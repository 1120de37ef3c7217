"""Training entrypoint: a sequential recommender on the synthetic
sequence pipeline, with a RecJPQ (or full) item table.

    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec \
        --steps 300 [--device cpu]

The reference CLI's flags and defaults, plus ``--device`` (``cuda`` by
default: the hand-written kernels; ``cpu``: their plain versions).  A
RecJPQ table trains with ``use_kernel=True``, so on the card the
``full_ce`` logits and the input vectors go through the jpq_scores and
jpq_lookup kernels, forward and backward (the reference CLI keeps its
gathers).  ``--arch bert4rec`` trains on batches masked by
``mask_batch`` with a generator seeded from the step.  ``--ckpt-dir``
saves a checkpoint every ``--ckpt-every`` steps and at the end (the
reference's format), resumes from the latest one there, and on SIGTERM
saves at the step reached and exits; ``--microbatches`` accumulates
gradients over equal batch slices.  Sequential archs only; flags that
name paths not yet ported (``--devices``/``--mesh``/``--model-axis`` > 1,
the elastic-exchange cluster) raise.
"""
from __future__ import annotations

import argparse

import torch

SEQ_ARCHS = ("sasrec", "bert4rec", "gru4rec")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sasrec")
    ap.add_argument("--embedding", default="jpq",
                    choices=["full", "jpq", "qr"])
    ap.add_argument("--assignment", default="svd",
                    choices=["svd", "bpr", "random"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-items", type=int, default=2000)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its latest "
                         "step, save every --ckpt-every steps, on "
                         "SIGTERM and at the end")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--early-stop-patience", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="devices for SPMD (not yet ported: > 1 raises)")
    ap.add_argument("--mesh", type=int, default=None,
                    help="alias for --devices (not yet ported)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="model-parallel axis (not yet ported: > 1 raises)")
    # the reference's TrainSpec flag cluster (not yet ported: any value
    # other than the default raises)
    ap.add_argument("--grad-compression", default=None,
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--grad-accum-shards", type=int, default=None)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--overlap", default="dispatch",
                    choices=["none", "dispatch", "backward"])
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation over this many equal "
                         "batch slices")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def build(args):
    """(model, data_fn, eval_fn, TrainConfig, OptConfig) for ``args``."""
    from repro_torch import fp32_matmuls, resolve_device
    from repro_torch.core import EmbeddingConfig
    from repro_torch.core.assign import build_codebook
    from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
    from repro_torch.models.sequential import (SeqRecConfig, SeqRecModel,
                                               mask_batch)
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.metrics import ndcg_at_k
    from repro_torch.train.optimizer import OptConfig

    if args.arch not in SEQ_ARCHS:
        raise NotImplementedError(
            f"arch {args.arch!r}: only the sequential archs {SEQ_ARCHS} "
            f"train in repro_torch")
    devices = args.mesh if args.mesh is not None else args.devices
    if devices > 1:
        raise NotImplementedError("--devices/--mesh > 1 is not yet ported")
    if args.model_axis > 1:
        raise NotImplementedError("--model-axis > 1 is not yet ported")
    dev = resolve_device(args.device)
    fp32_matmuls()
    data = SyntheticSequences(SeqDataConfig(
        n_users=max(args.n_items, 500), n_items=args.n_items, seq_len=32,
        seed=args.seed))
    codes, emb = None, None
    if args.embedding != "full":
        emb = EmbeddingConfig(0, 0, kind=args.embedding, m=args.m, b=256,
                              use_kernel=True)
    if args.embedding == "jpq":
        u, i = data.train_interactions()
        codes = build_codebook(
            args.assignment, args.n_items + 2, args.m, 256,
            interactions=(u, i + 1), n_users=data.n_users_eff,
            seed=args.seed,
            **({"epochs": 3} if args.assignment == "bpr" else {}))
    cfg = SeqRecConfig(arch=args.arch, n_items=args.n_items, max_len=32,
                       d_model=args.d_model, n_layers=2, n_heads=2,
                       d_ff=2 * args.d_model, embedding=emb)
    model = SeqRecModel(cfg, codes=codes, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            args.seed))

    def data_fn(s):
        b = data.train_batch(s, args.batch_size)
        if args.arch != "bert4rec":
            return b
        seq = torch.as_tensor(b["seq"], device=dev)
        ms, tg = mask_batch(torch.Generator(device=dev).manual_seed(s), seq,
                            cfg.mask_prob, cfg.mask_id)
        return {"seq": ms, "targets": tg}

    ev = data.eval_batch(range(0, data.n_users_eff, 8), split="val")
    ev = {k: torch.as_tensor(v, device=dev) for k, v in ev.items()}

    def eval_fn(params):
        s = model.score_last(params, ev["seq"])
        return {"ndcg10": float(torch.mean(ndcg_at_k(s, ev["target"])))}

    train_cfg = TrainConfig(
        steps=args.steps, batch_size=args.batch_size,
        log_every=max(args.steps // 10, 1), eval_every=args.eval_every,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        early_stop_patience=args.early_stop_patience,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        grad_accum_shards=args.grad_accum_shards, fsdp=args.fsdp,
        overlap=args.overlap, seed=args.seed)
    return model, data_fn, eval_fn, train_cfg, OptConfig(lr=args.lr)


def main(argv=None):
    from repro_torch.train.loop import Trainer
    args = build_parser().parse_args(argv)
    model, data_fn, eval_fn, train_cfg, opt_cfg = build(args)
    tr = Trainer(model, opt_cfg, train_cfg, data_fn=data_fn,
                 eval_fn=eval_fn)
    _, hist = tr.run(params=model.params())
    for h in hist[-5:]:
        print(h)
    if tr._preempted:
        print(f"preempted: checkpoint stamped at step {tr.done_step}; "
              f"resume with the same --ckpt-dir")
    else:
        print(f"done at step {tr.done_step} on {model.device}")
    return hist


if __name__ == "__main__":
    main()
