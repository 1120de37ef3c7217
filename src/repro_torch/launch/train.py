"""Training entrypoint: a sequential recommender on the synthetic
sequence pipeline, with a RecJPQ (or full) item table, or an arch of
the registry on its reduced smoke config: a CTR arch (two-tower, FM,
DLRM-RM2, DIEN; full or ``-jpq``), an LM (mixtral-8x7b, olmoe-1b-7b,
stablelm-12b, qwen3-14b, stablelm-1.6b) or MACE.

    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec \
        --steps 300 [--device cpu] [--devices 2] \
        [--grad-compression int8 --grad-accum-shards 4] [--fsdp] \
        [--overlap backward] [--model-axis 2 [--share-card]]

The reference CLI's flags and defaults, plus ``--device`` (``cuda`` by
default: the hand-written kernels; ``cpu``: their plain versions).  A
RecJPQ table trains with ``use_kernel=True``, so on the card the
``full_ce`` logits and the input vectors go through the jpq_scores and
jpq_lookup kernels, forward and backward (the reference CLI keeps its
gathers).  ``--arch bert4rec`` trains on batches masked by
``mask_batch`` with a generator seeded from the step.  ``--ckpt-dir``
saves a checkpoint every ``--ckpt-every`` steps and at the end (the
reference's format, stamped with the TrainSpec layout), resumes from
the latest one there after checking the stamp, and on SIGTERM saves at
the step reached and exits; ``--microbatches`` accumulates gradients
over equal batch slices.  A CTR arch trains, as the reference's CLI
trains it, its bundle's ``make_smoke`` model on the fixed template
batch, with no eval; its pooled lookups train through the embedding_bag
kernels on the card.  An LM arch trains so too, on one device or a
mesh: its token gather and the MoE's dispatch and combine gathers take
their gradients from the embedding_bag backward kernel.  So does MACE,
on one device or a mesh: its sums over receivers and graphs run through
the same kernels forward, and its sender gathers take their gradients
from them.

The TrainSpec flag cluster (``train.spec.add_train_spec_args``:
``--grad-compression`` / ``--grad-accum-shards`` / ``--fsdp`` /
``--overlap`` / ``--microbatches``) resolves to one ``TrainSpec``.  Any
elastic spec trains through ``repro_torch.dist.compression``'s exchange
on a mesh, even on one device (gloo on the CPU, NCCL on a card).
``--devices N`` (or ``--mesh N``) > 1 runs N ranks: on the CPU N gloo
processes (``launch.mesh.spawn``; a SIGTERM to the CLI reaches every
rank, and they stop and save at the same step); on ``cuda`` one process
a card, and more than ``torch.cuda.device_count()`` raises.  An elastic
run preempted on N ranks resumes bit-identically on any N' dividing
``--grad-accum-shards``.

``--model-axis S`` > 1 trains any arch on a ``(D, S)`` mesh of D·S
ranks (``--devices`` D·S; S alone when ``--devices`` is left at 1): the
catalogue's rows (a table that S divides), the attention heads and the
MLPs' widths split over ``"model"`` (the Trainer's tensor parallelism,
each model's ``placement``; an LM's heads and kv heads, its FFN's
width, its MoE's experts and its vocabulary too), the batch over
``"data"``.  On the CPU the ranks are gloo processes; on ``cuda`` one
a card, or with ``--share-card`` all on one card, their collectives
staged through host memory (``gloo-staged``: NCCL refuses two ranks on
one device).  Rank 0 prints the history and its eval NDCG@10.  With
an elastic spec the model is replicated over ``"model"`` instead, as
the reference's ``shard_map`` runs it: every rank holds the whole
model, the S ranks of a data column run the same rounds, and the
exchange runs over the ``"data"`` group, so the run is the ``(D, 1)``
run's, bit for bit.  MACE's graph splits over ``"data"`` into shares
(``data.graphs.partition_graph``: each rank's block of nodes and of
edges, the halo and the remote receivers exchanged), and only its
readout splits over ``"model"``; a graph has no rows to cut, so MACE
takes no elastic spec and no ``--microbatches`` (``ValueError``).
"""
from __future__ import annotations

import argparse
import os
import signal

import torch

from repro_torch.train.spec import add_train_spec_args, spec_from_args

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
                    help="data-parallel ranks (CPU: gloo processes)")
    ap.add_argument("--mesh", type=int, default=None,
                    help="alias for --devices; spell the restart of a "
                         "preempted run on another number of ranks")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="model-parallel axis S: the ranks form a "
                         "(devices / S, S) mesh")
    ap.add_argument("--share-card", action="store_true",
                    help="cuda: run every rank on one card (collectives "
                         "staged through host memory)")
    add_train_spec_args(ap)        # the shared TrainSpec flag cluster
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

    from repro_torch.configs import get_bundle, list_archs

    if args.arch not in SEQ_ARCHS and args.arch not in list_archs():
        get_bundle(args.arch)     # raises: unknown
    dev = resolve_device(args.device)
    fp32_matmuls()
    train_cfg = TrainConfig(
        steps=args.steps, batch_size=args.batch_size,
        log_every=max(args.steps // 10, 1), eval_every=args.eval_every,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        early_stop_patience=args.early_stop_patience,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        grad_accum_shards=args.grad_accum_shards, fsdp=args.fsdp,
        overlap=args.overlap, seed=args.seed)
    if args.arch not in SEQ_ARCHS:
        bundle = get_bundle(args.arch)
        model, template = bundle.make_smoke(device=dev, seed=args.seed)
        print(f"arch {args.arch}: training the reduced smoke config "
              f"({bundle.description})")
        return (model, lambda s: template, None, train_cfg,
                OptConfig(lr=args.lr))
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
        # on a "model" mesh, this rank's column block of the scores
        s = model.score_last(params, ev["seq"])
        return {"ndcg10": float(torch.mean(ndcg_at_k(
            s, ev["target"], rows=cfg.n_rows)))}

    return model, data_fn, eval_fn, train_cfg, OptConfig(lr=args.lr)


def _train(mesh, args):
    """One rank's run: the model, data and Trainer of ``args`` on
    ``mesh`` (None: one device, no mesh); rank 0 prints."""
    from repro_torch.train.loop import Trainer
    model, data_fn, eval_fn, train_cfg, opt_cfg = build(args)
    tr = Trainer(model, opt_cfg, train_cfg, data_fn=data_fn,
                 eval_fn=eval_fn, mesh=mesh, spec=spec_from_args(args))
    _, hist = tr.run(params=model.params())
    if mesh is not None and mesh.rank != 0:
        return hist
    for h in hist[-5:]:
        print(h)
    evals = [h["eval_ndcg10"] for h in hist if "eval_ndcg10" in h]
    if evals:
        print(f"eval NDCG@10 {evals[-1]:.4f}")
    if tr._preempted:
        print(f"preempted: checkpoint stamped at step {tr.done_step}; "
              f"resume with the same --ckpt-dir (any number of ranks "
              f"dividing the accum shards)")
    else:
        print(f"done at step {tr.done_step} on {model.device}"
              + ("" if mesh is None else f", mesh {mesh.shape}"))
    return hist


def _one_thread_on_cpu(device) -> None:
    """An elastic run on the CPU computes with one thread a process, so
    its bits do not depend on how a reduction is split over cores."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)


def _rank_main(mesh, args):
    _one_thread_on_cpu(mesh.device)
    _train(mesh, args)


def mesh_dims(args):
    """(D, S): the ``(data, model)`` mesh of ``--devices`` /
    ``--model-axis``; ``--devices`` left at 1 means one data rank."""
    S = int(args.model_axis)
    n = int(args.devices)
    if S > 1 and n == 1:
        n = S
    if S < 1 or n % S:
        raise ValueError(f"--model-axis {S} must divide --devices {n}")
    return n // S, S


def main(argv=None):
    """Train; returns rank 0's history (None when ranks were spawned)."""
    from repro_torch import resolve_device
    from repro_torch.launch import mesh as mesh_mod
    args = build_parser().parse_args(argv)
    spec = spec_from_args(args)
    if args.mesh is not None:
        args.devices = args.mesh
    D, S = mesh_dims(args)
    args.devices = D * S
    dev = resolve_device(args.device)
    transport = mesh_mod.transport_for(dev, args.share_card)
    if dev.type == "cuda" and not args.share_card \
            and args.devices > torch.cuda.device_count():
        raise ValueError(f"--devices {args.devices} on a machine with "
                         f"{torch.cuda.device_count()} card(s): pass "
                         f"--share-card to run the ranks on one card")
    if args.devices > 1:
        print(f"mesh: {{'data': {D}, 'model': {S}}} "
              f"({transport}, {args.devices} processes)")

        def forward_sigterm(procs):
            def _handler(signum, frame):
                for p in procs:
                    if p.is_alive():
                        os.kill(p.pid, signal.SIGTERM)
            signal.signal(signal.SIGTERM, _handler)

        mesh_mod.spawn(_rank_main, args.devices, (args,), device=dev,
                       model=S, share_card=args.share_card,
                       on_start=forward_sigterm)
        return None
    if not spec.elastic:
        return _train(None, args)
    # the elastic path needs a mesh even on one device: one data shard,
    # V rounds
    _one_thread_on_cpu(dev)
    mesh = mesh_mod.make_host_mesh(1, device=dev)
    print(f"mesh: {mesh.shape} ({mesh_mod.backend_for(dev)})")
    try:
        return _train(mesh, args)
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
