"""The paper-validation grid (Tables 4/5 analogue on synthetic data):

  backbones   : SASRec, BERT4Rec, GRU4Rec
  variants    : base, QR hashing, RecJPQ-{random, svd, bpr}
  datasets    : "ml1m" (dense, no long tail), "gowalla" (75%+ long tail)

    PYTHONPATH=src python -m repro_torch.examples.paper_validation \
        [--steps 400] [--device cpu] [--smoke]

Writes one JSON row a run (dataset, long_tail, arch, variant, ndcg10,
param_bytes, rel_size_pct, train_s) to ``--out``.  The RecJPQ variants
run with ``use_kernel=True``: on the card their logits and input vectors
go through the jpq_scores and jpq_lookup kernels, forward and backward.
``--smoke`` shrinks both data profiles to seconds a run.  The data
profiles, the variants' models and the training harness are this
module's own copies of the reference benchmark harness's helpers
(``make_data``, ``variant_model``, ``train_seqrec``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

VARIANTS = ("base", "qr", "jpq-random", "jpq-svd", "jpq-bpr")
D_MODEL, CODE_LEN, CENTROIDS = 64, 8, 64     # the grid's width and tables
BATCH, LR = 64, 3e-3


def make_data(profile: str, *, smoke: bool = False):
    """The grid's synthetic data: ``ml1m`` dense with no long tail,
    ``gowalla`` long-tailed; ``smoke`` shrinks either to seconds."""
    from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
    if profile == "ml1m":      # dense, no long tail
        cfg = SeqDataConfig(n_users=800, n_items=240, zipf_a=0.3,
                            min_len=12, max_len=60, seq_len=32, seed=0)
    else:                      # gowalla-like long tail
        cfg = SeqDataConfig(n_users=1200, n_items=2000, zipf_a=1.3,
                            min_len=6, max_len=30, seq_len=24, seed=1)
    if smoke:
        cfg = dataclasses.replace(cfg, n_users=120, n_items=80,
                                  seq_len=12, min_len=6, max_len=12)
    return SyntheticSequences(cfg)


def variant_model(arch, data, variant, *, device="cuda"):
    """The grid's model for (arch, variant) on ``data``: d = 64, 2 layers,
    2 heads; RecJPQ tables of m = 8 codes over b = 64 centroids, their
    codebook built from the training interactions."""
    from repro_torch.core import EmbeddingConfig
    from repro_torch.core.assign import build_codebook
    from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
    n_items = data.cfg.n_items
    codes = None
    if variant.startswith("jpq"):
        strat = variant.split("-")[1]
        u, i = data.train_interactions()
        codes = build_codebook(strat, n_items + 2, CODE_LEN, CENTROIDS,
                               interactions=(u, i + 1),
                               n_users=data.n_users_eff, seed=0,
                               **({"epochs": 3} if strat == "bpr" else {}))
        emb = EmbeddingConfig(0, 0, kind="jpq", m=CODE_LEN, b=CENTROIDS,
                              use_kernel=True)
    elif variant == "qr":
        emb = EmbeddingConfig(0, 0, kind="qr")
    else:
        emb = None
    cfg = SeqRecConfig(arch=arch, n_items=n_items, max_len=data.cfg.seq_len,
                       d_model=D_MODEL, n_layers=2, n_heads=2, d_ff=128,
                       embedding=emb)
    return SeqRecModel(cfg, codes=codes, device=device)


def train_seqrec(model, data, *, steps: int):
    """Train ``model`` (from the seed 0) for ``steps`` steps of ``BATCH``
    and score the test split of up to 256 users: (params, NDCG@10,
    parameter bytes).  A ``sampled_bce`` model draws ``n_negatives``
    negatives a position with each batch; BERT4Rec (with another loss)
    trains on the training sequences' items masked by ``mask_batch``,
    with a generator seeded from the step."""
    from repro_torch.models.sequential import mask_batch
    from repro_torch.nn.module import param_bytes
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.metrics import ndcg_at_k
    from repro_torch.train.optimizer import OptConfig

    dev = model.device
    if model.cfg.loss == "sampled_bce":
        def data_fn(s):
            return data.train_batch(s, BATCH,
                                    n_negatives=model.cfg.n_negatives)
    elif model.cfg.arch == "bert4rec":
        def data_fn(s):
            b = data.train_batch(s, BATCH)
            seq = torch.as_tensor(np.where(b["labels"] > 0, b["labels"], 0),
                                  device=dev)
            ms, tg = mask_batch(torch.Generator(device=dev).manual_seed(s),
                                seq, model.cfg.mask_prob, model.cfg.mask_id)
            return {"seq": ms, "targets": tg}
    else:
        def data_fn(s):
            return data.train_batch(s, BATCH)

    tr = Trainer(model, OptConfig(lr=LR),
                 TrainConfig(steps=steps, batch_size=BATCH,
                             log_every=max(steps // 4, 1), eval_every=0),
                 data_fn=data_fn)
    params, _ = tr.run()
    users = list(range(0, data.n_users_eff,
                       max(data.n_users_eff // 256, 1)))
    ev = data.eval_batch(users, split="test")
    with torch.no_grad():
        scores = model.score_last(params,
                                  torch.as_tensor(ev["seq"], device=dev))
    ndcg = float(ndcg_at_k(scores, torch.as_tensor(ev["target"],
                                                   device=dev)).mean())
    return params, ndcg, param_bytes(params)


def grid(profiles, archs, *, steps: int, device="cuda", smoke: bool = False):
    """One row a (profile, arch, variant) run, yielded as each run ends,
    so a caller can read what each run did on the card between rows."""
    for profile in profiles:
        data = make_data(profile, smoke=smoke)
        lt = data.long_tail_share()
        for arch in archs:
            base_bytes = None
            for variant in VARIANTS:
                t0 = time.time()
                model = variant_model(arch, data, variant, device=device)
                _, ndcg, nbytes = train_seqrec(model, data, steps=steps)
                if variant == "base":
                    base_bytes = nbytes
                yield {"dataset": profile, "long_tail": round(lt, 3),
                       "arch": arch, "variant": variant,
                       "ndcg10": round(ndcg, 4), "param_bytes": nbytes,
                       "rel_size_pct": round(100 * nbytes / base_bytes, 1),
                       "train_s": round(time.time() - t0, 1)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--archs", default="sasrec,bert4rec,gru4rec")
    ap.add_argument("--datasets", default="ml1m,gowalla")
    ap.add_argument("--out", default="experiments/paper_validation_torch.json")
    ap.add_argument("--smoke", action="store_true",
                    help="both data profiles shrunk to seconds a run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv=None) -> list:
    from repro_torch import fp32_matmuls, resolve_device
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    fp32_matmuls()
    results = []
    for rec in grid(args.datasets.split(","), args.archs.split(","),
                    steps=args.steps, device=dev, smoke=args.smoke):
        results.append(rec)
        print(rec, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out} ({len(results)} runs on {dev})")
    return results


if __name__ == "__main__":
    main()
