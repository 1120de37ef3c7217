"""Quickstart: train SASRec with RecJPQ (discrete-SVD codebook) on a
synthetic long-tail catalogue and compare it with the uncompressed base.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--steps 300] [--device cpu]

The paper's pipeline end to end: interactions -> SVD codebook ->
JPQ-compressed backbone -> train -> unsampled NDCG@10 and HR@10 -> size
report.  The RecJPQ model runs with ``use_kernel=True``: on the card its
logits and input vectors go through the jpq_scores and jpq_lookup
kernels, forward and backward; on the CPU through their plain versions.
"""
from __future__ import annotations

import argparse

import torch

# the synthetic catalogue, its sequences, the training batch and the
# RecJPQ table's centroids a split
N_ITEMS, SEQ_LEN, BATCH, CENTROIDS = 1500, 32, 64, 256


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv=None) -> dict:
    from repro_torch import fp32_matmuls, resolve_device
    from repro_torch.core import EmbeddingConfig
    from repro_torch.core.api import compression_report
    from repro_torch.core.assign import build_codebook
    from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
    from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
    from repro_torch.nn.module import param_bytes
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.metrics import hr_at_k, ndcg_at_k
    from repro_torch.train.optimizer import OptConfig

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    fp32_matmuls()
    data = SyntheticSequences(SeqDataConfig(
        n_users=1000, n_items=N_ITEMS, zipf_a=1.2, seq_len=SEQ_LEN, seed=0))
    print(f"dataset: {data.n_users_eff} users, {data.cfg.n_items} items, "
          f"long-tail share {data.long_tail_share():.1%}")

    users, items = data.train_interactions()
    codes = build_codebook("svd", data.cfg.n_items + 2, args.m, CENTROIDS,
                           interactions=(users, items + 1),
                           n_users=data.n_users_eff, seed=0)
    print("codebook built (discrete truncated SVD)")

    ev = data.eval_batch(range(0, data.n_users_eff, 4), split="test")
    seq = torch.as_tensor(ev["seq"], device=dev)
    tgt = torch.as_tensor(ev["target"], device=dev)
    results = {}
    for variant, emb, cb in [
        ("base", None, None),
        ("recjpq-svd", EmbeddingConfig(0, 0, kind="jpq", m=args.m,
                                       b=CENTROIDS,
                                       use_kernel=True), codes),
    ]:
        cfg = SeqRecConfig(arch="sasrec", n_items=data.cfg.n_items,
                           max_len=SEQ_LEN, d_model=args.d_model, n_layers=2,
                           n_heads=2, d_ff=128, embedding=emb)
        model = SeqRecModel(cfg, codes=cb, device=dev)
        tr = Trainer(model, OptConfig(lr=3e-3),
                     TrainConfig(steps=args.steps, batch_size=BATCH,
                                 log_every=max(args.steps // 5, 1),
                                 eval_every=0),
                     data_fn=lambda s: data.train_batch(s, BATCH))
        params, hist = tr.run()
        with torch.no_grad():
            scores = model.score_last(params, seq)
        results[variant] = {
            "ndcg10": float(ndcg_at_k(scores, tgt).mean()),
            "hr10": float(hr_at_k(scores, tgt).mean()),
            "param_bytes": param_bytes(params),
            "final_loss": hist[-1].get("loss"),
        }
        print(f"[{variant}] {results[variant]}")

    rep = compression_report(EmbeddingConfig(
        n_items=data.cfg.n_items, d=args.d_model, kind="jpq", m=args.m))
    print(f"\nembedding tensor: {rep['ratio']:.1f}x smaller "
          f"({rep['pct_of_base']:.2f}% of base)")
    b, j = results["base"], results["recjpq-svd"]
    print(f"NDCG@10 base={b['ndcg10']:.4f} recjpq={j['ndcg10']:.4f} | "
          f"model bytes {b['param_bytes']} -> {j['param_bytes']} on {dev}")
    return results


if __name__ == "__main__":
    main()
