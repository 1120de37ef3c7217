"""Serving demo: two-tower retrieval over a RecJPQ-compressed catalogue,
batched requests through the fused PQTopK score + top-k path (default)
or the materialise-then-top-k path (``--no-fused``), then the parity of
the fused, materialise and pruned paths, and the catalogue scored
through the jpq_scores kernel against the PyTorch gathers.

    PYTHONPATH=src python -m repro_torch.examples.serve_retrieval \
        [--no-fused] [--device cpu]

On the card the fused path runs the jpq_topk kernels, the pruned path
the jpq_topk_pruned kernel and the last part the jpq_scores kernel; on
the CPU their plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

BATCH_SIZES = (1, 32, 256)
REQUESTS = 6          # a warm-up and five timed, a batch size


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused score+top-k (no [B, N] score matrix); "
                         "--no-fused materialises and then top-ks")
    ap.add_argument("--n-items", type=int, default=200_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv=None) -> dict:
    from repro_torch import fp32_matmuls, resolve_device
    from repro_torch.core import EmbeddingConfig, serve
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core.api import compression_report
    from repro_torch.models.recsys import TwoTower, TwoTowerConfig

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    fp32_matmuls()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_items = args.n_items
    cfg = TwoTowerConfig(
        n_items=n_items, embed_dim=64, tower_mlp=(128, 64), hist_len=16,
        embedding=EmbeddingConfig(0, 0, kind="jpq", m=8, b=256))
    model = TwoTower(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    params = model.params()
    rep = compression_report(EmbeddingConfig(
        n_items=n_items, d=64, kind="jpq", m=8, b=256))
    print(f"catalogue {n_items} items; embedding store "
          f"{rep['compressed_bytes']/1e6:.1f} MB vs "
          f"{rep['base_bytes']/1e6:.1f} MB full ({rep['ratio']:.1f}x); "
          f"serve path: {'fused PQTopK' if args.fused else 'materialise'}")

    rng = np.random.default_rng(0)
    out = {"ms_per_batch": {}}
    # the batched request loop (what a serving replica does a tick):
    # fresh ids a request, as in repro_torch.launch.serve
    with torch.inference_mode():
        for batch_size in BATCH_SIZES:
            reqs = [{"user_hist": torch.as_tensor(
                rng.integers(1, n_items + 1, (batch_size, cfg.hist_len)),
                device=dev)} for _ in range(REQUESTS)]
            model.retrieve(params, reqs[0], top_k=10, fused=args.fused)
            sync()
            t0 = time.perf_counter()
            for batch in reqs[1:]:
                scores, ids = model.retrieve(params, batch, top_k=10,
                                             fused=args.fused)
                sync()
            dt = (time.perf_counter() - t0) / (REQUESTS - 1)
            out["ms_per_batch"][batch_size] = dt * 1e3
            print(f"batch={batch_size:4d}: {dt*1e3:7.2f} ms/req-batch, "
                  f"top-1 ids {ids[:2, 0].cpu().numpy()}")

        # fused vs materialise on the same queries, pruned included
        u = model.user_vec(params, batch["user_hist"][:4])
        pj = params["item_emb"]
        vf, idf = serve.retrieve_topk(model.emb, pj, u, k=10)
        vr, idr = serve.retrieve_topk(model.emb, pj, u, k=10, fused=False)
        vp, idp = serve.retrieve_topk(model.emb, pj, u, k=10, prune=True)
        out["fused_ids_equal"] = bool(torch.equal(idf, idr))
        out["pruned_ids_equal"] = bool(torch.equal(idp, idr))
        out["fused_max_abs_dv"] = float((vf - vr).abs().max())
        print(f"fused vs materialise: ids equal={out['fused_ids_equal']} "
              f"max|dv|={out['fused_max_abs_dv']:.2e}; pruned ids "
              f"equal={out['pruned_ids_equal']}")

        # the same scoring through the jpq_scores kernel (on a CPU tensor
        # its plain version) against the PyTorch gathers
        s_kernel = jpq_mod.logits(pj, u, use_kernel=True)
        s_ref = model.emb.logits(pj, u)
        out["jpq_scores_max_abs_diff"] = float((s_kernel - s_ref).abs().max())
    print(f"jpq_scores kernel vs gather path: max|diff|="
          f"{out['jpq_scores_max_abs_diff']:.2e} on {dev}")
    return out


if __name__ == "__main__":
    main()
