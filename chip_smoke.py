#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result):
  1. device: card name, count, and nvidia-smi's name and power limit;
  2. build: both PQTopK kernels compiled from ``src/repro_torch/csrc``
     with nvcc, in parallel;
  3. parity at full width (B=512, N=1,000,448, m=8, b=256): each kernel
     against its plain PyTorch version on the same inputs on the card,
     values and ids bit-equal (tolerance 0) — k in {10, 100}, a
     tie-heavy quantised LUT, and for the pruned kernel identity,
     popularity-permuted and an overshooting warm floor (which must
     demote and still give the exact top-k);
  4. main path: the full-width RecJPQ two-tower model (random weights
     from a seeded generator) serves 20 fresh-id requests of B=512
     through the port's serve loop, once ``--fused`` and once
     ``--prune --perm --warm``; launch counters are zeroed just before
     each run and must show its kernel ran; one request is held against
     the materialise-then-top-k path (bit-equal);
  5. timing with CUDA events at the main path's shapes: kernel, plain
     version and the least time the card could take (bound).
Then one JSON line of per-kernel numbers, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}`` last.  Imports nothing of
JAX or of the JAX package.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

B, M, BC = 512, 8, 256            # serve_p99 batch, code length, centroids
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# fp32 outside the tensor cores: 67 TFLOP/s on the data sheet counts an
# FMA as 2 flops (132 SMs x 128 lanes x 2 x 1.98 GHz), so plain adds and
# maxes issue at half that.  A lookup in a per-query table (the LUT
# gather) goes through shared memory, 32 lanes per SM per clock: a
# quarter of the add rate.
FADD_PER_S = 67e12 / 2
LOOKUP_PER_S = 67e12 / 8
REQUESTS = 20


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ok ({time.perf_counter() - t0:.1f}s)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import fp32_matmuls
    from repro_torch.configs import get_bundle
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core.assign import popularity_permutation
    from repro_torch.kernels import build
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops
    from repro_torch.launch import serve as serve_mod

    fp32_matmuls()
    dev = torch.device("cuda", 0)

    t0 = phase("device")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   device={kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"   nvidia-smi: {smi}")
    done(t0)

    t0 = phase("build kernels (nvcc, sm_90a, one process per source)")
    build.build()
    for name in build.SOURCES:
        log = build.library_path(name).with_suffix(".log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"   {name}: {'; '.join(regs)}")
    done(t0)

    def key_equal(a, b):
        return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
                and torch.equal(a[1], b[1]))

    def abs_err(a, b):
        return float((a[0] - b[0]).abs().max())

    err = {"jpq_topk": 0.0, "jpq_topk_pruned": 0.0}
    gen = torch.Generator(device=dev).manual_seed(1)
    N = 1_000_448

    t0 = phase(f"parity at full width B={B} N={N} m={M} b={BC}")
    codes = torch.randint(0, BC, (N, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    luts = {"normal": torch.randn((B, M, BC), generator=gen, device=dev),
            "quantised": torch.randint(-2, 3, (B, M, BC), generator=gen,
                                       device=dev).float()}
    pop = torch.randperm(N, generator=gen, device=dev)
    bn = ops.prune_block_n(N)
    states = {"identity": ops.prepare_pruning(codes, BC, bn),
              "permuted": ops.prepare_pruning(codes, BC, bn, perm=pop)}
    for lut_name, lut in luts.items():
        P = ops.canonicalise_lut(lut)
        for k in (10, 100):
            kern = kc.jpq_topk(P, codes, k)
            plain = ops.jpq_topk_scan(P, codes, k,
                                      block_n=ops.scan_block_n(N))
            check(key_equal(kern, plain),
                  f"jpq_topk != plain ({lut_name}, k={k})")
            err["jpq_topk"] = max(err["jpq_topk"], abs_err(kern, plain))
            cold = (torch.full((B,), -float("inf"), device=dev),
                    torch.full((B, k), -float("inf"), device=dev),
                    torch.zeros((B, k), dtype=torch.int32, device=dev))
            for st_name, st in states.items():
                kv, ki, kskip = kc.jpq_topk_pruned(
                    P, st.codes, st.ids, st.present, *cold, k=k, block_n=bn,
                    tie_break_ids=st.tie_break_ids)
                pv, pi, pskip = ops.jpq_topk_scan_pruned(
                    P, st.codes, st.ids, st.present, *cold, k=k, block_n=bn,
                    tie_break_ids=st.tie_break_ids)
                check(key_equal((kv, ki), (pv, pi)) and
                      key_equal((kv, ki), plain),
                      f"jpq_topk_pruned != plain ({lut_name}, k={k}, "
                      f"{st_name})")
                check(torch.equal(kskip.min(0).values, pskip),
                      f"pruned skip map != plain ({lut_name}, k={k}, "
                      f"{st_name})")
                err["jpq_topk_pruned"] = max(err["jpq_topk_pruned"],
                                             abs_err((kv, ki), (pv, pi)))
            # an overshooting warm floor: half the rows get a floor above
            # their true k-th value, so they must demote and re-sweep
            theta = plain[0][:, -1]
            floor = torch.where(torch.arange(B, device=dev) % 2 == 0,
                                theta + 1.0, theta - 1.0)
            wv, wi, stats = ops.jpq_topk_lut(
                P, codes, k, prune=states["permuted"], warm=floor,
                return_stats=True)
            check(key_equal((wv, wi), plain),
                  f"warm-floored pruned top-k != plain ({lut_name}, k={k})")
            check(int(stats["demoted"].sum()) == B // 2,
                  f"expected {B // 2} demoted rows, got "
                  f"{int(stats['demoted'].sum())}")
            err["jpq_topk_pruned"] = max(err["jpq_topk_pruned"],
                                         abs_err((wv, wi), plain))
            print(f"   {lut_name} k={k}: jpq_topk, jpq_topk_pruned "
                  f"(identity, permuted, warm floor) bit-equal to plain")
    del luts, states, codes, pop
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase("main path: full-width two-tower-retrieval-jpq serving")
    bundle = get_bundle("two-tower-retrieval-jpq")
    model = bundle.make_model(device=dev, seed=0)
    params = model.params()
    n_rows = params["item_emb"]["codes"].shape[0]
    rng = np.random.default_rng(0)
    hist_len = model.cfg.hist_len
    # Zipf-skewed history ids: the popularity tally --perm sweeps by
    template = {"user_hist": (rng.zipf(1.2, (B, hist_len)) - 1)
                % model.cfg.n_items + 1}
    runs = {}
    for name, flags, kern in (("fused", ["--fused"], "jpq_topk"),
                              ("pruned", ["--prune", "--perm", "--warm"],
                               "jpq_topk_pruned")):
        args = serve_mod.build_parser().parse_args(
            ["--batch-size", str(B), "--requests", str(REQUESTS),
             "--device", "cuda", *flags])
        kc.reset_launches()
        res = serve_mod.serve_loop(model, params, template, args)
        counts = dict(kc.launches)
        check(counts[kern] > 0, f"main path '{name}' never launched {kern}")
        res["launches"] = counts
        runs[name] = res
        print(f"   {name}: p50={res['p50_ms']:.3f}ms p99={res['p99_ms']:.3f}"
              f"ms skip={res['skip']} launches={counts} "
              f"({REQUESTS + 1} requests incl. warm-up) on {smi}")

    # the output, held against the materialise path on one fresh request
    req = next(serve_mod.make_requests(template, B, 1, seed=123,
                                       reserved=(0,)))
    with torch.inference_mode():
        outs = {}
        for fused in (True, False):
            spec = engine_mod.RetrievalSpec(kind="jpq", k=10, fused=fused)
            outs[fused] = model.bind_engine(params, spec).retrieve(req)
    v, i = outs[True]
    check(tuple(v.shape) == (B, 10) and bool(torch.isfinite(v).all()),
          f"fused output shape {tuple(v.shape)} / non-finite values")
    check(bool((i >= 0).all()) and bool((i < n_rows).all()),
          "fused ids out of range")
    check(key_equal(outs[True], outs[False]),
          "fused serving != materialise-then-top-k on the same request")
    print("   fused top-10 bit-equal to the materialise path on one "
          "request")
    done(t0)

    t0 = phase("timing at the main path's shapes (CUDA events)")

    def cuda_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    k = 10
    codes = params["item_emb"]["codes"]
    with torch.inference_mode():
        h = model.user_vec(params, torch.as_tensor(req["user_hist"],
                                                   device=dev))
        P = ops.canonicalise_lut(jpq_mod.partial_scores(
            params["item_emb"], h)).contiguous()
    # the pruned main path's state: the template's popularity order
    perm = popularity_permutation(
        serve_mod._template_popularity(template, n_rows))
    st = engine_mod.build_prune_state(codes, BC, perm=perm)
    nt = st.present.shape[0]
    cold = (torch.full((B,), -float("inf"), device=dev),
            torch.full((B, k), -float("inf"), device=dev),
            torch.zeros((B, k), dtype=torch.int32, device=dev))
    times = {
        "jpq_topk": (cuda_ms(lambda: kc.jpq_topk(P, codes, k), 20),
                     cuda_ms(lambda: ops.jpq_topk_scan(
                         P, codes, k, block_n=ops.scan_block_n(n_rows)), 3)),
        "jpq_topk_pruned": (
            cuda_ms(lambda: kc.jpq_topk_pruned(
                P, st.codes, st.ids, st.present, *cold, k=k,
                block_n=st.block_n, tie_break_ids=st.tie_break_ids), 20),
            cuda_ms(lambda: ops.jpq_topk_scan_pruned(
                P, st.codes, st.ids, st.present, *cold, k=k,
                block_n=st.block_n, tie_break_ids=st.tie_break_ids), 2)),
    }
    # least time for the same work: inputs read once, outputs written
    # once, over HBM; or the operations, each type over its own peak —
    # fp32 adds (and, pruned, the bound's maxes) and LUT lookups, which
    # run on different units, so the slower of the two.  Pruned: only
    # the (group, tile) pairs this run swept.
    lut_bytes, out_bytes = B * M * BC * 4, B * k * 8
    bytes_u = n_rows * M + lut_bytes + out_bytes
    adds_u = lookups_u = B * n_rows * M
    skip = kc.jpq_topk_pruned(P, st.codes, st.ids, st.present, *cold, k=k,
                              block_n=st.block_n,
                              tie_break_ids=st.tie_break_ids)[2]
    tile_items = torch.full((nt,), st.block_n, device=dev)
    tile_items[-1] = n_rows - (nt - 1) * st.block_n
    group = -(-B // skip.shape[0])        # queries per block
    rows_per_group = torch.full((skip.shape[0],), group, device=dev)
    rows_per_group[-1] = B - group * (skip.shape[0] - 1)
    swept = (1 - skip).to(torch.int64)
    scored = int((swept * tile_items[None, :] * rows_per_group[:, None]
                  ).sum()) * M                  # (query, item, split)s
    lookups_p = scored + B * nt * M * BC       # + the bound's LUT reads
    adds_p = scored + B * nt * M * (BC + 1)    # + the bound's max/add
    swept_items = int(((1 - skip.min(0).values) * tile_items).sum())
    bytes_p = (swept_items * (M + 4) + nt * M * BC * 4 + lut_bytes
               + B * 4 + 2 * out_bytes)
    kernels = []
    for name, bytes_, adds, lookups, src, line in (
            ("jpq_topk", bytes_u, adds_u, lookups_u, "jpq_topk.cu", 329),
            ("jpq_topk_pruned", bytes_p, adds_p, lookups_p,
             "jpq_topk_pruned.cu", 281)):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_adds = adds / FADD_PER_S * 1e3
        t_lookups = lookups / LOOKUP_PER_S * 1e3
        t_ops = max(t_adds, t_lookups)
        ms, plain_ms = times[name]
        run = runs["fused" if name == "jpq_topk" else "pruned"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/jpq_topk/jpq_topk.py:{line}",
            "launches": run["launches"][name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        print(f"   {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {max(t_bytes, t_ops):.4f} ms "
              f"({kernels[-1]['bound_by']}; bytes {t_bytes:.4f} ms, fp32 "
              f"adds {t_adds:.4f} ms, LUT lookups {t_lookups:.4f} ms), "
              f"B={B} k={k} on {smi}")
    print(f"   pruned sweep swept {swept_items} of {n_rows} items "
          f"(skip map: {int(skip.sum())} of {skip.numel()} group-tiles)")
    done(t0)

    print(json.dumps({"serve": {
        n: {key: r[key] for key in ("path", "p50_ms", "p99_ms", "skip",
                                    "demoted_rows", "launches")}
        for n, r in runs.items()}, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
