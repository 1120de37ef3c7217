#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result):
  1. device: card name, count, and nvidia-smi's name and power limit;
  2. build: every kernel source in ``src/repro_torch/csrc`` compiled
     with nvcc, one process per source, in parallel;
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
     version and the least time the card could take (bound); both
     kernels' general code path (uint8 codes at an odd address), held
     bit-equal to the 8-byte path and timed; ``jpq_topk``'s launch shape
     (the wrapper's record) and its time at k = 100; then the
     pruned kernel again on a skip-heavy full-width catalogue (codes that
     follow each item's rank, swept in popularity order; bit-equal to
     its plain version, skip map included), with the items it swept and
     the bound over the swept tiles, the tile bounds' own work included;
  6. parity of the training kernels on the card: jpq_scores forward at
     T=512 over the full catalogue (N=1,000,002), bit-equal to its plain
     version on normal and quantised LUTs; its backward against the
     plain version in float64 within the fp32 recursive-sum bound
     gamma(chain - 1) sum|terms| (chain: the longest run of adds into
     each output, a chunk's items of its bin and then the chunk
     partials), bit-identical across two calls, and over one item chunk
     its first 32 rows bit-equal to the plain version run on the CPU;
     jpq_lookup forward
     (bit-equal) and backward (bit-identical across two calls, bit-equal
     to its plain version run on CPU copies of its inputs, and within
     the float64 bound) at T=3,200;
  7. main path, training: full-width RecJPQ SASRec (d=512, 2 layers, 4
     heads, N=1,000,000 items, svd codebook over the synthetic data)
     trains through ``repro_torch.train.loop.Trainer`` for 1 + 20 steps
     of B=16 x S=200 with the full_ce loss; launch counters zeroed just
     before and each of the four training kernels must show launches;
     losses finite and falling; one step at B=2 held against the same
     step through PyTorch gathers (use_kernel=False); then score_last
     for 256 eval users through jpq_scores, NDCG@10 / HR@10, bit-equal
     to the plain version on the same LUT;
  8. the four training kernels at the main path's shapes (T=3,200, the
     trained weights, a training batch's ids): each held against its
     plain version as in phase 6 (jpq_scores' float64 backward in row
     blocks of 512); then kernel, plain version, bound, and one PyTorch
     library call timed, and for jpq_lookup and its backward also the
     card's own time of the kernel and of the library call under
     ``torch.profiler`` (``device_ms``, ``library_device_ms``); the
     jpq_scores forward's launch shape (queries a block, item ranges,
     blocks) at the training T and at score_last's T=256, and its time
     at both; the jpq_scores backward also timed over one item chunk,
     and its three kernels' device times under the profiler;
  9. embedding_bag parity on the card, bit-equal (tolerance 0) to its
     plain version: the two-tower user tower's shape (V=1,000,448,
     d=256, B=512, L=50, mask weights), FM's linear term (V=3,090,000,
     d=1, B=512, L=39, unit weights), FM's ``candidate_scores`` (one
     bag of L=38), B=65,536 at the two-tower shape, the ``mean`` combiner and ``weights=None`` through ``ops``, an
     all-padding bag over a negative pad row (-0.0), and an id outside
     [0, V) refused;
 10. embedding_bag timed at those four shapes (CUDA events): the kernel,
     the kernel with its id check, the plain version,
     ``F.embedding_bag`` and the bound (the distinct rows the ids name,
     read once); and the card's own time of the kernel and of
     ``F.embedding_bag`` under ``torch.profiler`` (``device_ms``,
     ``library_device_ms``);
 11. main path, CTR serving: two-tower-retrieval (full table), fm,
     fm-jpq, dlrm-rm2 (a 57.1 GB table), dlrm-rm2-jpq, dien and dien-jpq
     built at full width with ``make_model`` (random weights, seeded)
     and each serving 1 + 20 fresh requests of B=512 through
     ``serve_loop``, one model on the card at a time; launch counters
     zeroed before each run, and embedding_bag must show launches for
     the two-tower model and both FMs, whose output on one request is
     bit-equal with the plain version in the kernel's place; outputs
     finite, ``serve`` in [0, 1]; FM's ``candidate_scores`` and the
     DLRM and DIEN ``score_candidates`` over the 1,000,000-item field,
     once each, timed (FM's again with the plain version in the
     kernel's place, bit-equal); three more requests under ``torch.profiler`` give
     the card's busy time a request (its idle share against the p50)
     and the three largest device items.
Phases 12-15 run between phases 8 and 9, once SASRec's memory is freed:
 12. main path, the other two backbones: full-width RecJPQ BERT4Rec and
     GRU4Rec (SeqRecConfig defaults, phase 7's data and svd codebook,
     BERT4Rec's batches masked by ``mask_batch`` seeded from the step)
     train for 1 + 10 steps of B=16 x S=200, each checked as phase 7
     checks SASRec: launch counters zeroed just before, every training
     kernel launched, losses finite and falling, a B=2 step through the
     kernels against PyTorch gathers, and eval over 256 users (BERT4Rec
     at a [MASK] appended to the history) bit-equal to the kernel's
     scores on the same LUT; then a ``{"train_archs": ...}`` line;
 13. the quickstart example (``repro_torch.examples.quickstart``) at 50
     steps: both models' results finite, the training kernels launched;
 14. the serve_retrieval example as shipped (N=200,000, B=1/32/256):
     fused, materialise and pruned ids equal, fused values equal to
     materialise's, jpq_topk, jpq_topk_pruned and jpq_scores launched,
     the kernel's scores equal to the gathers';
 15. the paper-validation grid (2 profiles x 3 archs x 5 variants, 30
     runs at 30 steps; RecJPQ tables of b=64, dk=8): every NDCG@10
     finite, every RecJPQ run launching the training kernels (counters
     zeroed before each run); then a ``{"paper_validation": [...]}``
     line; then the four training kernels at every shape phases 13 and
     15 gave them (the quickstart's b=256 over 1,502 rows and the grid's
     b=64 over 242 and 2,002, training and eval, the eval T as the
     wrapper recorded it) and jpq_topk at serve_retrieval's, each held
     against its plain version (forwards bit-equal, backwards within
     the fp32 sum bound) and timed beside it and its bound (an
     ``{"example_shapes": ...}`` line).
Phases 16-22 run between phases 12 and 13, on phase 7's data and svd
codebook, one model on the card at a time:
 16-18. main path, SASRec's other objectives: full-width RecJPQ SASRec
     trains 1 + 10 steps with sampled_bce (one negative a position),
     code_ce, and full_ce + semantic_weight=0.5, each checked as phase 7
     checks SASRec, except that the jpq_scores pair must never launch in
     training where no [T, N] logits exist (sampled_bce, code_ce);
 19. full_ce at microbatches=2 (1 + 5 steps), checked the same way; the
     four training kernels at a slice's T = 1,600 held against their
     plain versions as phase 8 holds them, and timed; one step at
     microbatches=2 on [x; x] bit-equal to the single step on x; one
     step at microbatches=2 on a batch of 16 with distinct halves against
     the mean of the single steps on each half; then a
     ``{"seq_objectives": ...}`` line;
 20. checkpoints: a 6-step full_ce run; the save of its values and
     optimizer state timed and its bytes counted; a run sent a real
     SIGTERM while drawing step 3's batch stops with its checkpoint at
     step 3, and its resume ends bit-equal to the uninterrupted run; the
     checkpoint restored into a fresh model on the card (as
     ``launch/serve.py --ckpt-dir`` does) bit-equal; a ``{"checkpoint":
     ...}`` line;
 21. main path, the semantic-ID head: two-tower-retrieval-jpq at full
     width serves ``--head semantic`` (k = 10, auto beams) through
     ``serve_loop``, 1 + 20 requests of B=512, no sweep kernel launched;
     the code trie's build timed; on one more request every value
     bit-equal to the jpq_scores kernel's score of its id, and recall@10
     against ``--fused``; the exhaustive decode at 2,000 rows with
     duplicate codes bit-equal to jpq_topk;
 22. the SASRec of phase 20 through ``retrieve_topk``, fused and pruned,
     for 256 eval users, bit-equal to the top-10 of its ``score_last``;
     a ``{"semantic_serve": ...}`` line.
Phases 23-24 run after phase 11, one model on the card at a time:
 23. the embedding_bag backward on the card (the two-tower table,
     V=1,000,448, d=256, L=50, mask weights with ~10% pads; FM's linear
     term, V=3,090,000, d=1, L=39, unit weights; each at n_bags=65,536
     and 512; FM's with half of all ids on one row): bit-identical
     across two calls, bit-equal to its plain version run on CPU copies
     and within the fp32 recursive-sum bound of a float64 sum; timed by
     CUDA events (the kernel and its memset, the stable sort apart, the
     plain version, ``torch.zeros`` + ``index_add_``, the bound) and
     under ``torch.profiler``;
 24. main path, CTR training: seven bundles at the reference's full
     width (two-tower-retrieval and -jpq, fm and -jpq, dlrm-rm2-jpq,
     dien and -jpq) train through ``Trainer`` at B=65,536, adamw lr
     3e-3, 1 + 5 steps, at the smallest power-of-two ``microbatches``
     whose warm-up step peaks under 70 GB; launch counters zeroed before
     the run, embedding_bag forward and backward launched for the
     two-tower model and both FMs, losses finite, a B=64 step through
     the kernels against the plain versions in their place (loss within
     1e-5 relative, gradients within 1e-4 of each leaf's largest entry);
     the backward timed again at the main path's own ids; the
     arithmetic that keeps the full dlrm-rm2 off one card; a
     ``{"ctr_train": ...}`` line.
Then JSON lines of the serving runs, the CTR serving runs, CTR training
and the per-kernel numbers (eight kernels), the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}`` last.  Imports nothing of
JAX or of the JAX package.
"""
import contextlib
import dataclasses
import gc
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
U = 2.0 ** -24                     # fp32 unit roundoff


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ok ({time.perf_counter() - t0:.1f}s)", flush=True)


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` calls after one warm-up, by CUDA
    events."""
    import torch
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


def device_profile(torch, fn, reqs, attempts=3, pad_s=0.05, top_n=3):
    """Run ``fn`` on each request under ``torch.profiler`` and return
    (device-busy ms per request: the summed durations of the kernels
    and copies the card ran, the top ``top_n`` of them by name as
    [(name, ms per request)]).  Busy 0 means the profiler traced no
    device activity in any of ``attempts`` sessions.

    The profiler keeps only the device records whose (converted) time
    stamps fall inside its capture window, so a window that holds no
    more than a millisecond of short kernels can come back empty.  Each
    session therefore waits ``pad_s`` of idle host time on both sides
    of the requests (no device work, so the busy time is unchanged),
    and a session that still traced nothing is run again."""
    from torch.profiler import ProfilerActivity, profile
    reqs = list(reqs)
    per = {}
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            for r in reqs:
                fn(r)
            torch.cuda.synchronize()
            time.sleep(pad_s)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.name] = (per.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
        if per:
            break
        print(f"   (the profiler traced no device time in session "
              f"{attempt + 1} of {attempts})")
    n = len(reqs) * 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:top_n]
    return sum(per.values()) / n, [(k[:80], v / n) for k, v in top]


def odd_address(torch, x):
    """A contiguous copy of the uint8 tensor ``x`` at an odd address."""
    buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def bound(bytes_, ops):
    """(bound ms, bound_by): bytes over HBM against each operation type
    over its own rate (``ops``: {name: (count, rate)})."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max([n / r * 1e3 for n, r in ops.values()], default=0.0)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bits_equal(a, b):
    """Two float32 tensors equal bit for bit."""
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def scores_fwd_err(P, codes, what):
    """jpq_scores against its plain version: bit-equal; returns the
    max |kernel - plain| of that comparison (0)."""
    import torch

    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    kern = sc.jpq_scores(P, codes)
    plain = sref.jpq_scores_lut_ref(P, codes)
    check(bits_equal(kern, plain), f"jpq_scores != plain ({what})")
    e = float(kern.sub_(plain).abs_().max())
    del kern, plain
    torch.cuda.empty_cache()
    return e


def scores_bwd_err(dS, codes, b, what):
    """jpq_scores' backward (``b`` centroids a split) as the training
    path calls it (item chunks picked for the card, ``sc.bwd_chunks``):
    bit-identical across two calls and |kernel - float64| <=
    gamma(chain - 1) sum|terms|, chain the longest run of fp32 adds into
    each output (``sc.bwd_chain``: a chunk's items of the bin, then the
    chunk partials).  Over one chunk: the same bound, and rows 0-31
    bit-equal to the plain version run on CPU copies (one chain in item
    order from +0.0).  The float64 plain version runs in row blocks of
    512.  Returns (max |err|, largest bound, longest chain, chunks)."""
    import torch

    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    T_, N_ = dS.shape
    chunks = sc.bwd_chunks(T_, codes.shape[1], b, N_, dS.device)
    d1 = sc.jpq_scores_bwd(dS, codes, b)
    check(bits_equal(d1, sc.jpq_scores_bwd(dS, codes, b)),
          f"jpq_scores backward differs between calls ({what})")
    want = torch.empty(d1.shape, dtype=torch.float64, device=dS.device)
    mass = torch.empty_like(want)
    for r in range(0, T_, 512):
        blk = dS[r:r + 512].double()
        want[r:r + 512] = sref.jpq_scores_lut_bwd_ref(blk, codes, b)
        mass[r:r + 512] = sref.jpq_scores_lut_bwd_ref(blk.abs_(), codes, b)
        del blk
    out = None
    for c, got in ((chunks, d1),
                   (1, sc.jpq_scores_bwd(dS, codes, b, chunks=1))):
        chain = sc.bwd_chain(codes, b, c)
        n = chain.double() - 1
        lim = (n * U / (1 - n * U)) * mass
        diff = (got.double() - want).abs()
        check(bool((diff <= lim).all()),
              f"jpq_scores backward outside the fp32 sum bound over "
              f"{c} chunks ({what})")
        if out is None:
            out = (float(diff.max()), float(lim.max()), int(chain.max()),
                   chunks)
        del lim, diff
    on_cpu = sref.jpq_scores_lut_bwd_ref(dS[:32].cpu(), codes.cpu(), b)
    check(bits_equal(got[:32].cpu(), on_cpu),
          f"jpq_scores backward over one chunk != plain on the CPU, "
          f"rows 0-31 ({what})")
    del d1, got, want, mass
    torch.cuda.empty_cache()
    return out


def lookup_errs(ids, codes, cent, dout, what):
    """jpq_lookup bit-equal to its plain version; its backward
    bit-identical across two calls, bit-equal to the plain version
    run on CPU copies of its inputs (both sum each entry's positions
    in ascending order from +0.0) and |kernel - float64| <=
    T u sum|terms|.  ``dout`` None: the forward alone.  Returns the max
    |err| of the forward and of the backward against float64 (None)."""
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    kern = lc.jpq_lookup(ids, codes, cent)
    plain = lref.jpq_lookup_ref(ids, codes, cent)
    check(bits_equal(kern, plain), f"jpq_lookup != plain ({what})")
    e_fwd = float((kern - plain).abs().max())
    if dout is None:
        return e_fwd, None
    b = cent.shape[1]
    g1 = lc.jpq_lookup_bwd(ids, codes, dout, b)
    check(bits_equal(g1, lc.jpq_lookup_bwd(ids, codes, dout, b)),
          f"jpq_lookup backward differs between calls ({what})")
    on_cpu = lref.jpq_lookup_bwd_ref(ids.cpu(), codes.cpu(), dout.cpu(), b)
    check(bits_equal(g1.cpu(), on_cpu),
          f"jpq_lookup backward != plain on the CPU ({what})")
    want = lref.jpq_lookup_bwd_ref(ids, codes, dout.double(), b)
    mass = lref.jpq_lookup_bwd_ref(ids, codes, dout.double().abs(), b)
    diff = (g1.double() - want).abs()
    check(bool((diff <= ids.numel() * U * mass).all()),
          f"jpq_lookup backward outside the fp32 sum bound ({what})")
    return e_fwd, float(diff.max())


def train_kernel_work(T, N, b, dk):
    """The least work of each training kernel at T positions over N code
    rows of ``M`` codes, ``b`` centroids of ``dk`` floats a split:
    {name: (bytes, {op type: (count, rate)})}, inputs read once and
    outputs written once."""
    lut_b, out_b = T * M * b * 4, T * N * 4
    # the ids, the code rows they name, the centroids, the output
    look_b = T * 8 + T * M + M * b * dk * 4 + T * M * dk * 4
    return {
        "jpq_scores": (N * M + lut_b + out_b,
                       {"LUT lookups": (T * N * M, LOOKUP_PER_S),
                        "fp32 adds": (T * N * (M - 1), FADD_PER_S)}),
        "jpq_scores_bwd": (out_b + N * M + lut_b,
                           {"histogram updates": (T * N * M, LOOKUP_PER_S),
                            "fp32 adds": (T * N * M, FADD_PER_S)}),
        "jpq_lookup": (look_b, {}),
        "jpq_lookup_bwd": (look_b, {"fp32 adds": (T * M * dk, FADD_PER_S)}),
    }


def topk_work(Bq, N, k):
    """(bytes, fp32 adds, LUT lookups) of the unpruned fused top-k of
    ``Bq`` queries over N code rows: the codes and LUTs read once, the
    values and ids written once, one lookup and add a (query, item,
    split)."""
    return N * M + Bq * M * BC * 4 + Bq * k * 8, Bq * N * M, Bq * N * M


def bound_of(bytes_, adds, lookups):
    """(bound ms, bound_by, (bytes ms, adds ms, lookups ms)) of a top-k
    sweep: its bytes over HBM against its fp32 adds and its LUT lookups,
    each over its own rate."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_adds = adds / FADD_PER_S * 1e3
    t_lookups = lookups / LOOKUP_PER_S * 1e3
    t_ops = max(t_adds, t_lookups)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            (t_bytes, t_adds, t_lookups))


# the full-width training configuration (the repo's SeqRecConfig defaults
# with the paper's RecJPQ table) and its batch
N_ITEMS, SEQ_LEN, TRAIN_B = 1_000_000, 200, 16
EVAL_USERS, TRAIN_STEPS = 256, 20


def train_phases(torch, np, dev, smi):
    """Phases 6-8: the training kernels' parity, the training main path
    and the kernels' timing.  Returns (their entries of the kernels line,
    the synthetic data, the svd codebook), which phase 12 reuses."""
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core.assign import build_codebook
    from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    from repro_torch.models.sequential import _xent

    err = {}
    n_rows = N_ITEMS + 2
    T = TRAIN_B * SEQ_LEN
    dk = 512 // M
    gen = torch.Generator(device=dev).manual_seed(2)

    t0 = phase(f"training kernels' parity: jpq_scores T=512 N={n_rows}, "
               f"jpq_lookup T={T}")
    codes = torch.randint(0, BC, (n_rows, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    luts = {"normal": torch.randn((512, M, BC), generator=gen, device=dev),
            "quantised": torch.randint(-2, 3, (512, M, BC), generator=gen,
                                       device=dev).float()}
    err["jpq_scores"] = max(scores_fwd_err(P, codes, f"{name} LUT, T=512")
                            for name, P in luts.items())
    del luts
    dS = torch.randn((512, n_rows), generator=gen, device=dev)
    err["jpq_scores_bwd"], worst, chain, chunks = scores_bwd_err(
        dS, codes, BC, "T=512")
    print(f"   jpq_scores: forward bit-equal (normal, quantised LUT); "
          f"backward over {chunks} item chunks deterministic, max |err| vs "
          f"float64 {err['jpq_scores_bwd']:.3e} (bound gamma(chain - 1) "
          f"sum|dS|, longest chain {chain}, largest {worst:.3e}); over one "
          f"chunk within its bound, rows 0-31 bit-equal to plain on the CPU")
    del dS
    cent = torch.randn((M, BC, dk), generator=gen, device=dev)
    ids = torch.randint(0, n_rows, (T,), generator=gen, device=dev)
    ids[: T * 9 // 10] = 0                 # the main path's left padding
    ids = ids[torch.randperm(T, generator=gen, device=dev)]
    dout = torch.randn((T, M, dk), generator=gen, device=dev)
    err["jpq_lookup"], err["jpq_lookup_bwd"] = lookup_errs(
        ids, codes, cent, dout, f"T={T}")
    print(f"   jpq_lookup: forward bit-equal; backward bit-equal to plain "
          f"on the CPU, deterministic, max |err| vs float64 "
          f"{err['jpq_lookup_bwd']:.3e}")
    del codes, cent, ids, dout
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase(f"main path: full-width RecJPQ SASRec training, B={TRAIN_B} "
               f"S={SEQ_LEN} N={N_ITEMS}, 1 + {TRAIN_STEPS} steps")
    t1 = time.perf_counter()
    data = SyntheticSequences(SeqDataConfig(n_items=N_ITEMS,
                                            seq_len=SEQ_LEN, seed=0))
    t_data = time.perf_counter() - t1
    u, i = data.train_interactions()
    t1 = time.perf_counter()
    codes_np = build_codebook("svd", n_rows, M, BC, interactions=(u, i + 1),
                              n_users=data.n_users_eff, seed=0)
    t_codes = time.perf_counter() - t1
    print(f"   set-up on the host: data {t_data:.1f}s "
          f"({data.n_users_eff} users, {len(u)} train interactions), "
          f"svd codebook {t_codes:.1f}s")
    model, params, run = seq_main_path(torch, np, dev, smi, data, codes_np,
                                       "sasrec", TRAIN_STEPS)
    losses, step_ms, peak_gb, launches, ndcg, hr = (
        run[k] for k in ("losses", "median_step_ms", "peak_gb", "launches",
                         "ndcg10", "hr10"))
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase("the training kernels at the main path's shapes: parity, "
               "then timing (CUDA events)")
    codes = params["item_emb"]["codes"]
    cent = params["item_emb"]["centroids"].detach()
    batch = data.train_batch(0, TRAIN_B)
    seq = torch.as_tensor(batch["seq"], device=dev)
    ids = seq.reshape(-1)
    with torch.no_grad():
        P = jpq_mod.partial_scores(params["item_emb"],
                                   model.encode(params, seq)).reshape(
            T, M, BC).contiguous()
    # the kernels against their plain versions on these inputs, one
    # output alive at a time
    err["jpq_scores"] = max(err["jpq_scores"],
                            scores_fwd_err(P, codes, f"main path, T={T}"))
    dS = torch.randn((T, n_rows), generator=gen, device=dev)
    e, worst, chain, chunks = scores_bwd_err(dS, codes, BC,
                                             f"main path, T={T}")
    err["jpq_scores_bwd"] = max(err["jpq_scores_bwd"], e)
    print(f"   at T={T}: jpq_scores forward bit-equal to plain on the "
          f"trained LUT; backward over {chunks} item chunks deterministic, "
          f"max |err| vs float64 {e:.3e} (largest bound {worst:.3e}, "
          f"longest chain {chain}); over one chunk within its bound, rows "
          f"0-31 bit-equal to plain on the CPU")
    dout = torch.randn((T, M, dk), generator=gen, device=dev)
    e, e_bwd = lookup_errs(ids, codes, cent, dout, f"main path, T={T}")
    err["jpq_lookup"] = max(err["jpq_lookup"], e)
    err["jpq_lookup_bwd"] = max(err["jpq_lookup_bwd"], e_bwd)
    print(f"   at T={T}: jpq_lookup forward bit-equal to plain on the "
          f"batch's ids and trained centroids; backward bit-equal to plain "
          f"on the CPU, deterministic, max |err| vs float64 {e_bwd:.3e}")
    # the one-hot of the codes as a sparse [N, m*b] matrix (and its
    # transpose): one library call computes scores (transposed) and dP
    col = (codes.long() + BC * torch.arange(M, device=dev)).reshape(-1)
    onehot = torch.sparse_csr_tensor(
        torch.arange(0, n_rows * M + 1, M, device=dev), col,
        torch.ones(n_rows * M, device=dev), size=(n_rows, M * BC),
        check_invariants=False)
    onehot_t = onehot.to_sparse_coo().t().coalesce().to_sparse_csr()
    flat = (codes[ids].long() + BC * torch.arange(M, device=dev)).reshape(-1)
    cent2 = cent.reshape(M * BC, dk)
    P2t = P.reshape(T, M * BC).t().contiguous()
    lookup_fns = {   # the kernel and its library call
        "jpq_lookup": (lambda: lc.jpq_lookup(ids, codes, cent),
                       lambda: torch.index_select(cent2, 0, flat)),
        "jpq_lookup_bwd": (
            lambda: lc.jpq_lookup_bwd(ids, codes, dout, BC),
            lambda: torch.zeros_like(cent2).index_add_(
                0, flat, dout.reshape(T * M, dk))),
    }
    # the forward's time at the training T and at score_last's T, each
    # beside the launch shape the wrapper recorded (cuda.fwd_launch_shape:
    # queries a block, item ranges, blocks)
    fwd_shape = {"train": {"ms": cuda_ms(lambda: sc.jpq_scores(P, codes), 5),
                           **sc.fwd_launch_shape}}
    P_eval = P[:EVAL_USERS].contiguous()
    fwd_shape["eval"] = {"ms": cuda_ms(lambda: sc.jpq_scores(P_eval, codes),
                                       10), **sc.fwd_launch_shape}
    del P_eval
    for what, f in fwd_shape.items():
        print(f"   jpq_scores forward at T={f['T']} ({what}): {f['ms']:.4f} "
              f"ms; G={f['G']} queries a block, {f['item_ranges']} item "
              f"ranges of {f['items_per_block']} items, {f['blocks']} blocks "
              f"on {f['sms']} SMs")
    # its general code path (codes read a byte at a time), which uint8
    # codes at m = 8 take when their rows are not 8-byte aligned
    codes_odd = odd_address(torch, codes)
    check(bits_equal(sc.jpq_scores(P[:512], codes_odd),
                     sc.jpq_scores(P[:512], codes)),
          "jpq_scores' general path != its 8-byte path (T=512)")
    fwd_general_ms = cuda_ms(lambda: sc.jpq_scores(P, codes_odd), 5)
    print(f"   jpq_scores forward, general code path (codes at an odd "
          f"address): {fwd_general_ms:.4f} ms at T={T}, bit-equal to the "
          f"8-byte path at T=512 ({fwd_shape['train']['ms']:.4f} ms at "
          f"T={T})")
    del codes_odd
    times = {
        "jpq_scores": (
            fwd_shape["train"]["ms"],
            cuda_ms(lambda: sref.jpq_scores_lut_ref(P, codes), 2),
            cuda_ms(lambda: torch.sparse.mm(onehot, P2t), 2)),
        "jpq_scores_bwd": (
            cuda_ms(lambda: sc.jpq_scores_bwd(dS, codes, BC), 3),
            cuda_ms(lambda: sref.jpq_scores_lut_bwd_ref(dS, codes, BC), 2),
            cuda_ms(lambda: torch.sparse.mm(onehot_t, dS.t()), 2)),
        "jpq_lookup": (
            cuda_ms(lookup_fns["jpq_lookup"][0], 50),
            cuda_ms(lambda: lref.jpq_lookup_ref(ids, codes, cent), 20),
            cuda_ms(lookup_fns["jpq_lookup"][1], 50)),
        "jpq_lookup_bwd": (
            cuda_ms(lookup_fns["jpq_lookup_bwd"][0], 50),
            cuda_ms(lambda: lref.jpq_lookup_bwd_ref(ids, codes, dout, BC), 20),
            cuda_ms(lookup_fns["jpq_lookup_bwd"][1], 50)),
    }
    # the backward over one item chunk (one chain an output, bit-equal
    # to the CPU's index_add_; 200 blocks, a wave and a half on 132 SMs)
    one_chunk_ms = cuda_ms(
        lambda: sc.jpq_scores_bwd(dS, codes, BC, chunks=1), 3)
    print(f"   jpq_scores_bwd over one chunk: {one_chunk_ms:.4f} ms (over "
          f"{chunks}, as the training path runs it: "
          f"{times['jpq_scores_bwd'][0]:.4f} ms)")
    # the card's time in each of the backward's kernels (the sort, the
    # sums, the chunk reduction) under torch.profiler
    bwd_dev_ms, bwd_top = device_profile(
        torch, lambda _: sc.jpq_scores_bwd(dS, codes, BC), range(3))
    check(bwd_dev_ms > 0, "the profiler traced no device time for "
          "jpq_scores_bwd")
    print(f"   jpq_scores_bwd: device {bwd_dev_ms:.4f} ms a call: "
          + "; ".join(f"{k} {v:.4f}" for k, v in bwd_top))
    # the card's own time a call (torch.profiler: the summed durations of
    # the kernels a call ran) for the two small kernels and their library
    # calls, whose event times above may be the host's issue time
    dev_times = {}
    for name, fns in lookup_fns.items():
        (k_ms, k_top), (l_ms, l_top) = (
            device_profile(torch, lambda _, f=f: f(), range(50)) for f in fns)
        check(k_ms > 0, f"the profiler traced no device time for {name}")
        check(l_ms > 0, f"the profiler traced no device time for {name}'s "
              f"library call")
        dev_times[name] = {"device_ms": k_ms, "library_device_ms": l_ms}
        print(f"   {name}: device {k_ms:.4f} ms a call ({k_top[0][0]}); "
              f"library device {l_ms:.4f} ms ("
              + "; ".join(f"{k} {v:.4f}" for k, v in l_top) + ")")
    work = train_kernel_work(T, n_rows, BC, dk)
    line = {"jpq_scores": 60, "jpq_lookup": 62}
    out = []
    for name, (ms, plain_ms, lib_ms) in times.items():
        base = name.replace("_bwd", "")
        b_ms, b_by = bound(*work[name])
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{base}.cu",
            "replaces": f"src/repro/kernels/{base}/{base}.py:{line[base]}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms})
        dev_note = ""
        if name == "jpq_scores":
            out[-1]["launch_shape"] = fwd_shape
            out[-1]["general_path_ms"] = fwd_general_ms
        if name in dev_times:
            out[-1].update(dev_times[name])
            dev_note = " (device {device_ms:.4f} ms, library device " \
                "{library_device_ms:.4f} ms)".format(**dev_times[name])
        print(f"   {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"{lib_ms:.4f} ms library{dev_note}, bound {b_ms:.4f} ms "
              f"({b_by}), {launches[name]} launches in the training run, "
              f"T={T} on {smi}")
    print("   library calls: torch.sparse.mm with the codes' one-hot (CSR) "
          "for jpq_scores (output transposed) and its backward; "
          "index_select / index_add_ on a precomputed flat index for "
          "jpq_lookup and its backward")
    # what a step spends: the four kernels once each, the cross-entropy
    # forward and backward over [T, N] logits, and the encoder's forward
    # and backward, each timed alone at the step's shapes
    del dS, dout, onehot, onehot_t, P2t
    torch.cuda.empty_cache()
    labels = torch.as_tensor(batch["labels"], device=dev)
    valid = labels > 0
    logits = torch.randn((TRAIN_B, SEQ_LEN, n_rows), generator=gen,
                         device=dev).requires_grad_()

    def ce_pass():
        ce = _xent(logits, labels)
        torch.autograd.grad(torch.sum(ce * valid) / valid.sum(), logits)

    enc = list(model.parameters())
    split = {"kernels": sum(times[n][0] for n in times),
             "cross-entropy": cuda_ms(ce_pass, 3),
             "encoder": cuda_ms(lambda: torch.autograd.grad(
                 model.encode(params, seq).sum(), enc), 5)}
    del logits
    print(f"   step split (each part alone, ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; median step {step_ms:.1f} ms")
    print(json.dumps({"train": {
        "losses": losses, "median_step_ms": step_ms, "peak_gb": peak_gb,
        "launches": launches, "ndcg10": ndcg, "hr10": hr,
        "step_split_ms": split, "jpq_scores_bwd_chunks": chunks,
        "jpq_scores_bwd_one_chunk_ms": one_chunk_ms,
        "jpq_scores_bwd_device_ms": bwd_dev_ms,
        "jpq_scores_bwd_device_top": bwd_top, "card": smi}}))
    done(t0)
    return out, data, codes_np


# the paper's two other backbones at full width (SeqRecConfig defaults,
# the same RecJPQ table, data and codebook as phase 7), and the
# paper-validation grid's steps on the card
ARCHS, ARCH_STEPS, GRID_STEPS = ("bert4rec", "gru4rec"), 10, 30


def full_width_model(codes_np, dev, arch="sasrec", **kw):
    """Full-width RecJPQ ``arch`` (SeqRecConfig defaults, the svd codebook
    ``codes_np``, ``use_kernel=True``; ``kw`` more config fields) drawn
    from the seeded generator SeqRecModel defaults to."""
    from repro_torch.core import EmbeddingConfig
    from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
    cfg = SeqRecConfig(arch=arch, n_items=N_ITEMS, max_len=SEQ_LEN,
                       embedding=EmbeddingConfig(0, 0, kind="jpq", m=M, b=BC,
                                                 assignment="svd",
                                                 use_kernel=True), **kw)
    return SeqRecModel(cfg, codes=codes_np, device=dev)


def free_card(torch, dev, what):
    """Collect and empty the cache; fail unless under 2 GB is left
    allocated before ``what`` runs."""
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < 2e9,
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB still "
          f"allocated before {what}")


def seq_main_path(torch, np, dev, smi, data, codes_np, arch, steps, *,
                  loss="full_ce", semantic_weight=0.0, microbatches=1):
    """Train full-width RecJPQ ``arch`` (SeqRecConfig defaults, the svd
    codebook ``codes_np``, ``use_kernel=True``; ``loss``,
    ``semantic_weight`` and ``microbatches`` as given) for 1 + ``steps``
    steps of B=16 x S=200 through ``Trainer``, the launch counters zeroed
    just before: the jpq_lookup pair launched, and the jpq_scores pair
    launched exactly when the objective builds [T, N] logits (full_ce),
    else never; the losses finite and falling.  Then one step at B=2
    through the kernels against PyTorch gathers on the trained weights
    (loss within 1e-5 relative, every gradient within 1e-4 of its
    largest entry: the sums run in other orders), and ``score_last``
    for 256 eval users through jpq_scores, bit-equal to the kernel's
    scores on the same LUT (pad and [MASK] columns masked), with NDCG@10
    and HR@10.  BERT4Rec's batches are masked by ``mask_batch`` with a
    generator seeded from the step, as the train CLI masks them;
    sampled_bce's carry ``n_negatives`` negatives a position, as
    ``train_batch`` draws them.  Returns (model, params, summary)."""
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    from repro_torch.models.sequential import SeqRecModel, mask_batch
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.metrics import hr_at_k, ndcg_at_k
    from repro_torch.train.optimizer import OptConfig

    model = full_width_model(codes_np, dev, arch, loss=loss,
                             semantic_weight=semantic_weight)
    cfg = model.cfg
    what = arch if (loss, semantic_weight, microbatches) == \
        ("full_ce", 0.0, 1) else (f"{arch} {loss} semantic_weight="
                                  f"{semantic_weight} microbatches="
                                  f"{microbatches}")

    def batch_fn(B):
        def fn(s):
            if loss == "sampled_bce":
                return data.train_batch(s, B, n_negatives=cfg.n_negatives)
            b = data.train_batch(s, B)
            if arch != "bert4rec":
                return b
            seq = torch.as_tensor(b["seq"], device=dev)
            ms, tg = mask_batch(torch.Generator(device=dev).manual_seed(s),
                                seq, cfg.mask_prob, cfg.mask_id)
            return {"seq": ms, "targets": tg}
        return fn

    trainer = Trainer(model, OptConfig(lr=3e-3),
                      TrainConfig(steps=1 + steps, batch_size=TRAIN_B,
                                  log_every=1, eval_every=0,
                                  microbatches=microbatches),
                      data_fn=batch_fn(TRAIN_B))
    torch.cuda.reset_peak_memory_stats(dev)
    sc.reset_launches()
    lc.reset_launches()
    params, hist = trainer.run(
        generator=torch.Generator(device=dev).manual_seed(0))
    launches = {**sc.launches, **lc.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # the input side (and sampled_bce's labels and negatives) always
    # goes through jpq_lookup; only full_ce builds [T, N] logits
    logits = loss == "full_ce" or arch == "bert4rec" and loss != "code_ce"
    for name, n in launches.items():
        if logits or name.startswith("jpq_lookup"):
            check(n > 0, f"the {what} training run never launched {name}")
        else:
            check(n == 0, f"the {what} training run launched {name} {n} "
                  f"times: it builds no [T, N] logits")
    losses = [h["loss"] for h in hist if "loss" in h]
    secs = [h["sec"] for h in hist if "loss" in h][1:]
    check(len(losses) == 1 + steps and all(np.isfinite(losses)),
          f"{what} losses not finite: {losses}")
    check(np.mean(losses[-5:]) < losses[0],
          f"{what} loss did not fall: first {losses[0]}, last 5 "
          f"{losses[-5:]}")
    code_ce = [h["code_ce"] for h in hist if "code_ce" in h]
    check(len(code_ce) == (1 + steps if semantic_weight else 0)
          and all(np.isfinite(code_ce)),
          f"{what} code_ce rows malformed: {code_ce}")
    step_ms = float(np.median(secs)) * 1e3
    print(f"   losses {' '.join(f'{v:.4f}' for v in losses)}")
    if code_ce:
        print(f"   code_ce {' '.join(f'{v:.4f}' for v in code_ce)}")
    print(f"   median step {step_ms:.1f} ms (steps 1-{steps}), peak "
          f"memory {peak_gb:.2f} GB, launches {launches} on {smi}")

    plain = SeqRecModel(dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, use_kernel=False)), codes=codes_np, device=dev)
    small = {k: torch.as_tensor(v[:2], device=dev)
             for k, v in batch_fn(2)(10_000).items()}
    floats = list(model.parameters())
    res = {}
    for name, m in (("kernels", model), ("gathers", plain)):
        loss, _ = m.train_loss(params, small)
        res[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, floats))
    (lk, gk), (lg, gg) = res["kernels"], res["gathers"]
    check(abs(lk - lg) <= 1e-5 * abs(lg),
          f"{what} B=2 loss through kernels {lk} != gathers {lg}")
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(gk, gg))
    check(worst <= 1e-4, f"{what} B=2 gradients differ by {worst:.3e} of "
          f"their largest entry")
    print(f"   B=2 step: loss {lk:.6f} (kernels) vs {lg:.6f} (gathers), "
          f"gradients within {worst:.2e} of their largest entry")
    del res, gk, gg, plain, floats

    ev = data.eval_batch(range(EVAL_USERS), split="test")
    seq = torch.as_tensor(ev["seq"], device=dev)
    target = torch.as_tensor(ev["target"], device=dev)
    sc.reset_launches()
    with torch.no_grad():
        scores = model.score_last(params, seq)
        check(sc.launches["jpq_scores"] > 0,
              f"{arch} eval never launched jpq_scores")
        h = model.encode(params, model._serve_seq(seq))[:, -1]
        P = jpq_mod.partial_scores(params["item_emb"], h).contiguous()
        kern = sc.jpq_scores(P, params["item_emb"]["codes"])
        ref = sref.jpq_scores_lut_ref(P, params["item_emb"]["codes"])
    check(tuple(scores.shape) == (EVAL_USERS, N_ITEMS + 2)
          and bool(torch.isfinite(scores).all()),
          f"{arch} eval scores malformed")
    check(bits_equal(kern, ref), f"{arch} eval scores != plain on the same "
          f"LUT")
    kern[:, 0] = kern[:, -1] = -1e9
    check(bits_equal(scores, kern),
          f"{arch} score_last != kernel scores, masked")
    ndcg = float(ndcg_at_k(scores, target).mean())
    hr = float(hr_at_k(scores, target).mean())
    print(f"   eval {EVAL_USERS} users: NDCG@10 {ndcg:.4f} HR@10 {hr:.4f}; "
          f"scores bit-equal to the plain version on the same LUT")
    return model, params, {
        "losses": losses, **({"code_ce": code_ce} if code_ce else {}),
        "median_step_ms": step_ms,
        "step_ms": [t * 1e3 for t in secs], "peak_gb": peak_gb,
        "launches": launches, "ndcg10": ndcg, "hr10": hr,
        "b2_loss_kernels": lk, "b2_loss_gathers": lg,
        "b2_grad_rel_err": worst}


def arch_phases(torch, np, dev, smi, data, codes_np):
    """Phase 12: full-width RecJPQ BERT4Rec and GRU4Rec training through
    the four training kernels, each checked as phase 7 checks SASRec
    (``seq_main_path``).  Returns the ``train_archs`` summary."""
    summary = {}
    for arch in ARCHS:
        t0 = phase(f"main path: full-width RecJPQ {arch} training, "
                   f"B={TRAIN_B} S={SEQ_LEN} N={N_ITEMS}, 1 + {ARCH_STEPS} "
                   f"steps")
        free_card(torch, dev, arch)
        model, params, summary[arch] = seq_main_path(
            torch, np, dev, smi, data, codes_np, arch, ARCH_STEPS)
        del model, params
        done(t0)
    print(json.dumps({"train_archs": summary, "card": smi}))
    return summary


# the ninth slice: SASRec's other objectives, microbatching, checkpoints
# with SIGTERM preemption, and the semantic-ID head, at full width
OBJECTIVES = (("sampled_bce", 0.0), ("code_ce", 0.0), ("full_ce", 0.5))
OBJ_STEPS, MICRO_STEPS, CKPT_STEPS, CKPT_STOP = 10, 5, 6, 3
SEM_K, SEM_DUP_ROWS, SEM_DUP_B = 10, 2_000, 64


def _leaves_equal(torch, a, b):
    """Two params() trees equal bit for bit, leaf by leaf."""
    from repro_torch.nn.module import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.detach().view(torch.uint8),
                                           y.detach().view(torch.uint8))
        for x, y in zip(la, lb))


def objective_phases(torch, np, dev, smi, data, codes_np):
    """Phases 16-19: full-width RecJPQ SASRec trained with sampled_bce,
    code_ce and full_ce + semantic_weight=0.5 (1 + 10 steps each) and with
    full_ce at microbatches=2 (1 + 5 steps), each checked by
    ``seq_main_path``; then the training kernels at a microbatch slice's
    T = 1,600, held as phase 8 holds them and timed, and the microbatched
    step against the single step on one batch and against the mean of
    the single steps on its two halves.  Returns the ``seq_objectives``
    summary."""
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    summary = {}
    for loss, w in OBJECTIVES:
        name = loss if not w else f"{loss}+semantic_weight={w}"
        t0 = phase(f"main path: full-width RecJPQ SASRec, {name}, "
                   f"B={TRAIN_B} S={SEQ_LEN} N={N_ITEMS}, 1 + {OBJ_STEPS} "
                   f"steps")
        free_card(torch, dev, name)
        model, params, summary[name] = seq_main_path(
            torch, np, dev, smi, data, codes_np, "sasrec", OBJ_STEPS,
            loss=loss, semantic_weight=w)
        del model, params
        done(t0)

    t0 = phase(f"main path: full-width RecJPQ SASRec, full_ce at "
               f"microbatches=2, B={TRAIN_B} S={SEQ_LEN} N={N_ITEMS}, 1 + "
               f"{MICRO_STEPS} steps")
    free_card(torch, dev, "microbatches=2")
    model, params, run = seq_main_path(
        torch, np, dev, smi, data, codes_np, "sasrec", MICRO_STEPS,
        microbatches=2)
    summary["full_ce+microbatches=2"] = run
    # the training kernels at a slice's shape, T = 8 x 200 = 1,600, on the
    # trained weights and a training batch's ids, held as phase 8 holds
    # them at T = 3,200, then timed
    half = TRAIN_B // 2
    T2, n_rows, dk = half * SEQ_LEN, N_ITEMS + 2, 512 // M
    gen = torch.Generator(device=dev).manual_seed(3)
    codes = params["item_emb"]["codes"]
    cent = params["item_emb"]["centroids"].detach()
    seq = torch.as_tensor(data.train_batch(0, TRAIN_B)["seq"][:half],
                          device=dev)
    ids = seq.reshape(-1)
    with torch.no_grad():
        P = jpq_mod.partial_scores(params["item_emb"],
                                   model.encode(params, seq)).reshape(
            T2, M, BC).contiguous()
    slice_k = {"T": T2}
    slice_k["jpq_scores_err"] = scores_fwd_err(P, codes, f"T={T2}")
    slice_k["jpq_scores_launch_shape"] = dict(sc.fwd_launch_shape)
    dS = torch.randn((T2, n_rows), generator=gen, device=dev)
    (slice_k["jpq_scores_bwd_err"], worst, chain,
     slice_k["jpq_scores_bwd_chunks"]) = scores_bwd_err(dS, codes, BC,
                                                        f"T={T2}")
    dout = torch.randn((T2, M, dk), generator=gen, device=dev)
    slice_k["jpq_lookup_err"], slice_k["jpq_lookup_bwd_err"] = lookup_errs(
        ids, codes, cent, dout, f"T={T2}")
    work = train_kernel_work(T2, n_rows, BC, dk)
    for name, fn, iters in (
            ("jpq_scores", lambda: sc.jpq_scores(P, codes), 5),
            ("jpq_scores_bwd", lambda: sc.jpq_scores_bwd(dS, codes, BC), 3),
            ("jpq_lookup", lambda: lc.jpq_lookup(ids, codes, cent), 50),
            ("jpq_lookup_bwd",
             lambda: lc.jpq_lookup_bwd(ids, codes, dout, BC), 50)):
        slice_k[f"{name}_ms"] = cuda_ms(fn, iters)
        slice_k[f"{name}_bound_ms"] = bound(*work[name])[0]
    print(f"   T={T2}: jpq_scores forward bit-equal to plain (launch shape "
          f"{slice_k['jpq_scores_launch_shape']}); backward over "
          f"{slice_k['jpq_scores_bwd_chunks']} chunks deterministic, max "
          f"|err| vs float64 {slice_k['jpq_scores_bwd_err']:.3e} (largest "
          f"bound {worst:.3e}, longest chain {chain}); jpq_lookup forward "
          f"bit-equal, backward bit-equal to plain on the CPU")
    print(f"   T={T2}: ms kernel / bound: " + ", ".join(
        f"{n} {slice_k[n + '_ms']:.4f} / {slice_k[n + '_bound_ms']:.4f}"
        for n in ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
                  "jpq_lookup_bwd")) + f" on {smi}")
    del model, params, P, dS, dout, cent, codes, seq, ids
    free_card(torch, dev, "the microbatched step against the single step")
    # one step at microbatches=2 on [x; x] gives each slice the single
    # step's gradient on x, and (g + g) / 2 == g: the two steps must end
    # bit-equal, loss included
    x = data.train_batch(1, half)
    xx = {k: np.concatenate([v, v]) for k, v in x.items()}
    outs = {}
    for n, b in ((1, x), (2, xx)):
        m = full_width_model(codes_np, dev)
        tr = Trainer(m, OptConfig(lr=3e-3),
                     TrainConfig(steps=1, batch_size=len(b["seq"]),
                                 log_every=1, eval_every=0, microbatches=n),
                     data_fn=lambda s, b=b: b)
        p, hist = tr.run(params=m.params())
        outs[n] = (m, p, hist[0]["loss"])
    check(outs[1][2] == outs[2][2] and
          _leaves_equal(torch, outs[1][1], outs[2][1]),
          f"the microbatched step on [x; x] != the single step on x (loss "
          f"{outs[2][2]} vs {outs[1][2]})")
    slice_k["microbatched_equals_single_step"] = True
    print(f"   microbatches=2 on [x; x] (B={2 * half}) bit-equal to the "
          f"single step on x (B={half}): loss {outs[1][2]:.6f}, every "
          f"parameter")
    del outs, m, p, tr
    free_card(torch, dev, "the microbatched step on distinct halves")
    # microbatches=2 on a batch of 16 with distinct halves a and b against
    # its definition, the mean of the single steps' gradients on a and on
    # b (each slice's loss is the mean over its own labelled positions).
    # b keeps only its last 3 positions (the rest made padding), so the
    # halves hold unequal counts and the single step on the whole batch
    # differs from that mean: a slice that took the whole batch would
    # show, as would one slice taken twice.  The limits are the B=2
    # step's: the slices sum in other orders
    ab = data.train_batch(2, TRAIN_B)
    for v in ab.values():
        v[half:, :-3] = 0
    m = full_width_model(codes_np, dev)
    p = m.params()
    floats = [x for x in tree_leaves(p) if torch.is_floating_point(x)]

    def step_grads(n, b):
        tr = Trainer(m, OptConfig(lr=3e-3),
                     TrainConfig(steps=1, batch_size=len(b["seq"]),
                                 eval_every=0, microbatches=n), data_fn=None)
        g, mets = tr._grads(p, floats, {k: torch.as_tensor(v, device=dev)
                                        for k, v in b.items()}, 0)
        return float(mets["loss"]), g

    lm, gm = step_grads(2, ab)
    la, ga = step_grads(1, {k: v[:half] for k, v in ab.items()})
    lb, gb = step_grads(1, {k: v[half:] for k, v in ab.items()})
    lw, _ = step_grads(1, ab)
    lr_ = (la + lb) / 2
    err = max(float((x - (y + z) / 2).abs().max()
                    / ((y + z) / 2).abs().max().clamp(min=1e-30))
              for x, y, z in zip(gm, ga, gb))
    check(abs(lm - lr_) <= 1e-5 * abs(lr_) and err <= 1e-4,
          f"the microbatched step on distinct halves != the mean of the "
          f"single steps on each: loss {lm} vs {lr_}, gradients within "
          f"{err:.3e} of their largest entry")
    check(abs(lw - lr_) > 1e-5 * abs(lr_),
          f"the single step on the whole batch ({lw}) equals the halves' "
          f"mean ({lr_}): the check could not see a slice that took the "
          f"whole batch")
    slice_k.update(halves_loss_microbatched=lm, halves_loss_mean=lr_,
                   halves_loss_whole_batch=lw, halves_grad_rel_err=err)
    print(f"   microbatches=2 on distinct halves (B={TRAIN_B}): loss {lm:.6f}"
          f" vs the halves' mean {lr_:.6f} (whole batch {lw:.6f}), "
          f"gradients within {err:.2e} of their largest entry")
    summary["kernels_at_the_slice_shape"] = slice_k
    del m, p, floats, ga, gb, gm
    done(t0)
    print(json.dumps({"seq_objectives": summary, "card": smi}))
    return summary


def checkpoint_phase(torch, np, dev, smi, data, codes_np):
    """Phase 20: full-width RecJPQ SASRec (full_ce) trains 6 steps through
    ``Trainer``; a checkpoint of its values and optimizer state is saved
    and timed (the host copy that blocks training, and the whole write)
    and its bytes counted; a run that gets a real SIGTERM while drawing
    step 3's batch stops with a checkpoint stamped at step 3, and its
    resume ends bit-equal to the uninterrupted run; the checkpoint then
    restores onto the card into a fresh model, as ``launch/serve.py
    --ckpt-dir`` restores it.  Returns (the trained model, its params,
    the ``checkpoint`` summary)."""
    import shutil
    import signal
    import tempfile

    from repro_torch.ckpt import (AsyncCheckpointer, latest_step,
                                  restore_values)
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    t0 = phase(f"checkpoints at full width: SASRec full_ce, SIGTERM at step "
               f"{CKPT_STOP} of {CKPT_STEPS}, resume, restore onto the card")
    free_card(torch, dev, "the checkpoint phase")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt-",
                            dir=os.path.join(HERE, "build"))
    out = {}
    try:
        def run(d, sigterm_at=None):
            model = full_width_model(codes_np, dev)

            def data_fn(s):
                if s == sigterm_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return data.train_batch(s, TRAIN_B)

            tr = Trainer(model, OptConfig(lr=3e-3),
                         TrainConfig(steps=CKPT_STEPS, batch_size=TRAIN_B,
                                     log_every=1, eval_every=0, ckpt_dir=d,
                                     ckpt_every=0),
                         data_fn=data_fn)
            params, hist = tr.run(params=model.params())
            return model, tr, params, hist

        model, _, want, _ = run(None)
        # what a save costs: the host copy (training waits for it) and
        # the whole write, of the values and a same-sized optimizer state
        ck = AsyncCheckpointer(os.path.join(root, "timed"), keep=1)
        state = {"values": want, "opt": {**init_opt_state(want),
                                         "step": np.int32(CKPT_STEPS)}}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ck.save(state, CKPT_STEPS)
        t2 = time.perf_counter()
        ck.wait()
        t3 = time.perf_counter()
        npz = os.path.join(root, "timed", f"step_{CKPT_STEPS:010d}",
                           "arrays.npz")
        out.update(host_copy_ms=(t2 - t1) * 1e3, save_ms=(t3 - t1) * 1e3,
                   bytes=os.path.getsize(npz))
        del state
        d = os.path.join(root, "run")
        _, tr, _, _ = run(d, sigterm_at=CKPT_STOP - 1)
        check(tr._preempted and tr.done_step == CKPT_STOP
              and latest_step(d) == CKPT_STOP,
              f"SIGTERM at step {CKPT_STOP}: preempted={tr._preempted}, "
              f"done_step={tr.done_step}, latest checkpoint "
              f"{latest_step(d)}")
        _, tr, got, hist = run(d)
        check(not tr._preempted and tr.done_step == CKPT_STEPS
              and hist[0]["step"] == CKPT_STOP,
              f"the resumed run: done_step={tr.done_step}, first row "
              f"{hist[0]}")
        check(_leaves_equal(torch, want, got),
              "the preempted and resumed run != the uninterrupted run")
        del got
        fresh = full_width_model(codes_np, dev)
        p = fresh.params()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step = restore_values(d, p)
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t1) * 1e3
        check(step == CKPT_STEPS and _leaves_equal(torch, want, p) and all(
            x.device == dev for x in p["item_emb"].values()),
            "the restored checkpoint != the trained parameters on the card")
        del fresh, p
        out.update(preempted_at=CKPT_STOP, steps=CKPT_STEPS,
                   resume_bit_equal=True, restore_bit_equal=True)
        print(f"   save: host copy {out['host_copy_ms']:.1f} ms, write "
              f"{out['save_ms']:.1f} ms, {out['bytes']} bytes; SIGTERM at "
              f"step {CKPT_STOP}, resumed to {CKPT_STEPS}: bit-equal to the "
              f"uninterrupted run; restored onto the card in "
              f"{out['restore_ms']:.1f} ms, bit-equal, on {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    done(t0)
    print(json.dumps({"checkpoint": out, "card": smi}))
    return model, want, out


def semantic_phases(torch, np, dev, smi, data, template, seq_model,
                    seq_params):
    """Phases 21-22: ``two-tower-retrieval-jpq`` at full width serves
    --head semantic (k = 10, auto beams) through ``serve_loop``, 1 + 20
    fresh requests of B=512, after its code trie is built (timed); on
    one more request every value is bit-equal to the jpq_scores kernel's
    score of its id, and recall@10 against ``--fused``'s ids is
    reported; at 2,000 rows with duplicate codes the exhaustive decode is
    bit-equal to jpq_topk (values and ids).  Then the trained SASRec's
    ``retrieve_topk``, fused and pruned, for 256 eval users: bit-equal
    to the total-order top-10 of its ``score_last`` through the kernels.
    Returns the ``semantic_serve`` summary."""
    from repro_torch.configs import get_bundle
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core import semantic
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops
    from repro_torch.launch import serve as serve_mod

    t0 = phase(f"main path: full-width two-tower-retrieval-jpq --head "
               f"semantic (k={SEM_K}, auto beams), {REQUESTS} requests of "
               f"B={B}")
    free_card(torch, dev, "semantic serving")
    model = get_bundle("two-tower-retrieval-jpq").make_model(device=dev,
                                                             seed=0)
    params = model.params()
    codes = params["item_emb"]["codes"]
    n_rows = codes.shape[0]
    t1 = time.perf_counter()
    idx = semantic.index_for(codes, BC)
    build_s = time.perf_counter() - t1
    args = serve_mod.build_parser().parse_args(
        ["--batch-size", str(B), "--requests", str(REQUESTS), "--device",
         "cuda", "--head", "semantic"])
    kc.reset_launches()
    sc.reset_launches()
    res = serve_mod.serve_loop(model, params, template, args)
    check(res["path"] == "semantic", f"semantic serving ran {res['path']}")
    check(not any(kc.launches.values()) and not any(sc.launches.values()),
          f"the semantic head launched a sweep kernel: {kc.launches} "
          f"{sc.launches}")
    spec = engine_mod.spec_from_args(args, kind="jpq", k=SEM_K)
    beams = max(32, 4 * SEM_K)
    req = next(serve_mod.make_requests(template, B, 1, seed=321,
                                       reserved=(0,)))
    req = {k: torch.as_tensor(v, device=dev) for k, v in req.items()}
    with torch.inference_mode():
        v, i = model.bind_engine(params, spec).retrieve(req)
        fv, fi = model.bind_engine(params, engine_mod.RetrievalSpec(
            kind="jpq", k=SEM_K)).retrieve(req)
        h = model.user_vec(params, req["user_hist"])
        S = sc.jpq_scores(jpq_mod.partial_scores(params["item_emb"],
                                                 h).contiguous(), codes)
    check(tuple(i.shape) == (B, SEM_K) and bool((i >= 0).all())
          and bool((i < n_rows).all()), "semantic ids out of range")
    check(bits_equal(v, S.gather(1, i.long())),
          "a semantic value != the jpq_scores kernel's score of its id")
    recall = float((i[:, :, None] == fi[:, None, :]).any(-1).float().mean())
    del S, h
    print(f"   index: {idx.n_paths} paths over {n_rows} rows (largest "
          f"leaf {idx.max_leaf}) built in {build_s:.2f} s on the host")
    print(f"   p50={res['p50_ms']:.3f}ms p99={res['p99_ms']:.3f}ms "
          f"(beams {beams}); every value bit-equal to the kernel's score; "
          f"recall@{SEM_K} vs --fused {recall:.4f} on {smi}")
    # exhaustive decode at 2,000 rows with duplicate code rows (ties),
    # against jpq_topk on a canonical LUT (no -0.0)
    gen = torch.Generator(device=dev).manual_seed(4)
    dup = torch.randint(0, BC, (SEM_DUP_ROWS, M), generator=gen, device=dev,
                        dtype=torch.int32)
    dup[SEM_DUP_ROWS // 2:SEM_DUP_ROWS // 2 + 50] = dup[:50]
    dup = dup.to(torch.uint8)
    lut = ops.canonicalise_lut(torch.randint(
        -3, 4, (SEM_DUP_B, M, BC), generator=gen, device=dev).float() / 2)
    didx = semantic.build_code_index(dup, BC)
    ev_, ei_ = semantic.semantic_decode(lut, didx, SEM_K, beams=None)
    tv_, ti_ = kc.jpq_topk(lut.contiguous(), dup, SEM_K)
    check(bits_equal(ev_, tv_) and torch.equal(ei_, ti_),
          "exhaustive semantic decode != jpq_topk at 2,000 rows")
    print(f"   exhaustive decode ({didx.n_paths} paths over {SEM_DUP_ROWS} "
          f"rows, 50 duplicated, B={SEM_DUP_B}) bit-equal to jpq_topk")
    out = {"p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
           "lat_ms": res["lat_ms"], "beams": beams, "k": SEM_K,
           "index_build_s": build_s, "n_paths": idx.n_paths,
           "max_leaf": idx.max_leaf, "recall_vs_fused": recall,
           "values_equal_kernel_scores": True,
           "exhaustive_equals_jpq_topk": True}
    del model, params, codes, idx, didx, v, i, fv, fi
    # the scorer's cache holds the trie and the codes (≈ 40 MB on the
    # card): release them before the CTR phases read peak memory
    semantic.clear_index_cache()
    done(t0)

    t0 = phase(f"SeqRecModel.retrieve_topk on the trained full-width SASRec: "
               f"fused and pruned, {EVAL_USERS} users, k={SEM_K}")
    ev = data.eval_batch(range(EVAL_USERS), split="test")
    seq = torch.as_tensor(ev["seq"], device=dev)
    with torch.no_grad():
        scores = seq_model.score_last(seq_params, seq)
        want = engine_mod.rerank_candidates(
            scores, torch.arange(scores.shape[1], dtype=torch.int32,
                                 device=dev).expand_as(scores), SEM_K)
        del scores
        kc.reset_launches()
        got = {"fused": seq_model.retrieve_topk(seq_params, seq, k=SEM_K),
               "pruned": seq_model.retrieve_topk(seq_params, seq, k=SEM_K,
                                                 prune=True)}
    check(kc.launches["jpq_topk"] > 0 and kc.launches["jpq_topk_pruned"] > 0,
          f"retrieve_topk launched {kc.launches}")
    for name, (gv, gi) in got.items():
        check(bits_equal(gv, want[0]) and torch.equal(gi, want[1]),
              f"retrieve_topk ({name}) != the top-k of score_last")
    out["seqrec_retrieve_topk"] = {"users": EVAL_USERS, "k": SEM_K,
                                   "fused_equal": True, "pruned_equal": True,
                                   "launches": dict(kc.launches)}
    print(f"   fused and pruned top-{SEM_K} bit-equal to score_last's "
          f"(launches {dict(kc.launches)})")
    done(t0)
    print(json.dumps({"semantic_serve": out, "card": smi}))
    return out


def example_phases(torch, np, dev, smi):
    """Phases 13-15: the port's three examples on the card, as a user runs
    them (``python -m repro_torch.examples.<name>``): the quickstart at
    50 steps, serve_retrieval as shipped, and the paper-validation grid
    (2 profiles x 3 archs x 5 variants) at ``GRID_STEPS`` steps, the
    launch counters zeroed before each and read after.  Then the training
    kernels at every shape these runs gave them (``example_shape_times``:
    the eval shapes as the jpq_scores wrapper recorded them at each run's
    last launch, its ``score_last``).  Returns the summary of the
    three."""
    from repro_torch.examples import paper_validation as pv
    from repro_torch.examples import quickstart, serve_retrieval
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc

    counters = (kc, sc, lc)
    train_kernels = ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
                     "jpq_lookup_bwd")

    def reset():
        for c in counters:
            c.reset_launches()

    def read():
        return {k: v for c in counters for k, v in c.launches.items() if v}

    def eval_shape(what, n_rows):
        """(T, N) of the last jpq_scores launch: the run's score_last."""
        T, N = sc.fwd_launch_shape["T"], sc.fwd_launch_shape["N"]
        check(N == n_rows, f"{what}: the last jpq_scores launch was over "
              f"{N} rows, not the {n_rows} of its catalogue")
        return T

    # (what, scores T, lookup T, N, b, dk, backward too): the shapes the
    # examples ran the training kernels at
    shapes = []
    out = {}
    t0 = phase("example: quickstart --steps 50 (SASRec base vs RecJPQ-svd)")
    reset()
    qs = quickstart.main(["--steps", "50"])
    launches = read()
    for name in train_kernels:
        check(launches.get(name, 0) > 0, f"quickstart never launched {name}")
    for variant, r in qs.items():
        check(all(np.isfinite([r["ndcg10"], r["hr10"], r["final_loss"]])),
              f"quickstart {variant}: non-finite result {r}")
    check(qs["recjpq-svd"]["param_bytes"] < qs["base"]["param_bytes"],
          "quickstart: RecJPQ model not smaller than the base")
    qs_n = quickstart.N_ITEMS + 2
    qs_args = quickstart.build_parser().parse_args([])
    qs_dk = qs_args.d_model // qs_args.m
    qs_eval = eval_shape("quickstart", qs_n)
    qs_train = quickstart.BATCH * quickstart.SEQ_LEN
    shapes += [("quickstart train", qs_train, qs_train, qs_n,
                quickstart.CENTROIDS, qs_dk, True),
               ("quickstart eval", qs_eval, qs_eval * quickstart.SEQ_LEN,
                qs_n, quickstart.CENTROIDS, qs_dk, False)]
    out["quickstart"] = {**qs, "launches": launches}
    print(f"   launches {launches}")
    done(t0)

    t0 = phase("example: serve_retrieval (two-tower, N=200,000, B=1/32/256)")
    reset()
    sr = serve_retrieval.main([])
    launches = read()
    for name in ("jpq_topk", "jpq_topk_pruned", "jpq_scores"):
        check(launches.get(name, 0) > 0,
              f"serve_retrieval never launched {name}")
    check(sr["fused_ids_equal"] and sr["pruned_ids_equal"],
          "serve_retrieval: fused, materialise and pruned ids differ")
    check(sr["fused_max_abs_dv"] == 0.0,
          f"serve_retrieval: fused values differ from materialise's by "
          f"{sr['fused_max_abs_dv']}")
    check(sr["jpq_scores_max_abs_diff"] == 0.0,
          "serve_retrieval: jpq_scores kernel != gather path")
    out["serve_retrieval"] = {**sr, "launches": launches}
    print(f"   launches {launches}")
    done(t0)

    t0 = phase(f"example: paper_validation grid, 2 profiles x 3 archs x 5 "
               f"variants at --steps {GRID_STEPS}")
    profiles = ("ml1m", "gowalla")
    data_cfg = {p: pv.make_data(p).cfg for p in profiles}
    rows, grid_eval = [], {}
    runs = pv.grid(list(profiles), ["sasrec", "bert4rec", "gru4rec"],
                   steps=GRID_STEPS, device=dev)
    while True:
        reset()
        row = next(runs, None)
        if row is None:
            break
        row["launches"] = read()
        check(np.isfinite(row["ndcg10"]), f"grid row not finite: {row}")
        if row["variant"].startswith("jpq"):
            for name in train_kernels:
                check(row["launches"].get(name, 0) > 0,
                      f"grid {row['dataset']}/{row['arch']}/"
                      f"{row['variant']} never launched {name}")
            n_rows = data_cfg[row["dataset"]].n_items + 2
            grid_eval.setdefault(row["dataset"], set()).add(
                (eval_shape(f"grid {row['dataset']}", n_rows), n_rows))
        rows.append(row)
        print(f"   {row}")
    check(len(rows) == 30, f"the grid ran {len(rows)} of 30 runs")
    grid_dk = pv.D_MODEL // pv.CODE_LEN
    for p in profiles:
        check(len(grid_eval[p]) == 1, f"grid {p}: eval shapes "
              f"{grid_eval[p]} differ between runs")
        (T_eval, n_rows), = grid_eval[p]
        S = data_cfg[p].seq_len
        shapes += [(f"{p} train", pv.BATCH * S, pv.BATCH * S, n_rows,
                    pv.CENTROIDS, grid_dk, True),
                   (f"{p} eval", T_eval, T_eval * S, n_rows, pv.CENTROIDS,
                    grid_dk, False)]
    out["paper_validation"] = rows
    print(json.dumps({"paper_validation": rows, "steps": GRID_STEPS,
                      "card": smi}))
    done(t0)

    t0 = phase("the kernels at the examples' shapes: parity, then timing "
               "(CUDA events)")
    out["example_shapes"] = example_shape_times(torch, dev, smi, shapes)
    print(json.dumps({"example_shapes": out["example_shapes"],
                      "card": smi}))
    done(t0)
    return out


def example_shape_times(torch, dev, smi, shapes):
    """The kernels at the shapes the examples gave them, each held
    against its plain version and timed beside it and its bound.  The
    training kernels at each of ``shapes`` ((what, scores T, lookup T,
    N, b, dk, backward too): the quickstart's b = 256 and the grid's
    b = 64, training and eval): forwards bit-equal, backwards
    deterministic and within the fp32 sum bound (``scores_bwd_err``,
    ``lookup_errs``).  Then jpq_topk at serve_retrieval's B = 1, 32 and
    256 over its 200,192 rows, values bit-equal and ids equal."""
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for what, T, T_look, N, b, dk, bwd in shapes:
        codes = torch.randint(0, b, (N, M), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        P = torch.randn((T, M, b), generator=gen, device=dev)
        cent = torch.randn((M, b, dk), generator=gen, device=dev)
        ids = torch.randint(0, N, (T_look,), generator=gen, device=dev)
        dS = torch.randn((T, N), generator=gen, device=dev) if bwd else None
        dout = (torch.randn((T_look, M, dk), generator=gen, device=dev)
                if bwd else None)
        err = {"jpq_scores": scores_fwd_err(P, codes, what)}
        err["jpq_lookup"], err["jpq_lookup_bwd"] = lookup_errs(
            ids, codes, cent, dout, what)
        cases = {
            "jpq_scores": (T, lambda: sc.jpq_scores(P, codes),
                           lambda: sref.jpq_scores_lut_ref(P, codes)),
            "jpq_lookup": (T_look, lambda: lc.jpq_lookup(ids, codes, cent),
                           lambda: lref.jpq_lookup_ref(ids, codes, cent)),
        }
        if bwd:
            err["jpq_scores_bwd"] = scores_bwd_err(dS, codes, b, what)[0]
            cases["jpq_scores_bwd"] = (
                T, lambda: sc.jpq_scores_bwd(dS, codes, b),
                lambda: sref.jpq_scores_lut_bwd_ref(dS, codes, b))
            cases["jpq_lookup_bwd"] = (
                T_look, lambda: lc.jpq_lookup_bwd(ids, codes, dout, b),
                lambda: lref.jpq_lookup_bwd_ref(ids, codes, dout, b))
        for name, (T_k, kern, plain) in cases.items():
            b_ms, b_by = bound(*train_kernel_work(T_k, N, b, dk)[name])
            rows.append({"shape": what, "name": name, "T": T_k, "N": N,
                         "b": b, "dk": dk, "max_abs_err": err[name],
                         "ms": cuda_ms(kern, 50),
                         "plain_ms": cuda_ms(plain, 10), "bound_ms": b_ms,
                         "bound_by": b_by})
        del codes, P, cent, ids, dS, dout
    N, k = 200_192, 10
    codes = torch.randint(0, BC, (N, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    for Bq in (1, 32, 256):
        P = ops.canonicalise_lut(torch.randn((Bq, M, BC), generator=gen,
                                             device=dev)).contiguous()
        want = ops.jpq_topk_scan(P, codes, k, block_n=ops.scan_block_n(N))
        got = kc.jpq_topk(P, codes, k)
        check(bits_equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"jpq_topk != plain (serve_retrieval, B={Bq})")
        b_ms, b_by, _ = bound_of(*topk_work(Bq, N, k))
        rows.append({"shape": f"serve B={Bq}", "name": "jpq_topk", "B": Bq,
                     "N": N, "max_abs_err": float(
                         (got[0] - want[0]).abs().max()),
                     "ms": cuda_ms(lambda: kc.jpq_topk(P, codes, k), 50),
                     "plain_ms": cuda_ms(lambda: ops.jpq_topk_scan(
                         P, codes, k, block_n=ops.scan_block_n(N)), 5),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launch_shape": dict(kc.launch_shape)})
    for r in rows:
        print(f"   {r['name']} ({r['shape']}, T/B={r.get('T', r.get('B'))}, "
              f"N={r['N']}): {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} "
              f"ms plain, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"max |err| {r['max_abs_err']:.3e} on {smi}")
    return rows


# the CTR serving slice: the archs served, those whose path runs
# embedding_bag, and the kernel's shapes on that path
CTR_ARCHS = ("two-tower-retrieval", "fm", "fm-jpq", "dlrm-rm2",
             "dlrm-rm2-jpq", "dien", "dien-jpq")
BAG_ARCHS = ("two-tower-retrieval", "fm", "fm-jpq")
BAG_SHAPES = {   # V, d, n_bags, L, weights
    "two-tower B=512": (1_000_448, 256, B, 50, "masked"),
    "FM linear B=512": (3_090_000, 1, B, 39, None),
    "FM candidates n_bags=1": (3_090_000, 1, 1, 38, None),
    "two-tower B=65536": (1_000_448, 256, 65_536, 50, "masked"),
}


@contextlib.contextmanager
def plain_bag():
    """``ops.embedding_bag`` on CUDA tensors, forward and backward,
    through its plain versions for the duration (to hold the kernels'
    callers against them)."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    kernels = ec.embedding_bag, ec.embedding_bag_backward
    ec.embedding_bag = eref.embedding_bag_ref
    ec.embedding_bag_backward = eref.embedding_bag_backward_ref
    try:
        yield
    finally:
        ec.embedding_bag, ec.embedding_bag_backward = kernels


def ctr_phases(torch, np, dev, smi, data, tt_template):
    """Phases 9-11: embedding_bag's parity on the card, the CTR serving
    main path (seven archs at full width) and embedding_bag's timing.
    Returns (embedding_bag's entry of the kernels line, the serve_ctr
    summary)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_bundle
    from repro_torch.core import engine as engine_mod
    from repro_torch.data.clicks import ClickDataConfig, SyntheticClicks
    from repro_torch.data.clicks import dien_batch
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.launch import serve as serve_mod

    counters = (ec, kc, sc, lc)

    gen = torch.Generator(device=dev).manual_seed(3)
    tables = {}

    def bag_case(V, d, n, L, weights):
        """A table whose pad row 0 is all negative (one per (V, d)), ids
        with left padding in a quarter of the bags and, where there is
        more than one bag, one all-padding bag (bag 1), and mask, unit
        (None) or random weights."""
        if (V, d) not in tables:
            tab = torch.randn((V, d), generator=gen, device=dev)
            tab[0] = -tab[0].abs() - 0.25
            tables[(V, d)] = tab
        ids = torch.randint(0, V, (n, L), generator=gen, device=dev)
        ids[: n // 4, : L // 2] = 0
        if n > 1:
            ids[1] = 0
        w = {None: None, "masked": (ids > 0).float(),
             "random": torch.randn((n, L), generator=gen, device=dev)}[weights]
        return tables[(V, d)], ids, w

    t0 = phase("embedding_bag parity on the card (tolerance 0)")
    err = 0.0
    cases = {name: bag_case(*shape) for name, shape in BAG_SHAPES.items()}
    for name, (tab, ids, w) in cases.items():
        kern = ec.embedding_bag(tab, ids, w)
        plain = eref.embedding_bag_ref(tab, ids, w)
        check(bits_equal(kern, plain), f"embedding_bag != plain ({name})")
        err = max(err, float((kern - plain).abs().max()))
        padded = w is not None and ids.shape[0] > 1
        if padded:   # the all-padding bag: -0.0 from the pad row
            check(bool((kern[1] == 0).all()) and
                  bool(torch.signbit(kern[1]).all()),
                  f"all-padding bag is not -0.0 ({name})")
        print(f"   {name} (V={tab.shape[0]} d={tab.shape[1]} "
              f"n_bags={ids.shape[0]} L={ids.shape[1]}): bit-equal"
              + (", all-padding bag -0.0" if padded else ""))
    tab, ids, _ = cases["two-tower B=512"]
    rand_w = torch.randn(ids.shape, generator=gen, device=dev)
    for weights, combiner in ((None, "sum"), (None, "mean"),
                              (rand_w, "sum"), (rand_w, "mean")):
        kern = eops.embedding_bag(tab, ids, weights, combiner=combiner)
        with plain_bag():
            plain = eops.embedding_bag(tab, ids, weights, combiner=combiner)
        what = f"{combiner}, {'random' if weights is not None else 'no'} " \
            f"weights"
        check(bits_equal(kern, plain), f"embedding_bag != plain ({what})")
        err = max(err, float((kern - plain).abs().max()))
    print("   ops.embedding_bag, combiner sum and mean, weights None and "
          "random: bit-equal")
    bad = ids.clone()
    bad[7, 3] = tab.shape[0]
    try:
        ec.embedding_bag(tab, bad)
        check(False, "embedding_bag read an id outside [0, V)")
    except IndexError as e:
        print(f"   out-of-range id refused: {e}")
    del kern, plain, bad, rand_w
    done(t0)

    t0 = phase("embedding_bag timing (CUDA events): kernel, kernel + id "
               "check, plain version, F.embedding_bag, bound")
    timing = {}
    for name, (tab, ids, w) in cases.items():
        n, L = ids.shape
        d = tab.shape[1]
        iters = 20 if n > B else 200
        # bytes: the distinct rows the ids name (a row named twice need
        # not be read twice), the ids, the weights and the output; the
        # count with every gathered row read once is printed beside it
        small = ids.numel() * ids.element_size() + n * d * 4 \
            + (0 if w is None else w.numel() * 4)
        rows = torch.unique(ids).numel()
        b_ms, b_by = bound(rows * d * 4 + small,
                           {"fp32 FMAs": (n * L * d, FADD_PER_S)})
        all_rows_ms = (n * L * d * 4 + small) / HBM_BYTES_PER_S * 1e3
        timing[name] = {
            "ms": cuda_ms(lambda: ec.launch(tab, ids, w), iters),
            "checked_ms": cuda_ms(lambda: ec.embedding_bag(tab, ids, w),
                                  iters),
            "plain_ms": cuda_ms(lambda: eref.embedding_bag_ref(tab, ids, w),
                                max(iters // 10, 2)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                ids, tab, mode="sum", per_sample_weights=w), iters),
            "bound_ms": b_ms, "bound_by": b_by, "distinct_rows": rows,
            "bound_all_rows_ms": all_rows_ms}
        t = timing[name]
        # the card's own time a call (torch.profiler), apart from the
        # host's issue time that the event times above may show
        n_prof = 10 if n > B else 50
        for key, f in (("device_ms", lambda _: ec.launch(tab, ids, w)),
                       ("library_device_ms", lambda _: F.embedding_bag(
                           ids, tab, mode="sum", per_sample_weights=w))):
            t[key], top = device_profile(torch, f, range(n_prof))
            check(t[key] > 0, f"the profiler traced no device time for "
                  f"embedding_bag ({name}, {key})")
            t[key + "_top"] = top
        print(f"   {name}: {t['ms']:.4f} ms kernel (device "
              f"{t['device_ms']:.4f}), {t['checked_ms']:.4f} ms "
              f"with the id check, {t['plain_ms']:.4f} ms plain, "
              f"{t['library_ms']:.4f} ms F.embedding_bag (device "
              f"{t['library_device_ms']:.4f}: "
              + "; ".join(f"{k} {v:.4f}" for k, v in
                          t["library_device_ms_top"]) + "), bound "
              f"{b_ms:.4f} ms ({b_by}; {rows} distinct rows; "
              f"{all_rows_ms:.4f} ms with all {n * L} rows) on {smi}")
    del cases, tables, tab, ids, w
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase(f"main path: CTR serving at full width, {REQUESTS} requests "
               f"of B={B} (+ 1 warm-up) per arch")
    serve_ctr = {"embedding_bag_ms": timing}

    def streams(name, model, n):
        """Fresh request batches for ``name``: SyntheticClicks for FM and
        DLRM, dien_batch for DIEN, phase 4's Zipf template (make_requests)
        for the two-tower model."""
        if name.startswith("two-tower"):
            return serve_mod.make_requests(tt_template, B, n, seed=7,
                                           reserved=(0,))
        if name.startswith("dien"):
            return ({k: b[k] for k in ("hist", "target")}
                    for b in (dien_batch(data, s, B, model.cfg.seq_len)
                              for s in range(n)))
        keys = ("sparse",) if name.startswith("fm") else ("dense", "sparse")
        clicks = SyntheticClicks(ClickDataConfig(
            n_dense=getattr(model.cfg, "n_dense", 13),
            vocab_sizes=model.cfg.vocabs(), seed=0))
        return ({k: b[k] for k in keys}
                for b in (clicks.batch(s, B) for s in range(n)))

    def sync():
        torch.cuda.synchronize(dev)

    for name in CTR_ARCHS:
        check(torch.cuda.memory_allocated(dev) < 2e9,
              f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB still "
              f"allocated before {name}")
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        model = get_bundle(name).make_model(device=dev, seed=0)
        params = model.params()
        sync()
        build_s = time.perf_counter() - t1
        args = serve_mod.build_parser().parse_args(
            ["--arch", name, "--batch-size", str(B), "--requests",
             str(REQUESTS), "--device", "cuda"])
        for c in counters:
            c.reset_launches()
        res = serve_mod.serve_loop(model, params, tt_template, args,
                                   requests=streams(name, model,
                                                    REQUESTS + 1))
        launches = {k: v for c in counters for k, v in c.launches.items()
                    if v}
        if name in BAG_ARCHS:
            check(ec.launches["embedding_bag"] > 0,
                  f"the {name} serving run never launched embedding_bag")
        # one more request: the output's form, and (where the path runs
        # embedding_bag) the same request through the plain version
        req = next(iter(streams(name, model, REQUESTS + 2)))
        with torch.inference_mode():
            if name.startswith("two-tower"):
                spec = engine_mod.RetrievalSpec(kind="full", k=10)
                fn = model.bind_engine(params, spec).retrieve
                v, i = out = fn(req)
                check(tuple(v.shape) == (B, 10) and
                      bool(torch.isfinite(v).all()) and
                      bool(((i >= 0) &
                            (i < params["item_emb"]["table"].shape[0])).all()),
                      f"{name}: malformed top-10")
            else:
                fn = lambda r: model.serve(params, r)  # noqa: E731
                out = fn(req)
                check(tuple(out.shape) == (B,) and
                      bool(torch.isfinite(out).all()) and
                      bool(((out >= 0) & (out <= 1)).all()),
                      f"{name}: serve output not finite in [0, 1]")
            if name in BAG_ARCHS:
                with plain_bag():
                    plain = fn(req)
                if isinstance(out, tuple):
                    same = bits_equal(out[0], plain[0]) and \
                        torch.equal(out[1], plain[1])
                else:
                    same = bits_equal(out, plain)
                check(same, f"{name}: kernel path != plain path on the "
                      f"same request")
            # where a request's time goes: the card's busy time against
            # the unprofiled p50 (the rest is the host issuing work)
            busy_ms, top = device_profile(
                torch, fn, list(streams(name, model, 3)))
            # candidate scoring for one context over the catalogue
            rng = np.random.default_rng(11)
            t1 = time.perf_counter()
            if name.startswith("fm"):
                rest = next(iter(streams(name, model, 1)))["sparse"][:1, 1:]
                cand = model.candidate_scores(params, {"sparse_rest": rest})
                n_cand = model.cfg.vocabs()[0]
                sync()
                cand_ms = (time.perf_counter() - t1) * 1e3
                with plain_bag():
                    plain_cand = model.candidate_scores(
                        params, {"sparse_rest": rest})
                check(bits_equal(cand, plain_cand),
                      f"{name}: candidate_scores through the kernel != "
                      f"through the plain version")
                del plain_cand
            elif name.startswith("dlrm"):
                b = next(iter(streams(name, model, 1)))
                n_cand = model.cfg.vocabs()[0]          # the item field
                cand = model.score_candidates(params, {
                    "dense": b["dense"][:1], "sparse_rest": b["sparse"][:1, 1:],
                    "candidates": rng.permutation(n_cand)})
            elif name.startswith("dien"):
                n_cand = model.cfg.n_items
                cand = model.score_candidates(params, {
                    "hist": req["hist"][:1],
                    "candidates": rng.permutation(n_cand) + 1})
            else:
                cand, n_cand = None, 0
            sync()
            if not name.startswith("fm"):
                cand_ms = (time.perf_counter() - t1) * 1e3 if n_cand else None
        if cand is not None:
            check(cand.numel() == n_cand and bool(torch.isfinite(cand).all()),
                  f"{name}: candidate scores malformed")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        serve_ctr[name] = {"path": res["path"], "p50_ms": res["p50_ms"],
                           "p99_ms": res["p99_ms"], "peak_gb": peak_gb,
                           "build_s": build_s, "launches": launches,
                           "candidates": n_cand, "candidates_ms": cand_ms,
                           "device_busy_ms": busy_ms,
                           "idle_share": (1 - busy_ms / res["p50_ms"]
                                          if busy_ms else None),
                           "top_device_ms": top}
        print(f"   {name}: device busy {busy_ms:.3f} ms a request (of p50 "
              f"{res['p50_ms']:.3f} ms); top: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
        print(f"   {name}: p50={res['p50_ms']:.3f}ms p99={res['p99_ms']:.3f}"
              f"ms peak {peak_gb:.2f} GB (built in {build_s:.1f}s), "
              f"launches {launches}"
              + (f", {n_cand} candidates in {cand_ms:.1f} ms"
                 if n_cand else "")
              + (", kernel == plain on one request" if name in BAG_ARCHS
                 else "")
              + (" and on candidate_scores" if name.startswith("fm") else "")
              + f" on {smi}")
        del model, params, out, req, fn, cand
        if name in BAG_ARCHS:
            del plain
        gc.collect()
        torch.cuda.empty_cache()
    done(t0)

    main_t = timing["two-tower B=512"]
    entry = {"name": "embedding_bag", "route": "cuda",
             "source": "src/repro_torch/csrc/embedding_bag.cu",
             "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:59",
             "launches": sum(r["launches"].get("embedding_bag", 0)
                             for r in serve_ctr.values() if "launches" in r),
             "max_abs_err": err, "ms": main_t["ms"],
             "checked_ms": main_t["checked_ms"],
             "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
             "bound_by": main_t["bound_by"],
             "library_ms": main_t["library_ms"],
             "device_ms": main_t["device_ms"],
             "library_device_ms": main_t["library_device_ms"]}
    return entry, serve_ctr


# the CTR training slice: the bundles trained at full width, their batch
# and steps, the peak they must stay under, the bundles whose path runs
# the embedding_bag backward, and the backward's shapes in phase 23 (ids
# "uniform" as the training data draws them, "padded" with ~10% pad
# slots of weight 0, or "skewed": half of all positions one row)
CTR_TRAIN_ARCHS = ("two-tower-retrieval", "two-tower-retrieval-jpq", "fm",
                   "fm-jpq", "dlrm-rm2-jpq", "dien", "dien-jpq")
CTR_B, CTR_STEPS, PEAK_LIMIT = 65_536, 5, 70e9
BAG_BWD_SHAPES = {   # V, d, n_bags, L, ids, weights
    "two-tower B=65536, 10% pads": (1_000_448, 256, 65_536, 50, "padded",
                                    "masked"),
    "FM linear B=65536": (3_090_000, 1, 65_536, 39, "uniform", None),
    "two-tower B=512, 10% pads": (1_000_448, 256, B, 50, "padded", "masked"),
    "FM linear B=512": (3_090_000, 1, B, 39, "uniform", None),
    "FM linear B=65536, skewed": (3_090_000, 1, 65_536, 39, "skewed", None),
}


def bag_bwd_row(torch, ids, w, dout, V, iters, what, smi):
    """embedding_bag's backward kernel on (ids, w, dout): bit-identical
    across two calls, bit-equal to its plain version run on CPU copies
    (one chain a row in ascending position from +0.0), and |kernel -
    float64| <= gamma_n sum|w dout| a row (n: its positions; the float64
    plain version on the card).  Then timed by CUDA events: the kernel
    (its memset included) on an order made beforehand, the sort apart,
    the plain version on the card, ``torch.zeros`` + ``index_add_`` over
    the products (the one library call: atomics, no fixed order) and
    the bound; and the card's own time of the kernel under
    ``torch.profiler``.  Returns the row."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    dev = dout.device
    n, L = ids.shape
    d, P = dout.shape[1], n * L
    got = ec.embedding_bag_backward(ids, w, dout, V)
    check(bits_equal(got, ec.embedding_bag_backward(ids, w, dout, V)),
          f"embedding_bag backward differs between calls ({what})")
    on_cpu = eref.embedding_bag_backward_ref(
        ids.cpu(), None if w is None else w.cpu(), dout.cpu(), V)
    check(bits_equal(got.cpu(), on_cpu),
          f"embedding_bag backward != plain on the CPU ({what})")
    del on_cpu
    wd = None if w is None else w.double()
    want = eref.embedding_bag_backward_ref(ids, wd, dout.double(), V)
    mass = eref.embedding_bag_backward_ref(
        ids, None if wd is None else wd.abs(), dout.double().abs(), V)
    cnt = torch.bincount(ids.reshape(-1).long(), minlength=V).double()
    lim = (cnt * U / (1 - cnt * U))[:, None] * mass
    diff = (got.double() - want).abs_()
    check(bool((diff <= lim).all()),
          f"embedding_bag backward outside the fp32 sum bound ({what})")
    row = {"f64_err": float(diff.max()), "longest_chain": int(cnt.max()),
           "rows_named": int((cnt > 0).sum())}
    del got, want, mass, lim, diff, cnt, wd
    torch.cuda.empty_cache()
    order = ec.sort_ids(ids)
    flat = ids.reshape(-1)
    prods = dout.repeat_interleave(L, 0)
    if w is not None:
        prods = w.reshape(-1, 1) * prods
    row["ms"] = cuda_ms(
        lambda: ec.launch_backward(ids, w, dout, V, order=order), iters)
    row["sort_ms"] = cuda_ms(lambda: ec.sort_ids(ids), iters)
    row["plain_ms"] = cuda_ms(
        lambda: eref.embedding_bag_backward_ref(ids, w, dout, V),
        max(iters // 5, 2))
    row["library_ms"] = cuda_ms(lambda: torch.zeros(
        (V, d), device=dev).index_add_(0, flat, prods), iters)
    # dout, the ids and weights read once, dtable written once; a product
    # and an add a (position, column), each over the fp32 add rate
    bytes_ = (n * d * 4 + P * ids.element_size()
              + (0 if w is None else P * 4) + V * d * 4)
    ops = P * d * (1 if w is None else 2)
    row["bound_ms"], row["bound_by"] = bound(
        bytes_, {"fp32 adds and multiplies": (ops, FADD_PER_S)})
    row["device_ms"], top = device_profile(
        torch, lambda _: ec.launch_backward(ids, w, dout, V, order=order),
        range(5 if n > B else 20))
    check(row["device_ms"] > 0, f"the profiler traced no device time for "
          f"the embedding_bag backward ({what})")
    row["device_top"] = top
    row["shape"] = {"V": V, "d": d, "n_bags": n, "L": L,
                    "weights": w is not None}
    del order, flat, prods
    torch.cuda.empty_cache()
    print(f"   {what} (V={V} d={d} n_bags={n} L={L}): {row['ms']:.4f} ms "
          f"kernel (device {row['device_ms']:.4f}), sort {row['sort_ms']:.4f}"
          f" ms, plain {row['plain_ms']:.4f} ms, zeros + index_add_ "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); longest chain {row['longest_chain']}, "
          f"|err| vs float64 {row['f64_err']:.3e}; bit-identical twice, "
          f"bit-equal to the CPU, on {smi}")
    return row


def ctr_train_phases(torch, np, dev, smi, data):
    """Phases 23-24: the embedding_bag backward on the card, then CTR
    training at full width (seven bundles, one on the card at a time).
    Returns (the backward's entry of the kernels line, the forward's
    launches in training, the ctr_train summary)."""
    from repro_torch.configs import get_bundle
    from repro_torch.configs.recsys_archs import DLRM_VOCABS
    from repro_torch.data.clicks import ClickDataConfig, SyntheticClicks
    from repro_torch.data.clicks import dien_batch
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    counters = (ec, kc, sc, lc)
    gen = torch.Generator(device=dev).manual_seed(23)

    t0 = phase("embedding_bag backward on the card: bit-identical, bit-equal"
               " to the CPU, fp32 sum bound; timed (CUDA events)")
    shapes = {}
    for what, (V, d, n, L, kind, weights) in BAG_BWD_SHAPES.items():
        ids = torch.randint(0, V, (n, L), generator=gen, device=dev)
        if kind == "padded":
            ids[torch.rand((n, L), generator=gen, device=dev) < 0.1] = 0
        elif kind == "skewed":
            ids.view(-1)[::2] = V // 3
        w = (ids > 0).float() if weights == "masked" else None
        dout = torch.randn((n, d), generator=gen, device=dev)
        shapes[what] = bag_bwd_row(torch, ids, w, dout, V,
                                   5 if n > B else 50, what, smi)
        del ids, w, dout
    done(t0)

    t0 = phase(f"main path: CTR training at full width, B={CTR_B}, adamw lr "
               f"3e-3, TF32 off, 1 + {CTR_STEPS} steps per bundle")
    rows = sum(DLRM_VOCABS)
    table_gb = rows * 64 * 4 / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    print(f"   dlrm-rm2 (full table) is not trained on one card: its fp32 "
          f"table is {rows:,} rows x 64 x 4 B = {table_gb:.1f} GB, and "
          f"adamw keeps the values, a dense gradient and two moments: "
          f"4 x {table_gb:.1f} = {4 * table_gb:.1f} GB against the card's "
          f"{card_gb:.1f} GB ({smi})")

    cache = {}

    def make_batches(name, model):
        """1 + CTR_STEPS host batches of CTR_B rows (one set a family):
        the two-tower smoke template's distributions at full shape from
        (seed 0, step); SyntheticClicks for FM and DLRM; dien_batch over
        phase 7's sequences for DIEN."""
        fam = name.replace("-jpq", "")
        if fam in cache:
            return cache[fam]
        t1 = time.perf_counter()
        steps = range(1 + CTR_STEPS)
        if fam == "two-tower-retrieval":
            n_items, H = model.cfg.n_items, model.cfg.hist_len

            def one(s):
                r = np.random.default_rng((0, s))
                return {"user_hist": r.integers(0, n_items + 1, (CTR_B, H)),
                        "pos_item": r.integers(1, n_items + 1, (CTR_B,)),
                        "logq": np.zeros(CTR_B, np.float32)}
            bs = [one(s) for s in steps]
        elif fam == "dien":
            bs = [dien_batch(data, s, CTR_B, model.cfg.seq_len)
                  for s in steps]
        else:
            clicks = SyntheticClicks(ClickDataConfig(
                n_dense=getattr(model.cfg, "n_dense", 13),
                vocab_sizes=model.cfg.vocabs(), seed=0))
            keys = ("sparse", "label") if fam == "fm" else \
                ("dense", "sparse", "label")
            bs = [{k: b[k] for k in keys}
                  for b in (clicks.batch(s, CTR_B) for s in steps)]
        cache[fam] = bs, (time.perf_counter() - t1) / len(bs) * 1e3
        return cache[fam]

    def grads_at(model, params, batch):
        """(loss, gradients of the float leaves) of one step on batch."""
        fl = [x for x in tree_leaves(params) if torch.is_floating_point(x)]
        for x in fl:
            x.requires_grad_(True)
        try:
            loss, _ = model.train_loss(params, {
                k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            g = torch.autograd.grad(loss, fl, allow_unused=True)
        finally:
            for x in fl:
                x.requires_grad_(False)
        return float(loss.detach()), g

    summary, main_rows, fwd_launches = {}, {}, 0
    opt = OptConfig(lr=3e-3)
    for name in CTR_TRAIN_ARCHS:
        free_card(torch, dev, name)
        t1 = time.perf_counter()
        model = get_bundle(name).make_model(device=dev, seed=0)
        params = model.params()
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t1
        bs, batch_ms = make_batches(name, model)
        # the warm-up step picks microbatches: the smallest power of two
        # whose peak stays under PEAK_LIMIT (the step's slices take B / n
        # rows each; for the two-tower model B / n in-batch negatives)
        n, over = 1, []
        while True:
            for c in counters:
                c.reset_launches()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            warm = Trainer(model, opt, TrainConfig(
                steps=1, log_every=1, eval_every=0, microbatches=n),
                data_fn=lambda s: bs[0])
            try:
                _, h0 = warm.run(params=params)
                warm_peak = torch.cuda.max_memory_allocated(dev)
            except torch.cuda.OutOfMemoryError:
                warm_peak = None
            del warm
            if warm_peak is not None and warm_peak <= PEAK_LIMIT:
                break
            over.append({"microbatches": n, "peak_gb": None if warm_peak
                         is None else warm_peak / 1e9})
            print(f"   {name}: microbatches={n} "
                  + ("ran out of memory" if warm_peak is None else
                     f"peaked at {warm_peak / 1e9:.2f} GB")
                  + f" (limit {PEAK_LIMIT / 1e9:.0f} GB): trying {2 * n}")
            n *= 2
            check(n <= 16, f"{name}: no microbatches up to 16 fits")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = Trainer(model, opt, TrainConfig(
            steps=CTR_STEPS, log_every=1, eval_every=0, microbatches=n),
            data_fn=lambda s: bs[s + 1])
        _, hist = tr.run(params=params)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: v for c in counters for k, v in c.launches.items()
                    if v}
        losses = [h0[0]["loss"]] + [h["loss"] for h in hist if "loss" in h]
        steps_s = [h["sec"] for h in hist if "sec" in h]
        check(len(losses) == 1 + CTR_STEPS and
              all(np.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        check(peak <= PEAK_LIMIT, f"{name}: peak {peak / 1e9:.2f} GB")
        if name in BAG_ARCHS:
            check(ec.launches["embedding_bag"] > 0 and
                  ec.launches["embedding_bag_backward"] > 0,
                  f"the {name} training run did not launch embedding_bag "
                  f"forward and backward: {launches}")
            fwd_launches += ec.launches["embedding_bag"]
        # one step at B = 64 through the kernels against the same step
        # with the plain versions in their place, on the card
        small = {k: v[:64] for k, v in bs[0].items()}
        k_loss, k_g = grads_at(model, params, small)
        with plain_bag():
            p_loss, p_g = grads_at(model, params, small)
        check(abs(k_loss - p_loss) <= 1e-5 * abs(p_loss),
              f"{name}: B=64 loss {k_loss} (kernels) vs {p_loss} (plain)")
        worst = 0.0
        for a, b in zip(k_g, p_g):
            if b is None:
                continue
            scale = float(b.abs().max())
            e = float((a - b).abs().max())
            check(e <= 1e-4 * scale, f"{name}: B=64 gradient {e} vs scale "
                  f"{scale} (kernels vs plain)")
            worst = max(worst, e / scale if scale else 0.0)
        del k_g, p_g
        # where a step's time goes: the card's busy time (kernels and
        # copies) in one more step under the profiler, against the median
        one = Trainer(model, opt, TrainConfig(
            steps=1, log_every=1, eval_every=0, microbatches=n),
            data_fn=lambda s: bs[1])
        busy_ms, top = device_profile(
            torch, lambda _: one.run(params=params), [None], top_n=6)
        del one
        if name in BAG_ARCHS:
            # the backward at the main path's own inputs: the last
            # slice's ids of the first timed batch
            rows_ = CTR_B // n
            if name.startswith("two-tower"):
                ids = torch.as_tensor(bs[1]["user_hist"][-rows_:],
                                      device=dev)
                w = (ids > 0).float()
                V, d = params["item_emb"]["table"].shape
            else:
                ids = (torch.as_tensor(bs[1]["sparse"][-rows_:], device=dev)
                       + model.offsets[None, :]).contiguous()
                w, V, d = None, params["linear"].shape[0], 1
            dout = torch.randn((rows_, d), generator=gen, device=dev)
            main_rows[name] = bag_bwd_row(
                torch, ids, w, dout, V, 10, f"{name} training slice", smi)
            del ids, w, dout
        summary[name] = {
            "microbatches": n, "over_limit": over,
            "step_ms": float(np.median(steps_s)) * 1e3,
            "steps_ms": [x * 1e3 for x in steps_s], "batch_ms": batch_ms,
            "peak_gb": peak / 1e9, "warmup_peak_gb": warm_peak / 1e9,
            "first_loss": losses[0], "last_loss": losses[-1],
            "losses": losses, "build_s": build_s, "launches": launches,
            "b64_grad_worst": worst, "b64_loss": [k_loss, p_loss],
            "device_busy_ms": busy_ms, "top_device_ms": top}
        step_ms = summary[name]["step_ms"]
        print(f"   {name}: microbatches={n}, step {step_ms:.1f} ms (median "
              f"of {CTR_STEPS}), batch {batch_ms:.1f} ms on the "
              f"host, peak {peak / 1e9:.2f} GB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, launches {launches}; B=64 kernels vs "
              f"plain: loss {k_loss:.7f} / {p_loss:.7f}, worst gradient "
              f"{worst:.2e} of its leaf's largest entry; built in "
              f"{build_s:.1f}s, on {smi}")
        print(f"   {name}: device busy {busy_ms:.1f} ms of a step; top: "
              + "; ".join(f"{k} {v:.1f} ms" for k, v in top))
        del model, params, tr, hist, bs
        if name.endswith("-jpq"):        # its family's last bundle
            cache.pop(name[:-len("-jpq")], None)
    done(t0)

    main = main_rows["two-tower-retrieval"]
    entry = {"name": "embedding_bag_backward", "route": "cuda",
             "source": "src/repro_torch/csrc/embedding_bag.cu",
             "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:59",
             "launches": sum(r["launches"].get("embedding_bag_backward", 0)
                             for r in summary.values()),
             "max_abs_err": 0.0, "f64_err": max(
                 r["f64_err"] for r in [*shapes.values(),
                                        *main_rows.values()]),
             "ms": main["ms"], "sort_ms": main["sort_ms"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": main["library_ms"],
             "device_ms": main["device_ms"], "shape": main["shape"],
             "main_path": main_rows, "shapes": shapes}
    return entry, fwd_launches, summary


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
        per_req = []

        def counted(reqs, kern=kern, per_req=per_req):
            """The requests serve_loop would draw, with the launches of
            ``kern`` each one made (read when the loop asks for the next,
            after the request and its accounting)."""
            last = None
            for r in reqs:
                if last is not None:
                    per_req.append(kc.launches[kern] - last)
                last = kc.launches[kern]
                yield r
            per_req.append(kc.launches[kern] - last)

        kc.reset_launches()
        res = serve_mod.serve_loop(model, params, template, args, requests=(
            counted(serve_mod.make_requests(template, B, REQUESTS + 1,
                                            args.seed, reserved=(0,)))))
        counts = dict(kc.launches)
        check(counts[kern] > 0, f"main path '{name}' never launched {kern}")
        check(sum(per_req) == counts[kern] and len(per_req) == REQUESTS + 1,
              f"per-request launches of {kern} do not add up")
        res["launches"] = counts
        # the timed requests' launches of the path's kernel, and the p50
        # of the requests at each count
        res["launches_per_request"] = per_req[1:]
        lat = np.asarray(res["lat_ms"])
        res["p50_ms_by_launches"] = {
            int(n): float(np.percentile(lat[np.asarray(per_req[1:]) == n],
                                        50))
            for n in sorted(set(per_req[1:]))}
        runs[name] = res
        print(f"   {name}: p50={res['p50_ms']:.3f}ms p99={res['p99_ms']:.3f}"
              f"ms skip={res['skip']} launches={counts} "
              f"({REQUESTS + 1} requests incl. warm-up) on {smi}")
        print(f"   {name}: {kern} launches a timed request "
              f"{res['launches_per_request']}; p50 by launches "
              + ", ".join(f"{n}: {v:.3f} ms ({per_req[1:].count(n)} "
                          f"requests)"
                          for n, v in res["p50_ms_by_launches"].items()))

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
    bytes_u, adds_u, lookups_u = topk_work(B, n_rows, k)
    group = kc.pruned_group_size()        # queries per block (the library's)

    def pruned_work(st, skip):
        """(bytes, fp32 adds, LUT lookups, swept items) of a pruned sweep
        whose skip map [groups, tiles] is ``skip``."""
        nt = st.present.shape[0]
        tile_items = torch.full((nt,), st.block_n, device=dev)
        tile_items[-1] = n_rows - (nt - 1) * st.block_n
        rows_per_group = torch.full((skip.shape[0],), group, device=dev)
        rows_per_group[-1] = B - group * (skip.shape[0] - 1)
        swept = (1 - skip).to(torch.int64)
        scored = int((swept * tile_items[None, :] * rows_per_group[:, None]
                      ).sum()) * M                  # (query, item, split)s
        lookups = scored + B * nt * M * BC        # + the bound's LUT reads
        adds = scored + B * nt * M * (BC + 1)     # + the bound's max/add
        items = int(((1 - skip.min(0).values) * tile_items).sum())
        bytes_ = (items * (M + 4) + nt * M * BC * 4 + lut_bytes + B * 4
                  + 2 * out_bytes)
        return bytes_, adds, lookups, items

    pruned_out = kc.jpq_topk_pruned(P, st.codes, st.ids, st.present, *cold,
                                    k=k, block_n=st.block_n,
                                    tie_break_ids=st.tie_break_ids)
    skip = pruned_out[2]
    bytes_p, adds_p, lookups_p, swept_items = pruned_work(st, skip)
    # the general code path (codes read a byte at a time), which uint8
    # codes at m = 8 take when their rows are not 8-byte aligned, against
    # the main path's one 8-byte load a row
    codes_odd = odd_address(torch, st.codes)
    gen_out = kc.jpq_topk_pruned(P, codes_odd, st.ids, st.present, *cold,
                                 k=k, block_n=st.block_n,
                                 tie_break_ids=st.tie_break_ids)
    check(key_equal(gen_out[:2], pruned_out[:2]) and
          torch.equal(gen_out[2], skip),
          "jpq_topk_pruned's general path != its 8-byte path")
    general_ms = {"jpq_topk_pruned": cuda_ms(lambda: kc.jpq_topk_pruned(
        P, codes_odd, st.ids, st.present, *cold, k=k, block_n=st.block_n,
        tie_break_ids=st.tie_break_ids), 20)}
    print(f"   jpq_topk_pruned, general code path (codes at an odd "
          f"address): {general_ms['jpq_topk_pruned']:.4f} ms, bit-equal "
          f"to the 8-byte path ({times['jpq_topk_pruned'][0]:.4f} ms)")
    del codes_odd, gen_out, pruned_out
    # the unpruned kernel: its launch shape at k = 10 and 100 (the
    # wrapper's record), its general code path at k = 10 against the
    # 8-byte path and the plain version, and its time at k = 100
    top_out = kc.jpq_topk(P, codes, k)
    launch_shape = dict(kc.launch_shape)
    codes_odd = odd_address(torch, codes)
    gen_top = kc.jpq_topk(P, codes_odd, k)
    top_plain = ops.jpq_topk_scan(P, codes, k,
                                  block_n=ops.scan_block_n(n_rows))
    check(key_equal(gen_top, top_out) and key_equal(gen_top, top_plain),
          "jpq_topk's general path != its 8-byte path or the plain version")
    general_ms["jpq_topk"] = cuda_ms(lambda: kc.jpq_topk(P, codes_odd, k), 20)
    k100_ms = cuda_ms(lambda: kc.jpq_topk(P, codes, 100), 20)
    launch_shape_k100 = dict(kc.launch_shape)
    print(f"   jpq_topk launch shape k={k}: {launch_shape}; "
          f"k=100: {launch_shape_k100}")
    print(f"   jpq_topk, general code path (codes at an odd address): "
          f"{general_ms['jpq_topk']:.4f} ms, bit-equal to the 8-byte path "
          f"({times['jpq_topk'][0]:.4f} ms) and the plain version; k=100: "
          f"{k100_ms:.4f} ms, on {smi}")
    del codes_odd, gen_top, top_out, top_plain

    # the pruned kernel a second time, on a skip-heavy catalogue at full
    # width: codes that follow each item's rank (the card tests'
    # _structured catalogue), swept in popularity order, and a LUT that
    # falls with the code, so the running k-th value soon passes the
    # bounds of later tiles
    rank = torch.randperm(n_rows, generator=gen, device=dev)
    sh_codes = (rank[:, None] * BC // n_rows
                + torch.randint(0, 2, (n_rows, M), generator=gen,
                                device=dev)).clamp_(0, BC - 1).to(torch.uint8)
    sh_P = ops.canonicalise_lut(
        -(torch.arange(BC, device=dev) / BC)[None, None, :] * 4.0
        + 0.1 * torch.randn((B, M, BC), generator=gen, device=dev))
    sh_st = ops.prepare_pruning(sh_codes, BC, st.block_n,
                                perm=torch.argsort(rank))
    sh_args = (sh_P, sh_st.codes, sh_st.ids, sh_st.present, *cold)
    sh_kw = dict(k=k, block_n=sh_st.block_n,
                 tie_break_ids=sh_st.tie_break_ids)
    sh_kern = kc.jpq_topk_pruned(*sh_args, **sh_kw)
    sh_plain = ops.jpq_topk_scan_pruned(*sh_args, **sh_kw)
    check(key_equal(sh_kern[:2], sh_plain[:2]) and
          torch.equal(sh_kern[2].min(0).values, sh_plain[2]),
          "jpq_topk_pruned != plain on the skip-heavy catalogue")
    sh_bytes, sh_adds, sh_lookups, sh_items = pruned_work(sh_st, sh_kern[2])
    sh_bound, sh_by, sh_parts = bound_of(sh_bytes, sh_adds, sh_lookups)
    skip_heavy = {
        "ms": cuda_ms(lambda: kc.jpq_topk_pruned(*sh_args, **sh_kw), 20),
        "plain_ms": cuda_ms(
            lambda: ops.jpq_topk_scan_pruned(*sh_args, **sh_kw), 2),
        "bound_ms": sh_bound, "bound_by": sh_by, "swept_items": sh_items,
        "skipped_group_tiles": int(sh_kern[2].sum()),
        "group_tiles": sh_kern[2].numel()}
    print(f"   jpq_topk_pruned, skip-heavy catalogue: "
          f"{skip_heavy['ms']:.4f} ms kernel, {skip_heavy['plain_ms']:.4f} "
          f"ms plain, bound over the swept tiles {sh_bound:.4f} ms ({sh_by}; "
          f"bytes {sh_parts[0]:.4f}, fp32 adds and the tile bounds' maxes "
          f"{sh_parts[1]:.4f}, LUT lookups {sh_parts[2]:.4f} ms); swept "
          f"{sh_items} of {n_rows} items (skip map: "
          f"{skip_heavy['skipped_group_tiles']} of "
          f"{skip_heavy['group_tiles']} group-tiles); bit-equal to plain")
    del sh_codes, sh_P, sh_st, sh_args, sh_kern, sh_plain, rank
    kernels = []
    for name, bytes_, adds, lookups, src, line in (
            ("jpq_topk", bytes_u, adds_u, lookups_u, "jpq_topk.cu", 329),
            ("jpq_topk_pruned", bytes_p, adds_p, lookups_p,
             "jpq_topk_pruned.cu", 281)):
        b_ms, b_by, (t_bytes, t_adds, t_lookups) = bound_of(bytes_, adds,
                                                            lookups)
        ms, plain_ms = times[name]
        run = runs["fused" if name == "jpq_topk" else "pruned"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/jpq_topk/jpq_topk.py:{line}",
            "launches": run["launches"][name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        kernels[-1]["general_path_ms"] = general_ms[name]
        if name == "jpq_topk_pruned":
            kernels[-1]["skip_heavy"] = skip_heavy
        else:
            kernels[-1]["launch_shape"] = launch_shape
            kernels[-1]["k100_ms"] = k100_ms
            kernels[-1]["launch_shape_k100"] = launch_shape_k100
        print(f"   {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms, fp32 "
              f"adds {t_adds:.4f} ms, LUT lookups {t_lookups:.4f} ms), "
              f"B={B} k={k} on {smi}")
    print(f"   pruned sweep swept {swept_items} of {n_rows} items "
          f"(skip map: {int(skip.sum())} of {skip.numel()} group-tiles)")
    done(t0)

    del P, st, codes, params, model, h
    torch.cuda.empty_cache()
    train_kernels, data, codes_np = train_phases(torch, np, dev, smi)
    kernels += train_kernels
    gc.collect()
    torch.cuda.empty_cache()
    arch_phases(torch, np, dev, smi, data, codes_np)
    objective_phases(torch, np, dev, smi, data, codes_np)
    seq_model, seq_params, _ = checkpoint_phase(torch, np, dev, smi, data,
                                                codes_np)
    semantic_phases(torch, np, dev, smi, data, template, seq_model,
                    seq_params)
    del codes_np, seq_model, seq_params
    gc.collect()
    torch.cuda.empty_cache()
    example_phases(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    bag_kernel, serve_ctr = ctr_phases(torch, np, dev, smi, data, template)
    gc.collect()
    torch.cuda.empty_cache()
    bag_bwd, bag_train_launches, ctr_train = ctr_train_phases(
        torch, np, dev, smi, data)
    bag_kernel["train_launches"] = bag_train_launches
    kernels += [bag_kernel, bag_bwd]

    print(json.dumps({"serve": {
        n: {key: r[key] for key in ("path", "p50_ms", "p99_ms", "skip",
                                    "demoted_rows", "launches",
                                    "launches_per_request",
                                    "p50_ms_by_launches")}
        for n, r in runs.items()}, "card": smi}))
    print(json.dumps({"serve_ctr": serve_ctr, "card": smi}))
    print(json.dumps({"ctr_train": ctr_train, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
