"""Serving entrypoint: batched retrieval / scoring loop on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch two-tower-retrieval-jpq --requests 20 --batch-size 64 \
        --fused --prune --perm --warm
    PYTHONPATH=src python -m repro_torch.launch.serve --arch fm

Builds the arch's smoke model, then drives fresh-id request batches
through it and reports latency percentiles: a retrieval arch (one with
``bind_engine``/``retrieve``) through its bound retrieval engine, any
other (FM, DLRM-RM2, DIEN) through ``model.serve`` (``path=serve``).
Runs on ``--device cuda`` (the default; the kernels) or ``--device cpu``
(their plain versions).  ``--fused/--no-fused``, ``--prune``, ``--perm``,
``--warm [decay]``, ``--head semantic`` (constrained beam decoding over
the codes, ``path=semantic[@W]``) and ``--beams W`` are the reference's
retrieval flags; ``--ckpt-dir`` restores the parameters from the latest
checkpoint there before serving.  ``--mesh`` > 1 is not yet ported and
raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def make_requests(template, batch_size: int, n_requests: int, seed: int,
                  reserved=()):
    """Per-iteration request batches from a template batch.

    Integer fields (ids) are re-drawn uniformly over the template's
    [min, max] range, minus the ``reserved`` ids (pad row 0); float
    fields are row-sampled from the template.  Deterministic in
    ``seed``; yields ``n_requests`` dicts of numpy arrays with leading
    dim ``batch_size`` — the reference's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    tmpl = {k: np.asarray(v) for k, v in template.items()}
    reserved = np.asarray(sorted({int(r) for r in reserved}), np.int64)
    for _ in range(n_requests):
        req = {}
        for name, v in tmpl.items():
            shape = (batch_size,) + v.shape[1:]
            if np.issubdtype(v.dtype, np.integer):
                lo, hi = int(v.min()), int(v.max())
                valid = np.arange(lo, hi + 1, dtype=np.int64)
                if reserved.size:
                    kept = np.setdiff1d(valid, reserved)
                    valid = kept if kept.size else valid
                req[name] = valid[
                    rng.integers(0, valid.size, shape)].astype(v.dtype)
            else:
                rows = rng.integers(0, v.shape[0], batch_size)
                req[name] = v[rows]
        yield req


def _template_popularity(template, n_rows: int) -> np.ndarray:
    """Per-row id counts tallied from every integer field of the request
    template — the stand-in for train-set counts."""
    counts = np.zeros(n_rows, np.int64)
    for v in template.values():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.integer):
            ids = v.reshape(-1)
            ids = ids[(ids >= 0) & (ids < n_rows)]
            np.add.at(counts, ids, 1)
    return counts


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.core import engine as engine_mod
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="two-tower-retrieval-jpq")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    engine_mod.add_spec_args(ap)
    ap.add_argument("--mesh", type=int, default=0,
                    help="model-shard the catalogue S ways (not yet "
                         "ported: S > 1 raises)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the parameters from the latest "
                         "checkpoint in this directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def _check_ported(args) -> None:
    if args.mesh > 1:
        raise NotImplementedError("--mesh > 1: multi-GPU serving is not "
                                  "yet ported (ROADMAP.md queue 1, item 9b)")


def _is_retrieval(model) -> bool:
    return hasattr(model, "retrieve") and hasattr(model, "bind_engine")


def serve_loop(model, params, template, args, requests=None) -> dict:
    """Drive ``args.requests`` fresh-id batches (after one warm-up)
    through the model on the device its parameters live on: a retrieval
    model through its bound engine, any other through
    ``model.serve(params, req)``.  The requests are ``make_requests``
    draws from ``template`` unless ``requests`` (an iterable of
    ``args.requests + 1`` dicts of arrays) is given.  Each request's
    window runs from the host arrays to results on the card
    (``torch.cuda.synchronize``); the stats readback and the warm-floor
    EMA update stay outside it.  Prints one summary line and returns
    it as a dict (latencies in ms; ``lat_ms`` each timed request's, in
    order)."""
    _check_ported(args)
    dev = model.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if _is_retrieval(model):
        fn, account, finish = _retrieval(model, params, template, args, sync)
        reserved = (0,)   # retrieval ids are 1-based: row 0 is padding
    else:
        def fn(req):
            out = model.serve(params, req)
            sync()
            return out

        def account(out):
            return None

        def finish():
            return "serve", None, None
        reserved = ()
    if requests is None:
        requests = make_requests(template, args.batch_size,
                                 args.requests + 1, args.seed,
                                 reserved=reserved)
    reqs = iter(requests)
    lats = []
    with torch.inference_mode():
        account(fn(next(reqs)))      # first call: builds the kernels
        for req in reqs:
            t0 = time.perf_counter()
            out = fn(req)
            lats.append((time.perf_counter() - t0) * 1e3)
            account(out)
    lats = np.asarray(lats)
    mode, skip, demoted = finish()
    res = {"arch": args.arch, "device": str(dev), "batch": args.batch_size,
           "n": len(lats), "path": mode, "seed": args.seed,
           "p50_ms": float(np.percentile(lats, 50)),
           "p99_ms": float(np.percentile(lats, 99)),
           "skip": skip, "demoted_rows": demoted,
           "lat_ms": [float(x) for x in lats]}
    extra = "" if res["skip"] is None else f" skip={res['skip']:.3f}"
    print(f"{args.arch}: batch={args.batch_size} n={res['n']} "
          f"path={mode} device={dev} seed={args.seed} "
          f"p50={res['p50_ms']:.2f}ms p99={res['p99_ms']:.2f}ms{extra}",
          flush=True)
    return res


def _retrieval(model, params, template, args, sync):
    """The retrieval path of ``serve_loop``: (dispatch(req) -> output on
    the card, account(output) outside the timed window, finish() ->
    (path label, skip fraction, demoted rows))."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.assign import popularity_permutation
    from repro_torch.core.serve import ThresholdState

    spec = engine_mod.spec_from_args(args, kind=model.emb.cfg.kind,
                                     k=args.top_k)
    dev = model.device
    pruned = spec.prune
    state = None
    if pruned:
        # codes-only, built once outside the request path
        codes = params["item_emb"]["codes"]
        perm = None
        if spec.perm != "none":
            perm = popularity_permutation(
                _template_popularity(template, codes.shape[0]))
        state = engine_mod.build_prune_state(codes, model.emb.cfg.b,
                                             perm=perm)
    bound = model.bind_engine(params, spec)
    if pruned:
        bound.engine.bind_catalogue(prune=state)
    warm_state = ThresholdState(spec.warm) \
        if pruned and spec.warm is not None else None

    def dispatch(req):
        req = {k: torch.as_tensor(v, device=dev) for k, v in req.items()}
        floor = None
        if warm_state is not None:
            floor = torch.as_tensor(warm_state.floor(args.batch_size),
                                    device=dev)
        out = bound.retrieve(req, floor=floor)
        sync()
        return out

    totals = {"skipped": 0.0, "tiles": 0.0, "demoted": 0}

    def account(out):
        if not pruned:
            return
        stats = out[-1]
        if warm_state is not None:
            warm_state.update(stats["theta"].cpu().numpy())
        totals["skipped"] += float(stats["skipped_tiles"])
        totals["tiles"] += float(stats["total_tiles"])
        totals["demoted"] += int(stats["demoted"].sum())

    def finish():
        # label what ran: a full table materialises even when --fused
        mode = "materialise" if bound.engine.strategy == "materialise" \
            else "fused"
        if spec.kind == "semantic":
            # the generative head: constrained beam decode over the codes
            mode = "semantic" + ("" if spec.beams is None
                                 else f"@{spec.beams}")
        if pruned:
            mode = "fused+prune" + ("+perm" if spec.perm != "none"
                                    else "") \
                + ("+warm" if warm_state is not None else "")
        skip = totals["skipped"] / totals["tiles"] if totals["tiles"] \
            else None
        return mode, skip, totals["demoted"] if pruned else None

    return dispatch, account, finish


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_ported(args)
    from repro_torch import fp32_matmuls, resolve_device
    from repro_torch.configs import get_bundle

    dev = resolve_device(args.device)
    fp32_matmuls()
    model, batch = get_bundle(args.arch).make_smoke(device=dev)
    params = model.params()
    if args.ckpt_dir:
        from repro_torch.ckpt import restore_values
        step = restore_values(args.ckpt_dir, params)
        print(f"restored step {step} from {args.ckpt_dir}")
    template = {k: v for k, v in batch.items()
                if k not in ("label", "labels")}
    return serve_loop(model, params, template, args)


if __name__ == "__main__":
    main()
