"""Serving entrypoint: batched retrieval / scoring loop on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch two-tower-retrieval-jpq --requests 20 --batch-size 64 \
        --fused --prune --perm --warm
    PYTHONPATH=src python -m repro_torch.launch.serve --arch fm

Builds the arch's smoke model, then drives fresh-id request batches
through it and reports latency percentiles: a retrieval arch (one with
``bind_engine``/``retrieve``) through its bound retrieval engine, any
other (FM, DLRM-RM2, DIEN, MACE) through ``model.serve``
(``path=serve``).  MACE's requests are the reference's: every field,
node or edge, takes ``--batch-size`` rows, its indices re-drawn over
the template's range, so a batch smaller than the template's 32 nodes
names nodes it does not hold and raises (the reference reads such a
sender as NaN and drops such a receiver's message).
Runs on ``--device cuda`` (the default; the kernels) or ``--device cpu``
(their plain versions).  ``--fused/--no-fused``, ``--prune``, ``--perm``,
``--warm [decay]``, ``--head semantic`` (constrained beam decoding over
the codes, ``path=semantic[@W]``) and ``--beams W`` are the reference's
retrieval flags; ``--ckpt-dir`` restores the parameters from the latest
checkpoint there before serving.

``--mesh S`` serves any arch from a catalogue row-sharded S ways, as
the reference's ``--mesh S`` does on S host devices: ``serve_mesh``
spawns S ranks as a ``(1, S)`` mesh (``launch.mesh.spawn``).  Each rank
builds the model from the seed, keeps its rows of every catalogue leaf
S divides (``bridge.keep_serving_blocks``, for a model with a
catalogue ``keep_local_rows``: the two-tower item table or
codes, FM's and DLRM's tables and FM's ``linear``; DIEN's 1,000,001
rows divide by neither 2 nor 4 and stay whole, as in the reference),
builds the one global ``PruneState`` with ``shards=S`` and draws the
same seeded request stream, so no batch crosses ranks; rank 0 prints
the line, with ``mesh=S`` and the transport.  FM, DLRM-RM2 and DIEN
serve through ``model.serve``, their fields' rows gathered exactly
across the ranks (``core/sharded.take_rows``), so each response is the
unsharded path's, bit for bit (a zero's sign aside).  MACE has no
catalogue: each rank keeps its block of the readout, which is all the
reference's placement splits over ``"model"`` (``keep_serving_blocks``
without a catalogue axis is ``keep_local_blocks``), serves the whole
graph and runs the readout
tensor-parallel.  On CUDA each rank takes a card of its own (NCCL), or with
``--share-card`` every rank shares the one card and the collectives run
over gloo, staged through host memory; on the CPU the ranks are gloo
processes.

    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 4 \
        --share-card --prune --perm --warm
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mesh 2
"""
from __future__ import annotations

import argparse
import functools
import os
import shutil
import tempfile
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
                    help="model-shard the catalogue S ways over S ranks "
                         "(0 = no mesh)")
    ap.add_argument("--share-card", action="store_true",
                    help="with --mesh on CUDA: every rank on the one card, "
                         "collectives over gloo staged through host "
                         "memory (else a card each, NCCL)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the parameters from the latest "
                         "checkpoint in this directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def _is_retrieval(model) -> bool:
    return hasattr(model, "retrieve") and hasattr(model, "bind_engine")


def serve_loop(model, params, template, args, requests=None, *,
               keep_outputs: bool = False) -> dict:
    """Drive ``args.requests`` fresh-id batches (after one warm-up)
    through the model on the device its parameters live on: a retrieval
    model through its bound engine, any other through
    ``model.serve(params, req)``.  The requests are ``make_requests``
    draws from ``template`` unless ``requests`` (an iterable of
    ``args.requests + 1`` dicts of arrays) is given.  Each request's
    window runs from the host arrays to results on the card
    (``torch.cuda.synchronize``); the stats readback and the warm-floor
    EMA update stay outside it.  Prints one summary line (on rank 0 of a
    mesh) and returns it as a dict (latencies in ms; ``lat_ms`` each
    timed request's, in order; ``outputs`` each timed request's result
    on the CPU when ``keep_outputs``: (values, ids) of a retrieval, the
    scores of ``model.serve``).  Under the ambient ``"model"``
    mesh (``serve_mesh``) it also counts each timed request's
    collectives: ``comm_ms``, ``comm_bytes`` and ``comm_calls``."""
    from repro_torch.dist import rules as _rules
    mesh = _rules._CTX.mesh
    if mesh is not None and mesh.shape["model"] <= 1:
        mesh = None
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
            return "serve", None, None, {}
        reserved = ()
    if requests is None:
        requests = make_requests(template, args.batch_size,
                                 args.requests + 1, args.seed,
                                 reserved=reserved)
    reqs = iter(requests)
    lats, comm, outputs = [], [], []
    with torch.inference_mode():
        account(fn(next(reqs)))      # first call: builds the kernels
        for req in reqs:
            c0 = dict(mesh.comm) if mesh is not None else None
            t0 = time.perf_counter()
            out = fn(req)
            lats.append((time.perf_counter() - t0) * 1e3)
            if mesh is not None:
                comm.append({key: mesh.comm[key] - c0[key] for key in c0})
            account(out)
            if keep_outputs:
                outputs.append(tuple(x.cpu() for x in out[:2])
                               if isinstance(out, tuple) else out.cpu())
    lats = np.asarray(lats)
    mode, skip, demoted, extra_res = finish()
    res = {"arch": args.arch, "device": str(dev), "batch": args.batch_size,
           "n": len(lats), "path": mode, "seed": args.seed,
           "p50_ms": float(np.percentile(lats, 50)),
           "p99_ms": float(np.percentile(lats, 99)),
           "skip": skip, "demoted_rows": demoted,
           "lat_ms": [float(x) for x in lats], **extra_res}
    if keep_outputs:
        res["outputs"] = outputs
    extra = "" if res["skip"] is None else f" skip={res['skip']:.3f}"
    if mesh is not None:
        res.update(mesh=mesh.shape["model"], rank=mesh.rank,
                   transport=mesh.transport,
                   comm_ms=[c["seconds"] * 1e3 for c in comm],
                   comm_bytes=[c["bytes"] for c in comm],
                   comm_calls=[c["calls"] for c in comm])
        extra += f" mesh={res['mesh']} transport={mesh.transport}"
        if mesh.rank != 0:
            return res
    print(f"{args.arch}: batch={args.batch_size} n={res['n']} "
          f"path={mode} device={dev} seed={args.seed} "
          f"p50={res['p50_ms']:.2f}ms p99={res['p99_ms']:.2f}ms{extra}",
          flush=True)
    return res


def _retrieval(model, params, template, args, sync):
    """The retrieval path of ``serve_loop``: (dispatch(req) -> output on
    the card, account(output) outside the timed window, finish() ->
    (path label, skip fraction, demoted rows, extra result keys: each
    pruned call's ``total_tiles``))."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import sharded
    from repro_torch.core.assign import popularity_permutation
    from repro_torch.core.serve import ThresholdState

    spec = engine_mod.spec_from_args(args, kind=model.emb.cfg.kind,
                                     k=args.top_k)
    dev = model.device
    pruned = spec.prune
    state = None
    if pruned:
        # codes-only, built once outside the request path; on a mesh the
        # one global permute-then-shard state, from the whole codes
        rows = model.emb.cfg.n_items
        codes = sharded.whole(params["item_emb"]["codes"], rows)
        perm = None
        if spec.perm != "none":
            perm = popularity_permutation(
                _template_popularity(template, rows))
        state = engine_mod.build_prune_state(codes, model.emb.cfg.b,
                                             shards=args.mesh, perm=perm)
        del codes
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
    tiles = []                               # total_tiles, each call

    def account(out):
        if not pruned:
            return
        stats = out[-1]
        if warm_state is not None:
            warm_state.update(stats["theta"].cpu().numpy())
        totals["skipped"] += float(stats["skipped_tiles"])
        totals["tiles"] += float(stats["total_tiles"])
        totals["demoted"] += int(stats["demoted"].sum())
        tiles.append(int(stats["total_tiles"]))

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
        return (mode, skip, totals["demoted"] if pruned else None,
                {"total_tiles": tiles} if pruned else {})

    return dispatch, account, finish


def _check_arch(arch: str) -> None:
    from repro_torch.configs import get_bundle, list_archs
    from repro_torch.configs.registry import LM_ARCHS
    if arch in LM_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is an LM: serving it through this CLI is not "
            f"yet ported, nor is it in the reference's CLI (its "
            f"TransformerLM has no serve); the port serves an LM through "
            f"TransformerLM.prefill / decode_step")
    if arch not in list_archs():
        get_bundle(arch)          # raises: unknown


def smoke_model(arch: str, device):
    """The arch's smoke model and its request template (the batch less
    its labels): the CLI's model, and ``serve_mesh``'s default."""
    from repro_torch.configs import get_bundle
    _check_arch(arch)
    model, batch = get_bundle(arch).make_smoke(device=device)
    return model, {k: v for k, v in batch.items()
                   if k not in ("label", "labels")}


def _restore(args, params) -> None:
    if args.ckpt_dir:
        from repro_torch.ckpt import restore_values
        step = restore_values(args.ckpt_dir, params)
        print(f"restored step {step} from {args.ckpt_dir}")


def _mesh_rank(mesh, args, make, out_dir, keep_outputs):
    """One rank of ``serve_mesh``: build the model, keep its rows of the
    catalogue (MACE: its block of the readout), run ``serve_loop`` under
    the mesh, save the result (with this rank's kernel launches) as
    ``out_dir/rank<r>.pt``."""
    from repro_torch import bridge, fp32_matmuls
    from repro_torch.dist import use_mesh_rules
    from repro_torch.kernels.embedding_bag import cuda as bag_cuda
    from repro_torch.kernels.jpq_topk import cuda as topk_cuda
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)            # S processes share the cores
    fp32_matmuls()
    model, template = make(mesh.device)
    _restore(args, model.params())
    bridge.keep_serving_blocks(model, mesh)
    topk_cuda.reset_launches()
    bag_cuda.reset_launches()
    with use_mesh_rules(mesh):
        res = serve_loop(model, model.params(), template, args,
                         keep_outputs=keep_outputs)
    res["launches"] = {**topk_cuda.launches, **bag_cuda.launches}
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def serve_mesh(args, *, make=None, keep_outputs: bool = False,
               timeout=None) -> list:
    """``--mesh S``: spawn S ranks as a ``(1, S)`` mesh, each serving
    ``args`` through ``serve_loop`` from its rows of the catalogue, and
    return every rank's result dict, in rank order (``launches``: the
    rank's kernel launches).  ``make(device) -> (model, template)``
    builds the model on each rank (default: the arch's smoke model); it
    must be a module-level callable (spawn pickles it) and deterministic,
    so every rank builds the same weights and draws the same requests.
    The kernels are built here, before the ranks start, so they only
    load them."""
    from repro_torch import resolve_device
    from repro_torch.launch import mesh as mesh_mod
    if make is None:
        _check_arch(args.arch)
    S = int(args.mesh)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        if not args.share_card and torch.cuda.device_count() < S:
            raise ValueError(
                f"--mesh {S} needs {S} cards, this machine has "
                f"{torch.cuda.device_count()}: pass --share-card to run "
                f"the {S} ranks on one card")
        from repro_torch.kernels import build
        build.build()
    make = make or functools.partial(smoke_model, args.arch)
    out = tempfile.mkdtemp(prefix="repro_torch_serve-")
    try:
        mesh_mod.spawn(_mesh_rank, S, (args, make, out, keep_outputs),
                       device=dev, model=S, share_card=args.share_card,
                       timeout=timeout)
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(S)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from repro_torch import fp32_matmuls, resolve_device

    if args.mesh > 1:
        return serve_mesh(args)[0]
    if args.share_card:
        raise ValueError("--share-card shares one card between the ranks "
                         "of --mesh S > 1")
    dev = resolve_device(args.device)
    fp32_matmuls()
    model, template = smoke_model(args.arch, dev)
    _restore(args, model.params())
    return serve_loop(model, model.params(), template, args)


if __name__ == "__main__":
    main()
