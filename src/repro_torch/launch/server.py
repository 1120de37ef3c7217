"""Request-level retrieval server entrypoint (continuous batching).

    PYTHONPATH=src python -m repro_torch.launch.server \
        --arch two-tower-retrieval-jpq --requests 200 --rate 500 \
        --max-batch 8 --max-delay-ms 5 --warm --json
    PYTHONPATH=src python -m repro_torch.launch.server --device cpu --smoke

Where ``repro_torch.launch.serve`` drives pre-batched requests through
the bound engine (the batch-latency loop), this entrypoint serves
SINGLE-USER requests arriving as an open-loop Poisson stream: the
micro-batching queue coalesces them into fixed-shape ``[max_batch,
L_bucket]`` batches under the ``--max-delay-ms`` budget, a replica pool
serves them against the registry's live (validated, hot-swappable)
catalogue version, and the metrics snapshot reports the end-to-end
request latency percentiles — queueing included, which is the number a
batch-latency loop cannot see.

The CLI builds the arch's smoke model on ``--device`` (``cuda`` by
default, the kernels; ``cpu``, their plain versions); ``serve_requests``
is its body, shared with ``chip_smoke.py``, which drives the full-width
model through it.  ``--smoke`` is the CI contract: after the run it
asserts p99 under ``--p99-budget-ms``, zero dropped/duplicated requests,
and a schema-valid metrics snapshot, exiting non-zero on any violation.
Every (bucket, replica) dispatch is warmed on dummy batches first (the
kernels' build and first launches are not serve latency).

``--mesh S`` serves from a catalogue row-sharded S ways, as the
reference's ``--mesh S`` does on S host devices: S processes
(``launch.mesh.spawn``), each a rank of a ``(1, S)`` mesh that builds
the model from the seed, keeps its rows (``bridge.keep_local_rows``),
publishes the one global pruning state (``shards=S``) and warms its
dispatches.  Rank 0 runs the server (queue, clock, load, metrics;
the snapshot's config ends ``+mesh{S}``), broadcasting each batch and
each publish; the other ranks follow (``serve.server.follow``).  On
CUDA each rank takes a card of its own (NCCL), or with
``--share-card`` every rank shares the one card (gloo staged through
host memory); on the CPU the ranks are gloo processes.

    PYTHONPATH=src python -m repro_torch.launch.server --device cpu \
        --mesh 2 --smoke
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.launch.serve import _template_popularity


def build_parser() -> argparse.ArgumentParser:
    """Request-server CLI: the retrieval flag cluster is the SHARED
    ``core.engine.add_spec_args`` set (identical flags to
    ``repro_torch.launch.serve``; only the prune DEFAULT differs: the
    request server serves pruned unless told otherwise)."""
    from repro_torch.core import engine as engine_mod
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="two-tower-retrieval-jpq")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated history-length buckets "
                         "(default: hist_len/2, hist_len)")
    ap.add_argument("--replicas", type=int, default=1)
    engine_mod.add_spec_args(ap, prune_default=True)
    ap.add_argument("--merge-every", type=int, default=4,
                    help="merge replica warm floors every N batches "
                         "(0 = never)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="model-shard the catalogue S ways over S ranks "
                         "(0 = no mesh)")
    ap.add_argument("--share-card", action="store_true",
                    help="with --mesh on CUDA: every rank on the one card, "
                         "collectives over gloo staged through host "
                         "memory (else a card each, NCCL)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="print the full metrics snapshot as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: assert the serving contract and "
                         "exit non-zero on violation")
    ap.add_argument("--p99-budget-ms", type=float, default=2000.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def serve_requests(model, params, args, *, on_ready=None, mesh=None,
                   clock=None):
    """Serve ``args.requests`` single-user requests, Poisson arrivals at
    ``args.rate`` on the real clock (or on ``clock``, a
    ``serve.VirtualClock``), through a ``RetrievalServer`` over
    ``model`` (a JPQ retrieval model) on the device its parameters live
    on.  The registry publishes the model's codes (popularity-permuted
    under ``--perm``), every (bucket, replica) dispatch is warmed, then
    ``on_ready(server)`` is called, if given, just before the timed run.
    Returns (the metrics snapshot, the run's wall seconds).

    With ``mesh`` (a ``(1, S)`` ``HostMesh``; every rank calls this
    alike, ``model`` holding its rows of the catalogue) rank 0 serves
    and returns as above, and every other rank follows it
    (``serve.server.follow``) and returns (its log: the version and
    request ids of each batch it served, its wall seconds)."""
    from repro_torch.dist import use_mesh_rules

    ctx = contextlib.nullcontext() if mesh is None else use_mesh_rules(mesh)
    with ctx:
        return _serve_requests(model, params, args, on_ready, mesh, clock)


def _serve_requests(model, params, args, on_ready, mesh, clock):
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import sharded
    from repro_torch.core.assign import popularity_permutation
    from repro_torch.core.serve import ThresholdState
    from repro_torch.serve import (Batch, CatalogueRegistry, Replica,
                                   ReplicaPool, Request, RetrievalServer,
                                   ServerMetrics, poisson_arrivals,
                                   request_stream, run_open_loop)
    from repro_torch.serve.server import follow

    emb = model.emb
    n_items = int(model.cfg.n_items)
    # the whole catalogue's codes (on a mesh, every rank's rows gathered)
    codes = sharded.whole(params["item_emb"]["codes"], emb.cfg.n_items)
    hist_len = int(getattr(model.cfg, "hist_len",
                           getattr(model.cfg, "max_len", 16)))
    reserved = (0,)
    if hasattr(model.cfg, "mask_id"):
        reserved = (0, int(model.cfg.mask_id))
    if args.buckets:
        buckets = tuple(int(x) for x in args.buckets.split(","))
    else:
        buckets = tuple(sorted({max(1, hist_len // 2), hist_len}))

    # one spec resolution for the whole server: replicas stamp the
    # version-dependent fields (prune/perm/warm/stats) per catalogue
    spec = engine_mod.spec_from_args(args, kind=emb.cfg.kind,
                                     k=args.top_k)
    hists = list(request_stream(args.requests, n_items=n_items,
                                max_len=hist_len, reserved=reserved,
                                seed=args.seed))
    perm = None
    if spec.perm != "none":
        # popularity tallied from the request stream itself — the
        # serving stand-in for train-set interaction counts
        stream = np.concatenate([np.zeros(0, np.int32), *hists])
        perm = popularity_permutation(
            _template_popularity({"user_hist": stream}, codes.shape[0]))

    registry = CatalogueRegistry(shards=args.mesh, prune=spec.prune)
    registry.publish(codes, int(emb.cfg.b), perm=perm)
    pool = ReplicaPool(
        [Replica(model, params, k=args.top_k,
                 warm=(ThresholdState(spec.warm)
                       if spec.warm is not None else None),
                 name=f"replica{i}", spec=spec)
         for i in range(args.replicas)],
        merge_every=args.merge_every)

    # warm every (bucket, replica) dispatch before the timed run — the
    # kernels' build and first launches are not serve latency
    live = registry.live()
    for rep in pool.replicas:
        for L in buckets:
            dummy = Batch([Request(-1, np.ones(L, np.int32))], L,
                          args.max_batch)
            rep.serve(dummy, live)
    pool.reset_warm()

    if mesh is not None and mesh.rank != 0:
        t0 = time.perf_counter()
        log = follow(mesh, pool, registry)
        wall = time.perf_counter() - t0
        registry.wait()
        return log, wall
    kw = {} if clock is None else {"clock": clock}
    server = RetrievalServer(
        pool, registry, max_batch=args.max_batch,
        max_delay=args.max_delay_ms / 1e3, buckets=buckets,
        metrics=ServerMetrics(config=_config_name(args, spec)), mesh=mesh,
        **kw)
    arrivals = poisson_arrivals(args.rate, args.requests, seed=args.seed)
    if on_ready is not None:
        on_ready(server)
    t0 = time.perf_counter()
    try:
        run_open_loop(server, hists, arrivals, clock=clock)
        server.drain()
    finally:
        server.close()
    wall = time.perf_counter() - t0
    registry.wait()
    return server.metrics.snapshot(), wall


def _mesh_rank(mesh, args, out_dir):
    """One rank of ``--mesh S``: the arch's smoke model from the seed,
    this rank's rows kept, ``serve_requests`` under the mesh; rank 0
    saves the snapshot and wall seconds as ``out_dir/snapshot.json``."""
    from repro_torch import bridge, fp32_matmuls
    from repro_torch.configs import get_bundle
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)            # S processes share the cores
    fp32_matmuls()
    model, _ = get_bundle(args.arch).make_smoke(device=mesh.device)
    bridge.keep_local_rows(model, mesh)
    snap, wall = serve_requests(model, model.params(), args, mesh=mesh)
    if mesh.rank == 0:
        with open(os.path.join(out_dir, "snapshot.json"), "w") as f:
            json.dump({"snapshot": snap, "wall": wall}, f)


def serve_mesh(args):
    """``--mesh S``: spawn the S ranks; returns rank 0's (snapshot, wall
    seconds).  The kernels are built here, before the ranks start."""
    from repro_torch import resolve_device
    from repro_torch.launch import mesh as mesh_mod
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
    out = tempfile.mkdtemp(prefix="repro_torch_server-")
    try:
        mesh_mod.spawn(_mesh_rank, S, (args, out), device=dev, model=S,
                       share_card=args.share_card)
        with open(os.path.join(out, "snapshot.json")) as f:
            got = json.load(f)
        return got["snapshot"], got["wall"]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from repro_torch import fp32_matmuls, resolve_device
    from repro_torch.configs import get_bundle
    from repro_torch.serve import validate_snapshot

    dev = resolve_device(args.device)
    fp32_matmuls()
    model, _ = get_bundle(args.arch).make_smoke(device=dev)
    params = model.params()
    emb = getattr(model, "emb", None)
    if emb is None or emb.cfg.kind != "jpq" or "item_emb" not in params:
        sys.exit(f"{args.arch}: request-level serving needs a JPQ "
                 f"item embedding")
    if args.mesh > 1:
        del model, params
        snap, wall = serve_mesh(args)
    elif args.share_card:
        raise ValueError("--share-card shares one card between the ranks "
                         "of --mesh S > 1")
    else:
        snap, wall = serve_requests(model, params, args)
    errs = validate_snapshot(snap)
    if args.json:
        print(json.dumps(snap, indent=1, sort_keys=True))
    else:
        lat = snap["latency_ms"]
        print(f"{args.arch}: {snap['config']} n={args.requests} "
              f"rate={args.rate:.0f}/s wall={wall:.2f}s "
              f"p50={lat['p50']:.2f}ms p99={lat['p99']:.2f}ms "
              f"occ={snap['batch_occupancy']:.2f} "
              f"qdepth={snap['queue_depth']['mean']:.1f} device={dev}")

    if args.smoke:
        problems = list(errs)
        if snap["latency_ms"]["p99"] >= args.p99_budget_ms:
            problems.append(
                f"p99 {snap['latency_ms']['p99']:.1f}ms >= budget "
                f"{args.p99_budget_ms}ms")
        if snap["requests_completed"] != snap["requests_submitted"]:
            problems.append(
                f"completed {snap['requests_completed']} != submitted "
                f"{snap['requests_submitted']}")
        if snap["requests_dropped"] != 0:
            problems.append(f"dropped {snap['requests_dropped']}")
        if snap["requests_duplicated"] != 0:
            problems.append(f"duplicated {snap['requests_duplicated']}")
        if problems:
            sys.exit("server-smoke FAILED: " + "; ".join(problems))
        print("server-smoke OK")
    return snap


def _config_name(args, spec) -> str:
    """Label what actually RUNS (the resolved spec), not the argv: a
    --no-fused or non-JPQ run drops prune/perm/warm in resolution."""
    name = "queue" if args.max_batch > 1 else "sync-loop"
    if spec.kind == "semantic":
        name += "+semantic"
    if spec.prune:
        name += "+prune"
    if spec.perm != "none":
        name += "+perm"
    if spec.warm is not None:
        name += "+warm"
        if args.replicas > 1 and args.merge_every:
            name += "-merged"
    if args.mesh > 1:
        name += f"+mesh{args.mesh}"
    return name


if __name__ == "__main__":
    main()
