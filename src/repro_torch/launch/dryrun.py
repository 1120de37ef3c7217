"""The dry run: every (arch x shape) cell's step, as one rank of a
production mesh runs it, traced on fake tensors over a fake process
group, with no card and no data.  Each record gives that rank's FLOPs
(by dtype), bytes, memory (arguments, outputs, temporaries, aliases and
the peak) and collective bytes (by op, dtype and mesh axis), and the
three roofline terms on an H100 with the one that binds: the port's
counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for 512 placeholder TPU devices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--device cpu]

The trace runs the port's own step (``configs/base.py``'s builders over
the model a rank holds) under ``FakeTensorMode`` and ``dist/tally.Tally``:
every kernel is its ``repro_torch`` operator's fake implementation and
registered cost (``kernels/library.py``, ``kernels/cost.py``), every
collective goes through ``HostMesh`` on the ``"fake"`` transport
(``launch/mesh.make_fake_mesh``).  Fake ``cuda`` tensors unless
``--device cpu``: the card's build of torch traces either, a CPU build
only ``cpu``.  The counts are the code's, not measurements.

Results land in ``build/dryrun/<mesh><tag>/<arch>__<shape>.json``
(reused unless ``--force``).  A failing cell records ``error`` and its
traceback; a skip records ``skipped`` and its reason: the reference's,
or the port's own (``PORT_SKIPS``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import bridge
from repro_torch.configs import ARCHS, JPQ_VARIANTS, get_bundle, mace_arch
from repro_torch.dist import resolve_axes, tally
from repro_torch.launch import mesh as mesh_mod
from repro_torch.nn.module import tree_leaves
from repro_torch.train import spec as train_spec
from repro_torch.train.optimizer import init_opt_state

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../build/dryrun")
GB = 1e9
CARD_BYTES = 80e9          # one H100 SXM5 80GB's HBM


def _local_shape(shape, axes, mesh, rules=None):
    """The shape of this rank's share of an input placed by its logical
    ``axes``: a dimension on the data axes is cut to this rank's rows; a
    dimension on ``"model"`` (a candidate list's ``"items"``) stays whole,
    since the port's catalogue-sharded models take every candidate on
    each rank and split the catalogue's rows instead."""
    spec = resolve_axes(axes, shape, mesh, rules)
    out = []
    for n, e in zip(shape, spec):
        named = (e,) if isinstance(e, str) else tuple(e or ())
        out.append(n // math.prod(mesh.shape[a] for a in named
                                  if a != "model"))
    return tuple(out)


def _place(bundle, cell, model, mesh, rules, elastic):
    """Cut ``model`` to the blocks a rank holds (in place); returns the
    placement specs the train step's global norm reads, or None."""
    if mesh.shape["model"] <= 1 or elastic:
        return None
    if cell.kind == "train" or bundle.family != "recsys":
        return bridge.keep_local_blocks(model, mesh, rules)
    return bridge.keep_serving_blocks(model, mesh)


# the cells the port cannot trace, and why (the reference lowers
# ogb_products on placeholder devices, whose shares do not look at edges)
PORT_SKIPS = {
    ("mace", "ogb_products"):
        "a data rank's share (its halo rows and exchange routes) follows "
        "from the graph's edges, and ogbn-products' co-purchase edges are "
        "not in the repo (make_batch refuses the shape)",
}


def _rank_rows(x, axes, mesh, rules=None):
    """This rank's rows of a whole input ``x``: each dimension that its
    logical ``axes`` put on the data axes cut to the rank's block."""
    spec = resolve_axes(axes, tuple(x.shape), mesh, rules)
    for k, e in enumerate(spec):
        named = (e,) if isinstance(e, str) else tuple(e or ())
        D = math.prod(mesh.shape[a] for a in named if a != "model")
        if D > 1:
            n = x.shape[k] // D
            x = x.narrow(k, mesh.data_index * n, n)
    return x


def build_cell_args(bundle, cell, model, mesh, rules=None, *,
                    serve_kwargs=None, spec=None, host_batch=None,
                    batch=None):
    """Returns (fn, args tuple, donate_argnums) of this rank's step: the
    model cut to the rank's blocks as the port places them (``Trainer``:
    ``bridge.keep_local_blocks``; serving: ``keep_serving_blocks``),
    its values and the adamw moments of them, the rank's rows of each
    input (``_local_shape``), a decode cell's rank cache, an elastic
    cell's error rows.  Tensors are made in the ambient mode (fake under
    the dry run's trace).  ``spec``: a ``TrainSpec`` whose elastic knobs
    route a train cell through ``configs/base.dp_train_step_builder``
    (whose ranks each take the whole batch and cut their virtual
    shards).  ``host_batch``: MACE's host graph, whose rank share
    ``model.local_batch`` places.  ``batch``: the whole batch to take
    the rank's rows of (the tests' smoke batches), in place of zeros of
    the cell's shapes."""
    elastic = bool(spec is not None and spec.elastic and cell.kind == "train")
    specs = _place(bundle, cell, model, mesh, rules, elastic)
    values = model.params()
    dev = model.device
    if host_batch is not None:
        batch = model.local_batch(host_batch, mesh)
    elif batch is not None:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if not elastic:
            batch = {k: _rank_rows(v, cell.specs[k].axes, mesh, rules)
                     for k, v in batch.items()}
    else:
        batch = {}
        for name, s in cell.specs.items():
            shape = s.shape if elastic else _local_shape(s.shape, s.axes,
                                                         mesh, rules)
            batch[name] = torch.zeros(shape, dtype=s.dtype, device=dev)
    if cell.kind == "train":
        for x in tree_leaves(values):
            if torch.is_floating_point(x) and not x.requires_grad:
                x.requires_grad_(True)
        opt = init_opt_state(values)
        if elastic:
            from repro_torch.configs.base import dp_train_step_builder
            from repro_torch.dist import compression
            fn, _ = dp_train_step_builder(model, mesh, spec=spec)
            V = spec.resolve_accum(mesh)
            err = compression.shard_rows(
                compression.zeros_error_state(values, V), mesh, V)
            if spec.fsdp:
                values = fn.shard(values)
                opt = {**opt, "m": fn.shard(opt["m"]),
                       "v": fn.shard(opt["v"])}
            return fn, (values, opt, err, batch), (0, 1, 2)
        fn = cell.build(model, mesh, specs=specs, rules=rules)
        return fn, (values, opt, batch), (0, 1)
    if cell.kind == "decode":
        B = next(iter(batch.values())).shape[0]
        caches, _ = cell.state_fn(model, B)
        return cell.build(model, mesh, rules), (values, caches, batch), (1,)
    fn = cell.build(model, mesh, rules, **(serve_kwargs or {}))
    return fn, (values, batch), ()


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def make_model(bundle, shape, device, changes=None):
    """The cell's full-width model on ``device`` (seed 0; MACE at the
    shape's config), ``changes`` replacing fields of its config (a cut
    depth, as a chip phase cuts it)."""
    kw = dict(changes or {})
    if bundle.family == "gnn":
        kw["shape"] = shape
    return bundle.make_model(device=device, seed=0, **kw)


def trace_step(fn, args, mesh):
    """Run ``fn(*args)`` under ``dist/tally.Tally``: (its record, the
    memory record, the collectives ``mesh`` ran)."""
    before = dict(mesh.comm_by)
    with tally.Tally(resident=args) as t:
        out = fn(*args)
    memory = t.finish(out)
    coll = tally.collective_bytes(tally.comm_since(mesh, before))
    return t.record(), memory, coll


def trace_cell(arch, shape, mesh, device, *, rules=None, serve_kwargs=None,
               spec=None, host_batch=None, batch=None, changes=None):
    """One rank's step of a cell on ``mesh``, its model, state and inputs
    fake tensors on ``device``: ``(tally record, memory record,
    collectives record, seconds)``."""
    bundle = get_bundle(arch)
    cell = bundle.cells[shape]
    t0 = time.perf_counter()
    with _fake_mode():
        model = make_model(bundle, shape, device, changes)
        fn, args, _ = build_cell_args(
            bundle, cell, model, mesh, rules, serve_kwargs=serve_kwargs,
            spec=spec, host_batch=host_batch, batch=batch)
        del model
        rec, memory, coll = trace_step(fn, args, mesh)
        del fn, args
    return rec, memory, coll, time.perf_counter() - t0


def trace_rank(arch, shape, data, model_axis, rank, device, **kw):
    """``trace_cell`` on fake tensors as rank ``rank`` of a fake ``(data,
    model_axis)`` mesh."""
    mesh = mesh_mod.make_fake_mesh(data, model_axis, rank=rank,
                                   device=device)
    try:
        return trace_cell(arch, shape, mesh, device, **kw)
    finally:
        mesh.close()


def _ranks_to_trace(bundle, data, model_axis):
    """A graph's shares differ between data ranks (each its own halo), so
    MACE traces each data rank (at model index 0); every other cell's
    ranks are alike, and rank 0 stands for them."""
    if bundle.family == "gnn":
        return [d * model_axis for d in range(data)]
    return [0]


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             rules=None, save: bool = True, force: bool = False,
             tag: str = "", serve_kwargs=None, spec=None,
             device: str = "cuda", out_path=None) -> dict:
    """Trace one cell on its production mesh (``pod16x16``, or with
    ``multi_pod`` ``pod2x16x16``) and return its record, saved as JSON
    unless ``save`` is False."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    data, model_axis = mesh_mod.PRODUCTION_MESHES[mesh_name]
    mesh_name += tag
    if out_path is None:
        out_path = os.path.join(RESULTS_DIR, mesh_name,
                                f"{arch}__{shape}.json")
    if save and not force and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    bundle = get_bundle(arch)
    cell = bundle.cells[shape]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "kind": cell.kind, "note": cell.note}
    skip = cell.skip or PORT_SKIPS.get((arch, shape))
    if skip:
        rec["skipped"] = skip
        _save(rec, out_path, save)
        return rec
    t0 = time.perf_counter()
    try:
        host = None
        if bundle.family == "gnn":
            host = mace_arch.make_batch(shape, 0)
        per_rank = []
        for rank in _ranks_to_trace(bundle, data, model_axis):
            tr, mem, coll, _ = trace_rank(
                arch, shape, data, model_axis, rank, device, rules=rules,
                serve_kwargs=serve_kwargs, spec=spec, host_batch=host)
            per_rank.append((mem["peak_bytes"], rank, tr, mem, coll))
        del host
        # the worst rank: the largest peak (the first on a tie)
        _, rank, tr, mem, coll = max(per_rank, key=lambda r: (r[0], -r[1]))
        terms = {"compute_s": mesh_mod.compute_s(tr["flops_by_dtype"]),
                 "memory_s": mesh_mod.memory_s(tr["bytes"]),
                 "collective_s": mesh_mod.collective_s(
                     coll["per_axis_bytes"], data, model_axis)}
        notes = ["bytes: each operator's inputs and outputs once, unfused "
                 "(an upper bound where a fused step moves less)"]
        if mem["workspace_bytes"]:
            notes.append("peak: with the workspaces torch holds from a "
                         "card's first matrix product (cuBLAS) and first "
                         "product with a bias (cuBLASLt), %d bytes"
                         % mem["workspace_bytes"])
        if tr["upper_bound_ops"]:
            notes.append("FLOPs and bytes of " + ", ".join(
                tr["upper_bound_ops"]) + " count the full sweep: an upper "
                "bound (its skips depend on the data)")
        rec.update({
            "n_chips": data * model_axis,
            "mesh_shape": {"data": data, "model": model_axis},
            "device": device,
            "rank": rank,
            "ranks_traced": [r[1] for r in per_rank],
            "peak_gb_by_rank": {str(r[1]): r[0] / GB for r in per_rank},
            "trace_s": round(time.perf_counter() - t0, 2),
            "flops_per_device": float(tr["flops"]),
            "flops_per_device_by_dtype": {k: float(v) for k, v in
                                          tr["flops_by_dtype"].items()},
            "bytes_per_device": float(tr["bytes"]),
            "kernel_calls": tr["kernel_calls"],
            "collectives": coll,
            "memory": mem,
            "peak_gb": mem["peak_bytes"] / GB,
            "fits_80gb": mem["peak_bytes"] <= CARD_BYTES,
            "roofline_terms_s": terms,
            "bottleneck": max(terms, key=terms.get),
            "counts": "; ".join(notes),
        })
    except Exception as e:  # noqa: BLE001 - the record carries the failure
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _save(rec, out_path, save)
    return rec


def _save(rec, out_path, save):
    if not save:
        return
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)


def _run_one(job):
    (arch, shape), kw = job
    return run_cell(arch, shape, **kw)


def _slow_first(cell):
    """The order of cells over processes: MACE (a trace a data rank) and
    DIEN's candidate scoring (an AUGRU replay a chunk of 2,000 of 1M
    candidates) first, then the LMs, then the rest."""
    arch, shape = cell
    if arch == "mace" or (arch.startswith("dien")
                          and shape == "retrieval_cand"):
        return 0
    return 1 if get_bundle(arch).family == "lm" else 2


def _run_cells(cells, kw, jobs):
    """Each cell's record: here in ``cells``' order, or over ``jobs``
    spawned processes (slow cells first) as each ends."""
    if jobs <= 1:
        for cell in cells:
            yield _run_one((cell, kw))
        return
    import multiprocessing as mp
    cells = sorted(cells, key=_slow_first)
    with mp.get_context("spawn").Pool(jobs, maxtasksperchild=1) as pool:
        yield from pool.imap_unordered(_run_one, [(c, kw) for c in cells])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every cell of every arch, the -jpq variants "
                         "included")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="results subdir suffix "
                    "(perf-iteration variants)")
    ap.add_argument("--serve-fused", dest="serve_fused",
                    action="store_true", default=None,
                    help="force the fused PQTopK path in serve cells "
                         "(JPQ archs default to it already)")
    ap.add_argument("--no-serve-fused", dest="serve_fused",
                    action="store_false",
                    help="materialise-then-top-k reference serve path")
    ap.add_argument("--serve-prune", action="store_true",
                    help="score-bound dynamically pruned fused serve "
                         "path")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's "
                         "build of torch) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (each with its own fake group)")
    ap.add_argument("--out", default=None,
                    help="the record's path (one cell only); default "
                         "build/dryrun/<mesh><tag>/<arch>__<shape>.json")
    # the shared TrainSpec flag cluster (no --microbatches: dry-run cells
    # do not microbatch)
    train_spec.add_train_spec_args(ap, microbatches=False)
    args = ap.parse_args(argv)
    torch.device(args.device)            # a bad spelling raises here

    serve_kwargs = {}
    if args.serve_fused is not None:
        serve_kwargs["fused"] = args.serve_fused
    if args.serve_prune:
        serve_kwargs["prune"] = True
    serve_kwargs = serve_kwargs or None
    spec = train_spec.spec_for(
        grad_compression=args.grad_compression,
        grad_accum_shards=args.grad_accum_shards, fsdp=args.fsdp,
        overlap=args.overlap, rng="none")
    if not args.tag:        # variants must not overwrite the baseline
        bits = ([f"gc-{args.grad_compression}"]
                if args.grad_compression else [])
        bits += ["fsdp"] if args.fsdp else []
        bits += ([f"ov-{args.overlap}"]
                 if args.overlap != "dispatch" else [])
        bits += ["prune"] if args.serve_prune else []
        bits += ["nofused"] if args.serve_fused is False else []
        args.tag = "-" + "-".join(bits) if bits else ""

    if args.all:
        cells = [(a, s) for a in ARCHS + JPQ_VARIANTS
                 for s in get_bundle(a).cells]
    else:
        arch = args.arch or ARCHS[0]
        shapes = [args.shape] if args.shape else list(get_bundle(arch).cells)
        cells = [(arch, s) for s in shapes]
    if args.out and len(cells) != 1:
        ap.error("--out names one cell's record")

    t_all = time.perf_counter()
    n_err = 0
    kw = dict(multi_pod=args.multi_pod, force=args.force, tag=args.tag,
              serve_kwargs=serve_kwargs, spec=spec, device=args.device,
              out_path=args.out)
    for rec in _run_cells(cells, kw, args.jobs):
        arch, shape = rec["arch"], rec["shape"]
        if "error" in rec:
            n_err += 1
            status = "ERROR: " + rec["error"][:160]
        elif "skipped" in rec:
            status = "SKIP: " + rec["skipped"][:60]
        else:
            status = (f"ok trace={rec['trace_s']}s "
                      f"bottleneck={rec['bottleneck']} peak="
                      f"{rec['peak_gb']:.2f}GB terms="
                      f"{ {k: f'{v:.2e}' for k, v in rec['roofline_terms_s'].items()} }")
        print(f"[{rec['mesh']}] {arch:>24s} x {shape:<14s} {status}",
              flush=True)
    print(f"{len(cells)} cells, {n_err} errors, "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
