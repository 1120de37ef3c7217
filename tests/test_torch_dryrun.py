"""The dry run (``repro_torch.launch.dryrun``) against the reference's:
the grid's cells, each rank's argument bytes on a (4, 2) mesh, the
kernel operators (``kernels/library.py``), the tally of a fake trace
against a real step, the collectives of a fake (2, 2) mesh against a
real gloo one, and the CLI's records.  All on the CPU, at full width
only where nothing runs (fake tensors), else at the smoke configs.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import JPQ_VARIANTS as REF_JPQ
from repro.configs.registry import get_bundle as ref_bundle
from repro_torch.configs import ARCHS, JPQ_VARIANTS, get_bundle, mace_arch
from repro_torch.configs.base import serve_builder, train_step_builder
from repro_torch.dist import tally
from repro_torch.kernels import library
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train.optimizer import init_opt_state

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def _fake():
    return FakeTensorMode(allow_non_fake_inputs=True)


def _flat(x):
    if isinstance(x, dict):
        return [y for k in x for y in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


# ------------------------------------------------------------ the grid

def test_arch_lists_match_reference():
    assert ARCHS == REF_ARCHS and JPQ_VARIANTS == REF_JPQ


@pytest.mark.parametrize("arch", REF_ARCHS + REF_JPQ)
def test_cells_equal_reference(arch):
    """Names, kinds, spec shapes, dtypes and axes, skips and notes."""
    ref, port = ref_bundle(arch), get_bundle(arch)
    assert list(port.cells) == list(ref.cells)
    for name, rc in ref.cells.items():
        pc = port.cells[name]
        assert (pc.shape_name, pc.kind, pc.skip, pc.note) == \
            (rc.shape_name, rc.kind, rc.skip, rc.note)
        assert list(pc.specs) == list(rc.specs)
        for k, rs in rc.specs.items():
            ps = pc.specs[k]
            assert tuple(ps.shape) == tuple(rs.shape), (name, k)
            assert tuple(ps.axes) == tuple(rs.axes), (name, k)
            assert str(ps.dtype).removeprefix("torch.") == \
                np.dtype(rs.dtype).name, (name, k)
        assert (pc.state_fn is None) == (rc.state_fn is None)


# ------------------------------------ argument bytes against the reference

# one cell per family and kind; MACE's graph shares hold halo rows the
# reference's position blocks do not, so its inputs are left out
ARG_CELLS = ["fm:train_batch", "fm:serve_p99",
             "two-tower-retrieval-jpq:train_batch", "stablelm-1.6b:train_4k",
             "olmoe-1b-7b:decode_32k", "mace:molecule"]


@pytest.fixture(scope="module")
def ref_shards():
    """The reference's ``build_cell_args`` on 8 host devices as (4, 2):
    each argument leaf's path, whole and per-device shape and item size
    (no compile)."""
    body = f"""
    import json
    import jax, numpy as np
    from repro.configs.registry import get_bundle
    from repro.launch import dryrun as dr
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    out = {{}}
    for name in {ARG_CELLS!r}:
        arch, shape = name.split(":")
        b = get_bundle(arch)
        fn, args, _ = dr.build_cell_args(b, b.cells[shape],
                                         b.make_model(shape), mesh)
        out[name] = [[jax.tree_util.keystr(p), list(s.shape),
                      list(s.sharding.shard_shape(s.shape)),
                      np.dtype(s.dtype).itemsize]
                     for p, s in jax.tree_util.tree_leaves_with_path(args)]
    print(json.dumps(out))
    """
    code = ("import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            + textwrap.dedent(body))
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ARG_CELLS)
def test_rank_argument_bytes_match_reference(name, ref_shards):
    """Rank 0's values, optimizer state (or caches) and inputs on a fake
    (4, 2) mesh hold the reference's per-device bytes, less the
    documented divergences: the RecJPQ centroids are whole on every rank
    (the port keeps them whole: every rank's items reference every
    code), and the adamw step counter is a Python int, not a tensor."""
    arch, shape = name.split(":")
    bundle = get_bundle(arch)
    cell = bundle.cells[shape]
    mesh = mesh_mod.make_fake_mesh(4, 2, rank=0)
    try:
        with _fake():
            model = dryrun.make_model(bundle, shape, "cpu")
            host = mace_arch.make_batch(shape, 0) \
                if bundle.family == "gnn" else None
            _, args, _ = dryrun.build_cell_args(bundle, cell, model, mesh,
                                                host_batch=host)
            port = [sum(t.numel() * t.element_size() for t in _flat(a)
                        if isinstance(t, torch.Tensor)) for a in args]
    finally:
        mesh.close()
    want = [0] * len(port)
    for path, whole, shard, size in ref_shards[name]:
        i = int(path[1])
        n = math.prod(shard) * size
        if "centroids" in path:
            n = math.prod(whole) * size
        if path.endswith("['step']"):
            n = 0
        want[i] += n
    if bundle.family == "gnn":
        port, want = port[:-1], want[:-1]
    assert port == want


# ------------------------------------------------------- the kernel ops

def _op_args():
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 4, (5, 2), generator=g).to(torch.uint8)
    ids = torch.randint(0, 5, (6,), generator=g)
    big = torch.randint(0, 4, (300, 2), generator=g).to(torch.uint8)
    P = torch.randn((3, 2, 4), generator=g)
    from repro_torch.kernels.jpq_topk import ops as tk
    st = tk.prepare_pruning(big, 4, 128)
    bag = torch.randint(0, 10, (6, 3), generator=g)
    w = torch.rand((6, 3), generator=g)
    return {
        "jpq_scores": (P, codes),
        "jpq_scores_bwd": (torch.randn((3, 5), generator=g), codes, 4),
        "jpq_lookup": (ids, codes, torch.randn((2, 4, 3), generator=g)),
        "jpq_lookup_bwd": (ids, codes, torch.randn((6, 2, 3), generator=g),
                           4),
        "jpq_topk": (P, big, 5, None),
        "jpq_topk_pruned": (P, st.codes, st.ids, st.present,
                            torch.full((3,), -float("inf")),
                            torch.full((3, 5), -float("inf")),
                            torch.zeros((3, 5), dtype=torch.int32), 5, 128,
                            False),
        "embedding_bag": (torch.randn((10, 4), generator=g), bag, w),
        "bag_sort_ids": (torch.randint(0, 10, (200,), generator=g), 10,
                         False),
        "bag_backward": (bag, w, torch.randn((6, 4), generator=g), 10, None,
                         None, None, None, 0, 0),
    }


@pytest.mark.parametrize("name", sorted(_op_args()))
def test_kernel_op_opcheck(name):
    """Schema, fake implementation and dispatch of every kernel op
    (``torch.library.opcheck``), and its plain version's result."""
    args = _op_args()[name]
    torch.library.opcheck(library.op(name), args)
    assert name in library.SCHEMAS


# each op's cost at ``_op_args``' shapes, counted by hand from the
# kernel's least work (``kernels/cost.py``: inputs read once, outputs
# written once, an FMA 2 flops):
#   jpq_scores     T 3, N 5, m 2, b 4: adds T·N·(m-1) = 15; codes N·m = 10
#                  + LUT T·m·b·4 = 96 + scores T·N·4 = 60 -> 166 bytes
#   jpq_scores_bwd adds T·N·m = 30; dS 60 + codes 10 + dLUT 96 = 166
#   jpq_lookup     T 6, dk 3: ids T·8 = 48 + codes T·m = 12 + centroids
#                  m·b·dk·4 = 96 + out T·m·dk·4 = 144 -> 300; no flops
#   jpq_lookup_bwd adds T·m·dk = 36; the same 300 bytes
#   jpq_topk       B 3, N 300, k 5: adds B·N·m = 1,800; codes 600 + LUT
#                  96 + values and ids B·k·8 = 120 -> 816
#   jpq_topk_pruned  the full sweep 1,800 + each of 3 tiles' bound
#                  B·3·m·(b+1) = 90 -> 1,890; 816 + ids N·4 = 1,200 +
#                  tile maxima 3·m·b·4 = 96 + floors B·4 = 12 -> 2,124
#   embedding_bag  6 bags x 3, d 4, 10 rows: FMAs 6·3·4 = 72 -> 144;
#                  rows 10·4·4 = 160 + ids and weights 18·12 = 216 + out
#                  6·4·4 = 96 -> 472
#   bag_sort_ids   200 int64 ids 1,600 + perm 200·4 + offsets 11·4 +
#                  two int32 [4] 32 -> 2,476; no flops
#   bag_backward   18 weighted terms x d 4: a multiply and an add each
#                  -> 144; terms 18·12 = 216 + dout 96 + dtable 10·4·4 =
#                  160 -> 472
OP_COSTS = {
    "jpq_scores": (15, 166), "jpq_scores_bwd": (30, 166),
    "jpq_lookup": (0, 300), "jpq_lookup_bwd": (36, 300),
    "jpq_topk": (1800, 816), "jpq_topk_pruned": (1890, 2124),
    "embedding_bag": (144, 472), "bag_sort_ids": (0, 2476),
    "bag_backward": (144, 472),
}


@pytest.mark.parametrize("name", sorted(OP_COSTS))
def test_kernel_op_cost_by_hand(name):
    """Each op's tallied fp32 FLOPs and bytes at one shape equal the
    count written out by hand above."""
    args = _op_args()[name]
    with tally.Tally() as t:
        library.op(name)(*args)
    rec = t.record()
    assert (rec["flops"], rec["bytes"]) == OP_COSTS[name]
    assert set(rec["flops_by_dtype"]) <= {"float32"}
    assert rec["kernel_calls"] == {name: 1}


def test_every_kernel_op_has_a_cost():
    from repro_torch.kernels import cost
    assert set(library.SCHEMAS) == set(cost._COSTS)


# ---------------------------------------------- fake trace vs real step

def _smoke_args(arch, kind, fake):
    """The smoke model's step (a train step, or for ``serve`` the
    retrieval a serve cell runs) and its arguments, built in the fake
    mode or on real CPU tensors alike."""
    model, batch = get_bundle(arch).make_smoke(device="cpu", seed=0)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    values = model.params()
    if kind == "serve":
        return serve_builder("retrieve")(model), (values, {
            "user_hist": batch["user_hist"]})
    for x in _flat(values):
        if torch.is_floating_point(x) and not x.requires_grad:
            x.requires_grad_(True)
    return train_step_builder(model), (values, init_opt_state(values), batch)


@pytest.mark.parametrize("arch,kind", [("fm-jpq", "train"),
                                       ("stablelm-1.6b", "train"),
                                       ("mace", "train"),
                                       ("two-tower-retrieval-jpq", "serve")])
def test_fake_trace_equals_real_step(arch, kind):
    """FLOPs by dtype, bytes, kernel calls and the memory record of the
    smoke step traced on fake tensors equal the tally of the same step
    run on real CPU tensors.  The port's caches of constant tensors (the
    RoPE frequencies, the Gaunt tensors), which keep no fake tensor, are
    emptied before each, so both make them."""
    from repro_torch.models import equivariant
    from repro_torch.nn import layers
    mesh = mesh_mod.HostMesh(1, 1)
    out = []
    for fake in (False, True):
        layers._FREQS.clear()
        equivariant.gaunt_tensor.cache_clear()
        with _fake() if fake else contextlib.nullcontext():
            fn, args = _smoke_args(arch, kind, fake)
            rec, mem, coll = dryrun.trace_step(fn, args, mesh)
        out.append((rec, mem, coll))
    (real, real_mem, _), (fake, fake_mem, _) = out
    assert real["flops"] > 0
    assert fake == real
    assert fake_mem == real_mem


def lm_train_flops(cfg, B, S):
    """(matrix-product FLOPs, the token gather's backward FLOPs) of one
    train step of a dense LM, by hand: per layer the q, k, v, o
    projections, the scores and the weighted values over all S keys
    (the causal mask is added, not skipped; query chunks see every
    key), the FFN's gate, up and down products; each product costs
    2·m·n·k forward and twice that backward; ``remat`` replays a
    layer's forward in the backward, and the replay stops once the
    saved tensors are made again (torch's non-reentrant checkpoint),
    which is before the FFN's last product; the head's product runs
    once forward and twice backward.  Sums to 6·N·T for the weights
    (less the replay's) plus the attention's."""
    T, d, hd = B * S, cfg.d_model, cfg.hd
    proj = 2 * T * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv)
    attn = 2 * (2 * B * cfg.n_heads * S * S * hd)
    ffn_in, ffn_out = 2 * (2 * T * d * cfg.d_ff), 2 * T * cfg.d_ff * d
    layer = proj + attn + ffn_in + ffn_out
    passes = 4 if cfg.remat else 3
    blocks = cfg.n_layers * (passes * layer - (ffn_out if cfg.remat else 0))
    head = 3 * 2 * T * d * cfg.vocab
    return blocks + head, T * d


def test_lm_train_flops_by_hand():
    """stablelm-1.6b's smoke train step (fp32) run on the CPU, and its
    full-width train_4k step at 2 layers and B 1 traced on fake tensors
    (bf16 products, the gather's gradient summed in fp32): the tally's
    FLOPs equal ``lm_train_flops`` exactly (flop_counter counts 2·m·n·k
    a product; the kernel ops their registered cost)."""
    bundle = get_bundle("stablelm-1.6b")
    cfg = bundle.make_smoke(device="cpu")[0].cfg
    mesh = mesh_mod.HostMesh(1, 1)
    fn, args = _smoke_args("stablelm-1.6b", "train", fake=False)
    rec, _, _ = dryrun.trace_step(fn, args, mesh)
    products, gather = lm_train_flops(cfg, 2, 16)
    assert rec["flops_by_dtype"] == {"float32": products + gather}

    z = np.zeros((1, 4096), np.int32)
    fm = mesh_mod.make_fake_mesh(1, 1)
    try:
        rec, _, _, _ = dryrun.trace_cell(
            "stablelm-1.6b", "train_4k", fm, "cpu",
            batch={"tokens": z, "targets": z}, changes={"n_layers": 2})
    finally:
        fm.close()
    full = dataclasses.replace(bundle.config, n_layers=2)
    products, gather = lm_train_flops(full, 1, 4096)
    assert rec["flops_by_dtype"] == {"bfloat16": products,
                                     "float32": gather}


def test_workspaces_in_the_peak():
    """A CUDA device's first matrix product adds the cuBLAS workspace
    (32 MiB by default, read from torch's settings) to the peak, its
    first product with a bias cuBLASLt's (1 MiB), each once; a product
    on the CPU adds none."""
    assert tally.cublas_workspaces() == {"cublas": 32 * 2 ** 20,
                                         "cublaslt": 2 ** 20}
    with _fake():
        a = torch.empty((64, 64), device="cuda")
        bias = torch.empty((64,), device="cuda")
        with tally.Tally(resident=(a, bias)) as t:
            y, z = a @ a, a @ a
        assert t.finish((y, z))["workspace_bytes"] == 32 * 2 ** 20
        with tally.Tally(resident=(a, bias)) as t:
            y = a @ a
            z = torch.nn.functional.linear(a, a, bias)
            w = torch.addmm(bias, a, a)
        mem = t.finish((y, z, w))
    assert mem["workspace_bytes"] == 33 * 2 ** 20
    assert mem["peak_bytes"] == 4 * 64 * 64 * 4 + 512 + 33 * 2 ** 20
    a = torch.ones((64, 64))
    with tally.Tally(resident=(a,)) as t:
        y = a @ a
    assert t.finish(y)["workspace_bytes"] == 0


# ------------------------------- collectives: fake (2, 2) vs real gloo

def _lm_mesh_step(mesh, fake):
    """stablelm-1.6b's smoke train step on ``mesh``'s rank: its tally
    and ``HostMesh.comm_by`` of the step."""
    bundle = get_bundle("stablelm-1.6b")
    cell = bundle.cells["train_4k"]
    with _fake() if fake else contextlib.nullcontext():
        model, batch = bundle.make_smoke(device="cpu", seed=0)
        fn, args, _ = dryrun.build_cell_args(bundle, cell, model, mesh,
                                             batch=batch)
        rec, _, coll = dryrun.trace_step(fn, args, mesh)
    return rec, coll


def _gloo_rank(mesh, out_path):
    rec, coll = _lm_mesh_step(mesh, fake=False)
    if mesh.rank == 0:
        with open(out_path, "w") as f:
            json.dump({"rec": rec, "coll": coll}, f)


def test_fake_mesh_collectives_equal_gloo(tmp_path):
    """One LM train step's collectives on a fake (2, 2) mesh equal, per
    op, axis and dtype, the real 2x2 gloo run's ``HostMesh`` record on
    rank 0, and so do its FLOPs."""
    path = str(tmp_path / "gloo.json")
    mesh_mod.spawn(_gloo_rank, 4, (path,), model=2, timeout=240)
    with open(path) as f:
        real = json.load(f)
    mesh = mesh_mod.make_fake_mesh(2, 2, rank=0)
    try:
        rec, coll = _lm_mesh_step(mesh, fake=True)
    finally:
        mesh.close()
    coll = json.loads(json.dumps(coll))
    assert coll["total_bytes"] > 0
    assert coll == real["coll"]
    assert rec["flops_by_dtype"] == real["rec"]["flops_by_dtype"]


# ------------------------------------------------------------- the CLI

REF_KEYS = {"arch", "shape", "mesh", "kind", "note", "n_chips",
            "flops_per_device", "bytes_per_device", "collectives", "memory",
            "roofline_terms_s", "bottleneck"}


@pytest.mark.parametrize("cell", ["fm:serve_p99",
                                  "two-tower-retrieval-jpq:retrieval_cand"])
def test_cli_writes_reference_keys(cell, tmp_path):
    arch, shape = cell.split(":")
    out = tmp_path / "rec.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--arch", arch, "--shape", shape, "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert "error" not in rec, rec.get("traceback")
    assert REF_KEYS <= set(rec)
    assert rec["mesh"] == "pod16x16" and rec["n_chips"] == 256
    assert rec["flops_per_device"] > 0
    assert set(rec["collectives"]) >= {"per_op_bytes", "per_op_counts",
                                       "per_op_dtype_bytes", "total_bytes",
                                       "per_axis_bytes"}
    assert set(rec["memory"]) >= {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes",
                                  "alias_size_in_bytes"}
    assert rec["bottleneck"] in rec["roofline_terms_s"]
    assert "1 cells, 0 errors" in run.stdout


def test_skipped_cell_recorded_as_reference():
    rec = dryrun.run_cell("stablelm-1.6b", "long_500k", save=False,
                          device="cpu")
    want = ref_bundle("stablelm-1.6b").cells["long_500k"].skip
    assert rec["skipped"] == want
    assert "error" not in rec and "flops_per_device" not in rec


def test_port_skip_recorded():
    """ogb_products, whose shares follow from edges that are not in the
    repo, is recorded as skipped with the reason, not traced."""
    rec = dryrun.run_cell("mace", "ogb_products", save=False, device="cpu")
    assert rec["skipped"] == dryrun.PORT_SKIPS[("mace", "ogb_products")]
    assert "error" not in rec and "flops_per_device" not in rec


def test_roofline_links():
    """pod16x16's axis groups both cross 8-card nodes (InfiniBand); a
    (2, 4) mesh's model rows stay inside one (NVLink)."""
    assert mesh_mod.axis_link(16, 16, "model") == mesh_mod.IB_BW
    assert mesh_mod.axis_link(16, 16, "data") == mesh_mod.IB_BW
    assert mesh_mod.axis_link(2, 4, "model") == mesh_mod.NVLINK_BW
    assert mesh_mod.axis_link(1, 8, "world") == mesh_mod.NVLINK_BW
    assert mesh_mod.compute_s({"bfloat16": 989.4e12, "float32": 67e12}) \
        == pytest.approx(2.0)
    rec = tally.collective_bytes({("all-reduce", "data", "f32"): (2, 64)})
    assert rec["per_op_bytes"] == {"all-reduce": 64}
    assert rec["per_axis_bytes"] == {"data": 64}
