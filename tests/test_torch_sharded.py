"""The port's serving over a model-sharded catalogue (core/sharded.py's
mesh branches, launch/mesh.py's ``(data, model)`` mesh, dist's
``params_shardings`` / ``local_rows``, bridge.keep_local_rows,
launch/serve.py --mesh) against the JAX reference, on the CPU.

The port's meshes are gloo processes started by
``repro_torch.launch.mesh.spawn`` (1x2, 1x4 and 2x4, each spawned once,
at most 8 processes at a time, every spawn with a timeout of its own);
the reference's meshes run in one subprocess over 8 host devices
(``--xla_force_host_platform_device_count``, as
tests/test_mesh_perm.py runs them).  The inputs are made with numpy
from seeds, written once and read by every process.

Held:
  * at the LUT level (``fused_topk_over_codes``, ``topk_over_items``)
    values and ids bit-equal to the reference's unsharded
    ``jpq_topk_lut_ref`` / ``lax.top_k``, duplicate-score and -0.0 ties
    included, unpruned, pruned, permuted, warm and overshooting-warm
    (demoted); the pruning stats equal to the reference's mesh run;
  * ``pooled_lookup`` within 1e-6 of the reference (the sum over ranks
    runs in another order), ``take_rows`` exact;
  * the TwoTower models and the engine on bridged reference weights:
    bit-equal to the port's unsharded path, and, as
    tests/test_torch_serve.py holds the unsharded port, within 2e-7 of
    the reference with equal ids (the LUT einsum and the user tower sum
    in another order than XLA);
  * every rank returns the whole result; ``launch/serve.py --mesh``
    serves bit-equal to the unsharded loop.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingConfig as J_EC
from repro.core import sharded as J_sharded
from repro.core.assign import shard_sweep_ids as J_shard_sweep_ids
from repro.dist import resolve_axes as J_resolve
from repro.kernels.jpq_topk.ops import mesh_prune_block_n as J_mesh_bn
from repro.kernels.jpq_topk.ref import jpq_topk_lut_ref
from repro.models.recsys import TwoTower as J_TwoTower
from repro.models.recsys import TwoTowerConfig as J_TTC
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch import dist as T_dist
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import engine as T_engine
from repro_torch.core import make_embedding as T_make_embedding
from repro_torch.core import sharded as T_sharded
from repro_torch.core.assign import popularity_permutation as T_pop
from repro_torch.core.assign import shard_sweep_ids as T_shard_sweep_ids
from repro_torch.core.serve import ThresholdState as T_TS
from repro_torch.dist import rules as T_R
from repro_torch.kernels.jpq_topk import ops as T_ops
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as T_serve
from repro_torch.models.recsys import TwoTower as T_TwoTower
from repro_torch.models.recsys import TwoTowerConfig as T_TTC

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHAPES = ("1x2", "1x4", "2x4")
SPAWN_TIMEOUT = 150
TOL = 2e-7              # port vs reference through the LUT einsum
POOL_TOL = 1e-6         # pooled sums over ranks vs in slot order
ENG_RTOL = 2.0 ** -22   # two ulps: the engine's scores reach 2.6
TT = dict(n_items=200, embed_dim=32, tower_mlp=(64, 32), hist_len=8)
# the LUT-level cases: (B, m, b, N, k) and the acceptance case's tiles
U = dict(B=8, m=4, b=16, N=512, k=9)
Q = dict(B=6, m=3, b=8, N=640, k=37, bn=32)
E = dict(B=8, N=2048, d=16, m=4, b=16, k=7)


def _dims(shape):
    D, S = (int(x) for x in shape.split("x"))
    return D, S


# --------------------------------------------------------------- inputs

def _make_inputs():
    """Every array the cases read, from numpy seeds."""
    rng = np.random.default_rng(0)
    inp = {}
    inp["u_part"] = rng.standard_normal((U["B"], U["m"], U["b"])).astype(
        np.float32)
    inp["u_codes"] = rng.integers(0, U["b"], (U["N"], U["m"])).astype(
        np.int32)
    # the acceptance case: popularity-structured codes (bounds bite), an
    # integer LUT (duplicate scores) with every zero a -0.0
    B, m, b, N = Q["B"], Q["m"], Q["b"], Q["N"]
    rank = rng.permutation(N).astype(np.int32)
    inp["q_codes"] = np.clip(rank[:, None] * b // N
                             + rng.integers(0, 2, (N, m)), 0,
                             b - 1).astype(np.int32)
    part = (np.round(-(np.arange(b) / b)[None, None, :] * 4.0)
            + rng.integers(-1, 2, (B, m, b))).astype(np.float32)
    inp["q_part"] = np.where(part == 0.0, np.float32(-0.0), part)
    inp["q_perm"] = np.argsort(rank).astype(np.int32)   # popular first
    # topk_over_items: duplicate values and -0.0
    s = rng.integers(-3, 4, (8, 512)).astype(np.float32)
    inp["s_scores"] = np.where(s == 0.0, np.float32(-0.0), s)
    # pooled_lookup / take_rows
    inp["p_table"] = rng.standard_normal((64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, (8, 5))
    ids[:, -1] = 0
    inp["p_ids"] = ids.astype(np.int32)
    inp["p_w"] = (ids > 0).astype(np.float32)
    inp["t_codes"] = rng.integers(0, 256, (64, 4)).astype(np.uint8)
    # the engine case (tests/test_engine.py's sizes)
    inp["e_codes"] = rng.integers(0, E["b"], (E["N"], E["m"])).astype(
        np.uint8)
    inp["e_cent"] = (E["d"] ** -0.5 * rng.standard_normal(
        (E["m"], E["b"], E["d"] // E["m"]))).astype(np.float32)
    inp["e_h"] = rng.standard_normal((E["B"], E["d"])).astype(np.float32)
    inp["e_perm"] = np.arange(E["N"])[::-1].copy().astype(np.int64)
    # the two-tower models: the reference's weights, bridged
    for kind in ("jpq", "full"):
        jm = _j_two_tower(kind)
        vals = jax.tree.map(np.asarray, J_nn.values(
            jm.init_params(jax.random.PRNGKey(0))))
        for path, leaf in _flat(vals):
            inp[f"{kind}/" + "/".join(path)] = leaf
    inp["hist"] = rng.integers(0, TT["n_items"] + 1,
                               (8, TT["hist_len"])).astype(np.int32)
    return inp


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


def _j_two_tower(kind):
    emb = J_EC(0, 0, kind="jpq", m=4, b=16) if kind == "jpq" \
        else J_EC(0, 0, kind="full")
    return J_TwoTower(J_TTC(embedding=emb, **TT))


def _t_two_tower(kind, inp):
    emb = T_EC(0, 0, kind="jpq", m=4, b=16) if kind == "jpq" \
        else T_EC(0, 0, kind="full")
    tm = T_TwoTower(T_TTC(embedding=emb, **TT),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    bridge.load_values(tm, bridge.unflatten(inp, kind))
    return tm


# ----------------------------------------------------------- the worker
# (module-level, so spawned processes import it by name)

def _t(x):
    return torch.tensor(np.asarray(x))


def _stats_out(out, name, st):
    for key in ("skipped_tiles", "skips", "theta", "demoted"):
        out[f"{name}.{key}"] = st[key].numpy()
    out[f"{name}.total_tiles"] = np.asarray(st["total_tiles"])
    out[f"{name}.exchange_tiles"] = np.asarray(st["exchange_tiles"])


def _mesh_worker(mesh, tmp):
    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    D, S = mesh.shape["data"], mesh.shape["model"]
    out = {"coords": np.array([mesh.rank, mesh.data_index,
                               mesh.model_index])}
    me = torch.tensor([mesh.rank], dtype=torch.int32)
    out["gather_model"] = mesh.all_gather(me, "model", 0).numpy()
    out["gather_data"] = mesh.all_gather(me, "data", 0).numpy()
    out["max_all"] = mesh.all_reduce(me.float(), ("data", "model"),
                                     "max").numpy()
    out["sum_model"] = mesh.all_reduce(me, "model", "sum").numpy()
    fused = T_sharded.fused_topk_over_codes
    with T_dist.use_mesh_rules(mesh):
        # LUT level, unpruned: whole codes and this rank's block
        part, codes = _t(inp["u_part"]), _t(inp["u_codes"])
        lo, hi = T_dist.row_block(U["N"])
        v, i = fused(part, codes[lo:hi].clone(), U["k"], rows=U["N"])
        out["u_local.v"], out["u_local.i"] = v.numpy(), i.numpy()
        v, i = fused(part, codes, U["k"])
        out["u.v"], out["u.i"] = v.numpy(), i.numpy()
        # pruned, the state built inline
        v, i, st = fused(part, codes, U["k"], prune=True, return_stats=True)
        out["pi.v"], out["pi.i"] = v.numpy(), i.numpy()
        _stats_out(out, "pi", st)
        # the acceptance case: permute-then-shard, cold / warm / demoted
        qp, qc = _t(inp["q_part"]), _t(inp["q_codes"])
        state = T_ops.prepare_pruning(qc, Q["b"], Q["bn"],
                                      perm=_t(inp["q_perm"]))
        v, i, stc = fused(qp, qc, Q["k"], prune=state, return_stats=True)
        out["cold.v"], out["cold.i"] = v.numpy(), i.numpy()
        _stats_out(out, "cold", stc)
        v, i, stw = fused(qp, qc, Q["k"], prune=state, warm=stc["theta"],
                          return_stats=True)
        out["warm.v"], out["warm.i"] = v.numpy(), i.numpy()
        _stats_out(out, "warm", stw)
        v, i, std = fused(qp, qc, Q["k"], prune=state,
                          warm=torch.full((Q["B"],), 1e9),
                          return_stats=True)
        out["dem.v"], out["dem.i"] = v.numpy(), i.numpy()
        _stats_out(out, "dem", std)
        v, i = fused(qp, qc, Q["k"],
                     prune=T_ops.prepare_pruning(qc, Q["b"], Q["bn"]))
        out["ident.v"], out["ident.i"] = v.numpy(), i.numpy()
        qlo, qhi = T_dist.row_block(Q["N"])
        v, i = fused(qp, qc[qlo:qhi].clone(), Q["k"], prune=state,
                     rows=Q["N"])
        out["qlocal.v"], out["qlocal.i"] = v.numpy(), i.numpy()
        try:
            fused(qp, qc, Q["k"], prune=T_ops.prepare_pruning(qc, Q["b"], 96))
            out["mismatch_raises"] = np.array(0)
        except ValueError:
            out["mismatch_raises"] = np.array(1)
        errs = []
        for kw in (dict(warm=torch.zeros(U["B"])), dict(return_stats=True)):
            try:
                fused(part, codes, U["k"], **kw)
                errs.append(0)
            except ValueError as e:
                errs.append(int("pruned-path features" in str(e)))
        out["no_prune_raises"] = np.array(errs)
        # topk_over_items, pooled_lookup, take_rows
        sc = _t(inp["s_scores"])
        v, i = T_sharded.topk_over_items(sc, U["k"])
        out["items.v"], out["items.i"] = v.numpy(), i.numpy()
        v, i = T_sharded.topk_over_items(sc[:, lo:hi], U["k"], rows=U["N"])
        out["items_local.v"], out["items_local.i"] = v.numpy(), i.numpy()
        tab, ids, w = _t(inp["p_table"]), _t(inp["p_ids"]), _t(inp["p_w"])
        plo, phi = T_dist.row_block(64)
        out["pooled"] = T_sharded.pooled_lookup(tab, ids, w).numpy()
        out["pooled_local"] = T_sharded.pooled_lookup(
            tab[plo:phi].clone(), ids, w, rows=64).numpy()
        tc = _t(inp["t_codes"])
        out["take"] = T_sharded.take_rows(tc[plo:phi].clone(), ids,
                                          rows=64).numpy()
        out["whole"] = T_sharded.whole(tc[plo:phi].clone(), 64).numpy()
    _two_tower_cases(mesh, inp, out)
    _engine_case(mesh, inp, out)
    np.savez(os.path.join(tmp, f"{D}x{S}-rank{mesh.rank}.npz"), **out)


def _two_tower_cases(mesh, inp, out):
    hist = _t(inp["hist"])
    with torch.inference_mode():
        for kind in ("jpq", "full"):
            tm = _t_two_tower(kind, inp)
            p = tm.params()
            item = "codes" if kind == "jpq" else "table"
            whole_codes = p["item_emb"][item].clone()
            ref = {"fused": tm.retrieve(p, hist, top_k=7),
                   "mat": tm.retrieve(p, hist, top_k=7, fused=False)}
            u0 = tm.user_vec(p, hist)
            specs = bridge.keep_local_rows(tm, mesh)
            p = tm.params()
            out[f"{kind}.rows"] = np.array(p["item_emb"][item].shape[0])
            out[f"{kind}.spec"] = np.array(
                json.dumps(specs["item_emb"][item]))
            with T_dist.use_mesh_rules(mesh):
                got = {"fused": tm.retrieve(p, hist, top_k=7),
                       "mat": tm.retrieve(p, hist, top_k=7, fused=False)}
                u = tm.user_vec(p, hist)
                for name in got:
                    for j, x in enumerate(("v", "i")):
                        out[f"{kind}.{name}.{x}"] = got[name][j].numpy()
                        out[f"{kind}.{name}.{x}0"] = ref[name][j].numpy()
                out[f"{kind}.u"], out[f"{kind}.u0"] = u.numpy(), u0.numpy()
                if kind != "jpq":
                    continue
                # the warm loop over a prebuilt permute-then-shard state
                N = whole_codes.shape[0]
                counts = np.zeros(N, np.int64)
                ids = inp["hist"].reshape(-1)
                np.add.at(counts, ids[(ids >= 0) & (ids < N)], 1)
                state = T_engine.build_prune_state(
                    whole_codes, 16, shards=mesh.shape["model"],
                    perm=T_pop(counts))
                warm = T_TS(0.8)
                for r in range(3):
                    floor = torch.as_tensor(warm.floor(hist.shape[0]))
                    v, i, st = tm.retrieve(p, hist, top_k=7, prune=state,
                                           warm=floor, return_stats=True)
                    warm.update(st["theta"].numpy())
                    out[f"warm{r}.v"], out[f"warm{r}.i"] = v.numpy(), i.numpy()
                out["warm_seeded"] = np.array(int(warm.theta is not None))


def _engine_case(mesh, inp, out):
    emb = T_make_embedding(T_EC(n_items=E["N"], d=E["d"], kind="jpq",
                                m=E["m"], b=E["b"]))
    codes, cent = _t(inp["e_codes"]), _t(inp["e_cent"])
    h = _t(inp["e_h"])
    spec = T_engine.RetrievalSpec(kind="jpq", k=E["k"], prune=True,
                                  perm="catalogue", warm=0.9, stats=True)
    floor = torch.full((E["B"],), -float("inf"))

    def serve(p, shards):
        state = T_engine.build_prune_state(codes, E["b"], shards=shards,
                                           perm=inp["e_perm"])
        eng = T_engine.RetrievalEngine(spec, emb, p)
        eng.bind_catalogue(prune=state, version=1)
        return eng.retrieve(h, floor=floor)

    with torch.inference_mode():
        v0, i0, _ = serve({"codes": codes, "centroids": cent}, 0)
        lo, hi = T_dist.row_block(E["N"], mesh)
        with T_dist.use_mesh_rules(mesh):
            v, i, st = serve({"codes": codes[lo:hi].clone(),
                              "centroids": cent}, mesh.shape["model"])
        out["eng.lut"] = T_engine._jpq.partial_scores(
            {"codes": codes, "centroids": cent}, h).numpy()
    out["eng.v"], out["eng.i"] = v.numpy(), i.numpy()
    out["eng.v0"], out["eng.i0"] = v0.numpy(), i0.numpy()
    _stats_out(out, "eng", st)


# ----------------------------------------------- the reference's meshes

_REF_MESH = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import dist
from repro.core import sharded, engine
from repro.kernels.jpq_topk import ops as tops
tmp = sys.argv[1]
inp = dict(np.load(tmp + "/inputs.npz"))
U, Q, E = json.loads(sys.argv[2])
out = {}
def stats(name, st):
    for key in ("skipped_tiles", "skips", "theta", "demoted",
                "total_tiles", "exchange_tiles"):
        out[name + "." + key] = np.asarray(st[key])
for shape in ("1x2", "1x4", "2x4"):
    D, S = (int(x) for x in shape.split("x"))
    mesh = Mesh(np.array(jax.devices()[:D * S]).reshape(D, S),
                ("data", "model"))
    with dist.use_mesh_rules(mesh):
        part, codes = jnp.asarray(inp["u_part"]), jnp.asarray(inp["u_codes"])
        v, i, st = sharded.fused_topk_over_codes(part, codes, U["k"],
                                                 prune=True,
                                                 return_stats=True)
        stats(shape + ".pi", st)
        qp, qc = jnp.asarray(inp["q_part"]), jnp.asarray(inp["q_codes"])
        state = tops.prepare_pruning(qc, Q["b"], Q["bn"],
                                     perm=jnp.asarray(inp["q_perm"]))
        f = jax.jit(lambda p, c, w: sharded.fused_topk_over_codes(
            p, c, Q["k"], prune=state, warm=w, return_stats=True))
        g = jax.jit(lambda p, c: sharded.fused_topk_over_codes(
            p, c, Q["k"], prune=state, return_stats=True))
        _, _, stc = g(qp, qc)
        stats(shape + ".cold", stc)
        _, _, stw = f(qp, qc, stc["theta"])
        stats(shape + ".warm", stw)
        _, _, std = f(qp, qc, jnp.full((Q["B"],), 1e9, jnp.float32))
        stats(shape + ".dem", std)
        est = engine.build_prune_state(jnp.asarray(inp["e_codes"]), E["b"],
                                       shards=S, perm=inp["e_perm"])
        _, _, ste = sharded.fused_topk_over_codes(
            jnp.asarray(np.load(tmp + "/eng_lut.npy")),
            jnp.asarray(inp["e_codes"]), E["k"], prune=est,
            warm=jnp.full((E["B"],), -jnp.inf, jnp.float32),
            return_stats=True)
        stats(shape + ".eng", ste)
np.savez(tmp + "/ref_mesh.npz", **out)
print("ok")
"""


def _ref_mesh_run(tmp):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_MESH), tmp,
         json.dumps([U, Q, E])], env=env, capture_output=True, text=True,
        timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(os.path.join(tmp, "ref_mesh.npz")))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every mesh shape spawned once, then the reference's mesh runs;
    returns (inputs, {shape: [rank outputs]}, reference mesh stats)."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    inp = _make_inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    for shape in SHAPES:
        D, S = _dims(shape)
        M.spawn(_mesh_worker, D * S, (tmp,), model=S, timeout=SPAWN_TIMEOUT)
    ranks = {shape: [dict(np.load(os.path.join(tmp, f"{shape}-rank{r}.npz")))
                     for r in range(np.prod(_dims(shape)))]
             for shape in SHAPES}
    np.save(os.path.join(tmp, "eng_lut.npy"), ranks["1x2"][0]["eng.lut"])
    return inp, ranks, _ref_mesh_run(tmp)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _equal(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _ref_lut(part, codes, k):
    canon = jnp.where(jnp.asarray(part) == 0.0, 0.0, jnp.asarray(part))
    v, i = jpq_topk_lut_ref(canon, jnp.asarray(codes), k)
    return np.asarray(v), np.asarray(i)


# ------------------------------------------------ the mesh's own wiring

@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_coordinates_and_collective_order(run, shape):
    """rank = d * model + m (jax.make_mesh's order); all_gather over an
    axis concatenates in ascending index along it; all_reduce sums and
    maxes over the named axes."""
    _, ranks, _ = run
    D, S = _dims(shape)
    for r, out in enumerate(ranks[shape]):
        d, m = divmod(r, S)
        np.testing.assert_array_equal(out["coords"], [r, d, m])
        np.testing.assert_array_equal(out["gather_model"],
                                      [d * S + j for j in range(S)])
        np.testing.assert_array_equal(out["gather_data"],
                                      [j * S + m for j in range(D)])
        assert out["max_all"][0] == D * S - 1
        assert out["sum_model"][0] == sum(d * S + j for j in range(S))


@pytest.mark.parametrize("shape", SHAPES)
def test_every_rank_returns_the_whole_result(run, shape):
    """Every rank of every data row holds the whole [B, k] result, as
    the reference's global array is."""
    _, ranks, _ = run
    keys = [k for k in ranks[shape][0]
            if k.endswith((".v", ".i")) and not k.startswith(("jpq.", "full."))]
    for out in ranks[shape][1:]:
        for key in keys:
            _equal(out[key], ranks[shape][0][key])


# -------------------------------------------------------- the LUT level

@pytest.mark.parametrize("shape", SHAPES)
def test_fused_unpruned_bit_equal_to_unsharded(run, shape):
    """tests/test_serve_path.py:152 — the unpruned mesh path, codes
    whole and as this rank's block."""
    inp, ranks, _ = run
    rv, ri = _ref_lut(inp["u_part"], inp["u_codes"], U["k"])
    for out in ranks[shape]:
        for name in ("u", "u_local"):
            _equal(out[f"{name}.v"], rv)
            _equal(out[f"{name}.i"], ri)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_pruned_inline_bit_equal_and_stats(run, shape):
    """tests/test_serve_path.py:126 — prune=True under the mesh: the
    result bit-equal to the unsharded reference, the stats to the
    reference's mesh run."""
    inp, ranks, ref = run
    rv, ri = _ref_lut(inp["u_part"], inp["u_codes"], U["k"])
    for out in ranks[shape]:
        _equal(out["pi.v"], rv)
        _equal(out["pi.i"], ri)
        for key in ("skipped_tiles", "skips", "theta", "demoted",
                    "total_tiles", "exchange_tiles"):
            _equal(out[f"pi.{key}"], ref[f"{shape}.pi.{key}"])


@pytest.mark.parametrize("case", ["cold", "warm", "dem"])
@pytest.mark.parametrize("shape", SHAPES)
def test_permuted_warm_and_demoted_bit_exact(run, shape, case):
    """tests/test_mesh_perm.py's acceptance case on each mesh: the
    popularity-permuted global state, duplicate-score and -0.0 ties;
    cold, warm (seeded with the cold θ) and an overshooting 1e9 floor
    (every query demoted and re-swept) — values and ids bit-equal to
    the unsharded oracle, every stat equal to the reference's mesh
    run."""
    inp, ranks, ref = run
    rv, ri = _ref_lut(inp["q_part"], inp["q_codes"], Q["k"])
    for out in ranks[shape]:
        _equal(out[f"{case}.v"], rv)
        _equal(out[f"{case}.i"], ri)
        for key in ("skipped_tiles", "skips", "theta", "demoted",
                    "total_tiles", "exchange_tiles"):
            _equal(out[f"{case}.{key}"], ref[f"{shape}.{case}.{key}"])
    out = ranks[shape][0]
    D, S = _dims(shape)
    nt_loc = Q["N"] // S // Q["bn"]
    assert int(out[f"{case}.total_tiles"]) == nt_loc * S
    t_ex = int(out["cold.exchange_tiles"])
    assert t_ex > 0, "exchange point never scheduled"
    if case == "warm":
        skv = out["warm.skips"].reshape(S, nt_loc)
        assert skv[:, :t_ex].sum() > 0, \
            "warm start skipped nothing before the threshold exchange"
    if case == "dem":
        assert out["dem.demoted"].all()


@pytest.mark.parametrize("shape", SHAPES)
def test_identity_state_and_local_codes(run, shape):
    """An unpermuted prebuilt state, and the global state served from
    this rank's block of codes (``rows=N``): bit-equal to the oracle."""
    inp, ranks, _ = run
    rv, ri = _ref_lut(inp["q_part"], inp["q_codes"], Q["k"])
    for out in ranks[shape]:
        for name in ("ident", "qlocal"):
            _equal(out[f"{name}.v"], rv)
            _equal(out[f"{name}.i"], ri)


@pytest.mark.parametrize("shape", SHAPES)
def test_straddling_state_and_unpruned_floors_raise(run, shape):
    """A state whose tiles straddle the shards raises rather than being
    rebuilt per request; warm= / return_stats= without pruning raise
    (tests/test_engine.py:299) under the mesh too."""
    _, ranks, _ = run
    for out in ranks[shape]:
        assert int(out["mismatch_raises"]) == 1
        np.testing.assert_array_equal(out["no_prune_raises"], [1, 1])


@pytest.mark.parametrize("shape", SHAPES)
def test_topk_over_items_bit_equal(run, shape):
    """The hierarchical top-k over a column-sharded score matrix with
    duplicate values and -0.0 == lax.top_k over the whole matrix."""
    inp, ranks, _ = run
    rv, ri = jax.lax.top_k(jnp.asarray(inp["s_scores"]), U["k"])
    for out in ranks[shape]:
        for name in ("items", "items_local"):
            _equal(out[f"{name}.v"], rv)
            _equal(out[f"{name}.i"], ri)


@pytest.mark.parametrize("shape", SHAPES)
def test_pooled_lookup_within_tolerance(run, shape):
    """The row-sharded pooled lookup (ids outside the rank's rows
    clipped with weight 0, the [B, d] partial sums summed over "model")
    against the reference's unsharded pooled_lookup, within 1e-6."""
    inp, ranks, _ = run
    want = np.asarray(J_sharded.pooled_lookup(
        jnp.asarray(inp["p_table"]), jnp.asarray(inp["p_ids"]),
        jnp.asarray(inp["p_w"])))
    for out in ranks[shape]:
        for name in ("pooled", "pooled_local"):
            np.testing.assert_allclose(out[name], want, rtol=0,
                                       atol=POOL_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_take_rows_and_whole_exact(run, shape):
    """take_rows from the rank's block == the whole table's rows, and
    whole() gathers the blocks back bit for bit."""
    inp, ranks, _ = run
    for out in ranks[shape]:
        np.testing.assert_array_equal(out["take"],
                                      inp["t_codes"][inp["p_ids"]])
        np.testing.assert_array_equal(out["whole"], inp["t_codes"])


# ------------------------------------------------------ the model level

@pytest.mark.parametrize("shape", SHAPES)
def test_two_tower_jpq_sharded_serving(run, shape):
    """tests/test_serve_path.py:84 — TwoTower-RecJPQ from its rows of
    the catalogue (``keep_local_rows``), fused and materialise: bit-equal
    to the port's unsharded path, ids equal to the reference's
    materialise path and values within 2e-7 of it."""
    inp, ranks, _ = run
    D, S = _dims(shape)
    jm = _j_two_tower("jpq")
    jp = jm.init_params(jax.random.PRNGKey(0))
    rv, ri = jm.retrieve(jp, jnp.asarray(inp["hist"]), top_k=7, fused=False)
    for out in ranks[shape]:
        assert int(out["jpq.rows"]) == 512 // S
        assert json.loads(str(out["jpq.spec"])) == ["model", None]
        for name in ("fused", "mat"):
            _equal(out[f"jpq.{name}.v"], out[f"jpq.{name}.v0"])
            _equal(out[f"jpq.{name}.i"], out[f"jpq.{name}.i0"])
            np.testing.assert_array_equal(out[f"jpq.{name}.i"], ri)
            np.testing.assert_allclose(out[f"jpq.{name}.v"], rv, rtol=0,
                                       atol=TOL)
        _equal(out["jpq.u"], out["jpq.u0"])


@pytest.mark.parametrize("shape", SHAPES)
def test_two_tower_warm_loop_sharded(run, shape):
    """tests/test_mesh_perm.py::test_model_level_warm_serve_sharded —
    a prebuilt permute-then-shard state and the ThresholdState warm
    loop: every request's ids equal to the reference's materialise
    path (values within 2e-7), and the EMA seeded a floor."""
    inp, ranks, _ = run
    jm = _j_two_tower("jpq")
    jp = jm.init_params(jax.random.PRNGKey(0))
    rv, ri = jm.retrieve(jp, jnp.asarray(inp["hist"]), top_k=7, fused=False)
    for out in ranks[shape]:
        for r in range(3):
            _equal(out[f"warm{r}.v"], out["jpq.mat.v0"])
            np.testing.assert_array_equal(out[f"warm{r}.i"], ri)
            np.testing.assert_allclose(out[f"warm{r}.v"], rv, rtol=0,
                                       atol=TOL)
        assert int(out["warm_seeded"]) == 1


@pytest.mark.parametrize("shape", SHAPES)
def test_two_tower_full_table_sharded(run, shape):
    """The full-table two-tower: the user tower through the row-sharded
    pooled_lookup (within 1e-6 of the unsharded port, which sums in
    slot order), scores from the rank's column block; ids equal to the
    unsharded port's and the reference's."""
    inp, ranks, _ = run
    D, S = _dims(shape)
    jm = _j_two_tower("full")
    jp = jm.init_params(jax.random.PRNGKey(0))
    rv, ri = jm.retrieve(jp, jnp.asarray(inp["hist"]), top_k=7)
    for out in ranks[shape]:
        assert int(out["full.rows"]) == 512 // S
        np.testing.assert_allclose(out["full.u"], out["full.u0"], rtol=0,
                                   atol=POOL_TOL)
        for name in ("fused", "mat"):
            np.testing.assert_array_equal(out[f"full.{name}.i"],
                                          out[f"full.{name}.i0"])
            np.testing.assert_array_equal(out[f"full.{name}.i"], ri)
            np.testing.assert_allclose(out[f"full.{name}.v"], rv, rtol=0,
                                       atol=POOL_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_engine_permuted_warm_on_mesh(run, shape):
    """tests/test_engine.py:130 — the permuted + warm pruned engine from
    the rank's codes: bit-equal to the port's unsharded engine, ids
    equal to lax.top_k over the reference's logits (values within two
    ulps: the LUT einsum sums in another order than XLA), the stats equal to the reference's mesh run on the same LUT."""
    inp, ranks, ref = run
    jp = {"codes": J_nn.P(jnp.asarray(inp["e_codes"]), None),
          "centroids": J_nn.P(jnp.asarray(inp["e_cent"]), None)}
    from repro.core import jpq as J_jpq
    rv, ri = jax.lax.top_k(J_jpq.logits(jp, jnp.asarray(inp["e_h"])), E["k"])
    lut = ranks["1x2"][0]["eng.lut"]
    for out in ranks[shape]:
        _equal(out["eng.lut"], lut)
        _equal(out["eng.v"], out["eng.v0"])
        _equal(out["eng.i"], out["eng.i0"])
        np.testing.assert_array_equal(out["eng.i"], ri)
        np.testing.assert_allclose(out["eng.v"], rv, rtol=ENG_RTOL, atol=0)
        for key in ("skipped_tiles", "skips", "theta", "demoted",
                    "total_tiles", "exchange_tiles"):
            _equal(out[f"eng.{key}"], ref[f"{shape}.eng.{key}"])
        assert float(out["eng.total_tiles"]) > 0


# -------------------------------------------------- one process, no mesh

def test_shard_sweep_ids_matches_the_reference_and_the_state():
    """tests/test_mesh_perm.py: shard s's id-map is perm[s*L:(s+1)*L],
    the rows of a global state's ids."""
    N, shards = 480, 4
    perm = np.random.default_rng(3).permutation(N)
    layout = T_shard_sweep_ids(perm, shards)
    np.testing.assert_array_equal(layout, J_shard_sweep_ids(perm, shards))
    codes = torch.tensor(np.random.default_rng(4).integers(0, 8, (N, 3)))
    st = T_ops.prepare_pruning(codes, 8, 40, perm=torch.tensor(perm))
    np.testing.assert_array_equal(st.ids.numpy().reshape(shards, -1), layout)
    with pytest.raises(ValueError):
        T_shard_sweep_ids(perm, 7)


@pytest.mark.parametrize("N,shards", [(1_000_448, 16), (1_000_000, 8),
                                      (640, 4), (20_000, 8),
                                      (1_000_448, 2), (1_000_448, 4)])
def test_mesh_prune_block_n_matches_the_reference(N, shards):
    bn = T_ops.mesh_prune_block_n(N, shards)
    assert bn == J_mesh_bn(N, shards)
    assert (N // shards) % bn == 0
    assert T_engine.resolve_prune_block_n(N, shards=shards) == bn


def test_mesh_prune_block_n_at_full_width():
    """500,224 = 2^9 * 977 and 250,112 = 2^8 * 977 local rows: no power
    of two near 8,192, so both meshes tile at 7,816 (the unsharded
    default is 8,320); a shard count that does not divide falls back."""
    assert T_ops.mesh_prune_block_n(1_000_448, 2) == 7816
    assert T_ops.mesh_prune_block_n(1_000_448, 4) == 7816
    assert T_engine.resolve_prune_block_n(1_000_448) == 8320
    assert T_engine.resolve_prune_block_n(1_000_002, shards=4) == \
        T_ops.prune_block_n(1_000_002)
    with pytest.raises(ValueError):
        T_ops.mesh_prune_block_n(1_000_002, 4)


@pytest.mark.parametrize("kind", ["jpq", "full"])
@pytest.mark.parametrize("mesh_shape", [dict(data=1, model=4),
                                        dict(data=2, model=4),
                                        dict(data=1, model=3)])
def test_params_shardings_match_the_reference(kind, mesh_shape):
    """The TwoTower's axes tree is the reference's (nn.axes_tree of its
    init_params), and params_shardings places every leaf as the
    reference's does (PartitionSpec entries as tuples)."""
    jm = _j_two_tower(kind)
    meta = jm.init_params(jax.random.PRNGKey(0))
    tm = _t_two_tower(kind, {f"{kind}/" + "/".join(p): v for p, v in
                             _flat(jax.tree.map(np.asarray,
                                                J_nn.values(meta)))})
    j_axes = jax.tree.map(lambda p: p.axes, meta, is_leaf=J_nn.is_param)
    assert _norm(tm.param_axes()) == _norm(j_axes)
    jmesh = types.SimpleNamespace(shape=mesh_shape)
    got = T_dist.params_shardings(tm.params(), tm.param_axes(),
                                  M.HostMesh(**mesh_shape))
    # the reference's params_shardings is NamedSharding(mesh,
    # resolve_axes(p.axes, p.value.shape, mesh)) for every leaf
    for path, spec in _flat_specs(got):
        leaf = _at(meta, path)
        assert spec == tuple(J_resolve(leaf.axes, leaf.value.shape, jmesh)), \
            path


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm(v) for v in tree]
    return tuple(tree)


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_specs(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_specs(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_row_block_and_local_rows():
    x = torch.arange(24).reshape(12, 2)
    mesh = M.HostMesh(1, 4, rank=2)
    assert T_dist.row_block(12, mesh) == (6, 9)
    assert T_dist.row_block(10, mesh) is None          # 4 does not divide
    assert T_dist.row_block(12, M.HostMesh(4)) is None  # no model axis
    assert T_dist.row_block(12) is None                 # no mesh
    got = T_dist.local_rows(x, ("model", None), mesh)
    assert torch.equal(got, x[6:9]) and got.data_ptr() != x.data_ptr()
    assert T_dist.local_rows(x, (None, "model"), mesh) is x
    assert T_dist.local_rows(x, (None, None), mesh) is x
    assert T_dist.local_rows(x, ("model", None), M.HostMesh(1, 1)) is x
    d2 = M.HostMesh(2, 2, rank=3)
    assert (d2.data_index, d2.model_index, d2.world_size) == (1, 1, 4)
    assert T_dist.row_block(12, d2) == (6, 12)


@pytest.mark.parametrize("kind", ["jpq", "full"])
def test_keep_local_rows_cuts_only_the_catalogue(kind):
    """bridge.keep_local_rows: the codes / table keep this rank's rows,
    every other leaf (centroids, the user tower) stays whole."""
    jm = _j_two_tower(kind)
    vals = jax.tree.map(np.asarray,
                        J_nn.values(jm.init_params(jax.random.PRNGKey(0))))
    tm = _t_two_tower(kind, {f"{kind}/" + "/".join(p): v
                             for p, v in _flat(vals)})
    before = {"/".join(map(str, p)): t.clone()
              for p, t in _flat_specs(tm.params())}
    bridge.keep_local_rows(tm, M.HostMesh(1, 4, rank=1))
    after = {"/".join(map(str, p)): t for p, t in _flat_specs(tm.params())}
    item = "item_emb/" + ("codes" if kind == "jpq" else "table")
    for key, t in after.items():
        if key == item:
            assert torch.equal(t, before[key][128:256])
        else:
            assert torch.equal(t, before[key])
    # the table stays a parameter, the codes a buffer
    held = tm.item_emb._parameters if kind == "full" else tm.item_emb._buffers
    assert item.split("/")[1] in held


def test_sharded_functions_without_a_splitting_mesh():
    """Off a mesh, on a sizes-only mesh whose model axis does not divide
    the rows (N % S != 0: SASRec's N at S = 4), and with model == 1,
    the unsharded branch runs with no collective."""
    rng = np.random.default_rng(5)
    part = torch.tensor(rng.standard_normal((3, 2, 8)).astype(np.float32))
    codes = torch.tensor(rng.integers(0, 8, (21, 2)).astype(np.int32))
    want = T_ops.jpq_topk_lut(part, codes, 4)
    for mesh in (M.HostMesh(1, 4), M.HostMesh(4)):
        with T_dist.use_mesh_rules(mesh):
            got = T_sharded.fused_topk_over_codes(part, codes, 4)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            s = torch.tensor(rng.standard_normal((3, 21)).astype(np.float32))
            v, i = T_sharded.topk_over_items(s, 5)
            assert torch.equal(i, torch.topk(s, 5).indices.int())


def test_collectives_refuse_a_sizes_only_mesh_and_the_wrong_side():
    mesh = M.HostMesh(1, 2)
    with pytest.raises(ValueError, match="sizes-only"):
        mesh.all_gather(torch.zeros(2), "model")
    with pytest.raises(ValueError, match="share_card"):
        M.transport_for("cpu", share_card=True)
    with pytest.raises(ValueError, match="share_card"):
        M.spawn(_mesh_worker, 2, ("unused",), model=2, share_card=True,
                timeout=10)
    assert M.transport_for("cuda", share_card=True) == "gloo-staged"
    assert M.transport_for("cuda") == "nccl"
    assert M.HostMesh(1, 2, device="cpu").transport == "gloo"
    staged = M.HostMesh(1, 2, transport="gloo-staged", group=object(),
                        groups={"model": object(), "data": None})
    with pytest.raises(ValueError, match="cpu tensor on the gloo-staged"):
        staged.all_gather(torch.zeros(2), "model")


def test_training_and_the_request_server_on_a_model_mesh_raise():
    """Training on a "model" axis is ported for every recsys model
    (items 9c and 9c-ii); a model without a placement does not train
    there (the one refusal left).  The elastic exchange there replicates
    the model over "model" (item 9c-iii: no placement needed, no blocks
    cut), and the request server serves under a mesh (item 9d)."""
    from repro_torch.launch import server as T_server
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    with pytest.raises(ValueError, match="has no placement"):
        Trainer(object(), OptConfig(), TrainConfig(), data_fn=None,
                mesh=M.HostMesh(1, 2))
    tr = Trainer(object(), OptConfig(), TrainConfig(grad_compression="int8"),
                 data_fn=None, mesh=M.HostMesh(1, 2))
    assert not tr._split and tr._accum == 1 and tr._world == 1
    with T_R.use_mesh_rules(M.HostMesh(2, 2)):      # a block, no raise
        assert T_dist.constrain(torch.zeros(4, 4),
                                ("batch", "mlp")).shape == (4, 2)
    snap = T_server.main(["--device", "cpu", "--mesh", "2",
                          "--requests", "20"])
    assert snap["config"] == "queue+prune+mesh2"
    assert snap["requests_completed"] == 20


# ------------------------------------------------------ the serve CLI

def test_serve_cli_mesh_bit_equal_to_unsharded(capfd):
    """launch/serve.py --mesh 4 --prune --perm --warm on 4 gloo ranks:
    every rank's responses bit-equal to the unsharded loop's on the same
    seeded requests, the stats line with mesh=4, the candidate lists'
    bytes in each request's collectives."""
    argv = ["--device", "cpu", "--requests", "3", "--batch-size", "8",
            "--prune", "--perm", "--warm"]
    args = T_serve.build_parser().parse_args(argv + ["--mesh", "4"])
    ranks = T_serve.serve_mesh(args, keep_outputs=True,
                               timeout=SPAWN_TIMEOUT)
    line = capfd.readouterr().out          # rank 0's stdout
    assert "mesh=4 transport=gloo" in line and "path=fused+prune+perm+warm" \
        in line
    model, template = T_serve.smoke_model(args.arch, torch.device("cpu"))
    plain = T_serve.serve_loop(model, model.params(), template,
                               T_serve.build_parser().parse_args(argv),
                               keep_outputs=True)
    for res in ranks:
        assert res["mesh"] == 4 and res["transport"] == "gloo"
        for got, want in zip(res["outputs"], plain["outputs"], strict=True):
            _equal(got[0].numpy(), want[0].numpy())
            _equal(got[1].numpy(), want[1].numpy())
        # at least the merge's [B, 4 k] values and ids each request
        assert min(res["comm_bytes"]) >= 4 * 8 * 10 * 8
    assert ranks[0]["skip"] is not None


def test_serve_cli_main_mesh_fused():
    """``main(["--mesh", "2", ...])`` returns rank 0's result; the fused
    path launched no kernel on the CPU (the plain versions ran)."""
    res = T_serve.main(["--device", "cpu", "--requests", "2",
                        "--batch-size", "8", "--fused", "--mesh", "2"])
    assert res["mesh"] == 2 and res["path"] == "fused" and res["n"] == 2
    assert res["rank"] == 0 and sum(res["launches"].values()) == 0
    with pytest.raises(ValueError, match="share-card"):
        T_serve.main(["--device", "cpu", "--share-card"])
