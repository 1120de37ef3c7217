"""Training the CTR and two-tower models on a ``"model"`` mesh axis
(``placement`` of TwoTower, FM, DLRM and DIEN, ``bridge.keep_local_blocks``,
the tensor-parallel towers of ``nn/layers.mlp``, the row-block lookups
of ``core/sharded`` through ``embedding_bag_block`` / ``gather_block``,
the Trainer on a ``(data, model)`` mesh, its checkpoints, ``launch/train.py
--model-axis``) against the JAX reference, on gloo CPU processes at the
bundles' smoke widths.

The reference runs on one device in this process (its own mesh run
fails under jax 0.9.0: ROADMAP.md §3); both packages take the same
template batch and the reference's parameters, bridged with
``bridge.load_values``.  The smoke tables' rows divide by 2 and 4
(two-tower 512, FM 384, DLRM 288: the full-table DLRM at reduced rows),
but DIEN's 101 rows, which stay whole, as in the reference.  Held:
  * ``placement`` on (1, 2), (1, 4) and (2, 2): the reference's
    ``params_shardings`` but for the leaves kept whole by design (the
    RecJPQ centroids, DIEN's two GRUs); the blocks held are those
    slices;
  * step 0 at (1, 2) and (1, 4) for all eight bundles and FM at (2, 2):
    the loss within 1e-5 relative, every gathered gradient leaf within
    the leaf rule of tests/test_torch_recsys_train.py, of ``jax.grad``
    of the reference's single-device loss;
  * three Trainer steps: losses within 1e-5 relative of the reference's
    three adamw steps; two runs bit-identical;
  * a (1, 2) checkpoint holds whole leaves and resumes at (1, 2) bit-equal
    to the uninterrupted run, and at (1, 1) within 1e-4;
  * the row-block bag and gather: forward equal to the whole table's,
    backward bit-equal to the same rows of the whole table's gradient,
    and no row receives a foreign slot;
  * the train CLI at ``--model-axis 2`` (and FM at ``--devices 4
    --model-axis 2``): its losses within 1e-5 relative of the
    single-device CLI's.
"""
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as J_bundle
from repro.dist import resolve_axes as J_resolve
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch import dist as T_dist
from repro_torch.configs import get_bundle as T_bundle
from repro_torch.kernels.embedding_bag import ops as T_bag
from repro_torch.kernels.embedding_bag import ref as T_bag_ref
from repro_torch.launch import mesh as M
from repro_torch.launch import train as T_cli
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt

ARCHS = ["two-tower-retrieval", "two-tower-retrieval-jpq", "fm", "fm-jpq",
         "dlrm-rm2", "dlrm-rm2-jpq", "dien", "dien-jpq"]
SHAPES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
AT = {"1x2": ARCHS, "1x4": ARCHS, "2x2": ["fm"]}
CELLS = [(s, a) for s in SHAPES for a in AT[s]]
CELL_IDS = [f"{s}-{a}" for s, a in CELLS]
SPAWN_TIMEOUT = 200
LEAF, FLOOR = 1e-5, 1e-6         # tests/test_torch_recsys_train.py's rule
STEPS = 3
OPT = dict(lr=3e-3)


# ------------------------------------------------------------- inputs

def _ref(name):
    """(reference model, its params, numpy values, the template batch)."""
    jm, batch, rng = J_bundle(name).make_smoke()
    jp = jm.init_params(rng)
    return (jm, jp, jax.tree.map(np.asarray, J_nn.values(jp)),
            {k: np.array(v) for k, v in batch.items()})


def _t_model(name, values):
    tm, _ = T_bundle(name).make_smoke(device="cpu", seed=1)
    bridge.load_values(tm, values)
    return tm


# ----------------------------------------------------------- the worker
# (module-level, so spawned processes import it by name)

def _tb(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _rows(batch, d, D):
    n = len(next(iter(batch.values()))) // D
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def _whole(tree, specs, mesh):
    """{path: whole numpy array} of a tree of this rank's blocks."""
    sp = dict(_paths(specs))
    return {"/".join(map(str, p)): T_dist.gather_block(
        x.detach(), sp[p], mesh).numpy() for p, x in _paths(tree)}


def _one_step(mesh, name, values, batch):
    """(loss, {path: whole gradient}) of this rank's rows through the
    split model, as the Trainer runs it."""
    tm = _t_model(name, values)
    specs = dict(_paths(bridge.keep_local_blocks(tm, mesh)))
    p = tm.params()
    floats = [(q, x) for q, x in _paths(p) if torch.is_floating_point(x)]
    for _, x in floats:
        x.requires_grad_(True)
    D = mesh.shape["data"]
    loss_fn = T_loop.counted_loss(tm, mesh) if D > 1 else tm.train_loss
    with T_dist.use_mesh_rules(mesh, local_batch=D > 1):
        loss, _ = loss_fn(p, _tb(_rows(batch, mesh.data_index, D)))
        grads = torch.autograd.grad(loss, [x for _, x in floats])
    loss, *grads = T_loop.sum_over_ranks([loss.detach(), *grads], mesh)
    return float(loss), {"/".join(map(str, q)): T_dist.gather_block(
        g, specs[q], mesh).numpy() for (q, _), g in zip(floats, grads)}


def _trainer(mesh, name, values, batch, ckpt_dir=None, steps=STEPS):
    tm = _t_model(name, values)
    tr = T_loop.Trainer(tm, T_opt.OptConfig(**OPT), T_loop.TrainConfig(
        steps=steps, log_every=1, eval_every=0, ckpt_dir=ckpt_dir,
        ckpt_every=2), data_fn=lambda s: batch, mesh=mesh)
    params, hist = tr.run(params=tm.params())
    losses = [h["loss"] for h in hist if "loss" in h]
    if mesh is None:
        return losses, {"/".join(map(str, p)): x.detach().numpy()
                        for p, x in _paths(params)}
    return losses, _whole(params, tr._specs, mesh)


def _bitwise(a, b):
    return a[0] == b[0] and all(np.array_equal(a[1][k], b[1][k])
                                for k in a[1])


def _worker(mesh, inp_path, out_path):
    torch.set_num_threads(1)
    inp = torch.load(inp_path, weights_only=False)
    shape = f"{mesh.shape['data']}x{mesh.shape['model']}"
    out = {}
    for name in AT[shape]:
        values, batch = inp[name]
        out[("step", name)] = _one_step(mesh, name, values, batch)
        first = _trainer(mesh, name, values, batch)
        out[("three", name)] = first
        out[("bitwise", name)] = _bitwise(
            first, _trainer(mesh, name, values, batch))
        if shape != "1x2":
            continue
        ck = os.path.join(inp["ckpt_root"], name)
        out[("uninterrupted", name)] = _trainer(
            mesh, name, values, batch, ckpt_dir=os.path.join(ck, "A"),
            steps=4)
        _trainer(mesh, name, values, batch, ckpt_dir=os.path.join(ck, "B"),
                 steps=2)
        if mesh.rank == 0:
            shutil.copytree(os.path.join(ck, "B"), os.path.join(ck, "C"))
        out[("resumed", name)] = _trainer(
            mesh, name, values, batch, ckpt_dir=os.path.join(ck, "B"),
            steps=4)
    if mesh.rank == 0:
        torch.save(out, out_path)


# ------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh shape's results, each spawned once."""
    root = tmp_path_factory.mktemp("ctr_model_axis")
    inp = {name: _ref(name)[2:] for name in ARCHS}
    inp["ckpt_root"] = str(root / "ckpt")
    path = str(root / "inputs.pt")
    torch.save(inp, path)
    out = {"inputs": inp}
    for shape, (D, S) in SHAPES.items():
        res = str(root / f"{shape}.pt")
        M.spawn(_worker, D * S, (path, res), model=S,
                timeout=SPAWN_TIMEOUT)
        out[shape] = torch.load(res, weights_only=False)
    return out


_REF = {}


def _ref_results(name):
    """The reference's step-0 loss and flat gradient and its three adamw
    steps' losses on the template batch, once a bundle."""
    if name in _REF:
        return _REF[name]
    jm, jp, values, batch = _ref(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(v):
        return jm.train_loss(J_nn.with_values(jp, v), jb)[0]
    grad = jax.value_and_grad(loss_fn, allow_int=True)
    v = jax.tree.map(jnp.asarray, values)
    st = J_opt.init_opt_state(v)
    losses = []
    for s in range(STEPS):
        loss, g = grad(v)
        if s == 0:
            g0 = g
        v, st, _ = J_opt.apply_updates(J_opt.OptConfig(**OPT), st, v, g)
        losses.append(float(loss))
    flat = {}
    for path, x in jax.tree_util.tree_leaves_with_path(g0):
        if x.dtype != jax.dtypes.float0:
            flat["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                          for k in path)] = np.asarray(x)
    _REF[name] = losses, flat
    return _REF[name]


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("shape,name", CELLS, ids=CELL_IDS)
def test_one_step_matches_reference(runs, shape, name):
    losses, want = _ref_results(name)
    loss, got = runs[shape][("step", name)]
    assert abs(loss - losses[0]) <= 1e-5 * abs(losses[0])
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k in want:
        err = float(np.abs(want[k] - got[k]).max())
        assert err <= max(LEAF * float(np.abs(want[k]).max()),
                          FLOOR * top), (k, err)


@pytest.mark.parametrize("shape,name", CELLS, ids=CELL_IDS)
def test_three_trainer_steps_match_reference_and_repeat_bitwise(
        runs, shape, name):
    want, _ = _ref_results(name)
    losses, _ = runs[shape][("three", name)]
    assert np.allclose(losses, want, rtol=1e-5, atol=0)
    assert runs[shape][("bitwise", name)] is True


@pytest.mark.parametrize("name", ARCHS)
def test_checkpoint_resumes_at_1x2_bitwise_and_at_1x1(runs, name):
    """Steps 0-1 saved at (1, 2), resumed to step 4 at (1, 2): bit-equal
    to the uninterrupted run; the same checkpoint resumed on one
    device (whole leaves): within 1e-4."""
    r = runs["1x2"]
    l0, w0 = r[("uninterrupted", name)]
    l1, w1 = r[("resumed", name)]
    assert l1 == l0[2:]
    for k in w0:
        assert np.array_equal(w0[k], w1[k]), k
    values, batch = runs["inputs"][name]
    ck = os.path.join(runs["inputs"]["ckpt_root"], name, "C")
    l2, w2 = _trainer(None, name, values, batch, ckpt_dir=ck, steps=4)
    assert np.allclose(l2, l0[2:], rtol=1e-4, atol=0)
    for k in w0:
        if w0[k].dtype.kind == "f":
            assert np.abs(w0[k] - w2[k]).max() <= 1e-4 * max(
                np.abs(w0[k]).max(), 1.0), k
        else:
            assert np.array_equal(w0[k], w2[k]), k


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ARCHS)
def test_placement_is_the_references(shape, name):
    """Every leaf's placement is the reference's ``params_shardings``
    (``resolve_axes`` of its logical axes), but for the leaves kept
    whole by design; ``keep_local_blocks`` holds those slices."""
    import types
    jm, batch, rng = J_bundle(name).make_smoke()
    meta = jm.init_params(rng)
    D, S = SHAPES[shape]
    jmesh = types.SimpleNamespace(shape={"data": D, "model": S})
    tm = _t_model(name, jax.tree.map(np.asarray, J_nn.values(meta)))
    whole = {p: x.detach().clone() for p, x in _paths(tm.params())}
    mesh = M.HostMesh(D, S, rank=D * S - 1)
    got = dict(_paths(tm.placement(mesh)))
    split = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            meta, is_leaf=J_nn.is_param):
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        ref = tuple(J_resolve(leaf.axes, leaf.value.shape, jmesh))
        if key[-1] == "centroids" or key[0] in ("gru1", "augru"):
            assert got[key] == (None,) * len(ref), key
        else:
            assert got[key] == ref, key
            split += "model" in ref
    assert split >= 2            # the rows (FM: and linear), the towers
    bridge.keep_local_blocks(tm, mesh)
    for path, x in _paths(tm.params()):
        assert torch.equal(x, T_dist.local_block(whole[path], got[path],
                                                 mesh)), path


@pytest.mark.parametrize("L", [1, 6])
def test_block_bag_backward_is_the_whole_rows_and_skips_foreign(L):
    """The row-block bag (L = 6) and gather (L = 1) of each of 4 blocks:
    the ranks' forwards sum to the whole table's; each block's gradient
    is bit-equal to the same rows of the whole table's gradient (the
    same dout), and the backward's order gives each row exactly its own
    slots, the foreign ones the sentinel."""
    torch.manual_seed(0)
    V, d, S, n = 40, 3, 4, 50
    table = torch.randn(V, d, dtype=torch.float32)
    ids = torch.randint(0, V, (n, L))
    ids[:, 0] = 7                        # a long run on rank 0's rows
    w = torch.rand(n, L)
    dout = torch.randn(n, d)
    leaf = table.clone().requires_grad_(True)
    if L == 1:
        full = T_bag.gather(leaf, ids[:, 0])
    else:
        full = T_bag.embedding_bag(leaf, ids, w)
    (g_full,) = torch.autograd.grad(full, leaf, dout)
    total = torch.zeros_like(full)
    nb = V // S
    for r in range(S):
        lo = r * nb
        blk = table[lo:lo + nb].clone().requires_grad_(True)
        loc = ids - lo
        own = (loc >= 0) & (loc < nb)
        if L == 1:
            part = T_bag.gather_block(blk, loc[:, 0], own[:, 0])
        else:
            part = T_bag.embedding_bag_block(blk, loc, own, w)
        total = total + part.detach()
        (g,) = torch.autograd.grad(part, blk, dout)
        assert torch.equal(g, g_full[lo:lo + nb]), r
        marked = torch.where(own, loc, nb)
        _, offs, _, bad = T_bag_ref.sort_ids_ref(marked, nb)
        runs = offs[1:] - offs[:-1]
        want = torch.bincount(loc[own], minlength=nb)
        assert torch.equal(runs, want)
        assert int(offs[nb]) == int(own.sum())     # the rest: sentinels
        assert bad == bool((~own).any())
    assert torch.allclose(total, full.detach(), rtol=1e-6, atol=1e-6)


def _cli_losses(text):
    return [float(x) for x in re.findall(r"'loss': ([0-9.e+-]+)", text)]


@pytest.mark.parametrize("arch,flags", [
    ("fm", ["--model-axis", "2"]),
    ("fm", ["--devices", "4", "--model-axis", "2"]),
    ("two-tower-retrieval-jpq", ["--model-axis", "2"]),
    ("dien", ["--model-axis", "2"])])
def test_cli_model_axis_matches_single_device(capfd, arch, flags):
    argv = ["--device", "cpu", "--arch", arch, "--steps", "3"]
    hist = T_cli.main(argv)
    capfd.readouterr()
    T_cli.main(argv + flags)
    out = capfd.readouterr().out
    D = 2 if "4" in flags else 1
    want = [h["loss"] for h in hist if "loss" in h]
    got = _cli_losses(out)
    assert f"mesh: {{'data': {D}, 'model': 2}} (gloo" in out
    assert f"done at step 3 on cpu, mesh {{'data': {D}, 'model': 2}}" in out
    assert len(got) == 3
    assert np.allclose(got, want, rtol=1e-5, atol=0)
