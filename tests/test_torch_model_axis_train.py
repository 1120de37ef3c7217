"""Training the sequential recommenders on a ``"model"`` mesh axis
(repro_torch's tensor parallelism: ``SeqRecModel.placement``,
``bridge.keep_local_blocks``, the head- and MLP-parallel encoder, the
vocab-parallel cross-entropy, the Trainer on a ``(data, model)`` mesh,
its checkpoints, the metrics on column blocks, ``launch/train.py
--model-axis``) against the JAX reference, on the CPU.

The port's meshes are gloo processes started by
``repro_torch.launch.mesh.spawn``, each shape spawned once (1x2, 1x4,
2x2), every rank running every case; the reference runs on one device
in this process (its own mesh run, ``repro.launch.train --devices 2
--model-axis 2``, fails under jax 0.9.0 with a ``ShardingTypeError`` in
its codes gather: ROADMAP.md §3).  Both packages take the same numpy
batches, the reference's parameters bridged into the port with
``dropout = 0``, and BERT4Rec the reference's own ``mask_batch``.

Held (tolerances: the leaf rule of tests/test_torch_recsys_train.py):
  * every leaf's placement on (1, 2), (1, 4) and (2, 2) is the
    reference's ``params_shardings`` (``resolve_axes`` of its axes),
    but for the leaves kept whole by design (the centroids, GRU4Rec's
    GRU weights);
  * the vocab-parallel cross-entropy's loss within 1e-6 relative and
    its gradient within 1e-6 of its largest entry of the reference's
    ``_xent`` after ``_mask_special``, labels on every rank and the pad
    and [MASK] columns at the edges;
  * one step (SASRec, BERT4Rec, GRU4Rec x full_ce, sampled_bce, code_ce;
    the full and QR tables; a catalogue S does not divide, whose codes
    stay whole) at (1, 2), (1, 4) and (2, 2): the loss within 1e-5
    relative, every gathered gradient leaf within 1e-5 of its largest
    entry or 1e-6 of the gradient's largest, of ``jax.grad`` of the
    reference's single-device ``train_loss`` on the whole batch (at
    (2, 2) too: each data rank's terms over the whole batch's counts,
    the ranks' gradients summed, ``train/loop.counted_loss``);
  * three Trainer steps: losses within 1e-5 relative of the reference's
    three adamw steps on the whole batch; the clip norm of the first within 1e-6 relative
    of the reference's ``global_norm``; bit-identical run to run at
    (1, 2);
  * checkpoints at (1, 2): whole leaves under the reference's keys, read
    by the reference's ``restore_checkpoint``; SIGTERM, then resume at
    (1, 2) bit-equal to the uninterrupted run, at (1, 1) within 1e-5;
  * ``rank_of`` / NDCG@10 / HR@10 on column blocks equal to the whole
    scores' (ties included);
  * the train CLI at ``--model-axis 2`` and ``--devices 4 --model-axis
    2`` on gloo processes: its losses within 1e-5 relative of the
    single-device CLI's.
"""
import os
import re
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as J_restore
from repro.core import EmbeddingConfig as J_EC
from repro.dist import resolve_axes as J_resolve
from repro.models import sequential as J_seq
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch import dist as T_dist
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.launch import mesh as M
from repro_torch.launch import train as T_cli
from repro_torch.models import sequential as T_seq
from repro_torch.train import loop as T_loop
from repro_torch.train import metrics as T_met
from repro_torch.train import optimizer as T_opt

SHAPES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
SPAWN_TIMEOUT = 150
# 132 rows split 2 and 4 ways (QR: r_table's 12 rows split, q_table's
# 11 stay whole); 133 rows split neither way
N_ITEMS, ODD = 130, 131
KW = dict(max_len=10, d_model=16, n_layers=2, n_heads=4, d_ff=32,
          n_negatives=2)
ARCHS = ("sasrec", "bert4rec", "gru4rec")
# (arch, table, loss, n_items): the one-step cases
CASES = ([(a, "jpq", loss, N_ITEMS) for a in ARCHS
          for loss in ("full_ce", "sampled_bce", "code_ce")]
         + [("sasrec", "full", "full_ce", N_ITEMS),
            ("bert4rec", "qr", "full_ce", N_ITEMS),
            ("sasrec", "jpq", "full_ce", ODD)])
CASE_IDS = ["-".join(map(str, c)) for c in CASES]
LEAF, FLOOR = 1e-5, 1e-6         # tests/test_torch_recsys_train.py's rule
STEPS, B = 3, 4
OPT = dict(lr=3e-3)


# ------------------------------------------------------------- inputs

def _kw(arch, loss, n_items):
    return dict(KW, arch=arch, loss=loss, n_items=n_items)


def _codes(n_items):
    return np.random.default_rng(1).integers(
        0, 16, (n_items + 2, 4)).astype(np.int32)


def _j_model(arch, kind, loss, n_items):
    emb = J_EC(0, 0, kind=kind, m=4, b=16)
    return J_seq.SeqRecModel(J_seq.SeqRecConfig(embedding=emb,
                                                **_kw(arch, loss, n_items)),
                             codes=_codes(n_items) if kind == "jpq" else None)


def _t_model(arch, kind, loss, n_items, values=None):
    emb = T_EC(0, 0, kind=kind, m=4, b=16, use_kernel=True)
    tm = T_seq.SeqRecModel(T_seq.SeqRecConfig(embedding=emb,
                                              **_kw(arch, loss, n_items)),
                           codes=_codes(n_items) if kind == "jpq" else None,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    if values is not None:
        bridge.load_values(tm, values)
    return tm


def _batch(jm, arch, n_items, seed):
    """B rows of S = 10, left-padded; the causal archs' labels and two
    negatives a position (never the label), BERT4Rec masked by the
    reference's ``mask_batch``."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, n_items + 1, (B, 10))
    for r in range(B):
        seq[r, :r + 1] = 0
    if arch == "bert4rec":
        ms, tg = J_seq.mask_batch(jax.random.PRNGKey(seed), jnp.asarray(seq),
                                  jm.cfg.mask_prob, jm.cfg.mask_id)
        return {"seq": np.array(ms), "targets": np.array(tg)}
    labels = np.roll(seq, -1, 1)
    labels[:, -1] = rng.integers(1, n_items + 1, B)
    labels[:, -2] = n_items         # the last rank's last item
    labels[seq == 0] = 0
    neg = rng.integers(1, n_items, seq.shape + (2,))
    return {"seq": seq, "labels": labels,
            "negatives": neg + (neg >= labels[..., None])}


def _values(jm, seed=0):
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jp, jax.tree.map(np.asarray, J_nn.values(jp))


def _rows(batch, d, D):
    n = B // D
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


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


def _whole(tree, specs, mesh):
    """{path: whole numpy array} of a tree of this rank's blocks."""
    sp = dict(_paths(specs))
    return {"/".join(map(str, p)): T_dist.gather_block(
        x.detach(), sp[p], mesh).numpy() for p, x in _paths(tree)}


def _one_step(mesh, case, values, batch):
    """(loss, {path: whole gradient}): this rank's data rows through the
    split model over the whole batch's counts, the data group's sum,
    the blocks gathered."""
    D = mesh.shape["data"]
    tm = _t_model(*case, values=values)
    specs = bridge.keep_local_blocks(tm, mesh)
    p = tm.params()
    with T_dist.use_mesh_rules(mesh, local_batch=True):
        loss, _ = T_loop.counted_loss(tm, mesh)(
            p, _tb(_rows(batch, mesh.data_index, D)))
        floats = [x for _, x in _paths(p) if torch.is_floating_point(x)]
        got = iter(torch.autograd.grad(loss, floats))
    grads = {q: next(got) for q, x in _paths(p)
             if torch.is_floating_point(x)}
    loss, *flat = T_loop.sum_over_ranks([loss.detach()]
                                        + list(grads.values()), mesh)
    grads = dict(zip(grads, flat))
    sp = dict(_paths(specs))
    return float(loss), {"/".join(map(str, q)): T_dist.gather_block(
        g, sp[q], mesh).numpy() for q, g in grads.items()}


def _trainer(mesh, case, values, batches, ckpt_dir=None, steps=STEPS,
             sigterm_at=None):
    tm = _t_model(*case, values=values)

    def data_fn(s):
        if s == sigterm_at and (mesh is None or mesh.rank == 0):
            os.kill(os.getpid(), signal.SIGTERM)
        return batches[s]
    tr = T_loop.Trainer(tm, T_opt.OptConfig(**OPT), T_loop.TrainConfig(
        steps=steps, batch_size=B, log_every=1, eval_every=0,
        ckpt_dir=ckpt_dir, ckpt_every=2), data_fn=data_fn, mesh=mesh)
    params, hist = tr.run(params=tm.params())
    rows = [h for h in hist if "loss" in h]
    specs = tr._specs if mesh is not None else None
    whole = (_whole(params, specs, mesh) if mesh is not None else
             {"/".join(map(str, p)): x.detach().numpy()
              for p, x in _paths(params)})
    return ([h["loss"] for h in rows], [h["grad_norm"] for h in rows],
            whole, tr)


def _xent_case(mesh, inp):
    """The vocab-parallel cross-entropy on this rank's columns of the
    shared logits, masked as ``_mask_special`` masks them."""
    tm = _t_model("sasrec", "jpq", "full_ce", N_ITEMS)
    logits = torch.as_tensor(inp["logits"])
    N = logits.shape[-1]
    with T_dist.use_mesh_rules(mesh):
        lo, hi = T_dist.row_block(N)
        leaf = logits[..., lo:hi].clone().requires_grad_(True)
        blk = tm._mask_special(leaf * 1.0)
        labels = torch.as_tensor(inp["labels"])
        valid = labels > 0
        ce = T_seq.vocab_parallel_xent(blk, labels, lo, mesh)
        loss = torch.sum(ce * valid) / valid.sum()
        (g,) = torch.autograd.grad(loss, leaf)
    return float(loss), mesh.all_gather(g, "model", 2).numpy()


def _metrics_case(mesh, inp):
    sc, tg = torch.as_tensor(inp["scores"]), torch.as_tensor(inp["target"])
    N = sc.shape[-1]
    with T_dist.use_mesh_rules(mesh):
        lo, hi = T_dist.row_block(N)
        blk = sc[:, lo:hi]
        return np.stack([T_met.rank_of(blk, tg, rows=N).numpy(),
                         T_met.ndcg_at_k(blk, tg, rows=N).numpy(),
                         T_met.hr_at_k(blk, tg, rows=N).numpy()])


def _worker(mesh, inp_path, out_path):
    torch.set_num_threads(1)
    inp = torch.load(inp_path, weights_only=False)
    out = {}
    shape = f"{mesh.shape['data']}x{mesh.shape['model']}"
    for case in CASES:
        values, batch = inp["one"][case]
        out[case] = _one_step(mesh, case, values, batch)
    for arch in ARCHS:
        case = (arch, "jpq", "full_ce", N_ITEMS)
        values, batches = inp["three"][arch]
        out[("three", arch)] = _trainer(mesh, case, values, batches)[:3]
    out["xent"] = _xent_case(mesh, inp)
    out["metrics"] = _metrics_case(mesh, inp)
    if shape == "1x2":
        case = ("sasrec", "jpq", "full_ce", N_ITEMS)
        values, batches = inp["three"]["sasrec"]
        again = _trainer(mesh, case, values, batches)
        first = out[("three", "sasrec")]
        out["bitwise"] = (again[0] == first[0] and all(
            np.array_equal(again[2][k], first[2][k]) for k in first[2]))
        ck = inp["ckpt_dirs"]
        out["uninterrupted"] = _trainer(mesh, case, values, batches,
                                        ckpt_dir=ck["A"], steps=4)[:3]
        _, _, _, tr = _trainer(mesh, case, values, batches,
                               ckpt_dir=ck["B"], steps=4, sigterm_at=1)
        out["preempted_at"] = tr.done_step
        if mesh.rank == 0:
            shutil.copytree(ck["B"], ck["C"])
        out["resumed"] = _trainer(mesh, case, values, batches,
                                  ckpt_dir=ck["B"], steps=4)[:3]
    if mesh.rank == 0:
        torch.save(out, out_path)


# ------------------------------------------------------------ fixtures

def _inputs(ckpt_root):
    rng = np.random.default_rng(7)
    inp = {"one": {}, "three": {}}
    for case in CASES:
        jm = _j_model(*case)
        inp["one"][case] = (_values(jm)[1], _batch(jm, case[0], case[3], 3))
    for arch in ARCHS:
        jm = _j_model(arch, "jpq", "full_ce", N_ITEMS)
        inp["three"][arch] = (_values(jm)[1],
                              [_batch(jm, arch, N_ITEMS, 10 + s)
                               for s in range(4)])
    T, N = 6, N_ITEMS + 2
    inp["logits"] = (4 * rng.standard_normal((2, T, N))).astype(np.float32)
    labels = rng.integers(1, N - 1, (2, T))
    labels[0, :4] = [1, N // 4, N // 2 + 1, N - 2]   # on every rank
    labels[1, :2] = [0, N - 1]                       # pad, [MASK]
    inp["labels"] = labels
    s = rng.integers(-3, 4, (16, N)).astype(np.float32)
    inp["scores"] = np.where(s == 0, np.float32(-0.0), s)
    tg = rng.integers(0, N, 16)
    tg[:3] = [0, N - 1, N // 2]
    inp["target"] = tg
    inp["ckpt_dirs"] = {k: os.path.join(ckpt_root, k) for k in "ABC"}
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh shape's results, each spawned once."""
    root = tmp_path_factory.mktemp("model_axis")
    inp = _inputs(str(root / "ckpt"))
    path = str(root / "inputs.pt")
    torch.save(inp, path)
    out = {}
    for name, (D, S) in SHAPES.items():
        res = str(root / f"{name}.pt")
        M.spawn(_worker, D * S, (path, res), model=S,
                timeout=SPAWN_TIMEOUT)
        out[name] = torch.load(res, weights_only=False)
    out["inputs"] = inp
    return out


def _j_loss_grads(case, values, batch):
    jm = _j_model(*case)
    jp, _ = _values(jm)

    def loss(v):
        return jm.train_loss(J_nn.with_values(jp, v),
                             jax.tree.map(jnp.asarray, batch))[0]
    val, g = jax.value_and_grad(loss, allow_int=True)(
        jax.tree.map(jnp.asarray, values))
    return float(val), g


def _j_flat(g):
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(g):
        if x.dtype == jax.dtypes.float0:
            continue
        out["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)] = np.asarray(x)
    return out


@pytest.fixture(scope="module")
def ref_cache():
    """The reference's results, each computed once for the module (the
    1x2 and 1x4 cases share them)."""
    return {}


def _ref_step(cache, case, values, batch):
    """The reference's loss and gradient of its one step over the whole
    batch."""
    key = (case, id(batch))
    if key not in cache:
        cache[key] = _ref_step_uncached(case, values, batch)
    return cache[key]


def _ref_three(cache, arch, values, batches):
    """The reference's three adamw steps: (losses, clip norms)."""
    key = ("three", arch)
    if key in cache:
        return cache[key]
    case = (arch, "jpq", "full_ce", N_ITEMS)
    cfg = J_opt.OptConfig(**OPT)
    v = jax.tree.map(jnp.asarray, values)
    st = J_opt.init_opt_state(v)
    want, norms = [], []
    for s in range(STEPS):
        loss, g = _ref_step_uncached(case, jax.tree.map(np.asarray, v),
                                     batches[s])
        g = _unflat_like(v, g)
        norms.append(float(J_opt.global_norm(g)))
        v, st, _ = J_opt.apply_updates(cfg, st, v, g)
        want.append(loss)
    cache[key] = want, norms
    return want, norms


def _ref_step_uncached(case, values, batch):
    loss, g = _j_loss_grads(case, values, batch)
    return loss, _j_flat(g)


def _rule(want, got):
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(want) == set(got)
    for k in want:
        err = float(np.abs(want[k] - got[k]).max())
        assert err <= max(LEAF * float(np.abs(want[k]).max()),
                          FLOOR * top), (k, err)


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_one_step_matches_reference(runs, ref_cache, shape, case):
    values, batch = runs["inputs"]["one"][case]
    want_loss, want = _ref_step(ref_cache, case, values, batch)
    loss, got = runs[shape][case]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    _rule(want, got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ["sasrec", "gru4rec", "bert4rec-qr"])
def test_placement_is_the_references(shape, arch):
    """The port's placement of every leaf: the reference's
    ``params_shardings`` (``resolve_axes`` of its logical axes), but for
    the leaves kept whole by design; the blocks held are those slices."""
    import types
    arch, kind = (arch.split("-") + ["jpq"])[:2]
    jm = _j_model(arch, kind, "full_ce", N_ITEMS)
    meta = jm.init_params(jax.random.PRNGKey(0))
    D, S = SHAPES[shape]
    jmesh = types.SimpleNamespace(shape={"data": D, "model": S})
    tm = _t_model(arch, kind, "full_ce", N_ITEMS,
                  jax.tree.map(np.asarray, J_nn.values(meta)))
    whole = {"/".join(map(str, p)): x.detach().clone()
             for p, x in _paths(tm.params())}
    mesh = M.HostMesh(D, S, rank=S - 1)
    got = dict(_paths(tm.placement(mesh)))
    kept_whole = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            meta, is_leaf=J_nn.is_param):
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        ref = tuple(J_resolve(leaf.axes, leaf.value.shape, jmesh))
        if key[-1] == "centroids" or key[0] == "gru":
            kept_whole.append(ref)
            assert got[key] == (None,) * len(ref), key
        else:
            assert got[key] == ref, key
    if arch == "gru4rec":
        assert ("model", None) in kept_whole      # wh: split by GSPMD
    bridge.keep_local_blocks(tm, mesh)
    for path, x in _paths(tm.params()):
        k = "/".join(map(str, path))
        assert torch.equal(x, T_dist.local_block(whole[k], got[path], mesh))
    if arch != "gru4rec":                        # 4 heads, d_ff 32
        p = tm.params()["blocks"][0]
        assert p["attn"]["wq"].shape == (16, 4 // S, 4)
        assert p["mlp"]["wi"]["w"].shape == (16, 32 // S)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_vocab_parallel_xent_matches_reference(runs, shape):
    inp = runs["inputs"]
    jm = _j_model("sasrec", "jpq", "full_ce", N_ITEMS)
    labels = jnp.asarray(inp["labels"])
    valid = labels > 0

    def loss(lg):
        ce = J_seq._xent(jm._mask_special(lg), labels)
        return jnp.sum(ce * valid) / jnp.sum(valid)
    want, g = jax.value_and_grad(loss)(jnp.asarray(inp["logits"]))
    got, gg = runs[shape]["xent"]
    assert abs(got - float(want)) <= 1e-6 * abs(float(want))
    g = np.asarray(g)
    assert np.abs(gg - g).max() <= 1e-6 * np.abs(g).max()
    assert np.all(gg[..., 0] == 0) and np.all(gg[..., -1] == 0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_trainer_steps_match_reference(runs, ref_cache, shape, arch):
    """Three adamw steps of the Trainer on the mesh: the losses of the
    reference's three steps on the whole batch (jax.grad +
    apply_updates), and the first step's clip norm."""
    values, batches = runs["inputs"]["three"][arch]
    want, norms = _ref_three(ref_cache, arch, values, batches)
    losses, gnorms, _ = runs[shape][("three", arch)]
    assert np.allclose(losses, want, rtol=1e-5, atol=0)
    assert abs(gnorms[0] - norms[0]) <= 1e-6 * norms[0]
    assert np.allclose(gnorms, norms, rtol=1e-5, atol=0)


def _unflat_like(tree, flat):
    def one(path, x):
        k = "/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                     for p in path)
        return jnp.asarray(flat[k]) if k in flat else jnp.zeros_like(x)
    return jax.tree_util.tree_map_with_path(one, tree)


def test_run_to_run_bitwise(runs):
    assert runs["1x2"]["bitwise"] is True


def test_checkpoint_holds_whole_leaves_the_reference_reads(runs):
    """The (1, 2) run's checkpoint: whole leaves under the reference's
    keys, the reference's ``restore_checkpoint`` reads it, and its
    values are the run's gathered parameters."""
    inp = runs["inputs"]
    values, _ = inp["three"]["sasrec"]
    jv = jax.tree.map(jnp.asarray, values)
    like = {"values": jv, "opt": J_opt.init_opt_state(jv)}
    tree, step = J_restore(inp["ckpt_dirs"]["A"], like)
    assert step == 4
    _, _, whole = runs["1x2"]["uninterrupted"]
    for k, x in _j_flat(tree["values"]).items():
        assert np.array_equal(x, whole[k]), k
    flat = _j_flat(tree["opt"]["m"])
    assert flat["blocks/0/attn/wq"].shape == (16, 4, 4)
    assert flat["blocks/0/mlp/wi/w"].shape == (16, 32)


def test_sigterm_resume_at_1x2_bitwise_and_at_1x1_within_tolerance(runs):
    r = runs["1x2"]
    assert r["preempted_at"] == 2
    l0, _, w0 = r["uninterrupted"]
    l1, _, w1 = r["resumed"]
    assert l1 == l0[2:]
    for k in w0:
        assert np.array_equal(w0[k], w1[k]), k
    inp = runs["inputs"]
    values, batches = inp["three"]["sasrec"]
    l2, _, w2, tr = _trainer(None, ("sasrec", "jpq", "full_ce", N_ITEMS),
                             values, batches,
                             ckpt_dir=inp["ckpt_dirs"]["C"], steps=4)
    assert tr.done_step == 4
    assert np.allclose(l2, l0[2:], rtol=1e-5, atol=0)
    for k in w0:
        if w0[k].dtype.kind == "f":
            assert np.abs(w0[k] - w2[k]).max() <= 1e-5 * max(
                np.abs(w0[k]).max(), 1.0), k
        else:
            assert np.array_equal(w0[k], w2[k])


@pytest.mark.parametrize("shape", SHAPES)
def test_metrics_on_column_blocks_equal_whole_scores(runs, shape):
    inp = runs["inputs"]
    sc, tg = torch.as_tensor(inp["scores"]), torch.as_tensor(inp["target"])
    want = np.stack([T_met.rank_of(sc, tg).numpy(),
                     T_met.ndcg_at_k(sc, tg).numpy(),
                     T_met.hr_at_k(sc, tg).numpy()])
    assert np.array_equal(runs[shape]["metrics"], want)


def _cli_losses(text):
    return [float(x) for x in re.findall(r"'loss': ([0-9.e+-]+)", text)]


@pytest.mark.parametrize("flags", [["--model-axis", "2"],
                                   ["--devices", "4", "--model-axis", "2"]])
def test_cli_model_axis_matches_single_device(capfd, flags):
    argv = ["--device", "cpu", "--steps", "4", "--n-items", "130",
            "--batch-size", "8", "--eval-every", "2"]
    D = 2 if "4" in flags else 1
    hist = T_cli.main(argv)
    capfd.readouterr()
    T_cli.main(argv + flags)
    out = capfd.readouterr().out
    want = [h["loss"] for h in hist if "loss" in h]
    got = _cli_losses(out)
    assert f"mesh: {{'data': {D}, 'model': 2}} (gloo" in out
    assert "eval NDCG@10" in out and "done at step 4" in out
    assert len(got) == 3                       # rank 0's last rows
    # at (2, 2) too: the whole batch's loss, the ranks' shares summed
    assert np.allclose(got, want[-3:], rtol=1e-5, atol=0)
