"""The data group's loss on gloo CPU processes: plain data parallelism
(a ``(D, 1)`` mesh, D = 2 and 4) against the JAX reference's one step
over the whole batch, on batches whose ranks hold skewed counts of
labelled positions.

The reference jits one step over the global batch, so a loss term is
its sum over every rank's positions over their count.  The port gives
each rank its own rows; ``train/loop.counted_loss`` sums the counts
each term is a mean over (``model.loss_counts``) over ``"data"`` before
the forward, each rank's loss is its sums over those counts, and the
ranks' gradients are summed.  Held:
  * SASRec, BERT4Rec (masked by the reference's ``mask_batch``), GRU4Rec
    and SASRec with ``semantic_weight`` 0.5 on ``launch/train.py``'s
    data (2,000 users and items, 32 positions, seed 0) at B = 64, whose
    step-0 halves hold 562 and 628 labelled positions; DIEN with its
    ``aux`` term on a batch whose rows hold 0 to 9 items; FM, whose rows
    all count: one step's loss within 1e-5 relative and every gradient
    leaf within the leaf rule of tests/test_torch_recsys_train.py of
    ``jax.grad`` of the reference's loss on the whole batch; the
    Trainer's two adamw steps' losses within 1e-5 relative of the
    reference's, the first clip norm within 1e-6 relative;
  * the two-tower model's ``negatives`` at D = 2: ``"global"`` against
    the reference's ``[B, B]`` in-batch loss (the positives gathered
    over ``"data"``, ``dist.gather_from_data``) and ``"local"`` against
    its ``[G, b, b]`` loss (G = 2: ``repro.dist.data_shard_count``
    patched to 2), the loss, ``in_batch_acc`` and the gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dist as J_dist
from repro.configs import get_bundle as J_bundle
from repro.core import EmbeddingConfig as J_EC
from repro.models import recsys as J_rs
from repro.models import sequential as J_seq
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch import dist as T_dist
from repro_torch.configs import get_bundle as T_bundle
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
from repro_torch.launch import mesh as M
from repro_torch.models import recsys as T_rs
from repro_torch.models import sequential as T_seq
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt

SPAWN_TIMEOUT = 200
LEAF, FLOOR = 1e-5, 1e-6         # tests/test_torch_recsys_train.py's rule
N_ITEMS, B, STEPS = 2000, 64, 2
KW = dict(n_items=N_ITEMS, max_len=32, d_model=16, n_layers=2, n_heads=4,
          d_ff=32)
OPT = dict(lr=3e-3)
# name -> (arch, loss, semantic_weight)
SEQ = {"sasrec": ("sasrec", "full_ce", 0.0),
       "bert4rec": ("bert4rec", "full_ce", 0.0),
       "gru4rec": ("gru4rec", "full_ce", 0.0),
       "sasrec-semantic": ("sasrec", "full_ce", 0.5)}
CASES = [*SEQ, "dien", "fm"]


# ------------------------------------------------------------- models

def _codes():
    return np.random.default_rng(1).integers(
        0, 16, (N_ITEMS + 2, 4)).astype(np.int32)


def _seq_cfg(pkg, name):
    arch, loss, sw = SEQ[name]
    EC = J_EC if pkg is J_seq else T_EC
    kw = {} if pkg is J_seq else {"use_kernel": True}
    return pkg.SeqRecConfig(arch=arch, loss=loss, semantic_weight=sw,
                            embedding=EC(0, 0, kind="jpq", m=4, b=16, **kw),
                            **KW)


def _j_model(name):
    if name in SEQ:
        return J_seq.SeqRecModel(_seq_cfg(J_seq, name), codes=_codes())
    return J_bundle(name).make_smoke()[0]


def _t_model(name, values):
    if name in SEQ:
        tm = T_seq.SeqRecModel(_seq_cfg(T_seq, name), codes=_codes(),
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    else:
        tm = T_bundle(name).make_smoke(device="cpu", seed=1)[0]
    bridge.load_values(tm, values)
    return tm


def _tt_cfg(pkg, negatives):
    EC = J_EC if pkg is J_rs else T_EC
    return pkg.TwoTowerConfig(n_items=200, embed_dim=32, tower_mlp=(64, 32),
                              hist_len=8, embedding=EC(0, 0, kind="full"),
                              negatives=negatives)


# ------------------------------------------------------------- batches

def _seq_batches(name, jm):
    data = SyntheticSequences(SeqDataConfig(n_users=2000, n_items=N_ITEMS,
                                            seq_len=32, seed=0))
    out = []
    for s in range(STEPS):
        b = data.train_batch(s, B)
        if SEQ[name][0] == "bert4rec":
            ms, tg = J_seq.mask_batch(jax.random.PRNGKey(s),
                                      jnp.asarray(b["seq"]),
                                      jm.cfg.mask_prob, jm.cfg.mask_id)
            b = {"seq": np.array(ms), "targets": np.array(tg)}
        out.append({k: np.asarray(v) for k, v in b.items()})
    return out


def _dien_batches():
    """8 rows whose histories hold 9, 8, ..., 2, 0 and 1 items (left
    pads), so the data ranks' aux counts differ."""
    out = []
    for s in range(STEPS):
        r = np.random.default_rng(20 + s)
        hist = r.integers(1, 101, (8, 10))
        for i, n in enumerate([9, 8, 7, 6, 5, 2, 0, 1]):
            hist[i, :10 - n] = 0
        out.append({"hist": hist, "hist_neg": r.integers(1, 101, (8, 10)),
                    "target": r.integers(1, 101, (8,)),
                    "label": r.integers(0, 2, (8,))})
    return out


def _fm_batches():
    out = []
    for s in range(STEPS):
        r = np.random.default_rng(40 + s)
        out.append({"sparse": r.integers(0, 64, (8, 6)),
                    "label": r.integers(0, 2, (8,))})
    return out


def _tt_batch():
    r = np.random.default_rng(5)
    hist = r.integers(0, 201, (8, 8))
    return {"user_hist": hist, "pos_item": r.integers(1, 201, (8,)),
            "logq": (0.3 * r.standard_normal(8)).astype(np.float32)}


def _values(jm, seed=0):
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, J_nn.values(jp))


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


def _step(mesh, tm, batch):
    """(loss, metrics, {path: gradient}): this rank's rows over the whole
    batch's counts, the ranks' sums."""
    p = tm.params()
    floats = [(q, x) for q, x in _paths(p) if torch.is_floating_point(x)]
    for _, x in floats:
        x.requires_grad_(True)
    D = mesh.shape["data"]
    with T_dist.use_mesh_rules(mesh, local_batch=True):
        loss, mets = T_loop.counted_loss(tm, mesh)(
            p, _tb(_rows(batch, mesh.data_index, D)))
        grads = torch.autograd.grad(loss, [x for _, x in floats])
    keys = sorted(mets)
    summed = T_loop.sum_over_ranks(
        [loss.detach()] + [mets[k].detach() for k in keys] + list(grads),
        mesh)
    loss, rest = float(summed[0]), summed[1:]
    mets = {k: float(v) for k, v in zip(keys, rest)}
    return loss, mets, {"/".join(map(str, q)): g.numpy()
                        for (q, _), g in zip(floats, rest[len(keys):])}


def _trainer(mesh, tm, batches):
    tr = T_loop.Trainer(tm, T_opt.OptConfig(**OPT), T_loop.TrainConfig(
        steps=STEPS, batch_size=len(next(iter(batches[0].values()))),
        log_every=1, eval_every=0), data_fn=lambda s: batches[s],
        mesh=mesh)
    _, hist = tr.run(params=tm.params())
    rows = [h for h in hist if "loss" in h]
    return [h["loss"] for h in rows], [h["grad_norm"] for h in rows]


def _worker(mesh, inp_path, out_path):
    torch.set_num_threads(1)
    inp = torch.load(inp_path, weights_only=False)
    out = {}
    for name in CASES:
        values, batches = inp[name]
        out[name] = _step(mesh, _t_model(name, values), batches[0])
        out[("trainer", name)] = _trainer(mesh, _t_model(name, values),
                                          batches)
    if mesh.shape["data"] == 2:
        for neg in ("global", "local"):
            values, batch = inp["two-tower"]
            tm = T_rs.TwoTower(_tt_cfg(T_rs, neg),
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
            bridge.load_values(tm, values)
            out[("two-tower", neg)] = _step(mesh, tm, batch)
    if mesh.rank == 0:
        torch.save(out, out_path)


# ------------------------------------------------------------ fixtures

def _inputs():
    inp = {}
    for name in CASES:
        jm = _j_model(name)
        batches = (_seq_batches(name, jm) if name in SEQ else
                   _dien_batches() if name == "dien" else _fm_batches())
        inp[name] = (_values(jm), batches)
    inp["two-tower"] = (_values(J_rs.TwoTower(_tt_cfg(J_rs, "global"))),
                        _tt_batch())
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_group")
    inp = _inputs()
    path = str(root / "inputs.pt")
    torch.save(inp, path)
    out = {"inputs": inp}
    for D in (2, 4):
        res = str(root / f"{D}.pt")
        M.spawn(_worker, D, (path, res), timeout=SPAWN_TIMEOUT)
        out[D] = torch.load(res, weights_only=False)
    return out


def _j_flat(g):
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(g):
        if x.dtype == jax.dtypes.float0:
            continue
        out["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)] = np.asarray(x)
    return out


def _ref(jm, values, batch):
    """(loss, metrics, flat gradient) of the reference's step over the
    whole batch."""
    jp = jm.init_params(jax.random.PRNGKey(0))

    def loss(v):
        return jm.train_loss(J_nn.with_values(jp, v),
                             jax.tree.map(jnp.asarray, batch))
    (val, mets), g = jax.value_and_grad(loss, has_aux=True, allow_int=True)(
        jax.tree.map(jnp.asarray, values))
    return float(val), {k: float(v) for k, v in mets.items()}, _j_flat(g)


def _rule(want, got):
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(want) == set(got)
    for k in want:
        err = float(np.abs(want[k] - got[k]).max())
        assert err <= max(LEAF * float(np.abs(want[k]).max()),
                          FLOOR * top), (k, err)


def _ref_two_steps(jm, values, batches):
    jp = jm.init_params(jax.random.PRNGKey(0))
    v = jax.tree.map(jnp.asarray, values)
    st = J_opt.init_opt_state(v)
    losses, norms = [], []
    for b in batches:
        def loss(vv):
            return jm.train_loss(J_nn.with_values(jp, vv),
                                 jax.tree.map(jnp.asarray, b))[0]
        val, g = jax.value_and_grad(loss, allow_int=True)(v)
        norms.append(float(J_opt.global_norm(g)))
        v, st, _ = J_opt.apply_updates(J_opt.OptConfig(**OPT), st, v, g)
        losses.append(float(val))
    return losses, norms


# --------------------------------------------------------------- tests

def test_the_halves_hold_562_and_628_labelled_positions():
    """The skewed split: step 0 of launch/train.py's data at B =
    64 splits 562 / 628 over two data ranks."""
    b = SyntheticSequences(SeqDataConfig(n_users=2000, n_items=N_ITEMS,
                                         seq_len=32, seed=0)).train_batch(0, B)
    lab = np.asarray(b["labels"]) > 0
    assert [int(lab[:32].sum()), int(lab[32:].sum())] == [562, 628]


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_one_step_is_the_whole_batch_step(runs, name, D):
    values, batches = runs["inputs"][name]
    want_loss, want_mets, want = _ref(_j_model(name), values, batches[0])
    loss, mets, got = runs[D][name]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert set(mets) == set(want_mets)
    for k in mets:
        assert abs(mets[k] - want_mets[k]) <= 1e-5 * abs(want_mets[k]), k
    _rule(want, got)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_trainer_steps_are_the_whole_batch_steps(runs, name, D):
    values, batches = runs["inputs"][name]
    want, norms = _ref_two_steps(_j_model(name), values, batches)
    losses, gnorms = runs[D][("trainer", name)]
    assert np.allclose(losses, want, rtol=1e-5, atol=0)
    assert abs(gnorms[0] - norms[0]) <= 1e-6 * norms[0]


@pytest.mark.parametrize("negatives", ["global", "local"])
def test_two_tower_negatives(runs, monkeypatch, negatives):
    """At D = 2 the port's ``"global"`` is the reference's ``[B, B]``
    loss, its ``"local"`` the reference's ``[G, b, b]`` with G = 2; the
    two differ."""
    values, batch = runs["inputs"]["two-tower"]
    jm = J_rs.TwoTower(_tt_cfg(J_rs, negatives))
    if negatives == "local":
        monkeypatch.setattr(J_dist, "data_shard_count", lambda: 2)
    want_loss, want_mets, want = _ref(jm, values, batch)
    loss, mets, got = runs[2][("two-tower", negatives)]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert mets["in_batch_acc"] == want_mets["in_batch_acc"]
    _rule(want, got)
    other = runs[2][("two-tower",
                     "local" if negatives == "global" else "global")]
    assert abs(other[0] - loss) > 1e-3 * abs(loss)
