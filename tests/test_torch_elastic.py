"""The port's elastic exchange (``repro_torch.dist.compression``, the
Trainer's elastic path) against the reference's
(``repro.dist.compression``, ``repro.train.loop``) on one device
(``make_host_mesh(1)`` on both sides, V = 4 rounds):

  * ``_quantise`` / ``_dequantise`` bit-equal on shared numpy gradients:
    normal values at three scales, ties at k + 0.5 (rounding half to
    even), zeros, and tiny normal values (below the 1e-30 scale floor).
    Subnormal inputs are outside the contract: XLA's CPU backend
    flushes them to zero, torch keeps them;
  * one elastic step for none / bf16 / int8 on the reference's LinReg
    and on a small SASRec-RecJPQ (d = 16, 1 layer, dropout 0, the
    reference's weights carried over by ``bridge``), sgd: values and
    error state within 1e-6 of each leaf's largest entry for "none";
    for bf16 / int8 within one quantisation step of the leaf (the
    largest over the virtual shards of bf16's ulp at max|g|, or int8's
    max|g| / 127) — times lr for the values — plus that 1e-6, since a
    gradient an ulp apart may flip one rounding; adam moments for
    "none" on LinReg within 1e-6 of their largest entry;
  * ``last_schedule`` equal to the reference's for each overlap mode
    and V in {1, 2, 4};
  * the CLI: ``--devices 2`` then a resume on ``--devices 1`` equals an
    uninterrupted run on one, checkpoint for checkpoint, bit for bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingConfig as J_EC
from repro.dist import compression as J_C
from repro.launch.mesh import make_host_mesh as J_mesh
from repro.models.sequential import SeqRecConfig as J_Cfg
from repro.models.sequential import SeqRecModel as J_Model
from repro.nn import module as J_nn
from repro.nn.module import P as J_P
from repro.train import loop as J_loop
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
from repro_torch.dist import compression as T_C
from repro_torch.launch.mesh import make_host_mesh as T_mesh
from repro_torch.models.sequential import SeqRecConfig as T_Cfg
from repro_torch.models.sequential import SeqRecModel as T_Model
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
V = 4
LR = 5e-2
RNG = np.random.default_rng(0)
QCASES = {
    "small": RNG.standard_normal((257, 33)).astype(np.float32) * 1e-3,
    "unit": RNG.standard_normal((64, 16)).astype(np.float32),
    "large": RNG.standard_normal((1000,)).astype(np.float32) * 37.0,
    "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 0.0],
                     np.float32),
    "zeros": np.zeros((5, 3), np.float32),
    "tiny": np.array([2e-31, -3e-33, 5e-30, 1e-32, -7e-34], np.float32),
    "scalar": np.array(0.75, np.float32),
}


@pytest.fixture(scope="module")
def meshes():
    jm = J_mesh(1)
    tm = T_mesh(1)
    yield jm, tm
    tm.close()


# ------------------------------------------------------- quantisation

@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(QCASES))
def test_quantise_bit_equal(case, method):
    t = QCASES[case]
    jq, js, je = J_C._quantise(jnp.asarray(t), method)
    tq, ts, te = T_C._quantise(torch.tensor(t), method)
    assert str(tq.dtype).split(".")[-1] == str(jq.dtype)
    assert (np.asarray(jq.astype(jnp.float32)).tobytes()
            == tq.to(torch.float32).numpy().tobytes())
    assert np.asarray(je).tobytes() == te.numpy().tobytes()
    assert (js is None) == (ts is None)
    if js is not None:
        assert np.float32(js).tobytes() == ts.numpy().tobytes()
    if case == "ties" and method == "int8":      # half to even
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, 4, -126, 0]


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_dequantise_bit_equal(method):
    stack = np.stack([QCASES["unit"] * s for s in (1.0, 0.5, 3.0, 1e-3)])
    outs = [J_C._quantise(jnp.asarray(x), method) for x in stack]
    pays = jnp.stack([o[0] for o in outs])
    scales = (jnp.stack([o[1] for o in outs]) if method == "int8"
              else None)
    want = np.asarray(J_C._dequantise(pays, scales, method))
    tp = torch.from_numpy(np.array(pays.astype(jnp.float32))).to(
        T_C._WIRE_DTYPE[method])
    ts = (torch.from_numpy(np.array(scales)) if scales is not None
          else None)
    got = T_C._dequantise(tp, ts, method).numpy()
    assert want.tobytes() == got.tobytes()


# --------------------------------------------------------- one step
F = 32
TARGET = np.random.default_rng(1).standard_normal(F).astype(np.float32)


def _linreg_batch(s, B=64):
    r = np.random.default_rng(1000 + s)
    x = r.standard_normal((B, F)).astype(np.float32)
    y = (x @ TARGET + 0.1 * r.standard_normal(B)).astype(np.float32)
    return {"x": x, "y": y}


class J_LinReg:
    def init_params(self, rng):
        return {"w": J_P(jnp.zeros(F), (None,)),
                "b": J_P(jnp.zeros(3), (None,))}

    def train_loss(self, params, batch, rng=None):
        pred = batch["x"] @ params["w"].value + jnp.sum(params["b"].value)
        loss = jnp.mean((pred - batch["y"]) ** 2)
        return loss, {"loss": loss}


class T_LinReg:
    device = torch.device("cpu")

    def init_params(self, generator):
        return {"b": torch.zeros(3), "w": torch.zeros(F)}

    def train_loss(self, p, batch, generator=None):
        pred = batch["x"] @ p["w"] + torch.sum(p["b"])
        loss = torch.mean((pred - batch["y"]) ** 2)
        return loss, {"loss": loss}


SEQ = dict(arch="sasrec", n_items=60, max_len=10, d_model=16, n_layers=1,
           n_heads=2, d_ff=32)


def _seq_pair():
    codes = np.random.default_rng(2).integers(0, 16, (62, 4)).astype(
        np.uint8)
    jm = J_Model(J_Cfg(embedding=J_EC(0, 0, kind="jpq", m=4, b=16), **SEQ),
                 codes=codes)
    tm = T_Model(T_Cfg(embedding=T_EC(0, 0, kind="jpq", m=4, b=16,
                                      use_kernel=True), **SEQ),
                 codes=codes, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    jp = jm.init_params(jax.random.PRNGKey(0))   # the reference Trainer's
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    return jm, jp, tm


_DATA = SyntheticSequences(SeqDataConfig(n_users=64, n_items=60, seq_len=10,
                                         seed=1))


def _seq_batch(s, B=8):
    return _DATA.train_batch(s, B)


def _np_flat(tree):
    return flatten(jax.tree.map(np.asarray, tree))


STEPS = 3


def _setup(model):
    """(batch_fn, reference model, port model, port params or None,
    reference loss of (values, batch)) of a fresh pair."""
    if model == "linreg":
        jmodel = J_LinReg()

        def jloss(v, b):
            return jmodel.train_loss({k: J_P(x, (None,))
                                      for k, x in v.items()}, b)[0]
        return _linreg_batch, jmodel, T_LinReg(), None, jloss
    jmodel, jp, tmodel = _seq_pair()

    def jloss(v, b):
        return jmodel.train_loss(J_nn.with_values(jp, v), b)[0]
    return _seq_batch, jmodel, tmodel, tmodel.params(), jloss


def _train(meshes, model, method, steps):
    """Both Trainers, sgd at ``LR``, after ``steps`` elastic steps:
    (reference Trainer, its values, its history, port Trainer, its
    params, its history, reference loss, port model, batch_fn)."""
    jmesh, tmesh = meshes
    batch_fn, jmodel, tmodel, tparams, jloss = _setup(model)
    opt = dict(kind="sgd", lr=LR, clip_norm=None)
    knobs = dict(steps=steps, log_every=1, eval_every=0,
                 grad_compression=method, grad_accum_shards=V)
    jtr = J_loop.Trainer(jmodel, J_opt.OptConfig(**opt),
                         J_loop.TrainConfig(**knobs), data_fn=batch_fn,
                         mesh=jmesh)
    jparams, jhist = jtr.run()
    ttr = T_loop.Trainer(tmodel, T_opt.OptConfig(**opt),
                         T_loop.TrainConfig(**knobs), data_fn=batch_fn,
                         mesh=tmesh)
    tparams, thist = ttr.run(params=tparams)
    return (jtr, J_nn.values(jparams), jhist, ttr, tparams, thist, jloss,
            tmodel, batch_fn)


def _shard_t(jvals, jerr, jloss, tparams, terr, tmodel, batch):
    """Each side's exchanged tensor t = g + e of every virtual shard of
    ``batch`` (contiguous slices, as the exchange cuts them), from its
    values and error state before the step: ({key: [V, ...]} reference,
    the same for the port), keyed as ``flatten({"err": ...})``."""
    from repro_torch.nn.module import tree_leaves
    n = next(iter(batch.values())).shape[0] // V
    je, te = _np_flat({"err": jerr}), flatten({"err": terr})
    floats = [x for x in tree_leaves(tparams) if torch.is_floating_point(x)]
    for x in floats:
        x.requires_grad_(True)
    jgrad = jax.jit(jax.grad(jloss, allow_int=True))
    jt, tt = {}, {}
    for v in range(V):
        sl = {k: x[v * n:(v + 1) * n] for k, x in batch.items()}
        jg = _np_flat({"err": jgrad(
            jvals, {k: jnp.asarray(x) for k, x in sl.items()})})
        loss, _ = tmodel.train_loss(
            tparams, {k: torch.as_tensor(x) for k, x in sl.items()})
        got = torch.autograd.grad(loss, floats, allow_unused=True)
        by_id = {id(x): (torch.zeros_like(x) if g is None else g)
                 for x, g in zip(floats, got)}
        tg = flatten({"err": T_opt.tree_map(
            lambda x: by_id.get(id(x), x).detach(), tparams)})
        for k, w in je.items():
            if w.dtype.kind != "f" or not w[v].size:
                continue
            jt.setdefault(k, []).append(jg[k] + w[v])
            tt.setdefault(k, []).append(tg[k] + te[k][v])
    for x in floats:
        x.requires_grad_(False)
    return ({k: np.stack(x) for k, x in jt.items()},
            {k: np.stack(x) for k, x in tt.items()})


def _bf16_ulp(t):
    """bf16's spacing at |t| (0 at 0)."""
    a = np.abs(t.astype(np.float64))
    with np.errstate(divide="ignore"):
        return np.where(a > 0, 2.0 ** (np.floor(np.log2(
            np.where(a > 0, a, 1.0))) - 7), 0.0)


def _compare_err(want, got, jt, tt, method):
    """The error state after the last step, element by element.  Each
    side's err is t - dequantise(quantise(t)) of its own t (the
    gradients differ in their low bits, so the two errs do too).  Where
    both sides chose the same code, err moves with t alone: |got -
    want| <= slack = |t_port - t_ref| (+ for int8 the scales' gap
    times 127) + 1e-6 of the leaf's largest |t| (t recomputed outside
    the step).  Where the gap in t flipped a rounding, |got - want| > s
    / 2 and <= s + slack, s being one quantisation step (int8: the
    shard's max|t| / 127; bf16: its ulp at the element), and that
    only where the reference's t lay within slack of a rounding
    boundary (its err within slack of s / 2).  A zeroed err fails the
    first bound, a sign-flipped one the last.  Returns the flips."""
    flips = 0
    for k, tr in jt.items():
        tp, w, g = tt[k], want[k], got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        d = np.abs(g.astype(np.float64) - w)
        gap = np.abs(tp.astype(np.float64) - tr)
        # t recomputed outside the step: its sums may cancel, so the
        # leaf's largest |t| over the shards sets the rounding's scale
        room = 1e-6 * max(float(np.abs(tr).max()), float(np.abs(tp).max()))
        for v in range(V):
            big = max(float(np.abs(tr[v]).max()), float(np.abs(tp[v]).max()))
            slack = gap[v] + room
            if method == "int8":
                s = np.full(d[v].shape, max(big / 127.0, 1e-30))
                slack = slack + abs(float(np.abs(tp[v]).max())
                                    - float(np.abs(tr[v]).max()))
            else:
                s = np.maximum(_bf16_ulp(tr[v]), _bf16_ulp(tp[v]))
            flip = d[v] > s / 2
            assert (d[v][~flip] <= slack[~flip]).all(), (
                k, v, float((d[v] - slack)[~flip].max()))
            assert (d[v][flip] <= (s + slack)[flip]).all(), (k, v)
            # a flip needs a rounding boundary within the gap: the
            # reference's own err within slack of half a step
            edge = s / 2 - np.abs(w[v].astype(np.float64))
            assert (edge[flip] <= slack[flip]).all(), (
                k, v, int(flip.sum()), float((edge - slack)[flip].max()))
            flips += int(flip.sum())
    return flips


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
@pytest.mark.parametrize("model", ["linreg", "sasrec"])
def test_one_elastic_step_matches_reference(meshes, model, method):
    """``STEPS`` elastic steps, sgd, so that the error fed back (t = g +
    e) enters the last one.  Values: within 1e-6 of each leaf's largest
    entry, plus for bf16 / int8 lr times one quantisation step (the
    largest shard scale of the last step: error feedback keeps the sum
    of what was sent within one err of the sum of the gradients).  The
    error state: ``_compare_err`` ("none": zero on both sides)."""
    (jtr, jvals, jhist, ttr, tparams, thist, jloss, _,
     batch_fn) = _train(meshes, model, method, STEPS)
    want_err = _np_flat({"err": jtr.err_state})
    got_err = flatten({"err": ttr.err_state})
    qstep = {}
    if method == "none":
        for k, w in want_err.items():
            assert got_err[k].tobytes() == w.tobytes() and not w.any(), k
    else:
        # each side's state one step before the end, and its t there
        (pjtr, pjvals, _, pttr, ptparams, _, pjloss, ptmodel,
         _) = _train(meshes, model, method, STEPS - 1)
        jt, tt = _shard_t(pjvals, pjtr.err_state, pjloss, ptparams,
                          pttr.err_state, ptmodel, batch_fn(STEPS - 1))
        _compare_err(want_err, got_err, jt, tt, method)
        for k, t in jt.items():
            m = float(np.abs(t).max())
            qstep[k.split("/", 1)[1]] = (
                m / 127.0 if method == "int8" else
                2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0)
    want = _np_flat({"values": jvals})
    got = flatten({"values": tparams})
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind != "f" or not w.size:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        tol = 1e-6 * max(float(np.abs(w).max()), 1e-30)
        tol += qstep.get(k.split("/", 1)[1], 0.0) * LR
        assert float(np.abs(g - w).max()) <= tol, (k, float(
            np.abs(g - w).max()), tol)
    assert ttr.opt_state["step"] == STEPS
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-6)
    for key in ("payload_bytes", "exchange_fraction", "exchange_shards",
                "exchange_fsdp", "exchange_wire_bytes"):
        assert thist[0][key] == jhist[0][key], key


def test_adam_moments_match_reference(meshes):
    jmesh, tmesh = meshes
    opt = dict(kind="adamw", lr=1e-2, weight_decay=0.01)
    knobs = dict(steps=2, log_every=1, eval_every=0, grad_compression="none",
                 grad_accum_shards=V)
    jtr = J_loop.Trainer(J_LinReg(), J_opt.OptConfig(**opt),
                         J_loop.TrainConfig(**knobs), data_fn=_linreg_batch,
                         mesh=jmesh)
    jtr.run()
    ttr = T_loop.Trainer(T_LinReg(), T_opt.OptConfig(**opt),
                         T_loop.TrainConfig(**knobs), data_fn=_linreg_batch,
                         mesh=tmesh)
    ttr.run()
    # the reference keeps its optimizer state inside run(); its moments
    # follow from the same two gradients, recomputed here
    vals = {"b": jnp.zeros(3), "w": jnp.zeros(F)}
    state = J_opt.init_opt_state(vals)
    step = J_C.make_dp_grad_fn(
        lambda v, b: J_LinReg().train_loss({k: J_P(x, (None,))
                                            for k, x in v.items()}, b)[0],
        jmesh, "none", accum_shards=V)
    err = J_C.zeros_error_state(vals, V)
    for s in range(2):
        g, err, _ = step(vals, err, {k: jnp.asarray(x) for k, x in
                                     _linreg_batch(s).items()})
        vals, state, _ = J_opt.apply_updates(J_opt.OptConfig(**opt), state,
                                             vals, g)
    for slot in ("m", "v"):
        for k in ("b", "w"):
            w = np.asarray(state[slot][k])
            g = ttr.opt_state[slot][k].numpy()
            assert float(np.abs(g - w).max()) <= 1e-6 * float(
                np.abs(w).max()), (slot, k)
    assert ttr.opt_state["step"] == int(state["step"]) == 2


@pytest.mark.parametrize("overlap", ["none", "dispatch", "backward"])
def test_schedules_equal_reference(meshes, overlap):
    jmesh, tmesh = meshes

    def jloss(v, b):
        return jnp.mean((b["x"] @ v["w"] - b["y"]) ** 2)

    def tloss(v, b):
        return torch.mean((b["x"] @ v["w"] - b["y"]) ** 2)

    batch = _linreg_batch(0, B=8)
    for accum in (1, 2, 4):
        js = J_C.make_dp_grad_fn(jloss, jmesh, "int8", accum_shards=accum,
                                 overlap=overlap)
        ts = T_C.make_dp_grad_fn(tloss, tmesh, "int8", accum_shards=accum,
                                 overlap=overlap)
        jv = {"w": jnp.ones(F)}
        tv = {"w": torch.ones(F)}
        js(jv, J_C.zeros_error_state(jv, accum),
           {k: jnp.asarray(x) for k, x in batch.items()})
        ts(tv, T_C.zeros_error_state(tv, accum),
           {k: torch.as_tensor(x) for k, x in batch.items()})
        assert ts.last_schedule == js.last_schedule, (accum, overlap)
        assert ts.rounds == js.rounds and ts.n_shards == js.n_shards


# ------------------------------------------------------------- the CLI

def test_cli_two_processes_then_resume_on_one(tmp_path):
    """``--devices 2`` for 3 steps, resumed with ``--devices 1`` to 6:
    every array of the last checkpoint bit-equal to one uninterrupted
    run on one process, and stamped with the spec."""
    import json
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--n-items", "300", "--d-model", "16", "--batch-size",
            "8", "--eval-every", "0", "--ckpt-every", "0",
            "--grad-compression", "int8", "--grad-accum-shards", "4",
            "--fsdp", "--overlap", "backward"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for argv in (["--devices", "2", "--steps", "3", "--ckpt-dir", a],
                 ["--mesh", "1", "--steps", "6", "--ckpt-dir", a],
                 ["--steps", "6", "--ckpt-dir", b]):
        r = subprocess.run(base + argv, env=env, capture_output=True,
                           text=True, timeout=240)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "done at step" in r.stdout
    with np.load(os.path.join(a, "step_0000000006", "arrays.npz")) as za, \
            np.load(os.path.join(b, "step_0000000006", "arrays.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert any(k.startswith("err/") for k in za.files)
        for k in za.files:
            assert za[k].tobytes() == zb[k].tobytes(), k
    with open(os.path.join(a, "step_0000000006", "manifest.json")) as f:
        stamp = json.load(f)["metadata"]["train_spec"]
    assert stamp["compression"] == "int8" and stamp["fsdp"] is True
    assert stamp["resolved_accum_shards"] == 4
