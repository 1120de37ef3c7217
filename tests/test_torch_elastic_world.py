"""The port's elastic exchange against itself across world sizes, on
spawned gloo CPU processes (``repro_torch.launch.mesh.spawn``), with
``torch.set_num_threads(1)`` in every process.

  * D in {1, 2, 4}, V = 4: after 3 steps of a small SASRec-RecJPQ
    (dropout 0.1, so the per-shard generators are exercised), the
    parameters, Adam moments and error state are bit-equal across world
    sizes for each of none / bf16 / int8 x fsdp off / on x the three
    overlap modes; one exchange with FSDP against DP within rtol = atol
    = 2e-6 with the error state bit-equal, on each world size (the
    reference's tests/test_fsdp_exchange.py);
  * an int8 run of 6 steps on 4 processes equals a run SIGTERM'd at step
    3 on 4 (one rank signalled; every rank stops at the same step) and
    resumed on 2, bit for bit, fsdp off and on; resuming under another
    accum_shards or fsdp raises check_restore_layout's error;
  * plain data parallelism (no elastic spec) on 2 processes against one
    device within tolerance (the reference's
    tests/test_dist.py::test_mesh_training_matches_single_device);
  * accum_shards not divisible by D raises;
  * the counterpart of tests/test_elastic_train.py::TestCompressedParity:
    bf16 and int8 within 2% of fp32 over 240 LinReg steps at V = 8.

Every spawn carries a timeout of its own (``spawn(timeout=)``).
"""
import functools
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import flatten
from repro_torch.core import EmbeddingConfig
from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
from repro_torch.dist import compression as C
from repro_torch.launch import mesh as M
from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
from repro_torch.train.loop import TrainConfig, Trainer, step_generator
from repro_torch.train.optimizer import OptConfig

METHODS = ("none", "bf16", "int8")
OVERLAPS = ("none", "dispatch", "backward")
V = 4
SPAWN_TIMEOUT = 120


def _sasrec(seed=0):
    cfg = SeqRecConfig(arch="sasrec", n_items=60, max_len=10, d_model=16,
                       n_layers=1, n_heads=2, d_ff=32, dropout=0.1,
                       embedding=EmbeddingConfig(0, 0, kind="jpq", m=4, b=16,
                                                 use_kernel=True))
    codes = np.random.default_rng(seed).integers(0, 16, (62, 4)).astype(
        np.uint8)
    return SeqRecModel(cfg, codes=codes, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _seq_data():
    return SyntheticSequences(SeqDataConfig(n_users=64, n_items=60,
                                            seq_len=10, seed=1))


def _run(mesh, *, method, fsdp=False, overlap="dispatch", steps=3,
         ckpt_dir=None, accum=V, sigterm=None):
    """A fresh SASRec trained on ``mesh``; returns (trainer, state)
    where state is the flat ``/``-keyed numpy tree of the final values,
    optimizer moments and error state.  ``sigterm=(rank, step)`` sends
    SIGTERM to that rank while it reads that step's batch."""
    data = _seq_data()

    def data_fn(s):
        if sigterm is not None and (mesh.rank, s) == sigterm:
            os.kill(os.getpid(), signal.SIGTERM)
        return data.train_batch(s, 8)

    model = _sasrec()
    tr = Trainer(model, OptConfig(lr=1e-2),
                 TrainConfig(steps=steps, log_every=1, eval_every=0,
                             ckpt_dir=ckpt_dir, ckpt_every=0,
                             grad_compression=method, grad_accum_shards=accum,
                             fsdp=fsdp, overlap=overlap),
                 data_fn=data_fn, mesh=mesh)
    params, hist = tr.run(params=model.params())
    state = flatten({"values": params,
                     "opt": {"m": tr.opt_state["m"], "v": tr.opt_state["v"]},
                     "err": tr.err_state})
    state["loss"] = np.array([h["loss"] for h in hist if "loss" in h])
    return tr, state


def _save(mesh, out, name, state):
    if mesh.rank == 0:
        np.savez(os.path.join(out, name + ".npz"), **state)


def _load(out, name):
    with np.load(os.path.join(out, name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def _bit_equal(a, b):
    assert a.keys() == b.keys()
    bad = [k for k in a if a[k].dtype != b[k].dtype
           or a[k].tobytes() != b[k].tobytes()]
    return bad


# ---------------------------------------------------------- the workers
# (module-level, so spawned processes import them by name)

def _one_exchange(mesh, method, fsdp):
    """One grads-only exchange on step 0's batch: (gathered grads and
    err, flat), as the reference's tests/test_fsdp_exchange.py runs it."""
    model = _sasrec()
    p = model.params()
    batch = {k: torch.as_tensor(v)
             for k, v in _seq_data().train_batch(0, 8).items()}
    step = C.make_elastic_dp_step(
        lambda v, b, g: model.train_loss(v, b, g), mesh, method,
        accum_shards=V, has_aux=True, with_rng=True, fsdp=fsdp, shapes=p)
    err = C.shard_rows(C.zeros_error_state(p, V), mesh, V)
    g, e, loss, _ = step(step.shard(p) if fsdp else p, err, batch,
                         functools.partial(step_generator, 0, 0, "cpu"))
    out = flatten({"grads": step.gather(g) if fsdp else g,
                   "err": C.gather_rows(e, mesh)})
    out["loss"] = loss.numpy()
    return out


def _grid_worker(mesh, out):
    torch.set_num_threads(1)
    for method in METHODS:
        for fsdp in (False, True):
            _save(mesh, out, f"G-D{mesh.world_size}-{method}-{int(fsdp)}",
                  _one_exchange(mesh, method, fsdp))
        for fsdp in (False, True):
            for overlap in OVERLAPS:
                _, state = _run(mesh, method=method, fsdp=fsdp,
                                overlap=overlap)
                _save(mesh, out, f"D{mesh.world_size}-{method}-{int(fsdp)}-"
                      f"{overlap}", state)


def _preempt_worker(mesh, out):
    """World 4: the uninterrupted 6-step int8 run, and one SIGTERM'd on
    rank 1 at step 2 (so it saves at step 3), fsdp off and on."""
    torch.set_num_threads(1)
    for fsdp in (False, True):
        _, state = _run(mesh, method="int8", fsdp=fsdp, steps=6)
        _save(mesh, out, f"full-{int(fsdp)}", state)
        tr, _ = _run(mesh, method="int8", fsdp=fsdp, steps=6,
                     ckpt_dir=os.path.join(out, f"ck-{int(fsdp)}"),
                     sigterm=(1, 2))
        assert tr._preempted and tr.done_step == 3, (tr._preempted,
                                                     tr.done_step)


def _resume_worker(mesh, out):
    """World 2: the resumes of the SIGTERM'd runs; resumes under another
    layout (they must raise); and plain data parallelism on LinReg."""
    torch.set_num_threads(1)
    for fsdp in (False, True):
        d = os.path.join(out, f"ck-{int(fsdp)}")
        errors = []
        for kw in (dict(accum=2, fsdp=fsdp), dict(fsdp=not fsdp)):
            try:
                _run(mesh, method="int8", steps=6, ckpt_dir=d, **kw)
                errors.append("")
            except ValueError as e:
                errors.append(str(e))
        tr, state = _run(mesh, method="int8", fsdp=fsdp, steps=6,
                         ckpt_dir=d)
        assert not tr._preempted and tr.done_step == 6
        state["first_step"] = np.array(tr.history[0]["step"])
        _save(mesh, out, f"resumed-{int(fsdp)}", state)
        if mesh.rank == 0:
            with open(os.path.join(out, f"layout-{int(fsdp)}.txt"), "w") as f:
                f.write("\n".join(errors))
    params, hist = _linreg_run(mesh, steps=4, kind="sgd")
    _save(mesh, out, "dp-linreg",
          {"w": params["w"].numpy(),
           "loss": np.array([h["loss"] for h in hist])})


# -------------------------------------------------------------- LinReg
F = 32
TARGET = np.random.default_rng(0).standard_normal(F).astype(np.float32)


class LinReg:
    device = torch.device("cpu")

    def init_params(self, generator):
        return {"w": torch.zeros(F)}

    def train_loss(self, p, batch, generator=None):
        pred = batch["x"] @ p["w"]
        loss = torch.mean((pred - batch["y"]) ** 2)
        return loss, {"loss": loss}


def _linreg_data(s):
    r = np.random.default_rng(1000 + s)
    x = r.standard_normal((64, F)).astype(np.float32)
    y = (x @ TARGET + 0.1 * r.standard_normal(64)).astype(np.float32)
    return {"x": x, "y": y}


def _linreg_run(mesh, *, steps, kind="sgd", **knobs):
    tr = Trainer(LinReg(), OptConfig(kind=kind, lr=5e-2, clip_norm=None),
                 TrainConfig(steps=steps, batch_size=64, log_every=1,
                             eval_every=0, **knobs),
                 data_fn=_linreg_data, mesh=mesh)
    params, hist = tr.run()
    return params, [h for h in hist if "loss" in h]


# ---------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("grid"))
    for D in (1, 2, 4):
        M.spawn(_grid_worker, D, (out,), timeout=SPAWN_TIMEOUT)
    return out


@pytest.mark.parametrize("method", METHODS)
def test_bitwise_across_world_sizes(grid, method):
    """Values, moments and err bit-equal on 1, 2 and 4 processes, in
    every overlap mode and with fsdp off and on."""
    want = _load(grid, f"D1-{method}-0-none")
    assert np.isfinite(want["loss"]).all() and len(want["loss"]) == 3
    for D in (1, 2, 4):
        for fsdp in (0, 1):
            for overlap in OVERLAPS:
                got = _load(grid, f"D{D}-{method}-{fsdp}-{overlap}")
                if fsdp:
                    want_f = _load(grid, f"D1-{method}-1-none")
                    assert not _bit_equal(want_f, got), (D, overlap)
                else:
                    assert not _bit_equal(want, got), (D, overlap)
    err = [v for k, v in want.items() if k.startswith("err/")]
    if method == "none":
        assert all(not e.any() for e in err)
    else:
        assert any(e.any() for e in err) and all(np.isfinite(e).all()
                                                 for e in err)


@pytest.mark.parametrize("method", METHODS)
def test_fsdp_matches_dp(grid, method):
    """One exchange, as the reference's own test: fsdp's gradients within
    rtol = atol = 2e-6 of dp's (the chain against the [V, ...] mean),
    the error state bit-equal (made before the combine), on 1, 2 and 4
    processes; and fsdp's gradients bit-equal across world sizes."""
    want_f = _load(grid, f"G-D1-{method}-1")
    for D in (1, 2, 4):
        dp = _load(grid, f"G-D{D}-{method}-0")
        fs = _load(grid, f"G-D{D}-{method}-1")
        assert not _bit_equal(want_f, fs), D
        for k in dp:
            if k.startswith("err/") or dp[k].dtype.kind != "f":
                assert dp[k].tobytes() == fs[k].tobytes(), k
            else:
                np.testing.assert_allclose(fs[k], dp[k], rtol=2e-6,
                                           atol=2e-6, err_msg=k)


def test_sigterm_on_four_resume_on_two_is_bitwise(tmp_path):
    """int8: 6 steps on 4 processes == SIGTERM at step 3 on 4 + resume
    on 2, values, moments and err bit for bit; a resume under another
    accum_shards or fsdp raises the layout error; and plain data
    parallelism on 2 processes matches one device within tolerance."""
    out = str(tmp_path)
    M.spawn(_preempt_worker, 4, (out,), timeout=SPAWN_TIMEOUT)
    M.spawn(_resume_worker, 2, (out,), timeout=SPAWN_TIMEOUT)
    for fsdp in (0, 1):
        full = _load(out, f"full-{fsdp}")
        got = _load(out, f"resumed-{fsdp}")
        assert int(got.pop("first_step")) == 3       # resumed, not restarted
        # the loss rows: the resumed run logged steps 3-5 only
        assert full.pop("loss")[3:].tobytes() == got.pop("loss").tobytes()
        assert not _bit_equal(full, got), fsdp
        with open(os.path.join(out, f"layout-{fsdp}.txt")) as f:
            accum_err, fsdp_err = f.read().split("\n")
        assert "resolved_accum_shards: checkpoint=4 run=2" in accum_err
        assert "checkpoint layout does not match" in fsdp_err
        assert f"fsdp: checkpoint={bool(fsdp)!r}" in fsdp_err
    dp = _load(out, "dp-linreg")
    params, hist = _linreg_run(None, steps=4)
    np.testing.assert_allclose(dp["loss"], [h["loss"] for h in hist],
                               rtol=1e-5)
    np.testing.assert_allclose(dp["w"], params["w"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_accum_shards_must_divide_over_the_world():
    mesh = M.make_host_mesh(4, group=False)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        C.make_elastic_dp_step(lambda v, b: 0.0, M.HostMesh(3), "int8",
                               accum_shards=4)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        Trainer(LinReg(), OptConfig(), TrainConfig(grad_accum_shards=6),
                data_fn=None, mesh=mesh).run()


def test_compressed_within_2pct_of_fp32_over_240_steps():
    """Error feedback recovers the quantisation bias: bf16 and int8 end
    within 2% of fp32's loss (the noise floor) over 240 steps at V = 8;
    the exact method carries no residual, the others one."""
    torch.set_num_threads(1)
    mesh = M.make_host_mesh(1)
    try:
        finals, errs = {}, {}
        for method in METHODS:
            tr = Trainer(LinReg(), OptConfig(kind="sgd", lr=5e-2,
                                             clip_norm=None),
                         TrainConfig(steps=240, batch_size=64, log_every=1,
                                     eval_every=0, grad_compression=method,
                                     grad_accum_shards=8),
                         data_fn=_linreg_data, mesh=mesh)
            _, hist = tr.run()
            finals[method] = float(np.mean([h["loss"] for h in hist
                                            if "loss" in h][-20:]))
            errs[method] = float(tr.err_state["w"].abs().max())
    finally:
        mesh.close()
    assert abs(finals["bf16"] - finals["none"]) <= 0.02 * finals["none"]
    assert abs(finals["int8"] - finals["none"]) <= 0.02 * finals["none"]
    assert errs["none"] == 0.0 and errs["int8"] > 0.0 and errs["bf16"] > 0.0
