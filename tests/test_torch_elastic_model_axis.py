"""The elastic exchange on a ``(D, S)`` mesh, on spawned gloo CPU
processes (``repro_torch.launch.mesh.spawn``), with
``torch.set_num_threads(1)`` in every process.

The reference's elastic step runs under ``shard_map`` with every mesh
axis manual, the values replicated and the batch rows split over the
data axes only, so on ``(D, S)`` it is its ``(D, 1)`` step computed S
times.  The port replicates the model over ``"model"`` the same way, and
its exchange runs over the ``"data"`` group.  Held, at V = 4:

  * SASRec (dropout 0.1, so the virtual shards' generators are
    exercised), GRU4Rec, ``two-tower-retrieval-jpq`` and FM, each for
    none / bf16 / int8 x fsdp off / on x the three overlap modes, at
    ``(1, 2)``, ``(2, 2)`` and ``(1, 4)``: after 3 steps every rank's
    parameters, Adam moments and error state are bit-equal to the same
    run at ``(1, 1)`` and at ``(2, 1)`` (so each model rank's to its
    column's);
  * an int8 run SIGTERM'd at step 2 on ``(2, 2)`` (one rank signalled;
    every rank stops at step 3 and rank 0 saves) resumes on ``(1, 2)``
    and on ``(4, 1)`` bit-equal to 6 uninterrupted steps at ``(1, 1)``,
    fsdp off and on;
  * ``launch/train.py --model-axis 2`` with the elastic flags trains;
  * a V that D does not divide raises the reference's error.

The reference's own elastic run cannot anchor this on jax 0.9.0 (it
fails in its first step with a ``ShardingTypeError`` on any mesh, see
ROADMAP.md), so the anchor is the port's ``(1, 1)`` and ``(D, 1)`` step,
which tests/test_torch_elastic.py and test_torch_elastic_world.py hold
against the reference's arithmetic and across world sizes.
"""
import json
import os
import signal
import types

import numpy as np
import pytest
import torch

from repro.dist import compression as J_C
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.configs import get_bundle
from repro_torch.core import EmbeddingConfig
from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
from repro_torch.dist import compression as C
from repro_torch.launch import mesh as M
from repro_torch.launch import train as T_cli
from repro_torch.launch.serve import make_requests
from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.optimizer import OptConfig

ARCHS = ("sasrec", "gru4rec", "two-tower-retrieval-jpq", "fm")
METHODS = ("none", "bf16", "int8")
OVERLAPS = ("none", "dispatch", "backward")
GRID = [(m, f, o) for m in METHODS for f in (0, 1) for o in OVERLAPS]
MESHES = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
          "1x4": (1, 4)}
V = 4
ROWS = 16                      # the CTR batches' rows: 4 a virtual shard
SPAWN_TIMEOUT = 300


# ------------------------------------------------------------- models

def _seq_model(arch):
    cfg = SeqRecConfig(arch=arch, n_items=60, max_len=10, d_model=16,
                       n_layers=1, n_heads=2, d_ff=32, dropout=0.1,
                       embedding=EmbeddingConfig(0, 0, kind="jpq", m=4,
                                                 b=16, use_kernel=True))
    codes = np.random.default_rng(0).integers(0, 16, (62, 4)).astype(
        np.uint8)
    return SeqRecModel(cfg, codes=codes, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _model_and_data(arch):
    """(a fresh model, ``data_fn(step)``), the same on every rank."""
    if arch in ("sasrec", "gru4rec"):
        data = SyntheticSequences(SeqDataConfig(n_users=64, n_items=60,
                                                seq_len=10, seed=1))
        return _seq_model(arch), lambda s: data.train_batch(s, 8)
    model, template = get_bundle(arch).make_smoke(device="cpu", seed=0)
    # the template's rows redrawn, 16 a step (a virtual shard of the
    # smoke batch's 4 or 8 rows would hold one or two)
    return model, lambda s: next(make_requests(template, ROWS, 1, 100 + s))


def _run(mesh, arch, *, method, fsdp=False, overlap="dispatch", steps=3,
         ckpt_dir=None, sigterm=None):
    """``arch`` trained on ``mesh``; returns (trainer, state): the flat
    ``/``-keyed numpy tree of the final values, Adam moments and error
    state, and the loss rows.  ``sigterm=(rank, step)`` sends SIGTERM to
    that rank while it reads that step's batch."""
    model, batch_of = _model_and_data(arch)

    def data_fn(s):
        if sigterm is not None and (mesh.rank, s) == sigterm:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch_of(s)

    tr = Trainer(model, OptConfig(lr=1e-2),
                 TrainConfig(steps=steps, batch_size=8, log_every=1,
                             eval_every=0, ckpt_dir=ckpt_dir, ckpt_every=0,
                             grad_compression=method, grad_accum_shards=V,
                             fsdp=bool(fsdp), overlap=overlap),
                 data_fn=data_fn, mesh=mesh)
    params, hist = tr.run(params=model.params())
    state = flatten({"values": params,
                     "opt": {"m": tr.opt_state["m"], "v": tr.opt_state["v"]},
                     "err": tr.err_state})
    state["loss"] = np.array([h["loss"] for h in hist if "loss" in h])
    return tr, state


def _name(shape, rank, arch, method, fsdp, overlap):
    return f"{shape}-r{rank}-{arch}-{method}-{fsdp}-{overlap}"


def _save(out, name, state):
    np.savez(os.path.join(out, name + ".npz"), **state)


def _load(out, name):
    with np.load(os.path.join(out, name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def _bit_equal(a, b):
    """The keys whose arrays differ (dtype or bits)."""
    assert a.keys() == b.keys()
    return [k for k in a if a[k].dtype != b[k].dtype
            or a[k].tobytes() != b[k].tobytes()]


def _shape_of(mesh):
    return f"{mesh.shape['data']}x{mesh.shape['model']}"


# ---------------------------------------------------------- the workers
# (module-level, so spawned processes import them by name)

def _grid_worker(mesh, out):
    """Every (arch, method, fsdp, overlap) of the grid, 3 steps; each rank
    saves its own whole state."""
    torch.set_num_threads(1)
    shape = _shape_of(mesh)
    for arch in ARCHS:
        for method, fsdp, overlap in GRID:
            tr, state = _run(mesh, arch, method=method, fsdp=fsdp,
                             overlap=overlap)
            assert not tr._split and tr._specs is None    # whole leaves
            _save(out, _name(shape, mesh.rank, arch, method, fsdp, overlap),
                  state)


def _full_worker(mesh, out):
    """(1, 1): the uninterrupted 6-step int8 SASRec runs."""
    torch.set_num_threads(1)
    for fsdp in (0, 1):
        _, state = _run(mesh, "sasrec", method="int8", fsdp=fsdp, steps=6)
        _save(out, f"full-{fsdp}", state)


def _preempt_worker(mesh, out):
    """(2, 2): int8 SASRec SIGTERM'd on rank 3 at step 2 (saved at step
    3), then copies of the checkpoint for each resume."""
    import shutil
    torch.set_num_threads(1)
    for fsdp in (0, 1):
        d = os.path.join(out, f"ck-{fsdp}")
        tr, _ = _run(mesh, "sasrec", method="int8", fsdp=fsdp, steps=6,
                     ckpt_dir=d, sigterm=(3, 2))
        assert tr._preempted and tr.done_step == 3, (tr._preempted,
                                                     tr.done_step)
        mesh.all_reduce(torch.zeros(1), ("data", "model"))   # saved
        if mesh.rank == 0:
            for to in ("1x2", "4x1"):
                shutil.copytree(d, f"{d}-{to}")


def _resume_worker(mesh, out):
    """Resume both checkpoints on this mesh to step 6; every rank saves
    its state."""
    torch.set_num_threads(1)
    shape = _shape_of(mesh)
    for fsdp in (0, 1):
        tr, state = _run(mesh, "sasrec", method="int8", fsdp=fsdp, steps=6,
                         ckpt_dir=os.path.join(out, f"ck-{fsdp}-{shape}"))
        assert not tr._preempted and tr.done_step == 6
        state["first_step"] = np.array(tr.history[0]["step"])
        _save(out, f"resumed-{shape}-r{mesh.rank}-{fsdp}", state)


def _collectives_worker(mesh, out):
    """``HostMesh``'s byte collectives over each axis of a (2, 2) mesh,
    one issued with a handle, and ``broadcast`` of a dict over the world
    and of a tensor over each axis."""
    torch.set_num_threads(1)
    d, m = mesh.data_index, mesh.model_index
    buf = torch.full((3,), 10 * d + m, dtype=torch.uint8)
    res = {}
    res["gather_data"], work = mesh.all_gather_bytes(buf, "data",
                                                     async_op=True)
    work.wait()
    work.wait()                                   # a second wait: nothing
    res["gather_model"], _ = mesh.all_gather_bytes(buf, "model")
    res["a2a"], _ = mesh.all_to_all_bytes(
        torch.arange(4, dtype=torch.uint8).reshape(2, 2) + 100 * d, "data")
    res["world"] = mesh.broadcast(
        {"a": torch.arange(3) + 7, "b": torch.ones(2, 2, dtype=torch.bool),
         "e": torch.zeros(0, 4)} if mesh.rank == 0 else None, 0)
    res["model"] = mesh.broadcast(torch.tensor([float(mesh.rank)]), 1,
                                  axis="model")
    res["data"] = mesh.broadcast(torch.tensor([mesh.rank]), 1, axis="data")
    res["comm"] = dict(mesh.comm)
    torch.save(res, os.path.join(out, f"c{mesh.rank}.pt"))


# ---------------------------------------------------------------- tests

def test_host_mesh_byte_collectives_and_broadcast_on_2x2(tmp_path):
    out = str(tmp_path)
    M.spawn(_collectives_worker, 4, (out,), model=2, timeout=SPAWN_TIMEOUT)
    for rank in range(4):
        d, m = divmod(rank, 2)
        r = torch.load(os.path.join(out, f"c{rank}.pt"))
        assert r["gather_data"].tolist() == [[m] * 3, [10 + m] * 3]
        assert r["gather_model"].tolist() == [[10 * d] * 3,
                                              [10 * d + 1] * 3]
        assert r["a2a"].tolist() == [[2 * d, 2 * d + 1],
                                     [100 + 2 * d, 101 + 2 * d]]
        w = r["world"]
        assert w["a"].tolist() == [7, 8, 9] and w["a"].dtype == torch.int64
        assert w["b"].dtype == torch.bool and bool(w["b"].all())
        assert tuple(w["e"].shape) == (0, 4)
        assert r["model"].tolist() == [float(2 * d + 1)]
        assert r["data"].tolist() == [2 + m]
        # the gathers, the all-to-all, the dict's two (its sizes, then
        # its header and payload) and one a tensor
        head = json.dumps([["a", "int64", [3]], ["b", "bool", [2, 2]],
                           ["e", "float32", [0, 4]]])
        assert r["comm"]["calls"] == 7
        assert r["comm"]["bytes"] == 6 + 6 + 4 + 16 + len(head) + 24 + 4 \
            + 4 + 8



@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("grid"))
    for shape, (D, S) in MESHES.items():
        M.spawn(_grid_worker, D * S, (out,), model=S, timeout=SPAWN_TIMEOUT)
    return out


@pytest.mark.parametrize("shape", ["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bitwise_to_one_rank_and_the_data_axis(grid, arch, shape):
    """Every rank of ``shape`` ends each grid run with the values,
    moments and error state of the (1, 1) run and of the (2, 1) run,
    bit for bit."""
    D, S = MESHES[shape]
    for method, fsdp, overlap in GRID:
        want = _load(grid, _name("1x1", 0, arch, method, fsdp, overlap))
        assert np.isfinite(want["loss"]).all() and len(want["loss"]) == 3
        for rank in (0, 1):
            got = _load(grid, _name("2x1", rank, arch, method, fsdp,
                                    overlap))
            assert not _bit_equal(want, got), ("2x1", rank, method, fsdp,
                                               overlap)
        for rank in range(D * S):
            got = _load(grid, _name(shape, rank, arch, method, fsdp,
                                    overlap))
            assert not _bit_equal(want, got), (rank, method, fsdp, overlap)


@pytest.mark.parametrize("arch", ARCHS)
def test_error_feedback_carries_the_residual(grid, arch):
    """The exact method carries no residual and the compressed ones one
    (finite), so the runs above compare a live error state."""
    for method in METHODS:
        st = _load(grid, _name("1x4", 3, arch, method, 1, "backward"))
        err = [v for k, v in st.items() if k.startswith("err/")]
        if method == "none":
            assert all(not e.any() for e in err)
        else:
            assert any(e.any() for e in err)
            assert all(np.isfinite(e).all() for e in err)


def test_sigterm_on_2x2_resumes_on_1x2_and_4x1_bitwise(tmp_path):
    """int8 SASRec: SIGTERM at step 2 on (2, 2), resumed on (1, 2) and on
    (4, 1), equals 6 uninterrupted steps at (1, 1) on every rank, values,
    moments and err bit for bit, fsdp off and on."""
    out = str(tmp_path)
    M.spawn(_full_worker, 1, (out,), timeout=SPAWN_TIMEOUT)
    M.spawn(_preempt_worker, 4, (out,), model=2, timeout=SPAWN_TIMEOUT)
    M.spawn(_resume_worker, 2, (out,), model=2, timeout=SPAWN_TIMEOUT)
    M.spawn(_resume_worker, 4, (out,), model=1, timeout=SPAWN_TIMEOUT)
    for fsdp in (0, 1):
        full = _load(out, f"full-{fsdp}")
        want_loss = full.pop("loss")[3:]
        for shape, n in (("1x2", 2), ("4x1", 4)):
            for rank in range(n):
                got = _load(out, f"resumed-{shape}-r{rank}-{fsdp}")
                assert int(got.pop("first_step")) == 3     # resumed
                assert got.pop("loss").tobytes() == want_loss.tobytes()
                assert not _bit_equal(full, got), (shape, rank, fsdp)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_accum_shards_not_divisible_by_d_raises_the_references_error(shape):
    """V = 3 on a data axis of 2 or 4 raises, word for word the
    reference's error (its mesh's model axis changes nothing)."""
    D, S = shape
    want_mesh = types.SimpleNamespace(shape={"data": D, "model": S})
    with pytest.raises(ValueError) as want:
        J_C.make_elastic_dp_step(lambda v, b: 0.0, want_mesh, "int8",
                                 accum_shards=3)
    mesh = M.make_host_mesh(D * S, model=S, group=False)
    with pytest.raises(ValueError) as got:
        C.make_elastic_dp_step(lambda v, b: 0.0, mesh, "int8",
                               accum_shards=3)
    assert str(got.value) == str(want.value)
    model, data_fn = _model_and_data("fm")
    with pytest.raises(ValueError) as got:
        Trainer(model, OptConfig(), TrainConfig(grad_accum_shards=3,
                                                grad_compression="int8"),
                data_fn=data_fn, mesh=mesh).run(params=model.params())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [
    ["--arch", "fm", "--grad-compression", "int8", "--fsdp"],
    ["--arch", "gru4rec", "--grad-compression", "bf16",
     "--overlap", "backward"]])
def test_cli_model_axis_with_the_elastic_flags_trains(flags, capfd):
    """``launch/train.py --model-axis 2 --grad-accum-shards 4`` with the
    elastic flags trains on two gloo ranks; rank 0's losses are the
    single-process run's (the (1, 1) mesh) at the same V."""
    base = ["--device", "cpu", "--steps", "2", "--n-items", "50",
            "--batch-size", "8", "--eval-every", "0",
            "--grad-accum-shards", "4", *flags]
    assert T_cli.main(base + ["--model-axis", "2"]) is None
    out = capfd.readouterr().out
    assert "mesh: {'data': 1, 'model': 2} (gloo, 2 processes)" in out
    assert "done at step 2 on cpu, mesh {'data': 1, 'model': 2}" in out
    hist = T_cli.main(base)
    one = capfd.readouterr().out
    loss = [f"'loss': {h['loss']!r}" for h in hist if "loss" in h]
    assert loss and all(x in out for x in loss), (loss, out)
    assert "done at step 2" in one
