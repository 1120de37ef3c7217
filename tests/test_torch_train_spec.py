"""The training engine's policy layer, the port (``repro_torch.train.spec``)
held against the reference (``repro.train.spec``) on the same inputs:
counterparts of tests/test_train_spec.py's 41 tests — TrainSpec
validation (the same exception class and message for each bad spec),
the ``spec_for`` shims (hash-equal legacy spellings), the CLI flag
cluster, the step-builder registry (the same order), the checkpoint
layout stamp (equal stamp dicts, the same errors), the history schema —
plus the layout facade: ``payload_bytes`` / ``payload_metrics`` equal
integer for integer and the same ``fsdp_leaf_sharded`` /
``state_shardings`` classification for every leaf, on SASRec-RecJPQ and
a full-table two-tower model.
"""
import argparse
import ast
import dataclasses
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.dist import compression as J_C
from repro.train import metrics as J_met
from repro.train import spec as J
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.dist import compression as T_C
from repro_torch.launch.mesh import HostMesh
from repro_torch.train import metrics as T_met
from repro_torch.train import spec as T

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


def _outcome(fn):
    """(result, exception class name, message) of ``fn()``."""
    try:
        return fn(), None, None
    except Exception as e:                  # noqa: BLE001 - compared
        return None, type(e).__name__, str(e)


def _same(fn_j, fn_t):
    """Run the same construction through both packages: equal results
    (spec values compared as dicts) or the same error and message."""
    rj, ej, mj = _outcome(fn_j)
    rt, et, mt = _outcome(fn_t)
    assert (ej, mj) == (et, mt)
    if ej is None:
        if dataclasses.is_dataclass(rj):
            assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
        else:
            assert rj == rt
    return rt, et


# ------------------------------------------------------- spec validation
BAD_SPECS = [
    dict(compression="fp4", elastic=True),
    dict(overlap="speculative", elastic=True),
    dict(overlap=True, elastic=True),         # bools: spec_for only
    dict(rng="counter"),
    dict(compression="bf16"), dict(accum_shards=8), dict(fsdp=True),
    dict(overlap="backward"),
    dict(elastic=True, microbatches=4),
    dict(microbatches=0), dict(accum_shards=0, elastic=True),
]


class TestSpecValidation:
    def test_defaults_are_the_plain_step(self):
        s, _ = _same(J.TrainSpec, T.TrainSpec)
        assert (s.compression, s.elastic, s.microbatches) \
            == ("none", False, 1)

    @pytest.mark.parametrize("kw", BAD_SPECS,
                             ids=[str(i) for i in range(len(BAD_SPECS))])
    def test_bad_spec_raises_as_the_reference(self, kw):
        _, err = _same(lambda: J.TrainSpec(**kw), lambda: T.TrainSpec(**kw))
        assert err == "ValueError"

    def test_microbatches_coerced(self):
        s, _ = _same(lambda: J.TrainSpec(microbatches="3"),
                     lambda: T.TrainSpec(microbatches="3"))
        assert s.microbatches == 3

    def test_hashable_and_cache_key_semantics(self):
        a = T.TrainSpec(compression="int8", accum_shards=8, elastic=True)
        b = T.TrainSpec(compression="int8", accum_shards="8", elastic=True)
        assert a == b and hash(a) == hash(b) and len({a, b}) == 1
        assert [f.name for f in dataclasses.fields(T.TrainSpec)] == \
            [f.name for f in dataclasses.fields(J.TrainSpec)]


# ------------------------------------------------------ spec_for shims
SPEC_FOR = [
    dict(grad_compression="bf16"), dict(opt_grad_compression="bf16"),
    dict(grad_compression="int8", opt_grad_compression="int8"),
    dict(grad_compression="int8", opt_grad_compression="none"),
    dict(grad_compression="bf16", opt_grad_compression="int8"),
    dict(grad_compression="none"), dict(grad_accum_shards=8),
    dict(fsdp=True), dict(), dict(microbatches=3),
    dict(grad_compression="bf16", microbatches=2),
    dict(grad_compression="none", overlap=True),
    dict(grad_compression="none", overlap=False),
    dict(grad_compression="none", overlap=None),
    dict(grad_compression="none", overlap="backward"),
    dict(grad_compression="int8", grad_accum_shards=8, fsdp=True,
         rng="none"),
]


class TestSpecFor:
    @pytest.mark.parametrize("kw", SPEC_FOR,
                             ids=[str(i) for i in range(len(SPEC_FOR))])
    def test_spec_for_as_the_reference(self, kw):
        _same(lambda: J.spec_for(**kw), lambda: T.spec_for(**kw))

    def test_legacy_spellings_hash_equal(self):
        via_tc = T.spec_for(grad_compression="bf16")
        via_oc = T.spec_for(opt_grad_compression="bf16")
        assert via_tc == via_oc and hash(via_tc) == hash(via_oc)
        assert via_tc.elastic and via_tc.compression == "bf16"

    def test_conflicting_duplicates_raise(self):
        with pytest.raises(ValueError, match="conflicting grad compression"):
            T.spec_for(grad_compression="bf16", opt_grad_compression="int8")


# -------------------------------------------------- CLI flag cluster
CLI = [[], ["--grad-compression", "int8", "--grad-accum-shards", "8",
            "--fsdp", "--overlap", "backward"],
       ["--microbatches", "4"], ["--grad-compression", "none"],
       ["--overlap", "none"]]


class TestCliCluster:
    @staticmethod
    def _parse(mod, argv, **kw):
        ap = argparse.ArgumentParser()
        mod.add_train_spec_args(ap, **kw)
        return ap.parse_args(argv)

    @pytest.mark.parametrize("argv", CLI, ids=[str(i) for i in
                                               range(len(CLI))])
    def test_roundtrip_as_the_reference(self, argv):
        a, b = self._parse(J, argv), self._parse(T, argv)
        assert vars(a) == vars(b)
        _same(lambda: J.spec_from_args(a), lambda: T.spec_from_args(b))

    def test_microbatches_optional(self):
        with pytest.raises(SystemExit):
            self._parse(T, ["--microbatches", "4"], microbatches=False)

    def test_launch_cli_shares_the_cluster(self):
        """launch/train.py takes its spec flags from add_train_spec_args
        and re-declares none of them."""
        path = os.path.join(ROOT, "src", "repro_torch", "launch",
                            "train.py")
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        names = {getattr(n.func, "id", getattr(n.func, "attr", None))
                 for n in ast.walk(tree) if isinstance(n, ast.Call)}
        assert "add_train_spec_args" in names
        flags = {a.value for n in ast.walk(tree)
                 if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", None) == "add_argument"
                 for a in n.args if isinstance(a, ast.Constant)}
        assert not flags & {"--grad-compression", "--grad-accum-shards",
                            "--fsdp", "--overlap", "--microbatches"}

    def test_spec_importable_without_distributed_or_kernels(self):
        """The flag cluster and the spec import neither the exchange nor
        a kernel module."""
        code = ("import sys\n"
                "from repro_torch.launch.train import build_parser\n"
                "build_parser().parse_args(['--overlap', 'backward'])\n"
                "bad = [m for m in sys.modules if m.startswith(("
                "'repro_torch.dist.compression', 'repro_torch.kernels', "
                "'jax'))]\n"
                "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr


def test_constants_equal_the_reference():
    assert T.METHODS == J.METHODS == T_C.METHODS == J_C.METHODS
    assert T.OVERLAP_MODES == J.OVERLAP_MODES == T_C.OVERLAP_MODES
    assert T.RNG_POLICIES == J.RNG_POLICIES
    assert T._LAYOUT_KEYS == J._LAYOUT_KEYS


# ------------------------------------------------- step-builder registry
class TestRegistry:
    def test_builtin_order_and_resolution(self):
        assert T.step_builder_names() == J.step_builder_names()
        for kw in (dict(), dict(microbatches=4), dict(elastic=True),
                   dict(elastic=True, fsdp=True)):
            assert T.resolve_step_builder(T.TrainSpec(**kw))[0] == \
                J.resolve_step_builder(J.TrainSpec(**kw))[0]

    def test_register_overrides_and_unregister_restores(self):
        spec = T.TrainSpec(microbatches=3)
        sentinel = object()
        T.register_step_builder("custom-mb3", lambda s: s.microbatches == 3,
                                lambda s, ctx: sentinel)
        try:
            assert T.step_builder_names()[0] == "custom-mb3"
            assert T.build_train_step(spec, loss_fn=None) is sentinel
        finally:
            T.unregister_step_builder("custom-mb3")
        assert T.resolve_step_builder(spec)[0] == "microbatch"
        assert T.step_builder_names() == J.step_builder_names()

    def test_no_match_is_actionable(self):
        saved = list(T._STEP_BUILDERS)
        try:
            T._STEP_BUILDERS[:] = []
            with pytest.raises(ValueError, match="register_step_builder"):
                T.resolve_step_builder(T.TrainSpec())
        finally:
            T._STEP_BUILDERS[:] = saved

    def test_elastic_without_mesh_raises_as_the_reference(self):
        _, err = _same(
            lambda: J.build_train_step(J.TrainSpec(elastic=True),
                                       loss_fn=None),
            lambda: T.build_train_step(T.TrainSpec(elastic=True),
                                       loss_fn=None))
        assert err == "ValueError"


# ----------------------------------------------- checkpoint layout stamp
STAMPS = [
    # (checkpoint spec kwargs, stamped V, run spec kwargs, run V)
    (dict(compression="bf16", accum_shards=8), 8,
     dict(compression="bf16", accum_shards=8), 8),
    (dict(compression="bf16", accum_shards=8, overlap="backward"), 8,
     dict(compression="bf16", accum_shards=8, overlap="none", rng="none"),
     8),
    (dict(compression="bf16", accum_shards=8), 8,
     dict(compression="int8", accum_shards=8), 8),
    (dict(compression="bf16", accum_shards=8), 8,
     dict(compression="bf16", accum_shards=8), 4),
    (dict(compression="int8", accum_shards=8), 8,
     dict(compression="int8", accum_shards=8, fsdp=True), 8),
]


class TestLayoutStamp:
    @pytest.mark.parametrize("kw", [dict(), dict(microbatches=2),
                                    dict(compression="int8",
                                         accum_shards=8, elastic=True),
                                    dict(elastic=True, fsdp=True,
                                         overlap="none")])
    def test_stamp_equals_the_reference(self, kw):
        meshes = (None, types.SimpleNamespace(shape={"data": 4, "model": 1}))
        for mj, mt in zip(meshes, (None, HostMesh(4))):
            assert T.TrainSpec(**kw).layout_stamp(mt) == \
                J.TrainSpec(**kw).layout_stamp(mj)

    def test_empty_stamp_passes(self):
        T.check_restore_layout(None, T.TrainSpec(), None)
        T.check_restore_layout({}, T.TrainSpec(), None)

    @pytest.mark.parametrize("case", STAMPS,
                             ids=[str(i) for i in range(len(STAMPS))])
    def test_check_restore_layout_as_the_reference(self, case):
        ck, ck_v, run, run_v = case
        stamp = dict(J.TrainSpec(elastic=True, **ck).layout_stamp())
        stamp["resolved_accum_shards"] = ck_v
        _same(lambda: J.check_restore_layout(
                  stamp, J.TrainSpec(elastic=True, **run), run_v),
              lambda: T.check_restore_layout(
                  stamp, T.TrainSpec(elastic=True, **run), run_v))

    def test_checkpoint_metadata_roundtrip(self, tmp_path):
        from repro_torch.ckpt import checkpoint_metadata, save_checkpoint
        d = str(tmp_path / "ck")
        assert checkpoint_metadata(d) == {}
        s = T.TrainSpec(compression="int8", accum_shards=8, elastic=True)
        save_checkpoint(d, {"w": np.zeros((2,))}, 3,
                        metadata={"train_spec": s.layout_stamp()})
        got = checkpoint_metadata(d)["train_spec"]
        assert got == J.TrainSpec(compression="int8", accum_shards=8,
                                  elastic=True).layout_stamp()
        T.check_restore_layout(got, s, 8)
        with pytest.raises(ValueError, match="layout"):
            T.check_restore_layout(got, T.TrainSpec(
                compression="int8", accum_shards=8, fsdp=True,
                elastic=True), 8)


# ----------------------------------------------------- history schema
def _row(**kw):
    row = {"step": 0, "sec": 0.01, "loss": 1.5}
    row.update(kw)
    return row


HISTORIES = [
    [_row(step=0, payload_bytes=100, exchange_wire_bytes=800,
          exchange_shards=8, exchange_fsdp=0, exchange_fraction=0.25),
     _row(step=1)],
    [{"sec": 1.0}], [_row(loss="high")], [_row(payload_bytes=True)],
    [_row(sec=-1.0)], [_row(exchange_fraction=1.5)],
    [_row(step=5), _row(step=3)], ["not a row"],
]


class TestHistorySchema:
    def test_schema_equals_the_reference(self):
        assert T_met.HISTORY_SCHEMA == J_met.HISTORY_SCHEMA

    @pytest.mark.parametrize("hist", HISTORIES,
                             ids=[str(i) for i in range(len(HISTORIES))])
    def test_problems_equal_the_reference(self, hist):
        assert T_met.validate_history(hist) == J_met.validate_history(hist)


# ------------------------------------------------------- layout facade
def _models():
    """(reference values as numpy, port params) for SASRec-RecJPQ and a
    full-table two-tower model, the port's weights the reference's."""
    from repro.configs import get_bundle as J_bundle
    from repro.core import EmbeddingConfig as J_EC
    from repro.models.sequential import SeqRecConfig as J_Cfg
    from repro.models.sequential import SeqRecModel as J_Model
    from repro.nn import module as J_nn
    from repro_torch import bridge
    from repro_torch.configs import get_bundle as T_bundle
    from repro_torch.core import EmbeddingConfig as T_EC
    from repro_torch.models.sequential import SeqRecConfig as T_Cfg
    from repro_torch.models.sequential import SeqRecModel as T_Model

    kw = dict(arch="sasrec", n_items=300, max_len=12, d_model=32,
              n_layers=2, n_heads=2, d_ff=64)
    codes = np.random.default_rng(0).integers(0, 16, (302, 4)).astype(
        np.uint8)
    jm = J_Model(J_Cfg(embedding=J_EC(0, 0, kind="jpq", m=4, b=16), **kw),
                 codes=codes)
    tm = T_Model(T_Cfg(embedding=T_EC(0, 0, kind="jpq", m=4, b=16), **kw),
                 codes=codes, device="cpu")
    jv = jax.tree.map(np.asarray, J_nn.values(jm.init_params(
        jax.random.PRNGKey(0))))
    bridge.load_values(tm, jv)
    out = {"sasrec-jpq": (jv, tm.params())}
    jb, tb = J_bundle("two-tower-retrieval"), T_bundle("two-tower-retrieval")
    jtt = jb.make_smoke()[0]
    ttt = tb.make_smoke(device="cpu", seed=0)[0]
    jv = jax.tree.map(np.asarray, J_nn.values(jtt.init_params(
        jax.random.PRNGKey(0))))
    bridge.load_values(ttt, jv)
    out["two-tower-full"] = (jv, ttt.params())
    return out


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("D,V", [(1, 1), (1, 4), (2, 4), (4, 8)])
@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_payload_metrics_equal_the_reference(models, method, D, V):
    jmesh = types.SimpleNamespace(shape={"data": D, "model": 1})
    tmesh = HostMesh(D)
    for name, (jv, tp) in models.items():
        assert T_C.payload_bytes(tp, method) == \
            J_C.payload_bytes(jv, method), name
        for fsdp in (False, True):
            js = J.spec_for(grad_compression=method, grad_accum_shards=V,
                            fsdp=fsdp)
            ts = T.spec_for(grad_compression=method, grad_accum_shards=V,
                            fsdp=fsdp)
            want = J.payload_metrics(js, jv, jmesh)
            got = T.payload_metrics(ts, tp, tmesh)
            assert got == want and all(type(got[k]) is type(want[k])
                                       for k in want), (name, fsdp)


@pytest.mark.parametrize("V", [1, 2, 4, 8, 32])
def test_fsdp_classification_equals_the_reference(models, V):
    """``fsdp_leaf_sharded`` and ``state_shardings`` leaf for leaf."""
    from repro.launch.mesh import make_host_mesh as J_mesh
    from repro_torch.train.optimizer import tree_map
    jmesh = J_mesh(1)
    js = J.spec_for(grad_accum_shards=V, fsdp=True)
    ts = T.spec_for(grad_accum_shards=V, fsdp=True)
    for name, (jv, tp) in models.items():
        want = flatten(jax.tree.map(
            lambda v: np.bool_(J_C.fsdp_leaf_sharded(v, V)), jv))
        got = flatten(tree_map(
            lambda v: np.bool_(T_C.fsdp_leaf_sharded(v, V)), tp))
        assert got == want, name
        assert any(want.values())
        want_sh = flatten(jax.tree.map(
            lambda s: np.bool_(tuple(s.spec) == ("data",)),
            J.state_shardings(js, jv, jmesh)))
        got_sh = flatten(tree_map(
            lambda v, s: np.bool_(s == ("data",)), tp,
            T.state_shardings(ts, tp, HostMesh(1))))
        assert got_sh == want_sh == want, name


def test_error_state_shapes_and_zeros(models):
    for name, (jv, tp) in models.items():
        for V in (1, 4):
            ts = T.spec_for(grad_accum_shards=V)
            js = J.spec_for(grad_accum_shards=V)
            got = flatten(jax.tree.map(
                lambda x: np.array(tuple(x.shape)),
                T.error_state_shapes(ts, HostMesh(1))(tp)))
            want = flatten(jax.tree.map(
                lambda x: np.array(tuple(x.shape)),
                J.error_state_shapes(js, types.SimpleNamespace(
                    shape={"data": 1, "model": 1}))(jv)))
            assert got.keys() == want.keys()
            assert all(np.array_equal(got[k], want[k]) for k in want), name
            z = T.zeros_error_state(ts, tp, HostMesh(1))
            assert all(not x.any() and x.dtype == torch.float32
                       for x in jax.tree.leaves(z))
    assert T.dp_degree(HostMesh(4)) == 4


def test_dp_train_step_builder(models):
    """configs/base.dp_train_step_builder: the spec shim, one elastic
    step on a world of one, the error state's shapes."""
    from repro_torch.configs.base import dp_train_step_builder
    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import init_opt_state
    model, batch = get_bundle("two-tower-retrieval").make_smoke(
        device="cpu", seed=0)
    mesh = make_host_mesh(1)
    try:
        fn, err_shapes = dp_train_step_builder(model, mesh, method="int8",
                                               accum_shards=2, fsdp=True)
        assert fn.n_shards == 2 and fn.fsdp
        values = model.params()
        err = T_C.zeros_error_state(values, 2)
        assert jax.tree.map(lambda e, s: tuple(e.shape) == tuple(s.shape),
                            err, err_shapes(values))
        new, opt, new_err, loss = fn(
            fn.shard(values), fn.shard(init_opt_state(values)),
            err, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert torch.isfinite(loss) and opt["step"] == 1
        assert any(e.abs().max() > 0 for e in jax.tree.leaves(new_err)
                   if e.numel())
    finally:
        mesh.close()
