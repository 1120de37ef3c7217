"""Parity of the port's serving slice (repro_torch: core/jpq, core/engine,
core/serve, core/assign, models/recsys, launch/serve) with the JAX
reference, on the CPU.

End to end, the same reference TwoTower weights (bridged) serve the same
request through both packages.  The LUT einsum and the user tower sum
in another order than XLA, so values are compared within an absolute
tolerance of 2e-7 (measured: at most 1.5e-8 on these configs) and ids
must be equal; the seeds are chosen so that the gaps between the top
k+1 scores exceed ten times that tolerance, which the tests assert, so
a tie cannot flip an id.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jpq as J_jpq
from repro.core import engine as J_engine
from repro.core.assign import popularity_permutation as J_pop
from repro.core.serve import ThresholdState as J_TS
from repro.core import EmbeddingConfig as J_EC
from repro.launch import serve as J_serve
from repro.models.recsys import TwoTower as J_TwoTower
from repro.models.recsys import TwoTowerConfig as J_TTC
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import engine as T_engine
from repro_torch.core import jpq as T_jpq
from repro_torch.core.assign import popularity_permutation as T_pop
from repro_torch.core.serve import ThresholdState as T_TS
from repro_torch.launch import serve as T_serve
from repro_torch.models.recsys import TwoTower as T_TwoTower
from repro_torch.models.recsys import TwoTowerConfig as T_TTC

TOL = 2e-7

CONFIGS = {
    # the reference bundle's smoke config and one mid-size catalogue
    "smoke": dict(n_items=200, embed_dim=32, tower_mlp=(64, 32),
                  hist_len=8, m=4, b=16),
    "mid": dict(n_items=5000, embed_dim=64, tower_mlp=(128, 64),
                hist_len=10, m=8, b=256),
}


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    """Reference model + params, and the port's model on the same
    (bridged) weights; cached because every test only reads them."""
    c = dict(CONFIGS[name])
    m, b = c.pop("m"), c.pop("b")
    jm = J_TwoTower(J_TTC(embedding=J_EC(0, 0, kind="jpq", m=m, b=b), **c))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = T_TwoTower(T_TTC(embedding=T_EC(0, 0, kind="jpq", m=m, b=b), **c),
                    generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    hist = np.random.default_rng(seed).integers(0, c["n_items"] + 1,
                                                (8, c["hist_len"]))
    return jm, jp, tm, hist


def _min_gap(jm, jp, hist, k):
    u = jm.user_vec(jp, jnp.asarray(hist))
    s = np.asarray(jm.emb.logits(jp["item_emb"], u))
    top = -np.sort(-s, axis=1)[:, :k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


# ============================================================ core/jpq

class TestJpqModule:
    def test_partial_scores_and_logits(self):
        rng = np.random.default_rng(0)
        # the model's init scale (d ** -0.5), so scores are O(1)
        cent = (64 ** -0.5 * rng.standard_normal((8, 256, 8))).astype(
            np.float32)
        codes = rng.integers(0, 256, (5000, 8)).astype(np.uint8)
        h = rng.standard_normal((3, 2, 64)).astype(np.float32)
        jp = {"centroids": J_nn.P(jnp.asarray(cent), None),
              "codes": J_nn.P(jnp.asarray(codes), None)}
        tp = {"centroids": torch.tensor(cent), "codes": torch.tensor(codes)}
        np.testing.assert_allclose(
            np.asarray(J_jpq.partial_scores(jp, jnp.asarray(h))),
            T_jpq.partial_scores(tp, torch.tensor(h)).numpy(),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(J_jpq.logits(jp, jnp.asarray(h))),
            T_jpq.logits(tp, torch.tensor(h)).numpy(), rtol=0, atol=1e-6)
        ids = rng.integers(0, 5000, (4, 3))
        np.testing.assert_array_equal(
            np.asarray(J_jpq.lookup(jp, jnp.asarray(ids))),
            T_jpq.lookup(tp, torch.tensor(ids)).numpy())
        # use_kernel=True: on a CPU tensor the jpq_scores kernel's plain
        # version, the same gather-sum, so the same bits as the default
        np.testing.assert_array_equal(
            T_jpq.logits(tp, torch.tensor(h), use_kernel=True).numpy(),
            T_jpq.logits(tp, torch.tensor(h)).numpy())
        np.testing.assert_array_equal(
            np.asarray(J_jpq.reconstruct_table(jp)),
            T_jpq.reconstruct_table(tp).numpy())

    def test_mesh_is_a_later_slice(self):
        """The mesh branches are ported (tests/test_torch_sharded.py):
        the functions read the ambient mesh.  Where its model axis does
        not divide the rows they run unsharded, as the reference does;
        where it does, a mesh without a process group refuses the
        collective instead of serving a shard's answer."""
        from repro_torch import dist as T_dist
        from repro_torch.core import sharded
        from repro_torch.launch.mesh import HostMesh
        x = torch.arange(10.0).reshape(2, 5)
        part = torch.arange(8.0).reshape(2, 1, 4)
        codes = torch.tensor([[3], [1], [2], [0], [3]], dtype=torch.uint8)
        tab, ids = torch.arange(12.0).reshape(4, 3), torch.tensor([[1, 3]] * 2)
        want = (sharded.topk_over_items(x, 3),
                sharded.fused_topk_over_codes(part, codes, 3),
                sharded.pooled_lookup(tab, ids, torch.ones(2, 2)))
        with T_dist.use_mesh_rules(HostMesh(1, 3)):       # 3 ∤ 5, 3 ∤ 4
            got = (sharded.topk_over_items(x, 3),
                   sharded.fused_topk_over_codes(part, codes, 3),
                   sharded.pooled_lookup(tab, ids, torch.ones(2, 2)))
        for g, w in zip(got[:2], want[:2]):
            assert all(torch.equal(a, b) for a, b in zip(g, w))
        assert torch.equal(got[2], want[2])
        with T_dist.use_mesh_rules(HostMesh(1, 2)):       # 2 | 4
            with pytest.raises(ValueError, match="sizes-only"):
                sharded.pooled_lookup(tab, ids, torch.ones(2, 2))

    def test_init_dtypes_and_counts(self):
        g = torch.Generator().manual_seed(0)
        p = T_jpq.init(g, 100, 16, 4, 16, device="cpu")
        assert p["codes"].dtype == torch.uint8 and p["codes"].shape == (100, 4)
        assert p["centroids"].shape == (4, 16, 4)
        assert T_jpq.init(g, 10, 16, 4, 300, device="cpu")["codes"].dtype \
            == torch.int32
        assert T_jpq.embedding_param_count(1000, 64, 8, 256) == \
            J_jpq.embedding_param_count(1000, 64, 8, 256)


# ========================================================= core/engine

BAD_SPECS = [dict(k=0), dict(block_n=0), dict(perm="popularity"),
             dict(warm=0.5), dict(prune=True, warm=1.0),
             dict(stats=True), dict(fused=False, prune=True, stats=True),
             dict(beams=0), dict(kind="")]


class TestEngine:
    @pytest.mark.parametrize("kw", BAD_SPECS, ids=[str(k) for k in BAD_SPECS])
    def test_spec_validation_messages_match(self, kw):
        with pytest.raises(ValueError) as je:
            J_engine.RetrievalSpec(**kw)
        with pytest.raises(ValueError) as te:
            T_engine.RetrievalSpec(**kw)
        assert str(te.value) == str(je.value)

    def test_backend_values_are_the_ports(self):
        """The port's spec has no backend field: the tensors' device
        picks the kernel or its plain version."""
        assert "backend" not in {f.name for f in
                                 dataclasses.fields(T_engine.RetrievalSpec)}
        with pytest.raises(TypeError, match="backend"):
            T_engine.RetrievalSpec(backend="cuda")

    @pytest.mark.parametrize("argv", [
        [], ["--no-fused"], ["--prune"], ["--prune", "--perm", "--warm"],
        ["--prune", "--warm", "0.5", "--top-k", "7"],
        ["--no-fused", "--prune", "--perm"], ["--perm"]])
    def test_spec_from_args_matches(self, argv):
        ja = J_serve.build_parser().parse_args(argv)
        ta = T_serve.build_parser().parse_args(argv + ["--device", "cpu"])
        for kind in ("jpq", "full"):
            js = dataclasses.asdict(J_engine.spec_from_args(ja, kind=kind))
            ts = T_engine.spec_from_args(ta, kind=kind)
            # the reference's backend is left to its default (chosen at
            # run time), which the port's device-chosen path matches
            assert js.pop("backend") is None
            assert dataclasses.asdict(ts) == js

    def test_registry_resolution_matches(self):
        for kw in [dict(), dict(fused=False), dict(prune=True),
                   dict(prune=True, perm="popularity"),
                   dict(prune=True, warm=0.9), dict(kind="full")]:
            js = J_engine.resolve_scorer(J_engine.RetrievalSpec(**kw))[0]
            ts = T_engine.resolve_scorer(T_engine.RetrievalSpec(**kw))[0]
            assert ts == js, kw

    def test_rerank_candidates_matches(self):
        rng = np.random.default_rng(1)
        v = rng.integers(-2, 3, (3, 40)).astype(np.float32)
        v[v == 0] = -0.0
        v[:, ::5] = 0.0
        ids = rng.permutation(40 * 3).reshape(3, 40).astype(np.int32)
        jv, ji = J_engine.rerank_candidates(jnp.asarray(v), jnp.asarray(ids),
                                            12)
        tv, ti = T_engine.rerank_candidates(torch.tensor(v),
                                            torch.tensor(ids), 12)
        np.testing.assert_array_equal(np.asarray(jv).view(np.int32),
                                      tv.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())

    def test_jit_cache_keys_and_evicts(self):
        cache = T_engine.JitCache()
        s1 = T_engine.RetrievalSpec(k=5)
        s2 = T_engine.RetrievalSpec(k=6)
        builds = []
        for spec, ver in [(s1, 0), (s1, 0), (s2, 0), (s1, 1)]:
            cache.get(spec, ver, 8, lambda: builds.append(1) or object())
        assert len(builds) == 3 and len(cache) == 3
        assert cache.evict([1]) == 2 and cache.versions() == (1,)
        with pytest.raises(TypeError):
            cache.key("spec", 0, 8)

    def test_mesh_and_prune_block_n(self):
        assert T_engine.resolve_prune_block_n(1_000_448) == \
            J_engine.resolve_prune_block_n(1_000_448)
        assert T_engine.resolve_prune_block_n(1000, block_n=64) == 64
        # a sharded catalogue tiles each shard exactly, as the reference
        assert T_engine.resolve_prune_block_n(1024, shards=2) == \
            J_engine.resolve_prune_block_n(1024, shards=2)


# ==================================================== serve helpers

class TestServeHelpers:
    def test_threshold_state_sequence(self):
        rng = np.random.default_rng(2)
        js, ts = J_TS(0.8), T_TS(0.8)
        for _ in range(6):
            th = rng.standard_normal(5).astype(np.float32)
            th[rng.integers(0, 5)] = np.nan
            js.update(th)
            ts.update(th)
            assert ts.theta == js.theta
            np.testing.assert_array_equal(ts.floor(3), js.floor(3))
        ts.update([np.inf, -np.inf])
        assert ts.theta == js.theta
        other_j, other_t = J_TS(), T_TS()
        other_j.update([-5.0])
        other_t.update([-5.0])
        assert T_TS.merge([ts, other_t]) == J_TS.merge([js, other_j])
        assert ts.theta == js.theta
        ts.reset()
        assert ts.theta is None and np.isneginf(ts.floor(2)).all()
        with pytest.raises(ValueError, match="decay"):
            T_TS(1.0)

    def test_popularity_permutation(self):
        rng = np.random.default_rng(3)
        counts = rng.integers(0, 5, 300)
        np.testing.assert_array_equal(T_pop(counts), J_pop(counts))
        inter = (rng.integers(0, 9, 50), rng.integers(0, 40, 50))
        np.testing.assert_array_equal(
            T_pop(interactions=inter, n_items=40),
            J_pop(interactions=inter, n_items=40))
        for bad in (np.zeros((2, 2)), np.array([1.0, np.nan]),
                    np.array([1, -1])):
            with pytest.raises(ValueError):
                T_pop(bad)

    def test_make_requests_and_template_popularity(self):
        tmpl = {"user_hist": np.random.default_rng(4).integers(0, 50, (4, 6)),
                "logq": np.arange(4, dtype=np.float32)}
        for jr, tr in zip(J_serve.make_requests(tmpl, 7, 3, 9, reserved=(0,)),
                          T_serve.make_requests(tmpl, 7, 3, 9, reserved=(0,))):
            for k in tmpl:
                np.testing.assert_array_equal(jr[k], tr[k])
        np.testing.assert_array_equal(
            T_serve._template_popularity(tmpl, 60),
            J_serve._template_popularity(tmpl, 60))


# ================================================ the slice end to end

PATHS = ["fused", "no-fused", "prune", "prune-perm-warm"]


class TestTwoTowerEndToEnd:
    @pytest.mark.parametrize("path", PATHS)
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_retrieve_matches_reference(self, name, path):
        jm, jp, tm, hist = _pair(name)
        k = 10
        assert _min_gap(jm, jp, hist, k) > 10 * TOL
        kw = {}
        if path == "no-fused":
            kw = dict(fused=False)
        elif path == "prune":
            kw = dict(prune=True)
        elif path == "prune-perm-warm":
            n_rows = jm.cfg.emb_cfg().n_items
            perm = J_pop(J_serve._template_popularity({"h": hist}, n_rows))
            theta = np.asarray(jm.retrieve(jp, {"user_hist": jnp.asarray(
                hist)}, top_k=k)[0])[:, -1]
            # even rows overshoot (demote and re-sweep), odd rows hold
            warm = np.where(np.arange(len(theta)) % 2 == 0, theta + 1.0,
                            theta - 1.0).astype(np.float32)
            kw = dict(prune=True, perm=perm, warm=warm, return_stats=True)
        jout = jm.retrieve(jp, {"user_hist": jnp.asarray(hist)}, top_k=k,
                           **kw)
        tout = tm.retrieve(tm.params(), {"user_hist": torch.tensor(hist)},
                           top_k=k, **kw)
        np.testing.assert_array_equal(np.asarray(jout[1]), tout[1].numpy())
        np.testing.assert_allclose(np.asarray(jout[0]), tout[0].numpy(),
                                   rtol=0, atol=TOL)
        if kw.get("return_stats"):
            np.testing.assert_array_equal(np.asarray(jout[2]["demoted"]),
                                          tout[2]["demoted"].numpy())
            assert tout[2]["demoted"].numpy()[::2].all()

    def test_bind_engine_paths_agree(self):
        _, _, tm, hist = _pair("mid")
        p = tm.params()
        outs = {}
        for name, spec in [
                ("fused", T_engine.RetrievalSpec(k=10)),
                ("materialise", T_engine.RetrievalSpec(k=10, fused=False)),
                ("pruned", T_engine.RetrievalSpec(k=10, prune=True))]:
            outs[name] = tm.bind_engine(p, spec).retrieve(
                {"user_hist": torch.tensor(hist)})
        for name in ("materialise", "pruned"):
            assert torch.equal(outs[name][0], outs["fused"][0])
            assert torch.equal(outs[name][1], outs["fused"][1])

    def test_retrieve_topk_and_probe_match_reference(self):
        from repro.core.serve import retrieve_topk as J_retrieve_topk
        from repro_torch.core.serve import retrieve_topk as T_retrieve_topk
        jm, jp, tm, hist = _pair("smoke")
        u = np.asarray(jm.user_vec(jp, jnp.asarray(hist)))
        for kw in (dict(), dict(fused=False), dict(prune=True)):
            jv, ji = J_retrieve_topk(jm.emb, jp["item_emb"], jnp.asarray(u),
                                     k=9, **kw)
            tv, ti = T_retrieve_topk(tm.emb, tm.params()["item_emb"],
                                     torch.tensor(u), k=9, **kw)
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
            np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0,
                                       atol=TOL)
        part = T_jpq.partial_scores(tm.params()["item_emb"], torch.tensor(u))
        codes = tm.params()["item_emb"]["codes"]
        st = T_engine.build_prune_state(codes, 16, block_n=128)
        a = T_engine.probe_topk(part, codes, 9)
        b = T_engine.probe_topk(part, codes, 9, prune=st)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_custom_scorer_registration(self):
        calls = []

        def fake(engine, p, h, floor):
            calls.append(h.shape)
            return torch.zeros(h.shape[0], 1), torch.zeros(
                h.shape[0], 1, dtype=torch.int32)

        T_engine.register_scorer("test-fake", lambda s: s.kind == "fake",
                                 fake)
        try:
            assert T_engine.scorer_names()[0] == "test-fake"
            eng = T_engine.RetrievalEngine(T_engine.RetrievalSpec(kind="fake"))
            v, i = eng.retrieve(torch.zeros(2, 3, 4))
            assert v.shape == i.shape == (2, 3, 1) and calls == [(6, 4)]
        finally:
            T_engine.unregister_scorer("test-fake")
        assert "test-fake" not in T_engine.scorer_names()

    def test_bulk_retrieve_matches_reference(self):
        jm, jp, tm, hist = _pair("smoke")
        jv, ji = jm.bulk_retrieve(jp, {"user_hist": jnp.asarray(hist)},
                                  top_k=7, chunk=4)
        tv, ti = tm.bulk_retrieve(tm.params(), {"user_hist": hist}, top_k=7,
                                  chunk=4)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0,
                                   atol=TOL)


class TestServeCli:
    @pytest.mark.parametrize("flags,path", [
        ([], "fused"), (["--no-fused"], "materialise"),
        (["--prune"], "fused+prune"),
        (["--prune", "--perm", "--warm"], "fused+prune+perm+warm")])
    def test_cli_runs_on_cpu(self, flags, path, capsys):
        res = T_serve.main(["--device", "cpu", "--requests", "3",
                            "--batch-size", "8", *flags])
        assert res["path"] == path and res["device"] == "cpu"
        assert np.isfinite(res["p50_ms"]) and res["p99_ms"] >= res["p50_ms"]
        assert (res["skip"] is not None) == ("--prune" in flags)
        assert "two-tower-retrieval-jpq: batch=8" in capsys.readouterr().out

    # --mesh is ported for every recsys arch (tests/test_torch_sharded.py,
    # tests/test_torch_ctr_model_axis.py); an LM arch (item 10) is not
    @pytest.mark.parametrize("flags", [["--mesh", "2", "--arch",
                                        "qwen3-14b"]])
    def test_unported_flags_raise(self, flags):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            T_serve.main(["--device", "cpu", *flags])

    def test_cuda_default_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T_serve.main(["--requests", "1"])
