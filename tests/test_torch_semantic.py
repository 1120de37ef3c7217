"""The port's semantic-ID head (repro_torch.core.semantic) against the
JAX reference (repro.core.semantic), on the CPU.

The trie and the beam search are exact by construction, so on a shared
numpy LUT ``part`` the port's ``build_code_index`` and
``semantic_decode`` equal the reference's bit for bit: level keys,
offsets and leaf items; values and tie-broken ids, exhaustive and at
narrow beams, with duplicate code rows, score ties and -0.0 in the LUT.
The exhaustive port decode also equals the port's own materialise top-k
bit for bit, and a narrow decode is sound (every id real, its value its
materialised score).  ``code_xent`` goes through the LUT einsum, which
differs from XLA's by up to 2.4e-7, so it is held within 1e-5 relative.
Also: the trie cache (an in-place write to the codes rebuilds it), the
engine's "semantic-id" scorer and its guards, ``--head
semantic`` / ``--beams`` / ``--ckpt-dir`` through the serve CLI, and the
``backend`` rule (None only).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as J_engine
from repro.core import semantic as J_sem
from repro.launch import serve as J_serve
from repro.nn import module as J_nn
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import engine as T_engine
from repro_torch.core import jpq as T_jpq
from repro_torch.core import make_embedding as T_make
from repro_torch.core import semantic as T_sem
from repro_torch.core import serve as T_core_serve
from repro_torch.launch import serve as T_serve

B, N, D, M, CB = 5, 257, 16, 4, 8      # CB: centroids a split (b)
SENT = np.iinfo(np.int32).max


def _codes(seed=0, n=N, m=M, b=CB):
    """A codes table with duplicate rows (shared paths: score ties)."""
    codes = np.random.default_rng(seed).integers(0, b, size=(n, m))
    if n >= 8:
        codes[n // 3] = codes[1]
        codes[n - 2] = codes[1]
        codes[n // 2] = codes[4]
    return codes


def _part(seed=1, b=B, m=M, cb=CB):
    """A LUT with many exact ties (values on a half-integer grid), zeros
    of both signs."""
    rng = np.random.default_rng(seed)
    part = np.round(rng.standard_normal((b, m, cb)) * 2) / 2
    part = part.astype(np.float32)
    part[0, :, :3] = 0.0
    part[1, 0, 2] = -0.0
    part[2, 1, :] = -0.0
    return part


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _port_emb(codes, m=M, b=CB, seed=0):
    emb = T_make(T_EC(n_items=codes.shape[0], d=D, kind="jpq", m=m, b=b))
    p = emb.init(torch.Generator().manual_seed(seed), codes=codes,
                 device="cpu")
    h = torch.randn((B, D), generator=torch.Generator().manual_seed(seed + 1))
    return emb, p, h


def _port_topk(emb, p, h, k):
    """The port's materialise top-k: total order over jpq.logits."""
    s = emb.logits(p, h)
    ids = torch.arange(s.shape[1], dtype=torch.int32).expand_as(s)
    return T_engine.rerank_candidates(s, ids, k)


# ================================================================ index

class TestCodeIndex:
    @pytest.mark.parametrize("n,m,b", [(N, M, CB), (40, 1, 16), (9, 3, 2)])
    def test_index_equals_reference(self, n, m, b):
        codes = _codes(n=n, m=m, b=b)
        ji = J_sem.build_code_index(codes, b)
        ti = T_sem.build_code_index(codes, b)
        assert len(ti.level_keys) == len(ji.level_keys) == m
        for a, c in zip(ji.level_keys, ti.level_keys):
            assert c.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), c.numpy())
        np.testing.assert_array_equal(np.asarray(ji.leaf_offsets),
                                      ti.leaf_offsets.numpy())
        np.testing.assert_array_equal(np.asarray(ji.leaf_items),
                                      ti.leaf_items.numpy())
        for f in ("n_items", "n_paths", "max_leaf", "m", "b"):
            assert getattr(ti, f) == getattr(ji, f), f

    def test_index_from_a_tensor_keeps_its_device(self):
        codes = torch.tensor(_codes(), dtype=torch.uint8)
        ti = T_sem.build_code_index(codes, CB)
        assert ti.leaf_items.device == codes.device
        np.testing.assert_array_equal(
            ti.leaf_items.numpy(),
            np.asarray(J_sem.build_code_index(_codes(), CB).leaf_items))

    @pytest.mark.parametrize("codes,b", [
        (np.zeros(4, np.int32), 4), (np.array([[0, 7]]), 4),
        (np.array([[-1, 0]]), 4), (np.array([[0], [1]]), 2 ** 30),
        (np.zeros((0, 3), np.int32), 4)])
    def test_index_validation_matches(self, codes, b):
        with pytest.raises(ValueError) as je:
            J_sem.build_code_index(codes, b)
        with pytest.raises(ValueError) as te:
            T_sem.build_code_index(codes, b)
        if "int32" in str(je.value):
            assert "2**31" in str(te.value)
        else:
            assert str(te.value) == str(je.value)

    def test_index_cache_identity_and_eviction(self):
        codes = torch.tensor(_codes(), dtype=torch.uint8)
        a = T_sem.index_for(codes, CB)
        assert T_sem.index_for(codes, CB) is a
        assert T_sem.index_for(codes, 16) is not a      # keyed on b
        others = [torch.tensor(_codes(seed=s), dtype=torch.uint8)
                  for s in range(1, 9)]
        for c in others:
            T_sem.index_for(c, CB)
        assert len(T_sem._INDEX_CACHE) == T_sem._INDEX_CACHE_MAX
        assert T_sem.index_for(codes, CB) is not a      # evicted
        T_sem.clear_index_cache()
        assert not T_sem._INDEX_CACHE

    def test_index_cache_sees_an_in_place_write(self):
        codes = torch.tensor(_codes(), dtype=torch.uint8)
        a = T_sem.index_for(codes, CB)
        codes.copy_(torch.tensor(_codes(seed=5), dtype=torch.uint8))
        got = T_sem.index_for(codes, CB)
        assert got is not a
        np.testing.assert_array_equal(
            got.leaf_items.numpy(),
            np.asarray(J_sem.build_code_index(_codes(seed=5),
                                              CB).leaf_items))


# =============================================== decode vs the reference

class TestDecode:
    @pytest.mark.parametrize("beams", [None, 1, 3, 7])
    def test_decode_equals_reference(self, beams):
        codes, part = _codes(), _part()
        ji = J_sem.build_code_index(codes, CB)
        ti = T_sem.build_code_index(codes, CB)
        for k in (1, 7, 40, N):
            jv, jid = J_sem.semantic_decode(jnp.asarray(part), ji, k,
                                            beams=beams)
            tv, tid = T_sem.semantic_decode(torch.tensor(part), ti, k,
                                            beams=beams)
            assert tv.dtype == torch.float32 and tid.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(jid), tid.numpy())
            np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))

    @pytest.mark.parametrize("k", [1, 7, 40, N])
    def test_exhaustive_equals_port_materialise(self, k):
        codes = _codes()
        emb, p, h = _port_emb(codes)
        idx = T_sem.build_code_index(codes, CB)
        part = T_jpq.partial_scores(p, h)
        rv, ri = _port_topk(emb, p, h, k)
        for beams in (None, idx.n_paths, idx.n_paths + 100):
            v, i = T_sem.semantic_decode(part, idx, k, beams=beams)
            assert torch.equal(i, ri)
            np.testing.assert_array_equal(_bits(v), _bits(rv))

    def test_narrow_beams_sound(self):
        codes = _codes()
        emb, p, h = _port_emb(codes)
        idx = T_sem.build_code_index(codes, CB)
        part = T_jpq.partial_scores(p, h)
        scores = emb.logits(p, h).numpy()
        for beams, k in [(4, 3), (8, 7), (1, 1), (16, 60)]:
            v, i = T_sem.semantic_decode(part, idx, k, beams=beams)
            v, i = v.numpy(), i.numpy()
            for bi in range(B):
                real = i[bi] != SENT
                assert real.sum() >= min(beams, k)
                ids = i[bi][real]
                assert len(set(ids.tolist())) == len(ids)
                np.testing.assert_array_equal(_bits(v[bi][real]),
                                              _bits(scores[bi][ids]))
                assert (v[bi][~real] == -np.inf).all()

    def test_part_shape_checked(self):
        idx = T_sem.build_code_index(_codes(), CB)
        with pytest.raises(ValueError, match="partial_scores"):
            T_sem.semantic_decode(torch.zeros(B, M, CB + 1), idx, 3)


# ============================================================ code_xent

def test_code_xent_matches_reference():
    from repro.core import EmbeddingConfig as J_EC
    from repro.core import make_embedding as J_make
    codes = _codes()
    jemb = J_make(J_EC(n_items=N, d=D, kind="jpq", m=M, b=CB))
    jp = jemb.init(J_nn.KeyGen(0), codes=codes)
    vals = jax.tree.map(np.asarray, J_nn.values(jp))
    h = np.random.default_rng(2).standard_normal((B, 3, D)).astype(
        np.float32)
    ids = np.random.default_rng(3).integers(0, N, (B, 3))
    want = np.asarray(J_sem.code_xent(jp, jnp.asarray(h), jnp.asarray(ids)))
    tp = {"codes": torch.tensor(vals["codes"]),
          "centroids": torch.tensor(vals["centroids"])}
    got = T_sem.code_xent(tp, torch.tensor(h), torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# =========================================================== the scorer

class TestSemanticScorer:
    def test_engine_resolves_and_serves_exhaustively(self):
        codes = _codes()
        emb, p, h = _port_emb(codes)
        spec = T_engine.RetrievalSpec(kind="semantic", k=7)
        assert T_engine.resolve_scorer(spec)[0] == "semantic-id" == \
            J_engine.resolve_scorer(J_engine.RetrievalSpec(
                kind="semantic", k=7))[0]
        eng = T_engine.RetrievalEngine(dataclasses.replace(spec, beams=N),
                                       emb, p)
        v, i = eng.retrieve(h)
        rv, ri = _port_topk(emb, p, h, 7)
        assert torch.equal(i, ri)
        np.testing.assert_array_equal(_bits(v), _bits(rv))
        # the auto width max(32, 4k) is what a default spec serves
        v, i = T_engine.RetrievalEngine(spec, emb, p).retrieve(h)
        want = T_sem.semantic_decode(T_jpq.partial_scores(p, h),
                                     T_sem.index_for(p["codes"], CB), 7,
                                     beams=32)
        assert torch.equal(i, want[1]) and torch.equal(v, want[0])

    def test_serves_codes_restored_in_place(self, tmp_path):
        """A checkpoint with other codes restored into the live params
        (``restore_values`` writes in place): the next exhaustive decode
        equals the materialise top-k of the new codes, not the trie the
        scorer cached for the old ones."""
        from repro_torch.ckpt import restore_values, save_checkpoint
        emb, p, h = _port_emb(_codes())
        eng = T_engine.RetrievalEngine(
            T_engine.RetrievalSpec(kind="semantic", k=7, beams=N), emb, p)
        old_v, old_i = eng.retrieve(h)
        new_codes = _codes(seed=5)
        save_checkpoint(str(tmp_path), {
            "centroids": p["centroids"].detach().numpy(),
            "codes": new_codes.astype(np.uint8)}, 3)
        codes = p["codes"]
        assert restore_values(str(tmp_path), p) == 3
        assert p["codes"] is codes
        np.testing.assert_array_equal(codes.numpy(), new_codes)
        v, i = eng.retrieve(h)
        rv, ri = _port_topk(emb, p, h, 7)
        assert not torch.equal(i, old_i)
        assert torch.equal(i, ri)
        np.testing.assert_array_equal(_bits(v), _bits(rv))

    def test_scorer_guards(self):
        emb, p, h = _port_emb(_codes())
        eng = T_engine.RetrievalEngine(
            T_engine.RetrievalSpec(kind="semantic", k=7), emb, p)
        with pytest.raises(ValueError, match="floor"):
            eng.retrieve(h, floor=torch.zeros(B))
        eng.prune = True
        with pytest.raises(ValueError, match="prune=False"):
            eng.retrieve(h)
        full = T_make(T_EC(n_items=N, d=D, kind="full"))
        fp = full.init(torch.Generator().manual_seed(0), device="cpu")
        eng = T_engine.RetrievalEngine(
            T_engine.RetrievalSpec(kind="semantic", k=7), full, fp)
        with pytest.raises(ValueError, match="kind='jpq'"):
            eng.retrieve(h)

    @pytest.mark.parametrize("argv", [
        ["--head", "semantic"], ["--head", "semantic", "--beams", "64"],
        ["--head", "semantic", "--beams", "64", "--prune", "--perm"],
        ["--head", "semantic", "--no-fused", "--top-k", "3"]])
    def test_spec_from_args_matches(self, argv):
        ja = J_serve.build_parser().parse_args(argv)
        ta = T_serve.build_parser().parse_args(argv + ["--device", "cpu"])
        js = dataclasses.asdict(J_engine.spec_from_args(ja, kind="jpq"))
        assert js.pop("backend") is None
        assert dataclasses.asdict(T_engine.spec_from_args(ta, kind="jpq")) \
            == js
        with pytest.raises(ValueError, match="JPQ item embedding"):
            T_engine.spec_from_args(ta, kind="full")


# ====================================================== the backend rule

class TestBackendRule:
    @pytest.mark.parametrize("backend", ["pallas", "interpret", "scan",
                                         "cuda"])
    def test_every_backend_but_none_raises(self, backend):
        emb, p, h = _port_emb(_codes())
        with pytest.raises(ValueError, match=f"backend={backend!r}"):
            T_engine.spec_for(emb, k=3, backend=backend)
        with pytest.raises(ValueError, match="device picks the route"):
            T_core_serve.retrieve_topk(emb, p, h, k=3, backend=backend)

    def test_none_is_accepted(self):
        emb, p, h = _port_emb(_codes())
        assert T_engine.spec_for(emb, k=3, backend=None) == \
            T_engine.spec_for(emb, k=3)
        a = T_core_serve.retrieve_topk(emb, p, h, k=3, backend=None)
        b = T_core_serve.retrieve_topk(emb, p, h, k=3)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ================================================================ CLI

class TestServeCli:
    @pytest.mark.parametrize("flags,path", [
        (["--head", "semantic"], "semantic"),
        (["--head", "semantic", "--beams", "64"], "semantic@64")])
    def test_semantic_head_on_cpu(self, flags, path, capsys):
        res = T_serve.main(["--device", "cpu", "--requests", "3",
                            "--batch-size", "8", *flags])
        assert res["path"] == path and res["skip"] is None
        assert np.isfinite(res["p50_ms"]) and res["p99_ms"] >= res["p50_ms"]
        assert f"path={path} " in capsys.readouterr().out

    def test_semantic_head_matches_the_bound_engine(self):
        from repro_torch.configs import get_bundle
        model, batch = get_bundle("two-tower-retrieval-jpq").make_smoke(
            device="cpu")
        p = model.params()
        req = next(T_serve.make_requests(
            {k: v for k, v in batch.items() if k != "label"}, 8, 1, 0,
            reserved=(0,)))
        args = T_serve.build_parser().parse_args(
            ["--head", "semantic", "--beams", "64"])
        spec = T_engine.spec_from_args(args, kind="jpq", k=10)
        v, i = model.bind_engine(p, spec).retrieve(
            {k: torch.as_tensor(x) for k, x in req.items()})
        # every id is a real item whose value is its materialised score
        u = model.user_vec(p, torch.as_tensor(req["user_hist"]))
        s = model.emb.logits(p["item_emb"], u)
        assert bool((i != SENT).all())
        np.testing.assert_array_equal(_bits(v),
                                      _bits(s.gather(1, i.long())))

    @pytest.mark.parametrize("layout", ["trainer", "values"])
    def test_ckpt_dir_restores_before_serving(self, layout, tmp_path,
                                              capsys):
        """A checkpoint of the reference's (the Trainer's ``values/``
        layout, or the values tree alone, which the reference's serve CLI
        reads) restores into the port's model before serving."""
        from repro.ckpt import save_checkpoint
        from repro.configs import get_bundle as J_bundle
        from repro_torch.ckpt import restore_values
        from repro_torch.configs import get_bundle
        jm, _, rng = J_bundle("two-tower-retrieval-jpq").make_smoke()
        vals = jax.tree.map(np.asarray, J_nn.values(jm.init_params(
            jax.random.PRNGKey(7))))
        save_checkpoint(str(tmp_path), {"values": vals} if layout ==
                        "trainer" else vals, 5)
        res = T_serve.main(["--device", "cpu", "--requests", "2",
                            "--batch-size", "4", "--ckpt-dir",
                            str(tmp_path)])
        assert f"restored step 5 from {tmp_path}" in capsys.readouterr().out
        assert res["path"] == "fused"
        model, _ = get_bundle("two-tower-retrieval-jpq").make_smoke(
            device="cpu")
        p = model.params()
        assert restore_values(str(tmp_path), p) == 5
        np.testing.assert_array_equal(
            p["item_emb"]["centroids"].detach().numpy(),
            vals["item_emb"]["centroids"])
        np.testing.assert_array_equal(p["item_emb"]["codes"].numpy(),
                                      vals["item_emb"]["codes"])
        assert os.listdir(tmp_path) == ["step_0000000005"]
