"""Parity of the port's CTR recommenders (repro_torch: nn/recurrent,
data/clicks, models/recsys FM / DLRM / DIEN, configs, launch/serve) with
the JAX reference, on the CPU.

The reference's smoke models are initialised by the reference, their
``nn.values()`` trees bridged into the port's models, and both serve
the same arrays.  Tolerances (fp32; the port's products and sums run in
another order than XLA's, and the GRUs carry the difference through
their recurrences):
- ``gru_cell`` / ``gru_scan`` and every model output: rtol 1e-5,
  atol 1e-6 (measured: at most 3.0e-7 on these inputs);
- data (``SyntheticClicks``, ``dien_batch``): array-equal;
- the bridged trees: bit-identical.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as J_bundle
from repro.configs import registry as J_registry
from repro.data import clicks as J_clicks
from repro.data.sequences import SeqDataConfig as J_SDC
from repro.data.sequences import SyntheticSequences as J_Seq
from repro.models import recsys as J_recsys
from repro.nn import module as J_nn
from repro.nn import recurrent as J_rnn
from repro_torch import bridge
from repro_torch.configs import get_bundle as T_bundle
from repro_torch.configs import list_archs
from repro_torch.configs import recsys_archs as T_archs
from repro_torch.core import full as T_full
from repro_torch.data import clicks as T_clicks
from repro_torch.data.sequences import SeqDataConfig as T_SDC
from repro_torch.data.sequences import SyntheticSequences as T_Seq
from repro_torch.models import recsys as T_recsys
from repro_torch.nn import layers as T_L
from repro_torch.nn import recurrent as T_rnn

RTOL, ATOL = 1e-5, 1e-6
CTR = ["fm", "fm-jpq", "dlrm-rm2", "dlrm-rm2-jpq", "dien", "dien-jpq"]
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


_PAIRS = {}


def _pair(name):
    """(reference model, its params, the port's model on the bridged
    values, the values tree, the smoke batch); cached, read only."""
    if name not in _PAIRS:
        jm, batch, rng = J_bundle(name).make_smoke()
        jp = jm.init_params(rng)
        values = jax.tree.map(np.asarray, J_nn.values(jp))
        tm, tbatch = T_bundle(name).make_smoke(device="cpu", seed=1)
        bridge.load_values(tm, values)
        _PAIRS[name] = (jm, jp, tm, values,
                        {k: np.array(v) for k, v in batch.items()}, tbatch)
    return _PAIRS[name]


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ========================================================= nn/recurrent

def _gru_params(rng, d_in, d_h):
    p = {"wx": rng.standard_normal((d_in, 3 * d_h)) * 0.3,
         "wh": rng.standard_normal((d_h, 3 * d_h)) * 0.3,
         "b": rng.standard_normal(3 * d_h) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jp = {k: J_nn.P(jnp.asarray(v), None) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    return jp, tp


def test_gru_cell_matches_reference():
    rng = np.random.default_rng(0)
    jp, tp = _gru_params(rng, 7, 12)
    h = rng.standard_normal((5, 12)).astype(np.float32)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    a = rng.random(5).astype(np.float32)
    _close(T_rnn.gru_cell(tp, torch.from_numpy(h), torch.from_numpy(x)),
           J_rnn.gru_cell(jp, jnp.asarray(h), jnp.asarray(x)))
    _close(T_rnn.gru_cell(tp, torch.from_numpy(h), torch.from_numpy(x),
                          torch.from_numpy(a)),
           J_rnn.gru_cell(jp, jnp.asarray(h), jnp.asarray(x),
                          jnp.asarray(a)))


@pytest.mark.parametrize("augru", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0", [False, True])
def test_gru_scan_matches_reference(augru, reverse, h0):
    rng = np.random.default_rng(1)
    B, S, d_in, d_h = 4, 9, 6, 10
    jp, tp = _gru_params(rng, d_in, d_h)
    xs = rng.standard_normal((B, S, d_in)).astype(np.float32)
    attn = rng.random((B, S)).astype(np.float32) if augru else None
    h = rng.standard_normal((B, d_h)).astype(np.float32) if h0 else None
    jhs, jlast = J_rnn.gru_scan(
        jp, jnp.asarray(xs), None if h is None else jnp.asarray(h),
        None if attn is None else jnp.asarray(attn), reverse=reverse)
    ths, tlast = T_rnn.gru_scan(
        tp, torch.from_numpy(xs), None if h is None else torch.from_numpy(h),
        None if attn is None else torch.from_numpy(attn), reverse=reverse)
    _close(ths, jhs)
    _close(tlast, jlast)


def test_gru_init_and_glorot_normal():
    """The reference's shapes and scale: truncated normal on [-2, 2]
    times sqrt(2 / (fan_in + fan_out)); zero bias."""
    g = torch.Generator().manual_seed(0)
    p = T_rnn.gru_init(g, 18, 108, device="cpu")
    jp = J_rnn.gru_init(J_nn.KeyGen(jax.random.PRNGKey(0)), 18, 108)
    for k in ("wx", "wh", "b"):
        assert tuple(p[k].shape) == tuple(jp[k].value.shape)
    assert torch.count_nonzero(p["b"]) == 0
    w = T_L.glorot_normal(g, (400, 600), device="cpu")
    std = np.sqrt(2.0 / 1000)
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    # the std of a unit normal truncated to [-2, 2] is 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01


# ============================================================ data/clicks

@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_clicks_array_equal(seed):
    vocabs = (1000, 50, 7, 123_456)
    jd = J_clicks.SyntheticClicks(J_clicks.ClickDataConfig(
        n_dense=13, vocab_sizes=vocabs, seed=seed))
    td = T_clicks.SyntheticClicks(T_clicks.ClickDataConfig(
        n_dense=13, vocab_sizes=vocabs, seed=seed))
    np.testing.assert_array_equal(td.w_sparse, jd.w_sparse)
    for step in (0, 5):
        a, b = jd.batch(step, 64), td.batch(step, 64)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 2])
def test_dien_batch_array_equal(seed):
    kw = dict(n_users=60, n_items=300, seed=seed)
    jd, td = J_Seq(J_SDC(**kw)), T_Seq(T_SDC(**kw))
    for step in (0, 1):
        a = J_clicks.dien_batch(jd, step, 16, 12)
        b = T_clicks.dien_batch(td, step, 16, 12)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ======================================================= configs/registry

def test_registry_lists_the_ctr_archs():
    archs = list_archs()
    for name in CTR:
        assert name in archs
        assert name in J_registry.list_archs()
        assert T_bundle(name).name == name


def test_full_width_configs_match_reference():
    from repro.configs import recsys_archs as J_archs
    assert T_archs.FM_VOCABS == J_archs.FM_VOCABS
    assert T_archs.DLRM_VOCABS == J_archs.DLRM_VOCABS
    assert sum(T_archs.DLRM_VOCABS) == 223_220_000
    assert sum(T_archs.FM_VOCABS) == 3_090_000


def test_smoke_templates_draw_for_draw():
    for name in CTR:
        _, jbatch, _ = J_bundle(name).make_smoke()
        _, tbatch = T_bundle(name).make_smoke(device="cpu")
        assert set(jbatch) == set(tbatch)
        for k in jbatch:
            np.testing.assert_array_equal(np.asarray(jbatch[k]), tbatch[k])


# ================================================== models (bridged)

@pytest.mark.parametrize("name", CTR)
def test_bridged_tree_bit_identical(name):
    _, _, tm, values, _, _ = _pair(name)
    flat_t = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tm.params()))
    flat_j = jax.tree.leaves(values)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


@pytest.mark.parametrize("name", CTR)
def test_serve_matches_reference(name):
    jm, jp, tm, _, batch, _ = _pair(name)
    want = jm.serve(jp, _jnp(batch))
    got = tm.serve(tm.params(), batch)
    _close(got, want)
    assert got.shape == want.shape
    assert bool(((got >= 0) & (got <= 1)).all())


@pytest.mark.parametrize("name", ["fm", "fm-jpq", "dlrm-rm2", "dlrm-rm2-jpq"])
def test_scores_match_reference(name):
    jm, jp, tm, _, batch, _ = _pair(name)
    if name.startswith("fm"):
        want = jm.scores(jp, jnp.asarray(batch["sparse"]))
        got = tm.scores(tm.params(), batch["sparse"])
    else:
        want = jm.scores(jp, jnp.asarray(batch["dense"]),
                         jnp.asarray(batch["sparse"]))
        got = tm.scores(tm.params(), batch["dense"], batch["sparse"])
    _close(got, want)


@pytest.mark.parametrize("name", ["fm", "fm-jpq"])
def test_fm_candidate_scores_match_reference(name):
    jm, jp, tm, _, _, _ = _pair(name)
    rest = np.random.default_rng(5).integers(0, 64, (3, 5))
    want = jm.candidate_scores(jp, {"sparse_rest": jnp.asarray(rest)})
    got = tm.candidate_scores(tm.params(), {"sparse_rest": rest})
    assert got.shape == (3, 64)
    _close(got, want)


@pytest.mark.parametrize("name", ["dlrm-rm2", "dlrm-rm2-jpq"])
def test_dlrm_score_candidates_match_reference(name):
    jm, jp, tm, _, _, _ = _pair(name)
    rng = np.random.default_rng(6)
    b = {"dense": rng.standard_normal((1, 5)).astype(np.float32),
         "sparse_rest": rng.integers(0, 32, (1, 3)),
         "candidates": rng.integers(0, 128, (40,))}
    want = jm.score_candidates(jp, _jnp(b), chunk=8)
    got = tm.score_candidates(tm.params(), b, chunk=8)
    assert got.shape == (40,)
    _close(got, want)
    with pytest.raises(ValueError, match="divide"):
        tm.score_candidates(tm.params(), b, chunk=7)


@pytest.mark.parametrize("name", ["dien", "dien-jpq"])
def test_dien_score_candidates_match_reference(name):
    jm, jp, tm, _, _, _ = _pair(name)
    rng = np.random.default_rng(7)
    hist = rng.integers(0, 101, (1, 10))
    hist[0, :3] = 0
    b = {"hist": hist, "candidates": rng.integers(1, 101, (30,))}
    want = jm.score_candidates(jp, _jnp(b), chunk=10)
    got = tm.score_candidates(tm.params(), b, chunk=10)
    assert got.shape == (30,)
    _close(got, want)


def test_fm_linear_term_goes_through_embedding_bag(monkeypatch):
    """FM's linear term is the fixed-fanout bag over ``linear`` as a
    [V, 1] table, with unit weights."""
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    _, _, tm, _, batch, _ = _pair("fm")
    calls = []
    real = bag_ops.embedding_bag

    def spy(table, ids, weights=None, **kw):
        calls.append((tuple(table.shape), tuple(ids.shape), weights))
        return real(table, ids, weights, **kw)

    monkeypatch.setattr(bag_ops, "embedding_bag", spy)
    tm.serve(tm.params(), batch)
    V = sum(tm.cfg.vocabs())
    assert calls == [((V, 1), batch["sparse"].shape, None)]


def test_bce_matches_reference():
    rng = np.random.default_rng(8)
    logit = (rng.standard_normal(50) * 5).astype(np.float32)
    y = rng.integers(0, 2, 50).astype(np.float32)
    _close(T_recsys._bce(torch.from_numpy(logit), torch.from_numpy(y)),
           J_recsys._bce(jnp.asarray(logit), jnp.asarray(y)))


# ============================================================ core/full

def test_full_init_scales_in_place(monkeypatch):
    """The table is scaled in place: the same bits as ``scale * randn``,
    and the returned table is the very tensor ``randn`` made (one copy
    of the table during the init)."""
    made = []
    real = torch.randn

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch, "randn", spy)
    tab = T_full.init(torch.Generator().manual_seed(3), 500, 16,
                      device="cpu")["table"]
    monkeypatch.undo()
    want = 16 ** -0.5 * torch.randn((500, 16),
                                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(tab.view(torch.int32), want.view(torch.int32))
    assert len(made) == 1 and tab.data_ptr() == made[0].data_ptr()


# ============================================================ launch/serve

def test_serve_cli_fm_path_serve():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "fm", "--device", "cpu", "--requests", "3",
                        "--batch-size", "16"], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "path=serve" in r.stdout and "fm:" in r.stdout


@pytest.mark.parametrize("name", ["dlrm-rm2", "dien-jpq"])
def test_serve_loop_takes_a_request_stream(name):
    """A given request iterator replaces the template draws; the CTR
    path is labelled ``serve`` and times every request but the first."""
    from repro_torch.launch import serve as T_serve
    _, _, tm, _, batch, _ = _pair(name)
    args = T_serve.build_parser().parse_args(
        ["--arch", name, "--requests", "2", "--device", "cpu"])
    seen = []

    def stream():
        for i in range(3):
            seen.append(i)
            yield batch

    res = T_serve.serve_loop(tm, tm.params(), None, args, requests=stream())
    assert seen == [0, 1, 2]
    assert res["path"] == "serve" and res["n"] == 2
    assert res["skip"] is None and res["p50_ms"] > 0
    assert len(res["lat_ms"]) == 2 and min(res["lat_ms"]) > 0
