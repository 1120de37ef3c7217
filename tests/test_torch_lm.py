"""The port's decoder-only LM (``repro_torch.models.lm.TransformerLM``)
against the JAX reference (``repro.models.lm``) on the CPU, for each of
the five LM bundles' ``SMOKE`` configs and a RecJPQ vocabulary (m 4,
b 16, as the reference's ``test_jpq_vocab_embedding``; the port's with
``use_kernel=True``, so the tied softmax and the lookup run the
jpq_scores and jpq_lookup kernels' plain versions): the reference's
smoke parameters carried across with ``bridge.load_values``, the
bundles' numpy batch.

Tolerances (fp32):
- ``hidden_states``, ``logits``, each ``decode_step``'s logits, the
  loss, ``ce`` and ``aux``: within 1e-5 of the largest magnitude of the
  reference's (measured: at most 1.0e-6);
- the caches after the decode loop: ``pos`` equal, ``k`` / ``v`` within
  1e-5 of their largest magnitude;
- gradients against ``jax.grad``, by the rule of
  ``tests/test_torch_recsys_train.py``: each leaf within 1e-5 of its
  largest entry, or 1e-6 of the whole gradient's largest, whichever is
  larger;
- ``scan_layers`` and ``remat`` on and off in the port: the hidden
  states within 1e-6 of their largest magnitude, the gradients by the
  rule above.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as J_bundle
from repro.core import EmbeddingConfig as J_EC
from repro.models.lm import LMConfig as J_LMConfig
from repro.models.lm import TransformerLM as J_LM
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch.configs import get_bundle as T_bundle
from repro_torch.configs.registry import LM_ARCHS
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.models.lm import LMConfig as T_LMConfig
from repro_torch.models.lm import TransformerLM as T_LM
from repro_torch.nn.module import tree_leaves
from repro_torch.train.optimizer import tree_map

JPQ = "jpq-vocab"
CASES = list(LM_ARCHS) + [JPQ]


def _jpq_cfgs():
    kw = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv=2,
              d_ff=64, vocab=100, compute_dtype="float32")
    return (J_LMConfig(embedding=J_EC(0, 0, kind="jpq", m=4, b=16), **kw),
            T_LMConfig(embedding=T_EC(0, 0, kind="jpq", m=4, b=16,
                                      use_kernel=True), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, J_nn.values(tree))


_PAIRS = {}


def _pair(name):
    """(reference model, its params, the port's model on the bridged
    values, the numpy batch), cached; read only."""
    if name in _PAIRS:
        return _PAIRS[name]
    if name == JPQ:
        jcfg, tcfg = _jpq_cfgs()
        jm = J_LM(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = T_LM(tcfg, device="cpu")
        r = np.random.default_rng(0)
        batch = {"tokens": r.integers(0, 100, (2, 6)),
                 "targets": r.integers(0, 100, (2, 6))}
    else:
        jm, jb, rng = J_bundle(name).make_smoke()
        jp = jm.init_params(rng)
        tm, batch = T_bundle(name).make_smoke(device="cpu", seed=1)
        for k in batch:
            assert np.array_equal(batch[k], np.asarray(jb[k])), k
    bridge.load_values(tm, _np(jp))
    _PAIRS[name] = (jm, jp, tm, batch)
    return _PAIRS[name]


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", CASES)
def test_forward_and_loss_match_reference(name):
    jm, jp, tm, batch = _pair(name)
    toks = batch["tokens"]
    jh, jaux = jm.hidden_states(jp, jnp.asarray(toks))
    with torch.no_grad():
        th, taux = tm.hidden_states(tm.params(), torch.as_tensor(toks))
        tl = tm.logits(tm.params(), th)
        tloss, tmets = tm.train_loss(tm.params(), _t(batch))
    _close(th, jh)
    _close(taux, jaux)
    _close(tl, jm.logits(jp, jh))
    jloss, jmets = jm.train_loss(jp, _j(batch))
    assert set(tmets) == set(jmets) == {"loss", "ce", "aux"}
    for k in jmets:
        _close(tmets[k], jmets[k])
    _close(tloss, jloss)
    if name == JPQ:
        assert "lm_head" not in tm.params()


def _grads(tm, batch):
    params = tm.params()
    floats = [x for x in tree_leaves(params) if torch.is_floating_point(x)]
    loss, _ = tm.train_loss(params, _t(batch))
    got = torch.autograd.grad(loss, floats)
    by_id = {id(x): g for x, g in zip(floats, got)}
    return tree_map(lambda x: by_id.get(id(x)), params)


def _pairs_by_path(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs_by_path(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs_by_path(x, y, f"{path}/{i}")
    else:
        yield path, a, b


def _grad_rule(pairs):
    pairs = [(p, g, np.asarray(w)) for p, g, w in pairs if g is not None]
    assert len(pairs) >= 5
    floor = 1e-6 * max(float(np.abs(w).max()) for _, _, w in pairs)
    for path, got, want in pairs:
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == want.shape, path
        tol = max(1e-5 * float(np.abs(want).max()), floor)
        assert float(np.abs(got - want).max()) <= tol, path


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax_grad(name):
    jm, jp, tm, batch = _pair(name)

    @jax.jit
    def grad(v, b):
        return jax.grad(lambda vv: jm.train_loss(
            J_nn.with_values(jp, vv), b)[0], allow_int=True)(v)

    jg = grad(J_nn.values(jp), _j(batch))
    tg = _grads(tm, batch)
    pairs = list(_pairs_by_path(tg, jg))
    for path, got, want in pairs:
        if got is None:
            assert "codes" in path
        else:
            assert np.abs(np.asarray(want)).max() > 0, path
    _grad_rule(pairs)


@pytest.mark.parametrize("name", CASES)
def test_decode_loop_matches_reference(name):
    """``init_caches`` then one ``decode_step`` a token over the whole
    batch (mixtral's smoke window 8 wraps its ring at token 8), each
    step's logits against the reference's, and the caches after."""
    jm, jp, tm, batch = _pair(name)
    toks = batch["tokens"]
    B, S = toks.shape
    jc = jm.init_caches(B, S, jnp.float32)
    tc = tm.init_caches(B, S, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(S):
            jl, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            tl, tc2 = tm.decode_step(tm.params(),
                                     torch.as_tensor(toks[:, t:t + 1]), tc)
            assert tc2 is tc
            _close(tl, jl)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [S] * 2
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    pf = tm.prefill(tm.params(), torch.as_tensor(toks))
    _close(pf, jm.prefill(jp, jnp.asarray(toks)))
    # the port's own decode agrees with its full forward (the reference's
    # test_decode_matches_full_forward), at a capacity factor of E / k:
    # the full forward sizes capacity from B·S tokens and decode from B,
    # so at 1.25 an assignment the forward drops is kept by decode
    m = tm
    if tm.cfg.moe is not None:
        moe = tm.cfg.moe
        _, m, _ = _relaid(name, moe=dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k))
    with torch.no_grad():
        h, _ = m.hidden_states(m.params(), torch.as_tensor(toks))
        full = m.logits(m.params(), h)
        cc = m.init_caches(B, S, torch.float32)
        outs = [m.decode_step(m.params(), torch.as_tensor(
            toks[:, t:t + 1]), cc)[0][:, 0] for t in range(S)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def _relaid(name, **changes):
    """The port's model of ``name`` with ``changes`` to its config, on the
    same weights (the stacked blocks unstacked where ``scan_layers`` is
    off)."""
    _, jp, tm, batch = _pair(name)
    cfg = dataclasses.replace(tm.cfg, **changes)
    m = T_LM(cfg, device="cpu")
    values = _np(jp)
    if not cfg.scan_layers:
        values = dict(values)
        values["blocks"] = [jax.tree.map(lambda a: a[i], values["blocks"])
                            for i in range(cfg.n_layers)]
    bridge.load_values(m, values)
    return tm, m, batch


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-14b"])
@pytest.mark.parametrize("change", [{"scan_layers": False},
                                    {"remat": False}])
def test_scan_and_remat_change_nothing(name, change):
    tm, m, batch = _relaid(name, **change)
    if "scan_layers" in change:
        assert isinstance(m.params()["blocks"], list)
    with torch.no_grad():
        h1, a1 = tm.hidden_states(tm.params(), torch.as_tensor(
            batch["tokens"]))
        h2, a2 = m.hidden_states(m.params(), torch.as_tensor(
            batch["tokens"]))
    assert float((h1 - h2).abs().max()) <= 1e-6 * float(h1.abs().max())
    assert float((a1 - a2).abs()) <= 1e-6 * max(float(a1.abs()), 1e-30)
    g1, g2 = _grads(tm, batch), _grads(m, batch)
    if "scan_layers" in change:
        g1 = dict(g1)
        g1["blocks"] = [tree_map(lambda a: a[i], g1["blocks"])
                        for i in range(tm.cfg.n_layers)]
    _grad_rule([(p, a, b.numpy()) for p, a, b in _pairs_by_path(g2, g1)])


@pytest.mark.parametrize("name", CASES)
def test_param_count_and_init(name):
    """``param_count`` against the leaves, the port's tree shaped
    as the reference's, and ``init_params`` redrawing in place."""
    jm, jp, tm, _ = _pair(name)
    cfg = tm.cfg
    actual = sum(x.numel() for x in tree_leaves(tm.params()))
    jactual = sum(x.size for x in jax.tree.leaves(J_nn.values(jp)))
    assert actual == jactual
    assert cfg.param_count() == jm.cfg.param_count()
    if cfg.emb_cfg().kind == "full":
        # the formula leaves out qk-norm's two [Dh] scales a layer
        qk = 2 * cfg.n_layers * cfg.hd if cfg.qk_norm else 0
        assert actual == cfg.param_count() + qk
    assert cfg.active_param_count() == jm.cfg.active_param_count()
    fresh = T_LM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    again = T_LM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(4))
    again.init_params(torch.Generator().manual_seed(3))
    for _, a, b in _pairs_by_path(fresh.params(), again.params()):
        assert torch.equal(a, b)
    for _, a, b in _pairs_by_path(tm.params(), _np(jp)):
        assert tuple(a.shape) == b.shape


def test_full_and_smoke_configs_equal_the_reference():
    import importlib
    for name in LM_ARCHS:
        mod = name.replace("-", "_").replace(".", "_")
        j = importlib.import_module(f"repro.configs.{mod}")
        t = importlib.import_module(f"repro_torch.configs.{mod}")
        for which in ("FULL", "SMOKE"):
            a, b = dataclasses.asdict(getattr(j, which)), \
                dataclasses.asdict(getattr(t, which))
            assert a == b, (name, which)
        assert T_bundle(name).family == "lm"
        assert J_bundle(name).description == T_bundle(name).description
    from repro.configs import lm_common as J_common
    from repro_torch.configs import lm_common as T_common
    for shape in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert getattr(J_common, shape) == getattr(T_common, shape)
    assert T_bundle("mace").family == "gnn"
