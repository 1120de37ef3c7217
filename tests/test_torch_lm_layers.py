"""The LM's layers in the port (``repro_torch.nn.layers``: RMSNorm, RoPE,
the SwiGLU FFN; ``nn/module.stack_params`` / ``unstack_params``; the
attention options of ``nn/attention.py``: GQA, qk-norm, RoPE, windows,
query blocking, the pad mask, and the KV-cache decode) against the JAX
reference on the CPU, inputs drawn from numpy seeds and the reference's
parameters carried across.

Tolerances (fp32; the two sum in other orders):
- forwards within 1e-5 of the largest magnitude of the reference's
  output (measured: at most 3.6e-7);
- RoPE: the frequencies bit-equal (``rope_freqs`` rounds the power from
  float64 as XLA's fp32 ``pow`` does), the angles bit-equal, sin and
  cos within 1.2e-7 absolute (two fp32 ulps of 1; measured: one ulp,
  6e-8, at positions up to 524,287).  These are the reference's eager
  bits: jitted, XLA folds the frequencies another way (1 to 13 ulps off
  in 2 to 32 of them, jax 0.9.0 on the CPU), which moves sin by up to
  0.031 at 524,287, so the long-position cases run the reference eager;
- the port's blocked attention within 1e-6 of its unblocked attention
  (measured: equal);
- the KV cache after each decode step: ``pos`` equal, ``k``/``v`` within
  1e-5 of their largest magnitude (fp32 caches: a new key one ulp off
  can round to another bf16 value, which moves the output ~1e-3); a
  bf16 cache carried across is copied bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as J_attn
from repro.nn import layers as J_L
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch.nn import attention as T_attn
from repro_torch.nn import layers as T_L
from repro_torch.nn import module as T_nn


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{err} > {tol} x {scale}"


def _values(tree):
    return jax.tree.map(lambda v: _t(np.asarray(v)), J_nn.values(tree))


# ------------------------------------------------------------ layers

def test_rmsnorm():
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 5, 24)).astype(np.float32) * 3
    scale = r.standard_normal(24).astype(np.float32)
    want = J_L.rmsnorm({"scale": J_nn.P(jnp.asarray(scale))}, jnp.asarray(x))
    got = T_L.rmsnorm({"scale": _t(scale)}, _t(x))
    _close(got, want)
    assert T_L.rmsnorm({"scale": _t(scale)}, _t(x).bfloat16()).dtype \
        == torch.bfloat16


def test_make_norm():
    for kind in ("rmsnorm", "layernorm"):
        p, fn = T_L.make_norm(kind, 8, device="cpu")
        jp, jfn = J_L.make_norm(kind, 8)
        assert set(p) == set(jp)
        x = np.random.default_rng(1).standard_normal((2, 8)).astype(
            np.float32)
        _close(fn(p, _t(x)), jfn(jp, jnp.asarray(x)))
    with pytest.raises(ValueError):
        T_L.make_norm("batchnorm", 8)


POSITIONS = np.concatenate([np.arange(65), np.arange(524_224, 524_288)])


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("head_dim", [16, 64, 128, 160])
def test_rope_angles(theta, head_dim):
    """Every published head_dim (64, 128, 160) and the smoke configs'
    16, at positions 0..64 and 524,224..524,287."""
    pos = POSITIONS.astype(np.int32)[None]
    half = head_dim // 2
    jf = np.asarray(1.0 / (theta ** (jnp.arange(half, dtype=jnp.float32)
                                     / half)))
    tf = T_L.rope_freqs(head_dim, theta, "cpu").numpy()
    assert np.array_equal(jf.view(np.int32), tf.view(np.int32))
    js, jc = J_L.rope_angles(jnp.asarray(pos), head_dim, theta)
    ts, tc = T_L.rope_angles(_t(pos), head_dim, theta)
    assert ts.dtype == torch.float32 and ts.shape == (1, len(POSITIONS),
                                                      half)
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1.2e-7
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1.2e-7


def test_apply_rope_half_split():
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None] + 524_000
    js, jc = J_L.rope_angles(jnp.asarray(pos), 16, 1e6)
    want = J_L.apply_rope(jnp.asarray(x), js, jc)
    ts, tc = T_L.rope_angles(_t(pos), 16, 1e6)
    _close(T_L.apply_rope(_t(x), ts, tc), want)
    # bf16 in, bf16 out (computed in fp32 with the fp32 angles)
    assert T_L.apply_rope(_t(x).bfloat16(), ts, tc).dtype == torch.bfloat16


def test_gated_mlp():
    kg = J_nn.KeyGen(3)
    jp = J_L.gated_mlp_init(kg, 24, 40)
    x = np.random.default_rng(3).standard_normal((2, 5, 24)).astype(
        np.float32)
    want = J_L.gated_mlp(jp, jnp.asarray(x))
    _close(T_L.gated_mlp(_values(jp), _t(x)), want)
    tp = T_L.gated_mlp_init(torch.Generator().manual_seed(0), 24, 40,
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_stack_and_unstack_params():
    kg = J_nn.KeyGen(4)
    cfg = J_attn.AttnConfig(d_model=16, n_heads=4, n_kv=2, head_dim=4,
                            qk_norm=True)
    layers = [{"ln": J_L.rmsnorm_init(16), "attn": J_attn.attention_init(
        kg, cfg)} for _ in range(3)]
    want = J_nn.values(J_nn.stack_params(layers))
    got = T_nn.stack_params([_values(t) for t in layers])
    for path, a in _walk(got):
        b = np.asarray(_at(want, path))
        assert a.shape == b.shape and np.array_equal(a.numpy(), b), path
    back = T_nn.unstack_params(got)
    assert len(back) == 3
    for i, layer in enumerate(back):
        for path, a in _walk(layer):
            assert np.array_equal(a.numpy(), np.asarray(
                _at(J_nn.values(layers[i]), path))), (i, path)
    # the views' gradients reach the stack in one piece
    stack = torch.zeros((3, 2), requires_grad=True)
    parts = T_nn.unstack_params({"w": stack})
    sum(p["w"].sum() * (i + 1) for i, p in enumerate(parts)).backward()
    assert stack.grad.tolist() == [[1, 1], [2, 2], [3, 3]]


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------- attention

B, S, D = 2, 16, 32
ATTN_CASES = {
    "mha": dict(n_heads=4, n_kv=4, head_dim=8),
    "gqa_4_2": dict(n_heads=4, n_kv=2, head_dim=8),
    "qk_norm": dict(n_heads=4, n_kv=2, head_dim=8, qk_norm=True),
    "window_4": dict(n_heads=4, n_kv=2, head_dim=8, window=4),
    "q_chunk_4": dict(n_heads=4, n_kv=2, head_dim=8, q_chunk=4,
                      window=6, rope_theta=1e6),
    "pad_mask": dict(n_heads=4, n_kv=2, head_dim=8, qk_norm=True),
}


def _attn_pair(case, seed=0):
    cfg = dict(ATTN_CASES[case])
    jcfg = J_attn.AttnConfig(d_model=D, **cfg)
    tcfg = T_attn.AttnConfig(d_model=D, **cfg)
    jp = J_attn.attention_init(J_nn.KeyGen(seed), jcfg)
    return jcfg, tcfg, jp, _values(jp)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    jcfg, tcfg, jp, tp = _attn_pair(case)
    r = np.random.default_rng(5)
    x = r.standard_normal((B, S, D)).astype(np.float32)
    pad = None
    if case == "pad_mask":
        pad = r.random((B, S)) < 0.7
        pad[:, 0] = True
    want = J_attn.attention(jp, jcfg, jnp.asarray(x),
                            pad_mask=None if pad is None else
                            jnp.asarray(pad))
    got = T_attn.attention(tp, tcfg, _t(x),
                           pad_mask=None if pad is None else _t(pad))
    _close(got, want)
    tq = T_attn.attention_init(torch.Generator().manual_seed(0), tcfg,
                               device="cpu")
    assert {k: tuple(_leaf(v).shape) for k, v in tq.items()} == \
        {k: tuple(_leaf(v).shape) for k, v in tp.items()}


def _leaf(v):
    return v["scale"] if isinstance(v, dict) else v


def test_blocked_attention_equals_unblocked():
    _, tcfg, _, tp = _attn_pair("q_chunk_4")
    x = _t(np.random.default_rng(6).standard_normal((1, S, D)).astype(
        np.float32))
    blocked = T_attn.attention(tp, tcfg, x)
    import dataclasses
    plain = T_attn.attention(tp, dataclasses.replace(tcfg, q_chunk=None), x)
    scale = float(plain.abs().max())
    assert float((blocked - plain).abs().max()) <= 1e-6 * scale


def _decode_pair(window, theta, max_len, dtype):
    cfg = dict(n_heads=4, n_kv=2, head_dim=8, qk_norm=True, window=window,
               rope_theta=theta)
    jcfg = J_attn.AttnConfig(d_model=D, **cfg)
    tcfg = T_attn.AttnConfig(d_model=D, **cfg)
    jp = J_attn.attention_init(J_nn.KeyGen(7), jcfg)
    jc = J_attn.init_cache(jcfg, B, max_len, dtype)
    tc = T_attn.init_cache(tcfg, B, max_len, device="cpu",
                           dtype=getattr(torch, jnp.dtype(dtype).name))
    return jcfg, tcfg, jp, _values(jp), jc, tc


def _cache_close(tc, jc):
    assert int(tc["pos"]) == int(jc["pos"])
    for k in ("k", "v"):
        _close(tc[k].float(), np.asarray(jc[k]).astype(np.float32))


def test_decode_ring_wrap_matches_reference():
    """window 4 (a 4-slot ring) for 12 steps: every output, and the
    cache the port updated in place against the reference's new cache
    after every step."""
    jcfg, tcfg, jp, tp, jc, tc = _decode_pair(4, 1e4, 12, jnp.float32)
    assert tc["k"].shape == (B, 4, 2, 8)
    step = jax.jit(lambda c, x: J_attn.decode_step(jp, jcfg, x, c))
    xs = np.random.default_rng(8).standard_normal((12, B, 1, D)).astype(
        np.float32)
    for t in range(12):
        want, jc = step(jc, jnp.asarray(xs[t]))
        got, tc2 = T_attn.decode_step(tp, tcfg, _t(xs[t]), tc)
        assert tc2 is tc
        _close(got, want)
        _cache_close(tc, jc)


def test_decode_from_a_reference_cache_at_524280():
    """A ring cache the reference holds at position 524,280 (theta 1e6,
    window 8, fp32 so that no bf16 rounding of a new key hides behind
    the tolerance) carried across by ``bridge.load_caches``, then 8 more
    steps on both sides."""
    jcfg, tcfg, jp, tp, jc, tc = _decode_pair(8, 1e6, 524_288,
                                              jnp.float32)
    r = np.random.default_rng(9)
    jc = {"k": jnp.asarray(r.standard_normal(jc["k"].shape), jnp.float32),
          "v": jnp.asarray(r.standard_normal(jc["v"].shape), jnp.float32),
          "pos": jnp.asarray(524_280, jnp.int32)}
    bridge.load_caches(tc, jax.tree.map(np.asarray, jc))
    assert int(tc["pos"]) == 524_280 and tc["k"].shape[1] == 8
    xs = r.standard_normal((8, B, 1, D)).astype(np.float32)
    for t in range(8):
        # eager: under jit XLA rounds up to 13 of the frequencies another
        # ulp, which moves sin by up to 0.03 here (see the docstring)
        want, jc = J_attn.decode_step(jp, jcfg, jnp.asarray(xs[t]), jc)
        got, _ = T_attn.decode_step(tp, tcfg, _t(xs[t]), tc)
        _close(got, want)
        _cache_close(tc, jc)
    assert int(tc["pos"]) == 524_288


def test_load_caches_carries_bf16_bits():
    """The reference's bf16 cache arrives bit for bit; a wrong shape or
    dtype raises."""
    jcfg, tcfg, _, _, jc, tc = _decode_pair(8, 1e6, 524_288, jnp.bfloat16)
    r = np.random.default_rng(10)
    src = {"k": np.asarray(jnp.asarray(r.standard_normal(jc["k"].shape),
                                       jnp.bfloat16)),
           "v": np.asarray(jnp.asarray(r.standard_normal(jc["v"].shape),
                                       jnp.bfloat16)),
           "pos": np.asarray(524_280, np.int32)}
    bridge.load_caches(tc, src)
    for k in ("k", "v"):
        assert np.array_equal(tc[k].view(torch.int16).numpy(),
                              src[k].view(np.int16))
    assert int(tc["pos"]) == 524_280
    with pytest.raises(ValueError, match="bfloat16"):
        bridge.load_caches(tc, {**src, "k": src["k"].astype(np.float32)})
