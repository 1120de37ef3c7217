"""Parity of the port's SASRec (repro_torch.models.sequential) and the
layers it is built from (nn/layers, nn/attention) with the JAX
reference, on the CPU, on weights bridged from the reference's own
``init_params``.

Tolerances: fp32 products and sums are taken in another order than
XLA's, so values agree to a few ulps of their scale: layers within
1e-6 (1e-5 after attention), the model's loss within 1e-5 relative,
each gradient within 1e-4 of its largest entry, and ``score_last``
within 1e-5 (the masked pad/[MASK] columns exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingConfig as J_EC
from repro.models.sequential import SeqRecConfig as J_Cfg
from repro.models.sequential import SeqRecModel as J_Model
from repro.nn import attention as J_attn
from repro.nn import layers as J_L
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.models import sequential as T_seq
from repro_torch.nn import attention as T_attn
from repro_torch.nn import layers as T_L

KW = dict(arch="sasrec", n_items=400, max_len=12, d_model=32, n_layers=2,
          n_heads=2, d_ff=64)


def _tensors(tree):
    """numpy values tree -> the same tree of torch tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def _seq_batch(seed, B=3, S=12, n_items=400):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, n_items + 1, (B, S))
    for r in range(B):
        seq[r, : 2 + 3 * r] = 0                      # left padding
    labels = np.roll(seq, -1, 1)
    labels[:, -1] = rng.integers(1, n_items + 1, B)
    labels[seq == 0] = 0
    return seq, labels


def test_fan_matches_reference():
    for shape, ia, oa in [((5, 7), -2, -1), ((32, 2, 16), 0, 2),
                          ((2, 16, 32), 1, 2), ((9,), -2, -1)]:
        assert T_L.fan(shape, ia, oa) == J_nn._fan(shape, ia, oa)


def test_layernorm_and_dense_mlp():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    ln = {"scale": rng.standard_normal(32).astype(np.float32),
          "bias": rng.standard_normal(32).astype(np.float32)}
    jln = {k: J_nn.P(jnp.asarray(v), None) for k, v in ln.items()}
    np.testing.assert_allclose(
        np.asarray(J_L.layernorm(jln, jnp.asarray(x))),
        T_L.layernorm(_tensors(ln), torch.tensor(x)).numpy(),
        rtol=0, atol=1e-6)
    z = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jax.nn.gelu(jnp.asarray(z))),
                               T_L.gelu(torch.tensor(z)).numpy(), rtol=0,
                               atol=1e-6)
    jm = J_L.dense_mlp_init(J_nn.KeyGen(1), 32, 64)
    vals = jax.tree.map(np.asarray, J_nn.values(jm))
    np.testing.assert_allclose(
        np.asarray(J_L.dense_mlp(jm, jnp.asarray(x))),
        T_L.dense_mlp(_tensors(vals), torch.tensor(x)).numpy(), rtol=0,
        atol=1e-5)


def test_attention_causal_and_padding():
    cfg = dict(d_model=32, n_heads=4, n_kv=4, head_dim=8, causal=True,
               rope=False)
    jp = J_attn.attention_init(J_nn.KeyGen(2), J_attn.AttnConfig(**cfg))
    vals = jax.tree.map(np.asarray, J_nn.values(jp))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 10, 32)).astype(np.float32)
    pad = np.ones((3, 10), bool)
    pad[0, :4] = False                               # left padding
    pad[2, :9] = False
    want = J_attn.attention(jp, J_attn.AttnConfig(**cfg), jnp.asarray(x),
                            pad_mask=jnp.asarray(pad))
    got = T_attn.attention(_tensors(vals), T_attn.AttnConfig(**cfg),
                           torch.tensor(x), pad_mask=torch.tensor(pad))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                               atol=1e-5)


def test_attention_options_not_ported_raise():
    """Nothing of the attention raises since the LM slice ported every
    option and the KV cache (held against the reference in
    tests/test_torch_lm_layers.py): the RoPE config that raised here
    draws its weights, and the cache decodes a token."""
    cfg = T_attn.AttnConfig(d_model=8, n_heads=2, n_kv=2, head_dim=4)
    p = T_attn.attention_init(torch.Generator(), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (8, 2, 4), "wk": (8, 2, 4), "wv": (8, 2, 4), "wo": (2, 4, 8)}
    cache = T_attn.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    out, cache = T_attn.decode_step(p, cfg, torch.randn(2, 1, 8), cache)
    assert out.shape == (2, 1, 8) and int(cache["pos"]) == 1
    assert bool(torch.isfinite(out).all())


def _pair(use_kernel, kind="jpq", seed=0):
    codes = np.random.default_rng(seed).integers(0, 16, (402, 4)).astype(
        np.int32)
    jemb = J_EC(0, 0, kind=kind, m=4, b=16)
    temb = T_EC(0, 0, kind=kind, m=4, b=16, use_kernel=use_kernel)
    jm = J_Model(J_Cfg(embedding=jemb, **KW),
                 codes=codes if kind == "jpq" else None)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = T_seq.SeqRecModel(T_seq.SeqRecConfig(embedding=temb, **KW),
                           codes=codes if kind == "jpq" else None,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    return jm, jp, tm


def test_bridged_tree_is_the_reference_tree():
    """load_values takes the reference's SeqRec tree (pos_emb a leaf,
    blocks a list of ln1/attn/ln2/mlp, ln_f) and the weights arrive
    bit-identical."""
    jm, jp, tm = _pair(True)
    want = jax.tree.map(np.asarray, J_nn.values(jp))
    got = tm.params()
    np.testing.assert_array_equal(want["pos_emb"],
                                  got["pos_emb"].detach().numpy())
    np.testing.assert_array_equal(
        want["blocks"][1]["attn"]["wo"],
        got["blocks"][1]["attn"]["wo"].detach().numpy())
    np.testing.assert_array_equal(want["item_emb"]["codes"],
                                  got["item_emb"]["codes"].numpy())
    assert got["item_emb"]["codes"].dtype == torch.uint8
    assert sum(1 for _ in tm.parameters()) == len(
        [x for x in jax.tree.leaves(want) if x.dtype == np.float32])


@pytest.mark.parametrize("kind,use_kernel", [("jpq", True), ("jpq", False),
                                             ("full", False)])
def test_sasrec_loss_grads_and_scores(kind, use_kernel):
    jm, jp, tm = _pair(use_kernel, kind)
    seq, labels = _seq_batch(4)
    jb = {"seq": jnp.asarray(seq), "labels": jnp.asarray(labels)}

    def j_loss(v):
        return jm.train_loss(J_nn.with_values(jp, v), jb)[0]

    jl, jg = jax.value_and_grad(j_loss, allow_int=True)(J_nn.values(jp))
    p = tm.params()
    tl, mets = tm.train_loss(p, {"seq": torch.tensor(seq),
                                 "labels": torch.tensor(labels)})
    tl.backward()
    assert abs(float(jl) - float(mets["loss"])) <= 1e-5 * abs(float(jl))
    flat_j = jax.tree_util.tree_leaves_with_path(jg)
    n = 0
    for path, g in flat_j:
        if g.dtype == jax.dtypes.float0:
            continue
        node = p
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        g = np.asarray(g)
        err = np.abs(g - node.grad.numpy()).max()
        assert err <= 1e-4 * np.abs(g).max() + 1e-9, (path, err)
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    with torch.no_grad():
        got = tm.score_last(p, torch.tensor(seq)).numpy()
    want = np.asarray(jm.score_last(jp, jnp.asarray(seq)))
    np.testing.assert_allclose(want, got, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(want[:, [0, -1]], got[:, [0, -1]])


def test_dropout_draws_from_the_generator():
    tm = T_seq.SeqRecModel(
        T_seq.SeqRecConfig(embedding=T_EC(0, 0, kind="jpq", m=4, b=16),
                           **{**KW, "dropout": 0.3}),
        generator=torch.Generator().manual_seed(0), device="cpu")
    seq = torch.tensor(_seq_batch(5)[0])
    p = tm.params()
    with torch.no_grad():
        plain = tm.encode(p, seq)
        a = tm.encode(p, seq, generator=torch.Generator().manual_seed(1))
        b = tm.encode(p, seq, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert bool(torch.isfinite(a).all())
