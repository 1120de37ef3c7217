"""Parity of the port's BERT4Rec and GRU4Rec (repro_torch.models.sequential)
with the JAX reference, on the CPU, on weights bridged from the
reference's own ``init_params`` with ``dropout=0``; BERT4Rec on the
reference's own ``mask_batch`` output.  The port's ``mask_batch`` draws
from a torch generator, so it is held to its contract alone.

Tolerances, as the SASRec tests: the loss within 1e-5 relative, each
gradient within 1e-4 of its largest entry, ``score_last`` within 1e-5
(the masked pad/[MASK] columns exactly); three adamw Trainer steps give
the reference's loss trajectory within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingConfig as J_EC
from repro.models import sequential as J_seq
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.models import sequential as T_seq
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt

N_ITEMS = 120
KW = dict(n_items=N_ITEMS, max_len=10, d_model=16, n_layers=2, n_heads=2,
          d_ff=32)
ARCHS = ["bert4rec", "gru4rec"]
TABLES = [("full", False), ("jpq", True), ("jpq", False), ("qr", False)]


def _pair(arch, kind, use_kernel, seed=0):
    codes = np.random.default_rng(seed).integers(
        0, 16, (N_ITEMS + 2, 4)).astype(np.int32)
    codes = codes if kind == "jpq" else None
    jm = J_seq.SeqRecModel(J_seq.SeqRecConfig(
        arch=arch, embedding=J_EC(0, 0, kind=kind, m=4, b=16), **KW),
        codes=codes)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = T_seq.SeqRecModel(T_seq.SeqRecConfig(
        arch=arch, embedding=T_EC(0, 0, kind=kind, m=4, b=16,
                                  use_kernel=use_kernel), **KW),
        codes=codes, generator=torch.Generator().manual_seed(seed),
        device="cpu")
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    return jm, jp, tm


def _seq(seed, B=4, S=10):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, N_ITEMS + 1, (B, S))
    for r in range(B):
        seq[r, : 1 + 2 * r] = 0                      # left padding
    return seq


def _batch(jm, arch, seed):
    """The numpy batch both packages take: BERT4Rec's masked by the
    reference's ``mask_batch``."""
    seq = _seq(seed)
    if arch == "bert4rec":
        ms, tg = J_seq.mask_batch(jax.random.PRNGKey(seed), jnp.asarray(seq),
                                  jm.cfg.mask_prob, jm.cfg.mask_id)
        return {"seq": np.array(ms), "targets": np.array(tg)}
    labels = np.roll(seq, -1, 1)
    labels[:, -1] = np.random.default_rng(seed + 1).integers(
        1, N_ITEMS + 1, seq.shape[0])
    labels[seq == 0] = 0
    return {"seq": seq, "labels": labels}


@pytest.mark.parametrize("kind,use_kernel", TABLES,
                         ids=[f"{k}-{'kernel' if u else 'plain'}"
                              for k, u in TABLES])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_scores(arch, kind, use_kernel):
    jm, jp, tm = _pair(arch, kind, use_kernel)
    batch = _batch(jm, arch, 4)
    if arch == "bert4rec":
        assert (batch["seq"] == jm.cfg.mask_id).any()  # [MASK] rows looked up

    def j_loss(v):
        return jm.train_loss(J_nn.with_values(jp, v),
                             jax.tree.map(jnp.asarray, batch))[0]

    jl, jg = jax.value_and_grad(j_loss, allow_int=True)(J_nn.values(jp))
    p = tm.params()
    tl, mets = tm.train_loss(p, {k: torch.tensor(v) for k, v in
                                 batch.items()})
    tl.backward()
    assert abs(float(jl) - float(mets["loss"])) <= 1e-5 * abs(float(jl))
    n = 0
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
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
    seq = _seq(7)
    with torch.no_grad():
        got = tm.score_last(p, torch.tensor(seq)).numpy()
    want = np.asarray(jm.score_last(jp, jnp.asarray(seq)))
    assert got.shape == (seq.shape[0], N_ITEMS + 2)
    np.testing.assert_allclose(want, got, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(want[:, [0, -1]], got[:, [0, -1]])


def test_mask_row_gradient_reaches_its_centroids():
    """BERT4Rec's [MASK] row (id n_items + 1) goes through the jpq_lookup
    path: the gradient of its lookups lands on exactly the centroids its
    codes name, and the logits still never rank it (nor the pad row)."""
    jm, jp, tm = _pair("bert4rec", "jpq", True)
    p = tm.params()
    mask_codes = p["item_emb"]["codes"][jm.cfg.mask_id].long()
    ids = torch.full((3, 5), jm.cfg.mask_id)
    w = torch.randn((3, 5, 16), generator=torch.Generator().manual_seed(0))
    (tm.emb.lookup(p["item_emb"], ids) * w).sum().backward()
    g = p["item_emb"]["centroids"].grad                      # [m, b, dk]
    want = torch.zeros_like(g)
    for j in range(4):
        want[j, mask_codes[j]] = w[..., 4 * j:4 * j + 4].sum((0, 1))
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)
    batch = _batch(jm, "bert4rec", 4)
    with torch.no_grad():
        h = tm.encode(p, torch.tensor(batch["seq"]))
        logits = tm._mask_special(tm.emb.logits(p["item_emb"], h))
    assert bool((logits[..., -1] == T_seq.NEG_INF).all())
    assert bool((logits[..., 0] == T_seq.NEG_INF).all())


def test_serve_seq_appends_the_mask():
    _, _, tm = _pair("bert4rec", "full", False)
    seq = torch.tensor(_seq(2))
    got = tm._serve_seq(seq)
    assert torch.equal(got[:, :-1], seq[:, 1:])
    assert bool((got[:, -1] == tm.cfg.mask_id).all())
    _, _, gm = _pair("gru4rec", "full", False)
    assert gm._serve_seq(seq) is seq


@pytest.mark.parametrize("mask_prob", [0.2, 0.5])
def test_mask_batch_contract(mask_prob):
    """Pads are never masked, the last real item of every row always is,
    targets are the masked items and 0 elsewhere, and the masked share of
    the other items is within 3 sigma of mask_prob over 1e5 positions."""
    rng = np.random.default_rng(0)
    B, S, mask_id = 5_000, 50, 10_001
    seq = rng.integers(1, 10_001, (B, S))
    pad = rng.integers(0, S, B)
    seq[np.arange(S)[None, :] < pad[:, None]] = 0
    seq[:5] = 0                                       # empty rows
    seq[5, -3:] = 0                                   # right padding too
    seq = torch.tensor(seq)
    ms, tg = T_seq.mask_batch(torch.Generator().manual_seed(1), seq,
                              mask_prob, mask_id)
    is_item = seq > 0
    masked = ms == mask_id
    assert not bool((masked & ~is_item).any())
    assert torch.equal(ms[~masked], seq[~masked])
    assert torch.equal(tg[masked], seq[masked])
    assert bool((tg[~masked] == 0).all())
    idx = torch.arange(S)[None, :].expand(B, S)
    last = torch.where(is_item, idx, -1).amax(1)
    rows = last >= 0
    assert bool(masked[rows, last[rows]].all())
    other = is_item.clone()
    other[rows, last[rows]] = False
    n = int(other.sum())
    assert n > 100_000
    share = float(masked[other].float().mean())
    assert abs(share - mask_prob) <= 3 * np.sqrt(
        mask_prob * (1 - mask_prob) / n)
    again = T_seq.mask_batch(torch.Generator().manual_seed(1), seq,
                             mask_prob, mask_id)
    assert torch.equal(again[0], ms) and torch.equal(again[1], tg)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference_steps(arch):
    """Three adamw steps on identical batches from a bridged init: the
    loss trajectory within 1e-4 relative (as the SASRec test)."""
    jm, jp, tm = _pair(arch, "jpq", True)
    batches = [_batch(jm, arch, s) for s in range(3)]
    cfg = dict(kind="adamw", lr=3e-3)
    values = J_nn.values(jp)
    state = J_opt.init_opt_state(values)

    def loss_fn(v, b):
        return jm.train_loss(J_nn.with_values(jp, v), b)[0]

    grad = jax.jit(jax.value_and_grad(loss_fn, allow_int=True))
    jl = []
    for b in batches:
        loss, g = grad(values, jax.tree.map(jnp.asarray, b))
        values, state, _ = J_opt.apply_updates(J_opt.OptConfig(**cfg), state,
                                               values, g)
        jl.append(float(loss))
    tr = T_loop.Trainer(tm, T_opt.OptConfig(**cfg),
                        T_loop.TrainConfig(steps=3, batch_size=4,
                                           log_every=1, eval_every=0),
                        data_fn=lambda s: batches[s])
    _, hist = tr.run(params=tm.params())
    tl = [h["loss"] for h in hist if "loss" in h]
    assert tr.done_step == 3
    np.testing.assert_allclose(jl, tl, rtol=1e-4)


def test_gru4rec_tree_and_init_order():
    """GRU4Rec's tree is the reference's (``gru`` a list of wx/wh/b,
    ``proj``) and has no transformer parameters; its init draws the
    GRU weights glorot-normal and the biases zero."""
    jm, jp, tm = _pair("gru4rec", "jpq", False)
    p = tm.params()
    assert set(p) == {"item_emb", "gru", "proj"}
    assert [set(g) for g in p["gru"]] == [{"wx", "wh", "b"}] * 2
    assert tuple(p["gru"][0]["wx"].shape) == (16, 48)
    assert tuple(p["proj"]["w"].shape) == (16, 16)
    with torch.no_grad():
        fresh = T_seq.SeqRecModel(
            tm.cfg, codes=np.zeros((N_ITEMS + 2, 4)),
            generator=torch.Generator().manual_seed(3), device="cpu").params()
        assert float(fresh["gru"][1]["b"].abs().max()) == 0.0
        std = float(fresh["gru"][0]["wh"].std())
    assert 0.5 * np.sqrt(2 / 64) < std < 1.2 * np.sqrt(2 / 64)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        T_seq.SeqRecModel(T_seq.SeqRecConfig(arch="lstm", **KW),
                          device="cpu")
