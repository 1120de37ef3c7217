"""The port's other sequential objectives and its retrieval entry points
(repro_torch.models.sequential) against the JAX reference, on the CPU,
on weights bridged from the reference's ``init_params`` with
``dropout=0``; BERT4Rec on the reference's own ``mask_batch`` output.

* ``sampled_bce``, ``code_ce`` and the ``semantic_weight`` auxiliary, for
  SASRec, BERT4Rec and GRU4Rec: the loss (and the reported ``code_ce``)
  within 1e-5 relative of the reference's, every gradient within 1e-4 of
  its largest entry of ``jax.grad``'s (fp32 sums in another order).
* ``bind_engine`` / ``retrieve_topk`` on the fused, materialise, pruned,
  permuted and warm-floored paths: ids equal to the reference's and
  values within 1e-5 of the scores' largest magnitude (the encoder's
  tolerance; the top-k+1 gaps are checked ten times wider first), and
  bit-equal to the total-order top-k of the port's own ``score_last``;
  the semantic head at exhaustive beams bit-equal to it as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingConfig as J_EC
from repro.models import sequential as J_seq
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import engine as T_engine
from repro_torch.models import sequential as T_seq
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt

N_ITEMS, K_NEG = 120, 2
KW = dict(n_items=N_ITEMS, max_len=10, d_model=16, n_layers=2, n_heads=2,
          d_ff=32, n_negatives=K_NEG)
ARCHS = ["sasrec", "bert4rec", "gru4rec"]
TOL = 1e-5


def _pair(arch, loss="full_ce", semantic_weight=0.0, use_kernel=True,
          kind="jpq", seed=0):
    codes = np.random.default_rng(seed).integers(
        0, 16, (N_ITEMS + 2, 4)).astype(np.int32)
    codes = codes if kind == "jpq" else None
    kw = dict(KW, arch=arch, loss=loss, semantic_weight=semantic_weight)
    jm = J_seq.SeqRecModel(J_seq.SeqRecConfig(
        embedding=J_EC(0, 0, kind=kind, m=4, b=16), **kw), codes=codes)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = T_seq.SeqRecModel(T_seq.SeqRecConfig(
        embedding=T_EC(0, 0, kind=kind, m=4, b=16, use_kernel=use_kernel),
        **kw), codes=codes, generator=torch.Generator().manual_seed(seed),
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
    reference's ``mask_batch``; the causal archs' with K_NEG negatives a
    position that never equal the label (as ``train_batch`` draws
    them)."""
    seq = _seq(seed)
    if arch == "bert4rec":
        ms, tg = J_seq.mask_batch(jax.random.PRNGKey(seed), jnp.asarray(seq),
                                  jm.cfg.mask_prob, jm.cfg.mask_id)
        return {"seq": np.array(ms), "targets": np.array(tg)}
    rng = np.random.default_rng(seed + 1)
    labels = np.roll(seq, -1, 1)
    labels[:, -1] = rng.integers(1, N_ITEMS + 1, seq.shape[0])
    labels[seq == 0] = 0
    neg = rng.integers(1, N_ITEMS, seq.shape + (K_NEG,))
    return {"seq": seq, "labels": labels,
            "negatives": neg + (neg >= labels[..., None])}


def _grads_close(jg, p):
    n = 0
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        if g.dtype == jax.dtypes.float0:
            continue
        node = p
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        g = np.asarray(g)
        got = np.zeros_like(g) if node.grad is None else node.grad.numpy()
        err = np.abs(g - got).max()
        assert err <= 1e-4 * np.abs(g).max() + 1e-9, (path, err)
        n += 1
    return n


OBJECTIVES = [("sampled_bce", 0.0, True), ("sampled_bce", 0.0, False),
              ("code_ce", 0.0, True), ("full_ce", 0.5, True),
              ("sampled_bce", 0.5, True)]


@pytest.mark.parametrize("loss,weight,use_kernel", OBJECTIVES,
                         ids=[f"{l}-w{w}-{'kernel' if u else 'plain'}"
                              for l, w, u in OBJECTIVES])
@pytest.mark.parametrize("arch", ARCHS)
def test_objective_loss_and_grads(arch, loss, weight, use_kernel):
    jm, jp, tm = _pair(arch, loss, weight, use_kernel)
    batch = _batch(jm, arch, 4)

    def j_loss(v):
        return jm.train_loss(J_nn.with_values(jp, v),
                             jax.tree.map(jnp.asarray, batch))

    (jl, jmets), jg = jax.value_and_grad(j_loss, has_aux=True,
                                         allow_int=True)(J_nn.values(jp))
    p = tm.params()
    tl, mets = tm.train_loss(p, {k: torch.tensor(v) for k, v in
                                 batch.items()})
    tl.backward()
    want_keys = {"loss", "code_ce"} if weight and \
        (loss != "code_ce") else {"loss"}
    assert set(mets) == set(jmets) == want_keys
    for key in jmets:
        want = float(jmets[key])
        assert abs(want - float(mets[key])) <= TOL * abs(want), key
    assert _grads_close(jg, p) == sum(1 for _ in tm.parameters())


def test_sampled_bce_goes_through_lookup_only():
    """sampled_bce builds no [.., n_rows] logits: with logits refused,
    the loss still runs (positives and negatives through ``lookup``)."""
    jm, _, tm = _pair("sasrec", "sampled_bce")
    batch = {k: torch.tensor(v) for k, v in _batch(jm, "sasrec", 1).items()}

    def refuse(*a, **k):
        raise AssertionError("sampled_bce called emb.logits")

    tm.emb = dataclasses.replace(tm.emb)
    object.__setattr__(tm.emb, "logits", refuse)
    loss, _ = tm.train_loss(tm.params(), batch)
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("change", [dict(loss="code_ce"),
                                    dict(semantic_weight=0.1)])
@pytest.mark.parametrize("kind", ["full", "qr"])
def test_semantic_objective_needs_jpq(change, kind):
    cfg = dict(KW, arch="sasrec", **change)
    with pytest.raises(ValueError) as je:
        J_seq.SeqRecModel(J_seq.SeqRecConfig(
            embedding=J_EC(0, 0, kind=kind), **cfg))
    with pytest.raises(ValueError) as te:
        T_seq.SeqRecModel(T_seq.SeqRecConfig(
            embedding=T_EC(0, 0, kind=kind), **cfg), device="cpu")
    assert str(te.value) == str(je.value)


# ============================================= bind_engine / retrieve_topk

PATHS = ["fused", "materialise", "prune", "prune-perm", "prune-warm"]


def _min_gap(scores, k):
    top = -np.sort(-scores, axis=1)[:, :k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


def _own_topk(tm, p, seq, k):
    s = tm.score_last(p, seq)
    ids = torch.arange(s.shape[1], dtype=torch.int32).expand_as(s)
    return T_engine.rerank_candidates(s, ids, k)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_retrieve_topk_matches(arch, path):
    jm, jp, tm = _pair(arch)
    p = tm.params()
    seq = _seq(9)
    k = 5
    with torch.no_grad():
        want_v, want_i = _own_topk(tm, p, torch.tensor(seq), k)
    ref_scores = np.asarray(jm.score_last(jp, jnp.asarray(seq)))[:, 1:-1]
    tol = TOL * float(np.abs(ref_scores).max())
    assert _min_gap(ref_scores, k) > 10 * tol
    kw = {}
    if path == "materialise":
        kw = dict(fused=False)
    elif path.startswith("prune"):
        kw = dict(prune=True)
    if path == "prune-perm":
        kw["perm"] = np.random.default_rng(2).permutation(N_ITEMS + 2)
    if path == "prune-warm":
        # the internal (k+2)-th value: even rows overshoot it (demote and
        # re-sweep), odd rows stay under it
        theta = np.asarray(jm.retrieve_topk(jp, jnp.asarray(seq),
                                            k=k + 2)[0])[:, -1]
        kw["warm"] = np.where(np.arange(len(theta)) % 2 == 0, theta + 1.0,
                              theta - 1.0).astype(np.float32)
        kw["return_stats"] = True
    jout = jm.retrieve_topk(jp, jnp.asarray(seq), k=k, **kw)
    with torch.no_grad():
        tout = tm.retrieve_topk(p, torch.tensor(seq), k=k, **kw)
    np.testing.assert_array_equal(np.asarray(jout[1]), tout[1].numpy())
    np.testing.assert_allclose(np.asarray(jout[0]), tout[0].numpy(),
                               rtol=0, atol=tol)
    assert torch.equal(tout[1], want_i)
    assert torch.equal(tout[0].view(torch.int32), want_v.view(torch.int32))
    if kw.get("return_stats"):
        np.testing.assert_array_equal(np.asarray(jout[2]["demoted"]),
                                      tout[2]["demoted"].numpy())
        assert tout[2]["demoted"].numpy()[::2].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_semantic_head_exhaustive_equals_score_last(arch):
    _, _, tm = _pair(arch)
    p = tm.params()
    seq = torch.tensor(_seq(3))
    spec = T_engine.RetrievalSpec(kind="semantic", k=5, beams=N_ITEMS + 2)
    with torch.no_grad():
        v, i = tm.bind_engine(p, spec).retrieve({"user_hist": seq})
        rv, ri = _own_topk(tm, p, seq, 5)
    assert torch.equal(i, ri) and torch.equal(v.view(torch.int32),
                                              rv.view(torch.int32))


def test_retrieve_topk_backend_rule():
    _, _, tm = _pair("sasrec")
    seq = torch.tensor(_seq(3))
    with torch.no_grad():
        a = tm.retrieve_topk(tm.params(), seq, k=4, backend=None)
        b = tm.retrieve_topk(tm.params(), seq, k=4)
        assert torch.equal(a[1], b[1])
        for backend in ("pallas", "interpret", "scan"):
            with pytest.raises(ValueError, match="backend"):
                tm.retrieve_topk(tm.params(), seq, k=4, backend=backend)


@pytest.mark.parametrize("arch", ["sasrec", "bert4rec"])
def test_code_ce_trains_and_decodes(arch):
    """loss='code_ce' alone through the Trainer on one fixed batch: the
    loss falls, and the trained model serves through the semantic head
    (every id a real item)."""
    jm, _, tm = _pair(arch, "code_ce")
    batch = _batch(jm, arch, 5)
    tr = T_loop.Trainer(tm, T_opt.OptConfig(lr=1e-2),
                        T_loop.TrainConfig(steps=6, batch_size=4,
                                           log_every=1, eval_every=0),
                        data_fn=lambda s: batch)
    params, hist = tr.run(params=tm.params())
    losses = [h["loss"] for h in hist if "loss" in h]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    spec = T_engine.RetrievalSpec(kind="semantic", k=4, beams=16)
    with torch.no_grad():
        v, i = tm.bind_engine(params, spec).retrieve(torch.tensor(_seq(8)))
    assert bool(torch.isfinite(v).all()) and bool((i > 0).all())
    assert bool((i <= N_ITEMS).all())
