"""The port's top-k mixture of experts (``repro_torch.nn.moe``) against
the JAX reference (``repro.nn.moe``) on the CPU: the reference's
parameters carried across, inputs drawn from numpy seeds.

Tolerances:
- the routing exactly equal: the experts chosen (``idx``), each
  assignment's slot (``slot_of``) and so the set of dropped assignments
  (slot ``E·C``);
- ``y`` and ``aux`` (fp32) within 1e-5 of the largest magnitude
  (measured: at most 2.4e-7);
- gradients against ``jax.grad`` by the rule of
  ``tests/test_torch_recsys_train.py``: every leaf within 1e-5 of its
  largest entry, or within 1e-6 of the largest entry of the whole
  gradient, whichever is larger.

The dispatch and combine gathers take their gradients from the
embedding_bag backward's plain version here (``gather_backward_ref``),
which is checked to be the route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import module as J_nn
from repro.nn import moe as J_moe
from repro_torch.kernels.embedding_bag import ref as bag_ref
from repro_torch.nn import moe as T_moe

T, D, F = 24, 32, 48


def _pair(E=4, k=2, cf=1.25, seed=0):
    jcfg = J_moe.MoEConfig(n_experts=E, top_k=k, d_model=D, d_ff=F,
                           capacity_factor=cf)
    tcfg = T_moe.MoEConfig(n_experts=E, top_k=k, d_model=D, d_ff=F,
                           capacity_factor=cf)
    jp = J_moe.moe_init(J_nn.KeyGen(seed), jcfg)
    tp = {k_: torch.from_numpy(np.array(v)) for k_, v in
          J_nn.values(jp).items()}
    return jcfg, tcfg, jp, tp


def _x(seed=1, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(
        np.float32)
    x[list(zero_rows)] = 0.0
    return x


def _ref_routing(jp, jcfg, x, G=1):
    """The reference's idx and per-group slot_of (its own functions)."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"].value, -1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    C = J_moe.capacity(jcfg, T // G)
    xg = jnp.asarray(x).reshape(G, T // G, D)
    ig = idx.reshape(G, T // G, jcfg.top_k)
    slots = [np.asarray(J_moe._dispatch_group(xg[g], ig[g], jcfg.n_experts,
                                              C, jcfg.top_k)[1])
             for g in range(G)]
    return np.asarray(idx), slots, C


def _port_routing(tp, tcfg, x, G=1):
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    _, idx = T_moe.top_k(probs, tcfg.top_k)
    C = T_moe.capacity(tcfg, T // G)
    ig = idx.reshape(G, T // G, tcfg.top_k)
    slots = [T_moe.route(ig[g], tcfg.n_experts, C)[1].numpy()
             for g in range(G)]
    return idx.numpy(), slots, C


def _close(got, want, tol=1e-5):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _check(cf, G, *, E=4, k=2, zero_rows=(), expect_drops=None):
    jcfg, tcfg, jp, tp = _pair(E, k, cf)
    x = _x(zero_rows=zero_rows)
    jidx, jslots, C = _ref_routing(jp, jcfg, x, G)
    tidx, tslots, tC = _port_routing(tp, tcfg, x, G)
    assert C == tC
    assert np.array_equal(jidx, tidx)
    for a, b in zip(jslots, tslots):
        assert np.array_equal(a, b)
    drops = sum(int((s == E * C).sum()) for s in tslots)
    if expect_drops is not None:
        assert (drops > 0) == expect_drops, drops
    jy, jaux = J_moe.moe_apply(jp, jcfg, jnp.asarray(x), groups=G)
    ty, taux = T_moe.moe_apply(tp, tcfg, torch.from_numpy(x), groups=G)
    _close(ty, jy)
    _close(taux, jaux)
    return jcfg, tcfg, jp, tp, x, tidx


@pytest.mark.parametrize("cf,G,k,drops", [(1.25, 1, 2, None),
                                          (0.25, 1, 2, True),
                                          (1.25, 2, 2, None),
                                          (0.25, 2, 4, True)])
def test_forward_and_routing_match_reference(cf, G, k, drops):
    """At capacity_factor 0.25 the capacity (rounded up to 8 slots) is
    below the assignments an expert gets on average, so some drop."""
    _check(cf, G, k=k, expect_drops=drops)


def test_top_k_ties_go_to_the_smaller_expert():
    """Zero rows give every expert the same probability: the port picks
    experts 0..k-1 there, as ``lax.top_k`` does."""
    zero = (0, 5, 6, 17)
    *_, idx = _check(1.25, 1, E=8, k=3, zero_rows=zero)
    for r in zero:
        assert idx[r].tolist() == [0, 1, 2]
    probs = torch.full((2, 6), 1.0 / 6)
    assert T_moe.top_k(probs, 4)[1].tolist() == [[0, 1, 2, 3]] * 2


@pytest.mark.parametrize("cf,G", [(1.25, 1), (0.25, 2)])
def test_gradients_match_jax_grad(cf, G, monkeypatch):
    jcfg, tcfg, jp, tp, x, _ = _check(cf, G)
    r = np.random.default_rng(3).standard_normal((T, D)).astype(np.float32)

    def j_loss(v, xx):
        y, aux = J_moe.moe_apply(J_nn.with_values(jp, v), jcfg, xx,
                                 groups=G)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.grad(j_loss, argnums=(0, 1))(J_nn.values(jp),
                                                jnp.asarray(x))
    calls = []
    real = bag_ref.gather_backward_ref

    def spy(ids, dout, V):
        calls.append(V)
        return real(ids, dout, V)

    monkeypatch.setattr(bag_ref, "gather_backward_ref", spy)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = T_moe.moe_apply(leaves, tcfg, tx, groups=G)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    # per group: the dispatch gather (t + 1 rows), k combine gathers
    C = T_moe.capacity(tcfg, T // G)
    assert sorted(calls) == sorted([T // G + 1] * G
                                   + [4 * C + 1] * (2 * G))
    pairs = [(k, leaves[k].grad.numpy(), np.asarray(jg[k])) for k in tp]
    pairs.append(("x", tx.grad.numpy(), np.asarray(jgx)))
    floor = 1e-6 * max(float(np.abs(w).max()) for _, _, w in pairs)
    for name, got, want in pairs:
        assert np.abs(want).max() > 0, name
        tol = max(1e-5 * float(np.abs(want).max()), floor)
        assert np.abs(got - want).max() <= tol, name


def test_moe_init_shapes_and_groups_fallback():
    _, tcfg, jp, tp = _pair()
    got = T_moe.moe_init(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    x = torch.from_numpy(_x())
    # 5 groups do not divide 24 tokens: one group, as the reference
    y5, _ = T_moe.moe_apply(tp, tcfg, x, groups=5)
    y1, _ = T_moe.moe_apply(tp, tcfg, x, groups=1)
    assert torch.equal(y5, y1)
    assert T_moe.capacity(tcfg, 3) == 8 and \
        T_moe.capacity(T_moe.MoEConfig(64, 8, 8, 8), 1) == 8
