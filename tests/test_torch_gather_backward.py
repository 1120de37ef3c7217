"""The gradient of the port's table gathers on the CPU: ``core/full.lookup``
and ``core/jpq.lookup(use_kernel=False)`` take it from the embedding_bag
backward (``kernels/embedding_bag/ops.gather``: L = 1, unit weights,
``ref.gather_backward_ref`` on the CPU), and the plain version of the
backward's index preparation (``ref.sort_ids_ref``).

Tolerances:
- against ``jax.grad`` of the JAX package's same function
  (``repro.core.full.lookup``, ``repro.core.jpq.lookup``): each side is
  a recursive fp32 sum of a row's n terms in its own order, so
  elementwise |a - b| <= 2 gamma_n sum |terms|, gamma_n = n u / (1 - n
  u), u = 2^-24 (measured: 0 on these inputs, since XLA's CPU
  scatter-add also adds in ascending position);
- against ``index_add_`` onto zeros and against one fp32 chain a row in
  ascending flat position from +0.0 (the order the CUDA kernel keeps):
  none, bit-equal;
- the index preparation against ``torch.sort(stable=True)``,
  ``searchsorted`` and ``bincount``: none, equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import full as J_full
from repro.core import jpq as J_jpq
from repro.nn import module as J_nn
from repro_torch.core import full as T_full
from repro_torch.core import jpq as T_jpq
from repro_torch.kernels.embedding_bag import ops as T_ops
from repro_torch.kernels.embedding_bag import ref as T_ref

U = 2.0 ** -24


def _ids(rng, V, shape, *, pad=0.3, hot=3, negative=False):
    """ids with a left-padded share on row 0 and a few hot rows, so rows
    get long runs; ``negative``: some ids written as id - V."""
    ids = rng.integers(0, V, shape)
    flat = ids.reshape(-1)
    flat[rng.random(flat.size) < pad] = 0
    flat[rng.random(flat.size) < 0.2] = rng.integers(1, 1 + hot)
    if negative:
        neg = rng.random(flat.size) < 0.3
        flat[neg] -= V
    return ids


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _bound(ids, dout, V):
    """2 gamma_n sum |terms| a row, n the row's terms (ids wrapped)."""
    flat = np.where(ids.reshape(-1) < 0, ids.reshape(-1) + V, ids.reshape(-1))
    d = dout.shape[-1]
    mass = np.zeros((V, d))
    np.add.at(mass, flat, np.abs(dout.reshape(-1, d).astype(np.float64)))
    n = np.bincount(flat, minlength=V)[:, None].astype(np.float64)
    return 2 * n * U / (1 - n * U) * mass


def _chains(ids, dout, V):
    """One fp32 chain a row: +0.0, then each term dout[p] in ascending
    flat position p (ids wrapped)."""
    d = dout.shape[-1]
    out = np.zeros((V, d), np.float32)
    for p, v in enumerate(ids.reshape(-1)):
        out[v % V] = out[v % V] + dout.reshape(-1, d)[p]
    return out


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("V,d,shape", [(300, 16, (6, 40)), (50, 1, (200,)),
                                       (1000, 18, (4, 3, 25))])
def test_full_lookup_gradient_matches_jax_grad(V, d, shape, negative):
    rng = np.random.default_rng(V + d)
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = _ids(rng, V, shape, negative=negative)
    dout = rng.standard_normal(shape + (d,)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    out = T_full.lookup({"table": t}, torch.from_numpy(ids))
    assert isinstance(out.grad_fn, T_ops.TableGather._backward_cls)
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(dout))
    want = np.asarray(jax.grad(lambda tb: jnp.sum(J_full.lookup(
        {"table": J_nn.P(tb, None)}, jnp.asarray(ids)) * dout))(
            jnp.asarray(table)))
    assert got.shape == want.shape == (V, d)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= _bound(ids, dout, V))
    # the forward: the same bits as the plain gather
    np.testing.assert_array_equal(_bits(out.detach()),
                                  _bits(table[ids % V]))


@pytest.mark.parametrize("m,b,dk,shape", [(6, 16, 3, (8, 30)),
                                          (4, 256, 8, (5, 20)),
                                          (2, 3, 1, (40,))])
def test_jpq_lookup_gradient_matches_jax_grad(m, b, dk, shape):
    """``core/jpq.lookup(use_kernel=False)``: the centroids' gradient
    through the flat [m * b, dk] gather at j * b + code."""
    rng = np.random.default_rng(m * b)
    n_items = 60
    codes = rng.integers(0, b, (n_items, m)).astype(
        np.uint8 if b <= 256 else np.int32)
    codes[0] = codes[1]                         # two items share codes
    cent = rng.standard_normal((m, b, dk)).astype(np.float32)
    ids = _ids(rng, n_items, shape)
    dout = rng.standard_normal(shape + (m * dk,)).astype(np.float32)
    c = torch.from_numpy(cent).requires_grad_()
    out = T_jpq.lookup({"codes": torch.from_numpy(codes), "centroids": c},
                       torch.from_numpy(ids))
    (got,) = torch.autograd.grad(out, c, torch.from_numpy(dout))
    want = np.asarray(jax.grad(lambda ct: jnp.sum(J_jpq.lookup(
        {"codes": J_nn.P(jnp.asarray(codes), None),
         "centroids": J_nn.P(ct, None)}, jnp.asarray(ids)) * dout))(
            jnp.asarray(cent)))
    assert got.shape == want.shape == (m, b, dk)
    flat = (codes[ids].astype(np.int64)
            + b * np.arange(m)).reshape(-1)           # the flat gather's ids
    bound = _bound(flat, dout.reshape(-1, dk), m * b).reshape(m, b, dk)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= bound)
    # and bit-equal to the ascending chains of the flat gather
    np.testing.assert_array_equal(
        _bits(got.reshape(m * b, dk)),
        _bits(_chains(flat, dout.reshape(-1, dk), m * b)))


@pytest.mark.parametrize("d,shape", [(1, (500,)), (8, (7, 13)),
                                     (256, (3, 50))])
def test_route_bit_equal_to_ascending_chains_and_index_add(d, shape):
    V = 90
    rng = np.random.default_rng(d)
    ids = _ids(rng, V, shape, negative=True)
    dout = rng.standard_normal(shape + (d,)).astype(np.float32)
    t = torch.zeros((V, d), requires_grad=True)
    (got,) = torch.autograd.grad(T_ops.gather(t, torch.from_numpy(ids)), t,
                                 torch.from_numpy(dout))
    np.testing.assert_array_equal(_bits(got), _bits(_chains(ids, dout, V)))
    lib = torch.zeros(V, d).index_add_(
        0, torch.from_numpy(ids.reshape(-1) % V),
        torch.from_numpy(dout.reshape(-1, d)))
    np.testing.assert_array_equal(_bits(got), _bits(lib))
    # rows no id names stay +0.0
    unnamed = np.setdiff1d(np.arange(V), ids % V)
    assert len(unnamed) and np.all(_bits(got.numpy()[unnamed]) == 0)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_negative_ids_count_from_the_end(dtype):
    """A negative id names row id + V, as ``table[ids]`` reads it: the
    route's forward and gradient equal PyTorch's own gather's (one term
    a row here, so no order can differ) and the plain version on the
    wrapped ids; an id outside [-V, V) is refused."""
    V, d = 40, 5
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.permutation(np.arange(-V, V))[:V]).to(dtype)
    dout = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32))
    t = table.clone().requires_grad_()
    out = T_ops.gather(t, ids)
    (got,) = torch.autograd.grad(out, t, dout)
    t2 = table.clone().requires_grad_()
    (lib,) = torch.autograd.grad(t2[ids.long()], t2, dout)
    assert torch.equal(out.detach(), table[ids.long()])
    assert torch.equal(got.view(torch.int32), lib.view(torch.int32))
    wrapped = T_ref.gather_backward_ref(ids.long() % V, dout, V)
    assert torch.equal(got.view(torch.int32), wrapped.view(torch.int32))
    for bad in (-V - 1, V):
        with pytest.raises(IndexError, match="outside"):
            T_ref.gather_backward_ref(torch.tensor([0, bad]), dout[:2], V)


def test_no_graph_without_a_table_gradient():
    """Serving (a table that requires no gradient, or no_grad) runs the
    plain gather: no autograd node, the same bits."""
    table = torch.randn(30, 4)
    ids = torch.randint(0, 30, (5, 6))
    out = T_full.lookup({"table": table}, ids)
    assert out.grad_fn is None and torch.equal(out, table[ids])
    cent = torch.randn(3, 8, 2)
    codes = torch.randint(0, 8, (30, 3)).to(torch.uint8)
    assert T_jpq.lookup({"codes": codes, "centroids": cent},
                        ids).grad_fn is None
    table.requires_grad_()
    cent.requires_grad_()
    with torch.no_grad():
        assert T_full.lookup({"table": table}, ids).grad_fn is None
        assert T_jpq.lookup({"codes": codes, "centroids": cent},
                            ids).grad_fn is None
    # the graph holds the route where the table takes a gradient
    assert isinstance(T_full.lookup({"table": table}, ids).grad_fn,
                      T_ops.TableGather._backward_cls)


def test_gather_refuses_a_table_that_is_not_two_dimensional():
    t = torch.zeros(3, 4, 2, requires_grad=True)
    with pytest.raises(ValueError, match=r"\[V, d\] table"):
        T_ops.gather(t, torch.zeros(2, dtype=torch.int64))


def test_empty_ids():
    t = torch.randn(10, 3, requires_grad=True)
    ids = torch.zeros((0, 4), dtype=torch.int64)
    out = T_ops.gather(t, ids)
    assert out.shape == (0, 4, 3)
    (g,) = torch.autograd.grad(out, t, torch.zeros(0, 4, 3))
    assert g.shape == (10, 3) and not bool(g.any())


# ---------------------------------------------------- index preparation

def _prep_cases():
    rng = np.random.default_rng(11)
    skew = rng.integers(0, 500, 3000)
    skew[::2] = 123
    out_of_range = rng.integers(0, 40, 300)
    out_of_range[[5, 77]] = [40, -41]
    return [
        # name, ids, V, wrap, long_run
        ("uniform", rng.integers(0, 1000, 2000), 1000, False, 3),
        ("skewed", skew, 500, False, 64),
        ("one id", np.full(700, 9), 10, False, 64),
        ("sparse: long gaps", rng.integers(0, 100_000, 20), 100_000,
         False, 1),
        ("negative wrapped", rng.integers(-50, 50, 400), 50, True, 5),
        ("outside [0, V)", out_of_range, 40, False, 4),
        ("negative unwrapped", rng.integers(-5, 5, 100), 5, False, 64),
        ("V = 1", np.zeros(33, np.int64), 1, False, 32),
        ("one id, one row", np.zeros(1, np.int64), 3, False, 1),
    ]


@pytest.mark.parametrize("case", _prep_cases(), ids=lambda c: c[0])
def test_sort_ids_ref_against_stable_sort(case):
    """The plain version of the kernel's index preparation (sentinel
    keys, the offsets written from the boundaries between sorted keys,
    the long runs found from their first position) against the same
    facts from ``torch.sort(stable=True)``, ``searchsorted`` and
    ``bincount``."""
    _, ids_np, V, wrap, long_run = case
    ids = torch.from_numpy(np.asarray(ids_np, np.int64))
    perm, offs, lng, bad = T_ref.sort_ids_ref(ids, V, wrap=wrap,
                                              long_run=long_run)
    keys = torch.where(ids < 0, ids + V, ids) if wrap else ids.clone()
    outside = (keys < 0) | (keys >= V)
    keys[outside] = V
    skeys, want_perm = torch.sort(keys, stable=True)
    assert torch.equal(perm, want_perm)
    assert torch.equal(offs, torch.searchsorted(skeys, torch.arange(V + 1)))
    cnt = torch.bincount(keys[~outside], minlength=V)
    assert torch.equal(offs[1:] - offs[:-1], cnt)
    assert torch.equal(lng, torch.nonzero(cnt > long_run).flatten())
    assert bad == bool(outside.any())
    # each row's run, in perm order, is its positions ascending
    for v in torch.nonzero(cnt).flatten()[:50].tolist():
        run = perm[offs[v]:offs[v + 1]]
        assert torch.equal(run, torch.nonzero(keys == v).flatten())


def test_ctr_models_train_their_gathers_through_the_route(monkeypatch):
    """DIEN's three lookups (hist, hist_neg, target) and FM's field
    embeddings take their gradient from the route's plain version, the
    table's full row count each time."""
    from repro_torch.configs import get_bundle
    from repro_torch.nn.module import tree_leaves
    calls = []
    real = T_ref.gather_backward_ref

    def spy(ids, dout, V):
        calls.append((tuple(ids.shape), V))
        return real(ids, dout, V)

    monkeypatch.setattr(T_ref, "gather_backward_ref", spy)
    for name, n_calls in (("dien", 3), ("fm", 1), ("dien-jpq", 3)):
        calls.clear()
        model, batch = get_bundle(name).make_smoke(device="cpu", seed=0)
        p = model.params()
        fl = [x for x in tree_leaves(p) if x.is_floating_point()]
        for x in fl:
            x.requires_grad_(True)
        loss, _ = model.train_loss(p, batch)
        torch.autograd.grad(loss, fl, allow_unused=True)
        assert len(calls) == n_calls, (name, calls)
        if name == "dien":
            rows = p["item_emb"]["table"].shape[0]
            assert sorted(calls) == sorted([
                (tuple(batch["hist"].shape), rows),
                (tuple(batch["hist_neg"].shape), rows),
                (tuple(batch["target"].shape), rows)])
        if name == "dien-jpq":
            m, b, _ = p["item_emb"]["centroids"].shape
            assert all(V == m * b for _, V in calls)
