"""The gradient of the port's embedding_bag with respect to the table
(repro_torch.kernels.embedding_bag: ``ref.embedding_bag_backward_ref``
and ``ops.EmbeddingBag``), on the CPU.

The reference's Pallas kernel is forward-only; the reference trains its
tables through XLA's gather (``jnp.take`` + ``jnp.sum``), so the oracle
here is ``jax.grad`` of its ``kernels/embedding_bag/ref.py::
embedding_bag_ref`` with respect to the table.  Tolerances:
- against ``jax.grad``: each side is a recursive fp32 sum of a row's n
  rounded products w * dout (n: the positions that name the row), in
  its own order, so elementwise |a - b| <= 2 gamma_n sum |w * dout|,
  gamma_n = n u / (1 - n u), u = 2^-24 (measured: 0 on these inputs,
  since XLA's CPU scatter-add also adds in ascending position);
- against ``index_add_`` onto zeros on the CPU, and against one fp32
  chain a row in ascending flat position from +0.0 (the order the CUDA
  kernel keeps): none, bit-equal;
- ``torch.autograd.gradcheck`` in float64: its defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref as J_ref
from repro_torch.core import sharded as T_sharded
from repro_torch.kernels.embedding_bag import ops as T_ops
from repro_torch.kernels.embedding_bag import ref as T_ref

U = 2.0 ** -24
V, N_BAGS = 300, 12


def _case(d, L, weights, seed=0):
    """dout [N_BAGS, d] and ids with repeats (every bag's first half the
    pad row 0, bag 1 all padding, a few rows named many times), with
    mask, unit (None) or random weights."""
    rng = np.random.default_rng(seed + 100 * d + L)
    ids = rng.integers(0, V, (N_BAGS, L)).astype(np.int64)
    ids[:, 1::3] = rng.integers(1, 4, (N_BAGS, len(range(1, L, 3))))
    ids[:, : L // 2] = 0
    ids[1] = 0
    dout = rng.standard_normal((N_BAGS, d)).astype(np.float32)
    if weights == "masked":
        w = (ids > 0).astype(np.float32)
    elif weights == "random":
        w = rng.standard_normal((N_BAGS, L)).astype(np.float32)
    else:
        w = None
    return ids, w, dout


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _chains(ids, w, dout):
    """One fp32 chain a row: +0.0, then each term w * dout[n] (rounded)
    in ascending flat position."""
    L = ids.shape[1]
    out = np.zeros((V, dout.shape[1]), np.float32)
    for p, v in enumerate(ids.reshape(-1)):
        n = p // L
        term = dout[n] if w is None else np.float32(w.reshape(-1)[p]) * dout[n]
        out[v] = out[v] + term.astype(np.float32)
    return out


def _jax_grad(ids, w, dout):
    w1 = np.ones(ids.shape, np.float32) if w is None else w

    def f(table):
        return jnp.sum(J_ref(table, jnp.asarray(ids), jnp.asarray(w1))
                       * jnp.asarray(dout))

    return np.asarray(jax.grad(f)(jnp.zeros((V, dout.shape[1]),
                                            jnp.float32)))


def _bound(ids, w, dout):
    """2 gamma_n sum |w * dout| a row, n the row's positions."""
    w1 = np.ones(ids.shape, np.float64) if w is None else w.astype(np.float64)
    L = ids.shape[1]
    terms = np.abs(w1.reshape(-1, 1) * np.repeat(dout.astype(np.float64), L,
                                                 0))
    mass = np.zeros((V, dout.shape[1]))
    np.add.at(mass, ids.reshape(-1), terms)
    n = np.bincount(ids.reshape(-1), minlength=V)[:, None].astype(np.float64)
    return 2 * n * U / (1 - n * U) * mass


@pytest.mark.parametrize("weights", ["masked", "unit", "random"])
@pytest.mark.parametrize("d,L", [(1, 39), (8, 13), (256, 50)])
def test_plain_within_fp32_sum_bound_of_jax_grad(d, L, weights):
    ids, w, dout = _case(d, L, None if weights == "unit" else weights)
    got = T_ref.embedding_bag_backward_ref(_t(ids), _t(w), _t(dout),
                                           V).numpy()
    want = _jax_grad(ids, w, dout)
    assert got.shape == want.shape == (V, d)
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= _bound(ids, w, dout))
    # rows no id names stay +0.0
    unnamed = np.setdiff1d(np.arange(V), ids)
    assert len(unnamed) and np.all(_bits(got[unnamed]) == 0)


@pytest.mark.parametrize("weights", ["masked", "unit", "random"])
@pytest.mark.parametrize("d,L", [(1, 39), (8, 13), (256, 50)])
def test_plain_bit_equal_to_ascending_chains_and_index_add(d, L, weights):
    ids, w, dout = _case(d, L, None if weights == "unit" else weights, seed=1)
    got = T_ref.embedding_bag_backward_ref(_t(ids), _t(w), _t(dout),
                                           V).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_chains(ids, w, dout)))
    prods = torch.from_numpy(np.repeat(dout, L, 0))
    if w is not None:
        prods = torch.from_numpy(w.reshape(-1, 1)) * prods
    lib = torch.zeros(V, d).index_add_(0, torch.from_numpy(ids.reshape(-1)),
                                       prods).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(lib))


def test_plain_int32_ids_and_one_slot():
    ids, w, dout = _case(8, 1, "random", seed=2)
    a = T_ref.embedding_bag_backward_ref(_t(ids), _t(w), _t(dout), V)
    b = T_ref.embedding_bag_backward_ref(_t(ids.astype(np.int32)), _t(w),
                                         _t(dout), V)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    np.testing.assert_array_equal(_bits(a), _bits(_chains(ids, w, dout)))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weights", ["masked", "unit"])
def test_gradcheck_float64(combiner, weights):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((40, 3))).requires_grad_()
    ids = torch.from_numpy(rng.integers(0, 40, (7, 6)))
    w = (ids > 5).float() if weights == "masked" else None
    assert torch.autograd.gradcheck(
        lambda t: T_ops.embedding_bag(t, ids, w, combiner=combiner),
        (table,))


@pytest.mark.parametrize("weights", ["masked", "unit", "random"])
def test_function_gradient_is_the_plain_backward(weights):
    """``ops.embedding_bag`` on a table that requires a gradient: the
    forward bit-equal to the plain forward, the gradient (autograd)
    bit-equal to ``embedding_bag_backward_ref`` on the same dout."""
    ids, w, dout = _case(16, 20, None if weights == "unit" else weights,
                         seed=4)
    table = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (V, 16)).astype(np.float32)).requires_grad_()
    out = T_ops.embedding_bag(table, _t(ids), _t(w))
    with torch.no_grad():
        plain = T_ref.embedding_bag_ref(table, _t(ids), _t(w))
    assert torch.equal(out.detach().view(torch.int32),
                       plain.view(torch.int32))
    (g,) = torch.autograd.grad(out, table, _t(dout))
    want = T_ref.embedding_bag_backward_ref(_t(ids), _t(w), _t(dout), V)
    assert torch.equal(g.view(torch.int32), want.view(torch.int32))


def test_weights_that_require_a_gradient_are_refused():
    table = torch.zeros(10, 4, requires_grad=True)
    ids = torch.zeros(3, 2, dtype=torch.int64)
    w = torch.ones(3, 2, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient for its weights"):
        T_ops.embedding_bag(table, ids, w)
    # ids get no gradient and the weights' detached copy is fine
    out = T_ops.embedding_bag(table, ids, w.detach())
    assert out.requires_grad and out.grad_fn is not None


def test_no_graph_without_a_table_gradient():
    """Serving (a table that requires no gradient, or no_grad) runs the
    forward alone: no autograd node."""
    ids, w, _ = _case(8, 5, "masked", seed=5)
    table = torch.randn(V, 8)
    assert T_ops.embedding_bag(table, _t(ids), _t(w)).grad_fn is None
    table.requires_grad_()
    with torch.no_grad():
        assert T_ops.embedding_bag(table, _t(ids), _t(w)).grad_fn is None


def test_pooled_lookup_carries_the_gradient_as_jax_grad():
    """``core/sharded.pooled_lookup`` (the full two-tower user tower)
    passes the gradient through: against ``jax.grad`` of the
    reference's single-device pooled lookup (take + sum)."""
    from repro.core import sharded as J_sharded
    rng = np.random.default_rng(6)
    table = rng.standard_normal((V, 32)).astype(np.float32)
    hist = rng.integers(0, V, (10, 50))
    hist[:, :20] = 0
    mask = (hist > 0).astype(np.float32)
    dout = rng.standard_normal((10, 32)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    (g,) = torch.autograd.grad(
        T_sharded.pooled_lookup(t, torch.from_numpy(hist), _t(mask)), t,
        _t(dout))
    want = np.asarray(jax.grad(lambda tb: jnp.sum(J_sharded.pooled_lookup(
        tb, jnp.asarray(hist), jnp.asarray(mask)) * jnp.asarray(dout)))(
            jnp.asarray(table)))
    assert np.all(np.abs(g.numpy() - want) <= _bound(hist, mask, dout))


def test_empty_bag_list():
    table = torch.randn(V, 4, requires_grad=True)
    ids = torch.zeros((0, 5), dtype=torch.int64)
    out = T_ops.embedding_bag(table, ids)
    assert out.shape == (0, 4)
    g = T_ref.embedding_bag_backward_ref(ids, None, torch.zeros(0, 4), V)
    assert g.shape == (V, 4) and not bool(g.any())
