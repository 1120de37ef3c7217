"""Parity of the port's embedding_bag (repro_torch.kernels.embedding_bag,
core/sharded.pooled_lookup) with the JAX reference, on the CPU.

Tolerances:
- the plain version against the reference's Pallas kernel
  ``embedding_bag_fixed`` in interpret mode: none (bit-equal).  Both sum
  in slot order, slot 0 a rounded product and every later slot one
  fused multiply-add;
- against the reference's jnp oracle ``embedding_bag_ref`` and its
  ``core/sharded.pooled_lookup`` (a product, then ``jnp.sum`` over the
  slots): two recursive fp32 sums of the same L terms, so elementwise
  |a - b| <= 2 L u sum_l |w_l row_l| with u = 2^-24;
- the ``mean`` combiner with random weights: the same bound, plus the
  last-bit difference of the normalising sum (its relative error is
  at most L u).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded as J_sharded
from repro.kernels.embedding_bag import ops as J_ops
from repro.kernels.embedding_bag.embedding_bag import embedding_bag_fixed
from repro.kernels.embedding_bag.ref import embedding_bag_ref as J_ref
from repro_torch.core import sharded as T_sharded
from repro_torch.kernels.embedding_bag import ops as T_ops
from repro_torch.kernels.embedding_bag import ref as T_ref

U = 2.0 ** -24
V, N_BAGS = 300, 6


def _case(d, L, weights, seed=0):
    """A table whose pad row 0 is all negative, ids with padding (some
    bags all padding), and masked, unit (None) or random weights."""
    rng = np.random.default_rng(seed + 100 * d + L)
    table = rng.standard_normal((V, d)).astype(np.float32)
    table[0] = -np.abs(table[0]) - 0.25
    ids = rng.integers(0, V, (N_BAGS, L)).astype(np.int32)
    ids[:, : L // 2] = 0
    ids[1] = 0                                     # an all-padding bag
    if weights == "masked":
        w = (ids > 0).astype(np.float32)
    elif weights == "random":
        w = rng.standard_normal((N_BAGS, L)).astype(np.float32)
    else:
        w = None
    return table, ids, w


def _pallas(table, ids, w):
    if w is None:
        w = np.ones(ids.shape, np.float32)
    return np.asarray(embedding_bag_fixed(jnp.asarray(table),
                                          jnp.asarray(ids), jnp.asarray(w),
                                          interpret=True))


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _sum_bound(table, ids, w, L):
    w = np.ones(ids.shape, np.float32) if w is None else w
    mass = np.abs(table[ids].astype(np.float64) * w[..., None]).sum(1)
    return 2 * L * U * mass


@pytest.mark.parametrize("weights", ["masked", "unit", "random"])
@pytest.mark.parametrize("L", [1, 39, 50])
@pytest.mark.parametrize("d", [1, 10, 64, 256])
def test_plain_bit_equal_to_pallas_interpret(d, L, weights):
    table, ids, w = _case(d, L, None if weights == "unit" else weights)
    got = T_ref.embedding_bag_ref(_t(table), _t(ids), _t(w)).numpy()
    want = _pallas(table, ids, w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if weights == "masked":
        # the all-padding bag over the negative pad row: -0.0 everywhere
        assert np.all(got[1] == 0) and np.all(np.signbit(got[1]))


@pytest.mark.parametrize("weights", ["masked", "unit", "random"])
@pytest.mark.parametrize("d,L", [(1, 39), (10, 50), (64, 50), (256, 50)])
def test_plain_within_fp32_sum_bound_of_jnp_oracle(d, L, weights):
    table, ids, w = _case(d, L, None if weights == "unit" else weights,
                          seed=1)
    w1 = np.ones(ids.shape, np.float32) if w is None else w
    got = T_ops.embedding_bag(_t(table), _t(ids), _t(w)).numpy()
    want = np.asarray(J_ref(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(w1)))
    assert np.all(np.abs(got - want) <= _sum_bound(table, ids, w, L))


@pytest.mark.parametrize("d", [1, 10, 64])
def test_combiners_and_default_weights(d):
    """``sum`` and ``mean``, with weights or None, as the reference's
    ``ops.embedding_bag``: bit-equal to its kernel path where the
    normalising sum is exact (unit and 0/1 weights), within the sum
    bound where it is not."""
    L = 39
    for weights in (None, "masked"):
        table, ids, w = _case(d, L, weights, seed=2)
        for combiner in ("sum", "mean"):
            got = T_ops.embedding_bag(_t(table), _t(ids), _t(w),
                                      combiner=combiner).numpy()
            want = np.asarray(J_ops.embedding_bag(
                jnp.asarray(table), jnp.asarray(ids),
                None if w is None else jnp.asarray(w), combiner=combiner,
                interpret=True))
            np.testing.assert_array_equal(_bits(got), _bits(want))
    table, ids, w = _case(d, L, "random", seed=3)
    got = T_ops.embedding_bag(_t(table), _t(ids), _t(w),
                              combiner="mean").numpy()
    want = np.asarray(J_ops.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w),
        combiner="mean", use_kernel=False))
    wm = w / np.maximum(w.sum(1, keepdims=True), 1e-9)
    assert np.all(np.abs(got - want) <= 2 * _sum_bound(table, ids, wm, L))


def test_pooled_lookup_matches_reference():
    """The port's pooled_lookup (embedding_bag) against the reference's
    single-device ``core/sharded.pooled_lookup`` (take + sum) on a
    two-tower-shaped input: masked history, 1-based ids."""
    rng = np.random.default_rng(4)
    table = (rng.standard_normal((1000, 32)) / np.sqrt(32)).astype(
        np.float32)
    hist = rng.integers(0, 1000, (16, 50))
    hist[:, :20] = 0
    mask = (hist > 0).astype(np.float32)
    got = T_sharded.pooled_lookup(_t(table), torch.from_numpy(hist),
                                  _t(mask)).numpy()
    want = np.asarray(J_sharded.pooled_lookup(
        jnp.asarray(table), jnp.asarray(hist), jnp.asarray(mask)))
    assert np.all(np.abs(got - want) <= _sum_bound(table, hist, mask, 50))
    np.testing.assert_array_equal(
        _bits(got), _bits(_pallas(table, hist.astype(np.int32), mask)))


@pytest.mark.parametrize("bad", [-1, V])
def test_out_of_range_id_refused(bad):
    table, ids, w = _case(10, 5, "masked")
    ids[2, 3] = bad
    with pytest.raises(IndexError, match="outside"):
        T_ops.embedding_bag(_t(table), _t(ids), _t(w))


def test_int64_ids_and_empty_bags():
    table, ids, w = _case(10, 7, "random")
    a = T_ops.embedding_bag(_t(table), _t(ids), _t(w))
    b = T_ops.embedding_bag(_t(table), _t(ids.astype(np.int64)), _t(w))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    out = T_ops.embedding_bag(_t(table), torch.zeros((0, 7), dtype=torch.long))
    assert out.shape == (0, 10)
    with pytest.raises(ValueError, match="combiner"):
        T_ops.embedding_bag(_t(table), _t(ids), combiner="max")
