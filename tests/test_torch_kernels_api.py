"""The JAX package's public kernel names that the port now has too
(``kernels/jpq_scores/ops.jpq_scores``, ``kernels/jpq_scores/ref.
jpq_scores_ref``, ``kernels/jpq_topk/ref.jpq_topk_ref``), each held
against its JAX namesake on the CPU: the reference's ``ops.jpq_scores``
runs its Pallas kernel in interpret mode.

Tolerances: the scores within 1e-5 of their largest magnitude (the fp32
LUT einsums differ by rounding; on one shared LUT the gather-sums are
bit-equal, tests/test_torch_jpq_scores.py); the top-k ids equal and the
values within the same bound, on scores with no near-ties; on an
all-tied catalogue (zero centroids) the ids are 0..k-1, the smaller id
first as ``lax.top_k`` orders them.  ``ops.jpq_scores`` is
differentiable: its gradient in ``h`` and the centroids against
``jax.grad`` of the reference's ``jpq_scores_ref``, by the rule of
tests/test_torch_recsys_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jpq_scores import ops as J_ops
from repro.kernels.jpq_scores import ref as J_ref
from repro.kernels.jpq_topk import ref as J_topk_ref
from repro_torch.kernels.jpq_scores import ops as T_ops
from repro_torch.kernels.jpq_scores import ref as T_ref
from repro_torch.kernels.jpq_topk import ref as T_topk_ref

# lead shape of h, m, b, dk, N, codes dtype
CASES = [((4,), 4, 16, 8, 300, np.uint8),
         ((2, 3), 8, 256, 4, 1_000, np.uint8),
         ((5,), 2, 300, 16, 257, np.int32)]


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The reference kernels name ``pltpu.TPUCompilerParams``, which newer
    JAX releases call ``CompilerParams``; aliased for each test (the JAX
    package is not edited, and nothing outlives the test)."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _case(seed, lead, m, b, dk, N, code_dtype):
    r = np.random.default_rng(seed)
    h = r.standard_normal(lead + (m * dk,)).astype(np.float32)
    cent = r.standard_normal((m, b, dk)).astype(np.float32)
    codes = r.integers(0, b, (N, m)).astype(code_dtype)
    return h, cent, codes


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _t(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_jpq_scores_and_its_ref_match_the_reference(case):
    h, cent, codes = _case(case, *CASES[case])
    want = J_ref.jpq_scores_ref(jnp.asarray(h), jnp.asarray(cent),
                                jnp.asarray(codes))
    kern = J_ops.jpq_scores(jnp.asarray(h), jnp.asarray(cent),
                            jnp.asarray(codes))
    th, tc, tk = _t(h, cent, codes)
    got_ref = T_ref.jpq_scores_ref(th, tc, tk)
    got_ops = T_ops.jpq_scores(th, tc, tk)
    assert got_ops.dtype == torch.float32
    for got in (got_ref, got_ops):
        _close(got.numpy(), want)
        _close(got.numpy(), kern)
    # the plain version on the CPU: the same bits as the ref
    assert torch.equal(got_ops, got_ref)


def test_jpq_scores_gradient_matches_jax_grad():
    h, cent, codes = _case(7, *CASES[0])
    g = np.random.default_rng(8).standard_normal(
        h.shape[:-1] + (codes.shape[0],)).astype(np.float32)
    jg = jax.grad(lambda hh, cc: jnp.sum(J_ref.jpq_scores_ref(
        hh, cc, jnp.asarray(codes)) * g), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(cent))
    th, tc, tk = _t(h, cent, codes)
    th.requires_grad_(True)
    tc.requires_grad_(True)
    (T_ops.jpq_scores(th, tc, tk) * torch.from_numpy(g)).sum().backward()
    pairs = [(th.grad.numpy(), np.asarray(jg[0])),
             (tc.grad.numpy(), np.asarray(jg[1]))]
    floor = 1e-6 * max(np.abs(w).max() for _, w in pairs)
    for got, want in pairs:
        assert np.abs(got - want).max() <= max(1e-5 * np.abs(want).max(),
                                               floor)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("k", [1, 10])
def test_jpq_topk_ref_matches_the_reference(case, k):
    h, cent, codes = _case(case + 10, *CASES[case])
    jv, ji = J_topk_ref.jpq_topk_ref(jnp.asarray(h), jnp.asarray(cent),
                                     jnp.asarray(codes), k)
    tv, ti = T_topk_ref.jpq_topk_ref(*_t(h, cent, codes), k)
    assert tv.shape == tuple(jv.shape) and ti.dtype == torch.int32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tv.numpy(), jv)


def test_jpq_topk_ref_ties_go_to_the_smaller_id():
    h, cent, codes = _case(3, *CASES[0])
    cent = np.zeros_like(cent)
    jv, ji = J_topk_ref.jpq_topk_ref(jnp.asarray(h), jnp.asarray(cent),
                                     jnp.asarray(codes), 7)
    tv, ti = T_topk_ref.jpq_topk_ref(*_t(h, cent, codes), 7)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [list(range(7))] * h.shape[0]
    # more k than items: all N, as lax.top_k(min(k, N)) gives them
    _, ti = T_topk_ref.jpq_topk_ref(*_t(h, cent, codes[:5]), 9)
    assert ti.shape == (h.shape[0], 5)
