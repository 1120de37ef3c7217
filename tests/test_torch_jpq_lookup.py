"""Parity of the port's jpq_lookup module (repro_torch.kernels.jpq_lookup)
with the JAX reference, on the CPU.

On a CPU tensor the port's wrappers run the kernels' plain versions: the
forward against the reference's Pallas kernel in interpret mode, its
oracle and ``core/jpq.lookup`` (tolerance 0: a gather moves bits), the
backward against ``jax.grad`` of ``core/jpq.lookup`` (the Pallas kernel
has no gradient).  The CUDA kernels are held against the plain versions
in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jpq as J_jpq
from repro.kernels.jpq_lookup.ops import jpq_lookup as J_lookup
from repro.kernels.jpq_lookup.ref import jpq_lookup_ref as J_ref
from repro.nn import module as J_nn
from repro_torch.core import api as T_api
from repro_torch.core import jpq as T_jpq
from repro_torch.kernels.jpq_lookup import cuda as T_cuda
from repro_torch.kernels.jpq_lookup import ops as T_ops

CASES = [
    # N, m, b, dk, ids shape, codes dtype
    (10, 1, 2, 1, (1,), np.int32),
    (50, 4, 8, 4, (7,), np.uint8),
    (200, 8, 256, 8, (4, 6), np.uint8),
    (1000, 8, 32, 16, (33,), np.int32),
]


def _case(seed, N, m, b, dk, shape, cd):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, (N, m)).astype(cd)
    cent = rng.standard_normal((m, b, dk)).astype(np.float32)
    ids = rng.integers(0, N, shape)
    ids.reshape(-1)[: ids.size // 3] = 0              # padding positions
    return ids, codes, cent


def _jp(codes, cent):
    return {"centroids": J_nn.P(jnp.asarray(cent), None),
            "codes": J_nn.P(jnp.asarray(codes), None)}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """Newer JAX calls ``pltpu.TPUCompilerParams`` ``CompilerParams``;
    alias it for the duration of each test (the JAX package is not
    edited)."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:4]) for c in CASES])
def test_forward_bit_equal_to_reference(case):
    ids, codes, cent = _case(0, *case)
    got = T_ops.jpq_lookup(torch.tensor(ids), torch.tensor(codes),
                           torch.tensor(cent)).numpy()
    flat = jnp.asarray(ids.reshape(-1))
    np.testing.assert_array_equal(
        np.asarray(J_lookup(flat, jnp.asarray(codes), jnp.asarray(cent),
                            interpret=True)).reshape(got.shape), got)
    np.testing.assert_array_equal(
        np.asarray(J_ref(flat, jnp.asarray(codes), jnp.asarray(cent))
                   ).reshape(got.shape), got)
    np.testing.assert_array_equal(
        np.asarray(J_jpq.lookup(_jp(codes, cent), jnp.asarray(ids))), got)
    tp = {"codes": torch.tensor(codes), "centroids": torch.tensor(cent)}
    for use_kernel in (True, False):
        np.testing.assert_array_equal(
            T_jpq.lookup(tp, torch.tensor(ids), use_kernel=use_kernel
                         ).numpy(), got)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[str(c[:4]) for c in CASES])
def test_backward_against_jax_grad(case, use_kernel):
    """dcentroids of sum(w * lookup) against jax.grad of the reference's
    lookup: rtol 1e-6, atol 1e-6 (a handful of fp32 adds per bin)."""
    ids, codes, cent = _case(1, *case)
    w = np.random.default_rng(2).standard_normal(
        (*ids.shape, cent.shape[0] * cent.shape[2])).astype(np.float32)

    def j_loss(c):
        p = {"centroids": J_nn.P(c, None),
             "codes": J_nn.P(jnp.asarray(codes), None)}
        return jnp.sum(jnp.asarray(w) * J_jpq.lookup(p, jnp.asarray(ids)))

    want = jax.grad(j_loss)(jnp.asarray(cent))
    tc = torch.tensor(cent, requires_grad=True)
    out = T_jpq.lookup({"centroids": tc, "codes": torch.tensor(codes)},
                       torch.tensor(ids), use_kernel=use_kernel)
    torch.sum(torch.tensor(w) * out).backward()
    np.testing.assert_allclose(np.asarray(want), tc.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_gradcheck_float64():
    """torch.autograd.gradcheck of JPQLookup in float64 on a tiny case,
    repeated ids included."""
    rng = np.random.default_rng(3)
    cent = torch.tensor(rng.standard_normal((2, 3, 2)), requires_grad=True)
    codes = torch.tensor(rng.integers(0, 3, (6, 2)).astype(np.uint8))
    ids = torch.tensor([0, 5, 5, 2, 0])
    assert torch.autograd.gradcheck(
        lambda c: T_ops.JPQLookup.apply(ids, codes, c), (cent,))


def test_embedding_lookup_follows_use_kernel(monkeypatch):
    """Embedding.lookup passes the config's use_kernel on to core.jpq."""
    seen = []
    real = T_jpq.lookup

    def spy(p, ids, *, use_kernel=False, **kw):
        seen.append(use_kernel)
        return real(p, ids, use_kernel=use_kernel, **kw)

    monkeypatch.setattr(T_jpq, "lookup", spy)
    for uk in (True, False):
        emb = T_api.make_embedding(T_api.EmbeddingConfig(
            n_items=20, d=8, kind="jpq", m=2, b=4, use_kernel=uk))
        p = emb.init(torch.Generator().manual_seed(0), device="cpu")
        emb.lookup(p, torch.tensor([1, 2]))
    assert seen == [True, False]


def test_cuda_wrappers_take_cuda_tensors_only():
    ids, codes, cent = _case(4, *CASES[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_cuda.jpq_lookup(torch.tensor(ids), torch.tensor(codes),
                          torch.tensor(cent))
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_cuda.jpq_lookup_bwd(torch.tensor(ids), torch.tensor(codes),
                              torch.zeros(7, 4, 4), 8)


def _ascending_sum(ids, codes, dout, b):
    """dcent by an explicit fp32 loop: positions in ascending order, each
    bin starting from +0.0."""
    T, m, dk = dout.shape
    acc = np.zeros((m, b, dk), np.float32)
    splits = np.arange(m)
    for t in range(T):
        rows = codes[ids[t]].astype(np.int64)        # m distinct bins
        acc[splits, rows] = acc[splits, rows] + dout[t]
    return acc


def _order_case(name):
    rng = np.random.default_rng(5)
    if name == "negative zero":
        # split 0's code b-1 is named by one position only, whose row is
        # -0.0: that bin must come out +0.0 (+0.0 + -0.0); split 1's code
        # b-1 is named by none (+0.0 too)
        T, m, b, dk, N = 50, 2, 8, 4, 20
        codes = rng.integers(0, b - 1, (N, m)).astype(np.uint8)
        ids = rng.integers(0, N - 1, T)
        ids[7] = N - 1
        codes[N - 1, 0] = b - 1
        dout = rng.standard_normal((T, m, dk)).astype(np.float32)
        dout[7, 0] = -0.0
        return ids, codes, dout, b
    T, m, b, dk, N = 3_200, 8, 256, 64, 5_000
    codes = rng.integers(0, b, (N, m)).astype(np.uint8)
    ids = rng.integers(0, N, T)
    if name == "skewed":                 # left padding: one bin per split
        ids[rng.permutation(T)[: T * 8 // 10]] = 0
    dout = rng.standard_normal((T, m, dk)).astype(np.float32)
    return ids, codes, dout, b


@pytest.mark.parametrize("name", ["uniform", "skewed", "negative zero"])
def test_backward_ref_sums_in_ascending_order(name):
    """The order contract the CUDA backward is held to: the plain version
    (index_add_ on the CPU) is bit-equal to fp32 sums over the positions
    in ascending order from +0.0, so a bin whose only term is -0.0 (or
    that no position names) is +0.0."""
    ids, codes, dout, b = _order_case(name)
    got = T_ops.jpq_lookup_rows_bwd(torch.tensor(ids), torch.tensor(codes),
                                    torch.tensor(dout), b).numpy()
    want = _ascending_sum(ids, codes, dout, b)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if name == "negative zero":
        assert got[0, b - 1, 0] == 0 and not np.signbit(got[0, b - 1]).any()
        assert not np.signbit(got[1, b - 1]).any()
