"""Parity of the port's jpq_scores module (repro_torch.kernels.jpq_scores)
with the JAX reference, on the CPU.

On a CPU tensor the port's wrappers run the kernels' plain versions, so
these tests hold the plain forward and backward against the reference:
its gather oracle and its Pallas kernel in interpret mode (forward),
and ``jax.grad`` of ``core/jpq.logits`` through the gathers (backward;
the reference's Pallas kernel has no gradient).  The CUDA kernels are
held against the plain versions in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jpq as J_jpq
from repro.kernels.jpq_scores.jpq_scores import jpq_scores_lut as J_lut
from repro.kernels.jpq_scores.ops import jpq_scores as J_scores
from repro.kernels.jpq_scores.ref import jpq_scores_lut_ref as J_lut_ref
from repro.nn import module as J_nn
from repro_torch.core import jpq as T_jpq
from repro_torch.kernels.jpq_scores import cuda as T_cuda
from repro_torch.kernels.jpq_scores import ops as T_ops
from repro_torch.kernels.jpq_scores import ref as T_ref

CASES = [
    # T, m, b, N, codes dtype
    (3, 1, 2, 7, np.uint8),
    (5, 4, 16, 300, np.uint8),
    (9, 8, 256, 2_000, np.uint8),
    (4, 3, 300, 500, np.int32),
]


def _lut_case(seed, T, m, b, N, code_dtype, lut="normal"):
    rng = np.random.default_rng(seed)
    if lut == "normal":
        P = rng.standard_normal((T, m, b)).astype(np.float32)
    else:                                          # ties and signed zeros
        P = rng.integers(-1, 2, (T, m, b)).astype(np.float32)
        P[P == 0] = -0.0
    return P, rng.integers(0, b, (N, m)).astype(code_dtype)


def _emb_case(seed, m=8, b=64, dk=8, N=3_000, lead=(3, 4)):
    rng = np.random.default_rng(seed)
    d = m * dk
    cent = (d ** -0.5 * rng.standard_normal((m, b, dk))).astype(np.float32)
    codes = rng.integers(0, b, (N, m)).astype(np.uint8)
    h = rng.standard_normal((*lead, d)).astype(np.float32)
    return cent, codes, h


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("lut", ["normal", "zeros"])
@pytest.mark.parametrize("case", CASES, ids=[str(c[:4]) for c in CASES])
def test_plain_forward_bit_equal_to_reference_oracle(case, lut):
    """Tolerance 0 (as bits): both sum the same fp32 gathers in split
    order j = 0..m-1."""
    P, codes = _lut_case(0, *case, lut=lut)
    want = J_lut_ref(jnp.asarray(P), jnp.asarray(codes).astype(jnp.int32))
    got = T_ops.jpq_scores_lut(torch.tensor(P), torch.tensor(codes))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("case", CASES, ids=[str(c[:4]) for c in CASES])
def test_plain_forward_equals_pallas_interpret(case):
    """assert_array_equal (-0.0 == +0.0): the TPU kernel's one-hot
    products pick each LUT entry exactly, and its fp32 accumulation in
    split order equals the gather-sum up to the sign of a zero sum."""
    T, m, b, N, cd = case
    P, codes = _lut_case(1, *case)
    Np = -(-N // 128) * 128
    Tp = -(-T // 8) * 8
    Pp = np.pad(P, ((0, Tp - T), (0, 0), (0, 0)))
    cp = np.pad(codes, ((0, Np - N), (0, 0)))
    want = np.asarray(J_lut(jnp.asarray(Pp), jnp.asarray(cp), block_b=Tp,
                            block_n=128, interpret=True))[:T, :N]
    got = T_ops.jpq_scores_lut(torch.tensor(P), torch.tensor(codes))
    np.testing.assert_array_equal(want, got.numpy())


def test_logits_use_kernel_against_reference():
    """core.jpq.logits with use_kernel=True against the reference's
    logits, gather path and Pallas path (interpret): within 1e-6 on O(1)
    scores — the LUT einsum differs between the frameworks by up to
    about 2.4e-7 per entry, and m = 8 entries add."""
    cent, codes, h = _emb_case(2)
    jp = {"centroids": J_nn.P(jnp.asarray(cent), None),
          "codes": J_nn.P(jnp.asarray(codes), None)}
    tp = {"centroids": torch.tensor(cent), "codes": torch.tensor(codes)}
    got = T_jpq.logits(tp, torch.tensor(h), use_kernel=True).numpy()
    assert got.shape == (3, 4, 3_000)
    np.testing.assert_allclose(
        np.asarray(J_jpq.logits(jp, jnp.asarray(h))), got, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(J_scores(jnp.asarray(h), jnp.asarray(cent),
                            jnp.asarray(codes), interpret=True)),
        got, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        got, T_jpq.logits(tp, torch.tensor(h)).numpy())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_backward_against_jax_grad_of_gathers(use_kernel):
    """dh and dcentroids of sum(w * logits) against jax.grad of the
    reference's gather path (its Pallas kernel has no gradient):
    rtol 1e-5, atol 2e-5 — each centroid's gradient is an fp32 sum of
    ~560 O(1) terms (12 positions × ~47 items per bin), whose rounding,
    in another order, reaches ~√560 · 2^-24 · 10 ≈ 1.4e-5."""
    cent, codes, h = _emb_case(3)
    w = np.random.default_rng(4).standard_normal((3, 4, 3_000)).astype(
        np.float32)

    def j_loss(c, hh):
        p = {"centroids": J_nn.P(c, None),
             "codes": J_nn.P(jnp.asarray(codes), None)}
        return jnp.sum(jnp.asarray(w) * J_jpq.logits(p, hh))

    jdc, jdh = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(cent),
                                                jnp.asarray(h))
    tc = torch.tensor(cent, requires_grad=True)
    th = torch.tensor(h, requires_grad=True)
    s = T_jpq.logits({"centroids": tc, "codes": torch.tensor(codes)}, th,
                     use_kernel=use_kernel)
    torch.sum(torch.tensor(w) * s).backward()
    np.testing.assert_allclose(np.asarray(jdc), tc.grad.numpy(), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(jdh), th.grad.numpy(), rtol=1e-5,
                               atol=2e-5)


def test_plain_backward_is_the_transpose():
    """The plain backward against a dense one-hot product in float64:
    dP[t, j, :] = dS[t] @ onehot(codes[:, j]) (tolerance 1e-12)."""
    T, m, b, N = 4, 3, 10, 200
    rng = np.random.default_rng(5)
    codes = rng.integers(0, b, (N, m))
    dS = rng.standard_normal((T, N))
    want = np.stack([dS @ np.eye(b)[codes[:, j]] for j in range(m)], 1)
    got = T_ref.jpq_scores_lut_bwd_ref(torch.tensor(dS), torch.tensor(codes),
                                       b)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_gradcheck_float64():
    """torch.autograd.gradcheck of JPQScores in float64 on a tiny case."""
    rng = np.random.default_rng(6)
    P = torch.tensor(rng.standard_normal((3, 2, 5)), requires_grad=True)
    codes = torch.tensor(rng.integers(0, 5, (11, 2)).astype(np.uint8))
    assert torch.autograd.gradcheck(
        lambda p: T_ops.JPQScores.apply(p, codes), (P,))


def test_output_may_be_written_in_place():
    """The Function saves codes only, so masking its output in place (as
    SeqRecModel._mask_special does) keeps the gradient right: the
    overwritten columns get none."""
    P = torch.randn(2, 2, 4, requires_grad=True)
    codes = torch.tensor([[0, 1], [2, 3], [1, 1]], dtype=torch.uint8)
    s = T_ops.JPQScores.apply(P, codes)
    s[:, 0] = -1e9
    s.sum().backward()
    want = torch.zeros(2, 2, 4)
    for i in (1, 2):
        for j in range(2):
            want[:, j, int(codes[i, j])] += 1.0
    torch.testing.assert_close(P.grad, want)


def test_cuda_wrappers_take_cuda_tensors_only():
    P, codes = _lut_case(7, 2, 2, 4, 9, np.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_cuda.jpq_scores(torch.tensor(P), torch.tensor(codes))
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_cuda.jpq_scores_bwd(torch.zeros(2, 9), torch.tensor(codes), 4)


# ------------------------------------------- the backward's sorted lists
#
# The CUDA backward sorts each tile's codes once a call, then walks each
# bin's list of items.  Its plain pieces (the sort, the chunking, the
# chain length behind its error bound) are held here against numpy, and
# a numpy walk over the plain sort, as the kernel walks it, against the
# plain backward.

SORTS = [
    # name, N, m, b, codes dtype, share of split 0 at code 3
    ("ragged", 1_300, 4, 16, np.uint8, 0.0),     # N % 512 != 0
    ("one tile", 200, 3, 300, np.int32, 0.0),    # b > 256
    ("skewed", 1_536, 8, 256, np.uint8, 0.85),   # one code holds 85%
    ("whole tiles", 1_024, 2, 4, np.uint8, 0.0),
]


def _sort_case(N, m, b, cd, skew, seed=11):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, (N, m))
    codes[rng.random(N) < skew, 0] = 3
    return codes.astype(cd)


@pytest.mark.parametrize("case", SORTS, ids=[c[0] for c in SORTS])
def test_sort_codes_plain_matches_stable_argsort(case):
    _, N, m, b, cd, skew = case
    codes = _sort_case(N, m, b, cd, skew)
    lists, starts = T_cuda.sort_codes_plain(torch.tensor(codes), b)
    C = T_cuda.BWD_TILE
    n_tiles = -(-N // C)
    assert lists.shape == (n_tiles, m, C)
    assert starts.shape == (n_tiles, m * b + 1)
    for t in range(n_tiles):
        tile = codes[t * C:(t + 1) * C]
        nv = tile.shape[0]
        for j in range(m):
            order = np.argsort(tile[:, j], kind="stable")
            np.testing.assert_array_equal(lists[t, j, :nv].numpy(), order)
            assert bool((lists[t, j, nv:] == C).all())
            first = np.searchsorted(np.sort(tile[:, j]), np.arange(b))
            np.testing.assert_array_equal(
                starts[t, j * b:(j + 1) * b].numpy(), j * C + first)
        assert int(starts[t, -1]) == m * C


def _walk(dS, codes, b, chunks):
    """The CUDA backward's arithmetic in numpy: each bin's list walked
    tile by tile in float32 from +0.0 within a chunk, then the chunk
    partials summed in order."""
    lists, starts = T_cuda.sort_codes_plain(torch.tensor(codes), b)
    lists, starts = lists.numpy(), starts.numpy()
    T, N = dS.shape
    m = codes.shape[1]
    C = T_cuda.BWD_TILE
    tpc, n_chunks = T_cuda.bwd_chunking(N, chunks)
    staged = np.zeros((T, C + 1), np.float32)      # column C is +0.0
    part = np.zeros((n_chunks, T, m * b), np.float32)
    for t in range(lists.shape[0]):
        staged[:, :C] = 0.0
        seg = dS[:, t * C:(t + 1) * C]
        staged[:, :seg.shape[1]] = seg
        flat = lists[t].reshape(-1)
        acc = part[t // tpc]
        for k in range(m * b):
            for p in range(starts[t, k], starts[t, k + 1]):
                acc[:, k] = acc[:, k] + staged[:, flat[p]]
    out = part[0]
    for q in range(1, n_chunks):
        out = out + part[q]
    return out.reshape(T, m, b)


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("case", SORTS[:3], ids=[c[0] for c in SORTS[:3]])
def test_sorted_walk_gives_the_backward(case, chunks):
    """One chunk: bit-equal to the plain backward (index_add_ sums each
    bin in ascending item order from +0.0).  Three: within
    gamma(chain - 1) sum|terms| of float64, chain from bwd_chain."""
    _, N, m, b, cd, skew = case
    codes = _sort_case(N, m, b, cd, skew)
    rng = np.random.default_rng(12)
    dS = (rng.standard_normal((3, N))
          * np.exp(2 * rng.standard_normal((3, N)))).astype(np.float32)
    got = _walk(dS, codes, b, chunks)
    ct = torch.tensor(codes)
    if chunks == 1:
        want = T_ref.jpq_scores_lut_bwd_ref(torch.tensor(dS), ct, b)
        np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))
    exact = T_ref.jpq_scores_lut_bwd_ref(torch.tensor(dS).double(), ct, b)
    mass = T_ref.jpq_scores_lut_bwd_ref(torch.tensor(dS).double().abs(),
                                        ct, b)
    n = T_cuda.bwd_chain(ct, b, chunks).double() - 1
    u = 2.0 ** -24
    lim = (n * u / (1 - n * u)) * mass
    assert bool(((torch.tensor(got).double() - exact).abs() <= lim).all())


def test_bwd_chain_counts_the_longest_chain():
    codes = _sort_case(1_300, 4, 16, np.uint8, 0.6)
    for chunks in (1, 2, 3, 50):
        tpc, n_chunks = T_cuda.bwd_chunking(1_300, chunks)
        span = tpc * T_cuda.BWD_TILE
        want = np.zeros((4, 16), np.int64)
        for q in range(n_chunks):
            part = codes[q * span:(q + 1) * span]
            for j in range(4):
                want[j] = np.maximum(want[j],
                                     np.bincount(part[:, j], minlength=16))
        got = T_cuda.bwd_chain(torch.tensor(codes), 16, chunks)
        np.testing.assert_array_equal(got.numpy(), want + n_chunks - 1)


@pytest.mark.parametrize("N, chunks, want", [
    (1_000_002, 1, (1954, 1)), (1_000_002, 3, (652, 3)),
    (1_000_002, 10_000, (1, 1954)), (1_300, 2, (2, 2)), (1_300, 0, (3, 1)),
    (512, 4, (1, 1)), (1, 1, (1, 1))])
def test_bwd_chunking(N, chunks, want):
    assert T_cuda.bwd_chunking(N, chunks) == want


@pytest.mark.parametrize("T, mb, N, sms, want", [
    (3_200, 2_048, 1_000_002, 132, 7),   # 1,400 blocks: 96% of 11 waves
    (512, 2_048, 1_000_002, 132, 4),     # 128 blocks: one wave
    (1, 2_048, 5_000, 132, 5),           # 10 tiles: at most 10 chunks
    (64, 64, 1_024, 132, 2)])            # 2 tiles
def test_bwd_auto_chunks_fills_the_last_wave(T, mb, N, sms, want):
    got = T_cuda.bwd_auto_chunks(T, 8, mb // 8, N, sms)
    assert got == want
    per = -(-mb // T_cuda.BWD_BINS) * -(-T // 32)

    def fill(c):
        blocks = per * T_cuda.bwd_chunking(N, c)[1]
        return blocks / (-(-blocks // sms) * sms)

    assert all(fill(got) >= fill(c) for c in range(1, 9))


# The forward's query group G comes from the library (jpq_scores_fwd_group,
# held by tests/test_torch_cuda.py on the card: 24 at m*b = 2,048, 20 at
# b = 300, 28 at the most) and its warp step of 32 items likewise.
FWD_STEP = 32


@pytest.mark.parametrize("T, G, N, sms, want", [
    (3_200, 24, 1_000_002, 132, 16),  # 2,144 blocks: 95.5% of 17 waves
    (256, 24, 1_000_002, 132, 12),    # eval: 132 blocks, one wave
    (512, 24, 1_000_002, 132, 6),     # 132 blocks, one wave
    (1, 24, 5_000, 132, 16),          # one group: the most ranges
    (29, 24, 40, 132, 2),             # 2 warp steps: at most 2 ranges
    (3_200, 20, 1_000_002, 132, 14),  # b = 300: 2,240 blocks of 2,244
    (3_200, 28, 1_000_002, 132, 8),   # the most queries: 920 of 924
    (3_200, 24, 1_000_002, 114, 11),  # 114 SMs: 1,474 blocks of 1,482
    (256, 24, 1_000_002, 78, 7),      # 78 SMs: 77 blocks, one wave
    (9, 4, 3_001, 132, 16),           # the largest LUT: 4 queries a block
    (17, 8, 3_001, 132, 16),
    (30, 12, 5_000, 132, 16),         # m = 16
    (25, 24, 70_001, 132, 16),        # two groups, one of them ragged
])
def test_fwd_plan_fills_the_last_wave(T, G, N, sms, want):
    ranges, per = T_cuda.fwd_plan(T, G, N, sms, FWD_STEP)
    assert ranges == want
    assert per % FWD_STEP == 0
    assert (ranges - 1) * per < N <= ranges * per     # none empty, all of N
    groups = -(-T // G)

    def fill(blocks):
        return blocks / (-(-blocks // sms) * sms)

    steps = -(-N // FWD_STEP)
    for r in range(1, min(T_cuda.FWD_RANGES_MAX, steps) + 1):
        p = -(-steps // r)
        assert fill(groups * ranges) >= fill(groups * -(-steps // p))
