"""Parity of the port's PQTopK module (repro_torch.kernels.jpq_topk)
with the JAX reference, on the CPU.

On a CPU tensor the port's wrappers run the kernels' plain versions, so
these tests hold the plain PyTorch algorithm against the reference's
Pallas kernel in interpret mode, its "scan" backend and its
materialise oracle, on shared numpy inputs.  Tolerance: none — values
(compared as bits) and tie-broken ids must be equal.  The CUDA kernels
themselves are held against the plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jpq_topk import ops as J
from repro.kernels.jpq_topk.jpq_topk import desc_sort_key, topk_total_order
from repro.kernels.jpq_topk.ref import jpq_topk_lut_ref as J_ref
from repro_torch.kernels.jpq_topk import cuda as T_cuda
from repro_torch.kernels.jpq_topk import ops as T
from repro_torch.kernels.jpq_topk.ref import jpq_topk_lut_ref as T_ref

JAX_BACKENDS = ["interpret", "scan"]


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The reference kernels name ``pltpu.TPUCompilerParams``, which newer
    JAX releases call ``CompilerParams``; alias it for the duration of
    each test so the interpret backend runs (the JAX package is not
    edited, and nothing outlives the test)."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_same(jv, ji, tv, ti, msg=""):
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()),
                                  err_msg=f"{msg} values")
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy(),
                                  err_msg=f"{msg} ids")


def _case(seed, B, m, b, N, *, lut="normal"):
    rng = np.random.default_rng(seed)
    if lut == "normal":
        P = rng.standard_normal((B, m, b)).astype(np.float32)
    elif lut == "ties":
        P = rng.integers(0, 3, (B, m, b)).astype(np.float32)
    else:                                    # signed zeros: all zeros -0.0
        P = rng.integers(-1, 2, (B, m, b)).astype(np.float32)
        P[P == 0] = -0.0
    codes = rng.integers(0, b, (N, m)).astype(np.int32)
    return P, codes


def _structured(seed=0, B=4, m=4, b=32, N=2048):
    """Popularity-structured codes: low ranks use low codes, which the
    LUT favours — so the bound skips tiles, more so in rank order."""
    rng = np.random.default_rng(seed)
    rank = rng.permutation(N)
    codes = np.clip(rank[:, None] * b // N + rng.integers(0, 2, (N, m)),
                    0, b - 1).astype(np.int32)
    P = (-(np.arange(b) / b)[None, None, :] * 4.0
         + 0.1 * rng.standard_normal((B, m, b))).astype(np.float32)
    return P, codes, np.argsort(rank, kind="stable")


UNPRUNED_CASES = [
    # (B, m, b, N, k, block_n, lut)
    (3, 4, 16, 1000, 17, 128, "normal"),     # N % block_n != 0
    (2, 2, 8, 40, 64, 128, "normal"),        # k > N clamps to N
    (4, 2, 4, 300, 40, 64, "ties"),          # tie-heavy
    (3, 2, 8, 300, 40, 64, "zeros"),         # ±0.0 LUT entries
]


class TestUnprunedParity:
    @pytest.mark.parametrize("backend", JAX_BACKENDS)
    @pytest.mark.parametrize("case", UNPRUNED_CASES,
                             ids=[c[-1] + str(c[3]) for c in UNPRUNED_CASES])
    def test_bit_equal_to_jax(self, backend, case):
        B, m, b, N, k, bn, lut = case
        P, codes = _case(1, B, m, b, N, lut=lut)
        jv, ji = J.jpq_topk_lut(jnp.asarray(P), jnp.asarray(codes), k,
                                block_n=bn, backend=backend)
        tv, ti = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), k,
                                block_n=bn)
        _assert_same(jv, ji, tv, ti, backend)
        assert tv.shape == (B, min(k, N))

    @pytest.mark.parametrize("case", UNPRUNED_CASES,
                             ids=[c[-1] + str(c[3]) for c in UNPRUNED_CASES])
    def test_bit_equal_to_materialise_oracles(self, case):
        B, m, b, N, k, bn, lut = case
        P, codes = _case(2, B, m, b, N, lut=lut)
        canon = np.where(P == 0, np.float32(0), P)
        jv, ji = J_ref(jnp.asarray(canon), jnp.asarray(codes), k)
        rv, ri = T_ref(torch.tensor(canon), torch.tensor(codes), k)
        tv, ti = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), k,
                                block_n=bn)
        _assert_same(jv, ji, rv, ri, "oracle")
        _assert_same(jv, ji, tv, ti, "fused")
        assert not np.any(np.signbit(tv.numpy()) & (tv.numpy() == 0))

    def test_uint8_codes_and_default_block(self):
        P, codes = _case(3, 3, 4, 16, 700)
        jv, ji = J.jpq_topk_lut(jnp.asarray(P), jnp.asarray(codes), 21,
                                backend="scan")
        tv, ti = T.jpq_topk_lut(torch.tensor(P),
                                torch.tensor(codes.astype(np.uint8)), 21)
        _assert_same(jv, ji, tv, ti)

    def test_from_h_entrypoint_and_leading_dims(self):
        rng = np.random.default_rng(4)
        cent = rng.standard_normal((2, 8, 4)).astype(np.float32)
        codes = rng.integers(0, 8, (30, 2)).astype(np.int32)
        h = rng.standard_normal((3, 5, 8)).astype(np.float32)
        jv, ji = J.jpq_topk(jnp.asarray(h), jnp.asarray(cent),
                            jnp.asarray(codes), 6, backend="scan")
        tv, ti = T.jpq_topk(torch.tensor(h), torch.tensor(cent),
                            torch.tensor(codes), 6)
        assert tv.shape == ti.shape == (3, 5, 6)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        # the LUT einsum sums in another order than XLA: fp32 rounding
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0,
                                   atol=1e-6)


class TestOrderingHelpers:
    def test_desc_sort_key_matches_jax(self):
        v = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 3e-38,
                      -3e-38, 7.5], np.float32)
        v = np.concatenate([v, np.random.default_rng(0).standard_normal(
            64).astype(np.float32)])
        np.testing.assert_array_equal(
            np.asarray(desc_sort_key(jnp.asarray(v))),
            T.desc_sort_key(torch.tensor(v)).numpy())

    def test_topk_total_order_matches_jax(self):
        rng = np.random.default_rng(5)
        v = rng.integers(-2, 3, (4, 90)).astype(np.float32)
        v[v == 0] = -0.0
        v[:, ::7] = 0.0
        ids = np.stack([rng.permutation(1000)[:90] for _ in range(4)]
                       ).astype(np.int32)
        jv, ji = topk_total_order(jnp.asarray(v), jnp.asarray(ids),
                                           25)
        tv, ti = T.topk_total_order(torch.tensor(v), torch.tensor(ids), 25)
        _assert_same(jv, ji, tv, ti)

    @pytest.mark.parametrize("N", [1, 1000, 131072, 1_000_448, 5_000_000])
    def test_block_sizes_match_jax(self, N):
        assert T.scan_block_n(N) == J.scan_block_n(N)
        assert T.prune_block_n(N) == J.prune_block_n(N)


def _pruned_pair(P, codes, k, bn, *, perm=None, warm=None, backend):
    jv, ji, js = J.jpq_topk_lut(
        jnp.asarray(P), jnp.asarray(codes), k, block_n=bn, backend=backend,
        prune=True, perm=None if perm is None else jnp.asarray(perm),
        warm=None if warm is None else jnp.asarray(warm), return_stats=True)
    tv, ti, ts = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), k,
                                block_n=bn, prune=True, perm=perm,
                                warm=warm, return_stats=True)
    return (jv, ji, js), (tv, ti, ts)


class TestPrunedParity:
    @pytest.mark.parametrize("backend", JAX_BACKENDS)
    @pytest.mark.parametrize("order", ["identity", "popularity"])
    def test_structured_sweep_bit_equal_and_skips(self, backend, order):
        P, codes, pop = _structured()
        perm = pop if order == "popularity" else None
        (jv, ji, js), (tv, ti, ts) = _pruned_pair(P, codes, 16, 256,
                                                  perm=perm, backend=backend)
        _assert_same(jv, ji, tv, ti, order)
        uv, ui = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), 16)
        _assert_same(uv, ui, tv, ti, "vs unpruned")
        assert ts["total_tiles"] == int(js["total_tiles"]) == 8
        if backend == "scan":
            # with no floor the skip decisions are the reference scan's
            assert int(ts["skipped_tiles"]) == int(js["skipped_tiles"])
            np.testing.assert_array_equal(ts["skips"].numpy(),
                                          np.asarray(js["skips"]))
        if order == "popularity":
            assert int(ts["skipped_tiles"]) > 0

    @pytest.mark.parametrize("backend", JAX_BACKENDS)
    @pytest.mark.parametrize("warm", ["scalar", "per_row", "overshoot"])
    def test_warm_floors(self, backend, warm):
        """Values and ids stay bit-equal under any floor; skip counts are
        not compared here — with a floor, the any-reduce granularity of a
        backend changes which tiles a row sees."""
        P, codes, pop = _structured(seed=1)
        k = 16
        theta = T_ref(torch.tensor(P), torch.tensor(codes), k)[0][:, -1]
        theta = theta.numpy()
        floor = {"scalar": float(theta.min()) - 0.5,
                 "per_row": theta - 0.25,
                 "overshoot": np.where(np.arange(len(theta)) % 2 == 0,
                                       theta + 1.0, theta - 1.0
                                       ).astype(np.float32)}[warm]
        (jv, ji, js), (tv, ti, ts) = _pruned_pair(
            P, codes, k, 256, perm=pop, warm=floor, backend=backend)
        _assert_same(jv, ji, tv, ti, warm)
        uv, ui = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), k)
        _assert_same(uv, ui, tv, ti, "vs unpruned")
        np.testing.assert_array_equal(np.asarray(js["demoted"]),
                                      ts["demoted"].numpy())
        if warm == "overshoot":
            assert ts["demoted"].numpy()[::2].all()
            assert not ts["demoted"].numpy()[1::2].any()
        else:
            assert not ts["demoted"].any()

    @pytest.mark.parametrize("order", ["identity", "popularity"])
    def test_random_catalogue_matches_scan_stats(self, order):
        P, codes = _case(6, 3, 4, 16, 1000)
        perm = np.random.default_rng(6).permutation(1000) \
            if order == "popularity" else None
        (jv, ji, js), (tv, ti, ts) = _pruned_pair(P, codes, 9, 128,
                                                  perm=perm, backend="scan")
        _assert_same(jv, ji, tv, ti, order)
        assert int(ts["skipped_tiles"]) == int(js["skipped_tiles"])
        np.testing.assert_array_equal(ts["theta"].numpy(),
                                      np.asarray(js["theta"]))

    def test_prune_state_rebuild_keeps_ids(self):
        P, codes, pop = _structured(seed=2)
        st = T.prepare_pruning(torch.tensor(codes.astype(np.uint8)), 32, 128,
                               perm=pop)
        v, i = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), 12,
                              prune=st, block_n=512)
        jv, ji = J_ref(jnp.asarray(P), jnp.asarray(codes), 12)
        _assert_same(jv, ji, v, i, "rebuilt state")
        # the state's own tile size wins when block_n is not given
        v2, i2, s2 = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), 12,
                                    prune=st, return_stats=True)
        assert s2["total_tiles"] == 16
        _assert_same(jv, ji, v2, i2, "prebuilt state")

    def test_permuted_ids_cap(self):
        codes = torch.zeros((2 ** 24, 1), dtype=torch.uint8)
        with pytest.raises(ValueError, match="2\\^24"):
            T.prepare_pruning(codes, 2, 8192, perm=np.zeros(1, np.int64))


class TestNoHiddenFallback:
    def test_kernel_wrapper_refuses_cpu_tensors(self):
        P, codes = _case(7, 2, 2, 4, 50)
        with pytest.raises(ValueError, match="CUDA tensors"):
            T_cuda.jpq_topk(torch.tensor(P), torch.tensor(codes), 5)

    def test_k_above_kernel_limit_names_it(self):
        P, codes = _case(7, 2, 2, 4, 50)
        with pytest.raises(ValueError, match="k <= 1024"):
            T_cuda.jpq_topk(torch.tensor(P), torch.tensor(codes), 2000)

    def test_backend_must_match_the_device(self):
        """The tensor's device alone picks the backend: a CPU LUT runs
        the plain version (no kernel launch), and there is no knob to
        ask for another."""
        P, codes = _case(7, 2, 2, 4, 50)
        before = dict(T_cuda.launches)
        v, i = T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), 5)
        assert T_cuda.launches == before
        pv, pi = T.jpq_topk_scan(torch.tensor(P), torch.tensor(codes), 5,
                                 block_n=128)
        assert torch.equal(v, pv) and torch.equal(i, pi)
        with pytest.raises(TypeError, match="backend"):
            T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), 5,
                           backend="cuda")

    def test_stats_and_warm_need_pruning(self):
        P, codes = _case(7, 2, 2, 4, 50)
        with pytest.raises(ValueError, match="pruned-path"):
            T.jpq_topk_lut(torch.tensor(P), torch.tensor(codes), 5,
                           warm=0.0)


# The unpruned kernel's query group G comes from the library
# (jpq_topk_group, held by tests/test_torch_cuda.py on the card: 24 at
# k = 10 and m*b = 2,048, 20 at k = 100, 8 at k = 1,024) and its block
# step of 512 items likewise.
TOPK_STEP = 512


class TestRangePlan:
    @pytest.mark.parametrize("B, G, N, sms, want", [
        (512, 24, 1_000_448, 132, 6),     # the serving shape: 132 blocks
        (512, 20, 1_000_448, 132, 5),     # k = 100: 130 blocks, one wave
        (512, 8, 1_000_448, 132, 2),      # k = 1,024: 128 blocks
        (512, 24, 1_000_448, 114, 5),     # 114 SMs: 110 blocks, one wave
        (1, 24, 1_000_448, 132, 123),     # one group: many short ranges
        (23, 24, 70_001, 132, 69),        # one ragged group
        (25, 24, 70_001, 132, 46),        # two groups, 137 block steps
        (3, 28, 200, 132, 1),             # one block step: one range
    ])
    def test_range_plan_ends_soonest(self, B, G, N, sms, want):
        ranges, per = T_cuda.range_plan(B, G, N, sms, TOPK_STEP)
        assert ranges == want
        assert per % TOPK_STEP == 0
        assert (ranges - 1) * per < N <= ranges * per  # none empty, all N
        groups = -(-B // G)

        def makespan(ranges, per):
            waves = -(-groups * ranges // sms)
            return waves * (per + T_cuda.RANGE_COST)

        steps = -(-N // TOPK_STEP)
        for r in range(1, min(T_cuda.RANGES_MAX, steps) + 1):
            p = -(-steps // r) * TOPK_STEP
            assert makespan(ranges, per) <= makespan(-(-N // p), p)
