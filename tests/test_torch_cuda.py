"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips, inside the test, where
``torch.cuda.is_available()`` is false (as on a CPU-only host); run them
on the H100 with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  Tolerance: none — values (as bits) and
ids must be equal, and skip maps equal when no floor is set.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.jpq_topk import cuda as kc
from repro_torch.kernels.jpq_topk import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _same(a, b):
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def _case(dev, seed, B, m, b, N, *, lut="normal", code_dtype=torch.uint8):
    g = torch.Generator(device=dev).manual_seed(seed)
    if lut == "normal":
        P = torch.randn((B, m, b), generator=g, device=dev)
    else:
        P = torch.randint(-1, 2, (B, m, b), generator=g, device=dev).float()
        P[P == 0] = -0.0
    codes = torch.randint(0, b, (N, m), generator=g, device=dev,
                          dtype=torch.int32).to(code_dtype)
    return ops.canonicalise_lut(P).contiguous(), codes


UNPRUNED = [
    # B, m, b, N, k, lut, codes
    (3, 4, 16, 200, 10, "normal", torch.uint8),       # the smoke config
    (7, 8, 256, 70_001, 100, "normal", torch.uint8),  # ragged last chunk
    (5, 8, 256, 70_001, 100, "zeros", torch.uint8),   # ±0.0, heavy ties
    (9, 3, 300, 40_000, 37, "normal", torch.int32),   # int32 codes, b > 256
    (6, 8, 256, 100_000, 1024, "normal", torch.uint8),  # the largest k
    (2, 2, 4, 50, 1, "zeros", torch.uint8),           # k = 1
]


@pytest.mark.parametrize("case", UNPRUNED, ids=[str(c[:5]) for c in UNPRUNED])
def test_jpq_topk_kernel_matches_plain(dev, case):
    B, m, b, N, k, lut, cd = case
    P, codes = _case(dev, 0, B, m, b, N, lut=lut, code_dtype=cd)
    before = kc.launches["jpq_topk"]
    got = kc.jpq_topk(P, codes, k)
    torch.cuda.synchronize()
    assert kc.launches["jpq_topk"] == before + 2    # chunk pass + merge
    want = ops.jpq_topk_scan(P, codes, k, block_n=ops.scan_block_n(N))
    assert _same(got, want)


@pytest.mark.parametrize("block_n", [1000, 4096, 70_001])
def test_jpq_topk_block_n_sets_the_kernel_chunk(dev, block_n):
    """An explicit block_n is the unpruned kernel's chunk; the result
    does not depend on it."""
    P, codes = _case(dev, 4, 7, 8, 256, 70_001)
    want = ops.jpq_topk_scan(P, codes, 50, block_n=ops.scan_block_n(70_001))
    assert _same(ops.jpq_topk_lut(P, codes, 50, block_n=block_n), want)


@pytest.mark.parametrize("order", ["identity", "permuted"])
@pytest.mark.parametrize("case", UNPRUNED[:5],
                         ids=[str(c[:5]) for c in UNPRUNED[:5]])
def test_pruned_kernel_matches_plain(dev, case, order):
    B, m, b, N, k, lut, cd = case
    P, codes = _case(dev, 1, B, m, b, N, lut=lut, code_dtype=cd)
    perm = torch.randperm(N, device=dev) if order == "permuted" else None
    bn = ops.prune_block_n(N)
    st = ops.prepare_pruning(codes, b, bn, perm=perm)
    cold = (torch.full((B,), -float("inf"), device=dev),
            torch.full((B, k), -float("inf"), device=dev),
            torch.zeros((B, k), dtype=torch.int32, device=dev))
    kv, ki, kskip = kc.jpq_topk_pruned(P, st.codes, st.ids, st.present,
                                       *cold, k=k, block_n=bn,
                                       tie_break_ids=st.tie_break_ids)
    pv, pi, pskip = ops.jpq_topk_scan_pruned(
        P, st.codes, st.ids, st.present, *cold, k=k, block_n=bn,
        tie_break_ids=st.tie_break_ids)
    assert _same((kv, ki), (pv, pi))
    assert torch.equal(kskip.min(0).values, pskip)


def _structured(dev, N=20_000, m=4, b=32, B=6):
    rng = np.random.default_rng(0)
    rank = rng.permutation(N)
    codes = np.clip(rank[:, None] * b // N + rng.integers(0, 2, (N, m)),
                    0, b - 1).astype(np.uint8)
    P = (-(np.arange(b) / b)[None, None, :] * 4.0
         + 0.1 * rng.standard_normal((B, m, b))).astype(np.float32)
    return (torch.tensor(P, device=dev), torch.tensor(codes, device=dev),
            np.argsort(rank, kind="stable"))


@pytest.mark.parametrize("warm", [None, "scalar", "overshoot"])
def test_pruned_path_skips_and_stays_exact(dev, warm):
    P, codes, pop = _structured(dev)
    k = 16
    want = ops.jpq_topk_scan(P, codes, k, block_n=4096)
    floor = None
    if warm == "scalar":
        floor = float(want[0][:, -1].min()) - 0.5
    elif warm == "overshoot":
        th = want[0][:, -1]
        floor = torch.where(torch.arange(len(th), device=dev) % 2 == 0,
                            th + 1.0, th - 1.0)
    v, i, stats = ops.jpq_topk_lut(P, codes, k, prune=True, perm=pop,
                                   block_n=1024, warm=floor,
                                   return_stats=True)
    assert _same((v, i), want)
    assert int(stats["skipped_tiles"]) > 0
    assert int(stats["demoted"].sum()) == (3 if warm == "overshoot" else 0)


def test_seeded_carry_phased_sweep(dev):
    """A phased sweep: the second phase's running list is seeded from the
    first phase's (init_vals / init_ids)."""
    P, codes = _case(dev, 2, 5, 4, 16, 3000)
    k = 40
    st = ops.prepare_pruning(codes, 16, 512)
    half = 1536
    first = ops.PruneState(st.codes[:half], st.ids[:half], st.present[:3],
                           512, False)
    rest = ops.PruneState(st.codes[half:], st.ids[half:], st.present[3:],
                          512, False)
    out = {}
    for name in ("kernel", "plain"):
        fl = torch.full((5,), -float("inf"), device=dev)
        if name == "kernel":
            v1, i1, _ = ops.pruned_sweep(P, first, k, block_n=512)
            out[name] = ops.pruned_sweep(P, rest, k, block_n=512,
                                         carry=(v1, i1))
        else:
            v1, i1, _ = ops.jpq_topk_scan_pruned(
                P, first.codes, first.ids, first.present, fl,
                torch.full((5, k), -float("inf"), device=dev),
                torch.zeros((5, k), dtype=torch.int32, device=dev),
                k=k, block_n=512, tie_break_ids=False)
            out[name] = ops.jpq_topk_scan_pruned(
                P, rest.codes, rest.ids, rest.present, fl, v1, i1, k=k,
                block_n=512, tie_break_ids=False)
    assert _same(out["kernel"][:2], out["plain"][:2])
    assert _same(out["kernel"][:2],
                 ops.jpq_topk_scan(P, codes, k, block_n=1024))


def test_wrappers_reject_bad_inputs(dev):
    P, codes = _case(dev, 3, 2, 2, 4, 50)
    with pytest.raises(ValueError, match="contiguous"):
        kc.jpq_topk(P.transpose(1, 2).contiguous().transpose(1, 2), codes, 5)
    with pytest.raises(TypeError):
        kc.jpq_topk(P, codes.to(torch.int64), 5)
    with pytest.raises(ValueError, match="k <= 1024"):
        kc.jpq_topk(P, codes, 1025)
    with pytest.raises(ValueError, match="tensor on"):
        kc.jpq_topk(P, codes.cpu(), 5)


def test_two_tower_serves_through_both_kernels(dev):
    """Each serving path of the smoke two-tower model launches its kernel
    and gives the materialise path's top-k, bit for bit, on the card."""
    from repro_torch.configs import get_bundle
    from repro_torch.core import engine
    bundle = get_bundle("two-tower-retrieval-jpq")
    model, batch = bundle.make_smoke(device=dev, seed=3)
    p = model.params()
    want = model.bind_engine(p, engine.RetrievalSpec(
        k=10, fused=False)).retrieve(batch)
    for spec, name, n in ((engine.RetrievalSpec(k=10), "jpq_topk", 2),
                          (engine.RetrievalSpec(k=10, prune=True),
                           "jpq_topk_pruned", 1)):
        kc.reset_launches()
        got = model.bind_engine(p, spec).retrieve(batch)
        assert kc.launches[name] == n
        assert _same(got[:2], want)
