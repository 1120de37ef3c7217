"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips, inside the test, where
``torch.cuda.is_available()`` is false (as on a CPU-only host); run them
on the H100 with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  Tolerance for the PQTopK kernels and the
training kernels' forwards: none — values (as bits) and ids must be
equal, and skip maps equal when no floor is set; the training kernels'
backwards are held as the comment above their tests says; embedding_bag
and its backward: none (bit-equal, signed zeros included; the backward
also bit-equal to its plain version on the CPU and across two calls).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import jpq as jpq_mod
from repro_torch.kernels.embedding_bag import cuda as ec
from repro_torch.kernels.embedding_bag import ops as eops
from repro_torch.kernels.embedding_bag import ref as eref
from repro_torch.kernels.jpq_lookup import cuda as lc
from repro_torch.kernels.jpq_lookup import ops as lops
from repro_torch.kernels.jpq_lookup import ref as lref
from repro_torch.kernels.jpq_scores import cuda as sc
from repro_torch.kernels.jpq_scores import ref as sref
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
    assert kc.launches["jpq_topk"] == before + 2    # range pass + merge
    want = ops.jpq_topk_scan(P, codes, k, block_n=ops.scan_block_n(N))
    assert _same(got, want)


@pytest.mark.parametrize("block_n", [1, 257, 1000, 4096, 70_001, 100_000])
def test_jpq_topk_block_n_sets_the_kernel_chunk(dev, block_n):
    """An explicit block_n is the unpruned kernel's chunk (items a
    block's range: 1000 leaves a last range of one item, 257 is no whole
    number of block steps, 70,001 and 100,000 are one range); the result
    does not depend on it."""
    P, codes = _case(dev, 4, 7, 8, 256, 70_001)
    want = ops.jpq_topk_scan(P, codes, 50, block_n=ops.scan_block_n(70_001))
    assert _same(ops.jpq_topk_lut(P, codes, 50, block_n=block_n), want)
    assert kc.launch_shape["items_per_range"] == block_n
    assert kc.launch_shape["ranges"] == -(-70_001 // block_n)


@pytest.mark.parametrize("k, m, b, want", [
    (10, 8, 256, 24),     # the serving shape: 24 x 8 KB LUTs
    (100, 8, 256, 20), (1024, 8, 256, 8),   # longer lists, fewer queries
    (10, 5, 256, 28), (10, 8, 300, 20), (1024, 8, 2000, None)])
def test_jpq_topk_group(dev, k, m, b, want):
    """The library's query group and block step (the CPU planner tests
    assume these values)."""
    assert kc.step() == 512
    if want is None:
        with pytest.raises(ValueError, match="shared memory"):
            kc.group(k, m, b)
    else:
        assert kc.group(k, m, b) == want


def test_jpq_topk_records_its_launch_shape(dev):
    B, N = 512, 70_001
    P, codes = _case(dev, 12, B, 8, 256, N)
    kc.jpq_topk(P, codes, 10)
    shape = kc.launch_shape
    ranges, per = kc.range_plan(B, 24, N, shape["sms"], kc.step())
    assert shape == {"B": B, "N": N, "G": 24, "ranges": ranges,
                     "items_per_range": per, "blocks": ranges * -(-B // 24),
                     "warps": 32, "sms": shape["sms"]}


TOPK_EDGES = [
    # name, B, m, b, N, k, codes
    ("B = 1", 1, 8, 256, 70_001, 10, torch.uint8),
    ("B = 23", 23, 8, 256, 70_001, 10, torch.uint8),
    ("B = 25", 25, 8, 256, 70_001, 10, torch.uint8),
    ("k = 100, G = 20", 45, 8, 256, 70_001, 100, torch.uint8),
    ("k = 1024, G = 8", 9, 8, 256, 40_000, 1024, torch.uint8),
    ("m = 5", 7, 5, 256, 30_011, 10, torch.uint8),
    ("int32 codes, b = 300", 11, 8, 300, 30_011, 10, torch.int32),
    # the serve_retrieval example's request loop: B = 1 leaves most of a
    # G = 24 group empty; N as the issue of that example counts its rows
    # and as the two-tower model pads them (200,192)
    ("serve B = 1", 1, 8, 256, 200_002, 10, torch.uint8),
    ("serve B = 5", 5, 8, 256, 200_002, 10, torch.uint8),
    ("serve B = 32", 32, 8, 256, 200_002, 10, torch.uint8),
    ("serve B = 1, padded rows", 1, 8, 256, 200_192, 10, torch.uint8),
    ("serve B = 256, padded rows", 256, 8, 256, 200_192, 10, torch.uint8),
]


@pytest.mark.parametrize("lut", ["normal", "zeros"])
@pytest.mark.parametrize("case", TOPK_EDGES, ids=[c[0] for c in TOPK_EDGES])
def test_jpq_topk_edges(dev, case, lut):
    """B not a multiple of the group, k whose lists shrink the group, and
    the general code path (m != 8, int32 codes)."""
    _, B, m, b, N, k, cd = case
    P, codes = _case(dev, 13, B, m, b, N, lut=lut, code_dtype=cd)
    want = ops.jpq_topk_scan(P, codes, k, block_n=ops.scan_block_n(N))
    assert _same(kc.jpq_topk(P, codes, k), want)
    assert kc.launch_shape["G"] == kc.group(k, m, b)


@pytest.mark.parametrize("k", [10, 100])
def test_jpq_topk_unaligned_codes(dev, k):
    """uint8 codes at m = 8 whose rows are not 8-byte aligned take the
    general path; it gives the 8-byte path's bits."""
    P, codes = _case(dev, 14, 50, 8, 256, 30_011)
    buf = torch.empty(codes.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = buf[1:].view(codes.shape)
    shifted.copy_(codes)
    assert shifted.data_ptr() % 8 == 1
    got = kc.jpq_topk(P, shifted, k)
    assert _same(got, kc.jpq_topk(P, codes, k))
    assert _same(got, ops.jpq_topk_scan(P, codes, k, block_n=8192))


@pytest.mark.parametrize("chunk", [None, 65_536])
@pytest.mark.parametrize("k", [10, 100, 1024])
@pytest.mark.parametrize("order", ["rising", "falling"])
def test_jpq_topk_scores_monotone_in_the_id(dev, order, k, chunk):
    """Scores that rise strictly with the item id make every item a
    candidate of every query (the candidate buffers overflow, and warp
    steps are scored again after a merge); falling scores let almost
    nothing in after the first items.  score(i) = i + q exactly: codes
    (i // 256, i % 256), P[q, 0, c] = 256 c, P[q, 1, c] = c + q."""
    B, N = 5, 65_536
    i = torch.arange(N, device=dev)
    codes = torch.stack([i // 256, i % 256], 1).to(torch.uint8).contiguous()
    c = torch.arange(256, device=dev, dtype=torch.float32)
    q = torch.arange(B, device=dev, dtype=torch.float32)[:, None]
    P = torch.stack([(256 * c).expand(B, -1), c + q], 1).contiguous()
    if order == "falling":
        P = -P
    got = kc.jpq_topk(P, codes, k, chunk=chunk)
    want = ops.jpq_topk_scan(P, codes, k, block_n=8192)
    assert _same(got, want)
    top = torch.arange(k, device=dev, dtype=torch.int32)
    ids = N - 1 - top if order == "rising" else top
    assert torch.equal(got[1], ids.expand(B, -1))


@pytest.mark.parametrize("k", [10, 1024])
@pytest.mark.parametrize("signed", [False, True])
def test_jpq_topk_all_scores_equal(dev, k, signed):
    """Every score is a zero: the ids decide.  Canonicalised, every score
    is +0.0 and the top k are ids 0..k-1; with -0.0 left in the LUT some
    scores are -0.0, which rank below +0.0 (as the plain version ranks
    them)."""
    B, m, b, N = 6, 8, 256, 50_000
    g = torch.Generator(device=dev).manual_seed(15)
    P = torch.zeros((B, m, b), device=dev)
    codes = torch.randint(0, b, (N, m), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    if signed:
        P[:, :, : b // 2] = -0.0
    else:
        P = ops.canonicalise_lut(P).contiguous()
    got = kc.jpq_topk(P, codes, k)
    assert _same(got, ops.jpq_topk_scan(P, codes, k, block_n=8192))
    if not signed:
        assert torch.equal(got[1], torch.arange(
            k, device=dev, dtype=torch.int32).expand(B, -1))


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


def _cold(dev, B, k):
    return (torch.full((B,), -float("inf"), device=dev),
            torch.full((B, k), -float("inf"), device=dev),
            torch.zeros((B, k), dtype=torch.int32, device=dev))


PRUNED_EDGES = [
    # name, B, m, b, N, k, lut, block_n
    ("B not a multiple of the group", 7, 8, 256, 30_011, 10, "normal", 2048),
    ("B = 1", 1, 8, 256, 30_011, 10, "normal", 2048),
    ("k = 1024", 6, 8, 256, 40_000, 1024, "normal", 4096),
    ("k = 1024, zeros", 5, 8, 256, 20_000, 1024, "zeros", 1024),
    ("more than a ring of tiles", 9, 4, 16, 50_000, 25, "normal", 640),
]


@pytest.mark.parametrize("order", ["identity", "permuted"])
@pytest.mark.parametrize("case", PRUNED_EDGES,
                         ids=[c[0] for c in PRUNED_EDGES])
def test_pruned_kernel_edges(dev, case, order):
    """Groups of the new sweep cut short, the largest k (whose merges sort
    their candidates), more tiles than one ring of tile bounds."""
    _, B, m, b, N, k, lut, bn = case
    P, codes = _case(dev, 6, B, m, b, N, lut=lut)
    perm = torch.randperm(N, device=dev) if order == "permuted" else None
    st = ops.prepare_pruning(codes, b, bn, perm=perm)
    args = (P, st.codes, st.ids, st.present, *_cold(dev, B, k))
    kw = dict(k=k, block_n=bn, tie_break_ids=st.tie_break_ids)
    kv, ki, kskip = kc.jpq_topk_pruned(*args, **kw)
    pv, pi, pskip = ops.jpq_topk_scan_pruned(*args, **kw)
    assert _same((kv, ki), (pv, pi))
    assert torch.equal(kskip.min(0).values, pskip)
    assert kskip.shape == (-(-B // kc.pruned_group_size()), pskip.shape[0])


@pytest.mark.parametrize("k", [1, 16, 1024])
def test_pruned_kernel_skip_heavy_catalogue(dev, k):
    """The structured catalogue skips most tiles: the cold skip map, the
    values and the ids equal the plain version's, and two calls give the
    same bits."""
    P, codes, pop = _structured(dev, N=60_000, B=10)
    P = ops.canonicalise_lut(P).contiguous()
    st = ops.prepare_pruning(codes, 32, 1024,
                             perm=torch.as_tensor(pop, device=dev))
    args = (P, st.codes, st.ids, st.present, *_cold(dev, 10, k))
    kw = dict(k=k, block_n=1024, tie_break_ids=True)
    first = kc.jpq_topk_pruned(*args, **kw)
    second = kc.jpq_topk_pruned(*args, **kw)
    pv, pi, pskip = ops.jpq_topk_scan_pruned(*args, **kw)
    assert _same(first[:2], (pv, pi))
    assert torch.equal(first[2].min(0).values, pskip)
    assert int(pskip.sum()) > 0
    assert _same(first[:2], second[:2]) and torch.equal(first[2], second[2])


def test_pruned_kernel_seeded_lists_in_any_order(dev):
    """init_vals / init_ids need not be sorted: the kernel sorts them."""
    B, k = 6, 30
    P, codes = _case(dev, 7, B, 8, 256, 9_000)
    st = ops.prepare_pruning(codes, 256, 1024)
    g = torch.Generator(device=dev).manual_seed(8)
    iv = torch.randn((B, k), generator=g, device=dev) + 3.0
    ii = torch.randint(9_000, 20_000, (B, k), generator=g, device=dev,
                       dtype=torch.int32)
    fl = torch.full((B,), -float("inf"), device=dev)
    args = (P, st.codes, st.ids, st.present, fl, iv, ii)
    kw = dict(k=k, block_n=1024, tie_break_ids=False)
    kv, ki, kskip = kc.jpq_topk_pruned(*args, **kw)
    pv, pi, pskip = ops.jpq_topk_scan_pruned(*args, **kw)
    assert _same((kv, ki), (pv, pi))
    assert torch.equal(kskip.min(0).values, pskip)


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
    with pytest.raises(ValueError, match="chunk"):
        kc.jpq_topk(P, codes, 5, chunk=0)


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


# ================================================ jpq_scores, jpq_lookup
#
# Forwards: bit-equal to the plain versions (tolerance 0).  Backwards:
# against the plain version in float64, within the worst-case bound of
# an fp32 recursive sum, (chain - 1) * 2^-24 * sum|terms| per output,
# where chain is the longest run of adds the kernel makes into one
# output; and bit-identical across two calls (deterministic).  The
# jpq_lookup backward is also bit-equal to its plain version run on the
# CPU, whose index_add_ sums in the same order as the kernel.

U = 2.0 ** -24


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


SCORES = [
    # T, m, b, N, lut, codes
    (3, 4, 16, 200, "normal", torch.uint8),
    (13, 8, 256, 70_001, "normal", torch.uint8),     # ragged rows and items
    (16, 8, 256, 70_001, "zeros", torch.uint8),      # ±0.0 LUT
    (9, 3, 300, 40_000, "normal", torch.int32),      # int32 codes, b > 256
    # T around the forward's query group (cuda.fwd_group: 24 at m*b =
    # 2,048), N not a multiple of the items a lane (8), a warp step (32)
    # or a block handles; odd N puts the rows at every alignment
    (23, 8, 256, 4_099, "normal", torch.uint8),
    (24, 8, 256, 32 * 16 + 5, "normal", torch.uint8),
    (25, 8, 256, 70_001, "normal", torch.uint8),
    (1, 8, 256, 4_099, "normal", torch.uint8),
    (133, 8, 256, 70_002, "normal", torch.uint8),
    # the largest LUT the wrapper takes (4 queries a block), 8 queries a
    # block, and m away from 8 (the general code path)
    (9, 8, 1772, 3_001, "normal", torch.int32),
    (17, 8, 864, 3_001, "normal", torch.int32),
    (30, 1, 256, 5_000, "normal", torch.uint8),
    (30, 16, 256, 5_000, "normal", torch.uint8),
    # the paper-validation grid (b = 64, m*b = 512): training T = 64 x 32
    # over ml1m's 242 rows (fewer items than one range of a warp step per
    # SM) and 64 x 24 over gowalla's 2,002, and eval's T = 256
    (2048, 8, 64, 242, "normal", torch.uint8),
    (1536, 8, 64, 2_002, "normal", torch.uint8),
    (256, 8, 64, 242, "normal", torch.uint8),
    (256, 8, 64, 2_002, "zeros", torch.uint8),
    (1, 8, 64, 2_002, "normal", torch.uint8),
    # the grid's eval T (every 3rd of ml1m's 800 users, every 4th of
    # gowalla's 1,200), and the quickstart's b = 256 over 1,502 rows:
    # training T = 64 x 32, eval T = 250
    (267, 8, 64, 242, "normal", torch.uint8),
    (300, 8, 64, 2_002, "normal", torch.uint8),
    (2048, 8, 256, 1_502, "normal", torch.uint8),
    (250, 8, 256, 1_502, "normal", torch.uint8),
    # a microbatched step's slice at full width: T = 8 x 200
    (1600, 8, 256, 100_002, "normal", torch.uint8),
]


@pytest.mark.parametrize("case", SCORES, ids=[str(c[:4]) for c in SCORES])
def test_jpq_scores_forward_matches_plain(dev, case):
    T, m, b, N, lut, cd = case
    P, codes = _case(dev, 5, T, m, b, N, lut=lut, code_dtype=cd)
    before = sc.launches["jpq_scores"]
    got = sc.jpq_scores(P, codes)
    torch.cuda.synchronize()
    assert sc.launches["jpq_scores"] == before + 1
    assert _bits_equal(got, sref.jpq_scores_lut_ref(P, codes))
    # the launch shape the wrapper records is the one the planner gives
    shape = sc.fwd_launch_shape
    G = sc.fwd_group(m, b)
    ranges, per = sc.fwd_plan(T, G, N, shape["sms"], sc.fwd_step())
    assert shape == {"T": T, "N": N, "G": G, "items_per_block": per,
                     "item_ranges": ranges, "blocks": ranges * -(-T // G),
                     "sms": shape["sms"]}


@pytest.mark.parametrize("m, b, want", [
    (8, 256, 24),      # the paper's table: 24 x 8 KB LUTs and the staging
    (8, 300, 20), (8, 864, 8), (8, 1772, 4),   # 4: the largest LUT taken
    (4, 16, 28), (16, 256, 12), (8, 1773, None)])
def test_jpq_scores_fwd_group(dev, m, b, want):
    """The library's query group (the CPU planner tests assume these
    values and a warp step of 32 items)."""
    assert sc.fwd_step() == 32
    if want is None:
        with pytest.raises(ValueError, match="shared memory"):
            sc.fwd_group(m, b)
    else:
        assert sc.fwd_group(m, b) == want


def test_jpq_scores_forward_refuses_too_large_lut(dev):
    P, codes = _case(dev, 10, 2, 8, 1773, 10, code_dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        sc.jpq_scores(P, codes)


def test_jpq_scores_forward_unaligned_codes(dev):
    """uint8 codes at m = 8 whose rows are not 8-byte aligned go through
    the general path; the output is a fresh tensor a caller may write."""
    T, N = 29, 10_001
    P, codes = _case(dev, 11, T, 8, 256, N)
    buf = torch.empty(N * 8 + 1, dtype=torch.uint8, device=dev)
    shifted = buf[1:].view(N, 8)
    shifted.copy_(codes)
    assert shifted.data_ptr() % 8 == 1
    got = sc.jpq_scores(P, shifted)
    want = sref.jpq_scores_lut_ref(P, codes)
    assert _bits_equal(got, want)
    assert _bits_equal(sc.jpq_scores(P, codes), got)
    got[:, 0] = 0.0
    assert float(got[:, 0].abs().max()) == 0.0


SCORES_BWD = [
    # name, T, m, b, N, codes, share of split 0 at code 3
    ("base", 13, 8, 256, 70_001, torch.uint8, 0.0),    # ragged rows, items
    ("skewed", 40, 8, 256, 70_001, torch.uint8, 0.85),  # one code holds 85%
    ("int32 b=300", 9, 3, 300, 40_000, torch.int32, 0.0),
    ("T=1", 1, 8, 256, 5_000, torch.uint8, 0.0),
    ("small", 3, 4, 16, 200, torch.uint8, 0.0),         # one partial tile
    ("T=64", 64, 8, 256, 1_024, torch.uint8, 0.0),      # whole tiles, groups
    # the paper-validation grid, b = 64: one partial tile (ml1m, 242
    # rows), four tiles the last partial (gowalla, 2,002 rows)
    ("grid ml1m", 2048, 8, 64, 242, torch.uint8, 0.0),
    ("grid gowalla", 1536, 8, 64, 2_002, torch.uint8, 0.0),
    ("grid gowalla skewed", 1536, 8, 64, 2_002, torch.uint8, 0.85),
    ("quickstart", 2048, 8, 256, 1_502, torch.uint8, 0.0),
    ("microbatch slice", 1600, 8, 256, 100_002, torch.uint8, 0.0),
]


def _gamma_bound(codes, b, chunks, mass):
    """gamma(chain - 1) * sum|terms|, chain from the kernel's chunking."""
    n = sc.bwd_chain(codes, b, chunks).double() - 1
    return (n * U / (1 - n * U)) * mass


@pytest.mark.parametrize("chunks", [1, 3, None])
@pytest.mark.parametrize("case", SCORES_BWD, ids=[c[0] for c in SCORES_BWD])
def test_jpq_scores_backward_matches_plain(dev, case, chunks):
    """Bit-identical across calls; with one chunk bit-equal to the plain
    version on the CPU (both sum each bin in ascending item order from
    +0.0); always within gamma(chain - 1) sum|terms| of float64, chain
    the longest add chain into each output (``cuda.bwd_chain``).  None:
    the chunks the wrapper picks for the card."""
    _, T, m, b, N, cd, skew = case
    g = torch.Generator(device=dev).manual_seed(6)
    codes = torch.randint(0, b, (N, m), generator=g, device=dev,
                          dtype=torch.int32)
    codes[torch.rand(N, generator=g, device=dev) < skew, 0] = 3
    codes = codes.to(cd)
    dS = torch.randn((T, N), generator=g, device=dev)
    before = sc.launches["jpq_scores_bwd"]
    got = sc.jpq_scores_bwd(dS, codes, b, chunks=chunks)
    again = sc.jpq_scores_bwd(dS, codes, b, chunks=chunks)
    torch.cuda.synchronize()
    n_chunks = sc.bwd_chunks(T, m, b, N, dS.device, chunks)
    assert sc.launches["jpq_scores_bwd"] == \
        before + 2 * (2 if n_chunks == 1 else 3)
    assert _bits_equal(got, again)
    if n_chunks == 1:
        on_cpu = sref.jpq_scores_lut_bwd_ref(dS.cpu(), codes.cpu(), b)
        assert _bits_equal(got.cpu(), on_cpu)
    want = sref.jpq_scores_lut_bwd_ref(dS.double(), codes, b)
    mass = sref.jpq_scores_lut_bwd_ref(dS.double().abs(), codes, b)
    lim = _gamma_bound(codes, b, n_chunks, mass)
    assert bool(((got.double() - want).abs() <= lim).all())


@pytest.mark.parametrize("case", SCORES_BWD, ids=[c[0] for c in SCORES_BWD])
def test_jpq_scores_backward_sort_matches_plain(dev, case):
    """The backward's first kernel, the code sort, gives the plain sort's
    lists and bin starts exactly."""
    _, T, m, b, N, cd, skew = case
    g = torch.Generator(device=dev).manual_seed(13)
    codes = torch.randint(0, b, (N, m), generator=g, device=dev,
                          dtype=torch.int32)
    codes[torch.rand(N, generator=g, device=dev) < skew, 0] = 3
    codes = codes.to(cd)
    lists, starts = sc.sort_codes(codes, b)
    want_lists, want_starts = sc.sort_codes_plain(codes, b)
    assert torch.equal(lists, want_lists)
    assert torch.equal(starts, want_starts)


LOOKUP = [
    # name, T, m, b, dk, N, codes, share of positions at id 0
    ("base", 3_200, 8, 256, 64, 50_000, torch.uint8, 0.3),
    ("int32 codes", 3_200, 8, 256, 64, 50_000, torch.int32, 0.3),
    ("skewed", 3_200, 8, 256, 64, 50_000, torch.uint8, 0.8),  # one bucket
    ("T=1", 1, 8, 256, 64, 50_000, torch.uint8, 0.0),
    ("T=65536", 65_536, 8, 256, 64, 50_000, torch.uint8, 0.5),  # 32 chunks
    ("b=512", 3_200, 4, 512, 64, 50_000, torch.int32, 0.3),     # int32 codes
    ("dk=6", 3_200, 8, 256, 6, 50_000, torch.uint8, 0.3),       # scalar path
    ("dk=5", 3_200, 8, 256, 5, 50_000, torch.uint8, 0.3),       # odd dk
    ("m=40", 300, 40, 16, 8, 1_000, torch.uint8, 0.3),          # m > 32
    ("dk=160", 700, 3, 40, 160, 1_000, torch.uint8, 0.3),       # two slices
    ("misaligned", 3_200, 8, 256, 64, 50_000, torch.uint8, 0.3),
    # the paper-validation grid: b = 64, dk = 8 (d = 64, m = 8)
    ("grid ml1m", 2_048, 8, 64, 8, 242, torch.uint8, 0.3),
    ("grid gowalla", 1_536, 8, 64, 8, 2_002, torch.uint8, 0.5),
    # the quickstart: b = 256, dk = 8, training and eval (250 x 32)
    ("quickstart", 2_048, 8, 256, 8, 1_502, torch.uint8, 0.3),
    ("quickstart eval", 8_000, 8, 256, 8, 1_502, torch.uint8, 0.3),
    # a microbatched step's slice (T = 8 x 200), at SeqRec's width
    ("microbatch slice", 1_600, 8, 256, 64, 50_000, torch.uint8, 0.5),
]


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", LOOKUP, ids=[c[0] for c in LOOKUP])
def test_jpq_lookup_matches_plain(dev, id_dtype, case):
    """Forward bit-equal to the plain version on the card; backward
    bit-equal to the plain version run on the CPU copies of its inputs
    (the kernel sums each entry's positions in ascending order from +0.0,
    as ``index_add_`` does there), the same bits on two calls, and within
    T u sum|terms| of float64.  "misaligned": centroids and dout start 4
    bytes past a 16-byte boundary (the kernels' 4-byte paths)."""
    name, T, m, b, dk, N, cd, pad = case
    g = torch.Generator(device=dev).manual_seed(8)

    def floats(*shape):
        x = torch.randn(shape, generator=g, device=dev)
        if name != "misaligned":
            return x
        buf = torch.empty(x.numel() + 1, device=dev)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(shape)

    cent = floats(m, b, dk)
    codes = torch.randint(0, b, (N, m), generator=g, device=dev,
                          dtype=torch.int32).to(cd)
    ids = torch.randint(0, N, (T,), generator=g, device=dev).to(id_dtype)
    ids[torch.randperm(T, generator=g, device=dev)[: int(pad * T)]] = 0
    before = dict(lc.launches)
    got = lc.jpq_lookup(ids, codes, cent)
    assert _bits_equal(got, lref.jpq_lookup_ref(ids, codes, cent))
    dout = floats(T, m, dk)
    d1 = lc.jpq_lookup_bwd(ids, codes, dout, b)
    d2 = lc.jpq_lookup_bwd(ids, codes, dout, b)
    torch.cuda.synchronize()
    assert lc.launches == {"jpq_lookup": before["jpq_lookup"] + 1,
                           "jpq_lookup_bwd": before["jpq_lookup_bwd"] + 2}
    assert _bits_equal(d1, d2)
    on_cpu = lref.jpq_lookup_bwd_ref(ids.cpu(), codes.cpu(), dout.cpu(), b)
    assert _bits_equal(d1.cpu(), on_cpu)
    want = lref.jpq_lookup_bwd_ref(ids, codes, dout.double(), b)
    mass = lref.jpq_lookup_bwd_ref(ids, codes, dout.double().abs(), b)
    assert bool(((d1.double() - want).abs() <= T * U * mass).all())


def test_jpq_lookup_refuses_mismatched_codes(dev):
    """codes whose code length is not the centroids' (or dout's) m are
    refused before any launch."""
    ids = torch.zeros(5, dtype=torch.int64, device=dev)
    codes = torch.zeros((10, 4), dtype=torch.uint8, device=dev)
    before = dict(lc.launches)
    with pytest.raises(ValueError, match="codes shape"):
        lc.jpq_lookup(ids, codes, torch.zeros((8, 16, 4), device=dev))
    with pytest.raises(ValueError, match="codes shape"):
        lc.jpq_lookup_bwd(ids, codes, torch.zeros((5, 8, 4), device=dev), 16)
    assert lc.launches == before


def test_autograd_functions_launch_their_kernels(dev):
    """The Functions' forward and backward go through the kernels on a
    CUDA tensor and give the plain (CPU) Functions' gradients."""
    g = torch.Generator(device=dev).manual_seed(9)
    cent = torch.randn((4, 16, 8), generator=g, device=dev)
    codes = torch.randint(0, 16, (500, 4), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    ids = torch.randint(0, 500, (5, 7), generator=g, device=dev)
    out = {}
    for where in ("cuda", "cpu"):
        c = cent.detach().to(where).requires_grad_()
        x = lops.jpq_lookup(ids.to(where), codes.to(where), c)  # [5, 7, 32]
        s = jpq_mod.logits({"codes": codes.to(where), "centroids": c}, x,
                           use_kernel=True)                   # [5, 7, 500]
        (s.square().sum()).backward()
        out[where] = (s.detach().cpu(), c.grad.cpu())
    lc.reset_launches()
    sc.reset_launches()
    c = cent.detach().requires_grad_()
    x = lops.jpq_lookup(ids, codes, c)
    jpq_mod.logits({"codes": codes, "centroids": c}, x,
                   use_kernel=True).sum().backward()
    assert lc.launches == {"jpq_lookup": 1, "jpq_lookup_bwd": 1}
    assert sc.launches == {"jpq_scores": 1, "jpq_scores_bwd": 2}  # sort, sum
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-4)


def test_sasrec_step_through_kernels_matches_gathers(dev):
    """One full_ce step of a small SASRec: use_kernel=True (the four
    kernels) against use_kernel=False (PyTorch gathers) on the card, the
    same weights — loss within 1e-5 relative, every gradient within
    1e-4 of its largest magnitude (sums in another order)."""
    from repro_torch.core import EmbeddingConfig
    from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
    kw = dict(arch="sasrec", n_items=3000, max_len=16, d_model=64,
              n_layers=2, n_heads=2, d_ff=128)
    rng = np.random.default_rng(0)
    seq = rng.integers(1, 3001, (4, 16))
    seq[:, :5] = 0
    batch = {"seq": torch.tensor(seq, device=dev),
             "labels": torch.tensor(np.roll(seq, -1, 1), device=dev)}
    res = {}
    for uk in (True, False):
        model = SeqRecModel(
            SeqRecConfig(embedding=EmbeddingConfig(0, 0, kind="jpq", m=8,
                                                   b=256, use_kernel=uk),
                         **kw),
            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        p = model.params()
        loss, _ = model.train_loss(p, batch)
        loss.backward()
        res[uk] = (float(loss.detach()), [x.grad for x in model.parameters()])
    assert abs(res[True][0] - res[False][0]) <= 1e-5 * abs(res[False][0])
    for a, b in zip(res[True][1], res[False][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("arch", ["bert4rec", "gru4rec"])
def test_arch_step_through_kernels_matches_gathers(dev, arch):
    """One full_ce step of a small BERT4Rec (a masked batch: the [MASK]
    row through jpq_lookup) and GRU4Rec: use_kernel=True (the four
    kernels) against use_kernel=False (PyTorch gathers) on the card, the
    same weights — loss within 1e-5 relative, every gradient within 1e-4
    of its largest magnitude (sums in another order); every kernel
    launched."""
    from repro_torch.core import EmbeddingConfig
    from repro_torch.models.sequential import (SeqRecConfig, SeqRecModel,
                                               mask_batch)
    kw = dict(arch=arch, n_items=3000, max_len=16, d_model=64,
              n_layers=2, n_heads=2, d_ff=128)
    rng = np.random.default_rng(1)
    seq = torch.tensor(rng.integers(1, 3001, (4, 16)), device=dev)
    seq[:, :5] = 0
    if arch == "bert4rec":
        ms, tg = mask_batch(torch.Generator(device=dev).manual_seed(0), seq,
                            0.2, 3001)
        batch = {"seq": ms, "targets": tg}
    else:
        batch = {"seq": seq, "labels": torch.roll(seq, -1, 1)}
    res = {}
    for uk in (True, False):
        model = SeqRecModel(
            SeqRecConfig(embedding=EmbeddingConfig(0, 0, kind="jpq", m=8,
                                                   b=256, use_kernel=uk),
                         **kw),
            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        p = model.params()
        sc.reset_launches()
        lc.reset_launches()
        loss, _ = model.train_loss(p, batch)
        loss.backward()
        torch.cuda.synchronize()
        res[uk] = (float(loss.detach()), [x.grad for x in model.parameters()],
                   {**sc.launches, **lc.launches})
    assert all(n > 0 for n in res[True][2].values()), res[True][2]
    assert not any(res[False][2].values())
    assert abs(res[True][0] - res[False][0]) <= 1e-5 * abs(res[False][0])
    for a, b in zip(res[True][1], res[False][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


BAGS = [
    # V, d, n_bags, L, weights, ids dtype
    (1000, 1, 37, 39, None, torch.int64),        # the FM linear term
    (1000, 10, 33, 50, "random", torch.int32),   # d = 10: scalar loads
    (1000, 18, 21, 7, "masked", torch.int64),    # d = 18: DIEN's width
    (5000, 64, 64, 50, "random", torch.int64),   # float4 loads
    (20_000, 256, 130, 50, "masked", torch.int32),  # the two-tower width
    (100, 3, 9, 1, "random", torch.int64),       # L = 1, odd d
    (3_000, 1, 1, 38, None, torch.int64),        # FM's candidates: one bag
    (3_000, 1, 700, 1, "random", torch.int32),   # d = 1, L = 1
    (3_000, 3, 17, 100, "random", torch.int32),  # d = 3, L = 100
    (1_000, 33, 20, 38, "random", torch.int64),  # d = 33: a scalar slab
    (20_000, 256, 1, 50, "masked", torch.int64),  # d = 256, one bag
    (5_000, 256, 40, 100, "random", torch.int32),  # d = 256, L = 100
]


def _bag_case(dev, V, d, n, L, weights, id_dtype, seed=0):
    """A table whose pad row 0 is all negative, ids with left padding and
    one all-padding bag (bag 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((V, d), generator=g, device=dev)
    table[0] = -table[0].abs() - 0.25
    ids = torch.randint(0, V, (n, L), generator=g, device=dev)
    ids[:, : L // 2] = 0
    if n > 1:
        ids[1] = 0
    w = {None: None, "masked": (ids > 0).float(),
         "random": torch.randn((n, L), generator=g, device=dev)}[weights]
    return table, ids.to(id_dtype), w


@pytest.mark.parametrize("case", BAGS, ids=[str(c[:5]) for c in BAGS])
def test_embedding_bag_kernel_matches_plain(dev, case):
    table, ids, w = _bag_case(dev, *case)
    ec.reset_launches()
    got = ec.embedding_bag(table, ids, w)
    assert ec.launches == {"embedding_bag": 1, "embedding_bag_backward": 0}
    want = eref.embedding_bag_ref(table, ids, w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the same bits as the plain version on the CPU
    cpu = eref.embedding_bag_ref(table.cpu(), ids.cpu(),
                                 None if w is None else w.cpu())
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.parametrize("d", [256, 3])
def test_embedding_bag_misaligned_table(dev, d):
    """A table view 4 bytes past a 16-byte boundary (contiguous, as a
    slice of a flat buffer gives it) takes the scalar loads: bit-equal
    to the plain version."""
    table, ids, w = _bag_case(dev, 3_000, d, 40, 50, "random", torch.int64)
    buf = torch.empty(table.numel() + 1, device=dev)
    buf[1:] = table.reshape(-1)
    view = buf[1:].view(table.shape)
    assert view.data_ptr() % 16 == 4
    got = ec.embedding_bag(view, ids, w)
    want = eref.embedding_bag_ref(table, ids, w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_embedding_bag_keeps_signed_zero(dev):
    """An all-padding bag over a negative pad row with mask weights sums
    to -0.0 (slot 0 is the product -x * 0), not +0.0."""
    table, ids, w = _bag_case(dev, 500, 64, 8, 20, "masked", torch.int64)
    got = ec.embedding_bag(table, ids, w)[1]
    assert bool((got == 0).all()) and bool(torch.signbit(got).all())


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_ops_combiners_on_the_card(dev, combiner, monkeypatch):
    """``ops`` on the card (its weight handling, then the kernel) against
    the same ``ops`` call with the plain version in the kernel's place.
    Against the CPU only up to the normalising sum of ``mean``, which
    CUDA reduces in another order."""
    table, ids, w = _bag_case(dev, 700, 16, 12, 9, "random", torch.int64)
    for weights in (None, w):
        ec.reset_launches()
        got = eops.embedding_bag(table, ids, weights, combiner=combiner)
        assert ec.launches == {"embedding_bag": 1,
                               "embedding_bag_backward": 0}
        with monkeypatch.context() as m:
            m.setattr(ec, "embedding_bag", eref.embedding_bag_ref)
            want = eops.embedding_bag(table, ids, weights, combiner=combiner)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bad", [-1, 700])
def test_embedding_bag_refuses_out_of_range_ids(dev, bad):
    table, ids, w = _bag_case(dev, 700, 16, 12, 9, "masked", torch.int32)
    ids[4, 2] = bad
    with pytest.raises(IndexError, match="outside"):
        ec.embedding_bag(table, ids, w)
    with pytest.raises(IndexError, match="outside"):
        eops.embedding_bag(table, ids, w)


BAG_BWD = [
    # V, d, n_bags, L, weights, ids dtype
    (3_000, 1, 700, 39, None, torch.int64),        # the FM linear term
    (3_000, 1, 700, 39, None, torch.int32),
    (20_000, 256, 130, 50, "masked", torch.int32),  # the two-tower width
    (20_000, 256, 130, 50, "masked", torch.int64),
    (1_000, 18, 21, 7, "random", torch.int64),     # d = 18: a run a thread
    (5_000, 64, 64, 50, "random", torch.int32),    # float4 slabs
    (1_000, 33, 20, 38, "random", torch.int64),    # d = 33: a scalar slab
    (100, 3, 9, 1, "random", torch.int64),         # L = 1, odd d
]


def _bwd_check(dev, ids, w, dout, V):
    """The backward kernel: one launch, bit-identical across two calls,
    bit-equal to its plain version run on CPU copies."""
    ec.reset_launches()
    got = ec.embedding_bag_backward(ids, w, dout, V)
    assert ec.launches == {"embedding_bag": 0, "embedding_bag_backward": 1}
    again = ec.embedding_bag_backward(ids, w, dout, V)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    cpu = eref.embedding_bag_backward_ref(
        ids.cpu(), None if w is None else w.cpu(), dout.cpu(), V)
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
    return got


@pytest.mark.parametrize("case", BAG_BWD, ids=[str(c[:5]) for c in BAG_BWD])
def test_embedding_bag_backward_kernel_matches_plain(dev, case):
    V, d, n, L, weights, id_dtype = case
    _, ids, w = _bag_case(dev, *case)
    g = torch.Generator(device=dev).manual_seed(5)
    dout = torch.randn((n, d), generator=g, device=dev)
    got = _bwd_check(dev, ids, w, dout, V)
    # the rows no id names stay +0.0
    named = torch.zeros(V, dtype=torch.bool, device=dev)
    named[ids.long().reshape(-1)] = True
    assert not bool(got[~named].view(torch.int32).any())


@pytest.mark.parametrize("d", [1, 256])
def test_embedding_bag_backward_skewed_ids(dev, d):
    """Half of all positions name one row: one long chain."""
    _, ids, w = _bag_case(dev, 5_000, d, 400, 50, "random", torch.int64)
    flat = ids.reshape(-1)
    flat[::2] = 1234
    dout = torch.randn((400, d), generator=torch.Generator(
        device=dev).manual_seed(6), device=dev)
    _bwd_check(dev, ids, w, dout, 5_000)


def test_embedding_bag_backward_misaligned_dout(dev):
    """A dout view 4 bytes past a 16-byte boundary takes the scalar
    slabs: bit-equal to the plain version on the CPU."""
    _, ids, w = _bag_case(dev, 3_000, 256, 40, 50, "masked", torch.int64)
    buf = torch.randn(40 * 256 + 1, device=dev)
    dout = buf[1:].view(40, 256)
    assert dout.data_ptr() % 16 == 4
    _bwd_check(dev, ids, w, dout, 3_000)


def test_embedding_bag_backward_empty_bag_list(dev):
    ids = torch.zeros((0, 5), dtype=torch.int64, device=dev)
    ec.reset_launches()
    got = ec.embedding_bag_backward(ids, None, torch.zeros((0, 4),
                                                           device=dev), 30)
    assert got.shape == (30, 4) and not bool(got.any())
    assert ec.launches["embedding_bag_backward"] == 0


@pytest.mark.parametrize("bad", [-1, 700])
def test_embedding_bag_backward_refuses_out_of_range_ids(dev, bad):
    _, ids, w = _bag_case(dev, 700, 16, 12, 9, "masked", torch.int32)
    ids[4, 2] = bad
    with pytest.raises(IndexError, match="outside"):
        ec.embedding_bag_backward(ids, w, torch.ones((12, 16), device=dev),
                                  700)


@pytest.mark.parametrize("weights", [None, "masked"])
def test_embedding_bag_gradient_on_the_card(dev, weights):
    """``ops.embedding_bag`` on a table that requires a gradient: the
    forward and backward kernels each launch once, the gradient
    bit-equal to the CPU's through the plain versions."""
    table, ids, w = _bag_case(dev, 2_000, 256, 64, 50, weights,
                              torch.int64)
    dout = torch.randn((64, 256), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    t = table.clone().requires_grad_()
    ec.reset_launches()
    (got,) = torch.autograd.grad(eops.embedding_bag(t, ids, w), t, dout)
    assert ec.launches == {"embedding_bag": 1, "embedding_bag_backward": 1}
    tc = table.cpu().requires_grad_()
    (want,) = torch.autograd.grad(
        eops.embedding_bag(tc, ids.cpu(), None if w is None else w.cpu()),
        tc, dout.cpu())
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", ["fm", "two-tower-retrieval"])
def test_ctr_train_step_on_the_card(dev, name):
    """A smoke bundle's loss and gradients on the card (the embedding_bag
    kernels, forward and backward, one launch each) against the same
    weights on the CPU (their plain versions): loss within 1e-5
    relative, gradients within 1e-4 of each leaf's largest entry."""
    from repro_torch import bridge
    from repro_torch.configs import get_bundle
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train import optimizer as T_opt
    m, batch = get_bundle(name).make_smoke(device=dev, seed=0)
    c, _ = get_bundle(name).make_smoke(device="cpu", seed=0)
    bridge.load_values(c, T_opt.tree_map(lambda x: x.cpu().numpy(),
                                         m.params()))
    out = {}
    for where, model in (("cuda", m), ("cpu", c)):
        p = model.params()
        fl = [x for x in tree_leaves(p) if x.is_floating_point()]
        for x in fl:
            x.requires_grad_(True)
        ec.reset_launches()
        loss, _ = model.train_loss(p, batch)
        grads = torch.autograd.grad(loss, fl)
        if where == "cuda":
            assert ec.launches == {"embedding_bag": 1,
                                   "embedding_bag_backward": 1}
        out[where] = float(loss.detach()), [g.cpu() for g in grads]
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# ======== the other objectives, microbatches, checkpoints, semantic head

def _small_seqrec(dev, arch="sasrec", use_kernel=True, seed=1, **cfg):
    from repro_torch.core import EmbeddingConfig
    from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
    kw = dict(arch=arch, n_items=3000, max_len=16, d_model=64, n_layers=2,
              n_heads=2, d_ff=128, **cfg)
    return SeqRecModel(
        SeqRecConfig(embedding=EmbeddingConfig(0, 0, kind="jpq", m=8, b=256,
                                               use_kernel=use_kernel), **kw),
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def _small_batch(dev, arch, seed=2, B=4):
    from repro_torch.models.sequential import mask_batch
    rng = np.random.default_rng(seed)
    seq = torch.tensor(rng.integers(1, 3001, (B, 16)), device=dev)
    seq[:, :5] = 0
    if arch == "bert4rec":
        ms, tg = mask_batch(torch.Generator(device=dev).manual_seed(0), seq,
                            0.2, 3001)
        return {"seq": ms, "targets": tg}
    labels = torch.roll(seq, -1, 1)
    labels[seq == 0] = 0
    neg = torch.tensor(rng.integers(1, 3000, (B, 16, 1)), device=dev)
    return {"seq": seq, "labels": labels,
            "negatives": neg + (neg >= labels[..., None])}


OBJECTIVES = [("sampled_bce", 0.0), ("code_ce", 0.0), ("full_ce", 0.5)]


@pytest.mark.parametrize("loss,weight", OBJECTIVES,
                         ids=[f"{l}-w{w}" for l, w in OBJECTIVES])
@pytest.mark.parametrize("arch", ["sasrec", "bert4rec", "gru4rec"])
def test_objective_step_through_kernels_matches_gathers(dev, arch, loss,
                                                        weight):
    """One step of sampled_bce, code_ce and full_ce + semantic_weight:
    use_kernel=True against use_kernel=False (PyTorch gathers) on the
    card, the same weights — loss within 1e-5 relative, every gradient
    within 1e-4 of its largest magnitude; the jpq_lookup pair launched,
    the jpq_scores pair exactly where [T, N] logits exist (full_ce, and
    BERT4Rec's masked targets under sampled_bce)."""
    batch = _small_batch(dev, arch)
    res = {}
    for uk in (True, False):
        model = _small_seqrec(dev, arch, uk, loss=loss,
                              semantic_weight=weight)
        sc.reset_launches()
        lc.reset_launches()
        out, mets = model.train_loss(model.params(), batch)
        out.backward()
        torch.cuda.synchronize()
        res[uk] = (float(out.detach()), [x.grad for x in model.parameters()],
                   {**sc.launches, **lc.launches}, mets)
    logits = loss == "full_ce" or arch == "bert4rec" and loss != "code_ce"
    for name, n in res[True][2].items():
        assert (n > 0) == (logits or name.startswith("jpq_lookup")), \
            (name, res[True][2])
    assert not any(res[False][2].values())
    assert ("code_ce" in res[True][3]) == (weight > 0)
    assert abs(res[True][0] - res[False][0]) <= 1e-5 * abs(res[False][0])
    for a, b in zip(res[True][1], res[False][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_microbatched_step_equals_the_single_step(dev):
    """microbatches=2 on [x; x] through the kernels gives each slice the
    single step's gradient on x, so both steps end bit-equal."""
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    x = {k: v.cpu().numpy() for k, v in _small_batch(dev, "sasrec").items()}
    xx = {k: np.concatenate([v, v]) for k, v in x.items()}
    out = {}
    for n, b in ((1, x), (2, xx)):
        model = _small_seqrec(dev)
        tr = Trainer(model, OptConfig(lr=3e-3),
                     TrainConfig(steps=2, log_every=1, eval_every=0,
                                 microbatches=n), data_fn=lambda s, b=b: b)
        p, hist = tr.run(params=model.params())
        out[n] = ([t.detach().clone() for t in tree_leaves(p)],
                  [h["loss"] for h in hist])
    assert out[1][1] == out[2][1]
    for a, b in zip(out[1][0], out[2][0]):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_microbatched_step_on_distinct_halves(dev):
    """microbatches=2 on [a; b] through the kernels against the mean of
    the single steps on a and on b (loss 1e-5 relative, gradients 1e-4
    of their largest entry); b keeps only its last 3 positions, so the
    single step on [a; b] differs from that mean."""
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    ab = _small_batch(dev, "sasrec", B=8)
    for v in ab.values():
        v[4:, :-3] = 0
    model = _small_seqrec(dev)
    p = model.params()
    floats = list(model.parameters())

    def step(n, b):
        tr = Trainer(model, OptConfig(), TrainConfig(steps=1, microbatches=n),
                     data_fn=None)
        g, mets = tr._grads(p, floats, b, 0)
        return float(mets["loss"]), g

    lm, gm = step(2, ab)
    la, ga = step(1, {k: v[:4] for k, v in ab.items()})
    lb, gb = step(1, {k: v[4:] for k, v in ab.items()})
    lw, _ = step(1, ab)
    want = (la + lb) / 2
    assert abs(lm - want) <= 1e-5 * abs(want)
    assert abs(lw - want) > 1e-5 * abs(want)
    for x, y, z in zip(gm, ga, gb):
        ref = (y + z) / 2
        assert float((x - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_preempted_run_resumes_bit_equal_on_the_card(dev, tmp_path):
    """A real SIGTERM while step 1's batch is drawn: the checkpoint is
    stamped at step 2, and the resumed run ends bit-equal to the
    uninterrupted one (dropout on, drawn from (seed, step))."""
    import os
    import signal

    from repro_torch.ckpt import latest_step
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    batch = {k: v.cpu().numpy()
             for k, v in _small_batch(dev, "sasrec").items()}

    def run(d, sigterm_at=None):
        model = _small_seqrec(dev, dropout=0.2)

        def data_fn(s):
            if s == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return {k: np.roll(v, s, 0) for k, v in batch.items()}

        tr = Trainer(model, OptConfig(lr=3e-3),
                     TrainConfig(steps=4, log_every=1, eval_every=0,
                                 ckpt_dir=d, ckpt_every=0), data_fn=data_fn)
        p, _ = tr.run(params=model.params())
        return tr, [t.detach().clone() for t in tree_leaves(p)]

    _, want = run(None)
    d = str(tmp_path)
    tr, _ = run(d, sigterm_at=1)
    assert tr._preempted and tr.done_step == 2 and latest_step(d) == 2
    tr, got = run(d)
    assert tr.done_step == 4 and latest_step(d) == 4
    for a, b in zip(want, got):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_checkpoint_restores_onto_the_card(dev, tmp_path):
    """A checkpoint written from the card (and one written from numpy on
    the host) restores into a model on the card, leaf for leaf."""
    from repro_torch.ckpt import restore_values, save_checkpoint
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.optimizer import tree_map
    src = _small_seqrec(dev, seed=3).params()
    save_checkpoint(str(tmp_path / "card"), {"values": src}, 7)
    save_checkpoint(str(tmp_path / "host"), tree_map(
        lambda x: x.detach().cpu().numpy(), src), 7)
    for where in ("card", "host"):
        p = _small_seqrec(dev, seed=4).params()
        assert restore_values(str(tmp_path / where), p) == 7
        for a, b in zip(tree_leaves(p), tree_leaves(src)):
            assert a.device.type == "cuda"
            assert torch.equal(a.detach().view(torch.uint8),
                               b.detach().view(torch.uint8))


def test_semantic_decode_on_the_card_equals_the_cpu(dev):
    """The beam search (searchsorted, the total-order top-W) gives the
    same values and ids on the card as on the CPU, narrow and
    exhaustive."""
    from repro_torch.core import semantic
    g = torch.Generator(device=dev).manual_seed(5)
    codes = torch.randint(0, 16, (3_000, 4), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    codes[1_500:1_600] = codes[:100]
    part = torch.randint(-3, 4, (9, 4, 16), generator=g,
                         device=dev).float() / 2
    on_card = semantic.build_code_index(codes, 16)
    on_cpu = semantic.build_code_index(codes.cpu(), 16)
    for beams in (3, 40, None):
        v, i = semantic.semantic_decode(part, on_card, 10, beams=beams)
        cv, ci = semantic.semantic_decode(part.cpu(), on_cpu, 10, beams=beams)
        assert v.is_cuda and torch.equal(i.cpu(), ci)
        assert _bits_equal(v.cpu(), cv)


def test_semantic_exhaustive_decode_equals_jpq_topk(dev):
    """At 2,000 rows with duplicate code rows (ties), the exhaustive
    decode equals jpq_topk's values and ids on a canonical LUT."""
    from repro_torch.core import semantic
    g = torch.Generator(device=dev).manual_seed(6)
    codes = torch.randint(0, 256, (2_000, 8), generator=g, device=dev,
                          dtype=torch.int32)
    codes[1_000:1_050] = codes[:50]
    codes = codes.to(torch.uint8)
    P = ops.canonicalise_lut(torch.randint(
        -3, 4, (16, 8, 256), generator=g, device=dev).float() / 2)
    idx = semantic.build_code_index(codes, 256)
    v, i = semantic.semantic_decode(P, idx, 10, beams=None)
    assert _same((v, i), kc.jpq_topk(P.contiguous(), codes, 10))


def test_semantic_head_serves_kernel_exact_values(dev):
    """--head semantic through serve_loop on the card: no sweep kernel
    launched, and every value of a request equals the jpq_scores
    kernel's score of its id."""
    from repro_torch.configs import get_bundle
    from repro_torch.core import engine as engine_mod
    from repro_torch.launch import serve as serve_mod
    model, batch = get_bundle("two-tower-retrieval-jpq").make_smoke(
        device=dev)
    params = model.params()
    template = {k: v for k, v in batch.items() if k != "label"}
    args = serve_mod.build_parser().parse_args(
        ["--head", "semantic", "--requests", "3", "--batch-size", "16"])
    kc.reset_launches()
    sc.reset_launches()
    res = serve_mod.serve_loop(model, params, template, args)
    assert res["path"] == "semantic"
    assert not any(kc.launches.values()) and not any(sc.launches.values())
    req = next(serve_mod.make_requests(template, 16, 1, 9, reserved=(0,)))
    hist = torch.as_tensor(req["user_hist"], device=dev)
    spec = engine_mod.spec_from_args(args, kind="jpq", k=10)
    with torch.no_grad():
        v, i = model.bind_engine(params, spec).retrieve({"user_hist": hist})
        P = jpq_mod.partial_scores(params["item_emb"],
                                   model.user_vec(params, hist))
        S = sc.jpq_scores(P.contiguous(), params["item_emb"]["codes"])
    assert bool((i >= 0).all()) and bool((i < S.shape[1]).all())
    assert _bits_equal(v, S.gather(1, i.long()))


@pytest.mark.parametrize("prune", [False, True])
def test_seqrec_retrieve_topk_equals_score_last(dev, prune):
    """SeqRecModel.retrieve_topk through jpq_topk (or the pruned kernel)
    equals the total-order top-k of score_last through jpq_scores."""
    from repro_torch.core import engine as engine_mod
    model = _small_seqrec(dev)
    p = model.params()
    seq = _small_batch(dev, "sasrec", seed=8, B=32)["seq"]
    with torch.no_grad():
        s = model.score_last(p, seq)
        want = engine_mod.rerank_candidates(
            s, torch.arange(s.shape[1], dtype=torch.int32,
                            device=dev).expand_as(s), 10)
        kc.reset_launches()
        got = model.retrieve_topk(p, seq, k=10, prune=prune)
    assert kc.launches["jpq_topk_pruned" if prune else "jpq_topk"] > 0
    assert _same(got, want)
