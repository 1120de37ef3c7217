"""ctypes wrappers of the hand-written jpq_scores kernels
(``csrc/jpq_scores.cu``), forward and backward.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches
on the current stream, raises if the launch returned an error, and adds
the number of kernels it launched to its entry in ``launches``.  The
plain versions live in ``ref``; ``ops`` decides between the two by the
tensor's device alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SMEM_LIMIT = 232448    # shared memory a block may use on Hopper (227 KB)
# the backward's TILE and BINS in csrc/jpq_scores.cu, for sizing its
# scratch and chunks here
BWD_TILE = 512         # items a tile of the backward's sort and sums
BWD_BINS = 1024        # bins a block of the backward's sums
_LIB = "jpq_scores"
_P, _I = _build.P, _build.I

# kernel launches made by each wrapper, for showing which kernels a run
# went through (reset with ``reset_launches``)
launches = {"jpq_scores": 0, "jpq_scores_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _smem_check(fn_name: str, m: int, b: int):
    need = _build.fn(_LIB, fn_name, [_I, _I], ctypes.c_size_t)(m, b)
    if need > SMEM_LIMIT:
        raise ValueError(f"{_LIB}: m={m}, b={b} needs {need} bytes of shared "
                         f"memory per block, above the card's {SMEM_LIMIT}")


def _check_codes(codes, x, b: int, name: str):
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors; the plain version in "
                         f"repro_torch.kernels.jpq_scores.ref takes CPU ones")
    N, m = codes.shape
    _build.check(codes, "codes", (torch.uint8, torch.int32), (N, m), x.device)
    return N, m, _build.code_bytes(codes, b)


FWD_RANGES_MAX = 16    # most item ranges the planner splits N into
# the launch shape of the forward's last call, as the library launched
# it: T, N, G queries a block, items_per_block, item_ranges, blocks, and
# the SM count the plan was made for
fwd_launch_shape: dict = {}


@functools.lru_cache(maxsize=None)
def fwd_group(m: int, b: int) -> int:
    """Queries a block of the forward, as the library picks them: the
    most, a multiple of 4 and at most 28, whose LUT and staging fit the
    block's shared memory (24 at m*b = 2,048)."""
    G = _build.fn(_LIB, "jpq_scores_fwd_group", [_I, _I])(m, b)
    if G == 0:
        raise ValueError(f"{_LIB}: m={m}, b={b}: the LUT of 4 queries and "
                         f"the forward's staging do not fit the "
                         f"{SMEM_LIMIT} bytes of shared memory of a block")
    return G


def fwd_step() -> int:
    """Items a warp step of the forward (the library's): an item range
    is a whole number of them."""
    return _build.fn(_LIB, "jpq_scores_fwd_step", [])()


@functools.lru_cache(maxsize=None)
def fwd_plan(T: int, G: int, N: int, sms: int, step: int):
    """(item ranges, items a range) of the forward for G queries a block
    and warp steps of ``step`` items: of 1..``FWD_RANGES_MAX`` ranges
    (each a whole number of steps, none empty), the count whose blocks,
    one an SM, fill their last wave best, the fewest on a tie (each range
    loads its group's LUT once).  At T = 3,200, G = 24 and 132 SMs: 134
    groups x 16 ranges = 2,144 blocks, 95.5% of 17 waves."""
    groups = -(-T // G)
    steps = -(-N // step)

    def split(r):
        per = -(-steps // r)
        return -(-steps // per), per * step

    def fill(r):
        blocks = groups * split(r)[0]
        return blocks / (-(-blocks // sms) * sms)

    r = max(range(1, min(FWD_RANGES_MAX, steps) + 1),
            key=lambda r: (fill(r), -r))
    return split(r)


def jpq_scores(partial, codes):
    """partial [T, m, b] f32, codes [N, m] uint8/int32, on the card ->
    scores [T, N] f32 (one kernel: ``fwd_group`` queries a block, item
    ranges as ``fwd_plan`` picks them for the card's SMs; the launch
    shape goes to ``fwd_launch_shape``)."""
    T, m, b = partial.shape
    N, _, cb = _check_codes(codes, partial, b, "jpq_scores")
    dev = partial.device
    _build.check(partial, "partial", (torch.float32,), (T, m, b), dev)
    G, sms = fwd_group(m, b), _build.sm_count(dev)
    _, per = fwd_plan(T, G, N, sms, fwd_step())
    launch = _build.fn(_LIB, "jpq_scores_fwd_launch",
                       [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    grid = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        out = torch.empty((T, N), dtype=torch.float32, device=dev)
        rc = launch(partial.data_ptr(), codes.data_ptr(), cb, T, m, b, N, G,
                    per, out.data_ptr(), grid, _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["jpq_scores"] += 1
    fwd_launch_shape.clear()
    fwd_launch_shape.update(T=T, N=N, G=G, items_per_block=per,
                            item_ranges=grid[0], blocks=grid[0] * grid[1],
                            sms=sms)
    return out


def bwd_chunking(N: int, chunks: int):
    """(tiles a chunk, chunks) of the backward for ``chunks`` item chunks
    asked for: at least one, at most one a tile, none empty."""
    n_tiles = -(-N // BWD_TILE)
    tpc = -(-n_tiles // max(1, min(chunks, n_tiles)))
    return tpc, -(-n_tiles // tpc)


def bwd_auto_chunks(T: int, m: int, b: int, N: int, sms: int) -> int:
    """Item chunks for the backward's sums when the caller names none:
    of 1..8, the count whose blocks (one an SM) fill their last wave
    best, the smallest on a tie.  At T = 3,200, m*b = 2,048 and 132 SMs
    one chunk is 200 blocks, a wave and a half; seven are 1,400 blocks,
    96% of 11 waves."""
    per = -(-(m * b) // BWD_BINS) * -(-T // 32)   # blocks a chunk

    def fill(c):
        blocks = per * bwd_chunking(N, c)[1]
        return blocks / (-(-blocks // sms) * sms)

    return max(range(1, 9), key=lambda c: (fill(c), -c))


def bwd_chunks(T: int, m: int, b: int, N: int, dev, chunks=None) -> int:
    """The item chunks ``jpq_scores_bwd`` sums over on ``dev`` for
    ``chunks`` (None: ``bwd_auto_chunks`` for the card's SMs)."""
    if chunks is None:
        chunks = bwd_auto_chunks(T, m, b, N, _build.sm_count(dev))
    return bwd_chunking(N, chunks)[1]


def bwd_chain(codes, b: int, chunks: int = 1):
    """[m, b] int64: the longest chain of fp32 adds into each output of
    the backward, max over item chunks of the items the chunk gives the
    bin, plus ``chunks - 1`` adds of the chunk partials.  Its output is
    within gamma(chain - 1) * sum|terms| of the exact sum.  Plain
    PyTorch, on any device."""
    N, m = codes.shape
    tpc, n_chunks = bwd_chunking(N, chunks)
    chunk = torch.arange(N, device=codes.device) // (tpc * BWD_TILE)
    key = (chunk[:, None] * m + torch.arange(m, device=codes.device)) * b \
        + codes.long()
    counts = torch.bincount(key.reshape(-1), minlength=n_chunks * m * b)
    return counts.view(n_chunks, m, b).amax(0) + (n_chunks - 1)


def sort_codes_plain(codes, b: int):
    """The backward's code sort, plain: (lists [n_tiles, m, BWD_TILE]
    int64, starts [n_tiles, m*b + 1] int64).  For each tile of BWD_TILE
    items and split j, the tile's item offsets ordered by code, ascending
    within a code; the tile's items past N come last with the offset
    BWD_TILE.  ``starts[t, j*b + c]`` is ``j*BWD_TILE`` plus the position
    of code c's first item in split j's list; the last entry is
    ``m*BWD_TILE``."""
    N, m = codes.shape
    n_tiles = -(-N // BWD_TILE)
    c = torch.full((n_tiles * BWD_TILE, m), b, dtype=torch.int64,
                   device=codes.device)
    c[:N] = codes.long()
    c = c.view(n_tiles, BWD_TILE, m).transpose(1, 2)         # [tiles, m, C]
    order = torch.sort(c, dim=2, stable=True).indices
    lists = torch.where(torch.gather(c, 2, order) < b, order, BWD_TILE)
    counts = torch.zeros((n_tiles, m, b + 1), dtype=torch.int64,
                         device=codes.device)
    counts.scatter_add_(2, c, torch.ones_like(c))
    first = torch.cumsum(counts, 2)[:, :, :b] - counts[:, :, :b]
    first += BWD_TILE * torch.arange(m, device=codes.device)[:, None]
    starts = torch.cat([first.reshape(n_tiles, m * b),
                        torch.full((n_tiles, 1), m * BWD_TILE,
                                   dtype=torch.int64, device=codes.device)],
                       1)
    return lists, starts


def _sort_buffer(n_tiles: int, m: int, b: int, dev):
    """The sort's scratch: uint16 lists then bin starts (rows of m*b
    rounded up to whole sum blocks of BWD_BINS, plus 8), as int16."""
    fs = -(-(m * b) // BWD_BINS) * BWD_BINS + 8
    buf = torch.empty(n_tiles * (m * BWD_TILE + fs), dtype=torch.int16,
                      device=dev)
    return buf, fs


def sort_codes(codes, b: int):
    """The backward's first kernel alone, on the card: (lists, starts)
    as ``sort_codes_plain`` gives them (one kernel)."""
    N, m, cb = _check_codes(codes, codes, b, "sort_codes")
    n_tiles = -(-N // BWD_TILE)
    dev = codes.device
    launch = _build.fn(_LIB, "jpq_scores_sort_launch",
                       [_P, _I, _I, _I, _I, _P, _P])
    with torch.cuda.device(dev):
        buf, fs = _sort_buffer(n_tiles, m, b, dev)
        rc = launch(codes.data_ptr(), cb, m, b, N, buf.data_ptr(),
                    _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["jpq_scores_bwd"] += 1
    u16 = buf.long() & 0xFFFF
    n_lists = n_tiles * m * BWD_TILE
    return (u16[:n_lists].view(n_tiles, m, BWD_TILE),
            u16[n_lists:].view(n_tiles, fs)[:, :m * b + 1])


def jpq_scores_bwd(dS, codes, b: int, *, chunks=None):
    """dS [T, N] f32, codes [N, m], on the card -> dP [T, m, b] f32 with
    ``dP[t, j, c] = sum_{i : codes[i, j] = c} dS[t, i]``, the same bits
    on every call.  Kernels: the code sort, the sums over item chunks
    (``bwd_chunks``: ``chunks``, or by default as many as fill the
    card's last wave best), and with more than one chunk the sum of
    their partials in chunk order.  With ``chunks=1`` each output is one
    chain over its items in ascending order from +0.0, bit-equal to
    ``ref``'s ``index_add_`` on the CPU."""
    N, m, cb = _check_codes(codes, dS, b, "jpq_scores_bwd")
    T = dS.shape[0]
    dev = dS.device
    _build.check(dS, "dS", (torch.float32,), (T, N), dev)
    if chunks is not None and chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    if m * BWD_TILE > 65535:
        raise ValueError(f"jpq_scores_bwd takes m <= {65535 // BWD_TILE}, "
                         f"got m={m}")
    _smem_check("jpq_scores_bwd_smem_bytes", m, b)
    launch = _build.fn(_LIB, "jpq_scores_bwd_launch",
                       [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P])
    n_chunks = bwd_chunks(T, m, b, N, dev, chunks)
    tpc = bwd_chunking(N, n_chunks)[0]
    with torch.cuda.device(dev):
        buf, _ = _sort_buffer(-(-N // BWD_TILE), m, b, dev)
        partial = (torch.empty((T, n_chunks, m, b), dtype=torch.float32,
                               device=dev) if n_chunks > 1 else None)
        dP = torch.empty((T, m, b), dtype=torch.float32, device=dev)
        rc = launch(dS.data_ptr(), codes.data_ptr(), cb, T, m, b, N, tpc,
                    n_chunks, buf.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    dP.data_ptr(), _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["jpq_scores_bwd"] += 2 if n_chunks == 1 else 3
    return dP
