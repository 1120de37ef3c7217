"""ctypes wrappers of the hand-written PQTopK kernels (``csrc/``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches
on the current stream, raises if the launch returned an error, and adds
the number of kernels it launched to its entry in ``launches``.  The
plain versions live in ``ops``;
``ops`` decides between the two by the tensor's device alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

KMAX = 1024            # largest k the kernels take (csrc/jpq_common.cuh)
SMEM_LIMIT = 232448    # shared memory a block may use on Hopper (227 KB)
RANGES_MAX = 128       # most item ranges the unpruned kernel's planner picks
# what a range costs besides its items, in items scored: its LUT load, and
# the cold start and merges of its lists, which grow with k (at k = 100
# many short ranges take several times as long as one wave of long ones)
RANGE_COST = 16384

# kernel launches made by each wrapper, for showing which kernels a run
# went through (reset with ``reset_launches``)
launches = {"jpq_topk": 0, "jpq_topk_pruned": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P, _I = _build.P, _build.I


def _check_common(partial, codes, k: int, name: str):
    if not 1 <= k <= KMAX:
        raise ValueError(f"{name} takes 1 <= k <= {KMAX} (the kernel's "
                         f"limit, KMAX in csrc/jpq_common.cuh), got k={k}")
    if not partial.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors; the plain version "
                         f"in repro_torch.kernels.jpq_topk.ops takes CPU ones")
    B, m, b = partial.shape
    N = codes.shape[0]
    dev = partial.device
    _build.check(partial, "partial", (torch.float32,), (B, m, b), dev)
    _build.check(codes, "codes", (torch.uint8, torch.int32), (N, m), dev)
    return B, m, b, N, dev


def _pruned_smem_check(k: int, m: int, b: int):
    need = _build.fn("jpq_topk_pruned", "jpq_topk_pruned_smem_bytes",
                     [_I, _I, _I], ctypes.c_size_t)(k, m, b)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"jpq_topk_pruned: k={k}, m={m}, b={b} needs {need} bytes of "
            f"shared memory per block, above the card's {SMEM_LIMIT}")


@functools.lru_cache(maxsize=None)
def group(k: int, m: int, b: int) -> int:
    """Queries a block of the unpruned kernel, as the library picks them:
    the most, a multiple of 4 and at most 28, whose LUT, running lists
    and candidate buffers fit a block's shared memory (24 at k = 10 and
    m*b = 2,048; 20 at k = 100; 8 at k = 1,024)."""
    G = _build.fn("jpq_topk", "jpq_topk_group", [_I, _I, _I])(k, m, b)
    if G == 0:
        raise ValueError(
            f"jpq_topk: k={k}, m={m}, b={b}: the LUT, lists and candidate "
            f"buffers of 4 queries do not fit the {SMEM_LIMIT} bytes of "
            f"shared memory of a block")
    return G


def step() -> int:
    """Items a block step of the unpruned kernel (the library's): a
    planned item range is a whole number of them."""
    return _build.fn("jpq_topk", "jpq_topk_step", [])()


@functools.lru_cache(maxsize=None)
def range_plan(B: int, G: int, N: int, sms: int, step: int):
    """(item ranges, items a range) of the unpruned kernel for G queries
    a block and block steps of ``step`` items: of 1..``RANGES_MAX``
    ranges (each a whole number of steps, none empty), the count whose
    grid, one block an SM, ends soonest: waves x (items a range +
    ``RANGE_COST``), the fewest ranges on a tie.  At B = 512, G = 24 and
    132 SMs: 22 groups x 6 ranges = 132 blocks, one wave."""
    groups = -(-B // G)
    steps = -(-N // step)

    def split(r):
        per = -(-steps // r)
        return -(-steps // per), per * step

    def makespan(r):
        ranges, per = split(r)
        return -(-groups * ranges // sms) * (per + RANGE_COST)

    r = min(range(1, min(RANGES_MAX, steps) + 1),
            key=lambda r: (makespan(r), r))
    return split(r)


def range_count(B: int, N: int, k: int, m: int, b: int, dev,
                chunk: int | None = None) -> int:
    """Item ranges of ``jpq_topk``'s call on ``dev`` (its candidate
    scratch is ``[B, ranges, k]`` int64): ``chunk`` items a range, or
    the ranges ``range_plan`` picks for the card's SMs."""
    if chunk is None:
        chunk = range_plan(B, group(k, m, b), N, _build.sm_count(dev),
                           step())[1]
    return -(-N // int(chunk))


# the launch shape of the unpruned kernel's last call, as the library
# launched it: B, N, G queries a block, item ranges, items a range,
# blocks, warps a block, and the SM count the plan was made for
launch_shape: dict = {}


def jpq_topk(partial, codes, k: int, *, chunk: int | None = None):
    """partial [B, m, b] f32 (canonicalised), codes [N, m] uint8/int32,
    on the card -> (values [B, k] f32, ids [B, k] int32), k <= N.
    ``chunk`` is the items a block's range; by default ``range_plan``
    picks the ranges for the card's SMs.  Each call launches two
    kernels, the range pass and the merge, and counts both; the launch
    shape goes to ``launch_shape``."""
    B, m, b, N, dev = _check_common(partial, codes, k, "jpq_topk")
    if k > N:
        raise ValueError(f"k={k} > N={N}: clamp k first")
    G, sms = group(k, m, b), _build.sm_count(dev)
    if chunk is None:
        per = range_plan(B, G, N, sms, step())[1]
    else:
        per = int(chunk)
        if per < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
    launch = _build.fn("jpq_topk", "jpq_topk_launch",
                       [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P])
    grid = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        cand = torch.empty((B, -(-N // per), k), dtype=torch.int64,
                           device=dev)
        out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
        rc = launch(partial.data_ptr(), codes.data_ptr(),
                    _build.code_bytes(codes, b), B, m, b, N, k, G, per,
                    cand.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                    grid, _build.stream(dev))
    _build.raise_on(rc, "jpq_topk")
    launches["jpq_topk"] += 2
    launch_shape.clear()
    launch_shape.update(B=B, N=N, G=G, ranges=grid[0], items_per_range=per,
                        blocks=grid[0] * grid[1], warps=grid[2], sms=sms)
    return out_v, out_i


# queries a block of the pruned kernel (``csrc/jpq_topk_pruned.cu``'s
# group): the shape of its skip map, known before the library loads
PRUNED_GROUP = 4


def pruned_group_size() -> int:
    """Queries a block of the pruned kernel sweeps together, as the
    library reports it: the skip map has ``ceil(B / group)`` rows.
    Raises if it is not ``PRUNED_GROUP``, which shapes the fake op."""
    g = _build.fn("jpq_topk_pruned", "jpq_topk_pruned_group_size", [])()
    if g != PRUNED_GROUP:
        raise RuntimeError(f"jpq_topk_pruned: the library's group {g} is "
                           f"not PRUNED_GROUP = {PRUNED_GROUP}")
    return g


def jpq_topk_pruned(partial, codes, ids, present, floor, init_vals,
                    init_ids, *, k: int, block_n: int, tie_break_ids: bool):
    """The pruned sweep on the card.  ``codes [N, m]`` in sweep order,
    ``ids [N]`` int32 original ids, ``present [n_tiles, m, b]`` f32,
    ``floor [B]`` f32, ``init_vals``/``init_ids [B, k]`` the list seed.
    Returns (values [B, k], ids [B, k], skip map [n_groups, n_tiles]
    int32, 1 where the query group skipped the tile)."""
    B, m, b, N, dev = _check_common(partial, codes, k, "jpq_topk_pruned")
    n_tiles = -(-N // block_n)
    _build.check(ids, "ids", (torch.int32,), (N,), dev)
    _build.check(present, "present", (torch.float32,), (n_tiles, m, b), dev)
    _build.check(floor, "floor", (torch.float32,), (B,), dev)
    _build.check(init_vals, "init_vals", (torch.float32,), (B, k), dev)
    _build.check(init_ids, "init_ids", (torch.int32,), (B, k), dev)
    _pruned_smem_check(k, m, b)
    launch = _build.fn("jpq_topk_pruned", "jpq_topk_pruned_launch",
                 [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _I, _P, _P, _P, _P])
    n_groups = -(-B // pruned_group_size())
    with torch.cuda.device(dev):
        out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
        skip = torch.empty((n_groups, n_tiles), dtype=torch.int32,
                           device=dev)
        rc = launch(partial.data_ptr(), codes.data_ptr(),
                    _build.code_bytes(codes, b), ids.data_ptr(),
                    present.data_ptr(), floor.data_ptr(),
                    init_vals.data_ptr(), init_ids.data_ptr(), B, m, b, N,
                    k, int(block_n), int(bool(tie_break_ids)),
                    out_v.data_ptr(), out_i.data_ptr(), skip.data_ptr(),
                    _build.stream(dev))
    _build.raise_on(rc, "jpq_topk_pruned")
    launches["jpq_topk_pruned"] += 1
    return out_v, out_i, skip
