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

import torch

from repro_torch.kernels import build as _build

KMAX = 1024            # largest k the kernels take (csrc/jpq_common.cuh)
CHUNK = 32768          # items per block in the unpruned kernel's first pass
SMEM_LIMIT = 232448    # shared memory a block may use on Hopper (227 KB)

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


def _smem_check(lib_name: str, fn_name: str, k: int, m: int, b: int):
    need = _build.fn(lib_name, fn_name, [_I, _I, _I],
                     ctypes.c_size_t)(k, m, b)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{lib_name}: k={k}, m={m}, b={b} needs {need} bytes of shared "
            f"memory per block, above the card's {SMEM_LIMIT}")


def jpq_topk(partial, codes, k: int, *, chunk: int | None = None):
    """partial [B, m, b] f32 (canonicalised), codes [N, m] uint8/int32,
    on the card -> (values [B, k] f32, ids [B, k] int32), k <= N.
    ``chunk`` (default ``CHUNK``) is the items per block of the first
    pass.  Each call launches two kernels, the chunk pass and the merge,
    and counts both."""
    B, m, b, N, dev = _check_common(partial, codes, k, "jpq_topk")
    if k > N:
        raise ValueError(f"k={k} > N={N}: clamp k first")
    chunk = CHUNK if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    _smem_check("jpq_topk", "jpq_topk_smem_bytes", k, m, b)
    launch = _build.fn("jpq_topk", "jpq_topk_launch",
                 [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P])
    n_chunks = -(-N // chunk)
    with torch.cuda.device(dev):
        cand = torch.empty((B, n_chunks, k), dtype=torch.int64, device=dev)
        out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
        rc = launch(partial.data_ptr(), codes.data_ptr(),
                    _build.code_bytes(codes, b), B, m, b, N, k, chunk,
                    cand.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                    _build.stream(dev))
    _build.raise_on(rc, "jpq_topk")
    launches["jpq_topk"] += 2
    return out_v, out_i


def pruned_group_size() -> int:
    """Queries a block of the pruned kernel sweeps together, as the
    library reports it: the skip map has ``ceil(B / group)`` rows."""
    return _build.fn("jpq_topk_pruned", "jpq_topk_pruned_group_size", [])()


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
    _smem_check("jpq_topk_pruned", "jpq_topk_pruned_smem_bytes", k, m, b)
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
