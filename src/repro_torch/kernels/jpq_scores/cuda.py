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

import torch

from repro_torch.kernels import build as _build

SMEM_LIMIT = 232448    # shared memory a block may use on Hopper (227 KB)
BWD_CHUNK = 65536      # items per block in the backward's first pass
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


def jpq_scores(partial, codes):
    """partial [T, m, b] f32, codes [N, m] uint8/int32, on the card ->
    scores [T, N] f32 (one kernel)."""
    T, m, b = partial.shape
    N, _, cb = _check_codes(codes, partial, b, "jpq_scores")
    dev = partial.device
    _build.check(partial, "partial", (torch.float32,), (T, m, b), dev)
    _smem_check("jpq_scores_fwd_smem_bytes", m, b)
    launch = _build.fn(_LIB, "jpq_scores_fwd_launch",
                       [_P, _P, _I, _I, _I, _I, _I, _P, _P])
    with torch.cuda.device(dev):
        out = torch.empty((T, N), dtype=torch.float32, device=dev)
        rc = launch(partial.data_ptr(), codes.data_ptr(), cb, T, m, b, N,
                    out.data_ptr(), _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["jpq_scores"] += 1
    return out


def jpq_scores_bwd(dS, codes, b: int, *, chunk: int = BWD_CHUNK):
    """dS [T, N] f32, codes [N, m], on the card -> dP [T, m, b] f32 with
    ``dP[t, j, c] = sum_{i : codes[i, j] = c} dS[t, i]``, the same bits
    on every call.  Two kernels: per-chunk histograms, then their sum in
    chunk order."""
    N, m, cb = _check_codes(codes, dS, b, "jpq_scores_bwd")
    T = dS.shape[0]
    dev = dS.device
    _build.check(dS, "dS", (torch.float32,), (T, N), dev)
    if chunk < 32 or chunk % 32:
        raise ValueError(f"chunk must be a positive multiple of 32, got "
                         f"{chunk}")
    _smem_check("jpq_scores_bwd_smem_bytes", m, b)
    launch = _build.fn(_LIB, "jpq_scores_bwd_launch",
                       [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    n_chunks = -(-N // chunk)
    with torch.cuda.device(dev):
        partial = torch.empty((T, n_chunks, m, b), dtype=torch.float32,
                              device=dev)
        dP = torch.empty((T, m, b), dtype=torch.float32, device=dev)
        rc = launch(dS.data_ptr(), codes.data_ptr(), cb, T, m, b, N, chunk,
                    partial.data_ptr(), dP.data_ptr(), _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["jpq_scores_bwd"] += 2
    return dP
