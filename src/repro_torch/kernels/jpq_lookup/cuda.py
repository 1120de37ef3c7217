"""ctypes wrappers of the hand-written jpq_lookup kernels
(``csrc/jpq_lookup.cu``), forward and backward.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream, raises if the launch returned an error, and adds the
number of kernels it launched to its entry in ``launches``.  The plain
versions live in ``ref``; ``ops`` decides between the two by the
tensor's device alone.  The calls are small (microseconds on the card),
so the host side is kept short: the checks are inline comparisons
rather than calls of the shared checker, the launcher is looked up
once, and the device is entered only when it is not the current one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build

_LIB = "jpq_lookup"
_P, _I = _build.P, _build.I
_SIG = [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P]
_ID_T = (torch.int32, torch.int64)
_CODE_T = (torch.uint8, torch.int32)

# kernel launches made by each wrapper, for showing which kernels a run
# went through (reset with ``reset_launches``)
launches = {"jpq_lookup": 0, "jpq_lookup_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(ids, codes, x, m: int, what: str, name: str) -> None:
    """Raise unless ids [T] int32/int64, codes [N, m] uint8/int32 and x
    float32 are contiguous tensors on x's card (the callers check x's
    own shape against ids)."""
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors; the plain version in "
                         f"repro_torch.kernels.jpq_lookup.ref takes CPU ones")
    dev = x.device
    if x.dtype != torch.float32:
        raise TypeError(f"{what} dtype {x.dtype} is not torch.float32")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if not isinstance(ids, torch.Tensor) or ids.device != dev:
        raise ValueError(f"ids must be a tensor on {dev}, got "
                         f"{getattr(ids, 'device', type(ids))}")
    if not isinstance(codes, torch.Tensor) or codes.device != dev:
        raise ValueError(f"codes must be a tensor on {dev}, got "
                         f"{getattr(codes, 'device', type(codes))}")
    if ids.dtype not in _ID_T:
        raise TypeError(f"ids dtype {ids.dtype} not in {_ID_T}")
    if codes.dtype not in _CODE_T:
        raise TypeError(f"codes dtype {codes.dtype} not in {_CODE_T}")
    if ids.dim() != 1:
        raise ValueError(f"ids shape {tuple(ids.shape)} is not [T]")
    if codes.dim() != 2 or codes.shape[1] != m:
        raise ValueError(f"codes shape {tuple(codes.shape)} is not [N, {m}]")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")


def jpq_lookup(ids, codes, centroids):
    """ids [T] int32/int64, codes [N, m], centroids [m, b, dk] f32, on
    the card -> [T, m, dk] f32 (one kernel)."""
    m, b, dk = centroids.shape
    _check(ids, codes, centroids, m, "centroids", "jpq_lookup")
    T, N = ids.shape[0], codes.shape[0]
    dev = centroids.device
    out = torch.empty((T, m, dk), dtype=torch.float32, device=dev)
    rc = _build.launch(_build.fn(_LIB, "jpq_lookup_fwd_launch", _SIG), dev,
                       ids.data_ptr(), ids.element_size(), codes.data_ptr(),
                       _build.code_bytes(codes, b), centroids.data_ptr(), T,
                       m, b, dk, N, out.data_ptr())
    if rc:
        _build.raise_on(rc, _LIB)
    launches["jpq_lookup"] += 1
    return out


def jpq_lookup_bwd(ids, codes, dout, b: int):
    """ids [T], codes [N, m], dout [T, m, dk] f32, on the card -> dcent
    [m, b, dk] f32: each entry the fp32 sum of its positions' rows in
    ascending position order from +0.0, bit-equal to ``ref``'s
    ``index_add_`` on the CPU and the same bits on every call (one
    kernel)."""
    T, m, dk = dout.shape
    _check(ids, codes, dout, m, "dout", "jpq_lookup_bwd")
    if ids.shape[0] != T:
        raise ValueError(f"dout shape {(T, m, dk)} does not match ids "
                         f"{tuple(ids.shape)}")
    N = codes.shape[0]
    dev = dout.device
    dcent = torch.empty((m, b, dk), dtype=torch.float32, device=dev)
    rc = _build.launch(_build.fn(_LIB, "jpq_lookup_bwd_launch", _SIG), dev,
                       ids.data_ptr(), ids.element_size(), codes.data_ptr(),
                       _build.code_bytes(codes, b), dout.data_ptr(), T, m, b,
                       dk, N, dcent.data_ptr())
    if rc:
        _build.raise_on(rc, _LIB)
    launches["jpq_lookup_bwd"] += 1
    return dcent
