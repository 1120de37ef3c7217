"""ctypes wrapper of the hand-written embedding_bag kernel
(``csrc/embedding_bag.cu``).

``launch`` checks device, dtype, shape and contiguity, allocates the
output and a per-bag count of ids outside [0, V) with ``torch.empty``
(the kernel writes every bag's count, so nothing is zeroed: one device
operation a call), launches on the current stream, raises if the launch
returned an error, and adds one to ``launches["embedding_bag"]``.
``embedding_bag`` sums the counts, the one host synchronisation of a
call, and raises if any id was out of range.  The plain version lives
in ``ref``; ``ops`` decides between the two by the tensor's device
alone.  A call's host work is larger than the kernel's time on the card
at serving shapes, so it is kept short: the checks are inline
comparisons, the device is entered only when it is not the current one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

_LIB = "embedding_bag"
_P, _I = _build.P, _build.I
_SIG = [_P, ctypes.c_longlong, _I, _P, _I, _P, _I, _I, _P, _P, _P]
_ID_T = (torch.int32, torch.int64)

# kernel launches made by the wrapper, for showing which kernels a run
# went through (reset with ``reset_launches``)
launches = {"embedding_bag": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch(table, ids, weights=None):
    """The kernel alone: table [V, d] f32, ids [n_bags, L] int32/int64,
    weights [n_bags, L] f32 or None (unit weights), on the card ->
    (out [n_bags, d] f32, bad [n_bags] int32: each bag's count of ids
    outside [0, V), not yet read)."""
    if not table.is_cuda:
        raise ValueError("embedding_bag runs on CUDA tensors; the plain "
                         "version in repro_torch.kernels.embedding_bag.ref "
                         "takes CPU ones")
    dev = table.device
    if table.dtype != torch.float32:
        raise TypeError(f"table dtype {table.dtype} is not torch.float32")
    if table.dim() != 2:
        raise ValueError(f"table shape {tuple(table.shape)} is not [V, d]")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if not isinstance(ids, torch.Tensor) or ids.device != dev:
        raise ValueError(f"ids must be a tensor on {dev}, got "
                         f"{getattr(ids, 'device', type(ids))}")
    if ids.dtype not in _ID_T:
        raise TypeError(f"ids dtype {ids.dtype} not in {_ID_T}")
    if ids.dim() != 2:
        raise ValueError(f"ids shape {tuple(ids.shape)} is not [n_bags, L]")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if weights is not None:
        if not isinstance(weights, torch.Tensor) or weights.device != dev:
            raise ValueError(f"weights must be a tensor on {dev}, got "
                             f"{getattr(weights, 'device', type(weights))}")
        if weights.dtype != torch.float32:
            raise TypeError(f"weights dtype {weights.dtype} is not "
                            f"torch.float32")
        if weights.shape != ids.shape:
            raise ValueError(f"weights shape {tuple(weights.shape)} != ids "
                             f"shape {tuple(ids.shape)}")
        if not weights.is_contiguous():
            raise ValueError("weights must be contiguous")
    V, d = table.shape
    n_bags, L = ids.shape
    out = torch.empty((n_bags, d), dtype=torch.float32, device=dev)
    bad = torch.empty((n_bags,), dtype=torch.int32, device=dev)
    rc = _build.launch(_build.fn(_LIB, "embedding_bag_launch", _SIG), dev,
                       table.data_ptr(), V, d, ids.data_ptr(),
                       ids.element_size(),
                       None if weights is None else weights.data_ptr(),
                       n_bags, L, out.data_ptr(), bad.data_ptr())
    if rc:
        _build.raise_on(rc, _LIB)
    launches["embedding_bag"] += 1
    return out, bad


def embedding_bag(table, ids, weights=None):
    """``launch``, then refuse the result if any id was outside [0, V)."""
    out, bad = launch(table, ids, weights)
    n_bad = int(bad.sum())
    if n_bad:
        raise IndexError(f"embedding_bag: {n_bad} ids outside "
                         f"[0, {table.shape[0]})")
    return out
