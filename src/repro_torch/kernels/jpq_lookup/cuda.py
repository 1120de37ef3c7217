"""ctypes wrappers of the hand-written jpq_lookup kernels
(``csrc/jpq_lookup.cu``), forward and backward.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream, raises if the launch returned an error, and adds the
number of kernels it launched to its entry in ``launches``.  The plain
versions live in ``ref``; ``ops`` decides between the two by the
tensor's device alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build

_LIB = "jpq_lookup"
_P, _I = _build.P, _build.I

# kernel launches made by each wrapper, for showing which kernels a run
# went through (reset with ``reset_launches``)
launches = {"jpq_lookup": 0, "jpq_lookup_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_ids_codes(ids, codes, x, b: int, name: str):
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors; the plain version in "
                         f"repro_torch.kernels.jpq_lookup.ref takes CPU ones")
    (T,) = ids.shape
    N, m = codes.shape
    _build.check(ids, "ids", (torch.int32, torch.int64), (T,), x.device)
    _build.check(codes, "codes", (torch.uint8, torch.int32), (N, m), x.device)
    return T, N, m, ids.element_size(), _build.code_bytes(codes, b)


def jpq_lookup(ids, codes, centroids):
    """ids [T] int32/int64, codes [N, m], centroids [m, b, dk] f32, on
    the card -> [T, m, dk] f32 (one kernel)."""
    m, b, dk = centroids.shape
    T, N, _, ib, cb = _check_ids_codes(ids, codes, centroids, b, "jpq_lookup")
    dev = centroids.device
    _build.check(centroids, "centroids", (torch.float32,), (m, b, dk), dev)
    launch = _build.fn(_LIB, "jpq_lookup_fwd_launch",
                       [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P])
    with torch.cuda.device(dev):
        out = torch.empty((T, m, dk), dtype=torch.float32, device=dev)
        rc = launch(ids.data_ptr(), ib, codes.data_ptr(), cb,
                    centroids.data_ptr(), T, m, b, dk, N, out.data_ptr(),
                    _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["jpq_lookup"] += 1
    return out


def jpq_lookup_bwd(ids, codes, dout, b: int):
    """ids [T], codes [N, m], dout [T, m, dk] f32, on the card -> dcent
    [m, b, dk] f32, summed over positions in order (the same bits on
    every call; one kernel)."""
    T, N, m, ib, cb = _check_ids_codes(ids, codes, dout, b, "jpq_lookup_bwd")
    dk = dout.shape[-1]
    dev = dout.device
    _build.check(dout, "dout", (torch.float32,), (T, m, dk), dev)
    launch = _build.fn(_LIB, "jpq_lookup_bwd_launch",
                       [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P])
    with torch.cuda.device(dev):
        dcent = torch.empty((m, b, dk), dtype=torch.float32, device=dev)
        rc = launch(ids.data_ptr(), ib, codes.data_ptr(), cb, dout.data_ptr(),
                    T, m, b, dk, N, dcent.data_ptr(), _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["jpq_lookup_bwd"] += 1
    return dcent
