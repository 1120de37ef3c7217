"""ctypes wrapper of the hand-written embedding_bag kernel
(``csrc/embedding_bag.cu``).

``launch`` checks device, dtype, shape and contiguity, allocates the
output and a one-int counter of ids outside [0, V) with ``torch.empty``,
launches on the current stream (the launcher zeroes the counter first),
raises if the launch returned an error, and adds one to
``launches["embedding_bag"]``.  ``embedding_bag`` reads the counter, the
one host synchronisation of a call, and raises if any id was out of
range.  The plain version lives in ``ref``; ``ops`` decides between the
two by the tensor's device alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

_LIB = "embedding_bag"
_P, _I = _build.P, _build.I

# kernel launches made by the wrapper, for showing which kernels a run
# went through (reset with ``reset_launches``)
launches = {"embedding_bag": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch(table, ids, weights=None):
    """The kernel alone: table [V, d] f32, ids [n_bags, L] int32/int64,
    weights [n_bags, L] f32 or None (unit weights), on the card ->
    (out [n_bags, d] f32, bad [1] int32: the count of ids outside
    [0, V), not yet read)."""
    if not table.is_cuda:
        raise ValueError("embedding_bag runs on CUDA tensors; the plain "
                         "version in repro_torch.kernels.embedding_bag.ref "
                         "takes CPU ones")
    V, d = table.shape
    n_bags, L = ids.shape
    dev = table.device
    _build.check(table, "table", (torch.float32,), (V, d), dev)
    _build.check(ids, "ids", (torch.int32, torch.int64), (n_bags, L), dev)
    if weights is not None:
        _build.check(weights, "weights", (torch.float32,), (n_bags, L), dev)
    fn = _build.fn(_LIB, "embedding_bag_launch",
                   [_P, ctypes.c_longlong, _I, _P, _I, _P, _I, _I, _P, _P,
                    _P])
    with torch.cuda.device(dev):
        out = torch.empty((n_bags, d), dtype=torch.float32, device=dev)
        bad = torch.empty((1,), dtype=torch.int32, device=dev)
        rc = fn(table.data_ptr(), V, d, ids.data_ptr(), ids.element_size(),
                None if weights is None else weights.data_ptr(), n_bags, L,
                out.data_ptr(), bad.data_ptr(), _build.stream(dev))
    _build.raise_on(rc, _LIB)
    launches["embedding_bag"] += 1
    return out, bad


def embedding_bag(table, ids, weights=None):
    """``launch``, then refuse the result if any id was outside [0, V)."""
    out, bad = launch(table, ids, weights)
    n_bad = int(bad.item())
    if n_bad:
        raise IndexError(f"embedding_bag: {n_bad} ids outside "
                         f"[0, {table.shape[0]})")
    return out
