"""ctypes wrappers of the hand-written embedding_bag kernels
(``csrc/embedding_bag.cu``): the forward and the port's backward.

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

``sort_ids`` is the backward's index preparation (integer work, no
float of the gradient): the flat ids as 32-bit keys, sorted stably by
CUB's radix sort over the bits a key has, the flat positions in that
order, the row offsets, the rows whose run is longer than ``LONG_RUN``
terms and an out-of-range flag (``Order``; ``ref.sort_ids_ref`` is its
plain version); it reads the flag and the long runs' count on the host,
the one synchronisation of a call.  ``launch_backward`` makes the order
(or takes the one a caller made), allocates dtable with ``torch.empty``
(the kernels write every row, so nothing is zero-filled), launches the
long-run kernel only where a run is long, and adds one to
``launches["embedding_bag_backward"]``; ``embedding_bag_backward``
raises on the flag before any kernel runs.  ``gather_backward`` is the
gradient of a plain gather ``table[ids]``: the same kernels at L = 1
with unit weights, a negative id counting from the end; with an order
made beforehand it reads nothing back to the host.
``block_backward`` is the backward on a rank's row block, whose
foreign slots carry the id V and are skipped.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

_LIB = "embedding_bag"
_P, _I = _build.P, _build.I
_SIG = [_P, ctypes.c_longlong, _I, _P, _I, _P, _I, _I, _P, _P, _P]
_LL = ctypes.c_longlong
_TEMP_SIG = [_LL, _LL, _I]
_SORT_SIG = [_P, _I, _I, _LL, _LL, _I, _I, _P, _P, _P, _P, _LL, _P, _P, _P,
             _P, _P]
_BWD_SIG = [_P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _LL, _P, _I, _I, _I, _P]
_ID_T = (torch.int32, torch.int64)
# a run longer than this many terms is a long_kernel item (a CTA a run
# and column slab); shorter ones are walked by a warp a group of rows
LONG_RUN = 64
LONG_BLOCKS_PER_SM = 1        # long_kernel's persistent CTAs an SM

# kernel launches made by the wrapper, for showing which kernels a run
# went through (reset with ``reset_launches``)
launches = {"embedding_bag": 0, "embedding_bag_backward": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_ids(ids, weights, dev):
    """ids [n_bags, L] int32/int64 and weights [n_bags, L] f32 or None,
    contiguous, on ``dev``."""
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


def _check_f32(t, what, shape_name):
    if t.dtype != torch.float32:
        raise TypeError(f"{what} dtype {t.dtype} is not torch.float32")
    if t.dim() != 2:
        raise ValueError(f"{what} shape {tuple(t.shape)} is not "
                         f"{shape_name}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


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
    _check_f32(table, "table", "[V, d]")
    _check_ids(ids, weights, dev)
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
    """``launch`` through ``repro_torch::embedding_bag``, then refuse the
    result if any id was outside [0, V) (not on fake tensors, which
    hold no ids to count)."""
    from repro_torch.kernels.library import has_data, op
    out, bad = op("embedding_bag")(table, ids, weights)
    n_bad = int(bad.sum()) if has_data(bad) else 0
    if n_bad:
        raise IndexError(f"embedding_bag: {n_bad} ids outside "
                         f"[0, {table.shape[0]})")
    return out


class Order(NamedTuple):
    """The backward's index preparation for one set of flat ids (P of
    them, over a V-row table), on the card."""
    perm: torch.Tensor      # [P] int32 (int64 if P >= 2^31): flat
                            # positions, ids ascending, equal ids by p
    offs: torch.Tensor      # [V + 1] perm's dtype: row v's run is
                            # perm[offs[v]:offs[v + 1]]
    work: torch.Tensor      # int32: the rows whose run is longer than
                            # LONG_RUN terms, n_long of them, any order
    counters: torch.Tensor  # [3] int32: work's length, long_kernel's next
                            # item and its CTAs done
    bad: torch.Tensor       # [1] int32: 1 if an id lies outside [0, V)
    V: int
    n_long: int             # work's length, read on the host
    n_bad: int              # bad, read on the host


def work_rows(P: int, V: int) -> int:
    """The long-run list's length for P ids over V rows: the most long
    runs there can be, plus one."""
    return min(V, P // (LONG_RUN + 1)) + 1


def sort_tensors(ids, V: int, wrap: bool = False):
    """The index preparation's kernels alone (the CUDA implementation of
    ``repro_torch::bag_sort_ids``): ids (any shape, int32/int64,
    contiguous, on the card) -> (perm, offs, work, meta [4] int32: the
    long runs' count, long_kernel's two counters, the out-of-range
    flag), nothing read back."""
    if not isinstance(ids, torch.Tensor) or not ids.is_cuda:
        raise ValueError("sort_ids runs on CUDA tensors; "
                         "ref.sort_ids_ref takes CPU ones")
    if ids.dtype not in _ID_T:
        raise TypeError(f"ids dtype {ids.dtype} not in {_ID_T}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    V, P = int(V), ids.numel()
    if not 1 <= V < 2 ** 31:
        raise ValueError(f"V={V} must be in [1, 2^31)")
    if P < 1:
        raise ValueError("sort_ids needs at least one id")
    dev = ids.device
    pos_t = torch.int32 if P < 2 ** 31 else torch.int64
    pos_bytes = 4 if pos_t == torch.int32 else 8
    temp_bytes = _build.fn(_LIB, "embedding_bag_sort_temp_bytes", _TEMP_SIG,
                           _LL)(P, V, pos_bytes)
    if temp_bytes < 0:
        _build.raise_on(-temp_bytes, _LIB)
    keys = torch.empty((2 * P,), dtype=torch.int32, device=dev)
    pos = torch.empty((P,), dtype=pos_t, device=dev)
    temp = torch.empty((max(temp_bytes, 1),), dtype=torch.uint8, device=dev)
    perm = torch.empty((P,), dtype=pos_t, device=dev)
    offs = torch.empty((V + 1,), dtype=pos_t, device=dev)
    work = torch.empty((work_rows(P, V),), dtype=torch.int32, device=dev)
    meta = torch.empty((4,), dtype=torch.int32, device=dev)  # counters, bad
    rc = _build.launch(
        _build.fn(_LIB, "embedding_bag_sort_launch", _SORT_SIG), dev,
        ids.data_ptr(), ids.element_size(), int(wrap), P, V, LONG_RUN,
        pos_bytes, keys.data_ptr(), pos.data_ptr(), perm.data_ptr(),
        temp.data_ptr(), temp_bytes, offs.data_ptr(), work.data_ptr(),
        meta.data_ptr(), meta.data_ptr() + 12)
    if rc:
        _build.raise_on(rc, _LIB)
    return perm, offs, work, meta


def order_of(perm, offs, work, meta, V: int) -> Order:
    """The ``Order`` of the sort's outputs, its counts read on the host
    (the one synchronisation of a backward call).  Fake tensors have no
    counts to read: every run that could be long is taken as long, and
    no id as out of range."""
    from repro_torch.kernels.library import has_data
    if has_data(meta):
        n_long, _, _, n_bad = meta.tolist()
    else:
        n_long, n_bad = work.shape[0] - 1, 0
    return Order(perm, offs, work, meta[:3], meta[3:], int(V), n_long, n_bad)


def sort_ids(ids, V: int, *, wrap: bool = False) -> Order:
    """The order the backward walks, for ids (any shape, int32/int64,
    contiguous, on the card) over a V-row table: their flat positions
    sorted stably by id, the row offsets and the long runs (``Order``),
    through ``repro_torch::bag_sort_ids``.  ``wrap``: a negative id
    counts from the end, as ``table[ids]`` reads it; otherwise, like any
    id outside [0, V), it sets ``bad``.  Reads the long runs' count and
    ``bad`` on the host: the one host synchronisation of a backward
    call."""
    from repro_torch.kernels.library import op
    if not isinstance(ids, torch.Tensor) or not ids.is_cuda:
        raise ValueError("sort_ids runs on CUDA tensors; "
                         "ref.sort_ids_ref takes CPU ones")
    return order_of(*op("bag_sort_ids")(ids, int(V), bool(wrap)), V)


def _check_backward(ids, weights, dout, V):
    if not dout.is_cuda:
        raise ValueError("embedding_bag_backward runs on CUDA tensors; the "
                         "plain version in repro_torch.kernels."
                         "embedding_bag.ref takes CPU ones")
    dev = dout.device
    _check_f32(dout, "dout", "[n_bags, d]")
    _check_ids(ids, weights, dev)
    n_bags, L = ids.shape
    if dout.shape[0] != n_bags:
        raise ValueError(f"dout rows {dout.shape[0]} != n_bags {n_bags}")
    if int(V) < 1:
        raise ValueError(f"V={V} must be >= 1")
    return dev, n_bags, L, dout.shape[1], int(V)


def _launch_kernels(order, weights, dout, L, d, V, dev, rows_only):
    dtable = torch.empty((V, d), dtype=torch.float32, device=dev)
    rc = _build.launch(
        _build.fn(_LIB, "embedding_bag_backward_launch", _BWD_SIG), dev,
        order.perm.data_ptr(), order.offs.data_ptr(),
        order.perm.element_size(), order.work.data_ptr(),
        order.counters.data_ptr(), LONG_RUN,
        None if weights is None else weights.data_ptr(), dout.data_ptr(),
        L, d, V, dtable.data_ptr(), order.n_long,
        LONG_BLOCKS_PER_SM * _build.sm_count(dev), int(rows_only))
    if rc:
        _build.raise_on(rc, _LIB)
    return dtable


def backward_op(ids, weights, dout, V, perm, offs, work, counters, n_long,
                mode):
    """The CUDA implementation of ``repro_torch::bag_backward``: the
    backward kernels on the order (``perm``, ``offs``, ``work``,
    ``counters``, ``n_long``: ``sort_ids``' of these ids, which the
    card's callers make first and check; ``mode`` names the plain
    version the CPU runs)."""
    dev, n_bags, L, d, V = _check_backward(ids, weights, dout, V)
    if n_bags * L == 0:                          # nothing to walk: no launch
        return torch.zeros((V, d), dtype=torch.float32, device=dev)
    if perm is None:
        raise ValueError("bag_backward on the card takes the order "
                         "sort_ids made of its ids")
    order = Order(perm, offs, work, counters, None, V, int(n_long), 0)
    dtable = _launch_kernels(order, weights, dout, L, d, V, dev, False)
    launches["embedding_bag_backward"] += 1
    return dtable


def launch_backward(ids, weights, dout, V: int, order=None, *,
                    wrap: bool = False, rows_only: bool = False):
    """The backward kernels alone: ids [n_bags, L] int32/int64, weights
    [n_bags, L] f32 or None (unit weights), dout [n_bags, d] f32, on the
    card -> (dtable [V, d] f32, bad [1] int32: 1 if an id lies outside
    [0, V), not yet read).  ``order``: ``sort_ids(ids, V, wrap=wrap)``,
    made here when None.  The kernels run through
    ``repro_torch::bag_backward``; ``rows_only``: the short-run kernel
    alone, the long runs' rows left unwritten (for timing the kernels
    apart; launched directly and not counted as a launch)."""
    dev, n_bags, L, d, V = _check_backward(ids, weights, dout, V)
    P = n_bags * L
    if P == 0:                                   # nothing to walk: no launch
        return (torch.zeros((V, d), dtype=torch.float32, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))
    if order is None:
        order = sort_ids(ids, V, wrap=wrap)
    elif order.V != V or order.perm.shape != (P,):
        raise ValueError("order must be sort_ids(ids, V)")
    if rows_only:
        return (_launch_kernels(order, weights, dout, L, d, V, dev, True),
                order.bad)
    from repro_torch.kernels.library import op
    dtable = op("bag_backward")(ids, weights, dout, V, order.perm,
                                order.offs, order.work, order.counters,
                                order.n_long, 1 if wrap else 0)
    return dtable, order.bad


def embedding_bag_backward(ids, weights, dout, V: int, *, wrap: bool = False):
    """``launch_backward``, refused before its kernels if an id lies
    outside [0, V) (after ``wrap``)."""
    order = None
    if isinstance(ids, torch.Tensor) and ids.is_cuda and ids.numel():
        order = sort_ids(ids, V, wrap=wrap)
        if order.n_bad:
            raise IndexError(f"embedding_bag backward: ids outside "
                             f"[0, {V})")
    return launch_backward(ids, weights, dout, V, order, wrap=wrap)[0]


def block_backward(ids, weights, dout, V: int):
    """The backward on a row block ``[V, d]`` of a table (a rank's rows
    on a ``"model"`` mesh): ids [n_bags, L] in [0, V], where V marks a
    foreign slot.  The sort gives such a slot the sentinel key V, after
    every row's run (``offs[V]``), so the kernels, which walk the rows
    [0, V), never add it: no row receives a foreign slot, and every row
    gets the terms and the order of ``embedding_bag_backward``.  The
    sentinel's flag is not an error here."""
    return launch_backward(ids, weights, dout, V)[0]


def gather_backward(ids, dout, V: int, order=None):
    """The gradient of ``table[ids]`` for a [V, d] table: ids (any shape;
    a negative id counts from the end), dout [*ids.shape, d] -> dtable
    [V, d], the backward kernels at L = 1 with unit weights.  ``order``:
    ``sort_ids(ids, V)`` made beforehand and checked by the caller (a
    batch's order, shared by several calls on the same ids), else made
    and checked here."""
    flat = ids.reshape(-1, 1)
    flat = flat if flat.is_contiguous() else flat.contiguous()
    d = dout.shape[-1]
    dout = dout.reshape(-1, d).contiguous()
    if order is None:
        return embedding_bag_backward(flat, None, dout, V, wrap=True)
    return launch_backward(flat, None, dout, V, order, wrap=True)[0]
