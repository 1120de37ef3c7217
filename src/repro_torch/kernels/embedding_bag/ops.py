"""Public wrapper for embedding_bag: the fixed-fanout EmbeddingBag, with
the reference's signature and combiner handling, differentiable with
respect to the table.

The operators ``repro_torch::embedding_bag``, ``bag_sort_ids`` and
``bag_backward`` (``kernels/library``) choose by where the table (in the
backward: the gradient) lies:
  a CUDA tensor - the hand-written Hopper kernels (``csrc/embedding_bag.cu``)
  a CPU tensor  - their plain PyTorch versions (``ref``)
There is no fallback to the plain version on the card.

The gradient reaches the table through ``EmbeddingBag``, a
``torch.autograd.Function`` whose backward is the embedding_bag backward
kernel (deterministic: no float atomics); it is used only where the
table requires a gradient, so serving runs the forward alone.  Ids get
no gradient, and neither do the weights: every caller passes a mask or
None, and weights that require a gradient are refused.  The ``mean``
combiner's normalisation stays outside the Function.

``gather`` is a plain table gather ``table[ids]`` whose gradient comes
from the same backward kernel (``TableGather``: L = 1, unit weights, a
negative id counting from the end as indexing reads it).  Its forward
is PyTorch's indexing, the same bits; the reference computes the gather
outside any Pallas kernel.  The tables of ``core/full``, the centroids
of ``core/jpq`` (``use_kernel=False``), the MoE's dispatch and combine
(``nn/moe.py``) and MACE's edge gathers (``models/mace.py``) train
through it.

``segment_sum`` is ``jax.ops.segment_sum`` for ids in range: the same
backward kernels at L = 1 with unit weights compute it forward (its
backward is the gather ``dout[ids]``), MACE's sums over receivers and
over graphs.  ``segment_order`` makes the kernels' index preparation
once for a batch's ids, for every ``segment_sum`` and ``gather`` on
them, so the sort and its host synchronisation run once a batch and not
once a call.

``embedding_bag_block`` and ``gather_block`` are the two on a row block
of a table (a rank's rows on a ``"model"`` mesh, ``core/sharded``; a
rank's experts' slots in the MoE's combine, ``nn/moe.py``):
each slot names a row of the block or, where ``own`` is False, another
rank's row (a foreign slot).  A foreign slot adds nothing forward (its
id is 0 and its weight 0; ``gather_block`` zeroes its row) and reaches
no row backward: it carries the id V there, which the backward kernels
skip (``cuda.block_backward``; plain: ``ref.block_backward_ref``), so
the block's gradient is the same rows of the whole table's gradient,
bit for bit, and no run of a real row grows with the foreign slots.  An
own slot's id outside [0, V) raises, as everywhere.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import cuda as _cuda
from repro_torch.kernels.library import op


def _forward(table, ids, weights):
    if table.is_cuda:
        return _cuda.embedding_bag(table, ids, weights)
    return op("embedding_bag")(table, ids, weights)[0]


def _plain_backward(ids, weights, dout, V, mode):
    """``repro_torch::bag_backward`` with no order: on the CPU the plain
    version of mode 0 (the bag), 1 (a gather) or 2 (a row block)."""
    return op("bag_backward")(ids, weights, dout, int(V), None, None, None,
                              None, 0, mode)


class EmbeddingBag(torch.autograd.Function):
    """table [V, d], ids [n_bags, L], weights [n_bags, L] or None ->
    [n_bags, d]; the gradient flows to ``table`` alone."""

    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(ids, weights)
        ctx.V = table.shape[0]
        return _forward(table, ids, weights)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        ids, weights = ctx.saved_tensors
        if dout.is_cuda:
            grad = _cuda.embedding_bag_backward(ids, weights,
                                                dout.contiguous(), ctx.V)
        else:
            grad = _plain_backward(ids, weights, dout, ctx.V, 0)
        return grad, None, None


class TableGather(torch.autograd.Function):
    """table [V, d], ids int64 (any shape), order (``segment_order`` of
    the ids, or None) -> table[ids]; the gradient flows to ``table``
    alone.  A table in another float dtype than fp32 (a bf16 activation
    gathered by the MoE dispatch) has its gradient summed in fp32 and
    rounded once to the table's dtype."""

    @staticmethod
    def forward(ctx, table, ids, order):
        ctx.save_for_backward(ids)
        ctx.V = table.shape[0]
        ctx.dtype = table.dtype
        ctx.order = order
        return table[ids]

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        if dout.is_cuda:
            grad = _cuda.gather_backward(ids, dout.float(), ctx.V, ctx.order)
        else:
            grad = _plain_backward(ids, None, dout.float(), ctx.V, 1)
        return grad.to(ctx.dtype), None, None


def _segment_sum(data, ids, n, order):
    """data [E, d] f32, ids [E] -> [n, d]: the backward kernels at L = 1
    with unit weights on the card (``order`` made here when None), the
    plain ``index_add_`` in ascending position on the CPU."""
    ids = ids.reshape(-1, 1)
    if not data.is_cuda:
        return _plain_backward(ids, None, data, n, 0)
    ids = ids if ids.is_contiguous() else ids.contiguous()
    if order is None:
        return _cuda.embedding_bag_backward(ids, None, data, n)
    return _cuda.launch_backward(ids, None, data, n, order)[0]


class SegmentSum(torch.autograd.Function):
    """data [E, d], ids [E], n, order -> [n, d] with ``out[v] = sum_{e:
    ids[e] = v} data[e]``; the gradient flows to ``data`` alone, as
    ``dout[ids]``."""

    @staticmethod
    def forward(ctx, data, ids, n, order):
        ctx.save_for_backward(ids)
        return _segment_sum(data, ids, n, order)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (ids,) = ctx.saved_tensors
        return dout[ids.long()], None, None, None


class BlockBag(torch.autograd.Function):
    """``embedding_bag`` of a row block: table [V, d], ids [n_bags, L]
    (0 at foreign slots), weights [n_bags, L] (0 at foreign slots),
    marked [n_bags, L] (V at foreign slots) -> [n_bags, d]."""

    @staticmethod
    def forward(ctx, table, ids, weights, marked):
        ctx.save_for_backward(marked, weights)
        ctx.V = table.shape[0]
        return _forward(table, ids, weights)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        marked, weights = ctx.saved_tensors
        if dout.is_cuda:
            grad = _cuda.block_backward(marked, weights, dout.contiguous(),
                                        ctx.V)
        else:
            grad = _plain_backward(marked, weights, dout, ctx.V, 2)
        return grad, None, None, None


class BlockGather(torch.autograd.Function):
    """``table[ids]`` of a row block, zero at the foreign slots: table
    [V, d], ids (0 at foreign slots), own (bool, ids' shape), marked
    (V at foreign slots) -> [*ids.shape, d].  A table in another float
    dtype than fp32 (the MoE's bf16 expert outputs) has its gradient
    summed in fp32 and rounded once to the table's dtype, as
    ``TableGather``'s."""

    @staticmethod
    def forward(ctx, table, ids, own, marked):
        ctx.save_for_backward(marked)
        ctx.V = table.shape[0]
        ctx.dtype = table.dtype
        return table[ids].masked_fill_(~own[..., None], 0.0)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (marked,) = ctx.saved_tensors
        d = dout.shape[-1]
        flat = dout.reshape(-1, d).float().contiguous()
        if dout.is_cuda:
            grad = _cuda.block_backward(marked.reshape(-1, 1), None, flat,
                                        ctx.V)
        else:
            grad = _plain_backward(marked.reshape(-1, 1), None, flat, ctx.V,
                                   2)
        return grad.to(ctx.dtype), None, None, None


def _block_ids(ids, own, V):
    """(ids with 0 at the foreign slots, ids with V there), contiguous."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.long()
    return (torch.where(own, ids, 0).contiguous(),
            torch.where(own, ids, V).contiguous())


def embedding_bag_block(table, ids, own, weights=None):
    """``embedding_bag`` (sum combiner) over a row block [V, d] of a
    table: ids [n_bags, L] relative to the block where ``own`` [n_bags,
    L] is True; the other slots are foreign (see the module docstring).
    weights [n_bags, L] or None (ones) -> [n_bags, d] f32."""
    if ids.dim() != 2 or own.shape != ids.shape:
        raise ValueError(f"ids and own must be [n_bags, L], got "
                         f"{tuple(ids.shape)} and {tuple(own.shape)}")
    if weights is not None and weights.requires_grad:
        raise ValueError("embedding_bag_block takes no gradient for its "
                         "weights: detach them")
    V = table.shape[0]
    safe, marked = _block_ids(ids, own, V)
    w = own.to(torch.float32) if weights is None else \
        torch.where(own, weights.float(), 0.0)
    w = w.contiguous()
    if table.requires_grad and torch.is_grad_enabled():
        return BlockBag.apply(table, safe, w, marked)
    return _forward(table, safe, w)


def gather_block(table, ids, own):
    """``table[ids]`` over a row block [V, ...] of a table, +0.0 at the
    foreign slots (``own`` False): ids of any shape, relative to the
    block where ``own``.  A float [V, d] table that takes a gradient
    gets it through ``BlockGather``; any other (the codes) is indexed."""
    V = table.shape[0]
    if own.shape != ids.shape:
        raise ValueError(f"own {tuple(own.shape)} != ids "
                         f"{tuple(ids.shape)}")
    safe, marked = _block_ids(ids, own, V)
    if table.requires_grad and torch.is_grad_enabled():
        if table.dim() != 2:
            raise ValueError(f"gather_block takes a [V, d] table, got "
                             f"{tuple(table.shape)}")
        return BlockGather.apply(table, safe, own, marked)
    keep = own.reshape(*own.shape, *([1] * (table.dim() - 1)))
    return torch.where(keep, table[safe], torch.zeros((), dtype=table.dtype,
                                                      device=table.device))


def gather(table, ids, order=None):
    """``table[ids]`` for a [V, d] table and integer ids of any shape;
    where the table takes a gradient, through ``TableGather``.
    ``order``: ``segment_order(ids, V)``, shared by every call on these
    ids (else the backward sorts them itself)."""
    ids = ids.long()
    if table.requires_grad and torch.is_grad_enabled():
        if table.dim() != 2:
            raise ValueError(f"gather takes a [V, d] table, got "
                             f"{tuple(table.shape)}")
        return TableGather.apply(table, ids, order)
    return table[ids]


def segment_order(ids, n: int):
    """The order the backward kernels walk for ids [E] over n rows, made
    once for a batch and handed to every ``segment_sum`` and ``gather``
    on the same ids: ``cuda.sort_ids`` on the card (one host
    synchronisation; an id outside [0, n) raises), None on the CPU,
    where the plain versions need none."""
    if not ids.is_cuda:
        return None
    order = _cuda.sort_ids(ids if ids.is_contiguous() else ids.contiguous(),
                           n)
    if order.n_bad:
        raise IndexError(f"segment ids outside [0, {n})")
    return order


def segment_sum(data, ids, n: int, order=None):
    """``jax.ops.segment_sum(data, ids, n)`` for ids in [0, n): data [E,
    ...] -> [n, ...], each row +0.0 plus its terms in ascending position
    (deterministic: no float atomics).  On the card the embedding_bag
    backward kernels at L = 1 with unit weights, on the CPU their plain
    version; differentiable in ``data`` (``SegmentSum``, whose backward
    is the gather ``dout[ids]``).  ``order``: ``segment_order(ids, n)``
    (else sorted here, one host synchronisation a call)."""
    E = data.shape[0]
    if ids.shape != (E,):
        raise ValueError(f"ids {tuple(ids.shape)} != ({E},)")
    if order is not None and (order.V != n or order.perm.shape != (E,)):
        raise ValueError("order must be segment_order(ids, n)")
    flat = data.reshape(E, -1)
    flat = flat if flat.is_contiguous() else flat.contiguous()
    if data.requires_grad and torch.is_grad_enabled():
        out = SegmentSum.apply(flat, ids, n, order)
    else:
        out = _segment_sum(flat, ids, n, order)
    return out.reshape((n,) + tuple(data.shape[1:]))


def embedding_bag(table, ids, weights=None, *, combiner: str = "sum"):
    """table [V, d]; ids [n_bags, L] (pad slots -> any row, weight 0);
    weights [n_bags, L] or None (ones) -> [n_bags, d] f32.  ``"mean"``
    divides the weights by max(their sum, 1e-9) first."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got "
                         f"{combiner!r}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be [n_bags, L], got {tuple(ids.shape)}")
    if weights is not None and weights.requires_grad:
        raise ValueError("embedding_bag takes no gradient for its weights "
                         "(every caller passes a mask or None): detach them")
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.long()
    if ids.numel() == 0:
        return torch.zeros((ids.shape[0], table.shape[1]),
                           dtype=torch.float32, device=table.device)
    if combiner == "mean":
        if weights is None:
            weights = torch.ones(ids.shape, dtype=torch.float32,
                                 device=table.device)
        weights = weights.float()
        weights = weights / torch.clamp(weights.sum(1, keepdim=True),
                                        min=1e-9)
    if weights is not None and (weights.dtype != torch.float32
                                or not weights.is_contiguous()):
        weights = weights.float().contiguous()
    if not ids.is_contiguous():
        ids = ids.contiguous()
    if table.requires_grad and torch.is_grad_enabled():
        return EmbeddingBag.apply(table, ids, weights)
    return _forward(table, ids, weights)
