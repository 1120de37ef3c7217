"""Public wrapper for embedding_bag: the fixed-fanout EmbeddingBag, with
the reference's signature and combiner handling, differentiable with
respect to the table.

Chosen by where the table (in the backward: the gradient) lies:
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
outside any Pallas kernel.  The tables of ``core/full`` and the
centroids of ``core/jpq`` (``use_kernel=False``) train through it.

``embedding_bag_block`` and ``gather_block`` are the two on a row block
of a table (a rank's rows on a ``"model"`` mesh, ``core/sharded``):
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
from repro_torch.kernels.embedding_bag import ref as _ref


def _forward(table, ids, weights):
    impl = _cuda.embedding_bag if table.is_cuda else _ref.embedding_bag_ref
    return impl(table, ids, weights)


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
        impl = _cuda.embedding_bag_backward if dout.is_cuda \
            else _ref.embedding_bag_backward_ref
        return impl(ids, weights, dout.contiguous(), ctx.V), None, None


class TableGather(torch.autograd.Function):
    """table [V, d], ids int64 (any shape) -> table[ids]; the gradient
    flows to ``table`` alone."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.V = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
        impl = _cuda.gather_backward if dout.is_cuda \
            else _ref.gather_backward_ref
        return impl(ids, dout, ctx.V), None


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
        impl = _cuda.block_backward if dout.is_cuda \
            else _ref.block_backward_ref
        return impl(marked, weights, dout.contiguous(), ctx.V), None, None, \
            None


class BlockGather(torch.autograd.Function):
    """``table[ids]`` of a row block, zero at the foreign slots: table
    [V, d], ids (0 at foreign slots), own (bool, ids' shape), marked
    (V at foreign slots) -> [*ids.shape, d]."""

    @staticmethod
    def forward(ctx, table, ids, own, marked):
        ctx.save_for_backward(marked)
        ctx.V = table.shape[0]
        return table[ids].masked_fill_(~own[..., None], 0.0)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (marked,) = ctx.saved_tensors
        d = dout.shape[-1]
        impl = _cuda.block_backward if dout.is_cuda \
            else _ref.block_backward_ref
        return impl(marked.reshape(-1, 1), None,
                    dout.reshape(-1, d).contiguous(), ctx.V), None, None, None


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


def gather(table, ids):
    """``table[ids]`` for a [V, d] table and integer ids of any shape;
    where the table takes a gradient, through ``TableGather``."""
    ids = ids.long()
    if table.requires_grad and torch.is_grad_enabled():
        if table.dim() != 2:
            raise ValueError(f"gather takes a [V, d] table, got "
                             f"{tuple(table.shape)}")
        return TableGather.apply(table, ids)
    return table[ids]


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
