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
