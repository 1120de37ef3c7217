"""Public wrapper for embedding_bag: the fixed-fanout EmbeddingBag, with
the reference's signature and combiner handling.

Chosen by where the table lies:
  a CUDA tensor - the hand-written Hopper kernel (``csrc/embedding_bag.cu``)
  a CPU tensor  - its plain PyTorch version (``ref``)
There is no fallback to the plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import cuda as _cuda
from repro_torch.kernels.embedding_bag import ref as _ref


def embedding_bag(table, ids, weights=None, *, combiner: str = "sum"):
    """table [V, d]; ids [n_bags, L] (pad slots -> any row, weight 0);
    weights [n_bags, L] or None (ones) -> [n_bags, d] f32.  ``"mean"``
    divides the weights by max(their sum, 1e-9) first."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got "
                         f"{combiner!r}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be [n_bags, L], got {tuple(ids.shape)}")
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
    impl = _cuda.embedding_bag if table.is_cuda else _ref.embedding_bag_ref
    return impl(table, ids, weights)
