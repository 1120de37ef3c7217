"""Public wrappers for jpq_lookup: RecJPQ item vectors rebuilt from the
codes, differentiable in the centroids.

The operators ``repro_torch::jpq_lookup`` / ``jpq_lookup_bwd``
(``kernels/library``) choose by where the centroids lie:
  a CUDA tensor - the hand-written Hopper kernels (``csrc/jpq_lookup.cu``),
                  forward and a deterministic backward
  a CPU tensor  - their plain PyTorch versions (``ref``)
There is no fallback to the plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.library import op


def jpq_lookup_rows(ids, codes, centroids):
    """ids [T], codes [N, m], centroids [m, b, dk] -> [T, m, dk]
    (``repro_torch::jpq_lookup``)."""
    return op("jpq_lookup")(ids, codes, centroids)


def jpq_lookup_rows_bwd(ids, codes, dout, b: int):
    """ids [T], codes [N, m], dout [T, m, dk] -> dcent [m, b, dk]
    (``repro_torch::jpq_lookup_bwd``)."""
    return op("jpq_lookup_bwd")(ids, codes, dout, int(b))


class JPQLookup(torch.autograd.Function):
    """out = jpq_lookup_rows(ids, codes, centroids), with dcent from the
    backward kernel (ids and codes are ints: no gradient)."""

    @staticmethod
    def forward(ctx, ids, codes, centroids):
        ctx.save_for_backward(ids, codes)
        ctx.b = centroids.shape[1]
        return jpq_lookup_rows(ids, codes, centroids)

    @staticmethod
    def backward(ctx, dout):
        ids, codes = ctx.saved_tensors
        return None, None, jpq_lookup_rows_bwd(ids, codes, dout, ctx.b)


def jpq_lookup(ids, codes, centroids):
    """ids int[...], codes [N, m], centroids [m, b, dk] -> [..., m*dk]."""
    flat = ids.reshape(-1)
    if flat.dtype not in (torch.int32, torch.int64):
        flat = flat.long()
    out = JPQLookup.apply(flat, codes, centroids)
    return out.reshape(*ids.shape, -1)
