"""Plain oracle for jpq_topk: materialise [B, N], then an exact top-k.

The path the fused kernel replaces, kept as the parity reference.
Ties break to the lowest item id and +0.0 ranks above −0.0, as
``lax.top_k`` ranks them (``torch.topk`` promises no tie order, so the
ranking is a sort on the ``desc_sort_key`` int key, see ``ops``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.jpq_scores.ref import (jpq_scores_lut_ref,
                                                jpq_scores_ref)
from repro_torch.kernels.jpq_topk.ops import topk_desc


def jpq_topk_lut_ref(partial, codes, k: int):
    """partial [B, m, b] fp32, codes [N, m] -> (values, ids)
    [B, min(k, N)]."""
    scores = jpq_scores_lut_ref(partial, codes)
    N = scores.shape[1]
    ids = torch.arange(N, dtype=torch.int32, device=scores.device)
    return topk_desc(scores, ids.expand_as(scores), min(int(k), N))


def jpq_topk_ref(h, centroids, codes, k: int):
    """h [..., d], centroids [m, b, dk], codes [N, m] -> (values, ids)
    [..., min(k, N)]: ``jpq_scores_ref``'s [..., N] scores, then the
    exact top-k, ties to the smaller id (the reference's
    ``jpq_topk_ref``)."""
    scores = jpq_scores_ref(h, centroids, codes)
    N = scores.shape[-1]
    ids = torch.arange(N, dtype=torch.int32, device=scores.device)
    return topk_desc(scores, ids.expand_as(scores), min(int(k), N))
