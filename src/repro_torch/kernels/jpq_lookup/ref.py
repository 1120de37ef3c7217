"""Plain oracles for jpq_lookup: the two-level gather ids -> codes ->
centroids, forward and backward, in any float dtype.

The forward is bit-equal to the reference's ``jpq_lookup_ref`` and
``core.jpq.lookup``.  The backward scatters each position's split
slices into the centroid rows its codes name with ``index_add_``, which
on the CPU adds them in ascending position order onto +0.0: the order
the CUDA kernel keeps, so the two are bit-equal
(tests/test_torch_jpq_lookup.py pins the order).
"""
from __future__ import annotations

import torch


def jpq_lookup_ref(ids, codes, centroids):
    """ids [T], codes [N, m], centroids [m, b, dk] -> [T, m, dk]."""
    m = centroids.shape[0]
    rows = codes[ids.long()].long()                        # [T, m]
    return centroids[torch.arange(m, device=centroids.device), rows]


def jpq_lookup_bwd_ref(ids, codes, dout, b: int):
    """ids [T], codes [N, m], dout [T, m, dk] -> dcent [m, b, dk] with
    ``dcent[j, c] = sum_{i : codes[ids[i], j] = c} dout[i, j]``."""
    T, m, dk = dout.shape
    rows = codes[ids.long()].long()                        # [T, m]
    flat = (rows + b * torch.arange(m, device=rows.device)).reshape(-1)
    dcent = torch.zeros((m * b, dk), dtype=dout.dtype, device=dout.device)
    dcent.index_add_(0, flat, dout.reshape(T * m, dk))
    return dcent.reshape(m, b, dk)
