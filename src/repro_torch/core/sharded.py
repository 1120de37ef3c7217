"""Catalogue-wide top-k and pooled lookups, single device.

The reference's row-sharded (shard_map) branches of these functions are
a later slice of the port: passing a device ``mesh`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops as _bag
from repro_torch.kernels.jpq_topk import ops as _tops

_TOPK_BLOCK = 131072


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("multi-GPU serving is a later slice of "
                                  "the port: pass mesh=None")


def pooled_lookup(table, ids, weights, *, mesh=None):
    """table [V, d], ids [B, H] int, weights [B, H] float -> pooled
    [B, d] = sum_h w * table[ids], through the embedding_bag kernel (its
    plain version on a CPU tensor)."""
    _no_mesh(mesh)
    return _bag.embedding_bag(table, ids, weights)


def topk_over_items(scores, k: int, *, mesh=None):
    """scores [B, N] -> (values, ids) [B, min(k, N)], ties to the
    smallest id: column-block-local top-k, then one exact merge."""
    _no_mesh(mesh)
    B, N = scores.shape
    k = min(int(k), N)
    vs, is_ = [], []
    for n0 in range(0, N, _TOPK_BLOCK):
        n1 = min(N, n0 + _TOPK_BLOCK)
        ids = torch.arange(n0, n1, dtype=torch.int32, device=scores.device)
        v, i = _tops.topk_desc(scores[:, n0:n1], ids.expand(B, -1),
                               min(k, n1 - n0))
        vs.append(v)
        is_.append(i)
    return _tops.topk_desc(torch.cat(vs, 1), torch.cat(is_, 1), k)


def fused_topk_over_codes(partial, codes, k: int, *,
                          block_n: int | None = None, prune=None, perm=None,
                          warm=None, return_stats: bool = False, mesh=None):
    """PQTopK serving: fused score + top-k over the codes.  partial
    [B, m, b] fp32 LUT, codes [N, m] -> (values, ids) [B, min(k, N)]
    (+ the pruning stats dict when ``return_stats``)."""
    _no_mesh(mesh)
    if not prune and (warm is not None or return_stats):
        raise ValueError(
            "warm floors / stats are pruned-path features: the warm "
            "floor seeds the pruning threshold and the stats dict "
            "counts skipped tiles, neither of which exists on the "
            "unpruned sweep — pass prune=True (or a prepare_pruning(...) "
            "state), or drop warm=/return_stats=")
    return _tops.jpq_topk_lut(partial, codes, k, block_n=block_n,
                              prune=prune, perm=perm, warm=warm,
                              return_stats=return_stats)
