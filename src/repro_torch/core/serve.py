"""Serve-path entrypoint: top-k catalogue retrieval for any embedding
kind, fused for JPQ, and the warm-floor EMA the pruned path uses.
"""
from __future__ import annotations

import numpy as np


class ThresholdState:
    """Host-side EMA of the final pruning threshold θ across requests.

    A replica keeps one per (model, k) and passes ``floor(B)`` as the
    request's ``warm=`` floor, so the sweep prunes from its first tile.
    The floor never enters the running list; a floor that overshoots a
    query's true k-th value demotes that query and re-sweeps it, so the
    result is exact for any state.  ``update`` folds the MINIMUM of the
    request's finite final k-th values into the EMA (undershooting
    loses a little pruning, overshooting costs a re-sweep); NaN / ±inf
    entries are dropped.  ``reset`` returns to the cold state;
    ``merge`` min-reduces several replicas' states."""

    def __init__(self, decay: float = 0.9):
        if not 0.0 <= decay < 1.0:
            raise ValueError(
                f"decay must be in [0, 1): {decay} (1.0 would freeze "
                f"the EMA at its first value forever)")
        self.decay = float(decay)
        self.theta: float | None = None

    def floor(self, batch_size: int) -> np.ndarray:
        """[batch_size] f32 warm floor (-inf until the first update)."""
        fill = -np.inf if self.theta is None else self.theta
        return np.full((batch_size,), fill, np.float32)

    def update(self, thetas) -> None:
        t = np.asarray(thetas, np.float64).reshape(-1)
        t = t[np.isfinite(t)]
        if t.size == 0:
            return
        t = float(t.min())
        self.theta = t if self.theta is None else \
            self.decay * self.theta + (1.0 - self.decay) * t

    def reset(self) -> None:
        """Back to the cold state (floor −inf; decay kept)."""
        self.theta = None

    @classmethod
    def merge(cls, states, adopt: bool = True):
        """The MIN of the replicas' EMAs (cold replicas skipped); with
        ``adopt`` every state takes it.  Returns the merged theta, or
        None when every replica is cold."""
        thetas = [s.theta for s in states if s.theta is not None]
        merged = min(thetas) if thetas else None
        if adopt and merged is not None:
            for s in states:
                s.theta = merged
        return merged


def retrieve_topk(emb, p, h, *, k: int, fused: bool = True,
                  block_n: int | None = None, backend=None, prune=None,
                  perm=None, warm=None,
                  return_stats: bool = False):
    """emb: core.api.Embedding, p: its params, h [..., d] -> (values,
    ids) [..., min(k, n_items)] (+ the pruning-stats dict when
    ``return_stats``).  The kwargs become a ``RetrievalSpec`` served by
    a one-shot ``RetrievalEngine``; a per-request ``warm`` floor records
    the warm policy as decay 0.0 (externally managed floor).
    ``backend`` must be None: the tensors' device picks the route
    (``engine.spec_for``)."""
    from repro_torch.core import engine as _engine
    spec = _engine.spec_for(emb, k=k, fused=fused, block_n=block_n,
                            backend=backend, prune=prune, perm=perm,
                            warm_decay=0.0 if warm is not None else None,
                            stats=return_stats)
    eng = _engine.RetrievalEngine(spec, emb, p)
    if spec.prune:
        eng.bind_catalogue(prune=prune, perm=perm)
    return eng.retrieve(h, floor=warm)
