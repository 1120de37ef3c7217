"""Host-side assignment artefacts: the popularity sweep order.

The codebook builders (random / SVD / BPR) come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def popularity_permutation(counts=None, *, interactions=None,
                           n_items: Optional[int] = None) -> np.ndarray:
    """Sweep permutation for score-bound pruned serving: item ids sorted
    by descending popularity, ties by ascending id.  Pass per-item
    ``counts [n_items]``, or ``interactions=(users, item_rows)`` plus
    ``n_items`` to tally them.  Returns int64 ``perm [n_items]``: the
    original item id of each sweep slot."""
    if counts is None:
        if interactions is None or n_items is None:
            raise ValueError("need counts, or interactions + n_items")
        counts = np.zeros(int(n_items), np.int64)
        np.add.at(counts, np.asarray(interactions[1], np.int64), 1)
    counts = np.asarray(counts)
    # a garbage tally serves (pruning stays exact for any order, it just
    # stops skipping), so reject it loudly instead
    if counts.ndim != 1:
        raise ValueError(
            f"counts must be a 1-D per-item tally [n_items], got shape "
            f"{counts.shape}")
    if n_items is not None and counts.shape[0] != int(n_items):
        raise ValueError(
            f"counts has {counts.shape[0]} entries but n_items="
            f"{int(n_items)} — pass one count per catalogue row")
    if np.issubdtype(counts.dtype, np.floating) \
            and np.isnan(counts).any():
        raise ValueError(
            "counts contains NaN — NaN poisons the sort comparator and "
            "yields an arbitrary sweep order; clean the tally first")
    if counts.size and counts.min() < 0:
        raise ValueError(
            f"counts contains negative values (min {counts.min()}) — "
            f"popularity tallies are non-negative; clean the tally "
            f"first")
    # stable sort on -counts: equal-count items stay in ascending id
    return np.argsort(-counts, kind="stable")
