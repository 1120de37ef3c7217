"""Centroid (sub-id) assignment for RecJPQ codebooks, and the popularity
sweep order for pruned serving.  All host-side numpy, as in the
reference: the same seed gives array-equal codes in both packages.

Strategies (paper §4.1):
  random : m uniform ints in [0, b) per item.
  svd    : m-component randomized truncated SVD (Halko et al. 2011) of
           the binary user×item matrix, matrix-free over the (user, item)
           pairs; per-component min–max normalise, N(0, 1e-5)
           tie-breaking noise, b equal-mass quantile bins.
  bpr    : m-dim BPR-MF (Rendle et al. 2009) with uniform negatives;
           the same normalise/noise/quantile pipeline.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _dedupe(users: np.ndarray, items: np.ndarray, n_items: int):
    key = users.astype(np.int64) * n_items + items.astype(np.int64)
    key = np.unique(key)
    return (key // n_items).astype(np.int64), (key % n_items).astype(np.int64)


def _discretise(emb: np.ndarray, b: int, rng: np.random.Generator):
    """Paper's normalise + noise + per-column quantile binning."""
    lo, hi = emb.min(0, keepdims=True), emb.max(0, keepdims=True)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    norm = (emb - lo) / span + rng.normal(0.0, 1e-5, emb.shape)
    codes = np.empty(emb.shape, np.int32)
    for j in range(emb.shape[1]):
        qs = np.quantile(norm[:, j], np.linspace(0, 1, b + 1)[1:-1])
        codes[:, j] = np.searchsorted(qs, norm[:, j], side="right")
    return np.clip(codes, 0, b - 1)


# -------------------------------------------------- matrix-free rand-SVD

def _matmul_A(users, items, n_users, X):        # A @ X,  A = M [U, I]
    out = np.zeros((n_users, X.shape[1]), X.dtype)
    np.add.at(out, users, X[items])
    return out


def _matmul_At(users, items, n_items, Y):       # A.T @ Y
    out = np.zeros((n_items, Y.shape[1]), Y.dtype)
    np.add.at(out, items, Y[users])
    return out


def svd_item_embeddings(users, items, n_users: int, n_items: int, m: int,
                        *, oversample: int = 8, n_iter: int = 2,
                        seed=0) -> np.ndarray:
    """Right singular vectors (item embeddings) of the binary matrix,
    via Halko randomized SVD with power iterations. Matrix-free.
    ``seed`` is anything ``np.random.default_rng`` accepts (an int, or
    a ``SeedSequence`` child when called via ``build_codebook``)."""
    rng = np.random.default_rng(seed)
    users, items = _dedupe(np.asarray(users), np.asarray(items), n_items)
    k = min(m + oversample, min(n_users, n_items))
    omega = rng.standard_normal((n_items, k)).astype(np.float64)
    Y = _matmul_A(users, items, n_users, omega)              # [U, k]
    for _ in range(n_iter):
        Y, _ = np.linalg.qr(Y)
        Z = _matmul_At(users, items, n_items, Y)             # [I, k]
        Z, _ = np.linalg.qr(Z)
        Y = _matmul_A(users, items, n_users, Z)
    Q, _ = np.linalg.qr(Y)                                   # [U, k]
    B = _matmul_At(users, items, n_items, Q).T               # [k, I]
    _, _, vt = np.linalg.svd(B, full_matrices=False)
    V = vt[:m].T                                             # [I, m]
    if V.shape[1] < m:                                       # degenerate
        pad = rng.standard_normal((n_items, m - V.shape[1])) * 1e-3
        V = np.concatenate([V, pad], 1)
    return V.astype(np.float64)


# ------------------------------------------------------------- BPR-MF

def bpr_item_embeddings(users, items, n_users: int, n_items: int, m: int,
                        *, epochs: int = 5, lr: float = 0.05,
                        reg: float = 1e-4, batch: int = 8192,
                        seed=0) -> np.ndarray:
    """Tiny host-side BPR trainer (SGD, uniform negatives).  ``seed``
    is anything ``np.random.default_rng`` accepts."""
    rng = np.random.default_rng(seed)
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    U = 0.1 * rng.standard_normal((n_users, m))
    V = 0.1 * rng.standard_normal((n_items, m))
    n = len(users)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for s in range(0, n, batch):
            sel = perm[s: s + batch]
            u, ip = users[sel], items[sel]
            ineg = rng.integers(0, n_items, len(sel))
            uu, vp, vn = U[u], V[ip], V[ineg]
            x = np.sum(uu * (vp - vn), 1)
            g = 1.0 / (1.0 + np.exp(x))                      # dL/dx * -1
            gu = g[:, None] * (vp - vn) - reg * uu
            gp = g[:, None] * uu - reg * vp
            gn = -g[:, None] * uu - reg * vn
            np.add.at(U, u, lr * gu)
            np.add.at(V, ip, lr * gp)
            np.add.at(V, ineg, lr * gn)
    return V


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


# ------------------------------------------------------------- factory

def shard_sweep_ids(perm: np.ndarray, shards: int) -> np.ndarray:
    """Permute-then-shard id layout: the global popularity permutation
    is applied to the catalogue rows first and only then split into
    ``shards`` contiguous blocks, so shard s sweeps ``perm[s*L:(s+1)*L]``
    (L = n_items / shards), its own rows in popularity order.  Returns
    ``[shards, L]``: row s is shard s's id-map, the rows a global
    ``prepare_pruning(codes, b, bn, perm=perm)`` state's ``ids`` give
    each shard under ``core.sharded.fused_topk_over_codes``."""
    perm = np.asarray(perm)
    n = perm.shape[0]
    if n % shards != 0:
        raise ValueError(f"{n} rows do not split over {shards} shards")
    return perm.reshape(shards, n // shards)


def build_codebook(strategy: str, n_items: int, m: int, b: int = 256, *,
                   interactions: Optional[Tuple[np.ndarray,
                                                np.ndarray]] = None,
                   n_users: Optional[int] = None, seed: int = 0,
                   **kw) -> np.ndarray:
    """int32 codes [n_items, m] in [0, b). ``interactions=(users, items)``
    is required for svd/bpr.

    RNG discipline: ``seed`` is expanded through
    ``np.random.SeedSequence(seed).spawn`` into independent per-stage
    child streams — one for the embedding stage (random draw / SVD's
    ``omega`` / BPR's init+negatives), one for ``_discretise``'s
    tie-breaking noise.  Previously all stages were seeded with the
    same integer, so the discretise noise replayed the embedding
    stage's bitstream.
    """
    embed_ss, disc_ss = np.random.SeedSequence(seed).spawn(2)
    if strategy == "random":
        return np.random.default_rng(embed_ss).integers(
            0, b, (n_items, m), dtype=np.int32)
    if interactions is None or n_users is None:
        raise ValueError(f"strategy {strategy!r} needs interactions+n_users")
    users, items = interactions
    if strategy == "svd":
        emb = svd_item_embeddings(users, items, n_users, n_items, m,
                                  seed=embed_ss, **kw)
    elif strategy == "bpr":
        emb = bpr_item_embeddings(users, items, n_users, n_items, m,
                                  seed=embed_ss, **kw)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return _discretise(emb, b, np.random.default_rng(disc_ss))
