"""Synthetic CTR/click batches for FM / DLRM / DIEN with planted signal.

A hidden per-(field, bucket) weight vector defines the ground-truth
logit; labels are Bernoulli(sigmoid(logit)), so models have real AUC to
recover.  Stateless-seeded: batch(step) is pure in (seed, step).

A numpy-only copy of the reference's ``data/clicks.py``: the same seeds
give array-equal batches in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class ClickDataConfig:
    n_dense: int = 13
    vocab_sizes: Sequence[int] = (1000,) * 26
    seed: int = 0
    noise: float = 1.0


class SyntheticClicks:
    def __init__(self, cfg: ClickDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.w_dense = rng.standard_normal(cfg.n_dense) * 0.5
        # per-field hashed bucket weights (keeps memory bounded)
        self.n_hash = 4096
        self.w_sparse = rng.standard_normal(
            (len(cfg.vocab_sizes), self.n_hash)) * 0.5
        self.bias = -0.5

    def batch(self, step: int, batch_size: int):
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 3, step))
        dense = rng.standard_normal((batch_size, cfg.n_dense)) \
            .astype(np.float32)
        sparse = np.stack([rng.integers(0, v, batch_size)
                           for v in cfg.vocab_sizes], 1)
        logit = dense @ self.w_dense + self.bias
        for f in range(sparse.shape[1]):
            logit = logit + self.w_sparse[f, sparse[:, f] % self.n_hash]
        logit += cfg.noise * rng.standard_normal(batch_size)
        label = (rng.random(batch_size) < 1 / (1 + np.exp(-logit)))
        return {"dense": dense, "sparse": sparse.astype(np.int64),
                "label": label.astype(np.int64)}


def dien_batch(seq_data, step: int, batch_size: int, seq_len: int):
    """CTR view of the sequence dataset: target = true next item (label 1)
    or random item (label 0); negatives for the auxiliary loss."""
    c = seq_data.cfg
    rng = np.random.default_rng((c.seed, 4, step))
    users = rng.integers(0, seq_data.n_users_eff, batch_size)
    hist = np.zeros((batch_size, seq_len), np.int64)
    hist_neg = rng.integers(1, c.n_items + 1, (batch_size, seq_len))
    target = np.zeros(batch_size, np.int64)
    label = rng.random(batch_size) < 0.5
    for i, u in enumerate(users):
        s = seq_data.train_seq(u)
        cut = rng.integers(1, len(s))
        hist[i] = seq_data._pad_left(s[:cut], seq_len)
        target[i] = s[cut] if label[i] else rng.integers(1, c.n_items + 1)
    return {"hist": hist, "hist_neg": hist_neg, "target": target,
            "label": label.astype(np.int64)}
