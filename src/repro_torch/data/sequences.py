"""Synthetic sequential-recommendation dataset with latent structure.

Mimics the paper's dataset regime knobs:
  * Zipf item popularity with a controllable long-tail share
    (ML-1M-like: no long tail; Gowalla-like: ~75% long-tail items);
  * latent item clusters + per-user cluster random walk, so that
    (a) next-item prediction is learnable by sequence models and
    (b) SVD/BPR centroid assignment finds real item-item structure.

Everything is stateless-seeded: batch(step) is a pure function of
(seed, step), which makes checkpoint-restart exactly reproducible.

Items are 1-based (0 = padding) throughout, matching the models.

A numpy-only copy of the reference's ``data/sequences.py``: the same
seed gives array-equal sequences and batches in both packages, so
parity runs feed both the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SeqDataConfig:
    n_users: int = 2000
    n_items: int = 1000
    n_clusters: int = 20
    zipf_a: float = 1.2
    stay_prob: float = 0.85
    min_len: int = 6
    max_len: int = 40
    seq_len: int = 32            # model context window (left-pad)
    seed: int = 0


class SyntheticSequences:
    def __init__(self, cfg: SeqDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        c = cfg
        # item -> cluster, item popularity (zipf within cluster)
        self.item_cluster = rng.integers(0, c.n_clusters, c.n_items)
        pop = 1.0 / np.arange(1, c.n_items + 1) ** c.zipf_a
        self.pop = pop[rng.permutation(c.n_items)]
        self.cluster_items = [np.where(self.item_cluster == k)[0]
                              for k in range(c.n_clusters)]
        self.cluster_probs = []
        for k in range(c.n_clusters):
            pi = self.pop[self.cluster_items[k]]
            self.cluster_probs.append(pi / pi.sum())
        # generate user sequences (ids 1-based)
        seqs = []
        for _ in range(c.n_users):
            ln = rng.integers(c.min_len, c.max_len + 1)
            cl = rng.integers(0, c.n_clusters)
            s = []
            for _ in range(ln):
                if rng.random() > c.stay_prob:
                    cl = rng.integers(0, c.n_clusters)
                if len(self.cluster_items[cl]) == 0:
                    cl = rng.integers(0, c.n_clusters)
                    continue
                item = rng.choice(self.cluster_items[cl],
                                  p=self.cluster_probs[cl])
                s.append(int(item) + 1)
            if len(s) >= 3:
                seqs.append(np.asarray(s, np.int64))
        self.seqs = seqs
        self.n_users_eff = len(seqs)

    # --------------------------------------------------------- splits
    def train_seq(self, u: int) -> np.ndarray:
        return self.seqs[u][:-2]

    def val_target(self, u: int) -> int:
        return int(self.seqs[u][-2])

    def test_target(self, u: int) -> int:
        return int(self.seqs[u][-1])

    def train_interactions(self):
        """(users, item_rows 0-based) for codebook building (train only)."""
        us, its = [], []
        for u in range(self.n_users_eff):
            s = self.train_seq(u)
            us.extend([u] * len(s))
            its.extend((s - 1).tolist())
        return np.asarray(us, np.int64), np.asarray(its, np.int64)

    def long_tail_share(self, thresh: int = 5) -> float:
        cnt = np.zeros(self.cfg.n_items, np.int64)
        for u in range(self.n_users_eff):
            np.add.at(cnt, self.train_seq(u) - 1, 1)
        return float(np.mean(cnt < thresh))

    # -------------------------------------------------------- batching
    def _pad_left(self, s: np.ndarray, L: int) -> np.ndarray:
        s = s[-L:]
        out = np.zeros(L, np.int64)
        out[L - len(s):] = s
        return out

    def train_batch(self, step: int, batch_size: int, *,
                    n_negatives: int = 0):
        """Causal shifted-sequence batch: seq[t] predicts labels[t]."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, 1, step))
        users = rng.integers(0, self.n_users_eff, batch_size)
        L = c.seq_len
        seq = np.zeros((batch_size, L), np.int64)
        labels = np.zeros((batch_size, L), np.int64)
        for i, u in enumerate(users):
            s = self.train_seq(u)
            seq[i] = self._pad_left(s[:-1], L)
            labels[i] = self._pad_left(s[1:], L)
        batch = {"seq": seq, "labels": labels}
        if n_negatives:
            if c.n_items > 1:
                # uniform over the n_items - 1 NON-label items: draw in
                # [1, n_items - 1] and bump past the positive, so a
                # "negative" can never collide with its label (a
                # colliding draw silently pushed the positive down)
                neg = rng.integers(1, c.n_items,
                                   (batch_size, L, n_negatives))
                batch["negatives"] = neg + (neg >= labels[..., None])
            else:
                batch["negatives"] = np.ones(
                    (batch_size, L, n_negatives), np.int64)
        return batch

    def eval_batch(self, users, *, split: str = "test"):
        c = self.cfg
        L = c.seq_len
        seq = np.zeros((len(users), L), np.int64)
        tgt = np.zeros(len(users), np.int64)
        for i, u in enumerate(users):
            full = self.seqs[u]
            hist = full[:-1] if split == "test" else full[:-2]
            seq[i] = self._pad_left(hist, L)
            tgt[i] = full[-1] if split == "test" else full[-2]
        return {"seq": seq, "target": tgt}

    # ------------------------------------------------- two-tower view
    def twotower_batch(self, step: int, batch_size: int, hist_len: int):
        c = self.cfg
        rng = np.random.default_rng((c.seed, 2, step))
        users = rng.integers(0, self.n_users_eff, batch_size)
        hist = np.zeros((batch_size, hist_len), np.int64)
        pos = np.zeros(batch_size, np.int64)
        for i, u in enumerate(users):
            s = self.train_seq(u)
            # length-1 train sequences (raw length exactly 3) have no
            # interior cut: empty history, the lone item is the positive
            cut = int(rng.integers(1, len(s))) if len(s) > 1 else 0
            hist[i] = self._pad_left(s[:cut], hist_len)
            pos[i] = s[cut]
        # logQ correction: sampling probability ~ empirical popularity
        logq = np.log(self.pop[pos - 1] / self.pop.sum() + 1e-12)
        return {"user_hist": hist, "pos_item": pos,
                "logq": logq.astype(np.float32)}
