"""Async micro-batching queue for request-level retrieval serving.

Single-user requests (one variable-length item history each) are
coalesced into fixed-shape ``[max_batch, L_bucket]`` batches under a
latency budget: a bucket flushes the moment it holds ``max_batch``
requests OR the moment its oldest request has waited ``max_delay``
seconds — whichever comes first.  Deadline flushes are partial; the
missing rows are padded with all-pad (id 0) dummy histories so every
flush of a bucket runs the SAME batch shape.

**Bucketed padding.**  Histories are grouped by length into the
smallest configured bucket that fits (``buckets`` ascending, e.g.
(16, 32, 64)), and padded with the pad id (0) only up to that bucket's
length — one long request inflates its own bucket's batch, never the
short requests queued beside it.  Histories longer than the largest
bucket keep their most recent items (the serving convention: the tail
of a history is what predicts the next item).

**Why fixed shapes.**  A row's result is bitwise stable at a fixed
batch shape (it does not depend on what the other rows hold, dummy pad
rows included) but not across batch sizes: the GEMM libraries pick
another tiling, and so another summation order, for another shape.
Padding every flush to ``[max_batch, L_bucket]`` is therefore what makes
continuous batching *bit-exact* per request against single-request
serving at the same shape — the conformance contract
``tests/test_torch_server.py`` pins.

The queue is a pure state machine over an injectable ``clock`` (so the
deadline logic is testable with a fake clock); it is host-only numpy,
and threading lives in the server loop, not here.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0


@dataclasses.dataclass
class Request:
    """One user's retrieval request: a 1-D int32 item-id history."""
    rid: int
    hist: np.ndarray                  # [l] int32, natural length
    t_submit: float = 0.0

    def __post_init__(self):
        self.hist = np.asarray(self.hist, np.int32).reshape(-1)


@dataclasses.dataclass
class Batch:
    """A flushed, padded batch: ``hist [max_batch, bucket_len]`` with
    ``requests[i]`` in row i; rows ≥ ``n_real`` are all-pad dummies."""
    requests: List[Request]
    bucket_len: int
    max_batch: int

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def occupancy(self) -> float:
        return self.n_real / self.max_batch

    def padded_hist(self) -> np.ndarray:
        out = np.full((self.max_batch, self.bucket_len), PAD_ID, np.int32)
        for i, r in enumerate(self.requests):
            h = r.hist[-self.bucket_len:]          # keep the recent tail
            out[i, :h.size] = h
        return out

    def to_message(self, version: int, floor) -> Dict[str, np.ndarray]:
        """The batch, the catalogue version it is served on and its
        ``[max_batch]`` warm floor as a flat dict of arrays (what rank
        0 of a mesh server broadcasts): ``hist`` the padded histories,
        ``rids`` the request ids, ``meta`` (bucket length, max batch,
        version), ``floor``."""
        return {"hist": self.padded_hist(),
                "rids": np.asarray([r.rid for r in self.requests],
                                   np.int64),
                "meta": np.asarray([self.bucket_len, self.max_batch,
                                    version], np.int64),
                "floor": np.asarray(floor, np.float32)}

    @classmethod
    def from_message(cls, msg) -> Tuple["Batch", int, np.ndarray]:
        """(batch, version, floor) of a ``to_message`` dict: request i
        holds row i of the padded histories, so the batch pads to the
        same ``[max_batch, bucket_len]`` rows."""
        bucket_len, max_batch, version = (int(x) for x in msg["meta"])
        hist = np.asarray(msg["hist"], np.int32)
        reqs = [Request(int(rid), hist[i])
                for i, rid in enumerate(np.asarray(msg["rids"]))]
        return (cls(reqs, bucket_len, max_batch), version,
                np.asarray(msg["floor"], np.float32))


class MicroBatchQueue:
    """Coalesce requests into fixed-shape batches under a latency budget.

    ``submit`` enqueues; ``poll`` applies the flush rule at the current
    clock and returns the batches that are due (possibly several, when
    a burst filled a bucket more than once).  ``next_deadline`` is the
    earliest instant a deadline flush becomes due — the server loop's
    sleep bound.
    """

    def __init__(self, *, max_batch: int, max_delay: float,
                 buckets: Sequence[int],
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0: {max_delay}")
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {buckets}")
        self.clock = clock
        self._pending: Dict[int, List[Request]] = {b: [] for b in
                                                   self.buckets}
        self._rid = itertools.count()

    def bucket_of(self, length: int) -> int:
        """Smallest bucket holding ``length``; the largest for longer
        histories (which keep their most recent items)."""
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def submit(self, hist, rid: Optional[int] = None) -> int:
        if rid is None:
            rid = next(self._rid)
        elif rid >= 0:
            # the internal counter owns the non-negative id space; an
            # explicit rid that lands in it collides with a queued or
            # future request — duplicate rows in flight merge in the
            # metrics' _completed map and the duplicate counter lies.
            # Callers with their own ids use the negative namespace
            # (the warm-up path's Request(-1, ...) convention).
            raise ValueError(
                f"explicit rid must be negative (caller namespace); "
                f"got {rid}, which can collide with the queue's "
                f"internal non-negative ids")
        req = Request(rid, hist, t_submit=self.clock())
        self._pending[self.bucket_of(req.hist.size)].append(req)
        return req.rid

    def depth(self) -> int:
        return sum(len(p) for p in self._pending.values())

    def next_deadline(self) -> Optional[float]:
        heads = [p[0].t_submit for p in self._pending.values() if p]
        return min(heads) + self.max_delay if heads else None

    def poll(self, *, force: bool = False) -> List[Batch]:
        """Flush rule at ``clock()``: full buckets always flush; a
        partial bucket flushes when its oldest request's wait has
        reached ``max_delay`` (or unconditionally under ``force`` —
        the drain path)."""
        now = self.clock()
        out: List[Batch] = []
        for L, pend in self._pending.items():
            while len(pend) >= self.max_batch:
                out.append(Batch(pend[:self.max_batch], L, self.max_batch))
                del pend[:self.max_batch]
            # same expression as next_deadline(), so pumping exactly AT
            # the deadline flushes (`now - t >= delay` can disagree with
            # `now >= t + delay` by one ULP and spin the event loop)
            if pend and (force
                         or now >= pend[0].t_submit + self.max_delay):
                out.append(Batch(pend[:], L, self.max_batch))
                pend.clear()
        return out
