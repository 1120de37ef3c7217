"""The retrieval server: queue + replica pool + registry + metrics.

``RetrievalServer`` wires the pieces into one request-level serving
loop: ``submit`` enqueues a single user's history, ``pump`` flushes
whatever batches are due (full buckets, or partial buckets past the
latency budget) through the replica pool against the registry's live
catalogue version, and results land in ``results`` keyed by request
id.  Serving is single-threaded and clock-injected — the concurrency
story is the micro-batching itself, which is what the
latency/throughput trade measures, and it keeps the conformance tests
deterministic (only an off-thread ``publish`` runs beside it).

Hot-swap is visible here as one rule: each ``pump`` takes ONE registry
snapshot and serves every batch it flushes on that version; a publish
landing mid-pump is picked up by the next pump.  On a version change
the pool's warm floors are reset (old thresholds describe a catalogue
that no longer exists — ``ThresholdState.reset``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

from repro_torch.serve.metrics import ServerMetrics
from repro_torch.serve.queue import MicroBatchQueue
from repro_torch.serve.registry import CatalogueRegistry
from repro_torch.serve.replica import ReplicaPool, Result


class RetrievalServer:
    """Single-process continuous-batching retrieval server."""

    def __init__(self, pool: ReplicaPool, registry: CatalogueRegistry, *,
                 max_batch: int = 8, max_delay: float = 0.005,
                 buckets: Sequence[int] = (16, 32, 64),
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[ServerMetrics] = None):
        self.pool = pool
        self.registry = registry
        self.queue = MicroBatchQueue(max_batch=max_batch,
                                     max_delay=max_delay,
                                     buckets=buckets, clock=clock)
        self.clock = clock
        self.metrics = metrics or ServerMetrics()
        self.results: Dict[int, Result] = {}
        self._last_version: Optional[int] = None

    # ------------------------------------------------------------- API
    def submit(self, hist) -> int:
        rid = self.queue.submit(hist)
        self.metrics.record_submit(rid)
        self.metrics.record_queue_depth(self.queue.depth())
        return rid

    def in_flight(self) -> int:
        return self.queue.depth()

    def next_deadline(self) -> Optional[float]:
        return self.queue.next_deadline()

    def pump(self, *, force: bool = False) -> int:
        """Flush + serve every batch due at the current clock; returns
        the number of requests completed."""
        batches = self.queue.poll(force=force)
        if not batches:
            return 0
        version = self.registry.live()         # ONE snapshot per pump
        if self._last_version is not None and \
                version.version != self._last_version:
            self.pool.reset_warm()
            # retire cached dispatches for dead versions: keep the new
            # live version and the one in-flight work may still drain
            # on, so the cache stays bounded across swaps
            self.pool.evict_retired({version.version, self._last_version})
            self.metrics.catalogue_swaps += 1
        self._last_version = version.version
        done = 0
        for batch in batches:
            results, summary = self.pool.serve(batch, version)
            t_done = self.clock()
            self.metrics.record_batch(batch.n_real, batch.max_batch)
            self.metrics.record_prune(summary["skipped"],
                                      summary["total"])
            self.metrics.record_warm(summary["warm_hits"],
                                     summary["warm_total"])
            for req, res in zip(batch.requests, results):
                self.results[res.rid] = res
                self.metrics.record_complete(
                    res.rid, t_done - req.t_submit)
                done += 1
        return done

    def drain(self) -> None:
        """Serve everything still queued, budget or not."""
        while self.queue.depth():
            self.pump(force=True)

    def result(self, rid: int) -> Result:
        return self.results[rid]
