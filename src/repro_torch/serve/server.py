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

**Under a mesh** (``mesh``: a ``(1, S)`` ``HostMesh``, one process a
rank, each serving its rows of the catalogue through
``core/sharded.py``'s mesh branches) rank 0 runs this server: the
queue, the clock, the load, the registry's version choice and the
metrics are its own.  The other ranks run ``follow``.  Rank 0
broadcasts (``HostMesh.broadcast``) one message before each batch it
serves (``Batch.to_message``: the padded histories, the request ids,
the version it serves on and rank 0's warm floor), each publish it
makes (the version, the codes unless they are the previous publish's,
the permutation), and a stop message at ``close``.  A rank builds a
mirrored version on a stream of its own, as rank 0 does, and serves a
batch only once it holds that batch's version (``registry.get``), with
rank 0's floor: every batch is served on every rank with the same
version and the same floor, so every rank issues the same collectives.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.metrics import ServerMetrics
from repro_torch.serve.queue import Batch, MicroBatchQueue
from repro_torch.serve.registry import CatalogueRegistry
from repro_torch.serve.replica import ReplicaPool, Result

# the kinds of rank 0's messages to the other ranks of a mesh server
HELLO, PUBLISH, BATCH, STOP = range(4)


class RetrievalServer:
    """Single-process continuous-batching retrieval server."""

    def __init__(self, pool: ReplicaPool, registry: CatalogueRegistry, *,
                 max_batch: int = 8, max_delay: float = 0.005,
                 buckets: Sequence[int] = (16, 32, 64),
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[ServerMetrics] = None, mesh=None):
        self.pool = pool
        self.registry = registry
        self.queue = MicroBatchQueue(max_batch=max_batch,
                                     max_delay=max_delay,
                                     buckets=buckets, clock=clock)
        self.clock = clock
        self.metrics = metrics or ServerMetrics()
        self.results: Dict[int, Result] = {}
        self._last_version: Optional[int] = None
        self.mesh = mesh if mesh is not None and mesh.world_size > 1 \
            else None
        if self.mesh is not None:
            if self.mesh.rank != 0:
                raise ValueError("rank 0 runs the server; the other "
                                 "ranks follow (serve.server.follow)")
            self._outbox: list = []        # publishes not yet mirrored
            self._last_codes = registry.live().codes
            registry.listeners.append(self._note_publish)
            # the other ranks built their first version alone: the same
            # catalogue, or they stop here
            _send(self.mesh, HELLO, key=_key_bytes(registry.live().key))

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
        self._mirror_publishes()
        done = 0
        for batch in batches:
            if self.mesh is None:
                results, summary = self.pool.serve(batch, version)
            else:
                floor = self.pool.next_replica.floor_for(batch)
                _send(self.mesh, BATCH,
                      **batch.to_message(version.version, floor))
                results, summary = self.pool.serve(batch, version, floor)
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

    def close(self) -> None:
        """Under a mesh: mirror what is left to publish and stop the
        other ranks (once)."""
        if self.mesh is None:
            return
        self._mirror_publishes()
        _send(self.mesh, STOP)
        self.registry.listeners.remove(self._note_publish)
        self.mesh = None

    def _note_publish(self, version, codes, b, perm) -> None:
        """The registry's listener: a publish to mirror (on the
        publisher's thread; the serving thread sends it)."""
        self._outbox.append((version, codes, b, perm))

    def _mirror_publishes(self) -> None:
        """Send each publish made since the last batch, in version
        order, before the next batch's message."""
        if self.mesh is None:
            return
        while self._outbox:
            version, codes, b, perm = self._outbox.pop(0)
            same = codes is self._last_codes
            self._last_codes = codes
            _send(self.mesh, PUBLISH, version=version, b=b,
                  codes=codes[:0] if same else codes,
                  perm=np.zeros(0, np.int64) if perm is None else perm)

    def result(self, rid: int) -> Result:
        return self.results[rid]


def _key_bytes(key) -> np.ndarray:
    return np.frombuffer(repr(key).encode(), np.uint8).copy()


def _send(mesh, kind: int, **fields):
    """Broadcast one message from rank 0: ``kind`` and ``fields``
    (arrays or tensors), as tensors on the mesh's device."""
    msg = {"kind": torch.tensor(kind, dtype=torch.int64)}
    msg.update({k: torch.as_tensor(v) for k, v in fields.items()})
    mesh.broadcast({k: v.to(mesh.device) for k, v in msg.items()}, 0)


def follow(mesh, pool: ReplicaPool,
           registry: CatalogueRegistry) -> List[Tuple[int, tuple]]:
    """The loop of a rank other than 0 of a mesh server: receive rank
    0's messages until its stop; mirror each publish (built off-thread
    on a stream of its own, numbered as rank 0 numbered it); serve each
    batch on its version, once built, with rank 0's floor, and discard
    the results (rank 0 answers).  ``pool`` and ``registry`` are set up
    as rank 0's are, and its first version published.  Returns the
    log: the version and the request ids of each batch served."""
    codes, last, served = registry.live().codes, None, []
    while True:
        msg = mesh.broadcast(None, 0)
        kind = int(msg.pop("kind"))
        if kind == STOP:
            return served
        if kind == HELLO:
            want = bytes(msg["key"].cpu().numpy())
            have = _key_bytes(registry.live().key).tobytes()
            if want != have:
                raise ValueError(f"rank {mesh.rank} built catalogue "
                                 f"{have!r}, rank 0 {want!r}")
        elif kind == PUBLISH:
            if msg["codes"].numel():
                codes = msg["codes"]
            perm = msg["perm"].cpu().numpy() if msg["perm"].numel() \
                else None
            got = registry.publish(codes, int(msg["b"]), perm=perm,
                                   block=False)
            if got != int(msg["version"]):
                raise ValueError(f"rank {mesh.rank} numbered a publish "
                                 f"v{got}, rank 0 v{int(msg['version'])}")
        else:
            batch, v, floor = Batch.from_message(
                {k: x.cpu().numpy() for k, x in msg.items()})
            version = registry.get(v)
            if last is not None and v != last:
                pool.reset_warm()
                pool.evict_retired({v, last})
            last = v
            pool.serve(batch, version, floor)
            served.append((v, tuple(int(r.rid) for r in batch.requests)))
