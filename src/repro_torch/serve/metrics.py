"""Server observability: latency percentiles, queue depth, batch
occupancy, pruning/warm counters — exported as JSON-able snapshots.

Everything here is host-side numpy over values the serve path already
returns (the pruning stats dict, read back once a batch).  A snapshot
is one flat dict (``ServerMetrics.snapshot``) whose shape is pinned by
``METRICS_SCHEMA`` and checked by ``validate_snapshot``; the schema is
the JAX package's, key for key, so one snapshot validates under both.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

# required key -> type(s); nested dicts pin their own required keys.
# Optional[...] values may be None (e.g. skip_fraction on an unpruned
# server) but must be present.
METRICS_SCHEMA = {
    "config": str,
    "requests_submitted": int,
    "requests_completed": int,
    "requests_pending": int,
    "requests_dropped": int,
    "requests_duplicated": int,
    "batches": int,
    "batch_occupancy": float,
    "latency_ms": {"p50": float, "p95": float, "p99": float,
                   "mean": float, "max": float},
    "queue_depth": {"mean": float, "max": int},
    "skip_fraction": (float, type(None)),
    "warm_hit_rate": (float, type(None)),
    "catalogue_swaps": int,
}


class ServerMetrics:
    """Accumulators for one server run; ``snapshot()`` freezes them."""

    def __init__(self, config: str = "queue"):
        self.config = config
        self._lat_ms: List[float] = []
        self._depths: List[int] = []
        self._occ: List[float] = []
        self._submitted = 0
        self._dropped = 0
        self._completed: Dict[int, int] = {}     # rid -> completions
        self._skipped = 0.0
        self._tiles = 0.0
        self._warm_hits = 0
        self._warm_total = 0
        self.catalogue_swaps = 0

    # ------------------------------------------------------- recording
    def record_submit(self, rid: int) -> None:
        self._submitted += 1

    def record_complete(self, rid: int, latency_s: float) -> None:
        self._completed[rid] = self._completed.get(rid, 0) + 1
        self._lat_ms.append(latency_s * 1e3)

    def record_drop(self, rid: int) -> None:
        """A request the server gave up on (shed, timed out, replica
        lost).  Nothing in the current pipeline drops, so this stays 0
        unless a policy explicitly calls it — which is what makes
        ``requests_dropped`` mean *dropped*, and a still-queued request
        count as pending on a mid-run snapshot."""
        self._dropped += 1

    def record_queue_depth(self, depth: int) -> None:
        self._depths.append(int(depth))

    def record_batch(self, n_real: int, max_batch: int) -> None:
        self._occ.append(n_real / max_batch)

    def record_prune(self, skipped: float, total: float) -> None:
        self._skipped += float(skipped)
        self._tiles += float(total)

    def record_warm(self, n_hit: int, n_total: int) -> None:
        """Warm-hit = a request served under a finite warm floor that
        was NOT demoted (the floor held; no re-sweep)."""
        self._warm_hits += int(n_hit)
        self._warm_total += int(n_total)

    # -------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        lats = np.asarray(self._lat_ms, np.float64)
        depths = np.asarray(self._depths, np.float64)
        completed = len(self._completed)
        duplicated = sum(c - 1 for c in self._completed.values())
        pct = (lambda q: float(np.percentile(lats, q))) if lats.size \
            else (lambda q: 0.0)
        return {
            "config": self.config,
            "requests_submitted": self._submitted,
            "requests_completed": completed,
            "requests_pending": self._submitted - completed
            - self._dropped,
            "requests_dropped": self._dropped,
            "requests_duplicated": duplicated,
            "batches": len(self._occ),
            "batch_occupancy": float(np.mean(self._occ))
            if self._occ else 0.0,
            "latency_ms": {"p50": pct(50), "p95": pct(95), "p99": pct(99),
                           "mean": float(lats.mean()) if lats.size else 0.0,
                           "max": float(lats.max()) if lats.size else 0.0},
            "queue_depth": {"mean": float(depths.mean())
                            if depths.size else 0.0,
                            "max": int(depths.max()) if depths.size else 0},
            "skip_fraction": (self._skipped / self._tiles)
            if self._tiles > 0 else None,
            "warm_hit_rate": (self._warm_hits / self._warm_total)
            if self._warm_total > 0 else None,
            "catalogue_swaps": int(self.catalogue_swaps),
        }

    def json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)


def validate_snapshot(snap: dict,
                      schema: Optional[dict] = None) -> List[str]:
    """Schema-check one snapshot; returns a list of problems (empty =
    valid).  Checks presence + types per METRICS_SCHEMA, and the
    ordering invariants p50 ≤ p95 ≤ p99 ≤ max and counts ≥ 0."""
    schema = METRICS_SCHEMA if schema is None else schema
    errs: List[str] = []

    def check(prefix: str, spec, value):
        if isinstance(spec, dict):
            if not isinstance(value, dict):
                errs.append(f"{prefix}: expected dict, got "
                            f"{type(value).__name__}")
                return
            for k, sub in spec.items():
                if k not in value:
                    errs.append(f"{prefix}.{k}: missing")
                else:
                    check(f"{prefix}.{k}", sub, value[k])
            return
        types = spec if isinstance(spec, tuple) else (spec,)
        # bools are ints in python; reject them where ints are expected
        if isinstance(value, bool) or not isinstance(value, types):
            errs.append(f"{prefix}: expected {types}, got "
                        f"{type(value).__name__}")

    for key, spec in schema.items():
        if key not in snap:
            errs.append(f"{key}: missing")
        else:
            check(key, spec, snap[key])
    if not errs:
        lat = snap["latency_ms"]
        if not (lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
                or lat["max"] == 0.0):
            errs.append("latency_ms: percentiles not monotonic")
        for k in ("requests_submitted", "requests_completed",
                  "requests_pending", "requests_dropped",
                  "requests_duplicated", "batches"):
            if snap[k] < 0:
                errs.append(f"{k}: negative")
    return errs
