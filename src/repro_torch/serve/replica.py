"""Serving replicas over one catalogue.

A ``Replica`` binds (model, params) and serves padded fixed-shape
batches from the micro-batching queue through the model's bound
retrieval engine (``model.bind_engine(params, spec, catalogue=...)`` —
``core.engine``), with the live catalogue version's prebuilt
``PruneState`` and an optional per-replica warm-threshold EMA.

**Dispatch cache.**  PyTorch runs eagerly, so nothing compiles; the
bound dispatch callable is still built once per ``(RetrievalSpec,
catalogue version, bucket length)`` and cached in the engine's
``JitCache`` — the spec's hashability IS the cache key, so two serve
configurations can never alias one entry.  The ``PruneState`` is bound
on the engine, while the warm floor is a ``[max_batch]`` argument.
Fixed ``[max_batch, L_bucket]`` shapes keep per-row results bitwise
stable (see ``serve.queue``).  On catalogue hot-swap the server evicts
entries for retired versions (``evict`` — keep the live + draining
version), so the cache stays bounded over any number of swaps.

**Warm floors and dummy rows.**  The floor is a float32 tensor on the
model's device; for padding rows (row ≥ ``n_real``) it is −inf: a
dummy all-pad row scores junk, and a finite floor over junk could
demote and re-sweep the whole batch for rows nobody asked about.
Symmetrically, only ``theta[:n_real]`` is folded back into the EMA — a
dummy row's threshold describes no real query.  Exactness does not
depend on any of this (the demotion rule repairs every overshoot); it
is purely a perf hygiene rule.

Each batch reads its values, ids and pruning stats back to the host
in one copy, packed into one int32 tensor after its kernels (the warm
path's demotion test in ``ops.jpq_topk_lut`` makes one sync of its
own); ``Result`` holds numpy arrays.

``ReplicaPool`` round-robins batches over replicas and periodically
merges their warm EMAs (``ThresholdState.merge`` — a pure host-side
min-reduce, so replicas share pruning progress without sharing device
state).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import JitCache, RetrievalSpec
from repro_torch.core.serve import ThresholdState
from repro_torch.serve.queue import Batch
from repro_torch.serve.registry import CatalogueVersion


@dataclasses.dataclass
class Result:
    """One completed request: top-k over the catalogue version that was
    live when the batch flushed."""
    rid: int
    values: np.ndarray                # [k] f32
    ids: np.ndarray                   # [k] i32
    version: int
    warm_hit: bool = False


class Replica:
    """One serving worker: dispatch cache + warm EMA over a bound model."""

    def __init__(self, model, params, *, k: int,
                 warm: Optional[ThresholdState] = None,
                 name: str = "replica0",
                 spec: Optional[RetrievalSpec] = None):
        if not hasattr(model, "bind_engine"):
            raise TypeError(
                f"{type(model).__name__} exposes no .bind_engine — "
                f"serving goes through core.engine")
        self.name = name
        self.k = int(k)
        self.warm = warm
        self.model = model
        self.params = params
        # base spec: policy knobs that don't depend on the catalogue
        # version (kind/block_n/fused).  prune/perm/warm/stats are
        # stamped per version in _dispatch_fn — they follow the live
        # catalogue, not the replica.
        if spec is None:
            spec = RetrievalSpec(kind=model.emb.cfg.kind, k=self.k)
        self._base_spec = dataclasses.replace(
            spec, k=self.k, prune=False, perm="none", warm=None,
            stats=False)
        self.cache = JitCache()
        self.batches_served = 0

    # -------------------------------------------------------- dispatch
    def _version_spec(self, version: CatalogueVersion) -> RetrievalSpec:
        """The full spec a catalogue version serves under: the base
        policy + the version-dependent prune/perm/warm/stats fields."""
        pruned = version.state is not None
        return dataclasses.replace(
            self._base_spec, prune=pruned, stats=pruned,
            warm=(self.warm.decay
                  if (self.warm is not None and pruned) else None),
            perm=("catalogue"
                  if (pruned and version.perm is not None) else "none"))

    def _dispatch_fn(self, version: CatalogueVersion,
                     bucket_len: int) -> Callable:
        spec = self._version_spec(version)

        def build():
            # the PruneState is bound on the engine; the floor is an
            # argument
            bound = self.model.bind_engine(self.params, spec,
                                           catalogue=version)
            if spec.prune:
                def run(hist, floor):
                    return bound.retrieve(hist, floor=floor)
            else:
                def run(hist, floor):
                    del floor                # unpruned path: no knobs
                    return bound.retrieve(hist)
            return run

        return self.cache.get(spec, version.version, bucket_len, build)

    def evict(self, keep_versions) -> int:
        """Drop cached dispatches for retired catalogue versions."""
        return self.cache.evict(keep_versions)

    # ----------------------------------------------------------- serve
    def floor_for(self, batch: Batch) -> np.ndarray:
        """The ``[max_batch]`` warm floor this replica would serve
        ``batch`` with: its EMA's for the real rows (−inf while cold or
        without a warm state), −inf for the dummy rows."""
        floor = (self.warm.floor(batch.max_batch) if self.warm is not None
                 else np.full((batch.max_batch,), -np.inf, np.float32))
        floor[batch.n_real:] = -np.inf             # dummy rows: cold
        return floor

    def serve(self, batch: Batch, version: CatalogueVersion,
              floor=None) -> Tuple[List[Result], dict]:
        """Serve one padded batch; returns per-request results (real
        rows only) and a host-side summary dict for metrics.  ``floor``
        (default: ``floor_for(batch)``) is the warm floor to serve with:
        the ranks of a mesh server all take rank 0's."""
        dev = self.model.device
        hist = torch.as_tensor(batch.padded_hist(), device=dev)
        n_real = batch.n_real
        if floor is None:
            floor = self.floor_for(batch)
        warmed = np.isfinite(floor[:n_real])
        floor = torch.as_tensor(floor, device=dev)
        pruned = version.state is not None
        with torch.inference_mode():
            out = self._dispatch_fn(version, batch.bucket_len)(hist, floor)
            # the one readback: values (as their bits), ids and, when
            # pruned, theta, demoted and the skipped-tile count, packed
            # into one int32 [max_batch, 2k (+3)] tensor
            k = out[0].shape[1]
            cols = [out[0].float().view(torch.int32), out[1].to(torch.int32)]
            if pruned:
                stats = out[2]
                cols += [stats["theta"].float().view(torch.int32)[:, None],
                         stats["demoted"].to(torch.int32)[:, None],
                         stats["skipped_tiles"].to(torch.int32).reshape(
                             1, 1).expand(batch.max_batch, 1)]
            host = torch.cat(cols, 1).cpu().numpy()
        vals = host[:, :k].view(np.float32)
        ids = host[:, k:2 * k]

        summary = {"skipped": 0.0, "total": 0.0,
                   "warm_hits": 0, "warm_total": 0}
        hit_rows = np.zeros((n_real,), bool)
        if pruned:
            if self.warm is not None:
                demoted = host[:n_real, 2 * k + 1].astype(bool)
                hit_rows = warmed & ~demoted       # the floor held
                summary["warm_hits"] = int(hit_rows.sum())
                summary["warm_total"] = n_real
                # real rows only
                self.warm.update(host[:n_real, 2 * k].view(np.float32))
            summary["skipped"] = float(host[0, 2 * k + 2])
            summary["total"] = float(stats["total_tiles"])
        self.batches_served += 1
        results = [
            Result(r.rid, vals[i].copy(), ids[i].copy(), version.version,
                   warm_hit=bool(hit_rows[i]))
            for i, r in enumerate(batch.requests)]
        return results, summary


class ReplicaPool:
    """Round-robin pool of replicas with periodic warm-floor merging.

    ``merge_every`` batches, every replica's ThresholdState is folded
    through ``ThresholdState.merge`` (min-reduce + adopt), so a floor
    learned on one replica prunes traffic on all of them.  0 disables
    merging (independent floors)."""

    def __init__(self, replicas: List[Replica], *, merge_every: int = 0):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        self.merge_every = int(merge_every)
        self._next = 0
        self._since_merge = 0
        self.merge_count = 0

    @property
    def next_replica(self) -> Replica:
        """The replica the next ``serve`` goes to."""
        return self.replicas[self._next]

    def serve(self, batch: Batch, version: CatalogueVersion,
              floor=None) -> Tuple[List[Result], dict]:
        rep = self.replicas[self._next]
        self._next = (self._next + 1) % len(self.replicas)
        out = rep.serve(batch, version, floor)
        self._since_merge += 1
        if self.merge_every and self._since_merge >= self.merge_every:
            self.merge_warm()
            self._since_merge = 0
        return out

    def merge_warm(self):
        states = [r.warm for r in self.replicas if r.warm is not None]
        if len(states) < 2:
            return None
        self.merge_count += 1
        return ThresholdState.merge(states)

    def reset_warm(self):
        """Cold-restart every replica's floor — the hot-swap rule: old
        thresholds describe a catalogue that no longer exists."""
        for r in self.replicas:
            if r.warm is not None:
                r.warm.reset()

    def evict_retired(self, keep_versions) -> int:
        """Drop every replica's cached dispatches for catalogue
        versions outside ``keep_versions`` (the hot-swap rule: keep the
        live version plus the one in-flight batches may still drain
        on); returns the total number of entries evicted."""
        return sum(r.evict(keep_versions) for r in self.replicas)
