"""Catalogue registry: prebuilt ``PruneState``s with versioned hot-swap.

The pruned serve path's presence mask is codes-only and O(N·m) to
build, so it must never be (re)built inline per request.  The registry
is where that protocol lives at the server level: every catalogue
version's ``PruneState`` is built ONCE, keyed by ``(codes-hash, shards,
block_n, perm-hash)`` so identical catalogues (or re-publishes of the
same codes) reuse the prebuilt state, and the live version is swapped
atomically.

**Hot-swap protocol.**  ``publish(codes, b)`` builds the new version's
state (off-thread with ``block=False`` — the serving loop keeps
draining on the live version while the scatter runs), then *validates*
it on a probe batch — the pruned sweep over the new state must be
bit-identical to the unpruned fused sweep over the same codes (the
exactness contract; a corrupted presence mask or a stale id-map fails
here, before any traffic sees it) — and only then swaps the live
pointer under the lock.  Readers take a snapshot (``live()``) per
batch and finish on whatever version they started with: in-flight
requests drain on the old version, new flushes pick up the new one,
and nothing is ever served mid-swap.

**Streams.**  The kernels launch on PyTorch's *current* stream.  On the
card the build and the probe therefore run on a stream of their own
(made per build, after the publisher's stream so the codes are ready),
never on the serving stream: there the O(N·m) scatter would queue
behind the serving kernels and they behind it.  That stream is
synchronised before the swap, so the probe's host comparison certifies
a finished state, and the state's tensors are recorded on the
publisher's stream, where the replicas read them.  ``CatalogueVersion
.build_stream`` names the stream (None on the CPU).

The probe LUT is ``torch.randn`` from a ``torch.Generator`` seeded with
``probe_seed`` on the codes' device, so its values differ from the JAX
package's ``jax.random`` probe; the check it makes is the same.

Because pruning is bit-exact, a swap that changes only the pruning
artefacts (block_n, permutation) provably cannot change any result —
which is what lets the tests hot-swap mid-stream and still demand
bit-identical responses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CatalogueVersion:
    """An immutable published catalogue: what a replica serves from.

    ``state`` is None for unpruned catalogues (the registry still
    versions the codes so hot-swap semantics are uniform)."""
    version: int
    codes: object                     # torch [N, m]
    b: int                            # codebook size (LUT width)
    state: object                     # kernels.jpq_topk.ops.PruneState | None
    # (codes-hash, shards, block_n, perm-hash): everything the prebuilt
    # state depends on — perm included, else a re-publish of the same
    # codes under a new sweep order would reuse the old state
    key: Tuple[str, int, int, str]
    perm: object = None               # [N] original-id sweep order | None
    built_s: float = 0.0
    validated: bool = False
    build_stream: Optional[int] = None  # raw CUDA stream of the build


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def codes_hash(codes) -> str:
    """sha1 of the codes' host bytes and shape: the same codes give the
    same hash as a numpy array, a tensor on any device, or in the JAX
    package.  The hash reads the array in place (no ``tobytes`` copy)
    and releases the GIL while it runs, so an off-thread build holds
    the serving thread back as little as it can."""
    a = np.ascontiguousarray(_host(codes))
    h = hashlib.sha1(a)
    h.update(str(a.shape).encode())
    return h.hexdigest()


@contextlib.contextmanager
def _own_stream(codes, after):
    """On the card: a new stream that first waits for ``after`` (the
    publisher's), current inside the block and synchronised on a clean
    exit; yields it.  On the CPU: nothing."""
    if not codes.is_cuda:
        yield None
        return
    stream = torch.cuda.Stream(device=codes.device)
    stream.wait_stream(after)
    with torch.cuda.stream(stream):
        yield stream
    stream.synchronize()


class CatalogueRegistry:
    """Holds the live catalogue version and the prebuilt-state cache.

    ``block_n`` overrides the tile size; ``shards`` > 1 tiles each of
    the S row blocks exactly (``engine.resolve_prune_block_n``): one
    global state from the whole codes, which every rank of a mesh
    server holds and serves its rows of (``launch/server.py --mesh``).
    ``prune=False`` publishes versions without pruning state (the plain
    fused path).

    ``listeners`` are called with ``(version, codes, b, perm)`` at each
    publish, in version order (under the lock that numbers them): rank
    0 of a mesh server mirrors its publishes to the other ranks from
    there.  ``get(version)`` waits for a version's build and returns
    it, live or not: a rank of a mesh server serves each batch on the
    version rank 0 served it on.
    """

    def __init__(self, *, shards: int = 0, block_n: Optional[int] = None,
                 prune: bool = True, probe_batch: int = 4,
                 probe_k: int = 10, probe_seed: int = 0):
        self.shards = int(shards)
        self.block_n = block_n
        self.prune = bool(prune)
        self.probe_batch = int(probe_batch)
        self.probe_k = int(probe_k)
        self.probe_seed = int(probe_seed)
        self._lock = threading.Lock()
        self._built_cv = threading.Condition(self._lock)
        self._built: Dict[int, CatalogueVersion] = {}
        self.listeners: List = []
        self._live: Optional[CatalogueVersion] = None
        self._next_version = 1
        self._states: Dict[Tuple[str, int, int, str], object] = {}
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self.swap_count = 0

    # ------------------------------------------------------------ read
    def live(self) -> CatalogueVersion:
        """Snapshot of the live version — hold it for the whole batch;
        the registry never mutates a published version."""
        v = self._live
        if v is None:
            raise RuntimeError("no catalogue published yet")
        return v

    # ----------------------------------------------------------- write
    def publish(self, codes, b: int, *, perm=None,
                block: bool = True) -> int:
        """Build + validate + swap in a new catalogue version; returns
        its version number.  ``block=False`` runs build/validate on a
        worker thread (``wait()`` joins); the live version keeps
        serving until the swap."""
        codes = torch.as_tensor(codes)
        with self._lock:
            version = self._next_version
            self._next_version += 1
            for fn in self.listeners:
                fn(version, codes, int(b), perm)
        after = torch.cuda.current_stream(codes.device) if codes.is_cuda \
            else None
        if block:
            self._build_and_swap(version, codes, b, perm, after)
        else:
            t = threading.Thread(
                target=self._guarded_build,
                args=(version, codes, b, perm, after),
                name=f"catalogue-build-v{version}", daemon=True)
            self._threads.append(t)
            t.start()
        return version

    def get(self, version: int) -> CatalogueVersion:
        """Catalogue ``version`` once its build has finished (waiting
        for it); re-raises a build's error."""
        with self._built_cv:
            while version not in self._built:
                if self._errors:
                    raise self._errors[-1]
                self._built_cv.wait()
            return self._built[version]

    def wait(self) -> None:
        """Join outstanding off-thread builds; re-raise their errors."""
        for t in self._threads:
            t.join()
        self._threads.clear()
        if self._errors:
            raise self._errors.pop()

    # -------------------------------------------------------- internals
    def _guarded_build(self, version, codes, b, perm, after):
        try:
            self._build_and_swap(version, codes, b, perm, after)
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            with self._built_cv:
                self._errors.append(e)
                self._built_cv.notify_all()

    def _resolve_block_n(self, N: int):
        from repro_torch.core import engine as _engine
        return _engine.resolve_prune_block_n(N, shards=self.shards,
                                             block_n=self.block_n)

    def _build_and_swap(self, version, codes, b, perm, after):
        """``after``: the publisher's stream (None for CPU codes); the
        build waits for its work and the swapped state's memory is
        kept alive for its reads."""
        from repro_torch.core import engine as _engine

        t0 = time.perf_counter()
        N = codes.shape[0]
        bn = self._resolve_block_n(N)
        with _own_stream(codes, after) as stream:
            key = (codes_hash(codes), self.shards, bn,
                   "" if perm is None else codes_hash(perm))
            state = None
            if self.prune:
                with self._lock:
                    state = self._states.get(key)
                if state is None:
                    state = _engine.build_prune_state(codes, int(b),
                                                      block_n=bn, perm=perm)

            # probe validation: pruned-over-new-state must be
            # bit-identical to the unpruned fused sweep over the same codes
            validated = False
            if state is not None:
                gen = torch.Generator(device=codes.device).manual_seed(
                    self.probe_seed)
                probe = torch.randn(
                    (self.probe_batch, codes.shape[1], int(b)),
                    generator=gen, device=codes.device)
                k = min(self.probe_k, N)
                ref = _engine.probe_topk(probe, codes, k)
                got = _engine.probe_topk(probe, codes, k, prune=state)
                if not all(np.array_equal(_host(r), _host(g))
                           for r, g in zip(ref, got)):
                    raise ValueError(
                        f"catalogue v{version} failed probe validation: "
                        f"pruned top-{k} diverged from the unpruned fused "
                        f"sweep — refusing to swap")
                validated = True
        if state is not None and stream is not None:
            # the replicas read the state on the publisher's stream:
            # its memory must not be reused before their reads finish
            for t in (state.codes, state.ids, state.present):
                t.record_stream(after)

        entry = CatalogueVersion(
            version=version, codes=codes, b=int(b), state=state, key=key,
            perm=None if perm is None else _host(perm),
            built_s=time.perf_counter() - t0, validated=validated,
            build_stream=None if stream is None else stream.cuda_stream)
        with self._built_cv:
            if state is not None:
                self._states[key] = state
            self._built[version] = entry
            self._built_cv.notify_all()
            # versions race only through block=False publishes; never
            # let a slow old build clobber a newer live catalogue
            if self._live is None or version > self._live.version:
                self._live = entry
                self.swap_count += 1
