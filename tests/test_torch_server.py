"""Request-level serving conformance suite of the port (repro_torch.serve),
the port against itself: every test of the JAX package's
``tests/test_server.py`` has its counterpart here, at the same smoke
sizes (``max_batch`` 4, buckets (4, 8), K = 7), on the CPU.

The contract under test: a request served through the continuous-
batching server — queued, bucketed, padded into a shared fixed-shape
batch, pruned with warm floors, possibly across a catalogue hot-swap —
returns top-k values and ids BIT-IDENTICAL (tolerance 0) to the same
request served alone (row 0 of an otherwise-empty batch of the same
shape) through the port's unpruned fused path.  Fixed shapes matter:
per-row results are bitwise stable under co-batch changes at one shape
but not across batch sizes, which is why the reference is "alone at the
same shape", not "at batch 1".

Plus unit tests for the pieces: queue flush/deadline semantics on a
fake clock, ThresholdState EMA edge cases and merge algebra, registry
probe-validation and prebuilt-state reuse, metrics schema, and the
Poisson load generator.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.serve import ThresholdState
from repro_torch.serve import (METRICS_SCHEMA, Batch, CatalogueRegistry,
                               MicroBatchQueue, Replica, ReplicaPool, Request,
                               RetrievalServer, ServerMetrics, VirtualClock,
                               poisson_arrivals, request_stream, run_open_loop,
                               validate_snapshot)

# ============================================================ ThresholdState


class TestThresholdState:
    def test_decay_zero_tracks_latest_min(self):
        st = ThresholdState(0.0)            # decay=0 is valid: no memory
        st.update([3.0, 5.0])
        assert st.theta == 3.0
        st.update([10.0])
        assert st.theta == 10.0

    def test_decay_one_rejected(self):
        with pytest.raises(ValueError):
            ThresholdState(1.0)             # would freeze the EMA forever
        with pytest.raises(ValueError):
            ThresholdState(-0.1)

    def test_ema_math(self):
        st = ThresholdState(0.5)
        st.update([4.0])
        st.update([8.0])
        assert st.theta == pytest.approx(0.5 * 4.0 + 0.5 * 8.0)

    def test_pathological_inputs_do_not_poison_floor(self):
        st = ThresholdState(0.9)
        st.update([np.nan, np.inf, -np.inf])     # all dropped: no-op
        assert st.theta is None
        assert st.floor(3)[0] == -np.inf
        st.update([np.nan, 2.0, np.inf, 7.0])    # finite entries only
        assert st.theta == 2.0
        st.update([np.nan])                      # no-op, keeps 2.0
        assert st.theta == 2.0

    def test_reset_returns_to_cold(self):
        st = ThresholdState(0.9)
        st.update([1.0])
        st.reset()
        assert st.theta is None
        assert np.all(st.floor(4) == -np.inf)
        assert st.decay == 0.9

    def test_merge_commutative_and_adopts(self):
        def mk(thetas):
            out = []
            for t in thetas:
                s = ThresholdState(0.9)
                s.theta = t
                out.append(s)
            return out

        a = ThresholdState.merge(mk([3.0, 1.0, 2.0]))
        b = ThresholdState.merge(mk([2.0, 3.0, 1.0]))
        assert a == b == 1.0
        states = mk([3.0, 1.0, 2.0])
        ThresholdState.merge(states)
        assert all(s.theta == 1.0 for s in states)

    def test_merge_skips_cold_and_handles_all_cold(self):
        warm = ThresholdState(0.9)
        warm.theta = 5.0
        cold = ThresholdState(0.9)
        assert ThresholdState.merge([warm, cold]) == 5.0
        assert warm.theta == 5.0 and cold.theta == 5.0
        assert ThresholdState.merge(
            [ThresholdState(0.9), ThresholdState(0.9)]) is None


# ============================================================ MicroBatchQueue


class TestMicroBatchQueue:
    def _q(self, clock, max_batch=4, max_delay=0.01, buckets=(4, 8)):
        return MicroBatchQueue(max_batch=max_batch, max_delay=max_delay,
                               buckets=buckets, clock=clock)

    def test_full_bucket_flushes_immediately(self):
        clk = VirtualClock()
        q = self._q(clk)
        for i in range(4):
            q.submit(np.arange(1, 4, dtype=np.int32))
        out = q.poll()
        assert len(out) == 1 and out[0].n_real == 4
        assert out[0].bucket_len == 4
        assert q.depth() == 0

    def test_partial_waits_for_deadline(self):
        clk = VirtualClock()
        q = self._q(clk, max_delay=0.01)
        q.submit([1, 2])
        assert q.poll() == []                       # budget not spent
        clk.advance_to(0.0099)
        assert q.poll() == []
        clk.advance_to(0.01)                        # exactly the deadline
        out = q.poll()
        assert len(out) == 1 and out[0].n_real == 1
        assert q.depth() == 0

    def test_next_deadline_is_oldest_plus_budget(self):
        clk = VirtualClock()
        q = self._q(clk, max_delay=0.5)
        assert q.next_deadline() is None
        clk.advance_to(1.0)
        q.submit([1])
        clk.advance_to(2.0)
        q.submit([2])
        assert q.next_deadline() == pytest.approx(1.5)

    def test_force_flush(self):
        q = self._q(VirtualClock())
        q.submit([1])
        out = q.poll(force=True)
        assert len(out) == 1 and out[0].n_real == 1

    def test_burst_yields_multiple_full_batches(self):
        clk = VirtualClock()
        q = self._q(clk, max_batch=2)
        for i in range(5):
            q.submit([1, 2, 3])
        out = q.poll()                              # 2 full, 1 left
        assert [b.n_real for b in out] == [2, 2]
        assert q.depth() == 1

    def test_bucketing_by_length(self):
        q = self._q(VirtualClock(), buckets=(4, 8))
        assert q.bucket_of(1) == 4
        assert q.bucket_of(4) == 4
        assert q.bucket_of(5) == 8
        assert q.bucket_of(100) == 8                # overlong -> largest
        q.submit(np.arange(1, 3))                   # len 2  -> bucket 4
        q.submit(np.arange(1, 7))                   # len 6  -> bucket 8
        out = sorted(q.poll(force=True), key=lambda b: b.bucket_len)
        assert [b.bucket_len for b in out] == [4, 8]

    def test_padded_hist_shape_and_dummy_rows(self):
        b = Batch([Request(0, [7, 8]), Request(1, [9])], bucket_len=4,
                  max_batch=4)
        h = b.padded_hist()
        assert h.shape == (4, 4) and h.dtype == np.int32
        np.testing.assert_array_equal(h[0], [7, 8, 0, 0])
        np.testing.assert_array_equal(h[1], [9, 0, 0, 0])
        assert np.all(h[2:] == 0)                   # dummy rows all-pad
        assert b.occupancy == 0.5

    def test_explicit_nonnegative_rid_rejected(self):
        """The internal counter owns the non-negative id space; an
        explicit rid landing in it collides with a queued or future
        request.  Caller-owned ids live in the negative namespace (the
        warm-up path's Request(-1, ...) convention)."""
        clk = VirtualClock()
        q = self._q(clk)
        first = q.submit([1, 2])
        assert first == 0                       # counter-assigned
        with pytest.raises(ValueError, match="negative"):
            q.submit([1, 2], rid=0)             # collides with `first`
        with pytest.raises(ValueError, match="negative"):
            q.submit([1, 2], rid=7)             # future counter value
        # the rejects must not have consumed counter ids or enqueued
        assert q.submit([3, 4]) == 1
        assert q.depth() == 2
        # negative (caller-namespace) ids pass through untouched
        assert q.submit([5, 6], rid=-3) == -3

    def test_overlong_history_keeps_recent_tail(self):
        b = Batch([Request(0, np.arange(1, 11))], bucket_len=4,
                  max_batch=2)
        np.testing.assert_array_equal(b.padded_hist()[0], [7, 8, 9, 10])


# =================================================================== metrics


class TestMetrics:
    def _filled(self):
        m = ServerMetrics("queue+warm")
        for rid in range(4):
            m.record_submit(rid)
            m.record_queue_depth(rid)
        for rid in range(4):
            m.record_complete(rid, 0.001 * (rid + 1))
        m.record_batch(3, 4)
        m.record_prune(5, 10)
        m.record_warm(2, 3)
        return m

    def test_snapshot_is_schema_valid(self):
        snap = self._filled().snapshot()
        assert validate_snapshot(snap) == []
        assert snap["requests_dropped"] == 0
        assert snap["batch_occupancy"] == 0.75
        assert snap["skip_fraction"] == 0.5
        assert snap["warm_hit_rate"] == pytest.approx(2 / 3)

    def test_duplicated_completions_counted(self):
        m = self._filled()
        m.record_complete(0, 0.001)                 # rid 0 twice
        snap = m.snapshot()
        assert snap["requests_duplicated"] == 1
        assert snap["requests_completed"] == 4      # unique rids

    def test_validate_catches_missing_and_mistyped(self):
        snap = self._filled().snapshot()
        del snap["latency_ms"]["p99"]
        snap["requests_dropped"] = "zero"
        errs = validate_snapshot(snap)
        assert any("p99" in e for e in errs)
        assert any("requests_dropped" in e for e in errs)

    def test_validate_rejects_bool_for_int(self):
        snap = self._filled().snapshot()
        snap["catalogue_swaps"] = True
        assert any("catalogue_swaps" in e
                   for e in validate_snapshot(snap))

    def test_empty_snapshot_valid(self):
        assert validate_snapshot(ServerMetrics().snapshot()) == []

    def test_inflight_requests_are_pending_not_dropped(self):
        """A mid-run snapshot with queued work reports the backlog as
        ``requests_pending``, never as dropped."""
        m = ServerMetrics("queue")
        for rid in range(6):
            m.record_submit(rid)
        for rid in range(2):
            m.record_complete(rid, 0.001)
        snap = m.snapshot()
        assert validate_snapshot(snap) == []
        assert snap["requests_pending"] == 4
        assert snap["requests_dropped"] == 0        # nothing dropped
        # draining the backlog empties pending
        for rid in range(2, 6):
            m.record_complete(rid, 0.001)
        snap = m.snapshot()
        assert snap["requests_pending"] == 0
        assert snap["requests_completed"] == 6

    def test_dropped_means_explicitly_dropped(self):
        m = ServerMetrics("queue")
        for rid in range(5):
            m.record_submit(rid)
        m.record_complete(0, 0.001)
        m.record_drop(3)
        m.record_drop(4)
        snap = m.snapshot()
        assert validate_snapshot(snap) == []
        assert snap["requests_dropped"] == 2
        assert snap["requests_pending"] == 2        # 1, 2 still queued
        assert snap["requests_completed"] == 1

    def test_pending_is_schema_required(self):
        snap = self._filled().snapshot()
        del snap["requests_pending"]
        assert any("requests_pending" in e
                   for e in validate_snapshot(snap))

    def test_schema_covers_required_surface(self):
        for k in ("latency_ms", "queue_depth", "skip_fraction",
                  "warm_hit_rate", "catalogue_swaps"):
            assert k in METRICS_SCHEMA


# =================================================================== loadgen


class TestLoadgen:
    def test_poisson_arrivals(self):
        a = poisson_arrivals(100.0, 1000, seed=1)
        assert a.shape == (1000,)
        assert np.all(np.diff(a) >= 0)
        np.testing.assert_array_equal(a, poisson_arrivals(100.0, 1000,
                                                          seed=1))
        # mean inter-arrival ~ 1/rate
        assert np.diff(a).mean() == pytest.approx(0.01, rel=0.2)
        with pytest.raises(ValueError):
            poisson_arrivals(0.0, 5)

    def test_request_stream_respects_reserved_and_lengths(self):
        hists = request_stream(50, n_items=20, max_len=8, min_len=2,
                               reserved=(0, 21), seed=3)
        assert len(hists) == 50
        for h in hists:
            assert 2 <= h.size <= 8
            assert h.dtype == np.int32
            assert h.min() >= 1 and h.max() <= 20

    def test_request_stream_needs_valid_ids(self):
        with pytest.raises(ValueError):
            request_stream(5, n_items=1, max_len=4, reserved=(0, 1))


# ============================================== conformance (model-backed)


@pytest.fixture(scope="module")
def smoke_model():
    from repro_torch.configs import get_bundle
    model, _ = get_bundle("two-tower-retrieval-jpq").make_smoke(
        device="cpu")
    return model, model.params()


K = 7
MAX_BATCH = 4
BUCKETS = (4, 8)


def _reference(model, params):
    """Serve one request ALONE at the server's shape: row 0 of an
    all-pad [MAX_BATCH, L] batch through the plain (unpruned, cold)
    fused path.  Bit-identical to the server is the whole contract:
    padding rows, co-batched strangers, pruning state, warm floors and
    hot-swaps must all be invisible in the bits."""
    def ref(hist):
        hist = np.asarray(hist, np.int32).reshape(-1)
        q = MicroBatchQueue(max_batch=MAX_BATCH, max_delay=0,
                            buckets=BUCKETS, clock=lambda: 0.0)
        L = q.bucket_of(hist.size)
        xb = np.zeros((MAX_BATCH, L), np.int32)
        h = hist[-L:]
        xb[0, :h.size] = h
        with torch.inference_mode():
            v, i = model.retrieve(params, {"user_hist": xb}, top_k=K)
        return v[0].numpy(), i[0].numpy()
    return ref


def _make_server(model, params, *, clock, warm=True, prune=True,
                 replicas=2, max_delay=0.005):
    codes = params["item_emb"]["codes"]
    registry = CatalogueRegistry(prune=prune)
    registry.publish(codes, int(model.emb.cfg.b))
    pool = ReplicaPool(
        [Replica(model, params, k=K,
                 warm=ThresholdState(0.9) if warm and prune else None,
                 name=f"r{i}") for i in range(replicas)],
        merge_every=2)
    server = RetrievalServer(pool, registry, max_batch=MAX_BATCH,
                             max_delay=max_delay, buckets=BUCKETS,
                             clock=clock)
    return server, registry


def _assert_bits(res, rv, ri):
    np.testing.assert_array_equal(res.ids, ri)
    np.testing.assert_array_equal(res.values.view(np.int32),
                                  rv.view(np.int32))


class TestServerConformance:
    def test_queued_batched_results_bit_identical(self, smoke_model):
        """Varied-length requests (bucketing), Poisson arrivals with
        deadline partial flushes (padding), two warm replicas with
        periodic floor merging — every response bit-equal to the
        request served alone."""
        model, params = smoke_model
        clk = VirtualClock()
        server, _ = _make_server(model, params, clock=clk)
        hists = request_stream(40, n_items=int(model.cfg.n_items),
                               max_len=8, seed=7)
        arrivals = poisson_arrivals(400.0, len(hists), seed=7)
        submitted = run_open_loop(server, hists, arrivals, clock=clk)
        server.drain()

        ref = _reference(model, params)
        assert len(submitted) == len(hists)
        for (rid, _), hist in zip(submitted, hists):
            _assert_bits(server.result(rid), *ref(hist))

        snap = server.metrics.snapshot()
        assert validate_snapshot(snap) == []
        assert snap["requests_completed"] == len(hists)
        assert snap["requests_dropped"] == 0
        assert snap["requests_duplicated"] == 0
        # the queue actually batched (otherwise this tested nothing)
        assert snap["batches"] < len(hists)

    def test_hot_swap_mid_stream_is_invisible(self, smoke_model):
        """Publish a new catalogue version (same codes, reversed sweep
        order) halfway through the stream: in-flight requests drain on
        the old version, later ones serve on the new, and — because
        pruning is bit-exact — every response still matches the
        single-request reference."""
        model, params = smoke_model
        codes = params["item_emb"]["codes"]
        clk = VirtualClock()
        server, registry = _make_server(model, params, clock=clk)
        ref = _reference(model, params)
        hists = request_stream(24, n_items=int(model.cfg.n_items),
                               max_len=8, seed=11)

        results = {}
        for i, h in enumerate(hists):
            if i == 12:                      # hot-swap mid-stream
                N = codes.shape[0]
                perm = np.arange(N)[::-1].copy()
                registry.publish(codes, int(model.emb.cfg.b), perm=perm)
            rid = server.submit(h)
            results[rid] = h
            clk.advance_to(clk() + 0.001)
            server.pump()
        server.drain()

        versions = set()
        for rid, h in results.items():
            res = server.result(rid)
            versions.add(res.version)
            _assert_bits(res, *ref(h))
        assert versions == {1, 2}            # both versions served
        assert server.metrics.snapshot()["catalogue_swaps"] == 1

    def test_deadline_flush_timing_fake_clock(self, smoke_model):
        """A lone request must NOT be served before its latency budget
        expires, and MUST be served (padded, occupancy < 1) once the
        fake clock crosses submit + max_delay."""
        model, params = smoke_model
        clk = VirtualClock()
        server, _ = _make_server(model, params, clock=clk, warm=False,
                                 replicas=1, max_delay=0.02)
        rid = server.submit([3, 4, 5])
        assert server.pump() == 0            # t=0: budget unspent
        clk.advance_to(0.019)
        assert server.pump() == 0
        clk.advance_to(0.02)                 # deadline reached
        assert server.pump() == 1
        _assert_bits(server.result(rid),
                     *_reference(model, params)([3, 4, 5]))
        snap = server.metrics.snapshot()
        assert snap["batch_occupancy"] == pytest.approx(1 / MAX_BATCH)
        assert snap["latency_ms"]["p50"] == pytest.approx(20.0)

    def test_unpruned_server_matches_too(self, smoke_model):
        """prune=False registry versions (no PruneState) serve through
        the plain fused path and still hit the reference bits."""
        model, params = smoke_model
        clk = VirtualClock()
        server, _ = _make_server(model, params, clock=clk, warm=False,
                                 prune=False, replicas=1)
        ref = _reference(model, params)
        hists = request_stream(MAX_BATCH, n_items=int(model.cfg.n_items),
                               max_len=4, seed=2)
        rids = [server.submit(h) for h in hists]
        server.drain()
        for rid, hist in zip(rids, hists):
            _assert_bits(server.result(rid), *ref(hist))


class TestRegistry:
    def test_publish_validate_and_reuse(self, smoke_model):
        model, params = smoke_model
        codes = params["item_emb"]["codes"]
        b = int(model.emb.cfg.b)
        reg = CatalogueRegistry()
        v1 = reg.publish(codes, b)
        live1 = reg.live()
        assert live1.version == v1 == 1 and live1.validated
        assert live1.state is not None
        assert live1.build_stream is None     # the CPU has no streams
        # same codes re-published: prebuilt state reused by identity
        v2 = reg.publish(codes, b)
        live2 = reg.live()
        assert live2.version == v2 == 2
        assert live2.state is live1.state
        assert reg.swap_count == 2

    def test_perm_changes_cache_key(self, smoke_model):
        model, params = smoke_model
        codes = params["item_emb"]["codes"]
        b = int(model.emb.cfg.b)
        reg = CatalogueRegistry()
        reg.publish(codes, b)
        s1 = reg.live().state
        perm = np.arange(codes.shape[0])[::-1].copy()
        reg.publish(codes, b, perm=perm)
        assert reg.live().state is not s1

    def test_off_thread_build_serves_old_until_swap(self, smoke_model):
        model, params = smoke_model
        codes = params["item_emb"]["codes"]
        b = int(model.emb.cfg.b)
        reg = CatalogueRegistry()
        reg.publish(codes, b)
        assert reg.live().version == 1
        reg.publish(codes, b, block=False)
        reg.wait()
        assert reg.live().version == 2

    def test_probe_validation_rejects_corrupt_state(self, smoke_model,
                                                    monkeypatch):
        """A presence mask claiming every tile is empty prunes
        everything — the probe must catch the divergence and refuse to
        swap, keeping the old version live."""
        from repro_torch.kernels.jpq_topk import ops as tops
        model, params = smoke_model
        codes = params["item_emb"]["codes"]
        b = int(model.emb.cfg.b)
        # block_n=64 gives the 512-row smoke catalogue 8 tiles — at the
        # default (single-tile) size nothing is skippable, so a corrupt
        # mask would be unobservable and the probe rightly passes
        reg = CatalogueRegistry(block_n=64)
        reg.publish(codes, b)

        real_prepare = tops.prepare_pruning

        def corrupt(codes, b, block_n, perm=None):
            st = real_prepare(codes, b, block_n, perm=perm)
            return st._replace(present=torch.zeros_like(st.present))

        monkeypatch.setattr(tops, "prepare_pruning", corrupt)
        with pytest.raises(ValueError, match="probe validation"):
            reg.publish(codes, b, perm=np.arange(codes.shape[0]))
        assert reg.live().version == 1       # old version stays live

    def test_stale_build_cannot_clobber_newer_live(self, smoke_model):
        model, params = smoke_model
        codes = params["item_emb"]["codes"]
        b = int(model.emb.cfg.b)
        reg = CatalogueRegistry(prune=False)
        reg.publish(codes, b)
        reg.publish(codes, b)
        assert reg.live().version == 2
        reg._build_and_swap(1, codes, b, None, None)   # late v1 lands now
        assert reg.live().version == 2

    def test_live_before_publish_raises(self):
        with pytest.raises(RuntimeError):
            CatalogueRegistry().live()

    def test_off_thread_error_surfaces_in_wait(self, smoke_model,
                                               monkeypatch):
        from repro_torch.kernels.jpq_topk import ops as tops
        model, params = smoke_model
        codes = params["item_emb"]["codes"]

        def boom(*a, **kw):
            raise RuntimeError("scatter OOM")

        monkeypatch.setattr(tops, "prepare_pruning", boom)
        reg = CatalogueRegistry()
        reg.publish(codes, int(model.emb.cfg.b), block=False)
        with pytest.raises(RuntimeError, match="scatter OOM"):
            reg.wait()
        with pytest.raises(RuntimeError):    # failed build never swapped
            reg.live()


# ===================================================== overlong protocol


def _tiny_seqrec():
    """A directly-constructed bert4rec + JPQ model: the arch whose serve
    protocol appends a [MASK] after the history — the case where
    truncation ORDER matters."""
    from repro_torch.core import EmbeddingConfig
    from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
    cfg = SeqRecConfig(
        arch="bert4rec", n_items=40, max_len=max(BUCKETS), d_model=16,
        n_layers=1, n_heads=2, d_ff=32,
        embedding=EmbeddingConfig(0, 0, kind="jpq", m=2, b=8))
    codes = np.random.default_rng(5).integers(0, 8, size=(cfg.n_rows, 2))
    model = SeqRecModel(cfg, codes=codes,
                        generator=torch.Generator().manual_seed(2),
                        device="cpu")
    return model, model.params()


class TestOverlongProtocol:
    """An overlong request (history longer than every bucket) must be
    tail-truncated BEFORE the serve protocol's [MASK] append: the
    queue's ``padded_hist`` keeps ``hist[-L:]`` and the model then
    shifts in the [MASK].  Pinned server-vs-direct at the batch shape,
    both for the fused-score head and the semantic-ID head."""

    def test_truncate_then_append_equals_append_then_truncate(self):
        # the protocol identity, in plain numpy: for a FULL bucket row,
        # shift-left + [MASK] on hist[-L:] == ([MASK]-extended)[-L:]
        mask = 99
        hist = np.arange(1, 14, dtype=np.int32)          # len 13
        for L in BUCKETS:
            t = hist[-L:]
            served = np.concatenate([t[1:], [mask]])     # _serve_seq
            oracle = np.concatenate([hist, [mask]])[-L:]
            np.testing.assert_array_equal(served, oracle)

    @pytest.mark.parametrize("spec_kw", [
        dict(kind="jpq"),
        dict(kind="semantic", beams=64),
    ])
    def test_overlong_server_matches_direct_and_score_last(self, spec_kw):
        from repro_torch.core import engine
        model, params = _tiny_seqrec()
        spec = engine.RetrievalSpec(k=K, **spec_kw)
        codes = params["item_emb"]["codes"]
        registry = CatalogueRegistry(prune=False)
        registry.publish(codes, int(model.emb.cfg.b))
        pool = ReplicaPool([Replica(model, params, k=K, spec=spec)])
        server = RetrievalServer(pool, registry, max_batch=MAX_BATCH,
                                 max_delay=0.0, buckets=BUCKETS)

        hist = np.asarray(
            np.random.default_rng(9).integers(1, 41, size=13), np.int32)
        assert hist.size > max(BUCKETS)                  # overlong
        rid = server.submit(hist)
        server.drain()
        res = server.result(rid)

        # (a) bit-parity with the request served alone at the replica's
        # batch shape (the conformance contract)
        L = max(BUCKETS)
        padded = Batch([Request(rid, hist)], L,
                       server.queue.max_batch).padded_hist()
        np.testing.assert_array_equal(padded[0], hist[-L:])
        seq = torch.as_tensor(padded)
        with torch.inference_mode():
            ref_v, ref_i = model.bind_engine(params, spec).retrieve(seq)
            scores = model.score_last(params, seq)
        _assert_bits(res, ref_v[0].numpy(), ref_i[0].numpy())

        # (b) end-to-end protocol oracle: the served top-k IS the
        # materialised ranking of the truncated window at that shape
        # (total order: value descending, then id ascending)
        sv, si = engine.rerank_candidates(
            scores, torch.arange(scores.shape[1], dtype=torch.int32
                                 ).expand_as(scores), K)
        _assert_bits(res, sv[0].numpy(), si[0].numpy())
