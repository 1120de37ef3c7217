"""Parity of the port's request-level server (repro_torch.serve,
repro_torch.launch.server) with the JAX package's (repro.serve,
repro.launch.server), on the CPU and the same numpy inputs.

Host-only parts — the load generator, the queue's flush sequence,
``codes_hash``, the metrics snapshot and its validation — must be EQUAL,
not close.  End to end, the reference's two-tower-retrieval-jpq smoke
parameters (bridged) serve the same request stream on the same virtual
clock through both servers, across a mid-stream catalogue publish: the
same batches flush, the same versions serve each request, ids are equal
and values agree within 2e-7 absolute (the tolerance of
``tests/test_torch_serve.py``: the LUT einsum and the user tower sum in
another order than XLA), with the gaps between the top k+1 scores of
every request asserted above ten times that tolerance, so a tie cannot
flip an id.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as J
from repro.configs import get_bundle as J_get_bundle
from repro.core.serve import ThresholdState as J_TS
from repro.launch import server as J_cli
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch import serve as T
from repro_torch.configs import get_bundle as T_get_bundle
from repro_torch.core.serve import ThresholdState as T_TS
from repro_torch.launch import server as T_cli

TOL = 2e-7
K, MAX_BATCH, BUCKETS = 7, 4, (4, 8)


# ================================================================ host-only

def test_public_names_and_schema_equal():
    assert T.__all__ == J.__all__
    assert T.METRICS_SCHEMA == J.METRICS_SCHEMA
    assert T.PAD_ID == J.PAD_ID


@pytest.mark.parametrize("rate, n, seed", [(500.0, 400, 0), (400.0, 40, 7),
                                           (100.0, 1000, 1)])
def test_poisson_arrivals_equal(rate, n, seed):
    np.testing.assert_array_equal(T.poisson_arrivals(rate, n, seed=seed),
                                  J.poisson_arrivals(rate, n, seed=seed))


@pytest.mark.parametrize("kw", [
    dict(n=40, n_items=200, max_len=8, seed=7),
    dict(n=50, n_items=20, max_len=8, min_len=2, reserved=(0, 21), seed=3),
    dict(n=400, n_items=1_000_000, max_len=50, seed=0),
])
def test_request_stream_equal(kw):
    kw = dict(kw)
    n = kw.pop("n")
    got, want = T.request_stream(n, **kw), J.request_stream(n, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _flush_script(pkg):
    """One scripted run of a queue on a virtual clock: Poisson arrivals,
    a poll after every submit and at every deadline in between, a forced
    drain at the end.  Returns the flushed batches as (bucket_len,
    rids, padded_hist)."""
    clk = pkg.VirtualClock()
    q = pkg.MicroBatchQueue(max_batch=MAX_BATCH, max_delay=0.004,
                            buckets=BUCKETS, clock=clk)
    hists = pkg.request_stream(60, n_items=200, max_len=12, seed=5)
    out = []

    def take(batches):
        out.extend((b.bucket_len, [r.rid for r in b.requests],
                    b.padded_hist()) for b in batches)

    for h, t in zip(hists, pkg.poisson_arrivals(700.0, len(hists), seed=5)):
        dl = q.next_deadline()
        while dl is not None and dl < t:
            clk.advance_to(dl)
            take(q.poll())
            dl = q.next_deadline()
        clk.advance_to(t)
        q.submit(h)
        take(q.poll())
    take(q.poll(force=True))
    return out


def test_flushed_batches_equal():
    got, want = _flush_script(T), _flush_script(J)
    assert len(got) == len(want) > len(BUCKETS)
    assert any(len(r) < MAX_BATCH for _, r, _ in got)   # partial flushes
    for (gl, gr, gh), (wl, wr, wh) in zip(got, want):
        assert (gl, gr) == (wl, wr)
        assert gh.dtype == wh.dtype
        np.testing.assert_array_equal(gh, wh)


@pytest.mark.parametrize("shape, b", [((512, 4), 16), ((1000, 8), 256)])
def test_codes_hash_equal(shape, b):
    codes = np.random.default_rng(0).integers(0, b, shape).astype(np.uint8)
    h = J.codes_hash(jnp.asarray(codes))
    assert h == J.codes_hash(codes) == T.codes_hash(codes)
    assert T.codes_hash(torch.as_tensor(codes)) == h
    # the shape is part of the key
    assert T.codes_hash(codes.reshape(shape[1], shape[0])) != h


def test_perm_hash_equal():
    """The sweep order's hash keys the prebuilt state too (int64)."""
    perm = np.random.default_rng(1).permutation(1000)
    assert T.codes_hash(perm) == J.codes_hash(perm)
    assert T.codes_hash(torch.as_tensor(perm)) == J.codes_hash(perm)


def _fill(m, seed):
    rng = np.random.default_rng(seed)
    for rid in range(30):
        m.record_submit(rid)
        m.record_queue_depth(int(rng.integers(0, 9)))
    for rid in rng.permutation(30)[:25]:
        m.record_complete(int(rid), float(rng.exponential(0.004)))
    m.record_complete(3, 0.002)                       # a duplicate
    m.record_drop(29)
    for _ in range(7):
        m.record_batch(int(rng.integers(1, 5)), 4)
        m.record_prune(float(rng.integers(0, 5)), 8.0)
        m.record_warm(int(rng.integers(0, 3)), 3)
    m.catalogue_swaps = 2
    return m


def test_snapshot_equal_and_cross_valid():
    t = _fill(T.ServerMetrics("queue+prune"), 1).snapshot()
    j = _fill(J.ServerMetrics("queue+prune"), 1).snapshot()
    assert t == j
    assert T.validate_snapshot(j) == [] and J.validate_snapshot(t) == []
    assert T.validate_snapshot(T.ServerMetrics().snapshot()) == []
    assert J.validate_snapshot(T.ServerMetrics().snapshot()) == []


@pytest.mark.parametrize("mutate", [
    lambda s: s["latency_ms"].pop("p99"),
    lambda s: s.update(requests_dropped="zero"),
    lambda s: s.update(catalogue_swaps=True),
    lambda s: s.update(requests_pending=-1),
    lambda s: s["latency_ms"].update(p50=1e9),
    lambda s: s.pop("queue_depth"),
], ids=["missing", "mistyped", "bool", "negative", "non-monotonic",
        "missing-dict"])
def test_validate_reports_the_same_problems(mutate):
    snap = _fill(T.ServerMetrics(), 2).snapshot()
    mutate(snap)
    errs = T.validate_snapshot(snap)
    assert errs and errs == J.validate_snapshot(snap)


# ============================================ model-backed, end to end

@pytest.fixture(scope="module")
def pair():
    """The reference's smoke model and params, and the port's smoke
    model on the same (bridged) weights."""
    jm, _, rng = J_get_bundle("two-tower-retrieval-jpq").make_smoke()
    jp = jm.init_params(rng)
    tm, _ = T_get_bundle("two-tower-retrieval-jpq").make_smoke(device="cpu")
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    return jm, jp, tm, tm.params()


def _run(pkg, TS, model, params, codes, hists, arrivals, *, prune, warm,
         swap_at):
    """Serve ``hists`` at ``arrivals`` on a virtual clock through two
    replicas, publishing the same codes reverse-permuted before request
    ``swap_at``; returns (server, the flushed batches as (bucket_len,
    rids, version))."""
    clk = pkg.VirtualClock()
    registry = pkg.CatalogueRegistry(prune=prune)
    b = int(model.emb.cfg.b)
    registry.publish(codes, b)
    pool = pkg.ReplicaPool(
        [pkg.Replica(model, params, k=K, name=f"r{i}",
                     warm=TS(0.9) if warm else None) for i in range(2)],
        merge_every=2)
    server = pkg.RetrievalServer(pool, registry, max_batch=MAX_BATCH,
                                 max_delay=0.005, buckets=BUCKETS,
                                 clock=clk)
    flushed, submitted = [], [0]
    serve, submit = pool.serve, server.submit

    def record(batch, version):
        flushed.append((batch.bucket_len, [r.rid for r in batch.requests],
                        version.version))
        return serve(batch, version)

    def submit_then_maybe_swap(h):
        if submitted[0] == swap_at:
            registry.publish(codes, b,
                             perm=np.arange(codes.shape[0])[::-1].copy())
        submitted[0] += 1
        return submit(h)

    pool.serve, server.submit = record, submit_then_maybe_swap
    pkg.run_open_loop(server, hists, arrivals, clock=clk)
    server.drain()
    return server, flushed


def _min_gap(jm, jp, hist):
    """Smallest gap between the reference's top K+1 scores of ``hist``
    served at its bucket's shape (row 0 of an all-pad batch)."""
    L = min([b for b in BUCKETS if b >= hist.size] or [max(BUCKETS)])
    xb = np.zeros((MAX_BATCH, L), np.int32)
    h = hist[-L:]
    xb[0, :h.size] = h
    s = np.asarray(jm.emb.logits(jp["item_emb"],
                                 jm.user_vec(jp, jnp.asarray(xb))))[0]
    top = -np.sort(-s)[:K + 1]
    return float(np.min(top[:-1] - top[1:]))


@pytest.mark.parametrize("prune, warm", [(True, True), (False, False)],
                         ids=["pruned-warm", "unpruned"])
def test_servers_agree_end_to_end(pair, prune, warm):
    jm, jp, tm, tp = pair
    n_items = int(jm.cfg.n_items)
    hists = T.request_stream(40, n_items=n_items, max_len=8, seed=7)
    arrivals = T.poisson_arrivals(400.0, len(hists), seed=7)
    j_codes = jp["item_emb"]["codes"].value
    t_codes = tp["item_emb"]["codes"]
    np.testing.assert_array_equal(np.asarray(j_codes), t_codes.numpy())
    js, jf = _run(J, J_TS, jm, jp, j_codes, hists, arrivals, prune=prune,
                  warm=warm, swap_at=20)
    ts, tf = _run(T, T_TS, tm, tp, t_codes, hists, arrivals, prune=prune,
                  warm=warm, swap_at=20)

    assert tf == jf                                  # the same batches
    assert len(tf) < len(hists)
    assert {v for _, _, v in tf} == {1, 2}           # the swap served
    for rid, hist in enumerate(hists):
        assert _min_gap(jm, jp, hist) > 10 * TOL
        t, j = ts.result(rid), js.result(rid)
        assert t.version == j.version
        np.testing.assert_array_equal(t.ids, np.asarray(j.ids))
        np.testing.assert_allclose(t.values, np.asarray(j.values),
                                   rtol=0, atol=TOL)
    t_snap, j_snap = ts.metrics.snapshot(), js.metrics.snapshot()
    for key in ("requests_submitted", "requests_completed", "batches",
                "batch_occupancy", "queue_depth", "catalogue_swaps",
                "config"):
        assert t_snap[key] == j_snap[key], key
    assert (t_snap["skip_fraction"] is None) == (not prune)


# ===================================================================== CLI

@pytest.mark.parametrize("flags", [
    [], ["--no-prune"], ["--prune", "--perm", "--warm"],
    ["--warm", "--replicas", "2"], ["--no-fused"], ["--max-batch", "1"],
    ["--head", "semantic"],
], ids=lambda f: " ".join(f) or "defaults")
def test_cli_flags_resolve_alike(flags):
    from repro.core import engine as J_engine
    from repro_torch.core import engine as T_engine
    ja = J_cli.build_parser().parse_args(flags)
    ta = T_cli.build_parser().parse_args(flags)
    assert {k: v for k, v in vars(ta).items()
            if k not in ("device", "share_card")} == vars(ja)
    js = J_engine.spec_from_args(ja, kind="jpq", k=ja.top_k)
    ts = T_engine.spec_from_args(ta, kind="jpq", k=ta.top_k)
    # the port's spec has no Pallas ``backend`` field: the tensors'
    # device picks the route
    want = dataclasses.asdict(js)
    assert want.pop("backend") is None
    assert dataclasses.asdict(ts) == want
    assert T_cli._config_name(ta, ts) == J_cli._config_name(ja, js)


def test_cli_smoke_on_cpu(capsys):
    snap = T_cli.main(["--device", "cpu", "--smoke", "--requests", "60"])
    out = capsys.readouterr().out
    assert "server-smoke OK" in out and "device=cpu" in out
    assert T.validate_snapshot(snap) == []
    assert J.validate_snapshot(snap) == []
    assert snap["requests_completed"] == 60 and snap["config"] == \
        "queue+prune"


def test_cli_mesh_is_not_ported():
    """``--mesh 2`` serves (item 9d), labelled as the reference labels
    it; tests/test_torch_server_mesh.py holds its responses."""
    snap = T_cli.main(["--device", "cpu", "--mesh", "2", "--requests", "20"])
    assert snap["config"] == "queue+prune+mesh2"
    assert T.validate_snapshot(snap) == [] == J.validate_snapshot(snap)
    assert snap["requests_completed"] == 20


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        T_cli.main(["--smoke"])
