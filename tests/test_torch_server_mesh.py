"""The request server under ``--mesh S`` (``launch/server.py``,
``serve.RetrievalServer(mesh=)`` and ``serve.server.follow``) on spawned gloo
CPU processes, against the port's unsharded server and the reference's
``--mesh`` CLI.

Each run serves the two-tower-retrieval-jpq smoke model's seeded request
stream on a virtual clock (so the batches that flush are a function of
the arrivals alone), with a catalogue publish after 30 requests: a new
version of the same codes in a random sweep order.  Held, at S = 2 and
4 and for the pruned default, ``--prune --perm --warm`` (rank 0's warm
floors broadcast with each batch) and ``--no-prune``:
  * rank 0 flushes the batches the unsharded server flushes, each on
    the same catalogue version, and every response's ids and values are
    bit-equal to the unsharded server's;
  * every other rank serves the same batches on the same versions
    (``follow``'s log) as rank 0;
  * none dropped or duplicated, the snapshot valid and its config the
    unsharded one's plus ``+mesh{S}``;
  * with a non-blocking publish (the swap's timing then depends on the
    build thread) the responses are still bit-equal and every batch is
    served on every rank with the same version.
Then ``--smoke`` on the CPU at S = 2 and 4, and the snapshot's keys and
config against the reference's ``--mesh 2 --smoke --json``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_bundle
from repro_torch.launch import mesh as M
from repro_torch.launch import server as T_cli
from repro_torch.serve import VirtualClock, validate_snapshot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUESTS, SWAP_AT = 60, 30
FLAGS = {"pruned": [], "warm": ["--prune", "--perm", "--warm"],
         "unpruned": ["--no-prune"]}
SPAWN_TIMEOUT = 200


def _args(flags):
    return T_cli.build_parser().parse_args(
        ["--device", "cpu", "--requests", str(REQUESTS), "--rate", "500",
         "--max-batch", "8", "--max-delay-ms", "5", "--seed", "0", *flags])


def _serve_worker(mesh, out, name, flags, block):
    """One rank of a run: the smoke model (this rank's rows on a mesh),
    ``serve_requests`` on a virtual clock with a publish after
    ``SWAP_AT`` requests.  Rank 0 saves its snapshot, the batches it
    served (request ids, version, bucket) and every response; any other
    rank its ``follow`` log."""
    torch.set_num_threads(1)
    args = _args(flags)
    S = mesh.world_size
    if S > 1:
        args.mesh = S
    model, _ = get_bundle(args.arch).make_smoke(device="cpu")
    if S > 1:
        bridge.keep_local_rows(model, mesh)
    served, servers = [], []

    def on_ready(server):
        servers.append(server)
        submit, serve = server.submit, server.pool.serve
        live = server.registry.live()
        perm = np.random.default_rng(1).permutation(live.codes.shape[0])

        def record(batch, version, *floor):
            served.append([[r.rid for r in batch.requests],
                           version.version, batch.bucket_len])
            return serve(batch, version, *floor)

        def submit_then_swap(hist):
            if server.metrics._submitted == SWAP_AT:
                server.registry.publish(live.codes, live.b, perm=perm,
                                        block=block)
            return submit(hist)

        server.pool.serve, server.submit = record, submit_then_swap

    snap, _ = T_cli.serve_requests(model, model.params(), args,
                                   on_ready=on_ready,
                                   mesh=mesh if S > 1 else None,
                                   clock=VirtualClock())
    if mesh.rank != 0:                  # the follow log: (version, rids)
        with open(os.path.join(out, f"{name}-r{mesh.rank}.json"), "w") as f:
            json.dump([[v, [int(r) for r in rids]] for v, rids in snap], f)
        return
    # each response as int32 words: the values' bits, the ids, the version
    np.savez(os.path.join(out, f"{name}-results.npz"), **{
        str(rid): np.concatenate([r.values.view(np.int32), r.ids,
                                  [r.version]]).astype(np.int32)
        for rid, r in servers[0].results.items()})
    with open(os.path.join(out, f"{name}-r0.json"), "w") as f:
        json.dump({"snapshot": snap, "served": served}, f)


def _load(out, name):
    with open(os.path.join(out, f"{name}-r0.json")) as f:
        got = json.load(f)
    with np.load(os.path.join(out, f"{name}-results.npz")) as z:
        got["results"] = {int(k): z[k] for k in z.files}
    return got


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The port's unsharded server (a world of one), each configuration,
    the publish blocking."""
    out = str(tmp_path_factory.mktemp("unsharded"))
    for cfg, flags in FLAGS.items():
        M.spawn(_serve_worker, 1, (out, cfg, flags, True),
                timeout=SPAWN_TIMEOUT)
    return {cfg: _load(out, cfg) for cfg in FLAGS}


def _check_followers(out, name, S, served):
    """Every other rank served rank 0's batches on rank 0's versions."""
    want = [[v, rids] for rids, v, _ in served]
    for r in range(1, S):
        with open(os.path.join(out, f"{name}-r{r}.json")) as f:
            assert json.load(f) == want, (name, r)


def _check_snapshot(snap, S, n=REQUESTS):
    assert validate_snapshot(snap) == []
    assert snap["requests_submitted"] == snap["requests_completed"] == n
    assert snap["requests_dropped"] == snap["requests_duplicated"] == 0
    assert snap["config"].endswith(f"+mesh{S}")


@pytest.mark.parametrize("cfg", list(FLAGS))
@pytest.mark.parametrize("S", [2, 4])
def test_mesh_server_equals_the_unsharded_server(unsharded, tmp_path, S,
                                                 cfg):
    out = str(tmp_path)
    M.spawn(_serve_worker, S, (out, cfg, FLAGS[cfg], True), model=S,
            timeout=SPAWN_TIMEOUT)
    got, want = _load(out, cfg), unsharded[cfg]
    _check_snapshot(got["snapshot"], S)
    assert got["snapshot"]["config"] == \
        want["snapshot"]["config"] + f"+mesh{S}"
    assert got["snapshot"]["catalogue_swaps"] == 1
    assert got["served"] == want["served"]        # batches and versions
    assert {v for _, v, _ in got["served"]} == {1, 2}
    assert got["results"].keys() == want["results"].keys()
    for rid, res in want["results"].items():
        assert np.array_equal(got["results"][rid], res), rid
    _check_followers(out, cfg, S, got["served"])


def test_mesh_server_non_blocking_swap(unsharded, tmp_path):
    """The publish on rank 0's build thread: the swap lands when it
    lands, every rank follows rank 0's versions, the responses are the
    unsharded server's."""
    out, S = str(tmp_path), 2
    M.spawn(_serve_worker, S, (out, "pruned", FLAGS["pruned"], False),
            model=S, timeout=SPAWN_TIMEOUT)
    got, want = _load(out, "pruned"), unsharded["pruned"]
    _check_snapshot(got["snapshot"], S)
    assert [(r, b) for r, _, b in got["served"]] == \
        [(r, b) for r, _, b in want["served"]]
    for rid, res in want["results"].items():
        assert np.array_equal(got["results"][rid][:-1], res[:-1]), rid
    _check_followers(out, "pruned", S, got["served"])


@pytest.mark.parametrize("S", [2, 4])
def test_cli_mesh_smoke_on_cpu(S, capfd):
    snap = T_cli.main(["--device", "cpu", "--mesh", str(S), "--smoke",
                       "--requests", "40", "--prune", "--perm", "--warm"])
    out = capfd.readouterr().out
    assert "server-smoke OK" in out
    assert f"queue+prune+perm+warm+mesh{S} n=40" in out
    _check_snapshot(snap, S, 40)


def _json_of(stdout):
    return json.loads(stdout[stdout.index("{"):stdout.rindex("}") + 1])


def test_snapshot_keys_and_config_match_the_references_mesh_cli():
    """``--mesh 2 --smoke --json``: the reference's CLI (one process over
    two host devices) and the port's (two ranks) print snapshots with
    the same keys, nested keys and config name."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    flags = ["--mesh", "2", "--smoke", "--requests", "30", "--json"]
    runs = {}
    for pkg, extra in (("repro", []), ("repro_torch", ["--device", "cpu"])):
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.server", *flags, *extra],
            env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "server-smoke OK" in r.stdout
        runs[pkg] = _json_of(r.stdout)
    j, t = runs["repro"], runs["repro_torch"]
    assert j["config"] == t["config"] == "queue+prune+mesh2"
    assert sorted(j) == sorted(t)
    for k, v in j.items():
        if isinstance(v, dict):
            assert sorted(v) == sorted(t[k]), k
