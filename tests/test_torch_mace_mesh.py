"""MACE on a ``(data, model)`` mesh (``data/graphs.partition_graph``,
``dist.halo_rows`` / ``sum_to_owners`` / ``sum_partials_over_data``,
``MACE.placement``, ``MACE.local_batch`` and the Trainer's hook, the
CLIs) against the JAX reference, on the CPU.

The port's meshes are gloo processes started by
``repro_torch.launch.mesh.spawn``, each shape spawned once ((2, 1),
(4, 1), (1, 2), (2, 2)), every rank running every case.  The reference
runs on one device in this process: its own MACE fails on a mesh under
jax 0.9.0 (ROADMAP.md queue 3), so the anchor is its single-device
``train_loss`` and ``jax.grad`` on the whole graph.

Graphs (numpy, from seeds), at the smoke width (C = 8):
  * energy: 8 molecules of 10 atoms and 20 edges padded to 96 nodes and
    192 edges, so at D = 2 and 4 a molecule straddles two ranks' node
    blocks and a receiver's edges two edge blocks;
  * node_class: a random graph of 200 nodes and 600 edges padded to 256
    and 640, the loss on its first 120 nodes (as a sampled block's
    seeds).

Held (the leaf rule of tests/test_torch_mace.py's
``test_gradients_match_jax_grad``: each gradient leaf within 1e-5 of
its largest entry, or 1e-6 of the whole gradient's largest):
  * ``partition_graph`` without processes, on molecule and
    full_graph_sm as ``configs/mace_arch.make_batch`` builds them and on
    a sampled block of minibatch_lg's structure (64 seeds, fanouts 15
    and 10, the receivers its first rows): every edge in one block, the
    shares' senders and receivers the global ones, the halo and remote
    rows what the plan moves, the shares' segment sums reassembled the
    whole graph's (float64, within 1e-12);
  * every leaf's placement at S = 2 and 4 is the reference's
    ``resolve_axes`` of its axes (only the readout splits);
  * one step at each mesh, both heads: the loss and metrics within 1e-5
    relative of the reference's, the gradients summed over ``"data"``
    and gathered over ``"model"`` by the leaf rule;
  * three Trainer steps at each mesh, both heads: the losses within 1e-5
    relative of the reference's three adamw steps, run twice bit for
    bit (losses and every parameter);
  * at (2, 2): a checkpoint at step 2 resumed to step 3 bit for bit;
  * at (1, 2): ``serve`` within 1e-5 of the largest reference output;
  * the CLIs' refusals that remain: an elastic spec and
    ``--microbatches`` raise ``ValueError`` (a graph has no rows).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import resolve_axes as J_resolve
from repro.models import mace as J_mace
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch import dist as T_dist
from repro_torch.configs import mace_arch as T_arch
from repro_torch.data import graphs as T_graphs
from repro_torch.launch import mesh as M
from repro_torch.models import mace as T_mace
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt

SHAPES = {"2x1": (2, 1), "4x1": (4, 1), "1x2": (1, 2), "2x2": (2, 2)}
SPAWN_TIMEOUT = 300
LEAF, FLOOR, REL = 1e-5, 1e-6, 1e-5
STEPS, LR = 3, 3e-3
CFGS = {"energy": dict(n_layers=2, channels=8, lmax=2, correlation=3,
                       n_rbf=4, d_feat=5, head="energy", n_graphs=8,
                       r_cut=2.0, avg_neighbors=2.0),
        "node_class": dict(n_layers=2, channels=8, lmax=2, correlation=3,
                           n_rbf=4, d_feat=5, head="node_class",
                           n_classes=3, r_cut=3.0, avg_neighbors=2.5)}
METRIC = {"energy": "mae", "node_class": "acc"}


# -------------------------------------------------------------- graphs

def _pad(b, N, E):
    """``b`` padded to N nodes and E edges (zeros; pad edges 0 -> 0,
    masked), per-graph labels as they are."""
    out = {}
    for k, v in b.items():
        v = np.asarray(v)
        if k == "labels" and v.shape[0] != b["positions"].shape[0]:
            out[k] = v
            continue
        n = E if k in ("senders", "receivers", "edge_mask") else N
        pad = np.zeros((n,) + v.shape[1:], v.dtype)
        pad[:len(v)] = v
        out[k] = pad
    return out


def _graph(head):
    if head == "energy":
        return _pad(T_graphs.molecule_batch(0, batch=8, n_nodes=10,
                                            n_edges=20, d_feat=5), 96, 192)
    g = _pad(T_graphs.make_graph(T_graphs.GraphConfig(
        n_nodes=200, n_edges=600, d_feat=5, n_classes=3, seed=3)), 256, 640)
    g["node_mask"][120:] = 0.0
    return g


def _block(seeds=64):
    """minibatch_lg's structure, cut in scale: ``seeds`` seeds sampled
    with fanouts (15, 10) from a random graph of 20,000 nodes and
    1,000,000 edges, padded as ``pad_block`` pads the real shape, to
    multiples of 512."""
    g = T_graphs.make_graph(T_graphs.GraphConfig(
        n_nodes=20_000, n_edges=1_000_000, d_feat=4, n_classes=5, seed=1))
    indptr, nbrs = T_graphs.to_csr(g["senders"], g["receivers"], 20_000)
    rng = np.random.default_rng(1)
    ids = rng.choice(20_000, seeds, replace=False)
    send, recv, nodes = T_graphs.sample_block(indptr, nbrs, ids, (15, 10),
                                              rng)
    n = T_arch._pad512(seeds * (1 + 15 + 150))
    e = T_arch._pad512(seeds * (15 + 150))
    return T_graphs.pad_block(send, recv, nodes, g, n, e, seeds)


# ----------------------------------------------- partition_graph alone

@pytest.fixture(scope="module")
def structures():
    return {"molecule": T_arch.make_batch("molecule"),
            "full_graph_sm": T_arch.make_batch("full_graph_sm"),
            "minibatch_lg (64 seeds)": _block()}


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", ["molecule", "full_graph_sm",
                                  "minibatch_lg (64 seeds)"])
def test_partition_graph_reassembles_the_graph(structures, name, D):
    b = structures[name]
    N, E = len(b["positions"]), len(b["senders"])
    n, e = N // D, E // D
    head_graph = name == "molecule"
    shares = [T_graphs.partition_graph(b, D, d, graph_labels=head_graph)
              for d in range(D)]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, 3))                      # a node's row
    data = rng.standard_normal((E, 2))                   # an edge's row
    whole = np.zeros((N, 2))
    np.add.at(whole, b["receivers"], data)
    # the rows each rank receives: the halo along ``halo``, the partial
    # sums along ``owners`` (every rank's sends, routed by hand)
    partial = []
    for d, sh in enumerate(shares):
        ex = sh["exchange"]
        assert (ex.n_own, len(sh["senders"])) == (n, e)
        assert len(sh["positions"]) == n + ex.n_halo + ex.n_remote
        for k in T_graphs.OWN_FIELDS:
            assert np.array_equal(sh[k], b[k][d * n:(d + 1) * n]), k
        p = np.zeros((n + ex.n_remote, 2))
        np.add.at(p, sh["receivers"], data[d * e:(d + 1) * e])
        partial.append(p)
    for d, sh in enumerate(shares):
        ex = sh["exchange"]
        halo = np.zeros((ex.n_halo, 3))
        for j in range(D):
            sent = shares[j]["exchange"].halo.send[d]
            halo[ex.halo.recv[j]] = x[j * n + sent]
            assert len(sent) <= ex.halo.pad
        rows = np.concatenate([x[d * n:(d + 1) * n], halo])
        # the senders and receivers, through the local rows, are the
        # block's global ones (every edge in exactly one block)
        blk = slice(d * e, (d + 1) * e)
        assert np.array_equal(rows[sh["senders"]], x[b["senders"][blk]])
        pos = sh["positions"]
        pos_r = np.concatenate([pos[:n], pos[n + ex.n_halo:]])
        pos_s = pos[:n + ex.n_halo]
        assert np.array_equal(pos_r[sh["receivers"]],
                              b["positions"][b["receivers"][blk]])
        assert np.array_equal(pos_s[sh["senders"]],
                              b["positions"][b["senders"][blk]])
        assert np.array_equal(sh["edge_mask"], b["edge_mask"][blk])
        # the halo holds only senders another rank owns, each once
        ids = np.unique(b["senders"][blk])
        assert ex.n_halo == int(np.sum(ids // n != d))
        own = partial[d][:n].copy()
        for j in range(D):
            src = shares[j]["exchange"].owners.send[d]
            own[ex.owners.recv[j]] += partial[j][n + src]
            assert len(src) <= ex.owners.pad
        np.testing.assert_allclose(own, whole[d * n:(d + 1) * n],
                                   rtol=0, atol=1e-12)
        if head_graph:
            G = len(b["labels"])
            assert np.array_equal(sh["labels"], b["labels"])
            assert np.array_equal(np.flatnonzero(sh["label_mask"]),
                                  np.arange(d * G // D, (d + 1) * G // D))
    # the pads are the group's largest pair counts, the same on every rank
    assert len({s["exchange"].halo.pad for s in shares}) == 1
    assert len({s["exchange"].owners.pad for s in shares}) == 1


def test_partition_graph_keeps_a_graph_it_cannot_split():
    """D dividing neither N nor E: the rank keeps the whole graph."""
    b = _pad(T_graphs.molecule_batch(0, batch=3, n_nodes=10, n_edges=20,
                                     d_feat=5), 30, 60)
    got = T_graphs.partition_graph(b, 4, 1, graph_labels=True)
    assert "exchange" not in got and set(got) == set(b)
    assert all(np.array_equal(got[k], b[k]) for k in b)


# -------------------------------------------------------------- placement

@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("head", ["energy", "node_class"])
def test_placement_is_the_references(head, S):
    """Every leaf's placement is the reference's ``params_shardings``
    (``resolve_axes`` of its logical axes): only the readout splits, its
    layer 0's columns and bias and its layer 1's rows, layer 1's bias
    whole where S does not divide it."""
    import types
    jm = J_mace.MACE(J_mace.MACEConfig(**CFGS[head]))
    meta = jm.init_params(jax.random.PRNGKey(0))
    jmesh = types.SimpleNamespace(shape={"data": 1, "model": S})
    tm = T_mace.MACE(T_mace.MACEConfig(**CFGS[head]), device="cpu")
    mesh = M.HostMesh(1, S, rank=S - 1)
    got = dict(_paths(tm.placement(mesh)))
    split = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            meta, is_leaf=J_nn.is_param):
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        ref = tuple(J_resolve(leaf.axes, leaf.value.shape, jmesh))
        assert got.pop(key) == ref, key
        if "model" in ref:
            split.append(key)
    assert not got                              # no leaf the reference lacks
    assert sorted(split) == [("readout", "layers", 0, "b"),
                             ("readout", "layers", 0, "w"),
                             ("readout", "layers", 1, "w")]
    whole = {p: x.detach().clone() for p, x in _paths(tm.params())}
    specs = bridge.keep_local_blocks(tm, mesh)
    for path, x in _paths(tm.params()):
        assert torch.equal(x, T_dist.local_block(whole[path],
                                                 dict(_paths(specs))[path],
                                                 mesh)), path


# ----------------------------------------------------------- the worker
# (module-level, so spawned processes import it by name)

def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _key(path):
    return "/".join(map(str, path))


def _t_model(head, values):
    tm = T_mace.MACE(T_mace.MACEConfig(**CFGS[head]), device="cpu")
    bridge.load_values(tm, values)
    return tm


def _one_step(mesh, head, values, batch):
    """(loss, metric, {path: whole gradient}): this rank's share through
    the split model over the whole batch's counts, the data group's
    sum, the blocks gathered."""
    D = mesh.shape["data"]
    tm = _t_model(head, values)
    specs = bridge.keep_local_blocks(tm, mesh)
    p = tm.params()
    fn = T_loop.counted_loss(tm, mesh) if D > 1 else tm.train_loss
    with T_dist.use_mesh_rules(mesh, local_batch=D > 1):
        b = tm.local_batch(batch, mesh) if D > 1 else batch
        loss, mets = fn(p, b)
    leaves = [x for _, x in _paths(p)]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, got)]
    flat = T_loop.sum_over_ranks([loss.detach(), mets[METRIC[head]]]
                                 + grads, mesh)
    sp = dict(_paths(specs))
    return ([float(x) for x in flat[:2]],
            {_key(q): T_dist.gather_block(g, sp[q], mesh).numpy()
             for (q, _), g in zip(_paths(p), flat[2:])})


def _trainer(mesh, head, values, batch, ckpt_dir=None, steps=STEPS):
    tm = _t_model(head, values)
    tr = T_loop.Trainer(tm, T_opt.OptConfig(lr=LR), T_loop.TrainConfig(
        steps=steps, log_every=1, eval_every=0, ckpt_dir=ckpt_dir,
        ckpt_every=2), data_fn=lambda s: batch, mesh=mesh)
    params, hist = tr.run(params=tm.params())
    sp = dict(_paths(tr._specs)) if tr._specs is not None else {}
    whole = {_key(q): T_dist.gather_block(x.detach(), sp.get(q), mesh)
             .numpy() for q, x in _paths(params)}
    return [h["loss"] for h in hist if "loss" in h], whole


def _serve(mesh, head, values, batch):
    tm = _t_model(head, values)
    bridge.keep_local_blocks(tm, mesh)
    with T_dist.use_mesh_rules(mesh), torch.no_grad():
        return tm.serve(tm.params(), batch).numpy()


def _worker(mesh, inp_path, out_path):
    torch.set_num_threads(1)
    inp = torch.load(inp_path, weights_only=False)
    D, S = mesh.shape["data"], mesh.shape["model"]
    out = {}
    for head in CFGS:
        values, batch = inp[head]
        out[("one", head)] = _one_step(mesh, head, values, batch)
        first = _trainer(mesh, head, values, batch)
        again = _trainer(mesh, head, values, batch)
        out[("train", head)] = first[0]
        out[("bitwise", head)] = (again[0] == first[0] and all(
            np.array_equal(again[1][k], first[1][k]) for k in first[1]))
        if D == 1:
            out[("serve", head)] = _serve(mesh, head, values, batch)
        if (D, S) == (2, 2):
            # saved at step 2 (whole leaves), resumed to 3: the run's bits
            ck = {k: os.path.join(inp["ckpt_root"], f"{head}-{k}")
                  for k in "AB"}
            _trainer(mesh, head, values, batch, ck["B"], steps=2)
            resumed = _trainer(mesh, head, values, batch, ck["B"])
            out[("resumed", head)] = (resumed[0] == first[0][2:] and all(
                np.array_equal(resumed[1][k], first[1][k])
                for k in first[1]))
    comm = torch.tensor([mesh.comm["calls"]], dtype=torch.float64)
    out["calls"] = float(mesh.all_reduce(comm, ("data", "model"), "max"))
    if mesh.rank == 0:
        torch.save(out, out_path)


# ------------------------------------------------------------ fixtures

def _values(head):
    jm = J_mace.MACE(J_mace.MACEConfig(**CFGS[head]))
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, jax.tree.map(np.asarray, J_nn.values(jp))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh shape's results, each spawned once."""
    root = tmp_path_factory.mktemp("mace_mesh")
    inp = {head: (_values(head)[2], _graph(head)) for head in CFGS}
    inp["ckpt_root"] = str(root / "ckpt")
    path = str(root / "inputs.pt")
    torch.save(inp, path)
    out = {}
    for name, (D, S) in SHAPES.items():
        res = str(root / f"{name}.pt")
        M.spawn(_worker, D * S, (path, res), model=S, timeout=SPAWN_TIMEOUT)
        out[name] = torch.load(res, weights_only=False)
    return out


def _j_flat(g):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(g)}


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device step (loss, metric, gradient) and
    three adamw steps' losses, per head, on the whole graph."""
    out = {}
    for head in CFGS:
        jm, jp, values = _values(head)
        jb = {k: jnp.asarray(v) for k, v in _graph(head).items()}

        def loss(v, jm=jm, jp=jp, jb=jb):
            return jm.train_loss(J_nn.with_values(jp, v), jb)
        step = jax.jit(jax.value_and_grad(loss, has_aux=True))
        v = jax.tree.map(jnp.asarray, values)
        (val, mets), g = step(v)
        one = ([float(val), float(mets[METRIC[head]])], _j_flat(g))
        cfg = J_opt.OptConfig(lr=LR)
        st = J_opt.init_opt_state(v)
        losses = []
        for _ in range(STEPS):
            (val, _), g = step(v)
            v, st, _ = J_opt.apply_updates(cfg, st, v, g)
            losses.append(float(val))
        serve = np.asarray(jax.jit(lambda vv, jm=jm, jp=jp, jb=jb: jm.serve(
            J_nn.with_values(jp, vv), jb))(jax.tree.map(jnp.asarray,
                                                       values)))
        out[head] = {"one": one, "train": losses, "serve": serve}
    return out


# ------------------------------------------------------------- the tests

def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("head", list(CFGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_one_step_matches_jax_grad(runs, reference, shape, head):
    (loss, metric), grads = runs[shape][("one", head)]
    (jloss, jmetric), jgrads = reference[head]["one"]
    assert _rel(loss, jloss) <= REL
    assert _rel(metric, jmetric) <= REL
    assert set(grads) == set(jgrads)
    floor = FLOOR * max(float(np.abs(w).max()) for w in jgrads.values())
    for k, want in jgrads.items():
        tol = max(LEAF * float(np.abs(want).max()), floor)
        assert np.abs(grads[k] - want).max() <= tol, k


@pytest.mark.parametrize("head", list(CFGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_trainer_matches_reference_and_itself(runs, reference, shape, head):
    got, want = runs[shape][("train", head)], reference[head]["train"]
    assert len(got) == STEPS
    for a, b in zip(got, want):
        assert _rel(a, b) <= REL, (got, want)
    assert runs[shape][("bitwise", head)]


@pytest.mark.parametrize("head", list(CFGS))
def test_checkpoint_resumes_on_a_mesh(runs, head):
    """At (2, 2): two steps saved (the readout's blocks gathered whole),
    then resumed to the third: its loss and every parameter the
    uninterrupted run's, bit for bit."""
    assert runs["2x2"][("resumed", head)]


@pytest.mark.parametrize("head", list(CFGS))
def test_serve_on_the_model_axis(runs, reference, head):
    got, want = runs["1x2"][("serve", head)], reference[head]["serve"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", ["2x1", "4x1", "2x2"])
def test_shares_exchange_rows(runs, shape):
    """A data group moved rows: every rank ran its collectives."""
    assert runs[shape]["calls"] > 0


@pytest.mark.parametrize("flags", [
    ["--grad-compression", "int8", "--grad-accum-shards", "2"],
    ["--microbatches", "2"]])
def test_cli_refuses_to_cut_a_graph_into_rows(flags):
    from repro_torch.launch import train as T_cli
    with pytest.raises(ValueError, match="graph batch, which has no rows"):
        T_cli.main(["--arch", "mace", "--device", "cpu", "--steps", "1",
                    *flags])


def test_share_collectives_need_a_data_group():
    b = T_graphs.partition_graph(_graph("energy"), 2, 0, graph_labels=True)
    tm = T_mace.MACE(T_mace.MACEConfig(**CFGS["energy"]), device="cpu")
    with pytest.raises(ValueError, match="'data' group"):
        tm.train_loss(tm.params(), b)


def test_a_whole_graph_counted_on_each_rank_sums_to_its_loss():
    """Where D divides neither N nor E each of the D ranks keeps the whole
    graph: its loss over the data group's counts (``loss_counts`` of a
    whole batch, summed over D ranks) is a D-th of the whole loss."""
    for head in CFGS:
        tm = _t_model(head, _values(head)[2])
        b = _graph(head)
        whole, _ = tm.train_loss(tm.params(), b)
        counts = {k: 3 * torch.as_tensor(v).to(torch.int64)
                  for k, v in tm.loss_counts(b).items()}
        with T_dist.use_loss_counts(counts):
            part, _ = tm.train_loss(tm.params(), b)
        assert _rel(3 * float(part.detach()), float(whole.detach())) <= 1e-6, head
