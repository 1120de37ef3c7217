"""mace [arXiv:2206.07697]: 2L C=128 l_max=2 correlation=3 n_rbf=8, the
reference's ``configs/mace_arch.py`` less its XLA dry-run cells.

Four graph shapes; each needs its own head/feature width, so
``make_model(shape=...)`` is shape-aware.  Node/edge counts are padded
to multiples of 512 (masks carry validity).  The batch specs are plain
``(shape, dtype)`` data (``graph_specs``), and ``make_batch`` builds a
shape's padded batch on the host:
  molecule       128 molecules of 30 atoms and 64 edges (energy head)
  full_graph_sm  a Cora-sized graph, 2,708 nodes, 10,556 edges, 7 classes
  minibatch_lg   1,024 seeds sampled with fanouts (15, 10) from a
                 Reddit-sized graph (232,965 nodes, 41 classes) whose
                 edge count is cut to ``REDDIT_EDGES`` (every fanout
                 still fills)
  ogb_products   2,449,029 nodes and 61,859,140 edges: raises, since no
                 mesh of one card or four holds it at full width (its
                 messages alone are 158.4 GB a path in fp32)
RecJPQ is inapplicable here (no id-embedding table).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchBundle
from repro_torch.data.graphs import (GraphConfig, make_graph, molecule_batch,
                                     pad_block, sample_block, to_csr)
from repro_torch.models.mace import MACE, MACEConfig


def _pad512(x: int) -> int:
    return (x + 511) // 512 * 512


# shape -> (n_nodes, n_edges, d_feat, head, n_classes, n_graphs)
SHAPES = {
    "full_graph_sm": (_pad512(2708), _pad512(10556), 1433,
                      "node_class", 7, 1),
    "minibatch_lg": (_pad512(1024 * (1 + 15 + 150)),
                     _pad512(1024 * 15 + 1024 * 150), 602,
                     "node_class", 41, 1),
    "ogb_products": (_pad512(2_449_029), _pad512(61_859_140), 100,
                     "node_class", 47, 1),
    "molecule": (_pad512(128 * 30), _pad512(128 * 64), 16,
                 "energy", 0, 128),
}

# minibatch_lg's source graph: Reddit's nodes; 50 edges a node on
# average (Reddit has ~114.6M, ~492 a node) keep every receiver's
# in-degree above the fanouts, so each of the 1,024 seeds and its
# sampled neighbours take their full 15 and 10
REDDIT_NODES = 232_965
REDDIT_EDGES = 50 * REDDIT_NODES
SEEDS, FANOUTS = 1024, (15, 10)


def model_cfg(shape: str) -> MACEConfig:
    n, e, f, head, ncls, ng = SHAPES[shape]
    return MACEConfig(n_layers=2, channels=128, lmax=2, correlation=3,
                      n_rbf=8, d_feat=f, head=head, n_classes=ncls,
                      n_graphs=ng, avg_neighbors=max(e / max(n, 1), 1.0))


def graph_specs(shape: str) -> dict:
    """{field: (shape, numpy dtype)} of a shape's padded batch."""
    n, e, f, head, ncls, ng = SHAPES[shape]
    specs = {
        "positions": ((n, 3), np.float32),
        "features": ((n, f), np.float32),
        "senders": ((e,), np.int32),
        "receivers": ((e,), np.int32),
        "edge_mask": ((e,), np.float32),
        "node_mask": ((n,), np.float32),
        "graph_id": ((n,), np.int32),
    }
    specs["labels"] = ((ng,), np.float32) if head == "energy" \
        else ((n,), np.int32)
    return specs


def pad_graph(batch: dict, shape: str) -> dict:
    """A whole-graph batch padded to ``shape``'s node and edge counts:
    zeros beyond the real rows (pad edges 0 -> 0, masks 0); the energy
    head's per-graph labels stay as they are."""
    out = {}
    for k, (want, dt) in graph_specs(shape).items():
        v = np.asarray(batch[k])
        if v.shape[0] > want[0] or v.shape[1:] != want[1:]:
            raise ValueError(f"{k} {v.shape} does not fit {shape}'s "
                             f"{want}")
        pad = np.zeros(want, dt)
        pad[:v.shape[0]] = v
        out[k] = pad
    return out


def make_batch(shape: str, seed: int = 0) -> dict:
    """``shape``'s padded batch as numpy arrays (``graph_specs``), made
    from ``seed`` on the host."""
    if shape == "ogb_products":
        raise NotImplementedError(
            "ogb_products needs more cards than a run has: padded to "
            "2,449,408 nodes and 61,859,328 edges, one l = 2 message [E, "
            "C, 5] is 158.4 GB in fp32 (9.9 GB in a 1/16 share, and a "
            "training step holds several a path and layer), so no D that "
            "one card or four hold runs it at full width; the reference "
            "never executes it either (only its dry run's cells, which "
            "the port leaves out)")
    n, e, f, head, ncls, ng = SHAPES[shape]
    if shape == "molecule":
        return pad_graph(molecule_batch(seed, batch=ng, n_nodes=30,
                                        n_edges=64, d_feat=f), shape)
    if shape == "full_graph_sm":
        return pad_graph(make_graph(GraphConfig(
            n_nodes=2708, n_edges=10556, d_feat=f, n_classes=ncls,
            seed=seed)), shape)
    graph = make_graph(GraphConfig(n_nodes=REDDIT_NODES,
                                   n_edges=REDDIT_EDGES, d_feat=f,
                                   n_classes=ncls, seed=seed))
    indptr, neighbors = to_csr(graph["senders"], graph["receivers"],
                               REDDIT_NODES)
    rng = np.random.default_rng(seed)
    seeds = rng.choice(REDDIT_NODES, SEEDS, replace=False)
    send, recv, nodes = sample_block(indptr, neighbors, seeds, FANOUTS, rng)
    return pad_block(send, recv, nodes, graph, n, e, SEEDS)


SMOKE = MACEConfig(n_layers=2, channels=8, lmax=2, correlation=3,
                   n_rbf=4, d_feat=4, head="energy", n_graphs=4,
                   r_cut=2.0, avg_neighbors=2.0)


def smoke_batch() -> dict:
    """The reference's smoke batch: 4 molecules of 8 atoms, 12 edges."""
    return molecule_batch(0, batch=4, n_nodes=8, n_edges=12, d_feat=4)


def bundle() -> ArchBundle:
    def _gen(device, seed):
        dev = resolve_device(device)
        return dev, torch.Generator(device=dev).manual_seed(int(seed))

    def make_model(device="cuda", seed: int = 0, shape: str = "molecule",
                   **changes):
        """The published config of ``shape`` (``changes`` replace its
        fields), random weights from ``seed``."""
        dev, gen = _gen(device, seed)
        return MACE(dataclasses.replace(model_cfg(shape), **changes),
                    generator=gen, device=dev)

    def make_smoke(device="cuda", seed: int = 0):
        dev, gen = _gen(device, seed)
        return MACE(SMOKE, generator=gen, device=dev), smoke_batch()

    return ArchBundle(name="mace", family="gnn", make_model=make_model,
                      make_smoke=make_smoke,
                      description="E(3)-equivariant higher-order MPNN",
                      config=model_cfg("molecule"))
