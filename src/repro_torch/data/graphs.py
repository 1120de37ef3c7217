"""Synthetic graphs + a real fanout neighbour sampler (GraphSAGE-style),
the reference's ``data/graphs.py`` (numpy; every output is the
reference's, bit for bit, for a seed).

Graph cells of the MACE arch:
  full_graph_sm / ogb_products : one big graph, node classification
  minibatch_lg                 : sampled blocks from a big graph
  molecule                     : batched small radius graphs, energy head

Labels are planted functions of (positions, features) so training has
signal.  Positions are synthetic for the non-3D datasets.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphConfig:
    n_nodes: int = 2708
    n_edges: int = 10556
    d_feat: int = 64
    n_classes: int = 7
    seed: int = 0


def make_graph(cfg: GraphConfig):
    """Random graph with clustered positions -> learnable node labels."""
    rng = np.random.default_rng(cfg.seed)
    pos = rng.standard_normal((cfg.n_nodes, 3)).astype(np.float32)
    feats = rng.standard_normal((cfg.n_nodes, cfg.d_feat)) \
        .astype(np.float32)
    send = rng.integers(0, cfg.n_nodes, cfg.n_edges)
    recv = rng.integers(0, cfg.n_nodes, cfg.n_edges)
    w = rng.standard_normal((cfg.d_feat, cfg.n_classes))
    labels = np.argmax(feats @ w + 0.5 * rng.standard_normal(
        (cfg.n_nodes, cfg.n_classes)), 1)
    return {
        "positions": pos, "features": feats,
        "senders": send.astype(np.int32), "receivers": recv.astype(np.int32),
        "edge_mask": np.ones(cfg.n_edges, np.float32),
        "node_mask": np.ones(cfg.n_nodes, np.float32),
        "graph_id": np.zeros(cfg.n_nodes, np.int32),
        "labels": labels.astype(np.int32),
    }


def to_csr(senders, receivers, n_nodes):
    order = np.argsort(receivers, kind="stable")
    s, r = senders[order], receivers[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, s


def sample_block(indptr, neighbors, seeds, fanouts, rng):
    """GraphSAGE fanout sampling. Returns a padded block:
    (senders, receivers, edge_mask, nodes) where receivers index into the
    block's node list; seeds are nodes[:len(seeds)]."""
    nodes = list(seeds)
    node_pos = {int(n): i for i, n in enumerate(seeds)}
    send, recv = [], []
    frontier = list(seeds)
    for fanout in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = indptr[v], indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            k = min(fanout, deg)
            sel = neighbors[lo + rng.choice(deg, k, replace=False)]
            for u in sel:
                u = int(u)
                if u not in node_pos:
                    node_pos[u] = len(nodes)
                    nodes.append(u)
                send.append(node_pos[u])
                recv.append(node_pos[v])
            nxt.extend(int(u) for u in sel)
        frontier = nxt
    return (np.asarray(send, np.int32), np.asarray(recv, np.int32),
            np.asarray(nodes, np.int64))


def pad_block(send, recv, nodes, graph, max_nodes, max_edges, seeds_n):
    """Fixed-shape batch dict for the sampled block."""
    n, e = len(nodes), len(send)
    n = min(n, max_nodes)
    sel = (send < n) & (recv < n)
    send, recv = send[sel][:max_edges], recv[sel][:max_edges]
    e = len(send)
    nodes = nodes[:n]
    batch = {
        "positions": np.zeros((max_nodes, 3), np.float32),
        "features": np.zeros((max_nodes, graph["features"].shape[1]),
                             np.float32),
        "senders": np.zeros(max_edges, np.int32),
        "receivers": np.zeros(max_edges, np.int32),
        "edge_mask": np.zeros(max_edges, np.float32),
        "node_mask": np.zeros(max_nodes, np.float32),
        "graph_id": np.zeros(max_nodes, np.int32),
        "labels": np.zeros(max_nodes, np.int32),
    }
    batch["positions"][:n] = graph["positions"][nodes]
    batch["features"][:n] = graph["features"][nodes]
    batch["senders"][:e] = send
    batch["receivers"][:e] = recv
    batch["edge_mask"][:e] = 1.0
    batch["node_mask"][:min(seeds_n, n)] = 1.0   # loss on seed nodes only
    batch["labels"][:n] = graph["labels"][nodes]
    return batch


def molecule_batch(step: int, *, batch: int = 128, n_nodes: int = 30,
                   n_edges: int = 64, d_feat: int = 4, seed: int = 0):
    """Batched small radius-graphs with a planted energy function."""
    rng = np.random.default_rng((seed, 5, step))
    G = batch
    N, E = n_nodes, n_edges
    pos = rng.standard_normal((G, N, 3)).astype(np.float32) * 0.5
    feats = rng.standard_normal((G, N, d_feat)).astype(np.float32)
    # radius-ish edges: k nearest pairs per graph, truncated to E
    send = np.zeros((G, E), np.int64)
    recv = np.zeros((G, E), np.int64)
    for g in range(G):
        d = np.linalg.norm(pos[g][:, None] - pos[g][None], axis=-1)
        np.fill_diagonal(d, np.inf)
        idx = np.argsort(d.ravel())[:E]
        send[g], recv[g] = idx // N, idx % N
    # planted energy: sum of pairwise 1/r over edges + feature term
    r = np.linalg.norm(
        np.take_along_axis(pos, recv[..., None], 1)
        - np.take_along_axis(pos, send[..., None], 1), axis=-1)
    energy = np.sum(1.0 / np.maximum(r, 0.3), -1) * 0.05 \
        + feats.sum((1, 2)) * 0.01
    # flatten to one disjoint graph
    offs = (np.arange(G) * N)[:, None]
    return {
        "positions": pos.reshape(G * N, 3),
        "features": feats.reshape(G * N, d_feat),
        "senders": (send + offs).reshape(-1).astype(np.int32),
        "receivers": (recv + offs).reshape(-1).astype(np.int32),
        "edge_mask": np.ones(G * E, np.float32),
        "node_mask": np.ones(G * N, np.float32),
        "graph_id": np.repeat(np.arange(G, dtype=np.int32), N),
        "labels": energy.astype(np.float32),
    }
