"""Synthetic graphs + a real fanout neighbour sampler (GraphSAGE-style),
the reference's ``data/graphs.py`` (numpy; every output is the
reference's, bit for bit, for a seed).

Graph cells of the MACE arch:
  full_graph_sm / ogb_products : one big graph, node classification
  minibatch_lg                 : sampled blocks from a big graph
  molecule                     : batched small radius graphs, energy head

Labels are planted functions of (positions, features) so training has
signal.  Positions are synthetic for the non-3D datasets.

``partition_graph`` (the port's own) cuts a padded batch into one data
rank's share for MACE on a mesh: the ``"nodes"`` and ``"edges"`` axes
split into contiguous blocks by position, as the reference's
``_graph_specs`` places them, and the rows a share reads or writes on
other ranks as two ``Route``s of an all-to-all.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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


# ------------------------------------------------------- a rank's share
# The fields of a share that hold a row of each node the rank owns
OWN_FIELDS = ("features", "node_mask", "graph_id")


@dataclasses.dataclass(frozen=True)
class Route:
    """One all-to-all of rows over a data group of D ranks: this rank
    sends ``src[send[j]]`` to rank j, and the rows rank j sends land on
    ``dst[recv[j]]``; every slot is padded to ``pad`` rows, the largest
    count of any pair of ranks in the group (so each rank computes the
    same ``pad``).  ``send_slots``: the source row of each of the ``D *
    pad`` slots (0 at a pad slot); ``recv_slots``: for a route that fills
    every destination row once, in order, the slot each row comes from
    (else None)."""
    send: tuple
    recv: tuple
    pad: int
    send_slots: object
    recv_slots: object

    @classmethod
    def of(cls, send, recv, pad: int) -> "Route":
        D = len(send)
        slots = np.zeros(D * pad, np.int64)
        for j, rows in enumerate(send):
            slots[j * pad:j * pad + len(rows)] = rows
        pos = np.concatenate([j * pad + np.arange(len(rows), dtype=np.int64)
                              for j, rows in enumerate(recv)])
        flat = np.concatenate(recv)
        ordered = np.array_equal(flat, np.arange(len(flat)))
        return cls(tuple(send), tuple(recv), int(pad), slots,
                   pos if ordered else None)

    def reversed(self) -> "Route":
        """The route back: each row returns to where it came from."""
        return Route.of(self.recv, self.send, self.pad)

    @property
    def counts(self) -> tuple:
        """Rows that arrive from each rank."""
        return tuple(len(r) for r in self.recv)

    def map(self, fn: Callable) -> "Route":
        """The route with ``fn`` applied to each index array (the model
        moves them to its device once a batch)."""
        return Route(tuple(map(fn, self.send)), tuple(map(fn, self.recv)),
                     self.pad, fn(self.send_slots),
                     None if self.recv_slots is None
                     else fn(self.recv_slots))


@dataclasses.dataclass(frozen=True)
class Exchange:
    """The plan of one rank's share of a graph.  Its local rows: the
    ``n_own`` nodes it owns, then ``n_halo`` halo rows (senders of its
    edges that other ranks own), then ``n_remote`` remote receiver rows
    (receivers of its edges that other ranks own).  ``halo``: own rows
    to the halo block of the ranks that read them; ``owners``: the
    remote block's partial sums to the own rows of their owners."""
    n_own: int
    n_halo: int
    n_remote: int
    halo: Route
    owners: Route
    halo_back: Route
    owners_back: Route

    @classmethod
    def of(cls, n_own, n_halo, n_remote, halo, owners) -> "Exchange":
        return cls(n_own, n_halo, n_remote, halo, owners, halo.reversed(),
                   owners.reversed())

    def map(self, fn: Callable) -> "Exchange":
        return dataclasses.replace(
            self, **{k: getattr(self, k).map(fn) for k in
                     ("halo", "owners", "halo_back", "owners_back")})


def partition_graph(batch: dict, D: int, d: int, *,
                    graph_labels: bool) -> dict:
    """Rank ``d``'s share of a padded graph ``batch`` (numpy arrays or
    tensors) on a data group of ``D`` ranks, as numpy arrays:

      * its nodes ``[d·N/D, (d+1)·N/D)`` and its edges ``[d·E/D,
        (d+1)·E/D)``, both by position (the reference's ``"nodes"`` and
        ``"edges"`` blocks), the edges in their global order;
      * ``features``, ``node_mask``, ``graph_id`` of its own rows;
        ``positions`` of every local row (own, halo, remote), so the
        edge geometry needs no exchange;
      * ``senders`` into the own ++ halo rows, ``receivers`` into the
        own ++ remote rows, ``edge_mask`` of its edges;
      * ``labels``: a node label for each own row, or with
        ``graph_labels`` the whole ``[G]`` and ``label_mask``, 1 on the
        block of ``G/D`` graphs this rank scores (``[d·G//D,
        (d+1)·G//D)``);
      * ``exchange``: the ``Exchange`` plan.

    Where D does not divide N or E the rank keeps the whole graph (the
    batch as numpy, no ``exchange``), as the reference's best-effort
    placement replicates an axis it cannot split."""
    b = {k: _host(v) for k, v in batch.items()}
    N, E = len(b["positions"]), len(b["senders"])
    if D <= 1 or N % D or E % D:
        return b
    n, e = N // D, E // D
    send = b["senders"].astype(np.int64)
    recv = b["receivers"].astype(np.int64)
    halos, remotes = [], []
    for a in range(D):
        s, r = send[a * e:(a + 1) * e], recv[a * e:(a + 1) * e]
        # sorted by node, so grouped by owner in rank order
        halos.append(np.unique(s[s // n != a]))
        remotes.append(np.unique(r[r // n != a]))

    def pad_of(sets):
        return max(int(np.bincount(x // n, minlength=D).max()) if len(x)
                   else 0 for x in sets)

    def owned_by(x, j):
        return x[x // n == j]

    lo = d * n
    halo, remote = halos[d], remotes[d]
    nh, nr = len(halo), len(remote)
    # halo: own rows -> the halo blocks of the ranks that read them
    h_send = [owned_by(halos[j], d) - lo if j != d else _empty()
              for j in range(D)]
    h_recv = [np.flatnonzero(halo // n == j) for j in range(D)]
    # owners: the remote block's partial sums -> their owners' rows
    o_send = [np.flatnonzero(remote // n == j) for j in range(D)]
    o_recv = [owned_by(remotes[j], d) - lo if j != d else _empty()
              for j in range(D)]
    ex = Exchange.of(n, nh, nr, Route.of(h_send, h_recv, pad_of(halos)),
                     Route.of(o_send, o_recv, pad_of(remotes)))
    s, r = send[d * e:(d + 1) * e], recv[d * e:(d + 1) * e]
    out = {
        "positions": np.concatenate([b["positions"][lo:lo + n],
                                     b["positions"][halo],
                                     b["positions"][remote]]),
        "senders": np.where(s // n == d, s - lo,
                            n + np.searchsorted(halo, s)).astype(np.int32),
        "receivers": np.where(r // n == d, r - lo,
                              n + np.searchsorted(remote, r)).astype(
                                  np.int32),
        "edge_mask": b["edge_mask"][d * e:(d + 1) * e],
        **{k: b[k][lo:lo + n] for k in OWN_FIELDS},
        "exchange": ex}
    if graph_labels:
        G = len(b["labels"])
        mask = np.zeros(G, np.float32)
        mask[d * G // D:(d + 1) * G // D] = 1.0
        out.update(labels=b["labels"], label_mask=mask)
    elif "labels" in b:
        out["labels"] = b["labels"][lo:lo + n]
    return out


def _host(v):
    """A numpy view of ``v`` (a tensor is copied to the host)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _empty():
    return np.zeros(0, np.int64)
