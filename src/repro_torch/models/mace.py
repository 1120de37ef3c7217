"""MACE: higher-order E(3)-equivariant message passing (arXiv:2206.07697),
the reference's ``models/mace.py``.

Message passing is gather (edge endpoints) -> per-edge dense math ->
segment sum, as the reference's; the generalized Clebsch-Gordan
contractions are iterated pairwise products through exact real-Gaunt
intertwiners (``models/equivariant.py``).  RecJPQ is inapplicable here
(no large id-embedding table).

The sums and gathers run through the embedding_bag backward kernels
(``kernels/embedding_bag/ops``; deterministic, no float atomics):
  * each path's sum over receivers and the energy head's sum over
    graphs are ``ops.segment_sum`` (the kernels forward; their backward
    is a plain gather);
  * the sender gathers ``h[l1][send]`` are ``ops.gather`` on the
    ``[N, C·(2l1+1)]`` view, whose gradient is the kernels'.
One order a batch for the senders, the receivers and the graph ids
(``ops.segment_order``) serves every one of those calls, so a step
sorts each once.  Each layer gathers ``h[l1]`` once for all its paths
from l1 (the reference takes it a path; XLA computes it once).  A
step's gradients are the same bits run to run.

On a ``(data, model)`` mesh MACE is placed as the reference places it
(``param_axes``: every weight whole but the readout, whose layer 0's
columns and layer 1's rows split over ``"model"``; ``nn.layers.mlp``
runs it tensor-parallel).  Over ``"data"`` each rank holds its share of
the graph (``local_batch``: ``data.graphs.partition_graph``, the
reference's ``"nodes"`` and ``"edges"`` blocks), which stands for the
reference's ``dist.constrain`` of A and of a layer's output to
``"nodes"``.  A layer on a share fetches the halo rows of ``h`` from
their owners (``dist.halo_rows``) before its gathers, sums each
path's messages into its own and remote receiver rows, and sends the
remote rows' partial sums to their owners (``dist.sum_to_owners``);
everything after A is node-local.  The energy head's per-graph sums
are summed over ``"data"`` (a molecule may straddle two ranks), and
each rank scores its block of the graphs.  Without a share the path
and its bits are the one-device ones.

Heads: 'energy' (molecule cells: per-graph scalar regression, the
paper's native task) and 'node_class' (citation/products cells: node
classification on l=0 features).

Batch dict (padded, fixed shapes; numpy or tensors):
  positions [N, 3]  float     node coordinates (synthetic for non-3D data)
  features  [N, F]  float     input node features (or one-hot species)
  senders   [E]     int32     edge source index (pad: 0, masked)
  receivers [E]     int32     edge target index
  edge_mask [E]     float     1 = real edge
  node_mask [N]     float     1 = real node
  graph_id  [N]     int32     which graph (for batched small graphs)
  labels    ...               task-dependent
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import dist as _dist
from repro_torch.data.graphs import partition_graph
from repro_torch.kernels.embedding_bag import ops
from repro_torch.models.equivariant import (bessel_rbf, cg_product,
                                            product_paths,
                                            spherical_harmonics)
from repro_torch.nn import layers as L
from repro_torch.nn.module import Placed, Tensors, hold, live


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    n_layers: int = 2
    channels: int = 128         # d_hidden
    lmax: int = 2
    correlation: int = 3
    n_rbf: int = 8
    d_feat: int = 64            # input feature width
    r_cut: float = 1.0
    avg_neighbors: float = 10.0  # A-basis normalisation (conditioning)
    head: str = "energy"        # energy | node_class
    n_classes: int = 47
    n_graphs: int = 1           # batched small graphs

    @property
    def irrep_dims(self):
        return {l: 2 * l + 1 for l in range(self.lmax + 1)}


def _paths(lmax):
    return product_paths(lmax)


class Edges(NamedTuple):
    """A batch's edges as every layer reads them.  On a share, ``send``
    indexes its own ++ halo rows and ``recv`` its own ++ remote rows,
    and ``exchange`` is its plan (None for a whole graph)."""
    send: torch.Tensor          # [E] int64
    recv: torch.Tensor          # [E] int64
    send_order: object          # ops.segment_order(send, N), None on CPU
    recv_order: object
    rbf: torch.Tensor           # [E, n_rbf]
    sh: dict                    # {l: [E, 2l+1]}
    emask: torch.Tensor         # [E]
    exchange: object = None


class MACE(Placed, torch.nn.Module):
    """MACE's parameters, drawn from ``generator`` (on ``device``) in the
    reference's order: ``embed``; each layer's ``radial`` (a path each),
    ``mix_a``, ``msg`` and ``res`` (an l each), then its ``prod_w`` (an
    order and path each); ``readout``.  ``params()`` is the reference's
    tree of the live parameters, which the functional methods take."""

    def __init__(self, cfg: MACEConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.head not in ("energy", "node_class"):
            raise ValueError(f"unknown head {cfg.head!r}")
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.init_params(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device

    # ------------------------------------------------------------ init
    def _layer_init(self, gen, dev):
        cfg, C = self.cfg, self.cfg.channels
        ls = range(cfg.lmax + 1)

        def square():
            return L.lecun_normal(gen, (C, C), device=dev)

        lp = {"radial": {f"p{l1}{l2}{l3}": L.linear_init(
                  gen, cfg.n_rbf, C, bias=False, device=dev)
                  for (l1, l2, l3) in _paths(cfg.lmax)},
              "mix_a": {f"l{l}": square() for l in ls},
              "prod_w": {},
              "msg": {f"l{l}": square() for l in ls},
              "res": {f"l{l}": square() for l in ls}}
        for order in range(2, cfg.correlation + 1):
            for (l1, l2, l3) in _paths(cfg.lmax):
                lp["prod_w"][f"o{order}_p{l1}{l2}{l3}"] = 0.1 * torch.randn(
                    (C,), generator=gen, device=dev)
        return lp

    def init_params(self, gen: torch.Generator):
        """(Re)draw every parameter from ``gen``; returns ``params()``."""
        cfg, dev, C = self.cfg, gen.device, self.cfg.channels
        with torch.no_grad():
            self.embed = Tensors(L.linear_init(gen, cfg.d_feat, C,
                                               device=dev))
            self.layers = hold([self._layer_init(gen, dev)
                                for _ in range(cfg.n_layers)])
            self.readout = hold(L.mlp_init(gen, self._readout_dims(),
                                           device=dev))
        return self._record_shapes()

    def params(self) -> dict:
        return {"embed": self.embed.live(), "layers": live(self.layers),
                "readout": live(self.readout)}

    def _readout_dims(self):
        C = self.cfg.channels
        return ([C, C // 2, 1] if self.cfg.head == "energy"
                else [C, C, self.cfg.n_classes])

    def param_axes(self) -> dict:
        """The logical axes of each leaf of ``params()``: the reference's
        (``nn.axes_tree`` of its ``init_params``).  Only the readout's
        ``"mlp"`` axes resolve onto a mesh."""
        cfg = self.cfg
        ls = range(cfg.lmax + 1)
        paths = _paths(cfg.lmax)
        layer = {"radial": {f"p{l1}{l2}{l3}": {"w": (None, "embed")}
                            for (l1, l2, l3) in paths},
                 "mix_a": {f"l{l}": ("embed", "embed") for l in ls},
                 "prod_w": {f"o{o}_p{l1}{l2}{l3}": ("embed",)
                            for o in range(2, cfg.correlation + 1)
                            for (l1, l2, l3) in paths},
                 "msg": {f"l{l}": ("embed", "embed") for l in ls},
                 "res": {f"l{l}": ("embed", "embed") for l in ls}}
        return {"embed": {"w": ("features", "embed"), "b": ("embed",)},
                "layers": [layer for _ in range(cfg.n_layers)],
                "readout": {"layers": [
                    {"w": ("embed" if i == 0 else "mlp", "mlp"),
                     "b": ("mlp",)} for i in range(2)]}}

    # -------------------------------------------------------- interact
    def _interaction(self, lp, h, edges: Edges):
        """One MACE layer. h: {l: [N, C, 2l+1]}."""
        cfg = self.cfg
        C = cfg.channels
        N, E = h[0].shape[0], edges.send.shape[0]
        ex = edges.exchange
        n_sum = N if ex is None else N + ex.n_remote   # own ++ remote
        scale = cfg.avg_neighbors ** 0.5

        # ---- A-basis: sum_j R(r_ij) (h_j^{l1} x Y^{l2})^{l3}
        A = {l: torch.zeros((n_sum, C, 2 * l + 1), dtype=h[0].dtype,
                            device=h[0].device)
             for l in range(cfg.lmax + 1)}
        # one gather an l1; on a share from its own ++ halo rows, every
        # l1's halo fetched in one exchange.  (One gather of every l1 side
        # by side launches fewer kernels but holds one more [E, C·Σ(2l+1)]
        # buffer in the backward: +0.78 GB at minibatch_lg on one card.)
        hx = h if ex is None else _split_rows(
            _dist.halo_rows(_cat_rows(h), ex), h, C)
        hj = {l1: ops.gather(x.reshape(x.shape[0], -1), edges.send,
                             edges.send_order).view(E, C, 2 * l1 + 1)
              for l1, x in hx.items()}
        for (l1, l2, l3) in _paths(cfg.lmax):
            if l1 not in h:
                continue
            R = L.linear(lp["radial"][f"p{l1}{l2}{l3}"], edges.rbf)  # [E, C]
            msg = cg_product(hj[l1], edges.sh[l2][:, None, :],
                             l1, l2, l3)                         # [E, C, m3]
            msg = msg * (R * edges.emask[:, None])[..., None]
            A[l3] = A[l3] + ops.segment_sum(msg, edges.recv, n_sum,
                                            edges.recv_order) / scale
        if ex is not None:
            # the remote rows' partial sums to their owners
            A = _split_rows(_dist.sum_to_owners(_cat_rows(A), ex), A, C)
        A = {l: torch.einsum("ncm,cd->ndm", A[l],
                             lp["mix_a"][f"l{l}"].to(A[l].dtype))
             for l in A}

        # ---- product basis: iterated equivariant powers of A
        B = dict(A)
        cur = A
        for order in range(2, cfg.correlation + 1):
            nxt = {l: torch.zeros_like(A[l]) for l in A}
            for (l1, l2, l3) in _paths(cfg.lmax):
                w = lp["prod_w"][f"o{order}_p{l1}{l2}{l3}"]
                prod = cg_product(cur[l1], A[l2], l1, l2, l3)
                nxt[l3] = nxt[l3] + w[None, :, None].to(prod.dtype) * prod
            B = {l: B[l] + nxt[l] for l in B}
            cur = nxt

        # ---- message + residual update
        out = {}
        for l in B:
            m = torch.einsum("ncm,cd->ndm", B[l],
                             lp["msg"][f"l{l}"].to(B[l].dtype))
            r = torch.einsum("ncm,cd->ndm", h[l],
                             lp["res"][f"l{l}"].to(B[l].dtype)) \
                if l in h else 0.0
            out[l] = m + r
        return out

    # --------------------------------------------------------- forward
    def _on_device(self, batch) -> dict:
        dev = self.device
        return {k: (v.map(lambda a: torch.as_tensor(a, device=dev))
                    if k == "exchange" else torch.as_tensor(v, device=dev))
                for k, v in batch.items()}

    def local_batch(self, batch, mesh) -> dict:
        """This data rank's share of the graph ``batch`` (host arrays or
        tensors) on the model's device: ``data.graphs.partition_graph``
        on the ``"data"`` axis of ``mesh``.  The Trainer calls it in
        place of cutting the batch's rows, which a graph does not have
        (its senders index the whole graph)."""
        return self._on_device(partition_graph(
            batch, int(mesh.shape["data"]), mesh.data_index,
            graph_labels=self.cfg.head == "energy"))

    def _edges(self, batch) -> Edges:
        """The batch's edge geometry and the sorted orders of its senders
        and receivers (``ops.segment_order``: on the card one sort and
        one host synchronisation each, raising on an index outside the
        nodes).  On a share the senders index its own ++ halo rows and
        the receivers its own ++ remote rows, whose positions it holds in
        that order after the halo's."""
        cfg = self.cfg
        pos = batch["positions"]
        ex = batch.get("exchange")
        send, recv = batch["senders"].long(), batch["receivers"].long()
        if ex is None:
            pos_s = pos_r = pos
        else:
            pos_s = pos[:ex.n_own + ex.n_halo]
            pos_r = torch.cat([pos[:ex.n_own], pos[ex.n_own + ex.n_halo:]])
        send_order = ops.segment_order(send, pos_s.shape[0])
        recv_order = ops.segment_order(recv, pos_r.shape[0])
        emask = batch["edge_mask"].to(pos.dtype)
        vec = pos_r[recv] - pos_s[send]
        r = torch.linalg.vector_norm(vec, dim=-1)
        rbf = bessel_rbf(r, cfg.n_rbf, cfg.r_cut)         # [E, n_rbf]
        sh = spherical_harmonics(vec, cfg.lmax)           # {l: [E, 2l+1]}
        return Edges(send, recv, send_order, recv_order, rbf, sh, emask, ex)

    def node_features(self, p, batch):
        batch = self._on_device(batch)
        edges = self._edges(batch)
        h0 = L.linear(p["embed"], batch["features"])      # [N, C]
        h = {0: h0[..., None]}                            # l=0 irrep
        for lp in p["layers"]:
            h = self._interaction(lp, h, edges)
        return h

    def scalars(self, p, batch):
        h = self.node_features(p, batch)
        return h[0][..., 0]                               # [N, C] invariant

    def _readout(self, p, s):
        """The readout tower, tensor-parallel where the ambient
        ``"model"`` mesh split its weights."""
        return L.mlp(p["readout"], s, dims=self._readout_dims())

    def _energy(self, p, s, batch):
        """The per-graph energy [G]: the readout a node, masked, summed
        over each graph (``ops.segment_sum`` over ``graph_id``); on a
        share, the ranks' partial sums summed over ``"data"``."""
        node_e = self._readout(p, s)[..., 0] * batch["node_mask"]
        gid = batch["graph_id"].long()
        n = self.cfg.n_graphs
        e = ops.segment_sum(node_e, gid, n, ops.segment_order(gid, n))
        return e if "exchange" not in batch else \
            _dist.sum_partials_over_data(e)

    # ------------------------------------------------------------ loss
    def loss_counts(self, batch) -> dict:
        """What each loss term is a mean over, on this rank: the energy
        head's graphs it scores (a share's ``label_mask``; every graph of
        a whole batch), the node head's real own nodes."""
        if self.cfg.head == "energy":
            m = batch.get("label_mask")
            return {"graphs": torch.tensor(len(batch["labels"])) if m is None
                    else torch.sum(torch.as_tensor(m))}
        return {"nodes": torch.sum(torch.as_tensor(batch["node_mask"]))}

    def train_loss(self, p, batch, generator=None):
        """(loss, metrics): the energy head's mean squared error
        (``loss``, ``mae``) or the node head's masked mean cross-entropy
        (``loss``, ``acc``).  Where the data group installed its counts
        (``dist.loss_count``), each mean is this rank's sum over the
        whole batch's count: over the graphs it scores, or its own
        nodes."""
        del generator
        cfg = self.cfg
        batch = self._on_device(batch)
        s = self.scalars(p, batch)                        # [N, C]
        nmask = batch["node_mask"]
        if cfg.head == "energy":
            err = self._energy(p, s, batch) - batch["labels"]
            n = _dist.loss_count("graphs")
            if n is None:
                loss = torch.mean(torch.square(err))
                return loss, {"loss": loss.detach(),
                              "mae": torch.mean(torch.abs(err)).detach()}
            w = batch.get("label_mask")
            w = torch.ones_like(err) if w is None else w
            loss = torch.sum(torch.square(err) * w) / n
            return loss, {"loss": loss.detach(),
                          "mae": (torch.sum(torch.abs(err) * w) / n).detach()}
        labels = batch["labels"].long()
        logits = self._readout(p, s)                      # [N, n_classes]
        lse = torch.logsumexp(logits, -1)
        picked = torch.gather(logits, -1, labels[:, None])[..., 0]
        ce = (lse - picked) * nmask
        n = _dist.loss_count("nodes")
        count = torch.clamp(torch.sum(nmask) if n is None
                            else n.to(nmask.dtype), min=1.0)
        loss = torch.sum(ce) / count
        acc = torch.sum((torch.argmax(logits, -1) == labels) * nmask) / count
        return loss, {"loss": loss.detach(), "acc": acc.detach()}

    def serve(self, p, batch):
        """The energy head's [G] energies, or the node head's [N,
        n_classes] logits."""
        batch = self._on_device(batch)
        s = self.scalars(p, batch)
        if self.cfg.head == "energy":
            return self._energy(p, s, batch)
        return self._readout(p, s)


def _cat_rows(x: dict):
    """{l: [n, C, 2l+1]} -> [n, C·Σ(2l+1)], the l's side by side in
    ascending order (one exchange moves them all)."""
    rows = [x[l].reshape(x[l].shape[0], -1) for l in sorted(x)]
    return rows[0] if len(rows) == 1 else torch.cat(rows, 1)


def _split_rows(flat, like: dict, C: int) -> dict:
    """``_cat_rows``' inverse: views of ``flat`` [n, W] per l of
    ``like``."""
    ls = sorted(like)
    parts = torch.split(flat, [C * (2 * l + 1) for l in ls], 1)
    return {l: x.reshape(flat.shape[0], C, 2 * l + 1)
            for l, x in zip(ls, parts)}
