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
step's gradients are the same bits run to run.  The reference's
``dist.constrain`` of A and of a layer's output to the ``"nodes"`` axis
is left out: the port runs MACE on one device (a mesh is ROADMAP item
10e).

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

from repro_torch.kernels.embedding_bag import ops
from repro_torch.models.equivariant import (bessel_rbf, cg_product,
                                            product_paths,
                                            spherical_harmonics)
from repro_torch.nn import layers as L
from repro_torch.nn.module import Tensors, hold, live


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
    """A batch's edges as every layer reads them."""
    send: torch.Tensor          # [E] int64
    recv: torch.Tensor          # [E] int64
    send_order: object          # ops.segment_order(send, N), None on CPU
    recv_order: object
    rbf: torch.Tensor           # [E, n_rbf]
    sh: dict                    # {l: [E, 2l+1]}
    emask: torch.Tensor         # [E]


class MACE(torch.nn.Module):
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
            dims = ([C, C // 2, 1] if cfg.head == "energy"
                    else [C, C, cfg.n_classes])
            self.readout = hold(L.mlp_init(gen, dims, device=dev))
        return self.params()

    def params(self) -> dict:
        return {"embed": self.embed.live(), "layers": live(self.layers),
                "readout": live(self.readout)}

    # -------------------------------------------------------- interact
    def _interaction(self, lp, h, edges: Edges):
        """One MACE layer. h: {l: [N, C, 2l+1]}."""
        cfg = self.cfg
        C = cfg.channels
        N, E = h[0].shape[0], edges.send.shape[0]
        scale = cfg.avg_neighbors ** 0.5

        # ---- A-basis: sum_j R(r_ij) (h_j^{l1} x Y^{l2})^{l3}
        A = {l: torch.zeros((N, C, 2 * l + 1), dtype=h[0].dtype,
                            device=h[0].device)
             for l in range(cfg.lmax + 1)}
        hj = {l1: ops.gather(x.reshape(N, -1), edges.send, edges.send_order)
              .view(E, C, 2 * l1 + 1) for l1, x in h.items()}
        for (l1, l2, l3) in _paths(cfg.lmax):
            if l1 not in h:
                continue
            R = L.linear(lp["radial"][f"p{l1}{l2}{l3}"], edges.rbf)  # [E, C]
            msg = cg_product(hj[l1], edges.sh[l2][:, None, :],
                             l1, l2, l3)                         # [E, C, m3]
            msg = msg * (R * edges.emask[:, None])[..., None]
            A[l3] = A[l3] + ops.segment_sum(msg, edges.recv, N,
                                            edges.recv_order) / scale
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
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _edges(self, batch) -> Edges:
        """The batch's edge geometry and the sorted orders of its senders
        and receivers (``ops.segment_order``: on the card one sort and
        one host synchronisation each, raising on an index outside the
        nodes)."""
        cfg = self.cfg
        pos = batch["positions"]
        N = pos.shape[0]
        send, recv = batch["senders"].long(), batch["receivers"].long()
        send_order = ops.segment_order(send, N)
        recv_order = ops.segment_order(recv, N)
        emask = batch["edge_mask"].to(pos.dtype)
        vec = pos[recv] - pos[send]
        r = torch.linalg.vector_norm(vec, dim=-1)
        rbf = bessel_rbf(r, cfg.n_rbf, cfg.r_cut)         # [E, n_rbf]
        sh = spherical_harmonics(vec, cfg.lmax)           # {l: [E, 2l+1]}
        return Edges(send, recv, send_order, recv_order, rbf, sh, emask)

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

    def _energy(self, p, s, batch):
        """The per-graph energy [G]: the readout a node, masked, summed
        over each graph (``ops.segment_sum`` over ``graph_id``)."""
        node_e = L.mlp(p["readout"], s)[..., 0] * batch["node_mask"]
        gid = batch["graph_id"].long()
        n = self.cfg.n_graphs
        return ops.segment_sum(node_e, gid, n, ops.segment_order(gid, n))

    # ------------------------------------------------------------ loss
    def train_loss(self, p, batch, generator=None):
        """(loss, metrics): the energy head's mean squared error
        (``loss``, ``mae``) or the node head's masked mean cross-entropy
        (``loss``, ``acc``)."""
        del generator
        cfg = self.cfg
        batch = self._on_device(batch)
        s = self.scalars(p, batch)                        # [N, C]
        nmask = batch["node_mask"]
        if cfg.head == "energy":
            err = self._energy(p, s, batch) - batch["labels"]
            loss = torch.mean(torch.square(err))
            return loss, {"loss": loss.detach(),
                          "mae": torch.mean(torch.abs(err)).detach()}
        labels = batch["labels"].long()
        logits = L.mlp(p["readout"], s)                   # [N, n_classes]
        lse = torch.logsumexp(logits, -1)
        picked = torch.gather(logits, -1, labels[:, None])[..., 0]
        ce = (lse - picked) * nmask
        count = torch.clamp(torch.sum(nmask), min=1.0)
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
        return L.mlp(p["readout"], s)
