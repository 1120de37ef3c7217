"""Two-tower retrieval (YouTube DNN / RecSys'19 style) with a RecJPQ or
full item table.

User tower: mean-pooled history embedding -> MLP (tower_mlp, ending at
embed_dim).  Item side: the embedding table itself, scored against the
whole catalogue at serving time — fused score + top-k over the codes
for ``kind="jpq"`` (the hand-written PQTopK kernels on the card).

Batch layout: ``user_hist [B, H]`` item ids (0 = padding).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import EmbeddingConfig, make_embedding
from repro_torch.nn import layers as L
from repro_torch.nn.module import Tensors


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    n_items: int = 1_000_000
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    hist_len: int = 50
    embedding: Optional[EmbeddingConfig] = None
    logq_correction: bool = True
    negatives: str = "global"          # global | local (training)

    def emb_cfg(self) -> EmbeddingConfig:
        base = self.embedding or EmbeddingConfig(n_items=0, d=0)
        # row count padded as the reference pads it (to 512 rows)
        n_rows = (self.n_items + 1 + 511) // 512 * 512
        return dataclasses.replace(base, n_items=n_rows,
                                   d=self.embed_dim)


class TwoTower(torch.nn.Module):
    """Sampled-softmax two-tower retrieval.  Parameters are drawn from
    ``generator`` (on ``device``): the item table first, then the user
    tower, in the reference's order.  ``params()`` returns the
    reference-shaped tree ``{"item_emb": {...}, "user_mlp": {"layers":
    [{"w", "b"}, ...]}}`` of (detached) tensors that the functional
    methods take, as the reference's methods take its params."""

    def __init__(self, cfg: TwoTowerConfig, *, generator: torch.Generator,
                 codes=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.emb = make_embedding(cfg.emb_cfg())
        self.item_emb = Tensors(self.emb.init(generator, codes=codes,
                                               device=device))
        dims = [cfg.embed_dim, *cfg.tower_mlp, cfg.embed_dim]
        mlp = L.mlp_init(generator, dims, device=device)
        self.user_mlp = torch.nn.ModuleList(Tensors(lp)
                                            for lp in mlp["layers"])

    @property
    def device(self) -> torch.device:
        return next(self.item_emb.parameters()).device

    def params(self) -> dict:
        return {"item_emb": self.item_emb.tensors(),
                "user_mlp": {"layers": [m.tensors() for m in self.user_mlp]}}

    def forward(self, user_hist):
        return self.user_vec(self.params(), user_hist)

    def user_vec(self, p, user_hist):
        user_hist = torch.as_tensor(user_hist, device=self.device)
        mask = (user_hist > 0).float()
        if self.cfg.emb_cfg().kind == "full":
            from repro_torch.core import sharded
            pooled = sharded.pooled_lookup(p["item_emb"]["table"],
                                           user_hist, mask)
        else:
            e = self.emb.lookup(p["item_emb"], user_hist)    # [B, H, d]
            pooled = torch.sum(e * mask[..., None], 1)
        pooled = pooled / torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        return L.mlp(p["user_mlp"], pooled)                  # [B, d]

    def bind_engine(self, p, spec, *, catalogue=None):
        """Bind a ``core.engine.RetrievalSpec`` to this model + params:
        a ``BoundRetrieval`` mapping a request (a batch dict with
        ``user_hist``, or a raw [B, H] history) through the user tower
        into the engine's scorer."""
        from repro_torch.core import engine as _engine
        eng = _engine.RetrievalEngine(spec, self.emb, p["item_emb"],
                                      catalogue=catalogue)

        def encode(batch):
            hist = batch["user_hist"] if isinstance(batch, dict) else batch
            return self.user_vec(p, hist)

        return _engine.BoundRetrieval(eng, encode)

    def retrieve(self, p, batch, *, top_k: int = 100, fused: bool = True,
                 prune=None, perm=None, warm=None,
                 return_stats: bool = False):
        """Score user(s) against the full catalogue; returns the top-k
        (values, ids) (+ the pruning-stats dict when ``return_stats``).
        A wrapper over ``bind_engine`` with the reference's kwargs."""
        from repro_torch.core import engine as _engine
        spec = _engine.spec_for(self.emb, k=top_k, fused=fused,
                                prune=prune, perm=perm,
                                warm_decay=0.0 if warm is not None
                                else None,
                                stats=return_stats)
        bound = self.bind_engine(p, spec)
        if spec.prune:
            bound.engine.bind_catalogue(prune=prune, perm=perm)
        if warm is not None:
            warm = torch.as_tensor(warm, dtype=torch.float32,
                                   device=self.device)
        return bound.retrieve(batch, floor=warm)

    def bulk_retrieve(self, p, batch, *, top_k: int = 100,
                      chunk: int = 2048):
        """Offline scoring of many users, ``chunk`` users at a time so
        [B, n_items] never materialises."""
        from repro_torch.core import sharded
        hist = torch.as_tensor(batch["user_hist"], device=self.device)
        vals, idx = [], []
        for s in range(0, hist.shape[0], chunk):
            u = self.user_vec(p, hist[s:s + chunk])
            v, i = sharded.topk_over_items(
                self.emb.logits(p["item_emb"], u), top_k)
            vals.append(v)
            idx.append(i)
        return torch.cat(vals), torch.cat(idx)
