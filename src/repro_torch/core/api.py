"""Uniform embedding interface over {full, jpq, qr}."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import full as _full
from repro_torch.core import jpq as _jpq
from repro_torch.core import qr as _qr


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    n_items: int
    d: int
    kind: str = "full"            # full | jpq | qr
    m: int = 8                    # jpq: code length
    b: int = 256                  # jpq: centroids per split
    assignment: str = "svd"       # jpq: random | svd | bpr
    # jpq: the hand-written kernels, forward and backward — jpq_scores
    # for logits and (in the port; the reference has no lookup switch)
    # jpq_lookup for lookup
    use_kernel: bool = False
    init_scale: Optional[float] = None

    def float_param_count(self) -> int:
        if self.kind == "full":
            return self.n_items * self.d
        if self.kind == "jpq":
            return self.b * self.d
        if self.kind == "qr":
            q = _qr.qr_base(self.n_items)
            return ((self.n_items + q - 1) // q + q) * self.d
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class Embedding:
    cfg: EmbeddingConfig

    def init(self, gen: torch.Generator, *, codes=None, dtype=torch.float32,
             device="cuda"):
        c = self.cfg
        if c.kind == "full":
            return _full.init(gen, c.n_items, c.d, dtype=dtype,
                              init_scale=c.init_scale, device=device)
        if c.kind == "jpq":
            return _jpq.init(gen, c.n_items, c.d, c.m, c.b, codes=codes,
                             dtype=dtype, init_scale=c.init_scale,
                             device=device)
        if c.kind == "qr":
            return _qr.init(gen, c.n_items, c.d, dtype=dtype,
                            init_scale=c.init_scale, device=device)
        raise ValueError(c.kind)

    def param_axes(self) -> dict:
        """The logical axes of each leaf of ``init``'s tree (the
        reference's)."""
        kind = self.cfg.kind
        if kind == "full":
            return {"table": ("table", "table_dim")}
        if kind == "jpq":
            return {"codes": ("items", "code_split"),
                    "centroids": ("code_split", "centroid", "table_dim")}
        if kind == "qr":
            return {"q_table": ("table", "table_dim"),
                    "r_table": ("table", "table_dim")}
        raise ValueError(kind)

    def lookup(self, p, ids):
        """ids -> [..., d]; the leaves may hold this rank's rows of a
        ``"model"`` mesh (gathered across the ranks)."""
        c = self.cfg
        if c.kind == "full":
            return _full.lookup(p, ids, rows=c.n_items)
        if c.kind == "jpq":
            return _jpq.lookup(p, ids, use_kernel=c.use_kernel,
                               rows=c.n_items)
        return _qr.lookup(p, ids, c.n_items)

    def logits(self, p, h):
        """h -> [..., n_items], or this rank's column block of them where
        the ambient mesh splits the catalogue's rows over ``"model"``."""
        c = self.cfg
        if c.kind == "full":
            return _full.logits(p, h, rows=c.n_items)
        if c.kind == "jpq":
            return _jpq.logits(p, h, use_kernel=c.use_kernel, rows=c.n_items)
        return _qr.logits(p, h, c.n_items)

    def bag_lookup(self, p, ids, segment_ids, num_segments: int,
                   *, combiner: str = "sum", weights=None):
        """EmbeddingBag: ids [nnz], segment_ids [nnz] (the bag of each
        id) -> [num_segments, d], as gather + segment sum."""
        emb = self.lookup(p, ids)                       # [nnz, d]
        if weights is not None:
            emb = emb * weights[:, None].to(emb.dtype)
        seg = segment_ids.long()
        out = torch.zeros((num_segments, emb.shape[-1]), dtype=emb.dtype,
                          device=emb.device).index_add_(0, seg, emb)
        if combiner == "mean":
            cnt = torch.zeros((num_segments,), dtype=emb.dtype,
                              device=emb.device).index_add_(
                0, seg, torch.ones_like(seg, dtype=emb.dtype))
            out = out / torch.clamp(cnt, min=1.0)[:, None]
        return out


def make_embedding(cfg: EmbeddingConfig) -> Embedding:
    return Embedding(cfg)


def compression_report(cfg: EmbeddingConfig) -> dict:
    """Paper Table-2-style memory analysis for one table config."""
    base_bytes = cfg.n_items * cfg.d * 4
    if cfg.kind == "jpq":
        float_bytes = cfg.b * cfg.d * 4
        code_bytes = cfg.n_items * cfg.m * (1 if cfg.b <= 256 else 4)
        comp = float_bytes + code_bytes
    elif cfg.kind == "qr":
        comp = cfg.float_param_count() * 4
    else:
        comp = base_bytes
    return {
        "kind": cfg.kind, "n_items": cfg.n_items, "d": cfg.d,
        "base_bytes": base_bytes, "compressed_bytes": comp,
        "ratio": base_bytes / max(comp, 1),
        "pct_of_base": 100.0 * comp / base_bytes,
    }
