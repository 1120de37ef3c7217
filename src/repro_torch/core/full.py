"""Baseline uncompressed item-embedding table (the paper's "Base")."""
from __future__ import annotations

import torch


def init(gen: torch.Generator, n_items: int, d: int, *,
         dtype=torch.float32, init_scale: float | None = None,
         device="cuda"):
    scale = init_scale if init_scale is not None else d ** -0.5
    tab = scale * torch.randn((n_items, d), generator=gen, device=device)
    return {"table": tab.to(dtype)}


def lookup(p, ids):
    return p["table"][ids.long()]


def logits(p, h):
    return h.float() @ p["table"].float().T
