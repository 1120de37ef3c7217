"""Baseline uncompressed item-embedding table (the paper's "Base").

``lookup`` is the gather ``table[ids]``; where the table takes a
gradient, that gradient comes from the embedding_bag backward kernel
(``kernels/embedding_bag/ops.gather``; its plain version on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops as _bag


def init(gen: torch.Generator, n_items: int, d: int, *,
         dtype=torch.float32, init_scale: float | None = None,
         device="cuda"):
    """A normal table scaled in place, so only one copy of it exists
    while it is made (the full DLRM-RM2 table is 57.1 GB)."""
    scale = init_scale if init_scale is not None else d ** -0.5
    tab = torch.randn((n_items, d), generator=gen, device=device)
    return {"table": tab.mul_(scale).to(dtype)}


def lookup(p, ids):
    return _bag.gather(p["table"], ids)


def logits(p, h):
    return h.float() @ p["table"].float().T
