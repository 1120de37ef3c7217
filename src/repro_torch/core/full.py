"""Baseline uncompressed item-embedding table (the paper's "Base").

``lookup`` is the gather ``table[ids]``; where the table takes a
gradient, that gradient comes from the embedding_bag backward kernel
(``kernels/embedding_bag/ops.gather``; its plain version on the CPU).
On a ``"model"`` mesh the table may hold this rank's rows: ``lookup``
gathers across the ranks, ``logits`` scores this rank's rows.
"""
from __future__ import annotations

import torch

from repro_torch import dist as _dist
from repro_torch.core import sharded as _sharded
from repro_torch.kernels.embedding_bag import ops as _bag


def init(gen: torch.Generator, n_items: int, d: int, *,
         dtype=torch.float32, init_scale: float | None = None,
         device="cuda"):
    """A normal table scaled in place, so only one copy of it exists
    while it is made (the full DLRM-RM2 table is 57.1 GB)."""
    scale = init_scale if init_scale is not None else d ** -0.5
    tab = torch.randn((n_items, d), generator=gen, device=device)
    return {"table": tab.mul_(scale).to(dtype)}


def lookup(p, ids, *, rows=None):
    """``table[ids]``; a table held as this rank's block of a ``rows``-row
    catalogue gathers the ids' rows across the ranks
    (``core/sharded.take_rows``), each rank's gradient reaching its own
    rows through the same kernel."""
    tab = p["table"]
    if rows is None or tab.shape[0] == rows:
        return _bag.gather(tab, ids)
    return _sharded.take_rows(tab, ids, rows=rows)


def logits(p, h, *, rows=None):
    """h [..., d] -> [..., n_items]; this rank's column block where the
    ambient mesh splits the ``rows``-row catalogue (``h`` through
    ``dist.copy_to_model``)."""
    tab = p["table"]
    if rows is not None:
        mesh, _, tab = _sharded._split(tab, rows)
        if mesh is not None:
            h = _dist.copy_to_model(h, mesh)
    return h.float() @ tab.float().T
