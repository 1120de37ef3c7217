"""Quotient-Remainder compositional embedding (Shi et al., KDD'20), the
paper's compression baseline.

Item i is the element-wise product of two rows: ``q_table[i // q]`` and
``r_table[i % q]``, with ``q = ceil(sqrt(n_items))``.  Full-catalogue
scoring never builds the ``[n_items, d]`` table:
``scores[a*q + r] = sum_d h_d Q[a, d] R[r, d]``.

``p`` is ``{"q_table": [A, d], "r_table": [q, d]}``; ``n_items`` is
static config, passed explicitly.  On a ``"model"`` mesh either table
may hold this rank's block of rows, and ``logits`` scores this rank's
block of the catalogue.
"""
from __future__ import annotations

import math

import torch

from repro_torch import dist as _dist
from repro_torch.core import sharded as _sharded


def qr_base(n_items: int) -> int:
    return math.isqrt(max(n_items - 1, 0)) + 1 if n_items > 1 else 1


def init(gen: torch.Generator, n_items: int, d: int, *,
         dtype=torch.float32, init_scale: float | None = None,
         device="cuda"):
    """``q_table`` then ``r_table``, normal draws from ``gen`` scaled by
    ``init_scale`` (default ``d ** -0.25``, so a product row has the
    scale ``d ** -0.5``)."""
    q = qr_base(n_items)
    n_quot = (n_items + q - 1) // q
    scale = init_scale if init_scale is not None else d ** -0.25
    qt = torch.randn((n_quot, d), generator=gen, device=device).mul_(scale)
    rt = torch.randn((q, d), generator=gen, device=device).mul_(scale)
    return {"q_table": qt.to(dtype), "r_table": rt.to(dtype)}


def lookup(p, ids, n_items: int):
    """ids int[...] -> embeddings [..., d].  A table held as this rank's
    block of rows (a ``"model"`` mesh) gathers across the ranks."""
    q = qr_base(n_items)
    ids = ids.long()
    return (_rows(p["q_table"], ids // q, (n_items + q - 1) // q)
            * _rows(p["r_table"], ids % q, q))


def _rows(tab, idx, rows: int):
    if tab.shape[0] == rows:
        return tab[idx]
    return _sharded.take_rows(tab, idx, rows=rows)


def _whole(tab, rows: int):
    """The whole table of a rank's block (gathered; its gradient cut back
    to the block)."""
    return tab if tab.shape[0] == rows else _dist.gather_from_model(tab, 0)


def logits(p, h, n_items: int):
    """h [..., d] -> [..., n_items] in fp32, contracted as the reference's
    einsum is: ``h * Q`` to [..., A, d], then with ``R`` to [..., A, q].
    Where the ambient mesh splits the catalogue's ``n_items`` rows over
    ``"model"``, this rank's column block [lo, hi): the rows of ``Q``
    that cover it, its columns cut from their ``[.., A', q]`` products;
    ``h`` and the tables enter through ``dist.copy_to_model``."""
    q = qr_base(n_items)
    qt = _whole(p["q_table"], (n_items + q - 1) // q).float()   # [A, d]
    rt = _whole(p["r_table"], q).float()                        # [q, d]
    blk = _dist.row_block(n_items)
    a0, lo, hi = 0, 0, n_items
    if blk is not None:
        lo, hi = blk
        a0 = lo // q
        h, qt, rt = (_dist.copy_to_model(t) for t in (h, qt, rt))
        qt = qt[a0:(hi - 1) // q + 1]
    hq = h.float()[..., None, :] * qt                # [..., A, d]
    s = hq @ rt.T                                   # [..., A, q]
    s = s.reshape(*h.shape[:-1], qt.shape[0] * rt.shape[0])
    return s[..., lo - a0 * q:hi - a0 * q]
