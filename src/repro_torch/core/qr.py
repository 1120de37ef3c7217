"""Quotient-Remainder compositional embedding (Shi et al., KDD'20), the
paper's compression baseline.

Item i is the element-wise product of two rows: ``q_table[i // q]`` and
``r_table[i % q]``, with ``q = ceil(sqrt(n_items))``.  Full-catalogue
scoring never builds the ``[n_items, d]`` table:
``scores[a*q + r] = sum_d h_d Q[a, d] R[r, d]``.

``p`` is ``{"q_table": [A, d], "r_table": [q, d]}``; ``n_items`` is
static config, passed explicitly.
"""
from __future__ import annotations

import math

import torch


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
    """ids int[...] -> embeddings [..., d]."""
    q = qr_base(n_items)
    ids = ids.long()
    return p["q_table"][ids // q] * p["r_table"][ids % q]


def logits(p, h, n_items: int):
    """h [..., d] -> [..., n_items] in fp32, contracted as the reference's
    einsum is: ``h * Q`` to [..., A, d], then with ``R`` to [..., A, q]."""
    qt = p["q_table"].float()                       # [A, d]
    rt = p["r_table"].float()                       # [q, d]
    hq = h.float()[..., None, :] * qt                # [..., A, d]
    s = hq @ rt.T                                   # [..., A, q]
    s = s.reshape(*h.shape[:-1], qt.shape[0] * rt.shape[0])
    return s[..., :n_items]
