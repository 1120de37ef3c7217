"""GRU / AUGRU cells and their application over a sequence, written by
hand: ``torch.nn.GRU`` orders its gates r, z, n, puts a bias on both
sides and updates h' = (1 - z)·n + z·h, where the reference has gates
z, r, n, an input-side bias only, and h' = (1 - z)·h + z·n.

Used by DIEN's interest extractor and its interest-evolution layer
(AUGRU: the update gate scaled by an attention score,
arXiv:1809.03672).  Weights keep the reference layout ``wx [d_in, 3h]``,
``wh [h, 3h]``, ``b [3h]``.
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import glorot_normal


def gru_init(gen: torch.Generator, d_in: int, d_h: int, *,
             dtype=torch.float32, device="cuda"):
    return {"wx": glorot_normal(gen, (d_in, 3 * d_h), dtype=dtype,
                                device=device),
            "wh": glorot_normal(gen, (d_h, 3 * d_h), dtype=dtype,
                                device=device),
            "b": torch.zeros((3 * d_h,), dtype=dtype, device=device)}


def _step(p, h, gx, a=None):
    """One step from the input projection ``gx = x @ wx + b``."""
    gh = h @ p["wh"].to(h.dtype)
    xz, xr, xn = gx.chunk(3, -1)
    hz, hr, hn = gh.chunk(3, -1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    if a is not None:                               # AUGRU
        z = a[:, None] * z
    return (1.0 - z) * h + z * n


def _in_proj(p, x):
    return x @ p["wx"].to(x.dtype) + p["b"].to(x.dtype)


def gru_cell(p, h, x, a=None):
    """One step. h [B, Dh], x [B, Din], a optional attention score [B]."""
    return _step(p, h, _in_proj(p, x), a)


def gru_scan(p, xs, h0=None, attn=None, *, reverse: bool = False):
    """xs [B, S, Din] -> (hs [B, S, Dh], h_last [B, Dh]).

    attn: optional [B, S] attention scores (AUGRU when given).  The input
    projection of every step is one product before the loop; the
    recurrence is a Python loop over the S steps.  The steps' inputs are
    taken with ``unbind``, whose backward stacks the S gradients once:
    a step's ``gxs[:, t]`` would have a backward that writes a zero
    [B, S, 3 Dh] tensor a step, S times the projection's bytes."""
    B, S, _ = xs.shape
    d_h = p["wh"].shape[0]
    h = torch.zeros((B, d_h), dtype=xs.dtype, device=xs.device) \
        if h0 is None else h0
    gxs = _in_proj(p, xs).unbind(1)                 # S x [B, 3 Dh]
    ats = (None,) * S if attn is None else attn.unbind(1)
    hs = [None] * S
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        h = _step(p, h, gxs[t], ats[t])
        hs[t] = h
    return torch.stack(hs, 1), h
