"""Plain oracles for embedding_bag: the fixed-fanout bag, summed in slot
order as the TPU kernel's grid sums it, and its gradient with respect
to the table (the port's; the TPU kernel has no backward).

Slot 0 is the rounded product ``row * w``; every later slot one fused
multiply-add ``torch.addcmul`` (one rounding per slot), so the result is
bit-equal to the reference's ``embedding_bag_fixed`` in interpret mode.
A separate multiply and add, or ``torch.sum(rows * w, 1)`` (the
reference's ``embedding_bag_ref``), differs in the last bits.  A float64
table is summed in float64 (for ``gradcheck``); narrower floats in fp32.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table, ids, weights=None):
    """table [V, d], ids [n_bags, L] int, weights [n_bags, L] or None
    (unit weights) -> [n_bags, d] f32 (f64 for a f64 table).  Raises on
    an id outside [0, V)."""
    V = table.shape[0]
    ids = ids.long()
    lo, hi = torch.aminmax(ids)
    if int(lo) < 0 or int(hi) >= V:
        raise IndexError(f"embedding_bag: ids outside [0, {V}) "
                         f"(min {int(lo)}, max {int(hi)})")
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32,
                             device=table.device)
    dt = torch.promote_types(table.dtype, torch.float32)
    w = weights.to(dt)
    out = table[ids[:, 0]].to(dt) * w[:, :1]
    for slot in range(1, ids.shape[1]):
        out.addcmul_(table[ids[:, slot]].to(dt), w[:, slot:slot + 1])
    return out


def embedding_bag_backward_ref(ids, weights, dout, V: int):
    """The gradient of ``embedding_bag_ref`` with respect to the table:
    ids [n_bags, L] int, weights [n_bags, L] or None (unit weights),
    dout [n_bags, d] -> dtable [V, d] with
    ``dtable[v] = sum_{(n, l) : ids[n, l] = v} w[n, l] * dout[n]``.

    Each term is the rounded product ``w[n, l] * dout[n]`` (``dout[n]``
    itself with unit weights); ``index_add_`` adds a row's terms onto
    +0.0 in ascending flat position ``n * L + l``, one rounding an add,
    on the CPU (tests/test_torch_embedding_bag_backward.py pins the
    order): the chains the CUDA kernel keeps, so the two are bit-equal.
    On a CUDA tensor ``index_add_`` adds with atomics, in no fixed
    order.  Rows no id names stay +0.0."""
    n_bags, L = ids.shape
    flat = ids.reshape(-1).long()
    src = dout.repeat_interleave(L, 0)                     # [n_bags * L, d]
    if weights is not None:
        src = weights.reshape(-1, 1).to(dout.dtype) * src
    dtable = torch.zeros((V, dout.shape[1]), dtype=dout.dtype,
                         device=dout.device)
    return dtable.index_add_(0, flat, src)
