"""Plain oracle for embedding_bag: the fixed-fanout bag, summed in slot
order as the TPU kernel's grid sums it.

Slot 0 is the rounded product ``row * w``; every later slot one fused
multiply-add ``torch.addcmul`` (one rounding per slot), so the result is
bit-equal to the reference's ``embedding_bag_fixed`` in interpret mode.
A separate multiply and add, or ``torch.sum(rows * w, 1)`` (the
reference's ``embedding_bag_ref``), differs in the last bits.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table, ids, weights=None):
    """table [V, d], ids [n_bags, L] int, weights [n_bags, L] or None
    (unit weights) -> [n_bags, d] f32.  Raises on an id outside [0, V)."""
    V = table.shape[0]
    ids = ids.long()
    lo, hi = torch.aminmax(ids)
    if int(lo) < 0 or int(hi) >= V:
        raise IndexError(f"embedding_bag: ids outside [0, {V}) "
                         f"(min {int(lo)}, max {int(hi)})")
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32,
                             device=table.device)
    w = weights.float()
    out = table[ids[:, 0]].float() * w[:, :1]
    for slot in range(1, ids.shape[1]):
        out.addcmul_(table[ids[:, slot]].float(), w[:, slot:slot + 1])
    return out
