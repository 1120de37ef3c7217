"""Plain oracles for embedding_bag: the fixed-fanout bag, summed in slot
order as the TPU kernel's grid sums it, its gradient with respect to
the table (the port's; the TPU kernel has no backward), the gradient of
a plain gather ``table[ids]`` (the same function at L = 1 with unit
weights), the gradient on a row block whose foreign slots are dropped
(``block_backward_ref``), and the backward's index preparation
(``sort_ids_ref``).

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


def block_backward_ref(ids, weights, dout, V: int):
    """``embedding_bag_backward_ref`` on a row block ``[V, d]`` of a
    table (a rank's rows on a ``"model"`` mesh): ids [n_bags, L] in
    [0, V], where V marks a foreign slot (another rank's row) whose term
    is dropped, so no row receives it; every other row adds its terms
    onto +0.0 in ascending flat position, as there.  The plain version
    of ``cuda.block_backward``."""
    n_bags, L = ids.shape
    flat = ids.reshape(-1).long()
    keep = flat != V
    src = dout.repeat_interleave(L, 0)                     # [n_bags * L, d]
    if weights is not None:
        src = weights.reshape(-1, 1).to(dout.dtype) * src
    dtable = torch.zeros((V, dout.shape[1]), dtype=dout.dtype,
                         device=dout.device)
    return dtable.index_add_(0, flat[keep], src[keep])


def gather_backward_ref(ids, dout, V: int):
    """The gradient of ``table[ids]`` for a [V, d] table: ids (any shape;
    a negative id counts from the end, as indexing reads it), dout
    [*ids.shape, d] -> dtable [V, d], each row +0.0 plus its terms
    ``dout[p]`` in ascending flat position p (``index_add_`` on the CPU).
    Raises on an id outside [-V, V)."""
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + V, flat)
    if flat.numel():
        lo, hi = torch.aminmax(flat)
        if int(lo) < 0 or int(hi) >= V:
            raise IndexError(f"gather backward: ids outside [-{V}, {V})")
    d = dout.shape[-1]
    dtable = torch.zeros((V, d), dtype=dout.dtype, device=dout.device)
    return dtable.index_add_(0, flat, dout.reshape(-1, d))


def sort_ids_ref(ids, V: int, *, wrap: bool = False, long_run: int = 64):
    """The plain version of ``cuda.sort_ids``, the same algorithm in
    torch: each id becomes a key (an id outside [0, V), after ``wrap``,
    the sentinel V); a stable sort gives the flat positions ``perm``;
    sorted position i (i in [0, P]) gives the rows after the key before
    it, up to its own key (V at i = P), the offset i, so ``offs[v]`` is
    the first sorted position whose key is >= v; a run is long when the
    key ``long_run`` places after its first position is still its own.
    Returns (perm int64 [P], offs int64 [V + 1], the long rows ascending,
    bad: 1 if a sentinel exists)."""
    keys = ids.reshape(-1).long()
    if wrap:
        keys = torch.where(keys < 0, keys + V, keys)
    keys = torch.where((keys >= 0) & (keys < V), keys, V)
    P = keys.numel()
    skeys, perm = torch.sort(keys, stable=True)
    ends = torch.cat([skeys, skeys.new_tensor([V])])      # key at i, V at P
    starts = torch.cat([skeys.new_tensor([-1]), skeys])   # the key before i
    gaps = (ends - starts).clamp_(min=0)
    offs = torch.repeat_interleave(torch.arange(P + 1), gaps)[:V + 1]
    first = torch.ones(P, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    i = torch.arange(P)
    ahead = skeys[(i + long_run).clamp(max=max(P - 1, 0))]
    lng = first & (skeys < V) & (i + long_run < P) & (ahead == skeys)
    bad = int(offs[V]) < P
    return perm, offs, skeys[lng], bad
