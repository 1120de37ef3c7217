"""Top-k mixture-of-experts FFN with sort-based capacity dispatch, the
reference's (``nn/moe.py``), functional over tensor dicts.

Assignments are sorted by expert id (a stable sort), each expert gets a
fixed ``capacity`` of slots, and assignments past it are dropped to
slot ``E·C``, which nothing reads.  The dispatch is index-inverted: the
int32 token ids are scattered into an ``[E·C + 1]`` inverse map and the
expert buffer is one gather of the tokens; the combine is a static
top-k loop of ``[t, d]`` gathers.  Both gathers go through
``kernels/embedding_bag/ops.gather``, so their gradients come from the
hand-written, deterministic bag backward (torch's own index backward
adds with atomics), and a training step is bit-identical run to run.
The expert FFN is three batched SwiGLU products over ``[G, E, C, ·]``.

Top-k ties go to the smaller expert id, as ``lax.top_k`` gives them
(``torch.topk`` promises no order among ties): the k largest of a stable
descending sort.

On a ``(data, model)`` mesh (``moe_apply``) a rank runs its block of
the experts, or of their width, on routing computed whole on every
rank; the aux loss is the whole batch's (``aux_loss``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import dist as _dist
from repro_torch.kernels.embedding_bag import ops as _bag
from repro_torch.nn.layers import lecun_normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


def moe_init(gen: torch.Generator, cfg: MoEConfig, *, dtype=torch.float32,
             device="cuda"):
    """``router`` [d, E] ~ N(0, 0.02) in fp32, then ``wi_gate``,
    ``wi_up`` [E, d, f] and ``wo`` [E, f, d] (LeCun normal over each
    expert's fan-in), drawn in that order."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def w(shape):
        return lecun_normal(gen, shape, dtype=dtype, device=device,
                            in_axis=1, out_axis=2)

    router = 0.02 * torch.randn((d, E), generator=gen, device=device)
    return {"router": router, "wi_gate": w((E, d, f)),
            "wi_up": w((E, d, f)), "wo": w((E, f, d))}


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots an expert: ``capacity_factor · n_tokens · top_k / E``,
    rounded up to a multiple of 8, at least ``top_k``."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cfg.top_k, (c + 7) // 8 * 8)


def top_k(probs, k: int):
    """(values, ids) [T, k] of the k largest entries of each row, ties to
    the smaller id (``lax.top_k``'s order)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(idx, E: int, C: int):
    """One group's dispatch indices: idx [t, k] expert ids -> (inv
    [E·C] the token in each slot, t where a slot is unfilled; slot_of
    [t, k] each assignment's slot, ``E·C`` where it was dropped)."""
    t, k = idx.shape
    N = t * k
    dev = idx.device
    flat_e = idx.reshape(N)
    order = torch.argsort(flat_e, stable=True)                 # [N]
    sorted_e = flat_e[order]
    # integer adds (exact in any order); bincount would read the ids'
    # maximum back to the host to size its output
    counts = torch.zeros((E,), dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))                    # [E]
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(N, device=dev) - starts[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(sorted_e, E * C))       # drop slot
    token_of = (order // k).to(torch.int32)
    # only the drop slot E*C can be written twice, and it is never read
    inv = torch.full((E * C + 1,), t, dtype=torch.int32, device=dev)
    inv[slot] = token_of
    slot_of = torch.empty((N,), dtype=torch.int32, device=dev)
    slot_of[order] = slot.to(torch.int32)
    return inv[:E * C], slot_of.reshape(t, k)


def _dispatch_group(x, idx, E: int, C: int, lo=None, n: int = 0):
    """x [t, d], idx [t, k] -> (buf [E, C, d], slot_of [t, k]); with
    ``lo``, the slots of experts ``[lo, lo + n)`` only (buf [n, C,
    d])."""
    t, d = x.shape
    inv, slot_of = route(idx, E, C)
    if lo is not None:
        inv, E = inv[lo * C:(lo + n) * C], n
    xpad = torch.cat([x, x.new_zeros((1, d))], 0)
    buf = _bag.gather(xpad, inv)                               # [E*C, d]
    return buf.reshape(E, C, d), slot_of


def _combine_group(o, slot_of, weights, lo=None):
    """o [E', C, d] (experts ``[lo, lo + E')``), slot_of [t, k], weights
    [t, k] -> y [t, d]: a static k-loop of [t, d] gathers, added in
    order j = 0..k-1.  Holding all E experts, a dropped assignment reads
    the zero row ``E·C``; holding a block of them, each gather names the
    block's slots and sends every other slot (the other ranks' and the
    drop slot) to the sentinel (``ops.gather_block``): its row is zero
    and its gradient reaches no slot."""
    E, C, d = o.shape
    flat_o = o.reshape(E * C, d)
    y = o.new_zeros((slot_of.shape[0], d))
    if lo is None:
        flat_o = torch.cat([flat_o, o.new_zeros((1, d))], 0)
    else:
        loc = slot_of.long() - lo * C
        own = (loc >= 0) & (loc < E * C)
    for j in range(slot_of.shape[1]):
        part = (_bag.gather(flat_o, slot_of[:, j]) if lo is None else
                _bag.gather_block(flat_o, loc[:, j], own[:, j]))
        y = y + part * weights[:, j:j + 1].to(o.dtype)
    return y


def _groups() -> int:
    """Dispatch groups by default: one where each rank already holds
    only its own rows of the batch (the Trainer's data split: a rank's
    tokens are its group), else the ambient mesh's data-shard count (1
    off a mesh), the reference's ``dist.data_shard_count()``."""
    return 1 if _dist.data_rank()[1] > 1 else _dist.data_shard_count()


def aux_loss(probs, idx, E: int, weight: float):
    """The Switch load-balancing term ``weight · E · sum(mean probs ·
    mean top-k counts)`` over the whole batch.  Where each rank holds
    its own rows (``dist.data_rank``), the counts and the token count
    are summed over ``"data"`` (one all-reduce of ``[E + 1]`` int64,
    no gradient) and this rank's term is ``weight · E · sum((its probs
    summed / T) · counts / T)``: the ranks' terms sum to the whole
    batch's, and so do their gradients.  The counts are whole numbers
    summed exactly and divided once, as the reference's mean rounds
    them."""
    T = probs.shape[0]
    tot = torch.zeros((E + 1,), dtype=torch.int64, device=probs.device)
    tot.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(),
                                                  dtype=torch.int64,
                                                  device=probs.device))
    tot[E] = T
    if _dist.data_rank()[1] > 1:
        tot = _dist.sum_over_data(tot)
        n = tot[E].to(torch.float32)
        me = torch.sum(probs, 0) / n
    else:
        n = float(T)
        me = torch.mean(probs, 0)                              # [E]
    ce = tot[:E].to(torch.float32) / n
    return weight * E * torch.sum(me * ce)


def moe_apply(p, cfg: MoEConfig, x, *, aux_loss_weight: float = 0.01,
              groups: int | None = None):
    """x [T, d] -> (y [T, d], aux_loss scalar fp32).

    ``groups``: dispatch groups (GShard-style); the tokens split into G
    groups of T/G, each routed with its own capacity.  None takes
    ``_groups()``: the ambient mesh's data-shard count (1 off a mesh),
    or 1 where each rank holds only its own rows; a G that does not
    divide T falls back to 1.  The aux loss is ``aux_loss`` over the
    whole batch.

    On a ``"model"`` mesh, as the reference's axes ``("expert", "embed",
    "mlp")`` place them, the experts' weights hold this rank's block of
    the experts (``[E/S, ...]``) or, where S does not divide E, of
    their width (``[E, d, f/S]``, ``[E, f/S, d]``).  Every rank routes
    all of its tokens on the whole router (a block of the router's
    columns is gathered first, exactly): the ``[T, E]`` logits, the
    top-k and the slots carry the same bits on every rank.  A rank
    holding experts ``[lo, hi)`` gathers their slots only
    (``inv[lo·C:hi·C]``) and combines them, the other slots sent to the
    sentinel; holding a block of the width, it runs every expert on it.
    ``x`` and the routing weights enter that region through
    ``dist.copy_to_model`` and the partial ``y`` leaves it through
    ``dist.reduce_from_model``."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    G = groups if groups is not None else _groups()
    if T % G != 0:
        G = 1
    t_local = T // G
    C = capacity(cfg, t_local)
    E_l = p["wi_gate"].shape[0]
    split = E_l != E or p["wi_gate"].shape[2] != cfg.d_ff
    router = p["router"]
    if router.shape[1] != E:
        router = _dist.gather_from_model(router, 1)

    logits = x.float() @ router                                # [T, E]
    probs = torch.softmax(logits, -1)
    weights, idx = top_k(probs, k)                             # [T, k]
    weights = weights / torch.sum(weights, -1, keepdim=True)
    aux = aux_loss(probs, idx, E, aux_loss_weight)

    lo = None
    if split:
        if _dist.model_size() <= 1:
            raise ValueError("the experts' weights hold a block, but no "
                             "ambient mesh splits them "
                             "(dist.use_mesh_rules)")
        x = _dist.copy_to_model(x)
        weights = _dist.copy_to_model(weights)
        if E_l != E:
            lo = _dist.row_block(E)[0]
    xg = x.reshape(G, t_local, d)
    idxg = idx.reshape(G, t_local, k)
    wg = weights.reshape(G, t_local, k)
    parts = [_dispatch_group(xg[g], idxg[g], E, C, lo, E_l)
             for g in range(G)]
    h = torch.stack([b for b, _ in parts])                     # [G, E', C, d]

    g_ = F.silu(torch.einsum("gecd,edf->gecf", h, p["wi_gate"].to(dt)))
    u = torch.einsum("gecd,edf->gecf", h, p["wi_up"].to(dt))
    o = torch.einsum("gecf,efd->gecd", g_ * u, p["wo"].to(dt))
    y = torch.cat([_combine_group(o[g], parts[g][1], wg[g], lo)
                   for g in range(G)], 0)
    return (_dist.reduce_from_model(y) if split else y), aux
