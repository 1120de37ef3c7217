"""Public wrappers for the fused PQTopK serving path.

Two backends behind one call, the operators ``repro_torch::jpq_topk``
and ``jpq_topk_pruned`` (``kernels/library``), chosen by where the LUT
lies:
  "cuda" - the hand-written Hopper kernels (``csrc/jpq_topk.cu``,
           ``csrc/jpq_topk_pruned.cu``), for a CUDA tensor
  "scan" - their plain PyTorch versions (``jpq_topk_scan``,
           ``jpq_topk_scan_pruned``), for a CPU tensor: ports of the
           reference's ``_jpq_topk_scan`` / ``_jpq_topk_scan_pruned``

A CUDA tensor always goes to the kernel; there is no fallback to the
plain version on the card.  Every top-k ranks by (value descending in
the IEEE total order, +0.0 above −0.0; id ascending) — the order
``lax.top_k`` induces on the materialised matrix — so values AND ids
are bit-equal to the reference in every backend.  ``k`` is clamped to
``min(k, N)``; N need not be a multiple of any tile.

Pruning (``prune=``), permuted sweeps (``perm=``) and warm floors
(``warm=``) follow the reference contract: a tile is skipped only when
its score bound ``Σ_j max{P[j, c] : c present}`` cannot enter the
running top-k, and a warm floor that overshoots a query's true k-th
value demotes that query and re-sweeps, so results stay exact.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch


class PruneState(NamedTuple):
    """Query-independent pruning inputs for one (codes, block_n) pair.

    codes   [N, m] uint8/int32  codebook rows in SWEEP order
    ids     [N]    int32        original item id of each sweep row
    present [nt, m, b] f32      0/1 — code c occurs in tile t, split j
    block_n int                 tile size ``present`` was built for
    tie_break_ids bool          sweep order != ascending id (permuted)
    """
    codes: torch.Tensor
    ids: torch.Tensor
    present: torch.Tensor
    block_n: int
    tie_break_ids: bool


def _ceil_mult(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prepare_pruning(codes, b: int, block_n: int, perm=None) -> PruneState:
    """Build the per-tile code-presence mask (and optional sweep
    permutation).  O(N·m) scatter, codes-only: build once per
    (codes, block_n), not per query."""
    N, m = codes.shape
    dev = codes.device
    if perm is None:
        ids = torch.arange(N, dtype=torch.int32, device=dev)
        sweep = codes
    else:
        # the reference routes permuted tie ids through an f32 top_k;
        # the port keeps its cap so both accept the same catalogues
        if N >= 2 ** 24:
            raise ValueError(f"permuted pruning caps at 2^24 ids, N={N}")
        ids = torch.as_tensor(perm, device=dev).to(torch.int32)
        if tuple(ids.shape) != (N,):
            raise ValueError(f"perm shape {tuple(ids.shape)} != ({N},)")
        sweep = codes.index_select(0, ids.long())
    nt = -(-N // block_n)
    tile = (torch.arange(N, device=dev) // block_n)[:, None].expand(N, m)
    split = torch.arange(m, device=dev)[None, :].expand(N, m)
    present = torch.zeros((nt, m, b), dtype=torch.float32, device=dev)
    present[tile, split, sweep.long()] = 1.0
    return PruneState(sweep.contiguous(), ids, present, int(block_n),
                      perm is not None)


def _resolve_prune(prune, perm, codes, b: int, block_n: int):
    """True/PruneState -> a PruneState matching ``block_n``.  A rebuild
    re-tiles ``prune.codes`` (already in sweep order) and keeps the
    stored ids: permuting them again would serve the wrong item ids."""
    if isinstance(prune, PruneState):
        if prune.block_n == block_n:
            return prune
        st = prepare_pruning(prune.codes, b, block_n)
        return PruneState(st.codes, prune.ids, st.present, block_n,
                          prune.tie_break_ids)
    return prepare_pruning(codes, b, block_n, perm=perm)


def canonicalise_lut(partial):
    """-0.0 -> +0.0, numerically a no-op: pins the signed-zero tie order
    to the id tie-break in every backend."""
    return torch.where(partial == 0.0, torch.zeros_like(partial), partial)


def _as_floor(warm, B: int, device):
    """warm (None | scalar | [B]) -> per-query f32 floor [B] or None."""
    if warm is None:
        return None
    fl = torch.as_tensor(warm, dtype=torch.float32, device=device)
    return fl.broadcast_to((B,)).contiguous()


def desc_sort_key(v):
    """int32 key: ascending key order == IEEE-total-order DESCENDING
    value order (+0.0 above −0.0) — ``lax.top_k``'s ranking."""
    b = (-v.float()).contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def topk_desc(values, ids, k: int):
    """Exact top-k of candidates by (value desc, id asc), ids >= 0.

    The (key, id) pair packs into one int64 whose ascending order is the
    total order, so equal int64 keys are identical entries and the
    tie-free ``torch.topk`` over it is exact."""
    key = (desc_sort_key(values).long() << 32) | ids.long()
    pos = torch.topk(key, int(k), dim=-1, largest=False, sorted=True)[1]
    return values.gather(-1, pos), ids.gather(-1, pos)


topk_total_order = topk_desc


def jpq_topk(h, centroids, codes, k: int, *, block_n: int | None = None,
             prune: Union[bool, PruneState, None] = None, perm=None,
             warm=None):
    """h [..., d], centroids [m, b, dk], codes [N, m] ->
    (values, ids) [..., min(k, N)] without materialising [..., N]."""
    m, b, dk = centroids.shape
    lead = h.shape[:-1]
    h2 = h.reshape(-1, m, dk).float()
    partial = torch.einsum("bmk,mck->bmc", h2, centroids.float())
    v, i = jpq_topk_lut(partial, codes, k, block_n=block_n, prune=prune,
                        perm=perm, warm=warm)
    return v.reshape(*lead, -1), i.reshape(*lead, -1)


def jpq_topk_lut(partial, codes, k: int, *, block_n: int | None = None,
                 prune: Union[bool, PruneState, None] = None, perm=None,
                 warm=None, return_stats: bool = False):
    """partial [B, m, b] fp32, codes [N, m] -> (values, ids)
    [B, min(k, N)].  A CUDA ``partial`` runs the kernels, a CPU one the
    plain versions.

    ``block_n`` is the tile size in items.  ``None``: the plain unpruned
    scan uses ``scan_block_n(N)`` and the unpruned kernel the item ranges
    its planner picks (``cuda.range_plan``); pruned sweeps (kernel and
    plain) use ``prune_block_n(N)`` (~8192 items) so the bound has tiles
    to skip.  An explicit ``block_n`` sets the unpruned kernel's item
    range (``chunk``) too; tiling never changes the result.
    ``prune``/``perm``/``warm``/``return_stats`` are the reference's:
    stats are ``skipped_tiles`` / ``total_tiles`` /
    ``skips`` [n_tiles] / ``theta`` [B] (final k-th values) /
    ``demoted`` [B] bool (the warm floor overshot and the query was
    re-swept)."""
    B, m, b = partial.shape
    N = codes.shape[0]
    k = min(int(k), N)
    if k <= 0:
        raise ValueError(f"k must be >= 1 and the catalogue non-empty, "
                         f"got k={k}, N={N}")
    partial = canonicalise_lut(partial.float()).contiguous()
    if not prune:
        if return_stats or warm is not None:
            raise ValueError("stats and warm floors are pruned-path "
                             "features: pass prune=True or a PruneState")
        # the kernel's item range on the card, the plain scan's tile on
        # the CPU (default: scan_block_n(N))
        from repro_torch.kernels.library import op
        return op("jpq_topk")(partial, codes, k, block_n)

    # a prebuilt state's own tile size wins over the default (an
    # explicit block_n still forces a rebuild)
    if block_n is None and isinstance(prune, PruneState):
        block_n = prune.block_n
    bn = min(block_n or prune_block_n(N), _ceil_mult(N, 128))
    st = _resolve_prune(prune, perm, codes, b, bn)
    floor = _as_floor(warm, B, partial.device)

    def sweep(fl):
        return pruned_sweep(partial, st, k, block_n=bn, floor=fl)

    if floor is None:
        v, i, skips = sweep(None)
        demoted = torch.zeros((B,), dtype=torch.bool, device=v.device)
    else:
        # a floor is admissible only when <= the true k-th value, and
        # v1[:, -1] >= floor certifies exactly that (list values are
        # real scores); rows that fail are demoted to -inf and the
        # sweep re-runs — once, and only when some floor overshot
        v1, i1, s1 = sweep(floor)
        ok = v1[:, -1] >= floor
        demoted = ~ok
        if bool(ok.all()):
            v, i, skips = v1, i1, s1
        else:
            v, i, skips = sweep(torch.where(
                ok, floor, torch.full_like(floor, -float("inf"))))
    if return_stats:
        return v, i, {"skipped_tiles": skips.sum(),
                      "total_tiles": int(skips.numel()),
                      "skips": skips, "theta": v[:, -1],
                      "demoted": demoted}
    return v, i


def pruned_sweep(partial, st: PruneState, k: int, *, block_n: int,
                 floor=None, carry=None):
    """One score-bound pruned sweep over all rows of ``st``: the kernel
    for a CUDA ``partial``, the plain version for a CPU one.
    ``floor [B]`` is the per-query candidate floor (None = -inf),
    ``carry`` an optional (vals, ids) [B, k] running-list seed.
    Returns (values [B, k], ids [B, k], skips [n_tiles] int32) with
    ``skips[t] == 1`` iff no query group swept tile t.  ``partial`` must
    already be canonicalised fp32."""
    B = partial.shape[0]
    k = int(k)
    dev = partial.device
    if floor is None:
        floor = torch.full((B,), -float("inf"), dtype=torch.float32,
                           device=dev)
    if carry is None:
        carry = (torch.full((B, k), -float("inf"), dtype=torch.float32,
                            device=dev),
                 torch.zeros((B, k), dtype=torch.int32, device=dev))
    from repro_torch.kernels.library import op
    v, i, skip_map = op("jpq_topk_pruned")(
        partial, st.codes, st.ids, st.present, floor, carry[0], carry[1],
        k, int(block_n), bool(st.tie_break_ids))
    # a tile counts skipped when every query group skipped it (the plain
    # version sweeps all B rows as one group)
    return v, i, skip_map.min(dim=0).values


_SCAN_BLOCK_N = 131072
_PRUNE_BLOCK_N = 8192


def scan_block_n(N: int, target: int = _SCAN_BLOCK_N) -> int:
    """Near-divisor block size: the closest tile count to N/target, so
    the padded tail is < 128 items."""
    nb = max(1, round(N / target))
    return _ceil_mult(-(-N // nb), 128)


def prune_block_n(N: int, target: int = _PRUNE_BLOCK_N) -> int:
    """Pruned tile size (~8k items): at ~128k tiles every code occurs
    in every tile and the presence mask saturates."""
    return scan_block_n(N, target)


def mesh_prune_block_n(N: int, shards: int,
                       target: int = _PRUNE_BLOCK_N) -> int:
    """Pruned tile size for a ``shards``-way row-sharded catalogue: the
    divisor of the per-shard row count closest to ``target`` (the
    reference's search, ties to the first found), so one global permute-then-shard ``PruneState``
    tiles every shard's rows exactly."""
    if N % shards:
        raise ValueError(f"{N} rows do not split over {shards} shards")
    local_n = N // shards
    best = local_n
    d = 1
    while d * d <= local_n:
        if local_n % d == 0:
            for c in (d, local_n // d):
                if abs(c - target) < abs(best - target):
                    best = c
        d += 1
    return best


def _tile_scores(partial, codes_tile):
    """[B, m, b] LUT, [Nt, m] codes -> [B, Nt] scores, split order."""
    c = codes_tile.long()
    s = partial[:, 0, :].index_select(1, c[:, 0])
    for j in range(1, c.shape[1]):
        s = s + partial[:, j, :].index_select(1, c[:, j])
    return s


def jpq_topk_scan(partial, codes, k: int, *, block_n: int):
    """Plain version of the ``jpq_topk`` kernel (port of the
    reference's ``_jpq_topk_scan``): blockwise gather, block-local
    top-k, one final merge over the [B, nb·k] candidates.  A block-local
    top-k never drops a global winner, so the merge is exact."""
    B = partial.shape[0]
    N = codes.shape[0]
    vs, is_ = [], []
    for n0 in range(0, N, block_n):
        n1 = min(N, n0 + block_n)
        s = _tile_scores(partial, codes[n0:n1])
        ids = torch.arange(n0, n1, dtype=torch.int32, device=s.device)
        v, i = topk_desc(s, ids.expand(B, -1), min(k, n1 - n0))
        vs.append(v)
        is_.append(i)
    return topk_desc(torch.cat(vs, 1), torch.cat(is_, 1), k)


def jpq_topk_scan_pruned(partial, codes, ids, present, floor, vals0, idx0,
                         *, k: int, block_n: int, tie_break_ids: bool):
    """Plain version of the ``jpq_topk_pruned`` kernel (port of the
    reference's ``_jpq_topk_scan_pruned``), one query group over all B
    rows: the running (values, ids) list is the exact top-k after every
    tile, and a tile is swept only when some row's bound beats its
    running k-th value (``>`` in id order, ``>=`` under a permutation)
    and clears that row's floor.  Returns (v, i, skips [nt] int32)."""
    B = partial.shape[0]
    N = codes.shape[0]
    vals, idx = vals0, idx0
    pres = present > 0
    neg_inf = torch.tensor(-float("inf"), device=partial.device)
    skips = []
    for t, n0 in enumerate(range(0, N, block_n)):
        n1 = min(N, n0 + block_n)
        theta = vals[:, -1]
        ub = torch.zeros((B,), dtype=torch.float32, device=partial.device)
        for j in range(partial.shape[1]):
            pj = torch.where(pres[t, j][None, :], partial[:, j, :], neg_inf)
            ub = ub + pj.max(dim=1).values
        ok = (ub >= theta) if tie_break_ids else (ub > theta)
        # the floor applies per row before the any-reduce
        need = bool(torch.any(ok & (ub >= floor)))
        skips.append(0 if need else 1)
        if need:
            s = _tile_scores(partial, codes[n0:n1])
            cat_v = torch.cat([vals, s], 1)
            cat_i = torch.cat([idx, ids[n0:n1].expand(B, -1)], 1)
            vals, idx = topk_desc(cat_v, cat_i, k)
    return vals, idx, torch.tensor(skips, dtype=torch.int32,
                                   device=partial.device)
