"""Catalogue-wide top-k and pooled lookups, on one device or over the
``"model"`` axis of the ambient mesh (``dist.use_mesh_rules``).

Under a mesh whose ``"model"`` axis S divides the catalogue's rows, each
rank serves its own block of rows (``dist.row_block``) through the
kernels, and only small results cross ranks (``HostMesh.all_gather`` /
``all_reduce``): the ``[B, S·k]`` candidate lists, a ``[B]`` threshold,
a ``[B, d]`` pooled sum.  The catalogue operand may be passed whole (its
rows are sliced here, a view) or as this rank's block, and ``rows``
says which: the catalogue's row count, where the operand holds only
``rows / S`` of them (``bridge.keep_local_rows``).  Without a mesh, with
``model == 1``, or where S does not divide the rows, the unsharded
branch runs, as in the reference.

The mesh branches are the reference's ``shard_map`` bodies, in the same
order of operations, so the top-k results are bit-identical to the
unsharded path (values and ids, ties to the smallest id); the pooled
lookup sums over ranks in another order and is held within fp32
rounding.  The queries' batch is split over the ``"data"`` axis as the
reference's ``("batch", None)`` spec splits it, and every rank returns
the whole ``[B, ...]`` result, as the reference's global array is.
"""
from __future__ import annotations

import torch

from repro_torch import dist as _dist
from repro_torch.dist import rules as _rules
from repro_torch.kernels.embedding_bag import ops as _bag
from repro_torch.kernels.jpq_topk import ops as _tops

_TOPK_BLOCK = 131072


def _split(x, rows, dim: int = 0):
    """(mesh, (lo, hi), this rank's block of ``x``) when the ambient
    mesh splits a catalogue of ``rows`` rows (``x``'s ``dim`` holds all
    of them or this rank's block); else (None, None, ``x``)."""
    n = x.shape[dim]
    rows = n if rows is None else int(rows)
    blk = _dist.row_block(rows)
    if blk is None:
        if n != rows:
            raise ValueError(f"an operand of {n} rows is a block of a "
                             f"{rows}-row catalogue, but no ambient mesh "
                             f"splits it (dist.use_mesh_rules)")
        return None, None, x
    lo, hi = blk
    if n == rows:
        return _rules._CTX.mesh, blk, x.narrow(dim, lo, hi - lo)
    if n != hi - lo:
        raise ValueError(f"an operand of {n} rows is neither the "
                         f"catalogue ({rows}) nor a rank's block "
                         f"({hi - lo})")
    return _rules._CTX.mesh, blk, x


def _batch_rows(B: int, mesh):
    """This rank's (lo, hi) of the queries and whether they are split:
    the reference's ``resolve_axes(("batch", None), ...)`` spec."""
    spec = _rules.resolve_axes(("batch", None), (B, 1), mesh, _rules._CTX.rules)
    if spec[0] is None:
        return 0, B, False
    D = mesh.shape["data"]
    lo = mesh.data_index * (B // D)
    return lo, lo + B // D, True


def _gather_pair(mesh, v, i, axis: str, dim: int):
    """All-gather values and int32 ids in one collective (packed as
    int32 bits), concatenated on ``dim`` in ascending ``axis`` index."""
    if mesh.shape[axis] == 1:
        return v, i
    both = mesh.all_gather(torch.stack([v.contiguous().view(torch.int32),
                                        i.to(torch.int32)]), axis, dim + 1)
    return both[0].view(torch.float32), both[1]


def _local_topk(scores, k: int):
    """scores [B, n] -> (values, ids) [B, min(k, n)], ties to the
    smallest id: column-block-local top-k, then one exact merge."""
    B, N = scores.shape
    k = min(int(k), N)
    vs, is_ = [], []
    for n0 in range(0, N, _TOPK_BLOCK):
        n1 = min(N, n0 + _TOPK_BLOCK)
        ids = torch.arange(n0, n1, dtype=torch.int32, device=scores.device)
        v, i = _tops.topk_desc(scores[:, n0:n1], ids.expand(B, -1),
                               min(k, n1 - n0))
        vs.append(v)
        is_.append(i)
    return _tops.topk_desc(torch.cat(vs, 1), torch.cat(is_, 1), k)


def pooled_lookup(table, ids, weights, *, rows=None):
    """table [V, d] (or this rank's ``[V/S, d]`` block; ``rows`` = V),
    ids [B, H] int, weights [B, H] float -> pooled [B, d] =
    sum_h w * table[ids], through the embedding_bag kernel (its plain
    version on a CPU tensor).  On a mesh each rank pools the ids of its
    own rows (``embedding_bag_block``: the other ranks' slots add
    nothing, and their gradient reaches no row) and the ``[B, d]``
    partial sums are summed over ``"model"`` (``reduce_from_model``, so
    the pooled gradient reaches every rank's block).  Serving splits the
    queries over ``"data"`` and gathers the result; inside the Trainer
    each rank's rows are already its own (``local_batch``)."""
    mesh, blk, tab = _split(table, rows)
    if mesh is None:
        return _bag.embedding_bag(table, ids, weights)
    lo, hi = blk
    b0, b1, split = (0, ids.shape[0], False) if _rules._CTX.local_batch \
        else _batch_rows(ids.shape[0], mesh)
    loc = ids[b0:b1] - lo
    own = (loc >= 0) & (loc < hi - lo)
    pooled = _bag.embedding_bag_block(tab, loc, own, weights[b0:b1])
    pooled = _dist.reduce_from_model(pooled, mesh)
    return mesh.all_gather(pooled, "data", 0) if split else pooled


def take_rows(table, ids, *, rows=None):
    """``table[ids]`` for a catalogue table held whole or as this rank's
    block (``rows``), exactly: on a mesh each rank gathers the ids of
    its own rows, zeros elsewhere (``embedding_bag/ops.gather_block``),
    and the sum over ``"model"`` adds one nonzero term to zeros.  The
    port's counterpart of GSPMD's partitioned gather of the reference's
    row-sharded codes and tables (the sequential models' inputs and
    labels, the JPQ user tower, the CTR models' fields); every rank gets
    every row.  Differentiable in a float ``table``: the gradient of the
    rows (the same on every rank) reaches each rank's own rows through
    the embedding_bag backward kernel, the other ranks' slots skipped."""
    mesh, blk, tab = _split(table, rows)
    if mesh is None:
        return _bag.gather(table, ids)
    lo, hi = blk
    loc = ids.long() - lo
    own = (loc >= 0) & (loc < hi - lo)
    return _dist.reduce_from_model(_bag.gather_block(tab, loc, own), mesh)


class _VocabParallelXent(torch.autograd.Function):
    """Cross-entropy over a catalogue whose logits' columns are split
    over ``"model"``: ``logits [T, n]`` this rank's columns ``[lo, lo +
    n)``, ``labels [T]`` global ids -> ``ce [T]`` fp32, the same on every
    rank.  Forward: this rank's max, then the global max (one MAX
    all-reduce of ``[T]``); this rank's sum of ``exp(l - max)`` and the
    label's logit where this rank owns it, zero elsewhere, summed over
    the ranks together (one SUM all-reduce of ``[2, T]``).  Reductions
    run in fp32 and the label's logit is read in the logits' dtype, as
    the reference's LM loss reads bf16 logits (``logits_bf16``).
    Backward: ``g (softmax - onehot)`` on this rank's columns, written
    into one ``[T, n]`` buffer (bf16 logits: ``g softmax`` rounded to
    bf16, then ``-g`` added at the label in bf16, the two terms of the
    reference's gradient); the logits are saved, nothing else of ``[T,
    n]`` is kept between the passes."""

    @staticmethod
    def forward(ctx, logits, labels, lo, mesh):
        n = logits.shape[-1]
        wide = logits.float()
        gmax = _dist.max_over_model(wide.max(-1).values, mesh)
        sumexp = torch.sub(wide, gmax[:, None]).exp_().sum(-1)
        del wide
        loc = labels.long() - lo
        own = (loc >= 0) & (loc < n)
        picked = torch.gather(logits, -1,
                              loc.clamp(0, n - 1)[:, None])[:, 0].float()
        picked = torch.where(own, picked, torch.zeros_like(picked))
        both = mesh.all_reduce(torch.stack([sumexp, picked]), "model", "sum")
        lse = torch.log(both[0]) + gmax
        ctx.save_for_backward(logits, lse, loc, own)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, loc, own = ctx.saved_tensors
        n = logits.shape[-1]
        at = loc.clamp(0, n - 1)[:, None]
        d = torch.sub(logits.float(), lse[:, None]).exp_()       # softmax
        if logits.dtype == torch.float32:
            d.scatter_add_(-1, at, -own.to(d.dtype)[:, None])
            return d.mul_(g[:, None]), None, None, None
        d = d.mul_(g[:, None]).to(logits.dtype)
        pick = torch.where(own, -g, torch.zeros_like(g)).to(logits.dtype)
        return d.scatter_add_(-1, at, pick[:, None]), None, None, None


def vocab_parallel_xent(logits, labels, lo: int, mesh):
    """The per-position cross-entropy ``lse - logits[label]`` over the
    whole catalogue from this rank's column block ``logits [..., n]``
    (columns ``[lo, lo + n)``, split over ``mesh``'s ``"model"`` axis;
    fp32, or bf16 read as the reference's LM loss reads it) and the
    global ``labels [...]``: ``[...]`` fp32, the same on every rank."""
    n = logits.shape[-1]
    ce = _VocabParallelXent.apply(logits.reshape(-1, n),
                                  labels.reshape(-1), int(lo), mesh)
    return ce.reshape(labels.shape)


def whole(x, rows=None):
    """The whole catalogue operand: ``x`` when it holds all ``rows``
    rows, else every rank's block gathered over ``"model"`` (set-up
    work, such as building a pruning state, not the request path)."""
    mesh, _, block = _split(x, rows)
    if mesh is None or block is not x:       # no mesh, or x is whole
        return x
    return mesh.all_gather(x, "model", 0)


def _merge_local_topk(mesh, v, i, local_n: int, k: int):
    """Per-shard lists (shard-relative ids) -> the global top-k: ids
    offset by the shard's first row, the ``[B, S·k_loc]`` candidates
    gathered in ascending-shard order, and the (value desc, id asc)
    top-k — the order of a top-k over the unsharded scores."""
    i = i + mesh.model_index * local_n
    v_all, i_all = _gather_pair(mesh, v, i, "model", 1)
    return _tops.topk_desc(v_all, i_all, k)


def _merge_pruned_topk(mesh, v, i, k: int):
    """Pruned per-shard lists already carry original ids (each shard's
    slice of the global id-map): gather, then the total-order top-k,
    which does not depend on the order of the candidates."""
    v_all, i_all = _gather_pair(mesh, v, i, "model", 1)
    return _tops.topk_total_order(v_all, i_all, k)


def topk_over_items(scores, k: int, *, rows=None):
    """scores [B, N] (or this rank's ``[B, N/S]`` column block; ``rows``
    = N) -> (values, ids) [B, min(k, N)], ties to the smallest id.  On a
    mesh: a local top-k per shard, then the merge of the ``[B, S·k]``
    candidates."""
    B = scores.shape[0]
    mesh, blk, s = _split(scores, rows, dim=1)
    if mesh is None:
        return _local_topk(scores, k)
    lo, hi = blk
    k = min(int(k), (hi - lo) * mesh.shape["model"])
    b0, b1, split = _batch_rows(B, mesh)
    v, i = _local_topk(s[b0:b1], min(k, hi - lo))
    v, i = _merge_local_topk(mesh, v, i, hi - lo, k)
    return _gather_pair(mesh, v, i, "data", 0) if split else (v, i)


def fused_topk_over_codes(partial, codes, k: int, *,
                          block_n: int | None = None, prune=None, perm=None,
                          warm=None, exchange_tiles: int | None = None,
                          return_stats: bool = False, rows=None):
    """PQTopK serving: fused score + top-k over the codes.  partial
    [B, m, b] fp32 LUT, codes [N, m] (or this rank's ``[N/S, m]`` block;
    ``rows`` = N) -> (values, ids) [B, min(k, N)] (+ the pruning stats
    dict when ``return_stats``).

    On a mesh, unpruned: ``jpq_topk`` over the rank's code rows, then
    ``_merge_local_topk``.  Pruned, the reference's mesh-native path:
      * permute-then-shard — ``prune`` is one global ``PruneState``
        (``engine.build_prune_state(codes, b, shards=S, perm=perm)``)
        that each rank row-slices; a state whose tiles straddle the
        shards raises; ``prune=True`` builds it here (tests, one-offs);
      * the threshold exchange — after ``t_ex`` tiles the max over
        ``"model"`` of the running k-th values floors the rest of the
        sweep (strict skip), which resumes from the carried lists;
      * warm floors — the re-sweep of overshot queries is decided on
        the merged list, the same on every rank.
    Stats are the reference's: tile counts summed over the model shards
    and averaged over the data shards (``total_tiles`` = nt_loc · S),
    ``skips`` [nt_loc · S], ``theta``, ``exchange_tiles``, ``demoted``."""
    if not prune and (warm is not None or return_stats):
        raise ValueError(
            "warm floors / stats are pruned-path features: the warm "
            "floor seeds the pruning threshold and the stats dict "
            "counts skipped tiles, neither of which exists on the "
            "unpruned sweep — pass prune=True (or a prepare_pruning(...) "
            "state), or drop warm=/return_stats=")
    mesh, blk, codes_l = _split(codes, rows)
    if mesh is None:
        return _tops.jpq_topk_lut(partial, codes, k, block_n=block_n,
                                  prune=prune, perm=perm, warm=warm,
                                  return_stats=return_stats)
    B = partial.shape[0]
    S = mesh.shape["model"]
    local_n = blk[1] - blk[0]
    N = local_n * S
    k_out = min(int(k), N)
    k_loc = min(k_out, local_n)
    b0, b1, split = _batch_rows(B, mesh)

    if not prune:
        v, i = _tops.jpq_topk_lut(partial[b0:b1], codes_l, k_loc,
                                  block_n=block_n)
        v, i = _merge_local_topk(mesh, v, i, local_n, k_out)
        return _gather_pair(mesh, v, i, "data", 0) if split else (v, i)

    # ---------------------------------------- mesh-native pruned path
    if N >= 2 ** 24:
        raise ValueError(f"the total-order merge caps ids at 2^24, N={N}")
    if isinstance(prune, _tops.PruneState):
        st = prune
        if st.codes.shape[0] != N:
            raise ValueError(f"PruneState covers {st.codes.shape[0]} rows, "
                             f"catalogue has {N}")
        if local_n % st.block_n != 0:
            raise ValueError(
                f"PruneState block_n={st.block_n} straddles the "
                f"{local_n}-row shards of a {S}-way mesh; build it "
                f"once with prepare_pruning(codes, b, "
                f"mesh_prune_block_n(N, shards), perm=perm)")
        bn = st.block_n
    else:
        bn = block_n if (block_n and local_n % block_n == 0) \
            else _tops.mesh_prune_block_n(N, S)
        st = _tops.prepare_pruning(whole(codes, N), partial.shape[2], bn,
                                   perm=perm)
    nt_loc = local_n // bn
    t_ex = None
    if S > 1 and nt_loc > 1 and k_loc == k_out:
        t_ex = exchange_tiles if exchange_tiles else -(-k_loc // bn)
        t_ex = min(int(t_ex), nt_loc - 1)
    D = mesh.shape["data"]
    lo, t0 = blk[0], mesh.model_index * nt_loc
    partial = _tops.canonicalise_lut(partial.float()).contiguous()
    part_l = partial[b0:b1]
    floor0 = torch.full((B,), -float("inf"), device=partial.device) \
        if warm is None else _tops._as_floor(warm, B, partial.device)

    def sub(a, b):                           # tile range of this shard
        return _tops.PruneState(st.codes[lo + a * bn:lo + b * bn],
                                st.ids[lo + a * bn:lo + b * bn],
                                st.present[t0 + a:t0 + b], bn,
                                st.tie_break_ids)

    def run(fl):
        fl = fl[b0:b1]
        if t_ex is not None:
            v1, i1, s1 = _tops.pruned_sweep(part_l, sub(0, t_ex), k_loc,
                                            block_n=bn, floor=fl)
            # running k_loc-th values are real scores: their max over
            # the shards is <= the final global k-th, an admissible floor
            theta_ex = mesh.all_reduce(v1[:, -1].contiguous(), "model",
                                       "max")
            v2, i2, s2 = _tops.pruned_sweep(
                part_l, sub(t_ex, nt_loc), k_loc, block_n=bn,
                floor=torch.maximum(fl, theta_ex), carry=(v1, i1))
            skips = torch.cat([s1, s2])
        else:
            v2, i2, skips = _tops.pruned_sweep(part_l, sub(0, nt_loc), k_loc,
                                               block_n=bn, floor=fl)
        vm, im = _merge_pruned_topk(mesh, v2, i2, k_out)
        if split:
            vm, im = _gather_pair(mesh, vm, im, "data", 0)
        return vm, im, skips

    vm, im, skips = run(floor0)
    demoted = torch.zeros((B,), dtype=torch.bool, device=vm.device)
    if warm is not None:
        # the merged k-th value certifies the floor (list values are
        # real scores <= the true global k-th); the same on every rank
        ok = vm[:, -1] >= floor0
        demoted = ~ok
        if not bool(ok.all()):
            vm, im, skips = run(torch.where(ok, floor0,
                                            torch.full_like(floor0,
                                                            -float("inf"))))
    if not return_stats:
        return vm, im
    # model shards sweep disjoint tiles (gathered), data shards repeat
    # the sweep for their batch slice (summed, then / D)
    per_tile = mesh.all_gather(mesh.all_reduce(skips.float(), "data", "sum"),
                               "model", 0)
    return vm, im, {"skipped_tiles": per_tile.sum() / D,
                    "total_tiles": nt_loc * S, "skips": per_tile / D,
                    "theta": vm[:, -1], "demoted": demoted,
                    "exchange_tiles": 0 if t_ex is None else t_ex}
