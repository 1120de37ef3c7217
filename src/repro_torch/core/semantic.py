"""Semantic-ID generative retrieval: decode items as code sequences.

RecJPQ factorises every item into ``m`` discrete sub-ids, the
"semantic ID" of generative recommenders.  This head serves that
interface: instead of sweeping the catalogue (materialise or fused
PQTopK), it decodes an item as its m-token code sequence with a
constrained beam search over the codebooks.

* ``build_code_index`` — a trie over the codes table, built on the host
  with numpy.  Per position j it holds the sorted valid key prefixes
  (``parent_node * b + code``); a continuation is valid iff its key
  binary-searches into the level's keys.  Code rows are not unique, so
  the leaves carry a CSR (``leaf_offsets`` / ``leaf_items``) from each
  complete path to its ascending item ids.
* ``semantic_decode`` — beam search over the m codebooks with
  ``jpq.partial_scores`` as the per-step logits.  Invalid continuations
  are masked to −inf, so every emitted path resolves to >= 1 real item.
  Beam scores add in the same left-to-right fp32 chain as
  ``jpq.logits`` (step 0 takes the slice itself: ``0.0 + x`` would turn
  −0.0 into +0.0), and beams are selected in ``lax.top_k``'s order
  (value desc, then the lower candidate index) through the total-order
  helper.  With ``beams >= n_paths`` the search is exhaustive and equals
  the materialise scorer bit for bit, values and tie-broken ids.
* ``code_xent`` — the matching training objective: per-position code
  cross-entropy of the target's code sequence under the same logits
  (``models/sequential.py``: ``loss="code_ce"`` or ``semantic_weight``).
* the ``"semantic-id"`` scorer, registered on import, which claims
  ``RetrievalSpec(kind="semantic")``.

The per-step extend / mask / top-W is plain torch on either device: the
reference runs it as XLA code, not as a Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine as _engine
from repro_torch.core import jpq as _jpq
from repro_torch.kernels.jpq_topk import ops as _tops

_ID_SENTINEL = np.iinfo(np.int32).max   # junk-slot id: sorts after all


# ================================================================ index

@dataclasses.dataclass(frozen=True)
class CodeIndex:
    """Trie over a ``[N, m]`` codes table, its arrays int32 tensors on
    the device of the codes it was built from.

    ``level_keys[j]`` is the sorted array of valid keys at position j, a
    key being ``parent * b + code`` with ``parent`` the key's index at
    position j−1 (0 at j=0).  Keys are level-local, hence bounded by
    ``N * b < 2**31``.  A complete path's node id at the last level is
    its leaf id; ``leaf_items[leaf_offsets[p]:leaf_offsets[p+1]]`` lists
    the path's item ids in ascending order."""
    level_keys: Tuple[torch.Tensor, ...]   # m tensors, sorted int32
    leaf_offsets: torch.Tensor             # [n_paths + 1] int32 CSR
    leaf_items: torch.Tensor               # [N] int32, ascending per leaf
    n_items: int
    n_paths: int
    max_leaf: int
    m: int
    b: int


def build_code_index(codes, b: int) -> CodeIndex:
    """Build the code-sequence trie of a codes table (a tensor or an
    array) on the host; its arrays land on the codes tensor's device
    (the CPU for an array)."""
    device = "cpu"
    if isinstance(codes, torch.Tensor):
        device, codes = codes.device, codes.cpu().numpy()
    c = np.asarray(codes).astype(np.int64)
    if c.ndim != 2:
        raise ValueError(f"codes must be [n_items, m], got shape {c.shape}")
    N, m = c.shape
    b = int(b)
    if N == 0 or m == 0:
        raise ValueError(f"codes table is empty: shape {c.shape}")
    if c.min() < 0 or c.max() >= b:
        raise ValueError(
            f"codes must lie in [0, {b}): found range "
            f"[{c.min()}, {c.max()}]")
    if N * b >= 2 ** 31:
        raise ValueError(
            f"trie keys (node*b + code) must fit int32, but "
            f"n_items*b = {N}*{b} >= 2**31; shard the catalogue first")
    # a stable lexsort by columns 0..m-1: equal rows keep ascending id
    # order, so each leaf's item list comes out ascending
    order = np.lexsort(c.T[::-1])
    sc = c[order]
    levels = []
    parent = np.zeros(N, dtype=np.int64)
    for j in range(m):
        uniq, parent = np.unique(parent * b + sc[:, j], return_inverse=True)
        levels.append(uniq.astype(np.int32))
    counts = np.bincount(parent, minlength=len(levels[-1]))
    offsets = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])

    def dev(a):
        return torch.from_numpy(a).to(device)

    return CodeIndex(
        level_keys=tuple(dev(u) for u in levels),
        leaf_offsets=dev(offsets),
        leaf_items=dev(order.astype(np.int32)),
        n_items=int(N), n_paths=int(len(counts)),
        max_leaf=int(counts.max()), m=int(m), b=b)


# A small cache so per-request scorer calls reuse one host build per
# codes table.  Holding the codes tensor keeps its id() from being
# recycled while the entry lives; its version counter, which every
# in-place write bumps (a checkpoint restored into the live params),
# keeps a stale trie from being served.
_INDEX_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_INDEX_CACHE_MAX = 8


def index_for(codes, b: int) -> CodeIndex:
    """``build_code_index`` cached on the codes tensor's identity,
    version and shape and on ``b`` (8 entries, least recently used
    dropped).  An inference tensor keeps no version counter; its entry
    is keyed without one."""
    version = None if codes.is_inference() else codes._version
    key = (id(codes), version, tuple(codes.shape), int(b))
    hit = _INDEX_CACHE.get(key)
    if hit is not None:
        _INDEX_CACHE.move_to_end(key)
        return hit[1]
    idx = build_code_index(codes, b)
    _INDEX_CACHE[key] = (codes, idx)
    while len(_INDEX_CACHE) > _INDEX_CACHE_MAX:
        _INDEX_CACHE.popitem(last=False)
    return idx


def clear_index_cache() -> None:
    """Drop every cached trie and the codes tensors the cache holds."""
    _INDEX_CACHE.clear()


# =============================================================== decode

def _select(sc, node, ok, W: int):
    """Top-W beams of the flattened candidates ([B, C] each), ties to the
    lower candidate index as ``lax.top_k``; padded to W with dead beams
    when C < W so every step has W beams."""
    B, C = sc.shape
    Wk = min(W, C)
    flat = torch.arange(C, dtype=torch.int32, device=sc.device)
    v, pick = _tops.topk_desc(sc, flat.expand(B, C), Wk)
    pick = pick.long()
    n, a = node.gather(-1, pick), ok.gather(-1, pick)
    if Wk < W:
        pad = W - Wk
        v = torch.cat([v, v.new_full((B, pad), -float("inf"))], -1)
        n = torch.cat([n, n.new_zeros((B, pad))], -1)
        a = torch.cat([a, a.new_zeros((B, pad))], -1)
    return v, n, a


def _find(keys_sorted, keys):
    """(position, present) of each of ``keys`` in the sorted level."""
    n = keys_sorted.shape[0]
    pos = torch.searchsorted(keys_sorted, keys.contiguous(), out_int32=True)
    hit = keys_sorted[pos.clamp(0, n - 1).long()] == keys
    return pos, (pos < n) & hit


def semantic_decode(part, index: CodeIndex, k: int,
                    beams: Optional[int] = None):
    """Constrained beam search over the m codebooks.

    ``part`` is ``jpq.partial_scores(p, h)``, ``[B, m, b]`` fp32.  Returns
    ``(values, ids)`` of width ``min(k, n_items)`` in the (value desc,
    id asc) total order.  ``beams=None`` (or ``beams >= n_paths``) is
    exhaustive and equals the materialise scorer bit for bit; it sizes
    ``[B, n_paths, b]`` per step, so serve a narrow width at scale."""
    if part.dim() != 3 or part.shape[1] != index.m \
            or part.shape[2] != index.b:
        raise ValueError(
            f"part must be [B, m={index.m}, b={index.b}] "
            f"(jpq.partial_scores output), got {tuple(part.shape)}")
    B, m, b = part.shape
    dev = part.device
    n_paths = index.n_paths
    W = n_paths if beams is None else max(1, min(int(beams), n_paths))
    k_eff = min(int(k), index.n_items)
    codes_b = torch.arange(b, dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(-float("inf"), device=dev)

    # step 0: which of the b codes start a valid path?  The score is the
    # partial-score slice itself (0.0 + x would turn -0.0 into +0.0)
    pos0, ok0 = _find(index.level_keys[0], codes_b)
    sc0 = torch.where(ok0[None, :], part[:, 0, :], neg_inf)
    score, node, alive = _select(sc0, pos0[None, :].expand(B, b),
                                 ok0[None, :].expand(B, b), W)

    # steps 1..m-1: extend every alive beam by all b codes
    for j in range(1, m):
        cand = node[..., None] * b + codes_b
        # dead beams get key -1: level keys are >= 0, so it can never
        # alias a live node's child
        keys = torch.where(alive[..., None], cand, -1)
        pos, ok = _find(index.level_keys[j], keys)
        sc = torch.where(ok, score[..., None] + part[:, j, :][:, None, :],
                         neg_inf)
        score, node, alive = _select(sc.reshape(B, W * b),
                                     pos.reshape(B, W * b),
                                     ok.reshape(B, W * b), W)

    # resolve the surviving paths to item ids through the leaf CSR.  A
    # leaf contributes at most w = min(max_leaf, k) items: later items
    # share its value with a larger id, so w <= k items of the same leaf
    # precede them in the total order and they cannot reach the top-k
    w = max(1, min(index.max_leaf, k_eff))
    offs_t = index.leaf_offsets
    offs = offs_t[node.clamp(0, n_paths).long()]
    lens = offs_t[(node + 1).clamp(0, n_paths).long()] - offs
    slot = torch.arange(w, dtype=torch.int32, device=dev)
    idx = offs[..., None] + slot                                # [B, W, w]
    ok_it = (slot < lens[..., None]) & alive[..., None]
    items = index.leaf_items[idx.clamp(0, index.n_items - 1).long()]
    vals = torch.where(ok_it, score[..., None], neg_inf)
    ids = torch.where(ok_it, items, _ID_SENTINEL)
    return _engine.rerank_candidates(vals.reshape(B, W * w),
                                     ids.reshape(B, W * w), k_eff)


# ====================================================== training head

def code_xent(p, h, item_ids, *, rows=None):
    """Per-position code cross-entropy of the target items' sequences.

    ``h [..., d]`` hidden states, ``item_ids [...]`` rows of the codes
    table -> ``[...]``: the sum over the m positions of
    ``-log softmax(part[j])[codes[item, j]]``, the NLL of decoding the
    target's codes under the per-step logits ``semantic_decode``
    searches (teacher-forced: position j's logits depend on h only).
    ``rows``: the catalogue's row count, where the codes hold only this
    rank's block of them (the targets' rows gathered across the ranks,
    ``core/jpq.code_rows``)."""
    part = _jpq.partial_scores(p, h)                       # [..., m, b]
    t = _jpq.code_rows(p["codes"], item_ids, rows).long()  # [..., m]
    lse = torch.logsumexp(part, -1)                        # [..., m]
    picked = part.gather(-1, t[..., None])[..., 0]
    return torch.sum(lse - picked, -1)


# ============================================================== scorer

def _semantic_scorer(eng, p, h, floor):
    """Registry strategy for ``RetrievalSpec(kind="semantic")``."""
    spec = eng.spec
    if floor is not None:
        raise ValueError(
            "warm floors are pruned-JPQ-fused-path features: semantic "
            "decoding has no pruning threshold to seed — drop the "
            "floor or serve kind='jpq' with a prune policy")
    if spec.prune or eng.prune is not None:
        raise ValueError(
            "pruning is a fused-JPQ-path feature (it skips CODE tiles); "
            "the semantic head walks the code trie instead — use "
            "prune=False with kind='semantic'")
    emb = eng.emb
    if emb is None or getattr(getattr(emb, "cfg", None), "kind", None) \
            != "jpq":
        raise ValueError(
            "the semantic-ID head decodes JPQ code sequences — bind a "
            "kind='jpq' embedding on the engine (got "
            f"{getattr(getattr(emb, 'cfg', None), 'kind', None)!r})")
    idx = index_for(p["codes"], int(emb.cfg.b))
    part = _jpq.partial_scores(p, h)
    beams = spec.beams if spec.beams is not None else max(32, 4 * spec.k)
    return semantic_decode(part, idx, spec.k, beams=beams)


# at the front: the built-in materialise entry claims every non-"jpq"
# kind, so the semantic head must be consulted first
_engine.register_scorer("semantic-id", lambda s: s.kind == "semantic",
                        _semantic_scorer)
