"""Ranking metrics — unsampled, per the paper's evaluation protocol — and
the training-history schema that ``Trainer.run`` checks its rows
against before returning.
"""
from __future__ import annotations

from typing import List, Optional

import torch

# Typed history-row keys.  Rows are heterogeneous — a log row carries
# loss + exchange accounting, an eval row only eval_* values, a
# straggler row only the timing pair — so unlike the serve schema these
# keys are checked *when present*; only "step" is required on every
# row.  Keys not listed (model metric names, eval_*) must still be
# plain non-bool numbers.
HISTORY_SCHEMA = {
    "step": int,
    "sec": float,
    "loss": float,
    "payload_bytes": int,
    "exchange_wire_bytes": int,
    "exchange_shards": int,
    "exchange_fsdp": int,
    "exchange_fraction": float,
    "straggler_sec": float,
    "median_sec": float,
}

# keys that can never go negative (byte/shard counts, wall timings)
_NON_NEGATIVE = ("step", "sec", "payload_bytes", "exchange_wire_bytes",
                 "exchange_shards", "exchange_fraction",
                 "straggler_sec", "median_sec")


def validate_history(history: List[dict],
                     schema: Optional[dict] = None) -> List[str]:
    """Schema-check a Trainer history; returns a list of problems
    (empty = valid).  Checks per row: dict shape, a non-bool int
    "step", typed keys per ``HISTORY_SCHEMA`` (bools rejected where
    ints are expected, as in serve.metrics), every other value a plain
    number, non-negativity for ``_NON_NEGATIVE`` keys,
    ``exchange_fraction`` in [0, 1] and ``exchange_fsdp`` in {0, 1};
    across rows: "step" non-decreasing (multiple rows per step — log +
    eval + straggler — are legal)."""
    schema = HISTORY_SCHEMA if schema is None else schema
    errs: List[str] = []
    prev_step = None
    for i, row in enumerate(history):
        where = f"row {i}"
        if not isinstance(row, dict):
            errs.append(f"{where}: expected dict, got "
                        f"{type(row).__name__}")
            continue
        if "step" not in row:
            errs.append(f"{where}: missing 'step'")
            continue
        for k, v in row.items():
            spec = schema.get(k, (int, float))
            types = spec if isinstance(spec, tuple) else (spec,)
            if isinstance(v, bool) or not isinstance(v, types):
                errs.append(f"{where}.{k}: expected {types}, got "
                            f"{type(v).__name__}")
                continue
            if k in _NON_NEGATIVE and v < 0:
                errs.append(f"{where}.{k}: negative ({v!r})")
        frac = row.get("exchange_fraction")
        if isinstance(frac, float) and not 0.0 <= frac <= 1.0:
            errs.append(f"{where}.exchange_fraction: {frac!r} outside "
                        f"[0, 1]")
        fsdp = row.get("exchange_fsdp")
        if isinstance(fsdp, int) and not isinstance(fsdp, bool) \
                and fsdp not in (0, 1):
            errs.append(f"{where}.exchange_fsdp: {fsdp!r} not 0/1")
        step = row["step"]
        if isinstance(step, int) and not isinstance(step, bool):
            if prev_step is not None and step < prev_step:
                errs.append(f"{where}.step: {step} < previous row's "
                            f"{prev_step} (history must be "
                            f"step-ordered)")
            prev_step = step
    return errs


def rank_of(scores, target, *, rows=None):
    """scores [B, N], target [B] -> 1-based rank of the target item.
    Strict ``>``: items tied with the target rank below it.  ``rows``:
    the catalogue's size, where ``scores`` is this rank's column block
    of it on the ambient ``"model"`` mesh (``score_last`` there): the
    target's score comes from the rank that owns its column, summed over
    ``"model"`` with the others' zeros, and the counts of higher scores
    are summed over ``"model"``, so the rank equals the whole scores'."""
    n = scores.shape[-1]
    if rows is None or n == rows:
        t = torch.gather(scores, -1, target[:, None].long())     # [B, 1]
        return 1 + torch.sum(scores > t, dim=-1)
    from repro_torch import dist
    blk = dist.row_block(int(rows))
    if blk is None or blk[1] - blk[0] != n:
        raise ValueError(f"{n} score columns are neither the catalogue "
                         f"({rows}) nor this rank's block of it ({blk})")
    loc = target.long() - blk[0]
    own = (loc >= 0) & (loc < n)
    t = torch.gather(scores, -1, loc.clamp(0, n - 1)[:, None])[:, 0]
    t = dist.reduce_from_model(torch.where(own, t, torch.zeros_like(t)))
    higher = torch.sum(scores > t[:, None], dim=-1)
    return 1 + dist.reduce_from_model(higher)


def ndcg_at_k(scores, target, k: int = 10, *, rows=None):
    r = rank_of(scores, target, rows=rows)
    gain = 1.0 / torch.log2(1.0 + r.float())
    return torch.where(r <= k, gain, torch.zeros_like(gain))  # [B]


def hr_at_k(scores, target, k: int = 10, *, rows=None):
    return (rank_of(scores, target, rows=rows) <= k).float()
