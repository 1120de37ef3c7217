"""Optimizers over parameter trees: adamw, adam and sgd, with global-norm
clipping, decoupled weight decay and three lr schedules.

``values`` and ``grads`` are trees (dicts and lists) of tensors of the
same shape.  Non-float leaves (the frozen RecJPQ codes) are carried
through untouched: their moment slots are empty and their grads are
ignored.  The scalars (lr, bias corrections, clip scale) are float32,
as in the reference.  ``apply_updates`` is functional; the Trainer
copies its result into the live parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.nn.module import tree_leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adam | sgd
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    schedule: str = "constant"   # constant | cosine | linear_warmup_cosine
    warmup_steps: int = 0
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # deprecated duplicate of TrainConfig.grad_compression (the elastic
    # exchange's method; train.spec.spec_for reads both, "none" = unset)
    grad_compression: str = "none"


# the stats apply_updates adds to a step's metrics
OPT_STATS = ("grad_norm", "lr")


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The lr at ``step`` (1-based), a float32 scalar tensor on the CPU."""
    step = _f32(float(step))
    lr = _f32(cfg.lr)
    if cfg.schedule == "constant":
        return lr
    warm = (torch.clamp(step / max(cfg.warmup_steps, 1), 0.0, 1.0)
            if cfg.warmup_steps > 0 else _f32(1.0))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * prog))
    cos = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return lr * (warm * cos if cfg.schedule.endswith("cosine") else warm)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def init_opt_state(values):
    def _slot(x):
        if torch.is_floating_point(x):
            return torch.zeros_like(x, dtype=torch.float32).detach()
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    return {"m": tree_map(_slot, values), "v": tree_map(_slot, values),
            "step": 0}


def global_norm(grads, *, split=None, mesh=None) -> torch.Tensor:
    """The L2 norm over every float leaf.  ``split`` (a bool a leaf of
    ``tree_leaves(grads)``) marks the leaves that hold this rank's block
    of a ``"model"`` mesh: their sums of squares are summed over
    ``"model"`` (one all-reduce), the whole leaves' count once, so every
    rank clips by the whole gradient's norm."""
    sq = [(i, torch.sum(torch.square(g.float())))
          for i, g in enumerate(tree_leaves(grads))
          if g is not None and torch.is_floating_point(g) and g.numel()]
    if not sq:
        return _f32(0.0)
    mine = [j for j, (i, _) in enumerate(sq) if split is not None and
            split[i]]
    if mine and mesh is not None:
        red = mesh.all_reduce(torch.stack([sq[j][1] for j in mine]),
                              "model", "sum")
        for j, r in zip(mine, red):
            sq[j] = (sq[j][0], r)
    return torch.sqrt(sum(s for _, s in sq))


@torch.no_grad()
def apply_updates(cfg: OptConfig, state, values, grads, *, grad_norm=None):
    """Returns (new_values, new_state, stats).  ``weight_decay`` is
    decoupled for every kind: added to the update after the gradient or
    moment term, scaled by the scheduled lr but not by the clip scale.
    The moments are updated in place: ``new_state`` holds the tensors of
    ``state``."""
    if cfg.kind not in ("adamw", "adam", "sgd"):
        raise ValueError(f"unknown optimizer kind {cfg.kind!r}")
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9),
                            max=1.0)
    t = _f32(float(step))
    bc1 = 1.0 - torch.pow(_f32(cfg.b1), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2), t)

    def _upd(p, g, m, v):
        if not torch.is_floating_point(p):
            return p, m, v
        dev = p.device
        g = g.float()
        if scale is not None:
            g = g * scale.to(dev)
        p32 = p.float()
        if cfg.kind == "sgd":
            update = g
        else:
            # in place: a second copy of the moments would be held
            # otherwise; the same roundings as b1 * m + (1 - b1) * g
            m = m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
            v = v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
            update = (m / bc1.to(dev)) / (torch.sqrt(v / bc2.to(dev))
                                          + cfg.eps)
        if cfg.weight_decay > 0:
            update = update + cfg.weight_decay * p32
        return (p32 - lr.to(dev) * update).to(p.dtype), m, v

    out = tree_map(_upd, values, grads, state["m"], state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "step": step}
    return _pick(out, 0), new_state, {"grad_norm": gn, "lr": lr}


def _pick(tree, i):
    """The i-th entry of each (p, m, v) tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
