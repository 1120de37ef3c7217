"""Training loop, single device: seeded init, the step (loss, gradients,
optimizer update), history rows, periodic eval with early stopping, and
the step-time watchdog (straggler rows).

The reference's mesh path, elastic compressed-gradient exchange
(``grad_compression`` / ``grad_accum_shards`` / ``fsdp`` / ``overlap``),
microbatching, checkpoints and SIGTERM preemption are not yet ported:
asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.nn.module import tree_leaves
from repro_torch.train.metrics import validate_history
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state, tree_map)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 1000
    batch_size: int = 64
    log_every: int = 50
    eval_every: int = 200
    ckpt_dir: Optional[str] = None     # not yet ported
    early_stop_patience: int = 0       # 0 = off; in eval rounds
    microbatches: int = 1              # > 1 not yet ported
    watchdog_factor: float = 3.0       # flag steps slower than f * median
    seed: int = 0
    grad_compression: Optional[str] = None     # not yet ported
    grad_accum_shards: Optional[int] = None    # not yet ported
    fsdp: bool = False                         # not yet ported
    overlap: Any = None                        # not yet ported


def _unported(train_cfg: TrainConfig, opt_cfg: OptConfig, mesh, spec):
    c = train_cfg
    asked = [name for name, on in (
        ("mesh", mesh is not None), ("spec", spec is not None),
        ("grad_compression",
         c.grad_compression not in (None, "none")
         or opt_cfg.grad_compression != "none"),
        ("grad_accum_shards", c.grad_accum_shards is not None),
        ("fsdp", c.fsdp), ("overlap", c.overlap not in (None, "dispatch")),
        ("microbatches > 1", c.microbatches > 1),
        ("ckpt_dir", c.ckpt_dir is not None)) if on]
    if asked:
        raise NotImplementedError(
            f"Trainer options {asked} are not yet ported to repro_torch "
            f"(the single-device plain path is)")


class Trainer:
    def __init__(self, model, opt_cfg: OptConfig, train_cfg: TrainConfig,
                 data_fn: Callable[[int], dict],
                 eval_fn: Optional[Callable[[Any], dict]] = None,
                 mesh=None, spec=None):
        _unported(train_cfg, opt_cfg, mesh, spec)
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.data_fn = data_fn
        self.eval_fn = eval_fn
        self._step_times: list = []
        self.history: list = []
        self.done_step = 0

    def run(self, generator: Optional[torch.Generator] = None, params=None):
        """Train for ``cfg.steps`` steps; returns (params, history).
        ``params`` (a ``model.params()`` tree, e.g. with bridged weights)
        is trained in place; without it the model is re-initialised from
        ``generator`` (default: seeded with ``cfg.seed``)."""
        cfg, model = self.cfg, self.model
        self._step_times = []
        hist_start = len(self.history)
        dev = model.device
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(cfg.seed)
            params = model.init_params(generator)
        drop_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        opt_state = init_opt_state(params)
        floats = [x for x in tree_leaves(params) if torch.is_floating_point(x)]
        best_metric, stale = -np.inf, 0
        done_step = 0
        for step in range(cfg.steps):
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in self.data_fn(step).items()}
            loss, mets = model.train_loss(params, batch, drop_gen)
            got = torch.autograd.grad(loss, floats, allow_unused=True)
            by_id = {id(x): (torch.zeros_like(x) if g is None else g)
                     for x, g in zip(floats, got)}
            grads = tree_map(lambda x: by_id.get(id(x)), params)
            new, opt_state, _ = apply_updates(self.opt_cfg, opt_state,
                                              params, grads)
            with torch.no_grad():
                for n, x in zip(tree_leaves(new), tree_leaves(params)):
                    if torch.is_floating_point(x):
                        x.copy_(n)
            del got, by_id, grads, new
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            done_step = step + 1
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            if step % cfg.log_every == 0 or step == cfg.steps - 1:
                self.history.append({"step": step, **{
                    k: float(v) for k, v in mets.items()}, "sec": dt})
            if self.eval_fn and cfg.eval_every and \
                    (step + 1) % cfg.eval_every == 0:
                with torch.no_grad():
                    ev = self.eval_fn(params)
                self.history.append({"step": step, **{
                    f"eval_{k}": float(v) for k, v in ev.items()}})
                metric = float(next(iter(ev.values())))
                if cfg.early_stop_patience:
                    if metric > best_metric + 1e-6:
                        best_metric, stale = metric, 0
                    else:
                        stale += 1
                        if stale >= cfg.early_stop_patience:
                            break
        self.done_step = done_step
        problems = validate_history(self.history[hist_start:])
        if problems:
            raise RuntimeError(
                "train history failed schema validation "
                "(repro_torch.train.metrics.HISTORY_SCHEMA):\n  "
                + "\n  ".join(problems))
        return params, self.history

    def _watchdog(self, step, dt):
        self._step_times.append(dt)
        if len(self._step_times) >= 20:
            med = float(np.median(self._step_times[-100:]))
            if dt > self.cfg.watchdog_factor * med and step > 20:
                self.history.append(
                    {"step": step, "straggler_sec": dt, "median_sec": med})

