"""Training loop, single device: seeded init, the step (loss, gradients,
optimizer update), microbatching, history rows, periodic eval with early
stopping, checkpoints with resume, SIGTERM save-and-exit, and the
step-time watchdog (straggler rows).

Dropout draws from a generator that is a function of ``(seed, step)``,
and of ``(seed, step, slice)`` inside a microbatched step
(``step_generator``); no generator state is carried from step to step,
so a resumed run draws the masks the uninterrupted run drew.

``microbatches > 1`` accumulates the gradients of equal batch slices in
sequence (fp32 accumulators), takes their mean over the slices and
averages the metrics, as the reference's microbatch step does.
Checkpoints (``repro_torch.ckpt``, the reference's format) hold
``values``, ``opt`` and ``early_stop``; they carry no TrainSpec layout
stamp (the port has no TrainSpec yet), and the reference restores such a
checkpoint unchecked.  The reference's mesh path and elastic
compressed-gradient exchange (``grad_compression`` /
``grad_accum_shards`` / ``fsdp`` / ``overlap``) are not yet ported:
asking for them raises.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import (AsyncCheckpointer, latest_step,
                              restore_checkpoint)
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
    ckpt_every: int = 200
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    early_stop_patience: int = 0       # 0 = off; in eval rounds
    microbatches: int = 1              # gradient accumulation
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
        ("fsdp", c.fsdp), ("overlap", c.overlap not in (None, "dispatch")))
        if on]
    if asked:
        raise NotImplementedError(
            f"Trainer options {asked} are not yet ported to repro_torch "
            f"(the single-device path is)")
    if int(c.microbatches) < 1:
        raise ValueError(f"microbatches={c.microbatches} must be >= 1")


def step_generator(seed: int, step: int, device,
                   micro: Optional[int] = None) -> torch.Generator:
    """The dropout generator of one step (of one slice of a microbatched
    step), seeded from ``(seed, step[, micro])`` alone."""
    key = (step,) if micro is None else (step, micro)
    state = np.random.SeedSequence(seed, spawn_key=key).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


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
        self._preempted = False
        self._step_times: list = []
        self.history: list = []
        self.done_step = 0

    # ----------------------------------------------------------- setup
    def _install_sigterm(self):
        """Route SIGTERM to ``_preempted``; returns the handler to put
        back (None outside the main thread, where none is installed)."""
        def _handler(signum, frame):
            self._preempted = True
        try:
            old = signal.signal(signal.SIGTERM, _handler)
        except ValueError:                         # not the main thread
            return None
        return signal.SIG_DFL if old is None else old

    def _grads(self, params, floats, batch, step: int):
        """(gradients of ``floats``, metrics) of one step: the mean over
        ``microbatches`` n equal batch slices, run in sequence into fp32
        accumulators, slice i drawing dropout from
        ``step_generator(seed, step, i)`` (``(seed, step)`` when n == 1);
        the metrics are the slices' mean."""
        n, seed, dev = int(self.cfg.microbatches), self.cfg.seed, \
            self.model.device
        rows = {int(v.shape[0]) for v in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % n:
            raise ValueError(f"microbatches={n} must divide the batch into "
                             f"equal slices; batch rows {sorted(rows)}")
        size = next(iter(rows)) // n
        acc, slices = None, []
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, mets = self.model.train_loss(
                params, mb,
                step_generator(seed, step, dev, i if n > 1 else None))
            got = torch.autograd.grad(loss, floats, allow_unused=True)
            if acc is None:
                # made after the first backward, so a one-slice step's
                # peak (inside its backward) does not hold them
                acc = [torch.zeros_like(x, dtype=torch.float32)
                       for x in floats]
            for a, g in zip(acc, got):
                if g is not None:
                    a.add_(g)
            slices.append(mets)
            del loss, got
        mets = {k: torch.stack([m[k].float() for m in slices]).mean(0)
                for k in slices[0]}
        return [a.div_(n) for a in acc], mets

    def _restore(self, params, opt_state):
        """Load the latest checkpoint: the values into ``params`` in
        place, and (opt_state, step, best metric, stale rounds)."""
        d = self.cfg.ckpt_dir
        like = {"values": params, "opt": {**opt_state, "step": np.int32(0)}}
        state, step = restore_checkpoint(d, like)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params),
                                tree_leaves(state["values"])):
                dst.copy_(src)
        opt = {**state["opt"], "step": int(state["opt"]["step"])}
        # the early-stop state rides next to "opt" (absent in older
        # checkpoints: strict=False); without it a resumed run re-arms
        # the full patience window and can train past where the
        # uninterrupted run stopped
        es, _ = restore_checkpoint(
            d, {"early_stop": {"best": np.float64(-np.inf),
                               "stale": np.int64(0)}},
            step=step, strict=False)
        return opt, step, float(es["early_stop"]["best"]), \
            int(es["early_stop"]["stale"])

    # ------------------------------------------------------------- run
    def run(self, generator: Optional[torch.Generator] = None, params=None):
        """Train up to ``cfg.steps`` steps; returns (params, history).
        ``params`` (a ``model.params()`` tree, e.g. with bridged weights)
        is trained in place; without it the model is re-initialised from
        ``generator`` (default: seeded with ``cfg.seed``).  With
        ``cfg.ckpt_dir``, the latest checkpoint there is restored first
        (values, optimizer state, early-stop state) and the run goes on
        from its step; a fresh start takes an empty directory."""
        cfg, model = self.cfg, self.model
        self._step_times = []
        self._preempted = False
        hist_start = len(self.history)
        dev = model.device
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(cfg.seed)
            params = model.init_params(generator)
        opt_state = init_opt_state(params)
        floats = [x for x in tree_leaves(params) if torch.is_floating_point(x)]
        best_metric, stale = -np.inf, 0
        start_step = 0
        ckpt = None
        if cfg.ckpt_dir:
            ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
            if latest_step(cfg.ckpt_dir) is not None:
                opt_state, start_step, best_metric, stale = self._restore(
                    params, opt_state)

        def ckpt_state():
            return {"values": params,
                    "opt": {**opt_state, "step": np.int32(opt_state["step"])},
                    "early_stop": {"best": np.float64(best_metric),
                                   "stale": np.int64(stale)}}

        # the last checkpoint is stamped with the step actually reached
        # (a preemption or early stop ends the run before cfg.steps);
        # last_saved keeps the trailing save from repeating one
        done_step, last_saved = start_step, None
        old_handler = self._install_sigterm()
        try:
            for step in range(start_step, cfg.steps):
                t0 = time.perf_counter()
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in self.data_fn(step).items()}
                got, mets = self._grads(params, floats, batch, step)
                by_id = {id(x): g for x, g in zip(floats, got)}
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
                if ckpt and cfg.ckpt_every and \
                        (step + 1) % cfg.ckpt_every == 0:
                    ckpt.save(ckpt_state(), step + 1)
                    last_saved = step + 1
                if self._preempted:
                    if ckpt and last_saved != step + 1:
                        ckpt.save(ckpt_state(), step + 1)
                        last_saved = step + 1
                    break
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
            if ckpt:
                if last_saved != done_step:
                    ckpt.save(ckpt_state(), done_step)
                ckpt.wait()                    # drain the async writer
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
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
