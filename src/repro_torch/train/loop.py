"""Training loop: the step (loss, gradients, optimizer update) built
through the training engine (``repro_torch.train.spec``), history rows,
periodic eval with early stopping, checkpoints stamped with the
TrainSpec layout and resumed after checking it, SIGTERM save-and-exit,
and the step-time watchdog (straggler rows).

The policy is one ``TrainSpec``, handed over or derived from the legacy
``TrainConfig`` / ``OptConfig`` knobs by ``spec_for`` (a conflicting
duplicate raises), and the step comes from the step-builder registry:

  * plain / microbatch: one device, or with ``mesh`` plain data
    parallelism — each rank takes its rows of the batch (by its index
    on the ``"data"`` axis; a model with a ``local_batch(batch, mesh)``
    hook places the batch itself: MACE's share of a graph, which has no
    rows to cut, so it takes no elastic spec and no microbatches), and
    the loss is the whole batch's, as the
    reference's one step over the global batch is: before the forward
    the counts each loss term is a mean over (``model.loss_counts``)
    are summed over ``"data"`` in one small ``all_reduce`` and installed
    (``dist.use_loss_counts``), so a rank's loss is its local sums over
    the whole batch's counts, and the ranks' gradients and metrics are
    summed (one ``all_reduce`` each) — and, on a mesh whose ``"model"``
    axis is S > 1, tensor parallelism: the Trainer installs the mesh
    (``dist.use_mesh_rules``), cuts the parameters to their blocks
    (``bridge.keep_local_blocks`` of the model's ``placement``; the Adam
    moments are made from them), clips by the global norm with the
    split leaves' squares summed over ``"model"``, and the model's own
    collectives do the rest (``models/sequential.py``,
    ``models/recsys.py``, ``models/lm.py``);
  * elastic (``grad_compression`` / ``grad_accum_shards`` / ``fsdp`` /
    ``overlap``): ``repro_torch.dist.compression``'s exchange over ``V``
    virtual shards with error feedback, bitwise across world sizes
    dividing ``V``.  The error state is checkpointed under ``"err"`` as
    ``[V, ...]`` rows, so a run preempted on N processes resumes on any
    N' dividing ``V`` bit-identically.  ``fsdp`` keeps this rank's rows
    of the V-divisible leaves of the values and moments.

Dropout draws from a generator that is a function of ``(seed, step)``,
of ``(seed, step, slice)`` in a microbatched step and of ``(seed, step,
v)`` for virtual shard ``v`` (``step_generator``); no generator state is
carried from step to step, so a resumed run draws the masks the
uninterrupted run drew.  Checkpoints are the reference's format
(``repro_torch.ckpt``): ``values``, ``opt``, ``early_stop`` and, on the
elastic path, ``err``; rank 0 writes them and picks the step every
rank of a mesh restores (``Trainer._restore_step``).  On a ``"model"``
mesh every split leaf and its moments are gathered first, so a
checkpoint holds whole leaves under the reference's keys, and a restore
cuts each rank's blocks: a run saved at ``(1, 2)`` resumes at ``(1, 1)`` or
``(1, 2)``.  A model without a ``placement`` does not train on one.

The elastic step on a ``(D, S)`` mesh replicates the model over
``"model"``, as the reference's ``shard_map`` does: the Trainer installs
no ambient mesh and cuts no blocks, so every rank holds whole leaves
(no ``placement`` needed), the S ranks of a data column run the same
rounds on the same rows, and the exchange runs over the ``"data"``
group.  Its state is the ``(D, 1)`` step's, bit for bit, on every rank
of the column; rank 0 writes the checkpoints, and a run saved at ``(D,
S)`` resumes on any ``(D', S')`` with D' dividing ``V``.
"""
from __future__ import annotations

import dataclasses
import functools
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import (AsyncCheckpointer, checkpoint_metadata,
                              latest_step, restore_checkpoint)
from repro_torch.dist import gather_block, local_block, model_dim
from repro_torch.nn.module import tree_leaves
from repro_torch.train import spec as spec_mod
from repro_torch.train.metrics import validate_history
from repro_torch.train.optimizer import (OPT_STATS, OptConfig,
                                         apply_updates, global_norm,
                                         init_opt_state, tree_map)
from repro_torch.train.spec import TrainSpec


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
    # the elastic compressed-gradient exchange (repro_torch.dist.
    # compression): setting grad_compression ("none" / "bf16" / "int8"),
    # grad_accum_shards or fsdp routes the mesh step through it — the
    # batch cut into grad_accum_shards virtual shards (default: the
    # mesh's data-parallel degree), payloads exchanged compressed with
    # per-shard error feedback, bitwise across world sizes dividing the
    # shard count.  None inherits OptConfig.grad_compression
    grad_compression: Optional[str] = None
    grad_accum_shards: Optional[int] = None
    # each rank owns a row slice of the values and moments whose leading
    # dim divides by the shard count; the round's exchange becomes an
    # ordered reduce-scatter
    fsdp: bool = False
    # host schedule of the exchange rounds: "none" | "dispatch" |
    # "backward" (legacy bools accepted; None = "dispatch"); every mode
    # is bitwise identical, so it is not part of the checkpoint layout
    overlap: Any = None


def step_generator(seed: int, step: int, device,
                   micro: Optional[int] = None) -> torch.Generator:
    """The dropout generator of one step (of slice or virtual shard
    ``micro`` of a step), seeded from ``(seed, step[, micro])`` alone."""
    key = (step,) if micro is None else (step, micro)
    state = np.random.SeedSequence(seed, spawn_key=key).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def sum_over_ranks(tensors, mesh, *, inplace: bool = False):
    """The sum of each tensor over the ``"data"`` group (one
    ``all_reduce`` of their fp32 concatenation).  ``inplace``: each sum
    is written into its tensor, which must not share memory with another
    (a model's gradients: no second copy of them is held)."""
    buf = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    buf = mesh.all_reduce(buf, "data", "sum")
    out, off = [], 0
    for t in tensors:
        out.append(buf[off:off + t.numel()].view(t.shape).to(t.dtype))
        if inplace:
            out[-1] = t.copy_(out[-1])
        off += t.numel()
    return out


def counted_loss(model, mesh, loss_fn=None):
    """``loss_fn(values, batch[, generator])`` (default:
    ``model.train_loss``; it returns (loss, metrics)) with the whole
    batch's loss counts installed: this rank's
    ``model.loss_counts(batch)`` summed over ``"data"`` (one
    ``all_reduce`` before the forward).  Each rank's loss is then its
    share of the whole batch's, and the sum over the ranks of the
    losses, gradients and metrics is the whole batch's.  A model without
    ``loss_counts`` counts its rows, its loss and metrics scaled by
    this rank's share of them."""
    from repro_torch import dist as _dist
    loss_fn = loss_fn or model.train_loss
    counts = getattr(model, "loss_counts", None)

    def fn(values, batch, *args):
        local = (counts(batch) if counts is not None else
                 {"rows": len(next(iter(batch.values())))})
        keys = list(local)
        tot = mesh.all_reduce(torch.stack([
            torch.as_tensor(local[k], device=mesh.device).reshape(())
            .to(torch.int64) for k in keys]), "data", "sum")
        if counts is None:
            # a model without loss_counts is taken to be a mean over its
            # rows: its share of the whole batch's mean
            share = float(local["rows"]) / float(tot[0])
            loss, mets = loss_fn(values, batch, *args)
            return loss * share, {k: v * share for k, v in mets.items()}
        with _dist.use_loss_counts(dict(zip(keys, tot.to(model.device)))):
            return loss_fn(values, batch, *args)
    return fn


def _storage_key(t):
    """What tells ``t``'s storage from another's: its address, or for a
    fake tensor (the dry run's trace), which has none, the storage
    object itself."""
    from repro_torch.kernels.library import has_data
    st = t.untyped_storage()
    return st.data_ptr() if has_data(t) else id(st)


def _spec_leaves(specs):
    """The placement specs (tuples) of a specs tree, in leaf order."""
    if isinstance(specs, dict):
        return [x for k in specs for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def _whole_like(x, spec, mesh):
    """An empty host tensor shaped as the whole leaf whose block ``x`` is
    (the shape a checkpoint holds)."""
    shape = list(x.shape)
    k = model_dim(spec)
    if k is not None:
        shape[k] *= mesh.shape["model"]
    return torch.empty(shape, dtype=x.dtype, device="cpu")


class Trainer:
    def __init__(self, model, opt_cfg: OptConfig, train_cfg: TrainConfig,
                 data_fn: Callable[[int], dict],
                 eval_fn: Optional[Callable[[Any], dict]] = None,
                 mesh=None, rules=None, spec: Optional[TrainSpec] = None):
        self.model = model
        self.rules = rules
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.data_fn = data_fn
        self.eval_fn = eval_fn
        self.mesh = mesh
        self._preempted = False
        self._step_times: list = []
        self.history: list = []
        self.done_step = 0
        self.err_state = None              # error feedback, [V, ...] rows
        self.opt_state = None
        # the legacy knobs normalise to a TrainSpec; an explicit spec
        # wins over default knobs, and disagreeing with non-default ones
        # raises
        derived = spec_mod.spec_for(
            grad_compression=train_cfg.grad_compression,
            opt_grad_compression=opt_cfg.grad_compression,
            grad_accum_shards=train_cfg.grad_accum_shards,
            fsdp=train_cfg.fsdp, overlap=train_cfg.overlap,
            microbatches=train_cfg.microbatches)
        if spec is None:
            spec = derived
        elif derived != TrainSpec() and derived != spec:
            raise ValueError(
                f"Trainer got an explicit TrainSpec {spec} AND "
                f"conflicting legacy TrainConfig/OptConfig knobs "
                f"(which resolve to {derived}); set the policy in one "
                f"place")
        self.spec = spec
        # a model that places its own batch on the data ranks (a graph's
        # shares: MACE's ``local_batch``) has no rows to cut
        self._local_batch = getattr(model, "local_batch", None)
        if self._local_batch is not None and (spec.elastic
                                              or spec.microbatches > 1):
            raise ValueError(
                f"{type(model).__name__} trains on a graph batch, which "
                f"has no rows to split: it takes neither an elastic spec "
                f"(grad_compression / grad_accum_shards / fsdp), which "
                f"cuts the batch into virtual shards of rows, nor "
                f"microbatches={spec.microbatches}")
        self._use_dp = spec.elastic
        self._fsdp = spec.fsdp
        if self._use_dp and mesh is None:
            raise ValueError(
                "grad_compression / grad_accum_shards / fsdp "
                "require a mesh")
        self._accum = spec.resolve_accum(mesh) if self._use_dp else None
        self._world = 1 if mesh is None else spec_mod.dp_degree(mesh)
        self._rank = 0 if mesh is None else mesh.rank
        # the elastic step replicates the model over "model", as the
        # reference's shard_map does: no ambient mesh, whole leaves
        self._split = (mesh is not None and mesh.shape.get("model", 1) > 1
                       and not spec.elastic)
        if self._split:
            if not hasattr(model, "placement"):
                raise ValueError(
                    f"{type(model).__name__} has no placement, so it "
                    f"does not train on a 'model' mesh axis")
        # plain data parallelism: the data group's counts
        self._counted = not self._use_dp and self._world > 1
        self._specs = None                 # the placement, when split

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

    def _loss_and_apply(self):
        """The StepContext ingredients of every builder: the model's
        loss, and the optimizer hook (``grad_norm=`` is how the fsdp
        combine passes its norm).  On a data-parallel mesh without the
        elastic exchange, the loss divides by the whole batch's counts
        (``counted_loss``) and the hook first sums the gradients over
        the ranks."""
        model, opt_cfg, mesh = self.model, self.opt_cfg, self.mesh
        split = (None if self._specs is None else
                 [model_dim(sp) is not None
                  for sp in _spec_leaves(self._specs)])

        def loss_fn(values, batch, generator=None):
            return model.train_loss(values, batch, generator)

        if self._counted:
            loss_fn = counted_loss(model, mesh, loss_fn)

        def apply_fn(values, opt_state, grads, grad_norm=None):
            if split is not None and grad_norm is None:
                grad_norm = global_norm(grads, split=split, mesh=mesh)
            return apply_updates(opt_cfg, opt_state, values, grads,
                                 grad_norm=grad_norm)

        if self._use_dp or self._world == 1:
            return loss_fn, apply_fn

        def apply_dp(values, opt_state, grads, grad_norm=None):
            flat = [g for g in tree_leaves(grads) if g is not None]
            if len({_storage_key(g) for g in flat}) == len(flat):
                sum_over_ranks(flat, mesh, inplace=True)
            else:                 # aliased gradients: summed as copies
                by_id = dict(zip(map(id, flat), sum_over_ranks(flat, mesh)))
                grads = tree_map(lambda g: by_id.get(id(g), g), grads)
            del flat
            return apply_fn(values, opt_state, grads, grad_norm=grad_norm)
        return loss_fn, apply_dp

    def _build_step(self):
        """The plain / microbatch step of the registry: ``train_step(
        values, opt_state, batch, rng) -> (new_values, new_opt, mets)``."""
        loss_fn, apply_fn = self._loss_and_apply()
        spec = self.spec if not self.spec.elastic else TrainSpec()
        return spec_mod.build_train_step(spec, loss_fn=loss_fn,
                                         apply_fn=apply_fn, has_aux=True)

    def _build_dp_step(self, shapes):
        """The elastic exchange's step through the registry:
        ``step(values, opt_state, err_rows, batch, rng) -> (new_values,
        new_opt, new_err_rows, mets)``; ``shapes`` is the global values
        tree (the fsdp classification reads it)."""
        loss_fn, apply_fn = self._loss_and_apply()
        return spec_mod.build_train_step(
            self.spec, loss_fn=loss_fn, mesh=self.mesh, apply_fn=apply_fn,
            has_aux=True, shapes=shapes)

    def _restore(self, params, opt_state, step=None):
        """Load checkpoint ``step`` (None: the latest): the values into
        ``params`` in place, and (opt_state, step, best metric, stale
        rounds).  On a ``"model"`` mesh the checkpoint's whole leaves are
        read on the host and each rank keeps its blocks."""
        d = self.cfg.ckpt_dir
        opt = {**opt_state, "step": np.int32(0)}
        like = {"values": params, "opt": opt}
        if self._split:
            like = {"values": self._tree_blocks(params, _whole_like),
                    "opt": {**opt, "m": self._tree_blocks(opt["m"],
                                                          _whole_like),
                            "v": self._tree_blocks(opt["v"], _whole_like)}}
        state, step = restore_checkpoint(d, like, step=step)
        if self._split:
            state["values"] = self._tree_blocks(state["values"], local_block)
            for k in ("m", "v"):
                state["opt"][k] = tree_map(
                    lambda x, dst: x.to(dst.device),
                    self._tree_blocks(state["opt"][k], local_block),
                    opt_state[k])
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

    def _restore_step(self) -> Optional[int]:
        """The checkpoint step this run resumes from (None: a fresh
        start).  On a mesh rank 0 alone reads the directory, which holds
        every write it made committed (a run drains its writer before it
        returns), and broadcasts the step (-1: none) over the world, so
        no rank reads it while rank 0's writer may still be committing
        and every rank restores the same step."""
        mesh = self.mesh
        if mesh is None or mesh.world_size == 1:
            return latest_step(self.cfg.ckpt_dir)
        step = latest_step(self.cfg.ckpt_dir) if self._rank == 0 else None
        x = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                         device=mesh.device)
        step = int(mesh.broadcast(x, 0).item())
        return None if step < 0 else step

    def _agree_preempted(self) -> bool:
        """Whether any rank was sent SIGTERM (every rank stops at the
        same step)."""
        if self.mesh is None or self.mesh.world_size == 1:
            return self._preempted
        flag = torch.tensor([int(self._preempted)], dtype=torch.int32,
                            device=self.mesh.device)
        flag = self.mesh.all_reduce(flag, ("data", "model"), "max")
        self._preempted = bool(flag.item())
        return self._preempted

    def _tree_blocks(self, tree, fn):
        """``fn(leaf, spec, mesh)`` over a tree shaped as the parameters
        (the values or a moment), each leaf with its placement; a
        moment slot of a non-float leaf (empty) is passed over."""
        it = iter(_spec_leaves(self._specs))

        def one(x):
            spec = next(it)
            if x is None or x.dim() != len(spec):
                return x
            return fn(x, spec, self.mesh)
        return tree_map(one, tree)

    # ------------------------------------------------------------- run
    def run(self, generator: Optional[torch.Generator] = None, params=None):
        """Train up to ``cfg.steps`` steps; returns (params, history).
        ``params`` (a ``model.params()`` tree, e.g. with bridged weights)
        is trained in place (detached float leaves require a gradient
        for the run, and no longer after it); without it the model is
        re-initialised from ``generator`` (default: seeded with
        ``cfg.seed``).  With ``cfg.ckpt_dir``, the latest checkpoint
        there is restored first (after its TrainSpec stamp is checked:
        values, optimizer state, error state, early-stop state) and the
        run goes on from its step; a fresh start takes an empty
        directory.  On a mesh every rank resumes from the step rank 0
        finds, its latest complete one (broadcast over the world), and
        when ``run`` returns on any rank the run's last checkpoint is
        committed (rank 0 drains its writer, then a world barrier), so
        a caller on any rank may read, copy or resume the directory
        with no barrier of its own.  After the run ``err_state`` holds
        the ``[V, ...]`` error rows and ``opt_state`` the optimizer
        state.  On a ``"model"`` mesh the model's leaves are cut to this
        rank's blocks first (``params`` must be ``model.params()``; the
        returned tree holds the blocks, and so does ``opt_state``)."""
        # the tree goes over in a box, so no frame of this call keeps the
        # whole leaves alive once ``_run`` has cut them to their blocks
        box = [params]
        del params
        if not (self._split or self._counted):
            return self._run(generator, box)
        from repro_torch.dist import use_mesh_rules
        # each rank holds its own rows of the batch
        with use_mesh_rules(self.mesh, self.rules,
                            local_batch=self._counted):
            return self._run(generator, box)

    def _run(self, generator, box):
        from repro_torch.dist import compression
        cfg, model, mesh = self.cfg, self.model, self.mesh
        params = box.pop()
        self._step_times = []
        self._preempted = False
        hist_start = len(self.history)
        dev = model.device
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(cfg.seed)
            params = model.init_params(generator)
        if self._split:
            from repro_torch import bridge
            self._specs = bridge.keep_local_blocks(model, mesh, self.rules)
            params = model.params()
        opt_state = init_opt_state(params)
        elastic, fsdp, V = self._use_dp, self._fsdp, self._accum
        err_full = (compression.zeros_error_state(params, V)
                    if elastic else None)
        best_metric, stale = -np.inf, 0
        start_step = 0
        ckpt = None
        if cfg.ckpt_dir:
            if self._rank == 0:
                ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
            resume = self._restore_step()
            if resume is not None:
                # the layout stamp is checked before any array is read,
                # so a wrong --grad-accum-shards / --fsdp fails with the
                # spec's error rather than a bare shape mismatch
                stamp = checkpoint_metadata(cfg.ckpt_dir, resume).get(
                    "train_spec")
                spec_mod.check_restore_layout(stamp, self.spec, self._accum)
                opt_state, start_step, best_metric, stale = self._restore(
                    params, opt_state, resume)
                if elastic:
                    # strict=False: a checkpoint without "err" (written
                    # by a plain run) resumes from zero error state
                    tree, _ = restore_checkpoint(
                        cfg.ckpt_dir, {"err": err_full}, step=resume,
                        strict=False)
                    err_full = tree["err"]

        step_fn = (self._build_dp_step(params) if elastic
                   else self._build_step())
        err = (compression.shard_rows(err_full, mesh, V) if elastic
               else None)
        del err_full
        local = params
        if fsdp:
            local = step_fn.shard(params)
            opt_state = {**opt_state, "m": step_fn.shard(opt_state["m"]),
                         "v": step_fn.shard(opt_state["v"])}

        def sync_params():
            """``params`` made the whole current values (fsdp: gathered
            from the ranks' slices)."""
            if fsdp:
                full = step_fn.gather(local)
                with torch.no_grad():
                    for dst, src in zip(tree_leaves(params),
                                        tree_leaves(full)):
                        if dst is not src:
                            dst.copy_(src)

        def full_opt():
            if not fsdp:
                return opt_state
            return {**opt_state, "m": step_fn.gather(opt_state["m"]),
                    "v": step_fn.gather(opt_state["v"])}

        def ckpt_state():
            sync_params()
            opt = full_opt()
            values = params
            if self._split:                 # whole leaves, every rank
                values = self._tree_blocks(params, gather_block)
                opt = {**opt, "m": self._tree_blocks(opt["m"], gather_block),
                       "v": self._tree_blocks(opt["v"], gather_block)}
            state = {"values": values,
                     "opt": {**opt, "step": np.int32(opt["step"])},
                     "early_stop": {"best": np.float64(best_metric),
                                    "stale": np.int64(stale)}}
            if elastic:
                state["err"] = compression.gather_rows(err, mesh)
            return state

        # every save is stamped with the spec's layout fingerprint — the
        # restore above is its consumer
        ckpt_meta = {"train_spec": self.spec.layout_stamp(mesh)}

        def save(step):
            state = ckpt_state()            # every rank: the gathers
            if ckpt is not None:
                ckpt.save(state, step, metadata=ckpt_meta)

        # the exchange's accounting in every history row (the fields:
        # train.spec.payload_metrics)
        payload_mets = (spec_mod.payload_metrics(self.spec, params, mesh)
                        if elastic else {})
        # the last checkpoint is stamped with the step actually reached
        # (a preemption or early stop ends the run before cfg.steps);
        # last_saved keeps the trailing save from repeating one
        done_step, last_saved = start_step, None
        # float leaves handed over detached (the CTR models' params():
        # views of the parameters) are made differentiable for the run
        # and handed back as they came
        floats = [x for x in tree_leaves(params) if torch.is_floating_point(x)]
        detached = [x for x in floats if not x.requires_grad]
        for x in detached:
            x.requires_grad_(True)
        rows, share = None, None
        if self._counted and self._local_batch is not None:
            share = self._local_batch        # the model's own placement
        elif self._counted:
            rows = (mesh.data_index, self._world)
            if cfg.batch_size % self._world:
                raise ValueError(
                    f"batch_size={cfg.batch_size} must divide over the "
                    f"mesh's {self._world} data-parallel ranks")
        old_handler = self._install_sigterm()
        try:
            for step in range(start_step, cfg.steps):
                t0 = time.perf_counter()
                if share is not None:        # this rank's share
                    batch = share(self.data_fn(step), mesh)
                else:
                    batch = {k: torch.as_tensor(v, device=dev)
                             for k, v in self.data_fn(step).items()}
                if rows is not None:         # this rank's rows
                    batch = {k: v[rows[0] * (v.shape[0] // rows[1]):
                                  (rows[0] + 1) * (v.shape[0] // rows[1])]
                             for k, v in batch.items()}
                rng = functools.partial(step_generator, cfg.seed, step, dev)
                if elastic:
                    new, opt_state, err, mets = step_fn(local, opt_state,
                                                        err, batch, rng)
                else:
                    new, opt_state, mets = step_fn(params, opt_state, batch,
                                                   rng)
                if fsdp:
                    local = new
                else:
                    with torch.no_grad():
                        for n, x in zip(tree_leaves(new), tree_leaves(params)):
                            if torch.is_floating_point(x):
                                x.copy_(n)
                del new, batch
                if self._counted:
                    # the loss's metrics are this rank's shares: summed;
                    # the optimizer's (grad_norm, lr) are every rank's
                    keys = [k for k in mets if k not in OPT_STATS]
                    mets = {**mets, **dict(zip(keys, sum_over_ranks(
                        [torch.as_tensor(mets[k], dtype=torch.float32,
                                         device=dev).reshape(())
                         for k in keys], mesh)))}
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                done_step = step + 1
                dt = time.perf_counter() - t0
                self._watchdog(step, dt)
                if step % cfg.log_every == 0 or step == cfg.steps - 1:
                    self.history.append({"step": step, **{
                        k: float(v) for k, v in mets.items()},
                        **payload_mets, "sec": dt})
                if cfg.ckpt_dir and cfg.ckpt_every and \
                        (step + 1) % cfg.ckpt_every == 0:
                    save(step + 1)
                    last_saved = step + 1
                if self._agree_preempted():
                    if cfg.ckpt_dir and last_saved != step + 1:
                        save(step + 1)
                        last_saved = step + 1
                    break
                if self.eval_fn and cfg.eval_every and \
                        (step + 1) % cfg.eval_every == 0:
                    sync_params()
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
            if cfg.ckpt_dir and last_saved != done_step:
                save(done_step)
            if ckpt:
                ckpt.wait()                    # drain the async writer
            if cfg.ckpt_dir and mesh is not None and mesh.world_size > 1:
                # no rank returns before rank 0's last write is committed
                mesh.all_reduce(torch.zeros(1, device=mesh.device),
                                ("data", "model"))
            sync_params()
            self.opt_state = full_opt()
            if elastic:
                self.err_state = compression.gather_rows(err, mesh)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            for x in detached:
                x.requires_grad_(False)
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
