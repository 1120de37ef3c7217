"""Arch bundles: what an ``--arch`` name resolves to, the dry-run cells
that bind an (arch x input shape) to a step, and the step builders over a
bundle's model (the reference's ``configs/base.py``).

A ``Cell`` declares:
  * ``kind``    : train | serve | decode   (what extra state it needs)
  * ``specs``   : input name -> ``Spec(shape, dtype, logical axes)``
  * ``build``   : ``build(model, mesh=None, ...)`` -> the step
      train : fn(values, opt_state, batch)  -> (values, opt_state, loss)
      serve : fn(values, batch)             -> outputs
      decode: fn(values, caches, batch)     -> (logits, caches)
    Over a ``(data, model)`` mesh each rank's step runs with the mesh
    installed (``dist.use_mesh_rules``, every rank holding its own rows
    of the batch), as the Trainer's and the ``--mesh`` servers' do.
  * ``state_fn``: decode: model -> (caches, their logical axes)
  * ``skip``    : the reason a cell is a documented skip (long_500k on a
                  full-attention arch)
``launch/dryrun.py`` traces a cell's step on fake tensors.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """One input of a cell: its whole shape, torch dtype and logical
    axes (one a dim; ``None`` replicated)."""
    shape: tuple
    dtype: Any
    axes: tuple


@dataclasses.dataclass
class Cell:
    shape_name: str
    kind: str                            # train | serve | decode
    specs: Dict[str, Spec]
    build: Callable[..., Callable]
    state_fn: Optional[Callable] = None  # decode: model -> (caches, axes)
    skip: Optional[str] = None
    note: str = ""


@dataclasses.dataclass
class ArchBundle:
    """``make_model(device, seed)`` builds the full-width model;
    ``make_smoke(device, seed)`` a small one plus a request template
    (a dict of numpy arrays), as ``(model, batch)``.  ``config``: an LM
    bundle's published ``LMConfig``; MACE's at its ``molecule`` shape
    (``configs/mace_arch.model_cfg`` gives each shape's).  ``cells``: the
    dry-run cells by shape name."""
    name: str
    family: str                          # recsys | lm | gnn
    make_model: Callable[..., Any]
    make_smoke: Callable[..., tuple]
    description: str = ""
    config: Any = None
    cells: Dict[str, Cell] = dataclasses.field(default_factory=dict)

    def cell(self, shape_name: str) -> Cell:
        return self.cells[shape_name]


# ------------------------------------------------- generic cell builders

def on_mesh(fn, mesh, rules=None):
    """``fn`` run with ``mesh`` installed, every rank holding its own rows
    of the batch (``fn`` itself off a mesh)."""
    if mesh is None:
        return fn
    from repro_torch.dist import use_mesh_rules

    def run(*args):
        with use_mesh_rules(mesh, rules, local_batch=True):
            return fn(*args)
    return run


def train_step_builder(model, mesh=None, *, specs=None, rules=None):
    """The canonical full train step (forward, backward and the adamw
    update, lr 1e-4, weight decay 0.01, as the reference's), built as the
    port's ``Trainer`` builds it on ``mesh``: the data group's loss
    counts and gradient sum, and on a ``"model"`` axis the split leaves
    (``specs``: their placement, ``bridge.keep_local_blocks``' result)
    in the global norm.  ``fn(values, opt_state, batch) -> (new_values,
    new_opt_state, loss)`` over ``model.params()``-shaped trees."""
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    opt_cfg = OptConfig(kind="adamw", lr=1e-4, weight_decay=0.01)
    trainer = Trainer(model, opt_cfg, TrainConfig(), data_fn=None,
                      mesh=mesh, rules=rules)
    trainer._specs = specs
    step = trainer._build_step()

    def fn(values, opt_state, batch):
        new_values, new_opt, mets = step(values, opt_state, batch)
        return new_values, new_opt, mets["loss"]

    if mesh is None or not (trainer._split or trainer._counted):
        return fn
    return on_mesh(fn, mesh, rules)


def serve_builder(method: str):
    """Builder for serve cells: ``builder(model, mesh=None, **kw)`` ->
    ``fn(values, batch)``, the model's ``method`` without gradients.
    ``kw`` (e.g. ``fused=False`` / ``prune=True`` from the dry run's
    --serve flags) reaches the method where its signature takes them: a
    retrieval method resolves them to its engine spec
    (``core.engine.spec_for``); the bulk and scoring paths ignore
    them."""
    def builder(model, mesh=None, rules=None, **kw):
        bound = getattr(model, method)
        accepted = set(inspect.signature(bound).parameters)
        kw = {k: v for k, v in kw.items() if k in accepted}

        def fn(values, batch):
            with torch.no_grad():
                return bound(values, batch, **kw)
        return on_mesh(fn, mesh, rules)
    return builder


def decode_builder(model, mesh=None, rules=None):
    """fn(values, caches, batch) -> (logits, caches): one decode step of
    ``batch["token"]`` [B, 1] without gradients."""
    def fn(values, caches, batch):
        with torch.no_grad():
            return model.decode_step(values, batch["token"], caches)
    return on_mesh(fn, mesh, rules)


def dp_train_step_builder(model, mesh, method: str = None,
                          accum_shards: int | None = None,
                          fsdp: bool = False, spec=None):
    """A train step routed through the elastic compressed exchange of
    the training engine (``repro_torch.train.spec``).  Pass a
    ``TrainSpec`` (``spec=``), or the legacy ``method`` / ``accum_shards``
    / ``fsdp`` kwargs, which ``spec_for`` resolves to the same spec (an
    rng-less step, as the reference's).  Returns ``(fn,
    err_state_shapes)`` where ``fn(values, opt_state, err_rows, batch) ->
    (new_values, new_opt_state, new_err_rows, loss)`` over
    ``model.params()``-shaped trees (fsdp: this rank's slices, cut by
    ``fn.shard``) and ``err_state_shapes(values)`` gives the error
    state's shapes as ``meta`` tensors."""
    from repro_torch.train import spec as train_spec
    from repro_torch.train.optimizer import OptConfig, apply_updates

    if spec is None:
        spec = train_spec.spec_for(grad_compression=method,
                                   grad_accum_shards=accum_shards,
                                   fsdp=fsdp, rng="none")
    opt_cfg = OptConfig(kind="adamw", lr=1e-4, weight_decay=0.01)

    def loss_fn(values, batch):
        loss, _ = model.train_loss(values, batch)
        return loss

    def apply_fn(values, opt_state, grads, grad_norm=None):
        return apply_updates(opt_cfg, opt_state, values, grads,
                             grad_norm=grad_norm)

    step = train_spec.build_train_step(spec, loss_fn=loss_fn, mesh=mesh,
                                       apply_fn=apply_fn,
                                       shapes=model.params())

    def fn(values, opt_state, err_state, batch):
        new_values, new_opt, new_err, mets = step(
            values, opt_state, err_state, batch)
        return new_values, new_opt, new_err, mets["loss"]

    fn.n_shards = step.n_shards
    fn.fsdp = spec.fsdp
    fn.shard = step.shard
    return fn, train_spec.error_state_shapes(spec, mesh)
