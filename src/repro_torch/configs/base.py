"""Arch bundles: what an ``--arch`` name resolves to, and the elastic
train-step builder over a bundle's model."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class ArchBundle:
    """``make_model(device, seed)`` builds the full-width model;
    ``make_smoke(device, seed)`` a small one plus a request template
    (a dict of numpy arrays), as ``(model, batch)``.  ``config``: an LM
    bundle's published ``LMConfig``; MACE's at its ``molecule`` shape
    (``configs/mace_arch.model_cfg`` gives each shape's)."""
    name: str
    family: str                          # recsys | lm | gnn
    make_model: Callable[..., Any]
    make_smoke: Callable[..., tuple]
    description: str = ""
    config: Any = None


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
