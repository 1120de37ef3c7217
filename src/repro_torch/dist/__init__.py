"""``repro_torch.dist`` — the distribution layer over ``torch.distributed``.

Model code never names mesh axes: a dimension carries a logical axis
name, and ``rules`` resolves it onto the mesh in use
(``resolve_axes``; the reference's table, ``repro.dist``).  Each
process holds its own rows, so a placement on the data axis needs no
work and ``constrain`` is the identity.

On the ``"model"`` axis the port shards the catalogue and nothing else:
a leaf whose first dimension is a catalogue axis (``CATALOGUE_AXES``:
the items of the codes, the rows of a table) and resolves onto
``"model"`` is held as this rank's block of rows (``local_rows``), and
``core/sharded.py``'s mesh branches serve from those blocks.  Every
other leaf stays whole on every rank, including those the reference's
GSPMD would split on a width axis: tensor-parallel training is ROADMAP
queue 1, item 9c, and ``constrain`` on a width axis raises, naming it.

Public API
  resolve_axes(axes, shape, mesh[, rules]) -> placement spec (tuple)
  use_mesh_rules(mesh[, rules])   installs the ambient mesh
  constrain(x, axes)              identity (raises on a width axis of a
                                  model > 1 mesh)
  data_shard_count()              data-parallel degree of the ambient
                                  mesh (1 off a mesh)
  params_shardings(params, axes, mesh[, rules])  the placement spec of
                                  every leaf of a parameter tree
  row_block(rows, mesh)           this rank's [lo, hi) of a catalogue of
                                  ``rows`` rows split over "model"
  local_rows(x, spec, mesh)       this rank's rows of a leaf placed by
                                  ``spec``

Submodules: ``rules`` (the table and resolver), ``compression`` (the
elastic data-parallel gradient exchange with bf16/int8 error feedback).
"""
from __future__ import annotations

import math

from repro_torch.dist.rules import (DATA_AXES, DEFAULT_RULES, _CTX,  # noqa: F401
                                    data_mesh_axes, resolve_axes,
                                    use_mesh_rules)

__all__ = ["resolve_axes", "use_mesh_rules", "constrain",
           "data_shard_count", "params_shardings", "row_block",
           "local_rows", "DEFAULT_RULES", "CATALOGUE_AXES"]

NEXT_SLICE = ("training on the 'model' mesh axis (tensor-parallel width "
              "axes: constrain on them, sharded heads and MLPs, "
              "vocab-parallel cross-entropy) is not yet ported to "
              "repro_torch: ROADMAP queue 1, item 9c; the catalogue's "
              "row-sharded serving is (core/sharded.py)")

# logical axes that name catalogue rows: the leaves the port row-shards
CATALOGUE_AXES = ("items", "table")


def constrain(x, axes):
    """``x`` placed as its logical ``axes`` resolve under the ambient
    mesh.  Identity: off a mesh; and on the data axis, where each
    process already holds its own rows (inside the elastic step too).
    A width axis on a ``model > 1`` mesh raises."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    spec = resolve_axes(axes, tuple(x.shape), mesh, _CTX.rules)
    named = [a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)]
    if any(a not in DATA_AXES and mesh.shape[a] > 1 for a in named):
        raise NotImplementedError(NEXT_SLICE)
    return x


def data_shard_count() -> int:
    """Data-parallel degree of the ambient mesh (1 off a mesh)."""
    mesh = _CTX.mesh
    if mesh is None:
        return 1
    axes = [a for a in DATA_AXES if a in mesh.shape]
    return math.prod(mesh.shape[a] for a in axes) if axes else 1



def params_shardings(params, axes, mesh, rules=None):
    """The placement spec of every leaf of ``params`` (a tree of dicts
    and lists whose leaves have a ``shape``), from ``axes``, the matching
    tree of logical-axis tuples (the reference's ``nn.axes_tree``); the
    port's counterpart of the reference's ``params_shardings``, with
    specs as tuples of mesh-axis names."""
    if isinstance(params, dict):
        return {k: params_shardings(params[k], axes[k], mesh, rules)
                for k in params}
    if isinstance(params, list):
        return [params_shardings(p, a, mesh, rules)
                for p, a in zip(params, axes, strict=True)]
    return resolve_axes(axes, tuple(params.shape), mesh, rules)


def row_block(rows: int, mesh=None):
    """This rank's ``(lo, hi)`` of a catalogue of ``rows`` rows split
    over the ``"model"`` axis of ``mesh`` (default: the ambient one);
    None when nothing splits it (no mesh, ``model == 1``, or ``rows``
    not divisible, which the reference also serves unsharded)."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None:
        return None
    S = mesh.shape.get("model", 1)
    if S <= 1 or rows % S:
        return None
    n = rows // S
    lo = mesh.model_index * n
    return lo, lo + n


def local_rows(x, spec, mesh=None):
    """This rank's block of rows of ``x`` when ``spec`` (its placement)
    puts its first dimension on a ``"model"`` axis that splits it, as a
    copy that owns its memory (so the whole leaf can be freed); else
    ``x``."""
    blk = row_block(x.shape[0], mesh) if spec and spec[0] == "model" \
        else None
    return x if blk is None else x[blk[0]:blk[1]].clone()
