"""``repro_torch.dist`` — the distribution layer over ``torch.distributed``.

Model code never names mesh axes: a dimension carries a logical axis
name, and ``rules`` resolves it onto the mesh in use
(``resolve_axes``; the reference's table, ``repro.dist``).  The port's
mesh is data-parallel: each process holds its own rows, so a placement
on the data axis needs no work and ``constrain`` is the identity.  The
``"model"`` axis (tensor-sharded tables through ``params_shardings``,
``constrain`` on width axes) is the next slice of the port: a mesh with
``model > 1`` raises, and ``params_shardings`` is not here yet.

Public API
  resolve_axes(axes, shape, mesh[, rules]) -> placement spec (tuple)
  use_mesh_rules(mesh[, rules])   installs the ambient mesh
  constrain(x, axes)              identity (raises on a width axis of a
                                  model > 1 mesh)
  data_shard_count()              data-parallel degree of the ambient
                                  mesh (1 off a mesh)

Submodules: ``rules`` (the table and resolver), ``compression`` (the
elastic data-parallel gradient exchange with bf16/int8 error feedback).
"""
from __future__ import annotations

import math

from repro_torch.dist.rules import (DATA_AXES, DEFAULT_RULES, _CTX,  # noqa: F401
                                    data_mesh_axes, resolve_axes,
                                    use_mesh_rules)

__all__ = ["resolve_axes", "use_mesh_rules", "constrain",
           "data_shard_count", "DEFAULT_RULES"]

NEXT_SLICE = ("the 'model' mesh axis (tensor-sharded tables through "
              "params_shardings, constrain on width axes, the item-sharded "
              "serving merges) is not yet ported to repro_torch: ROADMAP "
              "queue 1, item 9b")


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

