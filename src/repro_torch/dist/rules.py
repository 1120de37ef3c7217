"""Logical-axis -> mesh-axis resolution, the reference's table
(``repro.dist.rules``) as pure functions over a mesh's axis names and
sizes.

Model code names each array dimension with a logical axis; this module
owns the one table mapping those names onto mesh axes:

  * data axes   — "batch" (and the graph analogues "nodes"/"edges")
    shard over ``("pod", "data")``, whichever of the two the mesh has,
    jointly;
  * width axes  — "mlp", "heads", "kv_heads", "vocab", "items",
    "table", "centroid", "expert" shard over ``"model"``;
  * everything else (``None`` included) is replicated.

Resolution is best effort: a dimension takes its candidate axes only if
its size divides by their product (trailing candidates are dropped
until it does, down to replication), and each mesh axis goes to at most
one dimension, the leftmost.

A placement spec is a tuple with one entry a dimension: ``None``
(replicated), an axis name, or a tuple of axis names — the entries of
the reference's ``PartitionSpec``.  A mesh is anything with a ``shape``
mapping of axis name to size (``repro_torch.launch.mesh.HostMesh``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Optional, Sequence, Tuple

# logical axis name -> ordered candidate mesh axes
DEFAULT_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("batch", ("pod", "data")),
    ("nodes", ("pod", "data")),
    ("edges", ("pod", "data")),
    ("mlp", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("vocab", ("model",)),
    ("items", ("model",)),
    ("table", ("model",)),
    ("centroid", ("model",)),
    ("expert", ("model",)),
)

# the mesh axes whose sizes make up the data-parallel degree
DATA_AXES = ("pod", "data")


def data_mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes that carry data parallelism, in the row-major order
    every data-parallel collective concatenates over; a mesh with no
    pod/data axis falls back to its first axis, so the degree is never
    zero."""
    axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    if not axes:
        axes = (tuple(mesh.shape)[0],)
    return axes


class _Ctx(threading.local):
    """The ambient (mesh, rules) installed by ``use_mesh_rules``; whether
    each rank already holds only its own rows of the batch
    (``local_batch``: inside the Trainer); the data group's loss counts
    (``counts``: ``use_loss_counts``)."""

    def __init__(self):
        self.mesh = None
        self.rules = None
        self.local_batch = False
        self.counts = None


_CTX = _Ctx()


def _rule_table(rules=None) -> Mapping[str, Tuple[str, ...]]:
    table = dict(DEFAULT_RULES)
    if rules:
        table.update(dict(rules))
    return table


def resolve_axes(logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int], mesh, rules=None) -> tuple:
    """The placement spec of a ``shape`` whose dims carry
    ``logical_axes`` (one a dim, ``None`` = replicated) on ``mesh``.
    ``rules`` overrides or extends the defaults (a mapping or pairs of
    name -> candidate mesh axes)."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"{len(logical_axes)} logical axes "
                         f"{tuple(logical_axes)} for shape {tuple(shape)}")
    table = _rule_table(rules)
    mesh_shape = dict(mesh.shape)
    used: set = set()
    entries = []
    for name, dim in zip(logical_axes, shape):
        cand = list(table.get(name, ())) if name is not None else []
        cand = [a for a in cand if a in mesh_shape and a not in used]
        # divisibility fallback: drop trailing axes until it divides
        while cand:
            prod = 1
            for a in cand:
                prod *= mesh_shape[a]
            if dim % prod == 0:
                break
            cand.pop()
        if not cand:
            entries.append(None)
        else:
            used.update(cand)
            entries.append(tuple(cand) if len(cand) > 1 else cand[0])
    return tuple(entries)


@contextlib.contextmanager
def use_mesh_rules(mesh, rules=None, *, local_batch: bool = False):
    """Install ``mesh`` (and optional rule overrides) as the ambient
    distribution context of ``constrain`` and ``data_shard_count``.
    ``local_batch``: each rank holds only its own rows of the batch (the
    Trainer's data split), so nothing splits it over ``"data"`` again;
    without it every rank holds the whole batch (serving)."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.local_batch)
    _CTX.mesh, _CTX.rules, _CTX.local_batch = mesh, rules, local_batch
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules, _CTX.local_batch = prev
