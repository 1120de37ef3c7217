"""``repro_torch.dist`` — the distribution layer over ``torch.distributed``.

Model code never names mesh axes: a dimension carries a logical axis
name, and ``rules`` resolves it onto the mesh in use
(``resolve_axes``; the reference's table, ``repro.dist``).  Each
process holds its own rows of the batch, so a placement on the data
axis needs no work.

On the ``"model"`` axis the port is hand-written tensor parallelism
(Megatron style) where the reference's GSPMD partitions the jit'd step:
a leaf whose placement puts a dimension on ``"model"`` is held as this
rank's block of that dimension (``local_block``), every other leaf is
whole on every rank.  The sequential recommenders split the catalogue's
rows (codes, full table, QR tables), the attention heads and the MLP's
width; the CTR and two-tower models their tables' rows and their MLPs'
widths; the model code reads the blocks' shapes and brackets each split
region with the autograd-aware collectives below.  The elastic
exchange (``compression``) replicates the model over ``"model"``
instead, as the reference's ``shard_map`` does, and exchanges over the
``"data"`` group.

On the ``"data"`` axis the Trainer gives each rank its own rows, and a
loss is the whole batch's: each term's local sum over its count in the
whole batch (``use_loss_counts`` installs the counts, all-reduced over
``"data"`` before the forward; ``loss_count`` reads one), and the ranks'
gradients are summed.

Public API
  resolve_axes(axes, shape, mesh[, rules]) -> placement spec (tuple)
  use_mesh_rules(mesh[, rules])   installs the ambient mesh
  constrain(x, axes)              this rank's block of the whole ``x``
                                  as its logical axes place it
  data_shard_count()              data-parallel degree of the ambient
                                  mesh (1 off a mesh)
  model_size()                    its "model" axis (1 off a mesh)
  params_shardings(params, axes, mesh[, rules])  the placement spec of
                                  every leaf of a parameter tree
  row_block(rows, mesh)           this rank's [lo, hi) of a catalogue of
                                  ``rows`` rows split over "model"
  local_rows(x, spec, mesh)       this rank's rows of a leaf placed by
                                  ``spec`` (its first dimension only)
  local_block(x, spec, mesh)      this rank's block of whichever
                                  dimension ``spec`` puts on "model"
  gather_block(x, spec, mesh)     the whole leaf from every rank's block
  copy_to_model(x)                identity forward, sum over "model"
                                  backward (enters a split region)
  reduce_from_model(x)            sum over "model" forward, identity
                                  backward (leaves a split region)
  gather_from_model(x, dim)       every rank's block concatenated
                                  forward, this rank's block of the
                                  gradient backward
  scatter_to_model(x, dim)        this rank's block of the whole ``x``
                                  forward, the blocks' gradients
                                  gathered backward
  column_linear(x, w)             ``x @ w`` for this rank's column block
                                  ``w``; backward gathers ``dy`` and
                                  ``w`` over "model" for the whole
                                  ``dx`` (a narrowing layer)
  max_over_model(x)               the max over "model" (no gradient)
  gather_from_data(x)             every data rank's rows concatenated
                                  forward, the gradient summed over
                                  "data" and cut to this rank's rows
                                  backward
  sum_over_data(x)                the sum over "data" where the ranks
                                  hold their own rows (no gradient)
  sum_partials_over_data(x)       the ranks' partial ``x`` summed over
                                  "data", the gradient summed too
  halo_rows(x, exchange)          a graph share's own rows, then its halo
                                  rows fetched from their owners; the
                                  halo's gradient added to the owners'
  sum_to_owners(a, exchange)      a share's partial sums of its own and
                                  remote rows -> its own rows, the other
                                  ranks' partials added in rank order
  bind_ambient(fn)                ``fn`` run under the ambient context
                                  of now, on any thread (a checkpointed
                                  region's recompute)
  data_rank()                     (this rank's index, D) on "data" when
                                  the ranks hold their own rows of the
                                  batch, else (0, 1)
  use_loss_counts(counts)         installs the whole batch's loss counts
  loss_count(name)                one of them (None when none is
                                  installed)

Submodules: ``rules`` (the table and resolver), ``compression`` (the
elastic data-parallel gradient exchange with bf16/int8 error feedback).
"""
from __future__ import annotations

import math

import torch

import contextlib

from repro_torch.dist.rules import (DATA_AXES, DEFAULT_RULES, _CTX,  # noqa: F401
                                    data_mesh_axes, resolve_axes,
                                    use_mesh_rules)

__all__ = ["resolve_axes", "use_mesh_rules", "constrain",
           "data_shard_count", "params_shardings", "row_block",
           "local_rows", "local_block", "gather_block", "block_shape",
           "model_dim",
           "model_size",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "scatter_to_model", "column_linear", "max_over_model",
           "gather_from_data", "sum_over_data", "sum_partials_over_data",
           "halo_rows", "sum_to_owners", "bind_ambient",
           "data_rank",
           "use_loss_counts", "loss_count", "DEFAULT_RULES",
           "CATALOGUE_AXES"]

# logical axes that name catalogue rows: the leaves the port row-shards
# (an LM's vocabulary table is a catalogue too)
CATALOGUE_AXES = ("items", "table", "vocab")


def constrain(x, axes):
    """The whole ``x`` placed as its logical ``axes`` resolve under the
    ambient mesh: this rank's block (a view) of the dimension they put
    on ``"model"``.  Identity off a mesh and on the data axes, where
    each process already holds its own rows (inside the elastic step
    too)."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    spec = resolve_axes(axes, tuple(x.shape), mesh, _CTX.rules)
    return local_block(x, spec, mesh, copy=False)


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


def model_dim(spec):
    """The dimension a placement ``spec`` puts on ``"model"``, or None."""
    for k, e in enumerate(spec or ()):
        named = (e,) if isinstance(e, str) else tuple(e or ())
        if "model" in named:
            if len(named) > 1:
                raise ValueError(f"placement {spec}: a dimension on "
                                 f"'model' and other axes is not held "
                                 f"as a block")
            return k
    return None


def model_size(mesh=None) -> int:
    """The ``"model"`` axis of ``mesh`` (default: the ambient one; 1 off
    a mesh)."""
    mesh = _CTX.mesh if mesh is None else mesh
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def local_block(x, spec, mesh=None, *, copy: bool = True):
    """This rank's block of the whole ``x`` along the dimension that
    ``spec`` (its placement) puts on ``"model"``: a copy that owns its
    memory (so the whole leaf can be freed), or a view with
    ``copy=False``; ``x`` itself when nothing splits it."""
    mesh = _CTX.mesh if mesh is None else mesh
    k = model_dim(spec)
    S = model_size(mesh)
    if k is None or S <= 1:
        return x
    n = x.shape[k]
    if n % S:
        raise ValueError(f"dimension {k} of {tuple(x.shape)} does not "
                         f"split {S} ways (placement {spec})")
    out = x.narrow(k, mesh.model_index * (n // S), n // S)
    return out.clone(memory_format=torch.contiguous_format) if copy \
        else out


def block_shape(shape, spec, mesh=None) -> tuple:
    """The shape of this rank's block of a whole ``shape`` placed by
    ``spec``."""
    mesh = _CTX.mesh if mesh is None else mesh
    k, S = model_dim(spec), model_size(mesh)
    shape = tuple(shape)
    if k is None or S <= 1:
        return shape
    return shape[:k] + (shape[k] // S,) + shape[k + 1:]


def gather_block(x, spec, mesh=None):
    """The whole leaf from every rank's block of it (``spec`` its
    placement), concatenated over ``"model"`` in rank order; ``x`` when
    nothing splits it.  Every rank of the ``"model"`` group calls it."""
    mesh = _CTX.mesh if mesh is None else mesh
    k = model_dim(spec)
    if k is None or model_size(mesh) <= 1:
        return x
    return mesh.all_gather(x.detach(), "model", k)


def local_rows(x, spec, mesh=None):
    """This rank's block of rows of ``x`` when ``spec`` (its placement)
    puts its first dimension on a ``"model"`` axis that splits it, as a
    copy that owns its memory (so the whole leaf can be freed); else
    ``x``."""
    blk = row_block(x.shape[0], mesh) if spec and spec[0] == "model" \
        else None
    return x if blk is None else x[blk[0]:blk[1]].clone()


# ------------------------------------------- autograd-aware collectives
# Megatron's pair: a split region starts at ``copy_to_model`` (each rank
# holds the whole input; the gradients the ranks' blocks send back are
# partial, and are summed) and ends at ``reduce_from_model`` (the ranks'
# partial outputs are summed; the gradient of the sum is the same on
# every rank).  They run ``HostMesh.all_reduce`` / ``all_gather``, which
# are not differentiable, over the ambient mesh's "model" group.

def _mesh_or_ambient(mesh):
    mesh = _CTX.mesh if mesh is None else mesh
    return mesh if model_size(mesh) > 1 else None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), "model", "sum"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous(), "model", "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, x.shape[dim]
        return mesh.all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_index * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        n = x.shape[dim] // mesh.shape["model"]
        ctx.dim, ctx.mesh = dim, mesh
        return x.narrow(dim, mesh.model_index * n, n)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), "model", ctx.dim), None, \
            None


class _ColumnLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mesh = ctx.mesh
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        g_all = mesh.all_gather(g.contiguous(), "model", g.dim() - 1)
        w_all = mesh.all_gather(w.contiguous(), "model", 1)
        return g_all @ w_all.T, dw, None


def copy_to_model(x, mesh=None):
    """Identity forward; the gradient summed over ``"model"``.  ``x`` is
    the whole input of a split region; off a splitting mesh, ``x``."""
    mesh = _mesh_or_ambient(mesh)
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh=None):
    """The ranks' partial ``x`` summed over ``"model"``; the gradient
    passes through unchanged.  Off a splitting mesh, ``x``."""
    mesh = _mesh_or_ambient(mesh)
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, dim: int = 0, mesh=None):
    """Every rank's block ``x`` concatenated on ``dim`` over ``"model"``;
    the gradient of the whole is cut back to this rank's block (it is
    the same on every rank: wrap a partial use in ``copy_to_model``)."""
    mesh = _mesh_or_ambient(mesh)
    return x if mesh is None else _GatherFromModel.apply(x, dim, mesh)


def scatter_to_model(x, dim: int = -1, mesh=None):
    """This rank's block of ``dim`` of the whole ``x`` (the same on every
    rank); the gradient of the whole is every rank's block gradient
    gathered over ``"model"`` (half the traffic of ``copy_to_model``'s
    sum of a mostly zero gradient).  Off a splitting mesh, ``x``."""
    mesh = _mesh_or_ambient(mesh)
    return x if mesh is None else _ScatterToModel.apply(x, dim % x.dim(),
                                                        mesh)


def column_linear(x, w, mesh=None):
    """``x @ w`` for the whole input ``x`` (the same on every rank) and
    this rank's column block ``w`` [d_in, d_out/S]: this rank's column
    block of the output.  The backward gathers ``dy``'s and ``w``'s
    blocks over ``"model"`` and computes the whole ``dx`` on every rank,
    which ships ``d_out`` floats a row where ``copy_to_model`` would sum
    ``d_in``: the cheaper of the two where the layer narrows (DIEN's
    attention tower, 324 -> 36).  Off a splitting mesh, ``x @ w``."""
    mesh = _mesh_or_ambient(mesh)
    return x @ w if mesh is None else _ColumnLinear.apply(x, w, mesh)


def max_over_model(x, mesh=None):
    """The elementwise max of ``x`` over ``"model"`` (no gradient: the
    logsumexp's shift)."""
    mesh = _mesh_or_ambient(mesh)
    return x if mesh is None else mesh.all_reduce(x.detach().contiguous(),
                                                  "model", "max")


# ------------------------------------------------- the data group's rows
# Inside the Trainer each data rank holds its own rows of the batch
# (``use_mesh_rules(..., local_batch=True)``).  A loss term over the
# whole batch is then this rank's sum over the term's count in the whole
# batch (``loss_count``), and the ranks' gradients are summed.

def data_rank():
    """(this rank's index on ``"data"``, D) where the ambient mesh's
    ranks hold their own rows of the batch; (0, 1) otherwise."""
    mesh = _CTX.mesh
    if mesh is None or not _CTX.local_batch:
        return 0, 1
    return mesh.data_index, int(mesh.shape.get("data", 1))


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return mesh.all_gather(x.contiguous(), "data", 0)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.contiguous(), "data", "sum")
        return g.narrow(0, ctx.mesh.data_index * ctx.n, ctx.n), None


def gather_from_data(x):
    """Every data rank's rows ``x`` concatenated on dim 0, in rank order
    (the whole batch's); the gradient of the whole, which each rank
    holds for its own loss, is summed over ``"data"`` and cut back to
    this rank's rows.  ``x`` itself unless the ranks hold their own
    rows (``data_rank``)."""
    if data_rank()[1] <= 1:
        return x
    return _GatherFromData.apply(x, _CTX.mesh)


def bind_ambient(fn):
    """``fn`` bound to the ambient context installed now (mesh, rules,
    the data split, the loss counts): each call installs it around
    ``fn`` on whichever thread runs it.  The context is thread-local,
    and autograd runs a CUDA backward on a thread of its own, so a
    checkpointed region recomputed there (``torch.utils.checkpoint``)
    needs its forward's context bound."""
    state = (_CTX.mesh, _CTX.rules, _CTX.local_batch, _CTX.counts)

    def run(*args, **kwargs):
        prev = (_CTX.mesh, _CTX.rules, _CTX.local_batch, _CTX.counts)
        (_CTX.mesh, _CTX.rules, _CTX.local_batch, _CTX.counts) = state
        try:
            return fn(*args, **kwargs)
        finally:
            (_CTX.mesh, _CTX.rules, _CTX.local_batch, _CTX.counts) = prev
    return run


def sum_over_data(x):
    """``x`` summed over ``"data"`` where the ranks hold their own rows
    of the batch (``data_rank``), else ``x``; no gradient (whole-batch
    statistics such as the MoE's top-k counts)."""
    if data_rank()[1] <= 1:
        return x
    return _CTX.mesh.all_reduce(x.detach().contiguous(), "data", "sum")


@contextlib.contextmanager
def use_loss_counts(counts):
    """Install ``counts`` (name -> the whole batch's count, an int
    tensor) as the denominators of the loss terms computed inside."""
    prev, _CTX.counts = _CTX.counts, dict(counts)
    try:
        yield
    finally:
        _CTX.counts = prev


def loss_count(name: str):
    """The whole batch's count ``name`` installed by ``use_loss_counts``;
    None outside it (a term is then its local mean, as on one device)."""
    counts = _CTX.counts
    return None if counts is None else counts[name]


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.contiguous(), "data", "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), "data", "sum"), None


def sum_partials_over_data(x):
    """The data ranks' partial ``x`` summed over ``"data"``, where each
    rank's loss reads the sum (a molecule's energy whose atoms two ranks
    own): the gradient of the whole loss, which each rank holds for its
    own term, is summed over ``"data"`` too.  ``x`` itself unless the
    ranks hold their own rows (``data_rank``)."""
    if data_rank()[1] <= 1:
        return x
    return _SumPartials.apply(x, _CTX.mesh)


# ------------------------------------------------- a graph's shares
# MACE on a mesh: each data rank holds its share of a graph
# (``data.graphs.partition_graph``), and a layer moves rows between the
# shares along the share's ``Exchange``: the halo (senders another rank
# owns) before the gather, the remote receivers' partial sums after the
# segment sum.  Each move is one ``HostMesh.all_to_all_bytes`` over
# "data", every slot padded to the group's largest pair count.

def _swap(src, route, mesh):
    """``src``'s rows that ``route`` sends, through one all-to-all over
    ``"data"``: ``[D * pad, W]`` as they arrive (row ``j * pad + k``: the
    k-th row from data rank j)."""
    D, pad, W = len(route.send), route.pad, src.shape[1]
    if pad == 0:
        return src.new_zeros((0, W))
    buf = (src.index_select(0, route.send_slots) if src.shape[0]
           else src.new_zeros((D * pad, W))).contiguous()
    out, _ = mesh.all_to_all_bytes(buf.view(torch.uint8).view(D, -1),
                                   "data")
    return out.view(src.dtype).view(D * pad, W)


def _land(dst, got, route):
    """Add what arrived (``_swap``'s result) onto the destination rows of
    ``route``, one data rank after another in rank order (each rank's
    rows unique, so every sum has a fixed order)."""
    for j, (rows, n) in enumerate(zip(route.recv, route.counts)):
        if n:
            dst.index_add_(0, rows, got[j * route.pad:j * route.pad + n])
    return dst


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, mesh):
        ctx.ex, ctx.mesh = ex, mesh
        got = _swap(x, ex.halo, mesh)
        return torch.cat([x, got.index_select(0, ex.halo.recv_slots)])

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        own = g[:ex.n_own].clone(memory_format=torch.contiguous_format)
        got = _swap(g[ex.n_own:].contiguous(), ex.halo_back, ctx.mesh)
        return _land(own, got, ex.halo_back), None, None


class _SumToOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, ex, mesh):
        ctx.ex, ctx.mesh = ex, mesh
        own = a[:ex.n_own].clone(memory_format=torch.contiguous_format)
        got = _swap(a[ex.n_own:].contiguous(), ex.owners, mesh)
        return _land(own, got, ex.owners)

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        g = g.contiguous()
        got = _swap(g, ex.owners_back, ctx.mesh)
        return (torch.cat([g, got.index_select(0, ex.owners_back.recv_slots)]),
                None, None)


def _share_mesh():
    mesh = _CTX.mesh
    if mesh is None or data_rank()[1] <= 1:
        raise ValueError("a graph share moves rows over the ambient mesh's "
                         "'data' group, where the ranks hold their own "
                         "rows (dist.use_mesh_rules(..., local_batch=True))")
    return mesh


def halo_rows(x, exchange):
    """``x [n_own, W]`` (this rank's own rows) followed by its halo rows
    ``[n_halo, W]``, fetched from the ranks that own them along
    ``exchange.halo``; backward, each halo row's gradient goes back to
    its owner and is added to the owner's gradient of that row after the
    owner's own, in rank order."""
    return _HaloRows.apply(x, exchange, _share_mesh())


def sum_to_owners(a, exchange):
    """``a [n_own + n_remote, W]``, this rank's partial sums of its own
    and its remote receiver rows -> ``[n_own, W]``: the own rows, each
    plus the partials of the same row from the other ranks, added after
    its own in rank order (``exchange.owners``); backward, the owners'
    gradient rows return to the ranks that made the partials."""
    return _SumToOwners.apply(a, exchange, _share_mesh())
