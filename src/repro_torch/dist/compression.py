"""Elastic-deterministic data-parallel gradient exchange with payload
compression and error feedback, composable with FSDP-sharded optimizer
state — the port of ``repro.dist.compression`` over
``torch.distributed``.

``make_elastic_dp_step`` cuts the global batch into a fixed number of
**virtual shards** ``V`` (``accum_shards``).  Each virtual shard's
gradient is compressed (a ``bf16`` cast, or per-tensor symmetric
``int8``), the compressed payloads are exchanged, and they are
mean-reduced in a fixed order.  The compression error is carried in
per-virtual-shard **error feedback** state: the residual ``(g + e) -
dequant(quant(g + e))`` is added to the next step's gradient.

Because ``V`` is fixed per run, not per world, the step is **bitwise
deterministic across world sizes** ``D`` dividing ``V``:

  1. rank ``d`` runs ``L = V / D`` rounds, slice ``v = d * L + r`` in
     round ``r``, one slice at a time, each a structurally identical
     forward and backward on the same rows, drawing dropout from
     ``rng(v)``;
  2. the only cross-process operations are ``all_gather`` and
     ``all_to_all_single`` of ``uint8`` views of the payloads' bytes
     over the ``"data"`` group (``HostMesh.all_gather_bytes`` /
     ``all_to_all_bytes``, on the mesh's transport): exact data
     movement, whatever the backend does with a dtype;
  3. ``combine`` reduces one contiguous ``[V, ...]`` stack in virtual
     order (replicated leaves), or an unrolled fixed-order sum over the
     ``V`` contributions of each owned row (fsdp leaves): its arithmetic
     never depends on ``D``.

The error state is ``[V, ...]`` fp32 a float leaf; a rank holds its
``L`` rows (``shard_rows`` / ``gather_rows``), so a checkpoint of the
gathered rows restores on any world size dividing ``V``.

On a ``(D, S)`` mesh the model is replicated over ``"model"``, as the
reference's ``shard_map`` (every mesh axis manual, the values
replicated, the batch rows split over the data axes only) runs it: D,
the rank's index ``d`` and every exchange are the ``"data"`` group's,
so the S model ranks of a data column compute the same rounds, bit for
bit, and the step is the ``(D, 1)`` step's.

Stages and the ``overlap`` modes
--------------------------------
A round is two stages, ``step.forward_backward`` (the slice's loss and
fp32 gradients; no collective) and ``step.quantise_pack`` (error
feedback, quantise into one packed byte buffer, and the round's
collectives issued with ``async_op=True``), then one
``step.combine`` (dequantise, ordered mean, global norm, update).  The
modes (``OVERLAP_MODES``) run the same stages in the same order on the
current stream and differ only in when the host waits on a round's
work handles:

  * ``"none"``     — wait on each round before the next; the oracle;
  * ``"dispatch"`` — round ``r+1`` (both stages) is issued before
    waiting on round ``r-1``: two rounds in flight;
  * ``"backward"`` — ``forward_backward(r+1)`` is issued right after
    ``quantise_pack(r)``, before waiting on round ``r-1`` (two rounds'
    uncompressed gradients live).

So every mode is bitwise identical to every other.  On the
``gloo-staged`` transport (ranks sharing a card) a round's payloads are
copied to host memory when it is issued and the results to the card at
its wait, so the modes overlap less there and stay bit-identical.
``step.last_schedule``
records the ``(fb / issue / drain / consume, round)`` order of the last
call, event for event the reference's.

FSDP (``fsdp=True``)
--------------------
Each rank owns a ``1/D`` row slice of every V-divisible float leaf
(``fsdp_leaf_sharded``: the rule reads ``V``, never ``D``) of the
parameters and both Adam moments (``step.shard`` cuts them).
``step.gather`` all-gathers the parameters once a step; a round's
payload collective is an ordered reduce-scatter: ``all_to_all_single``
hands each rank only the ``D`` contributions to its own rows, and the
update runs on the owned slice, with the global gradient norm made from
V-aligned segment partial sums (one ``[V/D]`` all-gather a leaf) and
passed as ``apply_fn(..., grad_norm=)``.

``payload_bytes`` is the accounting: compressed bytes one virtual shard
ships a step (the per-tensor scales excluded).  The reference's
``step.collect`` (both stages as one module, for XLA's collective-byte
accounting) has no counterpart here.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.dist import rules as _rules
from repro_torch.nn.module import tree_leaves
from repro_torch.train.optimizer import tree_map

METHODS = ("none", "bf16", "int8")
OVERLAP_MODES = ("none", "dispatch", "backward")

# bytes a gradient element takes on the wire: every gradient is cast to
# fp32 before it is compressed, so "none" ships 4 bytes an element
_PAYLOAD_ITEMSIZE = {"none": 4, "bf16": 2, "int8": 1}
_WIRE_DTYPE = {"none": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}
_ALIGN = 16                       # byte alignment of a leaf in a pack


def normalise_overlap(overlap) -> str:
    """Legacy bools: True = "dispatch", False = "none"; None = the
    default, "dispatch"."""
    if overlap is None or overlap is True:
        return "dispatch"
    if overlap is False:
        return "none"
    if overlap not in OVERLAP_MODES:
        raise ValueError(
            f"unknown overlap mode {overlap!r}: expected one of "
            f"{OVERLAP_MODES} (or a legacy bool)")
    return overlap


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return torch.is_floating_point(x)
    return bool(np.issubdtype(np.asarray(x).dtype, np.floating))


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def dp_shard_count(mesh) -> int:
    return math.prod(mesh.shape[a] for a in _rules.data_mesh_axes(mesh))


def dp_partition_spec(mesh) -> tuple:
    """The placement spec sharding a leading axis (error-state rows, a
    round's batch rows, fsdp parameter rows) over the data axes."""
    dp = _rules.data_mesh_axes(mesh)
    return (dp if len(dp) > 1 else dp[0],)


def fsdp_leaf_sharded(v, n_shards: int) -> bool:
    """Whether ``fsdp=True`` row-shards this leaf: a float leaf whose
    leading dim is a positive multiple of the virtual shard count ``V``
    (a run constant, so the classification is the same on every world
    size a run may resume on).  Codes, scalars and ragged leading dims
    stay replicated."""
    shape = _shape(v)
    if not shape or math.prod(shape) == 0:
        return False
    if not _is_float(v):
        return False
    return shape[0] % int(n_shards) == 0


def fsdp_partition_specs(values, mesh, n_shards: int):
    """The placement-spec tree of the fsdp layout: V-divisible float
    leaves row-sharded over the data axes, the rest replicated."""
    sh = dp_partition_spec(mesh)
    return tree_map(
        lambda v: sh if fsdp_leaf_sharded(v, n_shards) else (), values)


def zeros_error_state(values, n_shards: int):
    """Per-virtual-shard error-feedback state: one fp32 residual a float
    leaf stacked along a leading ``n_shards`` axis, ``[V, 0]`` for any
    other leaf.  Row ``v`` belongs to batch slice ``v`` whatever the
    world size."""
    def _zeros(v):
        dev = v.device if isinstance(v, torch.Tensor) else "cpu"
        if _is_float(v):
            return torch.zeros((n_shards,) + _shape(v), dtype=torch.float32,
                               device=dev)
        return torch.zeros((n_shards, 0), dtype=torch.float32, device=dev)
    return tree_map(_zeros, values)


def payload_bytes(values, method: str) -> int:
    """Compressed gradient bytes one virtual shard ships a step, at the
    wire dtype (4 / 2 / 1 bytes an element for none / bf16 / int8)."""
    if method not in METHODS:
        raise ValueError(f"unknown compression method {method!r}")
    itemsize = _PAYLOAD_ITEMSIZE[method]
    total = 0
    for v in tree_leaves(values):
        if not _is_float(v):
            continue
        shape = _shape(v)
        n = int(math.prod(shape)) if shape else 1
        total += n * itemsize
    return total


def _quantise(t, method: str):
    """t = grad + error (fp32) -> (payload, scale, new_error).  int8:
    ``clip(round(t / scale), -127, 127)`` with ``scale = max(max|t| /
    127, 1e-30)``, rounding half to even, a true division."""
    if method == "bf16":
        q = t.to(torch.bfloat16)
        return q, None, t - q.to(torch.float32)
    if method == "int8":
        scale = torch.clamp(torch.max(torch.abs(t)) / 127.0, min=1e-30)
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        return q, scale, t - q.to(torch.float32) * scale
    return t, None, torch.zeros_like(t)                # none


def _dequantise(stack, scales, method: str):
    """[V, ...] payload stack (and [V] scales for int8) -> fp32 stack."""
    if method == "int8":
        sh = (stack.shape[0],) + (1,) * (stack.ndim - 1)
        return stack.to(torch.float32).mul_(scales.reshape(sh))
    return stack.to(torch.float32)


# ----------------------------------------------------------- collectives
class _Pending:
    """The work handles of one round's collectives; ``wait`` once."""

    def __init__(self, works):
        self.works = [w for w in works if w is not None]

    def wait(self):
        works, self.works = self.works, []
        for w in works:
            w.wait()


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8)


def shard_rows(tree, mesh, n_shards: int):
    """This rank's rows ``[v0, v0 + L)`` of a ``[V, ...]`` tree (the
    error state), as copies; ``v0 = d * L`` for its data index d (the
    model ranks of a data column hold the same rows)."""
    D = dp_shard_count(mesh)
    L = n_shards // D
    r = mesh.data_index
    return tree_map(lambda x: x[r * L:(r + 1) * L].clone(), tree)


def gather_rows(tree, mesh):
    """Every data rank's ``[L, ...]`` rows of a tree, as ``[V, ...]``
    in virtual order (all ranks get the whole)."""
    D = dp_shard_count(mesh)

    def _one(x):
        if D == 1:
            return x
        if not x.numel():
            return x.new_zeros((D * x.shape[0],) + tuple(x.shape[1:]))
        out, _ = mesh.all_gather_bytes(_bytes(x), "data")
        return out.view(x.dtype).reshape((-1,) + tuple(x.shape[1:]))
    return tree_map(_one, tree)


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _Layout:
    """Where each exchanged leaf sits in a round's packed buffers:
    replicated leaves in the gathered buffer ``[G]``; fsdp leaves in the
    scattered buffer ``[D, C]``, row d holding the rows rank d owns."""

    def __init__(self, leaves, flags, D: int, method: str):
        self.itemsize = _PAYLOAD_ITEMSIZE[method]
        self.dtype = _WIRE_DTYPE[method]
        self.D = D
        # exchanged leaves: float, non-empty (index into the leaves)
        self.idx = [i for i, x in enumerate(leaves)
                    if _is_float(x) and x.numel()]
        self.shapes = [tuple(leaves[i].shape) for i in self.idx]
        self.sharded = [bool(flags[i]) for i in self.idx]
        self.offsets, g, c = [], 0, 0
        for shape, sh in zip(self.shapes, self.sharded):
            nb = math.prod(shape) * self.itemsize
            if sh:
                self.offsets.append(c)
                c += _align(nb // D)
            else:
                self.offsets.append(g)
                g += _align(nb)
        self.g_bytes, self.c_bytes = g, c

    def gathered(self, buf, j: int):
        """Leaf j's payloads of every rank: ``[D, *shape]``."""
        shape, off = self.shapes[j], self.offsets[j]
        nb = math.prod(shape) * self.itemsize
        return buf[:, off:off + nb].view(self.dtype).view(
            (buf.shape[0],) + shape)

    def scattered(self, buf, j: int):
        """Leaf j's row blocks, one a rank: ``[D, n / D, *rest]``."""
        shape, off = self.shapes[j], self.offsets[j]
        nbd = math.prod(shape) * self.itemsize // self.D
        return buf[:, off:off + nbd].view(self.dtype).view(
            (self.D, shape[0] // self.D) + shape[1:])


def make_elastic_dp_step(loss_fn, mesh, method: str = "none", *,
                         accum_shards: Optional[int] = None,
                         has_aux: bool = False, with_rng: bool = False,
                         apply_fn=None, fsdp: bool = False,
                         overlap="dispatch", shapes=None):
    """Build the elastic-deterministic data-parallel step.

    ``loss_fn(values, batch[, generator]) -> loss`` (or ``(loss, aux)``
    with ``has_aux``).  Returns ``step``::

        step(values, err_rows, batch[, rng])            (no apply_fn)
            -> (grads, new_err_rows, loss[, aux])
        step(values, opt_state, err_rows, batch[, rng]) (with apply_fn)
            -> (new_values, new_opt, new_err_rows, metrics)

    ``batch`` is the global batch (a dict of tensors; rank d takes the
    rows of its slices); ``err_rows`` this rank's ``[L, ...]`` rows of
    the error state (``shard_rows``); ``rng(v)`` the generator of
    virtual shard v; ``apply_fn(values, opt_state, grads[, grad_norm=])
    -> (new_values, new_opt_state, stats)``; metrics = aux means, stats
    and ``"loss"``.  Gradients and loss are the fixed-order means over
    the ``V`` virtual shards: the same bits on every world size dividing
    ``V``.

    With ``fsdp=True``, ``shapes`` is the global values tree (tensors,
    or ``meta`` tensors) the row classification reads, and the values
    and optimizer-state trees hold this rank's slices (``step.shard``
    cuts them; ``step.gather`` puts parameters back together).

    ``step.n_shards`` is V, ``step.rounds`` L, ``step.last_schedule``
    the last call's ``(fb / issue / drain / consume, round)`` order; the
    scheduler calls the stages through ``step.forward_backward``,
    ``step.quantise_pack`` and ``step.combine``, so a caller may wrap
    them (to time them, say).
    """
    if method not in METHODS:
        raise ValueError(f"unknown compression method {method!r}")
    overlap = normalise_overlap(overlap)
    D = dp_shard_count(mesh)
    V = D if accum_shards is None else int(accum_shards)
    if V % D != 0:
        raise ValueError(
            f"accum_shards={V} must be a multiple of the mesh's "
            f"data-parallel degree {D}")
    L = V // D
    # the index on "data": the model ranks of a data column run the same
    # rounds on the same rows and exchange over their column's group
    rank = mesh.data_index
    flags_full = ([fsdp_leaf_sharded(x, V) for x in tree_leaves(shapes)]
                  if fsdp and shapes is not None else None)

    def _flags(leaves):
        if not fsdp:
            return [False] * len(leaves)
        if flags_full is None:
            if D > 1:
                raise ValueError("fsdp=True on more than one rank needs "
                                 "shapes= (the global values tree)")
            return [fsdp_leaf_sharded(x, V) for x in leaves]
        return flags_full

    # ------------------------------------------------------ fsdp layout
    def shard(tree):
        """This rank's slices of a global tree (values or a moment tree):
        rows ``[rank * n / D, (rank + 1) * n / D)`` of each fsdp leaf."""
        def _one(x):
            if not fsdp_leaf_sharded(x, V):
                return x
            n = x.shape[0] // D
            return x.detach()[rank * n:(rank + 1) * n].clone()
        return tree_map(_one, tree)

    def gather(tree):
        """The global tree of this rank's slices (one all-gather of the
        fsdp leaves' bytes)."""
        leaves = tree_leaves(tree)
        flags = _flags(leaves)
        if D == 1 or not any(flags):
            return tree
        sharded = [i for i, f in enumerate(flags) if f]
        parts = [_bytes(leaves[i].detach()) for i in sharded]
        out, _ = mesh.all_gather_bytes(torch.cat(parts), "data")
        full, off = {}, 0
        for i, part in zip(sharded, parts):
            x, nb = leaves[i], part.numel()
            full[i] = out[:, off:off + nb].contiguous().view(
                x.dtype).reshape((D * x.shape[0],) + tuple(x.shape[1:]))
            off += nb
        it = iter(range(len(leaves)))
        return tree_map(lambda x: full.get(next(it), x), tree)

    # ---------------------------------------------------------- stages
    def forward_backward(values_g, floats, mb, rng, v):
        """Virtual shard v's loss and fp32 gradients (one per exchanged
        leaf); no collective."""
        args = (values_g, mb) + ((rng(v),) if with_rng else ())
        out = loss_fn(*args)
        loss, aux = out if has_aux else (out, {})
        got = torch.autograd.grad(loss, floats, allow_unused=True)
        grads = [torch.zeros_like(x, dtype=torch.float32) if g is None
                 else g.to(torch.float32) for x, g in zip(floats, got)]
        del got
        return (grads, loss.detach().to(torch.float32),
                {k: a.detach().to(torch.float32) for k, a in aux.items()})

    def quantise_pack(lay, grads, err_r, new_err_r, loss, aux):
        """Error feedback, quantisation into the round's packed buffers,
        and the round's collectives, issued asynchronously.  Writes the
        new error rows into ``new_err_r``; returns (pending, gathered
        payloads [D, G], scattered payloads [D, C] or None, meta [D, M]:
        each rank's scales, loss and aux)."""
        dev = loss.device
        gbuf = torch.empty(lay.g_bytes, dtype=torch.uint8, device=dev)
        sbuf = (torch.empty((D, lay.c_bytes), dtype=torch.uint8, device=dev)
                if lay.c_bytes else None)
        scales = []
        for j, (g, e, ne) in enumerate(zip(grads, err_r, new_err_r)):
            t = g + e
            pay, scale, new_e = _quantise(t, method)
            ne.copy_(new_e)
            if scale is not None:
                scales.append(scale)
            if lay.sharded[j]:
                lay.scattered(sbuf, j).copy_(
                    pay.reshape((D, pay.shape[0] // D) + pay.shape[1:]))
            else:
                lay.gathered(gbuf[None], j)[0].copy_(pay)
            del t, pay, new_e
        # scales (int8; zeros otherwise), loss and aux: one small gather
        meta = torch.cat([torch.stack(scales) if scales else
                          torch.zeros(len(grads), device=dev),
                          loss.reshape(1)]
                         + [a.reshape(1) for a in aux.values()])
        meta_all, w0 = mesh.all_gather_bytes(_bytes(meta), "data",
                                             async_op=True)
        pays, w1 = mesh.all_gather_bytes(gbuf, "data", async_op=True)
        scat, w2 = ((None, None) if sbuf is None else
                    mesh.all_to_all_bytes(sbuf, "data", async_op=True))
        return (_Pending([w0, w1, w2]), pays, scat,
                meta_all.view(torch.float32).view(D, -1))

    def _stack_v(xs):
        """L rounds of ``[D, ...]`` -> ``[V, ...]`` in virtual order
        ``v = d * L + r`` (one contiguous copy)."""
        s = torch.stack(xs, dim=1)
        return s.reshape((V,) + tuple(s.shape[2:]))

    def combine(values, opt_state, lay, leaves, rounds, aux_keys):
        """Dequantise, the fixed-order mean, the global norm and the
        update (fsdp: of the owned slices)."""
        metas = _stack_v([r[3] for r in rounds])           # [V, M]
        nf = len(lay.idx)
        scales, losses = metas[:, :nf], metas[:, nf]
        grads = {}
        sq_terms, segs = [], []
        for j, i in enumerate(lay.idx):
            if lay.sharded[j]:
                xs = [lay.scattered(r[2], j) for r in rounds]
            else:
                xs = [lay.gathered(r[1], j) for r in rounds]
            deq = _dequantise(_stack_v(xs), scales[:, j], method)
            del xs
            if lay.sharded[j]:
                # the owned width n / D varies with D, so a reduction
                # over axis 0 need not keep its bracketing; an unrolled
                # elementwise chain over the V contributions does
                acc = deq[0]
                for vv in range(1, V):
                    acc = acc + deq[vv]
                g = acc / V
                # the global norm from V-aligned segments: segment s
                # covers rows [s n / V, (s + 1) n / V) of the leaf on
                # every world size
                slen = g.shape[0] // L
                segs.append(torch.stack([
                    torch.sum(torch.square(
                        g[k * slen:(k + 1) * slen].clone()))
                    for k in range(L)]))
                sq_terms.append(len(segs) - 1)
            else:
                g = torch.mean(deq, dim=0)
                if fsdp:
                    sq_terms.append(torch.sum(torch.square(g)))
            del deq
            grads[i] = g
        if segs:
            seg_all, _ = mesh.all_gather_bytes(_bytes(torch.cat(segs)),
                                               "data")
            seg_all = seg_all.view(torch.float32).view(D, len(segs), L)
            sq_terms = [t if isinstance(t, torch.Tensor) else
                        torch.sum(seg_all[:, t, :].reshape(V).clone())
                        for t in sq_terms]
        it = iter(range(len(leaves)))

        def _grad(x):
            i = next(it)
            if i in grads:
                return grads[i]
            return torch.zeros_like(x)      # unexchanged (int/empty) leaf
        grads_t = tree_map(_grad, values)
        loss = torch.mean(losses)
        aux = {k: torch.mean(metas[:, nf + 1 + n])
               for n, k in enumerate(aux_keys)}
        if apply_fn is None:
            return grads_t, loss, aux
        if fsdp:
            gn = (torch.sqrt(sum(sq_terms)) if sq_terms
                  else torch.zeros((), dtype=torch.float32))
            new_values, new_opt, stats = apply_fn(values, opt_state,
                                                  grads_t, grad_norm=gn)
        else:
            new_values, new_opt, stats = apply_fn(values, opt_state,
                                                  grads_t)
        return new_values, new_opt, {"loss": loss, **aux, **stats}

    # ------------------------------------------------------- scheduler
    def _run(values, opt_state, err_rows, batch, rng):
        for k, x in batch.items():
            if x.shape[0] % V != 0:
                raise ValueError(
                    f"batch leading dim {x.shape[0]} not divisible by "
                    f"accum_shards={V}")
        values_full = step.gather(values) if fsdp else values
        leaves = tree_leaves(values_full)
        lay = _Layout(leaves, _flags(leaves), D, method)
        # differentiable views of the parameters, sharing their storage
        vals_g = tree_map(
            lambda x: x.detach().requires_grad_(True)
            if _is_float(x) and x.numel() else x, values_full)
        g_leaves = tree_leaves(vals_g)
        floats = [g_leaves[i] for i in lay.idx]
        e_leaves = tree_leaves(err_rows)
        errs = [e_leaves[i] for i in lay.idx]
        new_err = [torch.empty_like(e) for e in errs]
        rows = {k: x.shape[0] // V for k, x in batch.items()}
        fb_outs: List = [None] * L
        rounds: List = [None] * L
        schedule = []
        aux_keys: List = []

        def issue_fb(r):
            v = rank * L + r
            mb = {k: x[v * rows[k]:(v + 1) * rows[k]].clone()
                  for k, x in batch.items()}
            schedule.append(("fb", r))
            fb_outs[r] = step.forward_backward(vals_g, floats, mb, rng, v)

        def issue_qp(r):
            grads, loss, aux = fb_outs[r]
            aux_keys[:] = list(aux)
            schedule.append(("issue", r))
            return step.quantise_pack(lay, grads, [e[r] for e in errs],
                                      [e[r] for e in new_err], loss, aux)

        def consume(r, q):
            schedule.append(("consume", r))
            rounds[r] = q
            fb_outs[r] = None     # drop the uncompressed gradients

        if overlap == "dispatch":
            def issue(r):
                issue_fb(r)
                return issue_qp(r)
            pending, prev = issue(0), None
            for r in range(L):
                nxt = issue(r + 1) if r + 1 < L else None
                if prev is not None:
                    prev[0].wait()
                    schedule.append(("drain", r - 1))
                consume(r, pending)
                prev, pending = pending, nxt
        elif overlap == "backward":
            issue_fb(0)
            prev = None
            for r in range(L):
                q = issue_qp(r)
                if r + 1 < L:
                    issue_fb(r + 1)
                if prev is not None:
                    prev[0].wait()
                    schedule.append(("drain", r - 1))
                consume(r, q)
                prev = q
        else:                                          # "none": serial
            for r in range(L):
                issue_fb(r)
                q = issue_qp(r)
                q[0].wait()
                consume(r, q)
        step.last_schedule = tuple(schedule)
        for q in rounds:
            q[0].wait()
        it = iter(range(len(e_leaves)))
        by_i = dict(zip(lay.idx, new_err))
        new_err_t = tree_map(lambda e: by_i.get(next(it), e), err_rows)
        del vals_g, floats, g_leaves
        out = step.combine(values, opt_state, lay, leaves, rounds, aux_keys)
        if apply_fn is None:
            grads, loss, aux = out
            ret = (grads, new_err_t, loss)
            return ret + ((aux,) if has_aux else ())
        new_values, new_opt, mets = out
        return new_values, new_opt, new_err_t, mets

    if apply_fn is None:
        if with_rng:
            def step(values, err_rows, batch, rng):
                return _run(values, None, err_rows, batch, rng)
        else:
            def step(values, err_rows, batch):
                return _run(values, None, err_rows, batch, None)
    else:
        if with_rng:
            def step(values, opt_state, err_rows, batch, rng):
                return _run(values, opt_state, err_rows, batch, rng)
        else:
            def step(values, opt_state, err_rows, batch):
                return _run(values, opt_state, err_rows, batch, None)

    step.n_shards = V
    step.rounds = L
    step.method = method
    step.fsdp = fsdp
    step.overlap = overlap
    step.forward_backward = forward_backward
    step.quantise_pack = quantise_pack
    step.combine = combine
    step.gather = gather if fsdp else None
    step.shard = shard if fsdp else None
    step.last_schedule = ()
    return step


def make_dp_grad_fn(loss_fn, mesh, method: str = "none", *,
                    accum_shards: Optional[int] = None,
                    fsdp: bool = False, overlap="dispatch", shapes=None):
    """Grads-only surface: ``(values, err_rows, batch) -> (grads,
    err_rows, loss)`` with ``loss_fn(values, batch) -> scalar``; the
    fixed-order across-shard means, the same bits on every world size
    dividing ``accum_shards``.  Non-float leaves come back as zeros in
    their own shape and dtype."""
    return make_elastic_dp_step(loss_fn, mesh, method,
                                accum_shards=accum_shards, fsdp=fsdp,
                                overlap=overlap, shapes=shapes)
