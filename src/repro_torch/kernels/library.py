"""The hand-written kernels as operators of the ``repro_torch`` namespace
(``torch.ops.repro_torch.<name>``), so the dispatcher, fake tensors and
the dry run's tally (``dist/tally.py``) see each call as one operator.

Each operator has three implementations, chosen by the dispatcher:
  CUDA - the kernel's ctypes launch (``kernels/*/cuda.py``), which counts
         its launches as before;
  CPU  - the kernel's plain PyTorch version (``kernels/*/ref.py``, or the
         plain scans in ``jpq_topk/ops.py``);
  fake - the outputs' shapes and dtypes alone (``FakeTensorMode``, the
         ``meta`` device), for tracing a step with no data.
The device still picks the route, and there is no fallback: a CUDA
tensor reaches the kernel or raises.  The public wrappers and the
``autograd.Function``s in each ``ops.py`` call the operators; none of
them has an autograd formula of its own.  Each operator's cost (FLOPs by
dtype, HBM bytes, the card's scratch) is ``kernels/cost.op_cost``.

Registered through ``torch.library.Library``'s ``define`` / ``impl``
(the lower-level route: no per-call wrapper of its own), once, when
this module is imported; importing it starts nothing and builds nothing.
"""
from __future__ import annotations

import functools

import torch

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")
# op name -> its schema, for the tests' opcheck and the tally
SCHEMAS: dict = {}


def define(schema: str, *, cpu, cuda, fake) -> None:
    """Define ``repro_torch::<schema>`` with its CPU, CUDA and fake
    implementations."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    SCHEMAS[name] = schema


@functools.lru_cache(maxsize=None)
def op(name: str):
    """``torch.ops.repro_torch.<name>.default`` (looked up once)."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def has_data(t) -> bool:
    """Whether ``t`` holds values that the host may read: False for a
    fake tensor (``FakeTensorMode``) or one on the ``meta`` device, where
    a wrapper takes the largest size a data-dependent count can reach
    and skips its host checks."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type != "meta" and not is_fake(t)


def _register() -> None:
    from repro_torch.kernels.embedding_bag import cuda as bag_cuda
    from repro_torch.kernels.embedding_bag import ref as bag_ref
    from repro_torch.kernels.jpq_lookup import cuda as look_cuda
    from repro_torch.kernels.jpq_lookup import ref as look_ref
    from repro_torch.kernels.jpq_scores import cuda as sc_cuda
    from repro_torch.kernels.jpq_scores import ref as sc_ref
    from repro_torch.kernels.jpq_topk import cuda as tk_cuda

    # --------------------------------------------------------- jpq_scores
    define("jpq_scores(Tensor partial, Tensor codes) -> Tensor",
           cpu=sc_ref.jpq_scores_lut_ref,
           cuda=lambda p, c: sc_cuda.jpq_scores(p.contiguous(), c),
           fake=lambda p, c: p.new_empty((p.shape[0], c.shape[0])))
    define("jpq_scores_bwd(Tensor dS, Tensor codes, int b) -> Tensor",
           cpu=sc_ref.jpq_scores_lut_bwd_ref,
           cuda=lambda d, c, b: sc_cuda.jpq_scores_bwd(d.contiguous(), c, b),
           fake=lambda d, c, b: d.new_empty((d.shape[0], c.shape[1], b)))

    # --------------------------------------------------------- jpq_lookup
    define("jpq_lookup(Tensor ids, Tensor codes, Tensor centroids) -> Tensor",
           cpu=look_ref.jpq_lookup_ref,
           cuda=lambda i, c, ce: look_cuda.jpq_lookup(i.contiguous(), c,
                                                      ce.contiguous()),
           fake=lambda i, c, ce: ce.new_empty((i.shape[0], ce.shape[0],
                                               ce.shape[2])))
    define("jpq_lookup_bwd(Tensor ids, Tensor codes, Tensor dout, int b) "
           "-> Tensor",
           cpu=look_ref.jpq_lookup_bwd_ref,
           cuda=lambda i, c, d, b: look_cuda.jpq_lookup_bwd(
               i.contiguous(), c, d.contiguous(), b),
           fake=lambda i, c, d, b: d.new_empty((c.shape[1], b, d.shape[2])))

    # ----------------------------------------------------------- jpq_topk
    def topk_cpu(partial, codes, k, block_n):
        from repro_torch.kernels.jpq_topk import ops as tk_ops
        N = codes.shape[0]
        bn = block_n or tk_ops.scan_block_n(N)
        return tk_ops.jpq_topk_scan(partial, codes, k,
                                    block_n=min(bn, tk_ops._ceil_mult(N, 128)))

    def topk_fake(partial, codes, k, block_n):
        B = partial.shape[0]
        return (partial.new_empty((B, k)),
                partial.new_empty((B, k), dtype=torch.int32))

    define("jpq_topk(Tensor partial, Tensor codes, int k, int? block_n) "
           "-> (Tensor, Tensor)",
           cpu=topk_cpu,
           cuda=lambda p, c, k, bn: tk_cuda.jpq_topk(p, c, k, chunk=bn),
           fake=topk_fake)

    def pruned_cpu(partial, codes, ids, present, floor, vals0, ids0, k,
                   block_n, tie_break_ids):
        from repro_torch.kernels.jpq_topk import ops as tk_ops
        v, i, skips = tk_ops.jpq_topk_scan_pruned(
            partial, codes, ids, present, floor, vals0, ids0, k=k,
            block_n=block_n, tie_break_ids=tie_break_ids)
        # one query group over all B rows; never the seed list itself
        return v.clone(), i.clone(), skips[None, :]

    def pruned_cuda(partial, codes, ids, present, floor, vals0, ids0, k,
                    block_n, tie_break_ids):
        return tk_cuda.jpq_topk_pruned(
            partial, codes, ids, present, floor, vals0, ids0, k=k,
            block_n=block_n, tie_break_ids=tie_break_ids)

    def pruned_fake(partial, codes, ids, present, floor, vals0, ids0, k,
                    block_n, tie_break_ids):
        B = partial.shape[0]
        groups = (-(-B // tk_cuda.PRUNED_GROUP)
                  if partial.device.type == "cuda" else 1)
        return (partial.new_empty((B, k)),
                partial.new_empty((B, k), dtype=torch.int32),
                partial.new_empty((groups, present.shape[0]),
                                  dtype=torch.int32))

    define("jpq_topk_pruned(Tensor partial, Tensor codes, Tensor ids, "
           "Tensor present, Tensor floor, Tensor init_vals, "
           "Tensor init_ids, int k, int block_n, bool tie_break_ids) "
           "-> (Tensor, Tensor, Tensor)",
           cpu=pruned_cpu, cuda=pruned_cuda, fake=pruned_fake)

    # ------------------------------------------------------ embedding_bag
    def bag_cpu(table, ids, weights):
        out = bag_ref.embedding_bag_ref(table, ids, weights)
        return out, torch.zeros((ids.shape[0],), dtype=torch.int32,
                                device=ids.device)

    def bag_fake(table, ids, weights):
        dt = torch.promote_types(table.dtype, torch.float32)
        return (table.new_empty((ids.shape[0], table.shape[1]), dtype=dt),
                ids.new_empty((ids.shape[0],), dtype=torch.int32))

    define("embedding_bag(Tensor table, Tensor ids, Tensor? weights) "
           "-> (Tensor, Tensor)",
           cpu=bag_cpu, cuda=bag_cuda.launch, fake=bag_fake)

    def sort_cpu(ids, V, wrap):
        perm, offs, lng, bad = bag_ref.sort_ids_ref(
            ids, V, wrap=wrap, long_run=bag_cuda.LONG_RUN)
        P = ids.numel()
        pos_t = torch.int32 if P < 2 ** 31 else torch.int64
        work = torch.zeros((bag_cuda.work_rows(P, V),), dtype=torch.int32)
        work[:lng.numel()] = lng.to(torch.int32)
        meta = torch.tensor([lng.numel(), 0, 0, int(bad)],
                            dtype=torch.int32)
        return perm.to(pos_t), offs.to(pos_t), work, meta

    def sort_fake(ids, V, wrap):
        P = ids.numel()
        pos_t = torch.int32 if P < 2 ** 31 else torch.int64
        return (ids.new_empty((P,), dtype=pos_t),
                ids.new_empty((V + 1,), dtype=pos_t),
                ids.new_empty((bag_cuda.work_rows(P, V),), dtype=torch.int32),
                ids.new_empty((4,), dtype=torch.int32))

    define("bag_sort_ids(Tensor ids, int V, bool wrap) "
           "-> (Tensor, Tensor, Tensor, Tensor)",
           cpu=sort_cpu, cuda=bag_cuda.sort_tensors, fake=sort_fake)

    # mode: 0 the bag's gradient (an id outside [0, V) raises), 1 a
    # gather's (a negative id counts from the end), 2 a row block's (the
    # id V marks a foreign slot, skipped)
    def bwd_cpu(ids, weights, dout, V, perm, offs, work, counters, n_long,
                mode):
        if mode == 1:
            return bag_ref.gather_backward_ref(ids, dout, V)
        if mode == 2:
            return bag_ref.block_backward_ref(ids, weights, dout, V)
        return bag_ref.embedding_bag_backward_ref(ids, weights, dout, V)

    def bwd_fake(ids, weights, dout, V, perm, offs, work, counters, n_long,
                 mode):
        return dout.new_empty((V, dout.shape[-1]))

    define("bag_backward(Tensor ids, Tensor? weights, Tensor dout, int V, "
           "Tensor? perm, Tensor? offs, Tensor? work, Tensor? counters, "
           "int n_long, int mode) -> Tensor",
           cpu=bwd_cpu, cuda=bag_cuda.backward_op, fake=bwd_fake)


_register()
