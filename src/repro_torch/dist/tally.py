"""What one rank's step costs, counted from the operators it runs: the
port's counterpart of the reference's HLO accounting (``dist/hlo.py``
and XLA's ``cost_analysis`` / ``memory_analysis``).

``Tally`` is a ``TorchDispatchMode``: every operator of the step passes
through it, on fake tensors (``FakeTensorMode``, the dry run's trace,
``launch/dryrun.py``) or on real ones (a step on the CPU or the card,
which the tests and ``chip_smoke.py`` hold the trace against).  It
counts, on this rank:
  * FLOPs by dtype: ``torch.utils.flop_counter``'s formulas (matrix
    products, attention, convolutions; elementwise work counts none, as
    there), plus each kernel operator's registered cost
    (``kernels/cost.op_cost``; the pruned sweep counts its full sweep
    and marks the count an upper bound);
  * bytes: each operator's inputs read once and its outputs written
    once, views and allocations excepted.  PyTorch runs eagerly, with
    no fusion, so this is an upper bound where XLA's fused count is
    lower;
  * memory: the live bytes of every storage it sees (the step's
    arguments, found as they are first read, and everything the step
    makes), each rounded as the CUDA caching allocator rounds a block
    (512 bytes), with a view never counted twice; their peak, with a
    kernel operator's scratch added while it runs, and the workspaces
    torch makes for a CUDA device's matrix products and then holds
    (``cublas_workspaces``): cuBLAS's from the first product on,
    cuBLASLt's from the first product with a bias.
Collectives are counted by ``HostMesh`` (its ``comm_by``), which
``collective_bytes`` turns into the reference's record.
"""
from __future__ import annotations

import os
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import cost as _cost

_NS = "repro_torch"
# operators that move no data of their own: allocations without a fill,
# aliases, scalar and metadata reads, and the collectives
# (``collective_bytes``)
_NO_BYTES = {"aten::empty", "aten::empty_strided", "aten::new_empty",
             "aten::new_empty_strided", "aten::empty_like", "aten::detach",
             "aten::alias", "aten::lift_fresh", "aten::_local_scalar_dense",
             "aten::set_", "aten::resize_"}
_NO_BYTES_NS = ("c10d", "_c10d_functional", "c10d_functional", "prim")
BLOCK = 512        # the caching allocator's rounding of a block
# the operators torch runs through cuBLAS on a CUDA device, and those
# of them that take cuBLASLt's route (a product plus a 1-D bias)
_CUBLAS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
           "aten::addbmm", "aten::mv", "aten::addmv", "aten::dot",
           "aten::vdot", "aten::_addmm_activation"}
_CUBLASLT = {"aten::addmm", "aten::_addmm_activation"}


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as the CUDA caching allocator holds it: 0 for an empty
    storage, else rounded up to a whole number of 512-byte units."""
    return 0 if nbytes <= 0 else -(-nbytes // BLOCK) * BLOCK


def cublas_workspaces() -> dict:
    """The bytes of the workspaces torch allocates on an H100 for a
    stream's first matrix product and keeps: ``cublas`` (any product;
    ``CUBLAS_WORKSPACE_CONFIG``'s ``:KiB:count`` pairs, else torch's
    default for sm_90, 4,096 KiB x 8) and ``cublaslt`` (the first
    product with a 1-D bias, cuBLASLt's route;
    ``TORCH_CUBLASLT_WORKSPACE_SIZE`` KiB, else 1,024)."""
    cfg = [int(x) for x in
           os.environ.get("CUBLAS_WORKSPACE_CONFIG", "").split(":") if x]
    cublas = (sum(a * b for a, b in zip(cfg[::2], cfg[1::2])) if cfg
              else 4096 * 8) * 1024
    lt = int(os.environ.get("TORCH_CUBLASLT_WORKSPACE_SIZE", 1024)) * 1024
    return {"cublas": block_bytes(cublas), "cublaslt": block_bytes(lt)}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


class Tally(TorchDispatchMode):
    """Counts a region's FLOPs by dtype, bytes and memory (module
    docstring).  ``resident``: tensors live before the region (a step's
    arguments), counted as ``argument_bytes``; a storage first seen as
    an input inside the region joins them.  ``finish(outputs)`` splits
    the memory into the reference's argument, output, alias and temp
    sizes."""

    def __init__(self, resident=()):
        super().__init__()
        self.flops = defaultdict(int)
        self.bytes = 0
        self.kernel_calls = defaultdict(int)
        self.upper_bound = set()        # kernel ops whose count is a bound
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.workspace_bytes = 0
        self._workspaces: set = set()   # (device, kind) made so far
        self._refs: dict = {}           # id(storage) -> (weakref, bytes)
        self._args: set = set()         # ids of argument storages
        for t in _tensors(resident):
            self._track(t, argument=True)

    # ------------------------------------------------------------ memory
    def _track(self, t, argument=False) -> bool:
        """Count ``t``'s storage once; returns whether it was new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return False
        n = block_bytes(st.nbytes())

        def freed(_, key=key, n=n):
            if self._refs.pop(key, None) is not None:
                self.live -= n
                self._args.discard(key)

        self._refs[key] = (weakref.ref(st, freed), n)
        self.live += n
        if argument:
            self._args.add(key)
            self.argument_bytes += n
        self.peak = max(self.peak, self.live)
        return True

    def _workspace(self, device, kind):
        """The ``kind`` workspace of ``device``, made by its first
        product of that kind and held from then on."""
        if (device, kind) in self._workspaces:
            return
        self._workspaces.add((device, kind))
        n = cublas_workspaces()[kind]
        self.workspace_bytes += n
        self.live += n
        self.peak = max(self.peak, self.live)

    def finish(self, outputs) -> dict:
        """The reference's memory record of the region that returned
        ``outputs``: argument, output (storages the region made),
        alias (outputs that are arguments, updated in place) and temp
        (the peak less the arguments and outputs; the workspaces among
        them) bytes, and the peak."""
        seen, out_b, alias_b = set(), 0, 0
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            n = block_bytes(st.nbytes())
            if id(st) in self._args:
                alias_b += n
            else:
                out_b += n
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": out_b,
                "alias_size_in_bytes": alias_b,
                "temp_size_in_bytes": max(0, self.peak - self.argument_bytes
                                          - out_b),
                "workspace_bytes": self.workspace_bytes,
                "peak_bytes": self.peak}

    # ------------------------------------------------------------- count
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            self._track(t, argument=True)
        out = func(*args, **kwargs)
        name = func._schema.name
        ns, short = name.split("::", 1)
        outs = _tensors(out)
        if ns == _NS:
            c = _cost.op_cost(short, args, out)
            made = sum(block_bytes(t.untyped_storage().nbytes())
                       for t in outs
                       if id(t.untyped_storage()) not in self._refs)
            for dt, n in c["flops"].items():
                self.flops[dt] += int(n)
            self.bytes += int(c["bytes"])
            self.peak = max(self.peak, self.live + made + c["scratch"])
            self.kernel_calls[short] += 1
            if c.get("upper_bound"):
                self.upper_bound.add(short)
        else:
            if name in _CUBLAS and outs and outs[0].is_cuda:
                self._workspace(outs[0].device, "cublas")
                if name in _CUBLASLT and args[0].dim() == 1:
                    self._workspace(outs[0].device, "cublaslt")
            formula = _flop_registry().get(func._overloadpacket)
            if formula is not None:
                ins = _tensors(args)
                dt = _dtype(ins[0] if ins else outs[0])
                self.flops[dt] += int(formula(*args, **kwargs, out_val=out))
            if not (func.is_view or name in _NO_BYTES
                    or ns in _NO_BYTES_NS):
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out

    def record(self) -> dict:
        """FLOPs by dtype and in all, bytes, and the kernel ops' calls."""
        return {"flops_by_dtype": dict(self.flops),
                "flops": sum(self.flops.values()),
                "bytes": self.bytes,
                "kernel_calls": dict(self.kernel_calls),
                "upper_bound_ops": sorted(self.upper_bound)}


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def collective_bytes(comm_by: dict) -> dict:
    """``HostMesh.comm_by`` (calls and bytes by (op, axis, dtype)) as the
    reference's ``dist.hlo.collective_bytes`` record: ``per_op_bytes``,
    ``per_op_counts``, ``per_op_dtype_bytes``, ``total_bytes``, with the
    ops spelled as HLO spells them, plus ``per_axis_bytes`` and
    ``per_op_axis_bytes`` (the split by mesh axis)."""
    per_bytes, per_counts = defaultdict(int), defaultdict(int)
    per_dtype = defaultdict(lambda: defaultdict(int))
    per_axis, per_op_axis = defaultdict(int), defaultdict(
        lambda: defaultdict(int))
    for (op, axis, dtype), (calls, nbytes) in sorted(comm_by.items()):
        per_bytes[op] += nbytes
        per_counts[op] += calls
        per_dtype[op][dtype] += nbytes
        per_axis[axis] += nbytes
        per_op_axis[op][axis] += nbytes
    return {"per_op_bytes": dict(per_bytes),
            "per_op_counts": dict(per_counts),
            "per_op_dtype_bytes": {k: dict(v) for k, v in per_dtype.items()},
            "total_bytes": sum(per_bytes.values()),
            "per_axis_bytes": dict(per_axis),
            "per_op_axis_bytes": {k: dict(v)
                                  for k, v in per_op_axis.items()}}


def comm_since(mesh, before: dict) -> dict:
    """``mesh.comm_by`` less a copy taken earlier (``dict(mesh.comm_by)``):
    the collectives of a region."""
    out = {}
    for key, (calls, nbytes) in mesh.comm_by.items():
        c0, b0 = before.get(key, (0, 0))
        if calls - c0:
            out[key] = (calls - c0, nbytes - b0)
    return out
