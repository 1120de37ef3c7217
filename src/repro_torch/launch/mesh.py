"""The ``(data, model)`` mesh over ``torch.distributed``.

``HostMesh`` is the port's counterpart of the reference's host mesh
(``repro.launch.mesh.make_host_mesh``): axis names ``("data",
"model")``, their sizes, and this process's rank in the process group
that carries the collectives.  Ranks take ``jax.make_mesh((data,
model))``'s device order, ``rank = d * model + m``; each rank also holds
the sub-groups of its ``"model"`` row and its ``"data"`` column.  A mesh
built from sizes alone (``group=False``) has no group and serves the
layout arithmetic (``dist.compression.payload_bytes``,
``TrainSpec.resolve_accum``) only.

The transport is the caller's choice, never a fallback:
  * ``"gloo"``        CPU tensors;
  * ``"nccl"``        CUDA tensors, each rank on a card of its own;
  * ``"gloo-staged"`` CUDA tensors of ranks that share one card
    (``spawn(..., share_card=True)``): NCCL refuses two ranks on one
    device, so every collective of ``HostMesh`` copies the payload to
    host memory, runs gloo there and copies the result back;
  * ``"fake"``        torch's fake process group in one process, standing
    for one rank of a mesh of any size (``make_fake_mesh``): the
    collectives move nothing, their results keep their shapes, and the
    records below count them as the real ones would.  The dry run
    (``launch/dryrun.py``) traces a rank's step over it on fake tensors.
A tensor on the wrong side of its transport raises.

Every collective of the port goes through ``HostMesh``: ``all_gather``
and ``all_reduce`` (the model code's), ``broadcast`` (a tensor, or a
small dict of tensors, from one rank: the request server's batches),
and ``all_gather_bytes`` / ``all_to_all_bytes`` (exact byte movement
over one axis, synchronous or issued with a handle that ``wait``s: the
elastic exchange's payloads).  ``comm`` counts them all, and
``comm_by`` splits the same counts by (op, axis, dtype) with the
reference's spellings (``dist/tally.collective_bytes`` reads it).

The roofline constants at the end are one H100's (``compute_s``,
``memory_s``, ``collective_s``), the dry run's terms.

The group is initialised from a ``FileStore`` in a temporary directory,
so nothing needs a network.  ``make_host_mesh`` makes a world of one in
the calling process; a world of N runs N processes, which ``spawn``
starts (``launch/train.py --devices N`` on the CPU, ``launch/serve.py
--mesh S``).
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")
TRANSPORTS = ("gloo", "nccl", "gloo-staged", "fake")
# the reference's HLO spellings: HostMesh's calls -> collective ops, and
# torch dtypes -> HLO element types
OP_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "all_to_all": "all-to-all", "broadcast": "collective-broadcast"}
HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
              torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
              torch.int64: "s64", torch.bool: "pred"}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class HostMesh:
    """A ``(data, model)`` mesh: ``shape`` maps axis name to size,
    ``rank`` is this process's rank in the group (``d * model + m``;
    its index on the data axis when ``model == 1``), ``groups`` the
    sub-group of each axis through this rank (``None`` for an axis of
    size 1).  ``comm`` counts the collectives it ran: calls, the bytes
    of their results on this rank, and host seconds (staging included;
    for NCCL, the enqueue; for an issued collective, its issue and its
    ``wait``); ``comm_by`` the same calls and bytes by ``(op, axis,
    dtype)``: op as the reference's HLO spells it (``OP_NAMES``), axis
    ``"data"``, ``"model"`` or ``"world"``, dtype as HLO spells it."""

    def __init__(self, data: int, model: int = 1, *, rank: int = 0,
                 group=None, device="cpu", owned_dir: Optional[str] = None,
                 groups=None, transport: Optional[str] = None):
        self.shape = {"data": int(data), "model": int(model)}
        self.axis_names = AXES
        self.rank = int(rank)
        self.group = group
        self.groups = dict(groups or {})
        self.device = _indexed(device)
        self.transport = transport or backend_for(self.device)
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport {self.transport!r} not in "
                             f"{TRANSPORTS}")
        self.comm = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self.comm_by: dict = {}
        self._owned_dir = owned_dir

    @property
    def world_size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    def _group_of(self, axes):
        axes = tuple(a for a in axes if self.shape[a] > 1)
        n = math.prod(self.shape[a] for a in axes)
        if n > 1 and self.group is None:
            raise ValueError("a sizes-only mesh (group=False) runs no "
                             "collective")
        if len(axes) != 1:                   # none, or both: the world
            return self.group, n
        return self.groups[axes[0]], n

    def _record(self, op: str, axes, out) -> None:
        """Count one collective: ``comm``'s calls and bytes, and
        ``comm_by``'s entry of (op, axis, dtype)."""
        axes = tuple(a for a in axes if self.shape[a] > 1)
        axis = axes[0] if len(axes) == 1 else "world"
        nbytes = out.numel() * out.element_size()
        self.comm["calls"] += 1
        self.comm["bytes"] += nbytes
        key = (OP_NAMES[op], axis, HLO_DTYPES.get(out.dtype, str(out.dtype)))
        calls, total = self.comm_by.get(key, (0, 0))
        self.comm_by[key] = (calls + 1, total + nbytes)

    def _check_side(self, x) -> None:
        if self.transport == "fake":
            return
        want_cuda = self.transport != "gloo"
        if x.is_cuda != want_cuda:
            raise ValueError(
                f"a {x.device.type} tensor on the {self.transport} "
                f"transport (gloo: CPU tensors; nccl and gloo-staged: "
                f"CUDA tensors)")

    def _collective(self, x, fn, op: str, axes):
        """Run ``fn`` on ``x`` over this mesh's transport: in place on
        the tensor for gloo, NCCL and fake, on a host copy for
        gloo-staged; recorded as ``op`` over ``axes``."""
        self._check_side(x)
        if self.transport == "gloo-staged":
            torch.cuda.synchronize(x.device)   # time the exchange alone
        t0 = time.perf_counter()
        if self.transport == "gloo-staged":
            out = fn(x.cpu()).to(x.device)
        else:
            out = fn(x)
        self._record(op, axes, out)
        self.comm["seconds"] += time.perf_counter() - t0
        return out

    def _issue(self, x, out_shape, fn, async_op: bool, op: str, axis: str):
        """Issue ``fn(src, out)`` (a ``torch.distributed`` call with
        ``async_op=True`` that writes ``out``, shaped ``out_shape``)
        on ``x``; returns (the result, its handle).  On gloo-staged the
        handle's ``wait`` copies the host result to the card.  A
        synchronous call waits before it returns."""
        self._check_side(x)
        staged = self.transport == "gloo-staged"
        if staged:
            torch.cuda.synchronize(x.device)   # time the exchange alone
        t0 = time.perf_counter()
        src = x.contiguous()
        if staged:
            src = src.cpu()
        out = torch.empty(out_shape, dtype=x.dtype, device=src.device)
        work = fn(src, out)
        result = (torch.empty(out_shape, dtype=x.dtype, device=x.device)
                  if staged else out)
        self._record(op, (axis,), out)
        self.comm["seconds"] += time.perf_counter() - t0
        handle = _Work(self, work, (result, out) if staged else None)
        if not async_op:
            handle.wait()
        return result, handle

    def all_gather_bytes(self, buf, axis: str = "data", *,
                         async_op: bool = False):
        """``buf`` (1-D ``uint8``) of every rank of ``axis`` -> ``[n,
        nbytes]`` in ascending axis index, and its handle (``wait``
        before reading the result): exact data movement whatever the
        backend does with a dtype.  An axis of one returns ``buf[None]``
        and runs nothing."""
        group, n = self._group_of((axis,))
        if n == 1:
            return buf[None], _DONE

        def fn(src, out):
            return dist.all_gather(list(out.unbind(0)), src, group=group,
                                   async_op=True)
        return self._issue(buf, (n, buf.numel()), fn, async_op, "all_gather",
                           axis)

    def all_to_all_bytes(self, buf, axis: str = "data", *,
                         async_op: bool = False):
        """``buf [n, C]`` (``uint8``; row j for the rank of axis index
        j) -> ``[n, C]`` whose row s came from the rank of index s, and
        its handle.  An axis of one returns ``buf``."""
        group, n = self._group_of((axis,))
        if n == 1:
            return buf, _DONE

        def fn(src, out):
            return dist.all_to_all_single(out.view(-1), src.view(-1),
                                          group=group, async_op=True)
        return self._issue(buf, tuple(buf.shape), fn, async_op, "all_to_all",
                           axis)

    def broadcast(self, x, src: int = 0, axis: Optional[str] = None):
        """Rank ``src``'s ``x`` (``src`` its index on ``axis``, or its
        rank in the world when ``axis`` is None) on every rank of the
        group.  ``x`` is a tensor, which the other ranks pass shaped and
        typed as the sender's, or a dict of tensors, which the other
        ranks pass as None: its keys, dtypes and shapes travel first
        (one ``int64 [2]`` broadcast of the sizes, then one ``uint8``
        broadcast of the header and the payload).  Returns a new tensor
        (or dict) on every rank."""
        group, n = self._group_of(AXES if axis is None else (axis,))
        if n == 1:
            return x
        root = self._global_rank(src, axis)
        axes = AXES if axis is None else (axis,)
        if not isinstance(x, dict) and x is not None:
            return self._broadcast_tensor(x, root, group, axes)
        dev = self.device
        if self.rank == root:
            keys = list(x)
            tensors = [x[k].contiguous() for k in keys]
            head = json.dumps([[k, str(t.dtype).removeprefix("torch."),
                                list(t.shape)]
                               for k, t in zip(keys, tensors)]).encode()
            body = [t.view(-1).view(torch.uint8) for t in tensors]
            buf = torch.cat([torch.frombuffer(bytearray(head),
                                              dtype=torch.uint8).to(dev)]
                            + [b.to(dev) for b in body])
            sizes = torch.tensor([len(head), buf.numel()],
                                 dtype=torch.int64, device=dev)
        else:
            sizes = torch.zeros(2, dtype=torch.int64, device=dev)
        sizes = self._broadcast_tensor(sizes, root, group, axes)
        n_head, n_buf = (int(v) for v in sizes.cpu())
        if self.rank != root:
            buf = torch.empty(n_buf, dtype=torch.uint8, device=dev)
        buf = self._broadcast_tensor(buf, root, group, axes)
        head = json.loads(bytes(buf[:n_head].cpu().numpy()))
        out, off = {}, n_head
        for key, dtype, shape in head:
            dt = getattr(torch, dtype)
            nb = math.prod(shape) * torch.empty((), dtype=dt).element_size()
            # a copy: the slice's offset need not be aligned for ``dt``
            out[key] = buf[off:off + nb].clone().view(dt).view(shape)
            off += nb
        return out

    def _broadcast_tensor(self, x, root: int, group, axes):
        def fn(t):
            t = t.clone()
            dist.broadcast(t, root, group=group)
            return t
        return self._collective(x, fn, "broadcast", axes)

    def _global_rank(self, index: int, axis: Optional[str]) -> int:
        """The world rank of the rank at ``index`` on ``axis`` through
        this rank (``index`` itself when ``axis`` is None)."""
        M = self.shape["model"]
        if axis is None:
            return int(index)
        if axis == "model":
            return self.data_index * M + int(index)
        return int(index) * M + self.model_index

    def all_gather(self, x, axis: str, dim: int = 0):
        """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in
        ascending axis index (the reference's ``all_gather(...,
        tiled=True)``)."""
        group, n = self._group_of((axis,))
        if n == 1:
            return x

        def fn(t):
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts, dim)
        return self._collective(x, fn, "all_gather", (axis,))

    def all_reduce(self, x, axes, op: str = "sum"):
        """``x`` reduced (``"sum"`` or ``"max"``) over the ranks of
        ``axes`` (one axis name or a tuple); a new tensor."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        group, n = self._group_of(axes)
        if n == 1:
            return x

        def fn(t):
            t = t.clone()
            dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
            return t
        return self._collective(x, fn, "all_reduce", axes)

    def close(self) -> None:
        """Tear down a process group this mesh initialised."""
        if self.transport == "fake" and self._owned_dir is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            self._owned_dir = None
        if self._owned_dir is not None:
            if dist.is_initialized():
                _leave()
            shutil.rmtree(self._owned_dir, ignore_errors=True)
            self._owned_dir = None

    def __repr__(self):
        return (f"HostMesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device}, transport={self.transport})")


class _Work:
    """The handle of a collective ``HostMesh`` issued: ``wait`` (once;
    later calls return at once) waits for it and, on gloo-staged,
    copies its host result to the card, adding the time to the mesh's
    ``comm``."""

    def __init__(self, mesh, work, staged=None):
        self._mesh, self._work, self._staged = mesh, work, staged

    def wait(self) -> None:
        if self._work is None:
            return
        t0 = time.perf_counter()
        self._work.wait()
        if self._staged is not None:
            result, host = self._staged
            result.copy_(host)
        self._work = self._staged = None
        self._mesh.comm["seconds"] += time.perf_counter() - t0


class _Done:
    """The handle of a collective that ran nothing."""

    def wait(self) -> None:
        return None


_DONE = _Done()


def make_fake_mesh(data: int, model: int = 1, *, rank: int = 0,
                   device="cpu") -> HostMesh:
    """Rank ``rank`` of a ``(data, model)`` mesh over torch's fake process
    group, in this process (no other rank runs): the world of
    ``data * model`` and the axis groups of ``axis_groups``, on the
    ``"fake"`` transport.  ``close()`` tears the group down; no other
    process group may be running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = int(data) * int(model)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if dist.is_initialized():
        raise ValueError("a process group is already running: a fake mesh "
                         "needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    return HostMesh(data, model, rank=rank, group=dist.group.WORLD,
                    device=device, transport="fake", owned_dir="fake",
                    groups=axis_groups(data, model, rank))


# the production meshes of the dry run: the reference's 256-chip pod, and
# its two pods, whose ("pod", "data") batch axes the port joins into one
# "data" axis of 32 (the reference's rules shard every batch axis over
# both jointly)
PRODUCTION_MESHES = {"pod16x16": (16, 16), "pod2x16x16": (32, 16)}

# One H100 SXM5 80GB (NVIDIA's data sheet, dense, at its 700 W limit):
# tensor-core bf16 / fp16, fp32 outside the tensor cores (the port keeps
# TF32 off, ``repro_torch.fp32_matmuls``), fp64; HBM3; NVLink 4 a
# direction within an 8-card node; one InfiniBand NDR port a card
# across nodes.
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12,
              "float32": 67e12, "float64": 34e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 50e9
CARDS_PER_NODE = 8


def compute_s(flops_by_dtype: dict) -> float:
    """Each dtype's FLOPs over that dtype's peak, summed (a dtype with
    no rate of its own, e.g. an integer, at fp32's)."""
    return sum(n / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
               for dt, n in flops_by_dtype.items())


def memory_s(nbytes: float) -> float:
    """Bytes over HBM."""
    return nbytes / HBM_BW


def axis_link(data: int, model: int, axis: str) -> float:
    """The bandwidth a card's collectives over ``axis`` (``"data"``,
    ``"model"`` or ``"world"``) of a ``(data, model)`` mesh get: NVLink
    where every group of the axis lies in one node of
    ``CARDS_PER_NODE`` consecutive ranks, else InfiniBand."""
    if axis == "model":
        groups = [[d * model + m for m in range(model)] for d in range(data)]
    elif axis == "data":
        groups = [[d * model + m for d in range(data)] for m in range(model)]
    else:
        groups = [list(range(data * model))]
    inside = all(len({r // CARDS_PER_NODE for r in g}) == 1 for g in groups)
    return NVLINK_BW if inside else IB_BW


def collective_s(bytes_by_axis: dict, data: int, model: int) -> float:
    """Each axis's collective bytes over the link its groups cross,
    summed."""
    return sum(n / axis_link(data, model, axis)
               for axis, n in bytes_by_axis.items())


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def transport_for(device, share_card: bool = False) -> str:
    """The transport of a rank on ``device``: ``share_card`` (several
    ranks on one card) stages CUDA payloads through gloo."""
    if not share_card:
        return backend_for(device)
    if torch.device(device).type != "cuda":
        raise ValueError("share_card is for ranks that share one CUDA "
                         "card; a CPU mesh runs gloo as it is")
    return "gloo-staged"


def axis_groups(data: int, model: int, rank: int) -> dict:
    """The sub-group of each axis through ``rank``: every rank creates
    every group, in the same order (``"model"`` rows, then ``"data"``
    columns), as ``dist.new_group`` requires.  An axis of size 1 has
    none; an axis that spans the world is the default group."""
    world = data * model
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    cols = [[d * model + m for d in range(data)] for m in range(model)]
    groups = {}
    for axis, sets, size in (("model", rows, model), ("data", cols, data)):
        if size == 1:
            groups[axis] = None
        elif size == world:
            groups[axis] = dist.group.WORLD
        else:
            for ranks in sets:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    return groups


def _indexed(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_group(rank: int, world: int, store_path: str, device,
               share_card: bool = False) -> None:
    """Initialise this process's default group from a ``FileStore``."""
    dev = _indexed(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    backend = "gloo" if share_card else backend_for(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)


def make_host_mesh(n_devices: int = 1, model: int = 1, *, device="cpu",
                   group=True, share_card: bool = False) -> HostMesh:
    """The mesh over the process group: the running group when there is
    one (its world size must be ``n_devices``; every rank calls this
    alike, since it creates the axis groups), else a new world of one
    (only ``n_devices == 1``).  ``group=False`` builds a sizes-only
    mesh.  ``share_card``: the ranks share one card (gloo-staged)."""
    if model < 1 or n_devices % model != 0:
        raise ValueError(
            f"model axis {model} must divide the device count "
            f"{n_devices}")
    data = n_devices // model
    transport = transport_for(device, share_card)
    if not group:
        return HostMesh(data, model, device=device, transport=transport)
    backend = "nccl" if transport == "nccl" else "gloo"
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != n_devices:
            raise ValueError(
                f"a mesh of {n_devices} devices in a process group of "
                f"{world}")
        if dist.get_backend() != backend:
            raise ValueError(
                f"the process group runs {dist.get_backend()}, the "
                f"{transport} transport needs {backend}")
        rank = dist.get_rank()
        return HostMesh(data, model, rank=rank, group=dist.group.WORLD,
                        device=device, transport=transport,
                        groups=axis_groups(data, model, rank))
    if n_devices != 1:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes: "
            f"start them with repro_torch.launch.mesh.spawn "
            f"(launch/train.py --devices {n_devices} does)")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh-")
    init_group(0, 1, os.path.join(tmp, "store"), device)
    return HostMesh(1, 1, rank=0, group=dist.group.WORLD, device=device,
                    owned_dir=tmp)


def _worker(rank, world, model, store_path, device, share_card, fn, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0) if share_card \
            else torch.device("cuda", rank)
    init_group(rank, world, store_path, dev, share_card)
    fn(make_host_mesh(world, model, device=dev, share_card=share_card),
       *args)
    _leave()


def _leave() -> None:
    """Tear the default group down while the process is whole: cyclic
    garbage that still holds it (a step's closures) is collected first,
    so the group is not destroyed during interpreter shutdown, and every
    rank leaves together."""
    gc.collect()
    if dist.get_world_size() > 1:
        dist.barrier()
    dist.destroy_process_group()


def spawn(fn, n: int, args=(), *, device="cpu", model: int = 1,
          share_card: bool = False, on_start=None,
          timeout: Optional[float] = None) -> None:
    """Run ``fn(mesh, *args)`` in ``n`` new processes, one a rank of an
    ``(n // model, model)`` mesh, and wait for them all; raises if one
    fails, and after ``timeout`` seconds kills them and raises
    ``TimeoutError``.  CUDA: rank r on card r, or with ``share_card``
    every rank on ``device``'s card (the gloo-staged transport).
    ``on_start(processes)`` runs once they have started (the train CLI
    forwards SIGTERM to them from there)."""
    import torch.multiprocessing as mp
    transport_for(device, share_card)            # validate before forking
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} must divide {n} ranks")
    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn-")
    deadline = None if timeout is None else time.monotonic() + timeout
    ctx = None
    try:
        ctx = mp.start_processes(
            _worker, args=(n, model, os.path.join(tmp, "store"),
                           str(device), share_card, fn, tuple(args)),
            nprocs=n, join=False, start_method="spawn")
        if on_start is not None:
            on_start(ctx.processes)
        while not ctx.join(timeout=None if deadline is None else 0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks still running after "
                                   f"{timeout} s")
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
