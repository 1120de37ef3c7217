"""The data-parallel mesh over ``torch.distributed``.

``HostMesh`` is the port's counterpart of the reference's host mesh
(``repro.launch.mesh.make_host_mesh``): axis names ``("data",
"model")``, their sizes, and this process's rank in the process group
that carries the collectives (gloo for CPU tensors, NCCL for CUDA
ones).  A mesh built from sizes alone (``group=False``) has no group and
serves the layout arithmetic (``dist.compression.payload_bytes``,
``TrainSpec.resolve_accum``) only.

The group is initialised from a ``FileStore`` in a temporary directory,
so nothing needs a network.  ``make_host_mesh`` makes a world of one in
the calling process; a world of N runs N processes, which ``spawn``
starts (``launch/train.py --devices N`` on the CPU).
"""
from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")


class HostMesh:
    """A ``(data, model)`` mesh: ``shape`` maps axis name to size,
    ``rank`` is this process's index on the data axis."""

    def __init__(self, data: int, model: int = 1, *, rank: int = 0,
                 group=None, device="cpu", owned_dir: Optional[str] = None):
        if model != 1:
            from repro_torch.dist import NEXT_SLICE
            raise NotImplementedError(NEXT_SLICE)
        self.shape = {"data": int(data), "model": int(model)}
        self.axis_names = AXES
        self.rank = int(rank)
        self.group = group
        self.device = _indexed(device)
        self._owned_dir = owned_dir

    @property
    def world_size(self) -> int:
        return self.shape["data"]

    def close(self) -> None:
        """Tear down a process group this mesh initialised."""
        if self._owned_dir is not None:
            if dist.is_initialized():
                _leave()
            shutil.rmtree(self._owned_dir, ignore_errors=True)
            self._owned_dir = None

    def __repr__(self):
        return (f"HostMesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device})")


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _indexed(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_group(rank: int, world: int, store_path: str, device) -> None:
    """Initialise this process's default group from a ``FileStore``."""
    dev = _indexed(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend_for(dev), store=store, rank=rank,
                            world_size=world, **kw)


def make_host_mesh(n_devices: int = 1, model: int = 1, *, device="cpu",
                   group=True) -> HostMesh:
    """The mesh over the process group: the running group when there is
    one (its world size must be ``n_devices``), else a new world of one
    (only ``n_devices == 1``).  ``group=False`` builds a sizes-only
    mesh."""
    if model < 1 or n_devices % model != 0:
        raise ValueError(
            f"model axis {model} must divide the device count "
            f"{n_devices}")
    data = n_devices // model
    if model != 1:
        from repro_torch.dist import NEXT_SLICE
        raise NotImplementedError(NEXT_SLICE)
    if not group:
        return HostMesh(data, model, device=device)
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != n_devices:
            raise ValueError(
                f"a mesh of {n_devices} devices in a process group of "
                f"{world}")
        if dist.get_backend() != backend_for(device):
            raise ValueError(
                f"the process group runs {dist.get_backend()}, a "
                f"{torch.device(device).type} mesh needs "
                f"{backend_for(device)}")
        return HostMesh(data, model, rank=dist.get_rank(),
                        group=dist.group.WORLD, device=device)
    if n_devices != 1:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes: "
            f"start them with repro_torch.launch.mesh.spawn "
            f"(launch/train.py --devices {n_devices} does)")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh-")
    init_group(0, 1, os.path.join(tmp, "store"), device)
    return HostMesh(1, 1, rank=0, group=dist.group.WORLD, device=device,
                    owned_dir=tmp)


def _worker(rank, world, store_path, device, fn, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    init_group(rank, world, store_path, dev)
    fn(HostMesh(world, 1, rank=rank, group=dist.group.WORLD, device=dev),
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


def spawn(fn, n: int, args=(), *, device="cpu", on_start=None,
          timeout: Optional[float] = None) -> None:
    """Run ``fn(mesh, *args)`` in ``n`` new processes, one a rank of a
    mesh of ``n`` (CUDA: rank r on card r), and wait for them all;
    raises if one fails, and after ``timeout`` seconds kills them and
    raises ``TimeoutError``.  ``on_start(processes)`` runs once they
    have started (the train CLI forwards SIGTERM to them from there)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn-")
    deadline = None if timeout is None else time.monotonic() + timeout
    ctx = None
    try:
        ctx = mp.start_processes(
            _worker, args=(n, os.path.join(tmp, "store"), str(device), fn,
                           tuple(args)),
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
