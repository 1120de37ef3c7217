"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (seconds to build; no PyTorch
headers), named by a hash of the sources and flags so an edited source
never loads a stale library.  The libraries go to ``build/kernels/`` at
the repository root, which ``.gitignore`` lists.  Nothing here runs at
import time.  The ctypes helpers at the end are shared by the kernels'
wrappers (``kernels/*/cuda.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("jpq_topk", "jpq_topk_pruned", "jpq_scores", "jpq_lookup",
           "embedding_bag")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME or PATH): the CUDA kernels are built "
        "from src/repro_torch/csrc at first use on a machine with the "
        "CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Raises with nvcc's
    output if any fails (after every compiler process has ended)."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log.decode()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


P, I = ctypes.c_void_p, ctypes.c_int   # pointer (and stream), int
_FNS: dict = {}


def fn(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """``fn_name`` of ``csrc/<lib_name>.cu`` with its ctypes signature."""
    key = (lib_name, fn_name)
    if key not in _FNS:
        f = getattr(load(lib_name), fn_name)
        f.argtypes, f.restype = argtypes, restype
        _FNS[key] = f
    return _FNS[key]


def check(t, what: str, dtypes, shape, device):
    """Raise unless ``t`` is a contiguous tensor on ``device`` with one
    of ``dtypes`` and exactly ``shape``."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{what} must be a tensor on {device}, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def code_bytes(codes, b: int) -> int:
    """Bytes per code the kernels read: uint8 codes address b <= 256."""
    if codes.dtype == torch.uint8:
        if b > 256:
            raise ValueError(f"uint8 codes address at most 256 centroids, "
                             f"b={b}")
        return 1
    return 4


def raise_on(rc: int, lib_name: str):
    """Raise for a launcher's return code: < 0 refused arguments, > 0 a
    CUDA error."""
    if rc == 0:
        return
    if rc < 0:
        raise ValueError(f"{lib_name}: the kernel refused its arguments "
                         f"(code {rc})")
    msg = fn(lib_name, "jpq_error_string", [I], ctypes.c_char_p)(rc)
    raise RuntimeError(f"{lib_name}: CUDA error {rc}: {msg.decode()}")


def stream(dev) -> int:
    """PyTorch's current stream on ``dev``, as the launchers take it (the
    raw pointer, without building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def launch(f, dev, *args) -> int:
    """``f(*args, stream)`` on ``dev``'s current stream, entering ``dev``
    only when it is not already the current device; returns ``f``'s
    code."""
    if dev.index == torch.cuda.current_device():
        return f(*args, stream(dev))
    with torch.cuda.device(dev):
        return f(*args, stream(dev))


_SMS: dict = {}


def sm_count(dev) -> int:
    """Streaming multiprocessors of the card ``dev`` (cached)."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]
