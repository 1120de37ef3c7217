"""Checkpoints in the reference's on-disk format, so either package
restores the other's.

  * one directory a step: ``<dir>/step_0000001230/``;
  * the arrays in one ``arrays.npz`` keyed by the tree paths joined by
    ``/`` (``values/item_emb/centroids``, ``opt/m/blocks/0/ln1/scale``,
    ``opt/step``, ``early_stop/best``), plus ``manifest.json`` (step,
    keys, user metadata);
  * an atomic commit: written into a ``.tmp-*`` directory, then
    ``os.replace`` — a crash mid-save never corrupts the latest step;
  * keep-N garbage collection;
  * ``AsyncCheckpointer``: the copy to the host is synchronous, the disk
    write runs on a worker thread; ``wait()`` drains it and raises a
    failed write once.

Trees are nested dicts and lists; leaves are tensors (on any device),
numpy arrays or Python scalars.  bfloat16 leaves are stored as raw
2-byte records (numpy's ``V2``), as the reference's npz holds them.
``restore_checkpoint`` puts each tensor leaf on the device and dtype of
the matching leaf of the target tree.  On a ``"model"`` mesh the Trainer
gathers every split leaf (and its moments) before rank 0 writes, so the
files hold whole leaves, and cuts each rank's blocks after a restore.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

_SEP = "/"


def _host(leaf, copy: bool) -> np.ndarray:
    """A leaf as a numpy array on the host; a tensor is always copied
    (training updates it in place), an array only when ``copy``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _items(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}{_SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}{_SEP}")
    else:
        yield prefix[:-len(_SEP)], tree


def flatten(tree, *, copy: bool = True) -> dict:
    """{``/``-joined path: numpy array} of a tree, copied to the host."""
    return {k: _host(v, copy) for k, v in _items(tree)}


def save_checkpoint(directory: str, tree, step: int, *, keep: int = 3,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = flatten(tree, copy=False)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=directory)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "keys": sorted(flat.keys()),
                    "metadata": metadata or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(_all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def _all_steps(directory: str):
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step (one with a manifest), or None."""
    if not os.path.isdir(directory):
        return None
    steps = _all_steps(directory)
    return max(steps) if steps else None


def checkpoint_metadata(directory: str,
                        step: Optional[int] = None) -> dict:
    """The user metadata stamped into a checkpoint's manifest at save
    time; ``step=None`` reads the latest.  A missing directory or step,
    or a manifest without metadata, gives ``{}``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return {}
    path = os.path.join(directory, f"step_{step:010d}", "manifest.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        manifest = json.load(f)
    return manifest.get("metadata") or {}


def _as_like(arr: np.ndarray, ref, key: str):
    """``arr`` shaped, typed and placed as the target leaf ``ref``."""
    shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"checkpoint key {key!r} has shape {arr.shape}, expected "
            f"{shape} — was the run restarted with a different model "
            f"config?")
    if isinstance(ref, torch.Tensor):
        if ref.dtype == torch.bfloat16:
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(arr, np.float32)).to(
                    torch.bfloat16)
        else:
            want = torch.empty((), dtype=ref.dtype).numpy().dtype
            t = torch.from_numpy(np.array(arr, dtype=want, copy=True))
        return t.to(ref.device)
    if isinstance(ref, (bool, int, float)):
        return type(ref)(arr.item())
    ref_dt = np.asarray(ref).dtype
    if arr.dtype != ref_dt:
        if arr.dtype.kind == "V" and arr.dtype.itemsize == ref_dt.itemsize:
            return arr.view(ref_dt)
        return arr.astype(ref_dt)
    return arr


def _rebuild(like, flat: dict, strict: bool, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, strict, f"{prefix}{k}{_SEP}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, strict, f"{prefix}{i}{_SEP}")
                          for i, v in enumerate(like))
    key = prefix[:-len(_SEP)]
    if key not in flat:
        if not strict:
            return like
        raise KeyError(f"checkpoint missing key {key!r}")
    return _as_like(flat[key], like, key)


def restore_checkpoint(directory: str, like, *, step: Optional[int] = None,
                       strict: bool = True):
    """Restore into the structure of ``like``: each leaf takes the shape,
    dtype and (for a tensor) device of ``like``'s leaf at the same path.
    ``strict=False`` keeps ``like``'s leaf for a key the checkpoint
    lacks instead of raising ``KeyError``; a shape mismatch always
    raises.  Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _rebuild(like, flat, strict), step


def restore_values(directory: str, params, *,
                   step: Optional[int] = None) -> int:
    """Copy a checkpoint's parameters into the tensors of ``params`` in
    place (on their device); returns the step.  A Trainer's checkpoint
    holds them under ``values/``; a checkpoint of the values tree alone
    (what the reference's serve CLI restores) holds them at the top."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}", "manifest.json")
    with open(path) as f:
        nested = any(k.startswith("values" + _SEP)
                     for k in json.load(f)["keys"])
    state, _ = restore_checkpoint(
        directory, {"values": params} if nested else params, step=step)
    src = state["values"] if nested else state
    with torch.no_grad():
        for dst, new in zip(_items(params), _items(src)):
            dst[1].copy_(new[1])
    return step


class AsyncCheckpointer:
    """Background-thread writer with atomic commits.  ``save`` first
    waits for the write in flight, then copies the tree to the host
    before it returns, so the caller may update the tensors at once."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, tree, step: int, metadata: Optional[dict] = None):
        self.wait()
        host = flatten(tree)            # the host copy; the IO is async

        def _run():
            try:
                save_checkpoint(self.directory, host, step,
                                keep=self.keep, metadata=metadata)
            except BaseException as e:  # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the write in flight; raise its error, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
