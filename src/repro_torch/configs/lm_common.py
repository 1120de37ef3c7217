"""Shared bundle construction for the five assigned LM architectures
(the reference's ``configs/lm_common.py``).

The four LM shapes of the assignment, as data ``(name, seq_len,
batch)``, and the dry-run cells over them (``lm_cells``): ``train_4k``
a train step, ``prefill_32k`` the prefill, ``decode_32k`` and
``long_500k`` one decode step over a ``seq_len``-position cache;
``long_500k`` runs only for a sliding-window arch, whose ring-buffer
cache holds ``min(seq_len, window)`` positions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ArchBundle, Cell, Spec, on_mesh,
                                      decode_builder, train_step_builder)
from repro_torch.models.lm import LMConfig, TransformerLM

TRAIN_4K = ("train_4k", 4096, 256)
PREFILL_32K = ("prefill_32k", 32768, 32)
DECODE_32K = ("decode_32k", 32768, 128)
LONG_500K = ("long_500k", 524288, 1)
SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def _cache_axes(caches):
    return {k: ("layers",) if v.dim() == 1 else
            ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            for k, v in caches.items()}


def _decode_state(batch: int, max_len: int):
    """state_fn(model, rows=batch): the bf16 caches of ``rows`` sequences
    (a rank's rows of the batch) over ``max_len`` positions, and their
    logical axes."""
    def state_fn(model, rows=batch):
        caches = model.init_caches(rows, max_len, torch.bfloat16)
        return caches, _cache_axes(caches)
    return state_fn


def _prefill_builder(model, mesh=None, rules=None):
    def fn(values, batch):
        with torch.no_grad():
            return model.prefill(values, batch["tokens"])
    return on_mesh(fn, mesh, rules)


def lm_cells(cfg: LMConfig) -> dict:
    """The reference's four LM cells of ``cfg``."""
    cells = {}
    name, S, B = TRAIN_4K
    cells[name] = Cell(
        shape_name=name, kind="train",
        specs={"tokens": Spec((B, S), torch.int32, ("batch", "seq")),
               "targets": Spec((B, S), torch.int32, ("batch", "seq"))},
        build=train_step_builder)
    name, S, B = PREFILL_32K
    cells[name] = Cell(
        shape_name=name, kind="serve",
        specs={"tokens": Spec((B, S), torch.int32, ("batch", "seq"))},
        build=_prefill_builder)
    for name, S, B in (DECODE_32K, LONG_500K):
        skip = None
        if name == "long_500k" and cfg.window is None:
            skip = ("pure full-attention arch: 500k-context decode is "
                    "excluded per assignment (needs sub-quadratic "
                    "attention); see DESIGN.md §Arch-applicability")
        cells[name] = Cell(
            shape_name=name, kind="decode",
            specs={"token": Spec((B, 1), torch.int32, ("batch", "seq"))},
            build=decode_builder, state_fn=_decode_state(B, S), skip=skip,
            note=(f"KV ring buffer = min({S}, window={cfg.window})"
                  if cfg.window else ""))
    return cells


def smoke_batch(cfg: LMConfig) -> dict:
    """The reference's smoke batch: ``default_rng(0)``, B 2, S 16,
    tokens then targets uniform over the vocabulary."""
    r = np.random.default_rng(0)
    B, S = 2, 16
    return {"tokens": r.integers(0, cfg.vocab, (B, S)),
            "targets": r.integers(0, cfg.vocab, (B, S))}


def make_lm_bundle(name: str, cfg: LMConfig, smoke_cfg: LMConfig,
                   description: str = "") -> ArchBundle:
    """``make_model(device, seed, **changes)`` builds the published
    config (``changes`` replace its fields, e.g. a cut ``n_layers``);
    ``make_smoke(device, seed)`` the smoke model and its batch."""
    def _gen(device, seed):
        dev = resolve_device(device)
        return dev, torch.Generator(device=dev).manual_seed(int(seed))

    def make_model(device="cuda", seed: int = 0, **changes):
        dev, gen = _gen(device, seed)
        return TransformerLM(dataclasses.replace(cfg, **changes),
                             generator=gen, device=dev)

    def make_smoke(device="cuda", seed: int = 0):
        dev, gen = _gen(device, seed)
        return (TransformerLM(smoke_cfg, generator=gen, device=dev),
                smoke_batch(smoke_cfg))

    return ArchBundle(name=name, family="lm", make_model=make_model,
                      make_smoke=make_smoke, description=description,
                      config=cfg, cells=lm_cells(cfg))
