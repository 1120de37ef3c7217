"""Shared bundle construction for the five assigned LM architectures
(the reference's ``configs/lm_common.py``, less its XLA dry-run cells).

The four LM shapes of the assignment, as data ``(name, seq_len,
batch)``; ``long_500k`` runs only for a sliding-window arch, whose
ring-buffer cache holds ``min(seq_len, window)`` positions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchBundle
from repro_torch.models.lm import LMConfig, TransformerLM

TRAIN_4K = ("train_4k", 4096, 256)
PREFILL_32K = ("prefill_32k", 32768, 32)
DECODE_32K = ("decode_32k", 32768, 128)
LONG_500K = ("long_500k", 524288, 1)
SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


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
                      config=cfg)
