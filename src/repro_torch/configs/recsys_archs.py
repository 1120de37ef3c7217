"""Recsys arch bundles (the two-tower retrieval model for now).

The full config is the reference's large-catalogue regime: 1,000,000
items (1,000,448 padded rows), embed_dim 256, user tower
(1024, 512, 256), hist_len 50, RecJPQ with m=8, b=256 for the ``-jpq``
variant.  Weights are random, drawn from a seeded generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchBundle
from repro_torch.core import EmbeddingConfig
from repro_torch.models.recsys import TwoTower, TwoTowerConfig

N_CANDIDATES = 1_000_000
JPQ = EmbeddingConfig(0, 0, kind="jpq", m=8, b=256)
FULLE = EmbeddingConfig(0, 0, kind="full")


def two_tower_bundle(kind: str = "full") -> ArchBundle:
    emb = JPQ if kind == "jpq" else FULLE
    cfg = TwoTowerConfig(n_items=N_CANDIDATES, embed_dim=256,
                         tower_mlp=(1024, 512, 256), hist_len=50,
                         embedding=emb, negatives="local")

    def _gen(device, seed):
        dev = resolve_device(device)
        return dev, torch.Generator(device=dev).manual_seed(int(seed))

    def make_model(device="cuda", seed: int = 0):
        dev, gen = _gen(device, seed)
        return TwoTower(cfg, generator=gen, device=dev)

    def make_smoke(device="cuda", seed: int = 0):
        scfg = TwoTowerConfig(n_items=200, embed_dim=32,
                              tower_mlp=(64, 32), hist_len=8,
                              embedding=dataclasses.replace(emb, m=4, b=16))
        # the reference's smoke template, draw for draw
        r = np.random.default_rng(0)
        batch = {"user_hist": r.integers(0, 201, (4, 8)),
                 "pos_item": r.integers(1, 201, (4,)),
                 "logq": np.zeros(4, np.float32)}
        dev, gen = _gen(device, seed)
        return TwoTower(scfg, generator=gen, device=dev), batch

    suffix = "-jpq" if kind == "jpq" else ""
    return ArchBundle(f"two-tower-retrieval{suffix}", "recsys", make_model,
                      make_smoke,
                      f"sampled-softmax retrieval, item table [{kind}]")
