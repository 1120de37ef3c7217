"""Recsys arch bundles: two-tower retrieval, FM, DLRM-RM2 and DIEN, each
as ``<arch>`` (full tables, the paper's Base) and ``<arch>-jpq`` (RecJPQ
tables, m=8, b=256 by default).

The full configs are the reference's (``configs/recsys_archs.py``):
  two-tower : 1,000,000 items (1,000,448 padded rows), embed_dim 256,
              user tower (1024, 512, 256), hist_len 50
  fm        : 39 fields (``FM_VOCABS``, 3,090,000 rows), embed_dim 10;
              m=5 for -jpq (10 is not divisible by 8)
  dlrm-rm2  : 13 dense + 26 sparse fields (``DLRM_VOCABS``, 223,220,000
              rows: 57.1 GB as a full fp32 table), embed_dim 64, bottom
              MLP (512, 256, 64), top MLP (512, 512, 256, 1)
  dien      : 1,000,000 items, embed_dim 18, seq_len 100, gru_dim 108,
              MLP (200, 80); m=6 for -jpq
Weights are random, drawn from a seeded generator on the device.
``make_smoke`` builds the reference's smoke config and its request
template, draw for draw.

Each bundle's four dry-run cells are the reference's: train_batch
(B=65,536 training step), serve_p99 (B=512 online), serve_bulk
(B=262,144 offline scoring), retrieval_cand (1 context vs 1,000,000
candidates).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ArchBundle, Cell, Spec, serve_builder,
                                      train_step_builder)
from repro_torch.core import EmbeddingConfig
from repro_torch.models.recsys import (DIEN, DIENConfig, DLRM, DLRMConfig, FM,
                                       FMConfig, TwoTower, TwoTowerConfig)

N_CANDIDATES = 1_000_000
JPQ = EmbeddingConfig(0, 0, kind="jpq", m=8, b=256)
FULLE = EmbeddingConfig(0, 0, kind="full")


def _gen(device, seed):
    dev = resolve_device(device)
    return dev, torch.Generator(device=dev).manual_seed(int(seed))


I32, F32 = torch.int32, torch.float32


def _bundle(name, kind, cls, cfg, smoke_cfg, smoke_batch, description,
            cells):
    """An ``ArchBundle`` whose models are ``cls(cfg)`` (full width) and
    ``cls(smoke_cfg)`` with the template ``smoke_batch()``."""
    def make_model(device="cuda", seed: int = 0):
        dev, gen = _gen(device, seed)
        return cls(cfg, generator=gen, device=dev)

    def make_smoke(device="cuda", seed: int = 0):
        batch = smoke_batch()
        dev, gen = _gen(device, seed)
        return cls(smoke_cfg, generator=gen, device=dev), batch

    suffix = "-jpq" if kind == "jpq" else ""
    return ArchBundle(f"{name}{suffix}", "recsys", make_model, make_smoke,
                      f"{description} [{kind}]", cells=cells)


def _smoke_emb(emb, kind):
    return dataclasses.replace(emb, m=4, b=16) if kind == "jpq" else None


def two_tower_bundle(kind: str = "full") -> ArchBundle:
    emb = JPQ if kind == "jpq" else FULLE
    cfg = TwoTowerConfig(n_items=N_CANDIDATES, embed_dim=256,
                         tower_mlp=(1024, 512, 256), hist_len=50,
                         embedding=emb, negatives="local")
    scfg = TwoTowerConfig(n_items=200, embed_dim=32, tower_mlp=(64, 32),
                          hist_len=8,
                          embedding=dataclasses.replace(emb, m=4, b=16))

    def smoke_batch():
        r = np.random.default_rng(0)
        return {"user_hist": r.integers(0, 201, (4, 8)),
                "pos_item": r.integers(1, 201, (4,)),
                "logq": np.zeros(4, np.float32)}

    def hist_spec(B):
        return Spec((B, cfg.hist_len), I32, ("batch", "seq"))

    cells = {
        "train_batch": Cell(
            "train_batch", "train",
            {"user_hist": hist_spec(65536),
             "pos_item": Spec((65536,), I32, ("batch",)),
             "logq": Spec((65536,), F32, ("batch",))},
            train_step_builder),
        "serve_p99": Cell("serve_p99", "serve",
                          {"user_hist": hist_spec(512)},
                          serve_builder("retrieve")),
        "serve_bulk": Cell("serve_bulk", "serve",
                           {"user_hist": hist_spec(262144)},
                           serve_builder("bulk_retrieve")),
        "retrieval_cand": Cell(
            "retrieval_cand", "serve", {"user_hist": hist_spec(1)},
            serve_builder("retrieve"),
            note="1 query vs 1M candidates through emb.logits "
                 "(JPQ partial-score path when kind=jpq)"),
    }
    return _bundle("two-tower-retrieval", kind, TwoTower, cfg, scfg,
                   smoke_batch, "sampled-softmax retrieval, item table",
                   cells)


FM_VOCABS = [N_CANDIDATES] + [100_000] * 19 + [10_000] * 19


def fm_bundle(kind: str = "full") -> ArchBundle:
    emb = JPQ if kind == "jpq" else FULLE
    # embed_dim 10 isn't divisible by m=8 -> m=5 for the JPQ variant
    emb = dataclasses.replace(emb, m=5) if kind == "jpq" else emb
    cfg = FMConfig(n_fields=39, vocab_sizes=FM_VOCABS, embed_dim=10,
                   embedding=emb)
    scfg = FMConfig(n_fields=6, vocab_sizes=[64] * 6, embed_dim=8,
                    embedding=_smoke_emb(emb, kind))

    def smoke_batch():
        r = np.random.default_rng(0)
        return {"sparse": r.integers(0, 64, (8, 6)),
                "label": r.integers(0, 2, (8,))}

    def batch_specs(B):
        return {"sparse": Spec((B, 39), I32, ("batch", None)),
                "label": Spec((B,), I32, ("batch",))}

    cells = {
        "train_batch": Cell("train_batch", "train", batch_specs(65536),
                            train_step_builder),
        "serve_p99": Cell("serve_p99", "serve",
                          {"sparse": Spec((512, 39), I32, ("batch", None))},
                          serve_builder("serve")),
        "serve_bulk": Cell("serve_bulk", "serve",
                           {"sparse": Spec((262144, 39), I32,
                                           ("batch", None))},
                           serve_builder("serve")),
        "retrieval_cand": Cell(
            "retrieval_cand", "serve",
            {"sparse_rest": Spec((1, 38), I32, ("batch", None))},
            serve_builder("candidate_scores"),
            note="factorised full-catalogue scoring via emb.logits"),
    }
    return _bundle("fm", kind, FM, cfg, scfg, smoke_batch,
                   "factorisation machine", cells)


DLRM_VOCABS = [N_CANDIDATES if i == 0 else
               [40_000_000, 4_000_000, 400_000, 40_000, 4_000][i % 5]
               for i in range(26)]


def dlrm_bundle(kind: str = "full") -> ArchBundle:
    emb = JPQ if kind == "jpq" else FULLE
    cfg = DLRMConfig(n_dense=13, n_sparse=26, embed_dim=64,
                     bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
                     vocab_sizes=DLRM_VOCABS, embedding=emb)
    scfg = DLRMConfig(n_dense=5, n_sparse=4, embed_dim=16, bot_mlp=(32, 16),
                      top_mlp=(32, 1), vocab_sizes=[128, 64, 64, 32],
                      embedding=_smoke_emb(emb, kind))

    def smoke_batch():
        r = np.random.default_rng(0)
        return {"dense": r.standard_normal((8, 5)).astype(np.float32),
                "sparse": r.integers(0, 32, (8, 4)),
                "label": r.integers(0, 2, (8,))}

    def batch_specs(B, label=True):
        d = {"dense": Spec((B, 13), F32, ("batch", None)),
             "sparse": Spec((B, 26), I32, ("batch", None))}
        if label:
            d["label"] = Spec((B,), I32, ("batch",))
        return d

    cells = {
        "train_batch": Cell("train_batch", "train", batch_specs(65536),
                            train_step_builder),
        "serve_p99": Cell("serve_p99", "serve", batch_specs(512, False),
                          serve_builder("serve")),
        "serve_bulk": Cell("serve_bulk", "serve",
                           batch_specs(262144, False),
                           serve_builder("serve")),
        "retrieval_cand": Cell(
            "retrieval_cand", "serve",
            {"dense": Spec((1, 13), F32, ("batch", None)),
             "sparse_rest": Spec((1, 25), I32, ("batch", None)),
             "candidates": Spec((N_CANDIDATES,), I32, ("items",))},
            serve_builder("score_candidates"),
            note="chunked lax.map over 1M candidates (non-factorisable "
                 "top-MLP)"),
    }
    return _bundle("dlrm-rm2", kind, DLRM, cfg, scfg, smoke_batch,
                   "DLRM dot-interaction CTR", cells)


def dien_bundle(kind: str = "full") -> ArchBundle:
    emb = JPQ if kind == "jpq" else FULLE
    # embed_dim 18: m must divide -> m=6 for the JPQ variant
    emb = dataclasses.replace(emb, m=6) if kind == "jpq" else emb
    cfg = DIENConfig(n_items=N_CANDIDATES, embed_dim=18, seq_len=100,
                     gru_dim=108, mlp=(200, 80), embedding=emb)
    scfg = DIENConfig(n_items=100, embed_dim=8, seq_len=10, gru_dim=12,
                      mlp=(16, 8), embedding=_smoke_emb(emb, kind))

    def smoke_batch():
        r = np.random.default_rng(0)
        return {"hist": r.integers(0, 101, (4, 10)),
                "hist_neg": r.integers(1, 101, (4, 10)),
                "target": r.integers(1, 101, (4,)),
                "label": r.integers(0, 2, (4,))}

    S = cfg.seq_len

    def batch_specs(B, train=True):
        d = {"hist": Spec((B, S), I32, ("batch", "seq")),
             "target": Spec((B,), I32, ("batch",))}
        if train:
            d["label"] = Spec((B,), I32, ("batch",))
            d["hist_neg"] = Spec((B, S), I32, ("batch", "seq"))
        return d

    cells = {
        "train_batch": Cell("train_batch", "train", batch_specs(65536),
                            train_step_builder),
        "serve_p99": Cell("serve_p99", "serve", batch_specs(512, False),
                          serve_builder("serve")),
        "serve_bulk": Cell("serve_bulk", "serve",
                           batch_specs(262144, False),
                           serve_builder("serve")),
        "retrieval_cand": Cell(
            "retrieval_cand", "serve",
            {"hist": Spec((1, S), I32, ("batch", "seq")),
             "candidates": Spec((N_CANDIDATES,), I32, ("items",))},
            serve_builder("score_candidates"),
            note="interest GRU once, AUGRU per candidate chunk"),
    }
    return _bundle("dien", kind, DIEN, cfg, scfg, smoke_batch,
                   "interest-evolution CTR", cells)
