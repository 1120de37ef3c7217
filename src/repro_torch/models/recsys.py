"""RecSys architectures: two-tower retrieval, FM, DLRM-RM2, DIEN.

Every sparse id table goes through ``repro_torch.core``'s embedding
factory, so RecJPQ is a per-table config switch.  Two-tower serving
scores the whole catalogue (fused score + top-k over the codes for
``kind="jpq"``: the PQTopK kernels on the card).  The fixed-fanout
pooled lookups — the full-table two-tower user tower
(``core/sharded.pooled_lookup``) and FM's linear term — run through the
hand-written embedding_bag kernel on the card.

Each model is an ``nn.Module`` whose parameters are drawn from a
``torch.Generator`` on its device (``init_params``, which the
constructor calls and ``Trainer`` may call again); ``params()`` returns
the tree of tensors in the reference's shape, which the functional
methods take as the reference's methods take its params.  Its float
leaves are detached views of the parameters, so serving builds no
autograd graph; ``Trainer`` makes them require a gradient for its run
(and trains the parameters through them, in place), and the pooled
lookups carry the gradient through the embedding_bag backward kernel.
``train_loss(p, batch, rng=None)`` is each reference model's, with its
metric keys.

Batch layouts (fixed shapes):
  two-tower : user_hist [B, H] item ids (0 pad), pos_item [B], logq [B]
              (training)
  fm/dlrm   : dense [B, 13] (DLRM), sparse ids [B, n_fields] (one id
              per field), label [B] (training)
  dien      : hist [B, S] (0 pad), target [B]; hist_neg [B, S] and
              label [B] (training)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import EmbeddingConfig, make_embedding
from repro_torch.kernels.embedding_bag import ops as _bag
from repro_torch.nn import layers as L
from repro_torch.nn.module import Tensors
from repro_torch.nn.recurrent import gru_init, gru_scan


def _mlp_modules(mlp) -> torch.nn.ModuleList:
    return torch.nn.ModuleList(Tensors(lp) for lp in mlp["layers"])


def _mlp_tree(mods) -> dict:
    return {"layers": [m.tensors() for m in mods]}


def _drop(module, *names):
    """Remove the named parameter holders (before they are drawn again,
    so an old table is freed before its successor is made)."""
    for name in names:
        if name in module._modules:
            delattr(module, name)


def _bce(logit, y):
    return -(y * F.logsigmoid(logit) + (1.0 - y) * F.logsigmoid(-logit))


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    n_items: int = 1_000_000
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    hist_len: int = 50
    embedding: Optional[EmbeddingConfig] = None
    logq_correction: bool = True
    negatives: str = "global"          # global | local (training)

    def emb_cfg(self) -> EmbeddingConfig:
        base = self.embedding or EmbeddingConfig(n_items=0, d=0)
        # row count padded as the reference pads it (to 512 rows)
        n_rows = (self.n_items + 1 + 511) // 512 * 512
        return dataclasses.replace(base, n_items=n_rows,
                                   d=self.embed_dim)


class TwoTower(torch.nn.Module):
    """Sampled-softmax two-tower retrieval.  Parameters are drawn from
    ``generator`` (on ``device``): the item table first, then the user
    tower, in the reference's order.  ``params()`` returns the
    reference-shaped tree ``{"item_emb": {...}, "user_mlp": {"layers":
    [{"w", "b"}, ...]}}`` of (detached) tensors that the functional
    methods take, as the reference's methods take its params."""

    def __init__(self, cfg: TwoTowerConfig, *, generator: torch.Generator,
                 codes=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.emb = make_embedding(cfg.emb_cfg())
        self._codes = codes
        self.init_params(generator)

    def init_params(self, generator: torch.Generator) -> dict:
        """(Re)draw every parameter from ``generator`` (on the model's
        device) in the reference's order; returns ``params()``."""
        cfg, dev = self.cfg, generator.device
        _drop(self, "item_emb", "user_mlp")
        self.item_emb = Tensors(self.emb.init(generator, codes=self._codes,
                                               device=dev))
        dims = [cfg.embed_dim, *cfg.tower_mlp, cfg.embed_dim]
        self.user_mlp = _mlp_modules(L.mlp_init(generator, dims, device=dev))
        return self.params()

    @property
    def device(self) -> torch.device:
        return next(self.item_emb.parameters()).device

    def params(self) -> dict:
        return {"item_emb": self.item_emb.tensors(),
                "user_mlp": _mlp_tree(self.user_mlp)}

    def forward(self, user_hist):
        return self.user_vec(self.params(), user_hist)

    def user_vec(self, p, user_hist):
        user_hist = torch.as_tensor(user_hist, device=self.device)
        mask = (user_hist > 0).float()
        if self.cfg.emb_cfg().kind == "full":
            from repro_torch.core import sharded
            pooled = sharded.pooled_lookup(p["item_emb"]["table"],
                                           user_hist, mask)
        else:
            e = self.emb.lookup(p["item_emb"], user_hist)    # [B, H, d]
            pooled = torch.sum(e * mask[..., None], 1)
        pooled = pooled / torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        return L.mlp(p["user_mlp"], pooled)                  # [B, d]

    def train_loss(self, p, batch, rng=None):
        """In-batch sampled softmax over the B positives, with the logQ
        correction when the batch has ``logq``; on one device the
        reference's ``negatives="local"`` groups are one group (its
        ``dist.data_shard_count()`` is 1 off a mesh).  Returns (loss,
        {"loss", "in_batch_acc"})."""
        del rng
        cfg = self.cfg
        u = self.user_vec(p, batch["user_hist"])            # [B, d]
        pos = torch.as_tensor(batch["pos_item"], device=self.device)
        v = self.emb.lookup(p["item_emb"], pos)
        B = u.shape[0]
        G = 1
        b = B // G
        logits = torch.bmm(u.reshape(G, b, -1),
                           v.reshape(G, b, -1).transpose(1, 2))  # in-batch
        if cfg.logq_correction and "logq" in batch:
            logq = torch.as_tensor(batch["logq"], device=self.device)
            logits = logits - logq.reshape(G, 1, b)
        lse = torch.logsumexp(logits, -1)                   # [G, b]
        picked = torch.diagonal(logits, dim1=1, dim2=2)     # [G, b]
        loss = torch.mean(lse - picked)
        acc = torch.mean((torch.argmax(logits, -1) == torch.arange(
            b, device=self.device)[None, :]).float())
        return loss, {"loss": loss, "in_batch_acc": acc}

    def bind_engine(self, p, spec, *, catalogue=None):
        """Bind a ``core.engine.RetrievalSpec`` to this model + params:
        a ``BoundRetrieval`` mapping a request (a batch dict with
        ``user_hist``, or a raw [B, H] history) through the user tower
        into the engine's scorer."""
        from repro_torch.core import engine as _engine
        eng = _engine.RetrievalEngine(spec, self.emb, p["item_emb"],
                                      catalogue=catalogue)

        def encode(batch):
            hist = batch["user_hist"] if isinstance(batch, dict) else batch
            return self.user_vec(p, hist)

        return _engine.BoundRetrieval(eng, encode)

    def retrieve(self, p, batch, *, top_k: int = 100, fused: bool = True,
                 prune=None, perm=None, warm=None,
                 return_stats: bool = False):
        """Score user(s) against the full catalogue; returns the top-k
        (values, ids) (+ the pruning-stats dict when ``return_stats``).
        A wrapper over ``bind_engine`` with the reference's kwargs."""
        from repro_torch.core import engine as _engine
        spec = _engine.spec_for(self.emb, k=top_k, fused=fused,
                                prune=prune, perm=perm,
                                warm_decay=0.0 if warm is not None
                                else None,
                                stats=return_stats)
        bound = self.bind_engine(p, spec)
        if spec.prune:
            bound.engine.bind_catalogue(prune=prune, perm=perm)
        if warm is not None:
            warm = torch.as_tensor(warm, dtype=torch.float32,
                                   device=self.device)
        return bound.retrieve(batch, floor=warm)

    def bulk_retrieve(self, p, batch, *, top_k: int = 100,
                      chunk: int = 2048):
        """Offline scoring of many users, ``chunk`` users at a time so
        [B, n_items] never materialises."""
        from repro_torch.core import sharded
        hist = torch.as_tensor(batch["user_hist"], device=self.device)
        vals, idx = [], []
        for s in range(0, hist.shape[0], chunk):
            u = self.user_vec(p, hist[s:s + chunk])
            v, i = sharded.topk_over_items(
                self.emb.logits(p["item_emb"], u), top_k)
            vals.append(v)
            idx.append(i)
        return torch.cat(vals), torch.cat(idx)


# ===================================================================== FM

@dataclasses.dataclass(frozen=True)
class FMConfig:
    n_fields: int = 39
    vocab_sizes: Optional[Sequence[int]] = None     # default: 1e4 each
    embed_dim: int = 10
    embedding: Optional[EmbeddingConfig] = None

    def vocabs(self):
        return list(self.vocab_sizes) if self.vocab_sizes else \
            [10_000] * self.n_fields


def _offsets(vocabs, device) -> torch.Tensor:
    """Row offset of each field in the shared mega-table."""
    off = np.zeros(len(vocabs), np.int64)
    off[1:] = np.cumsum(vocabs)[:-1]
    return torch.as_tensor(off, device=device)


class FM(torch.nn.Module):
    """Factorisation Machine (Rendle ICDM'10), 2-way interactions via the
    O(nk) sum-square trick.  One shared "mega-table" with per-field row
    offsets -> one embedding object, JPQ-able.  The linear term is a
    fixed-fanout bag over the ``[V, 1]`` view of ``linear`` (the
    embedding_bag kernel on the card).  Parameters are drawn in the
    reference's order: the table, then ``linear``; ``bias`` is zero."""

    def __init__(self, cfg: FMConfig, *, generator: torch.Generator,
                 codes=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        vocabs = cfg.vocabs()
        base = cfg.embedding or EmbeddingConfig(n_items=0, d=0)
        self.emb = make_embedding(dataclasses.replace(
            base, n_items=int(sum(vocabs)), d=cfg.embed_dim))
        self._codes = codes
        self.register_buffer("offsets", _offsets(vocabs, device),
                             persistent=False)
        self.init_params(generator)

    def init_params(self, generator: torch.Generator) -> dict:
        """(Re)draw every parameter from ``generator`` (on the model's
        device) in the reference's order; returns ``params()``."""
        dev = generator.device
        total = self.emb.cfg.n_items
        _drop(self, "emb_table", "head")
        self.emb_table = Tensors(self.emb.init(generator, codes=self._codes,
                                               device=dev))
        linear = torch.randn((total,), generator=generator, device=dev)
        self.head = Tensors({"linear": linear.mul_(0.01),
                             "bias": torch.zeros((), device=dev)})
        return self.params()

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def params(self) -> dict:
        return {"emb": self.emb_table.tensors(), **self.head.tensors()}

    def _linear_bag(self, p, flat):
        """sum over the fields of linear[flat]: [B, F] -> [B]."""
        return _bag.embedding_bag(p["linear"].view(-1, 1), flat)[:, 0]

    def scores(self, p, sparse_ids):
        """sparse_ids [B, F] per-field ids -> logit [B]."""
        sparse_ids = torch.as_tensor(sparse_ids, device=self.device)
        flat = sparse_ids + self.offsets[None, :]
        v = self.emb.lookup(p["emb"], flat)                 # [B, F, k]
        sum_v = torch.sum(v, 1)
        sum_sq = torch.sum(v * v, 1)
        pair = 0.5 * torch.sum(sum_v * sum_v - sum_sq, -1)  # [B]
        return pair + self._linear_bag(p, flat) + p["bias"]

    def train_loss(self, p, batch, rng=None):
        """Mean BCE; returns (loss, {"loss", "auc_proxy"})."""
        del rng
        logit = self.scores(p, batch["sparse"])
        y = torch.as_tensor(batch["label"], device=self.device).float()
        loss = torch.mean(_bce(logit, y))
        return loss, {"loss": loss, "auc_proxy": torch.mean(
            ((logit > 0) == (y > 0.5)).float())}

    def serve(self, p, batch):
        return torch.sigmoid(self.scores(p, batch["sparse"]))

    def candidate_scores(self, p, batch):
        """Score every value of field 0 (the item field) for one or more
        contexts: s_i = const(rest) + w_i + <v_i, sum(rest)>, one
        ``emb.logits`` call over the table."""
        rest = torch.as_tensor(batch["sparse_rest"], device=self.device) \
            + self.offsets[None, 1:]                        # [B, F-1]
        vr = self.emb.lookup(p["emb"], rest)                # [B, F-1, k]
        rest_sum = torch.sum(vr, 1)                         # [B, k]
        v0 = int(self.cfg.vocabs()[0])
        inter = self.emb.logits(p["emb"], rest_sum)[..., :v0]  # [B, V0]
        lin = p["linear"][:v0][None, :]
        # context-constant terms (pairwise among rest + linear + bias)
        sum_sq = torch.sum(vr * vr, 1)
        c_pair = 0.5 * torch.sum(rest_sum * rest_sum - sum_sq, -1)
        const = (c_pair + self._linear_bag(p, rest) + p["bias"])[:, None]
        return inter + lin + const                          # [B, V0]


# =================================================================== DLRM

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Sequence[int] = (512, 256, 64)
    top_mlp: Sequence[int] = (512, 512, 256, 1)
    vocab_sizes: Optional[Sequence[int]] = None
    embedding: Optional[EmbeddingConfig] = None

    def vocabs(self):
        if self.vocab_sizes:
            return list(self.vocab_sizes)
        # RM2-flavoured mix: a few huge tables + many small ones
        return [[40_000_000, 4_000_000, 400_000, 40_000, 4_000][i % 5]
                for i in range(self.n_sparse)]


class DLRM(torch.nn.Module):
    """DLRM (arXiv:1906.00091) with dot interaction over a shared
    mega-table.  Parameters are drawn in the reference's order: the
    table, the bottom MLP, the top MLP."""

    def __init__(self, cfg: DLRMConfig, *, generator: torch.Generator,
                 codes=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        vocabs = cfg.vocabs()
        base = cfg.embedding or EmbeddingConfig(n_items=0, d=0)
        self.emb = make_embedding(dataclasses.replace(
            base, n_items=int(sum(vocabs)), d=cfg.embed_dim))
        self._codes = codes
        self.register_buffer("offsets", _offsets(vocabs, device),
                             persistent=False)
        self.init_params(generator)

    def init_params(self, generator: torch.Generator) -> dict:
        """(Re)draw every parameter from ``generator`` (on the model's
        device) in the reference's order; returns ``params()``."""
        cfg, dev = self.cfg, generator.device
        _drop(self, "emb_table", "bot", "top")
        self.emb_table = Tensors(self.emb.init(generator, codes=self._codes,
                                               device=dev))
        nf = cfg.n_sparse + 1
        top_in = nf * (nf - 1) // 2 + cfg.bot_mlp[-1]
        self.bot = _mlp_modules(L.mlp_init(
            generator, [cfg.n_dense, *cfg.bot_mlp], device=dev))
        self.top = _mlp_modules(L.mlp_init(
            generator, [top_in, *cfg.top_mlp], device=dev))
        return self.params()

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def params(self) -> dict:
        return {"emb": self.emb_table.tensors(), "bot": _mlp_tree(self.bot),
                "top": _mlp_tree(self.top)}

    def scores(self, p, dense, sparse_ids):
        dense = torch.as_tensor(dense, device=self.device)
        sparse_ids = torch.as_tensor(sparse_ids, device=self.device)
        x = L.mlp(p["bot"], dense, final_act=True)          # [B, d]
        flat = sparse_ids + self.offsets[None, :]
        e = self.emb.lookup(p["emb"], flat)                 # [B, F, d]
        feats = torch.cat([x[:, None, :], e], 1)            # [B, F+1, d]
        gram = torch.bmm(feats, feats.transpose(1, 2))
        nf = feats.shape[1]
        iu = torch.triu_indices(nf, nf, offset=1, device=self.device)
        pairs = gram[:, iu[0], iu[1]]                       # [B, F(F-1)/2]
        z = torch.cat([x, pairs], -1)
        return L.mlp(p["top"], z)[..., 0]

    def train_loss(self, p, batch, rng=None):
        """Mean BCE; returns (loss, {"loss"})."""
        del rng
        logit = self.scores(p, batch["dense"], batch["sparse"])
        y = torch.as_tensor(batch["label"], device=self.device).float()
        loss = torch.mean(_bce(logit, y))
        return loss, {"loss": loss}

    def serve(self, p, batch):
        return torch.sigmoid(self.scores(p, batch["dense"], batch["sparse"]))

    def score_candidates(self, p, batch, *, chunk: int = 4000):
        """Rank a candidate list for one context.  The top MLP is not
        factorisable over items, so candidates run through the full
        interaction ``chunk`` at a time (the reference's ``lax.map``
        chunks; chunk must divide the number of candidates)."""
        cands = torch.as_tensor(batch["candidates"], device=self.device)
        dense = torch.as_tensor(batch["dense"], device=self.device)
        rest = torch.as_tensor(batch["sparse_rest"], device=self.device)
        NC = cands.shape[0]
        if NC % chunk:
            raise ValueError(f"chunk {chunk} must divide the {NC} "
                             f"candidates")
        out = []
        for c in cands.reshape(NC // chunk, chunk):
            d = dense.expand(chunk, dense.shape[1])
            s = torch.cat([c[:, None], rest.expand(chunk, rest.shape[1])], 1)
            out.append(self.scores(p, d, s))
        return torch.cat(out)


# =================================================================== DIEN

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    n_items: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: Sequence[int] = (200, 80)
    embedding: Optional[EmbeddingConfig] = None
    aux_loss_weight: float = 0.1

    def emb_cfg(self) -> EmbeddingConfig:
        base = self.embedding or EmbeddingConfig(n_items=0, d=0)
        return dataclasses.replace(base, n_items=self.n_items + 1,
                                   d=self.embed_dim)


class DIEN(torch.nn.Module):
    """Deep Interest Evolution Network (arXiv:1809.03672): interest
    extraction GRU over the behaviour embeddings, target-attention
    scores, interest-evolution AUGRU, final MLP.  Parameters are drawn
    in the reference's order."""

    def __init__(self, cfg: DIENConfig, *, generator: torch.Generator,
                 codes=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.emb = make_embedding(cfg.emb_cfg())
        self._codes = codes
        self.init_params(generator)

    def init_params(self, generator: torch.Generator) -> dict:
        """(Re)draw every parameter from ``generator`` (on the model's
        device) in the reference's order; returns ``params()``."""
        cfg = self.cfg
        d, g = cfg.embed_dim, cfg.gru_dim
        gen, dev = generator, generator.device
        _drop(self, "item_emb", "gru1", "att", "augru", "fc", "tgt_proj",
              "aux")
        self.item_emb = Tensors(self.emb.init(gen, codes=self._codes,
                                              device=dev))
        self.gru1 = Tensors(gru_init(gen, d, g, device=dev))
        self.att = _mlp_modules(L.mlp_init(gen, [3 * g, 36, 1], device=dev))
        self.augru = Tensors(gru_init(gen, g, g, device=dev))
        self.fc = _mlp_modules(L.mlp_init(gen, [g + 2 * d, *cfg.mlp, 1],
                                          device=dev))
        self.tgt_proj = Tensors(L.linear_init(gen, d, g, device=dev))
        self.aux = _mlp_modules(L.mlp_init(gen, [g + d, 32, 1], device=dev))
        return self.params()

    @property
    def device(self) -> torch.device:
        return self.gru1.wx.device

    def params(self) -> dict:
        return {"item_emb": self.item_emb.tensors(),
                "gru1": self.gru1.tensors(), "att": _mlp_tree(self.att),
                "augru": self.augru.tensors(), "fc": _mlp_tree(self.fc),
                "tgt_proj": self.tgt_proj.tensors(),
                "aux": _mlp_tree(self.aux)}

    def _interest(self, p, hist):
        e = self.emb.lookup(p["item_emb"], hist)            # [B, S, d]
        states, _ = gru_scan(p["gru1"], e)                  # [B, S, g]
        return e, states

    def train_loss(self, p, batch, rng=None):
        """BCE on the target plus ``aux_loss_weight`` times the auxiliary
        next-behaviour loss on the interest states (over ``hist_neg``,
        when the batch has it); returns (loss, {"loss", "main", "aux"})."""
        del rng
        dev = self.device
        hist = torch.as_tensor(batch["hist"], device=dev)
        target = torch.as_tensor(batch["target"], device=dev)
        y = torch.as_tensor(batch["label"], device=dev).float()
        mask = (hist > 0).float()
        e, states = self._interest(p, hist)

        # auxiliary loss: next-behaviour discrimination on the GRU states
        aux = torch.zeros((), device=dev)
        if "hist_neg" in batch:
            e_neg = self.emb.lookup(p["item_emb"], torch.as_tensor(
                batch["hist_neg"], device=dev))
            h_t = states[:, :-1]                            # [B, S-1, g]
            pos_in = torch.cat([h_t, e[:, 1:]], -1)
            neg_in = torch.cat([h_t, e_neg[:, 1:]], -1)
            lp = L.mlp(p["aux"], pos_in)[..., 0]
            ln = L.mlp(p["aux"], neg_in)[..., 0]
            m = mask[:, 1:]
            aux = -(torch.sum((F.logsigmoid(lp) + F.logsigmoid(-ln)) * m)
                    / torch.clamp(torch.sum(m), min=1.0))

        logit = self._head(p, e, states, mask, target)
        main = torch.mean(_bce(logit, y))
        loss = main + self.cfg.aux_loss_weight * aux
        return loss, {"loss": loss, "main": main, "aux": aux}

    def _head(self, p, e, states, mask, target):
        te = self.emb.lookup(p["item_emb"], target)         # [B, d]
        tg = L.linear(p["tgt_proj"], te)                    # [B, g]
        B, S, g = states.shape
        tgb = tg[:, None, :].expand(B, S, g)
        att_in = torch.cat([states, tgb, states * tgb], -1)
        scores = L.mlp(p["att"], att_in)[..., 0]            # [B, S]
        scores = torch.where(mask > 0, scores, -1e9)
        alpha = torch.softmax(scores, -1) * mask
        _, final = gru_scan(p["augru"], states, attn=alpha)
        mean_e = torch.sum(e * mask[..., None], 1) / torch.clamp(
            torch.sum(mask, 1, keepdim=True), min=1.0)
        z = torch.cat([final, te, mean_e], -1)
        return L.mlp(p["fc"], z)[..., 0]

    def serve(self, p, batch):
        hist = torch.as_tensor(batch["hist"], device=self.device)
        target = torch.as_tensor(batch["target"], device=self.device)
        mask = (hist > 0).float()
        e, states = self._interest(p, hist)
        return torch.sigmoid(self._head(p, e, states, mask, target))

    def score_candidates(self, p, batch, *, chunk: int = 2000):
        """Rank candidates for one user.  The interest GRU runs once;
        only the target-conditioned attention and the AUGRU replay per
        candidate chunk (chunk must divide the number of candidates)."""
        hist = torch.as_tensor(batch["hist"], device=self.device)   # [1, S]
        cands = torch.as_tensor(batch["candidates"], device=self.device)
        mask = (hist > 0).float()
        e, states = self._interest(p, hist)                 # [1, S, ...]
        NC, S = cands.shape[0], hist.shape[1]
        if NC % chunk:
            raise ValueError(f"chunk {chunk} must divide the {NC} "
                             f"candidates")
        eb = e.expand(chunk, *e.shape[1:])
        sb = states.expand(chunk, *states.shape[1:])
        mb = mask.expand(chunk, S)
        return torch.cat([self._head(p, eb, sb, mb, c)
                          for c in cands.reshape(NC // chunk, chunk)])
