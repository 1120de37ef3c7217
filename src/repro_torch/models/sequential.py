"""Sequential recommenders with a pluggable item embedding: SASRec,
BERT4Rec and GRU4Rec, the paper's three backbones.

Item ids are 1-based; row 0 is padding and row ``n_items + 1`` is
BERT4Rec's [MASK] token, so every embedding table has ``n_items + 2``
rows, as in the reference.  BERT4Rec trains on batches masked by
``mask_batch`` (a ``targets`` array in place of ``labels``) and is
queried at a [MASK] appended after the history.

Losses (the reference's):
  full_ce     - softmax over the whole catalogue; with a RecJPQ table and
                ``use_kernel=True`` its logits come from the jpq_scores
                kernels, forward and backward.
  sampled_bce - SASRec's binary CE over ``n_negatives`` sampled
                negatives a position (``batch["negatives"]``); it never
                builds the [T, N] logits.  Positives and negatives are
                looked up through ``emb.lookup`` (the jpq_lookup kernels
                on the card).  BERT4Rec trains its masked targets with
                full_ce whatever the loss, as in the reference.
  code_ce     - the semantic-ID head's per-position code cross-entropy
                (``core/semantic.code_xent``), RecJPQ tables only;
                ``semantic_weight > 0`` adds it to another loss as an
                auxiliary term and reports it as ``code_ce``.
The input vectors go through the jpq_lookup kernels with a RecJPQ table
and ``use_kernel=True``.

On a ``(data, model)`` mesh (``dist.use_mesh_rules``; the Trainer
installs it and cuts the parameters with ``bridge.keep_local_blocks``)
each rank holds its blocks of the leaves ``placement`` puts on
``"model"``: the catalogue's rows, the attention heads, the MLP's
width.  The encoder runs head- and MLP-parallel (``nn/attention.py``,
``nn/layers.dense_mlp``), the logits are this rank's column block, and
``full_ce`` is the vocab-parallel cross-entropy
(``vocab_parallel_xent``): the ranks exchange three ``[T]`` vectors,
never the ``[T, N]`` logits.  ``bind_engine`` / ``retrieve_topk`` serve the
top-k through the retrieval engine without the [B, n_rows] scores.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import dist as _dist
from repro_torch.core import EmbeddingConfig, make_embedding
from repro_torch.core import engine as _engine
from repro_torch.core import semantic as _semantic
from repro_torch.core.sharded import vocab_parallel_xent
from repro_torch.nn import layers as L
from repro_torch.nn.attention import AttnConfig, attention, attention_init
from repro_torch.nn.module import Placed, Tensors
from repro_torch.nn.recurrent import gru_init, gru_scan

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    arch: str                     # sasrec | bert4rec | gru4rec
    n_items: int
    max_len: int = 200
    d_model: int = 512
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 1024
    embedding: Optional[EmbeddingConfig] = None   # None -> full, d=d_model
    loss: str = "full_ce"         # full_ce | sampled_bce | code_ce
    semantic_weight: float = 0.0  # auxiliary code-CE weight (jpq only)
    n_negatives: int = 1
    dropout: float = 0.0
    mask_prob: float = 0.2        # bert4rec masking rate

    @property
    def n_rows(self) -> int:      # pad + items + [MASK]
        return self.n_items + 2

    @property
    def mask_id(self) -> int:
        return self.n_items + 1

    def emb_cfg(self) -> EmbeddingConfig:
        # item embeddings start at ~N(0, 0.02), the scale of pos_emb, as
        # in the reference (the d**-0.5 table default, amplified by the
        # sqrt(d_model) input scaling, stalls early training)
        base = self.embedding if self.embedding is not None else \
            EmbeddingConfig(0, 0)
        scale = base.init_scale
        if scale is None and base.kind in ("full", "jpq"):
            scale = 0.02
        return dataclasses.replace(base, n_items=self.n_rows,
                                   d=self.d_model, init_scale=scale)


def _dropout(gen, x, rate: float):
    """Inverted dropout drawn from ``gen``; the identity when ``gen`` is
    None or ``rate`` is 0.  Its bits are not jax.random's."""
    if rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class SeqRecModel(Placed, torch.nn.Module):
    """SASRec / BERT4Rec / GRU4Rec with a pluggable item embedding.
    Parameters are drawn from ``generator`` (on ``device``) in the
    reference's order: the item table, then for the transformers
    ``pos_emb``, each block's ``ln1``, ``attn`` (wq, wk, wv, wo), ``ln2``,
    ``mlp`` (wi, wo), then ``ln_f``; for GRU4Rec each layer's GRU (wx,
    wh, b), then ``proj``.  ``params()`` returns the reference-shaped
    tree of the live parameters (codes a buffer), which the functional
    methods take, as the reference's take its params."""

    def __init__(self, cfg: SeqRecConfig, codes=None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.arch not in ("sasrec", "bert4rec", "gru4rec"):
            raise ValueError(f"unknown arch {cfg.arch!r}")
        if cfg.loss not in ("full_ce", "sampled_bce", "code_ce"):
            raise ValueError(f"unknown loss {cfg.loss!r}")
        if (cfg.loss == "code_ce" or cfg.semantic_weight > 0.0) \
                and cfg.emb_cfg().kind != "jpq":
            raise ValueError(
                f"the semantic-ID objective (loss='code_ce' / "
                f"semantic_weight > 0) is per-position cross-entropy "
                f"over JPQ code sequences — it needs a kind='jpq' "
                f"embedding, got {cfg.emb_cfg().kind!r}")
        self.cfg = cfg
        # GRU4Rec's GRU weights stay whole on a "model" mesh (Placed)
        self.WHOLE = ("gru",) if cfg.arch == "gru4rec" else ()
        self.emb = make_embedding(cfg.emb_cfg())
        self._codes = codes
        self.attn_cfg = AttnConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_heads,
            head_dim=cfg.d_model // cfg.n_heads,
            causal=(cfg.arch == "sasrec"), rope=False)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.init_params(generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ------------------------------------------------------------ init
    def init_params(self, gen: torch.Generator):
        """(Re)draw every parameter from ``gen`` in the reference's order;
        returns ``params()``."""
        cfg, dev = self.cfg, gen.device
        self.item_emb = Tensors(self.emb.init(gen, codes=self._codes,
                                              device=dev))
        if cfg.arch == "gru4rec":
            self.gru = torch.nn.ModuleList(
                Tensors(gru_init(gen, cfg.d_model, cfg.d_model, device=dev))
                for _ in range(cfg.n_layers))
            self.proj = Tensors(L.linear_init(gen, cfg.d_model, cfg.d_model,
                                              device=dev))
            return self._record_shapes()
        self.pos_emb = torch.nn.Parameter(0.02 * torch.randn(
            (cfg.max_len, cfg.d_model), generator=gen, device=dev))
        blocks = []
        for _ in range(cfg.n_layers):
            ln1 = L.layernorm_init(cfg.d_model, device=dev)
            attn = attention_init(gen, self.attn_cfg, device=dev)
            ln2 = L.layernorm_init(cfg.d_model, device=dev)
            mlp = L.dense_mlp_init(gen, cfg.d_model, cfg.d_ff, device=dev)
            blocks.append(torch.nn.ModuleDict({
                "ln1": Tensors(ln1), "attn": Tensors(attn),
                "ln2": Tensors(ln2),
                "mlp": torch.nn.ModuleDict({k: Tensors(v)
                                            for k, v in mlp.items()})}))
        self.blocks = torch.nn.ModuleList(blocks)
        self.ln_f = Tensors(L.layernorm_init(cfg.d_model, device=dev))
        return self._record_shapes()

    # ------------------------------------------------------- placement
    def param_axes(self) -> dict:
        """The logical axes of every leaf of ``params()``: the reference's
        ``nn.axes_tree`` of its ``init_params``."""
        cfg = self.cfg
        emb = self.emb.param_axes()
        if cfg.arch == "gru4rec":
            return {"item_emb": emb,
                    "gru": [{"wx": ("embed", "mlp"), "wh": ("mlp", "mlp"),
                             "b": ("mlp",)} for _ in range(cfg.n_layers)],
                    "proj": {"w": ("embed", "embed"), "b": ("embed",)}}

        def ln():
            return {"scale": ("embed",), "bias": ("embed",)}
        return {
            "item_emb": emb, "pos_emb": ("seq", "embed"),
            "blocks": [{
                "ln1": ln(),
                "attn": {"wq": ("embed", "heads", "head_dim"),
                         "wk": ("embed", "kv_heads", "head_dim"),
                         "wv": ("embed", "kv_heads", "head_dim"),
                         "wo": ("heads", "head_dim", "embed")},
                "ln2": ln(),
                "mlp": {"wi": {"w": ("embed", "mlp"), "b": ("mlp",)},
                        "wo": {"w": ("mlp", "embed"), "b": ("embed",)}}}
                for _ in range(cfg.n_layers)],
            "ln_f": ln()}

    def params(self) -> dict:
        """``{"item_emb", "pos_emb", "blocks": [{"ln1", "attn", "ln2",
        "mlp": {"wi", "wo"}}], "ln_f"}`` of live tensors; for GRU4Rec
        ``{"item_emb", "gru": [{"wx", "wh", "b"}], "proj": {"w", "b"}}``."""
        if self.cfg.arch == "gru4rec":
            return {"item_emb": self.item_emb.live(),
                    "gru": [g.live() for g in self.gru],
                    "proj": self.proj.live()}
        return {
            "item_emb": self.item_emb.live(),
            "pos_emb": self.pos_emb,
            "blocks": [{"ln1": b["ln1"].live(), "attn": b["attn"].live(),
                        "ln2": b["ln2"].live(),
                        "mlp": {k: v.live() for k, v in b["mlp"].items()}}
                       for b in self.blocks],
            "ln_f": self.ln_f.live(),
        }

    # --------------------------------------------------------- encoder
    def encode(self, p, seq, *, generator=None):
        """seq int[B, S] (0 = pad) -> hidden [B, S, d].  ``generator``
        draws the dropout masks (none when None)."""
        cfg = self.cfg
        valid = seq > 0
        x = self.emb.lookup(p["item_emb"], seq)
        x = torch.where(valid[..., None], x, 0.0)
        if cfg.arch == "gru4rec":
            for gp in p["gru"]:
                x, _ = gru_scan(gp, x)
            return L.linear(p["proj"], x)
        S = seq.shape[1]
        x = x * math.sqrt(cfg.d_model)
        x = x + p["pos_emb"][:S][None]
        x = _dropout(generator, x, cfg.dropout)
        for blk in p["blocks"]:
            h = attention(blk["attn"], self.attn_cfg,
                          L.layernorm(blk["ln1"], x), pad_mask=valid)
            x = x + _dropout(generator, h, cfg.dropout)
            h = L.dense_mlp(blk["mlp"], L.layernorm(blk["ln2"], x),
                            d_ff=cfg.d_ff)
            x = x + _dropout(generator, h, cfg.dropout)
        return L.layernorm(p["ln_f"], x)

    # ------------------------------------------------------------ loss
    def loss_counts(self, batch) -> dict:
        """The count in ``batch`` of the positions every loss term is a
        mean over: those with a label (BERT4Rec: with a masked target).
        The Trainer sums it over the data group (``dist.loss_count``)."""
        key = "targets" if self.cfg.arch == "bert4rec" else "labels"
        return {"valid": (torch.as_tensor(batch[key]) > 0).sum()}

    def train_loss(self, p, batch, generator=None):
        """(loss, metrics): the mean over the positions with a label
        (BERT4Rec: with a masked target) of the configured loss, plus
        ``semantic_weight`` times the code cross-entropy when it is set
        (then reported as ``code_ce``).  Each mean divides by the whole
        batch's count where the data group installed it (``_count``), so
        a data rank's terms are its share of the whole batch's."""
        cfg = self.cfg
        if cfg.arch == "bert4rec":
            return self._masked_lm_loss(p, batch, generator)
        seq, labels = batch["seq"], batch["labels"]            # [B, S]
        h = self.encode(p, seq, generator=generator)
        valid = labels > 0
        if cfg.loss == "full_ce":
            loss = self._full_ce(p, h, labels, valid)
        elif cfg.loss == "code_ce":                          # semantic head
            loss = self._code_loss(p, h, labels, valid)
        else:                                                # sampled_bce
            neg = batch["negatives"]                         # [B, S, K]
            pos_e = self.emb.lookup(p["item_emb"], labels)
            neg_e = self.emb.lookup(p["item_emb"], neg)
            pos_s = torch.sum(h * pos_e, -1)
            neg_s = torch.einsum("bsd,bskd->bsk", h, neg_e)
            lp = F.logsigmoid(pos_s)
            ln = torch.sum(F.logsigmoid(-neg_s), -1)
            loss = -torch.sum((lp + ln) * valid) / _count(valid)
        if cfg.semantic_weight > 0.0 and cfg.loss != "code_ce":
            return self._with_aux(p, h, labels, valid, loss)
        return loss, {"loss": loss.detach()}

    def _masked_lm_loss(self, p, batch, generator):
        """BERT4Rec: the batch carries masked inputs and their targets
        (0 where nothing is masked)."""
        seq, targets = batch["seq"], batch["targets"]
        h = self.encode(p, seq, generator=generator)
        valid = targets > 0
        if self.cfg.loss == "code_ce":                       # semantic head
            loss = self._code_loss(p, h, targets, valid)
            return loss, {"loss": loss.detach()}
        loss = self._full_ce(p, h, targets, valid)
        if self.cfg.semantic_weight > 0.0:
            return self._with_aux(p, h, targets, valid, loss)
        return loss, {"loss": loss.detach()}

    def _full_ce(self, p, h, labels, valid):
        """Mean full-catalogue cross-entropy; every position is scored,
        as in the reference.  On this rank's column block of the logits
        (a ``"model"`` mesh), the vocab-parallel cross-entropy."""
        logits = self._mask_special(self.emb.logits(p["item_emb"], h))
        lo, mesh = self._columns(logits)
        ce = _xent(logits, labels) if mesh is None else \
            vocab_parallel_xent(logits, labels, lo, mesh)
        return torch.sum(ce * valid) / _count(valid)

    def _code_loss(self, p, h, targets, valid):
        """Mean code cross-entropy of the targets' code sequences
        (``core/semantic.code_xent``): each position's logits are the
        ``partial_scores`` slices ``semantic_decode`` searches."""
        ce = _semantic.code_xent(p["item_emb"], h, targets,
                                 rows=self.cfg.n_rows)        # [B, S]
        return torch.sum(ce * valid) / _count(valid)

    def _with_aux(self, p, h, targets, valid, loss):
        aux = self._code_loss(p, h, targets, valid)
        loss = loss + self.cfg.semantic_weight * aux
        return loss, {"loss": loss.detach(), "code_ce": aux.detach()}

    def _mask_special(self, logits):
        """Never rank pad / [MASK] rows.  In place: the reference's
        ``.at[].set`` copies, this writes into ``logits`` (no backward
        here needs its values) and saves a [.., n_rows] copy.  On a
        column block the pad column is rank 0's first and the [MASK]
        column the last rank's last."""
        lo, _ = self._columns(logits)
        if lo == 0:
            logits[..., 0] = NEG_INF
        if lo + logits.shape[-1] == self.cfg.n_rows:
            logits[..., -1] = NEG_INF
        return logits

    def _columns(self, logits):
        """(first column, mesh) of scores that are this rank's column
        block of the catalogue; (0, None) for the whole catalogue."""
        n = logits.shape[-1]
        if n == self.cfg.n_rows:
            return 0, None
        blk = _dist.row_block(self.cfg.n_rows)
        if blk is None or blk[1] - blk[0] != n:
            raise ValueError(f"{n} score columns are neither the catalogue "
                             f"({self.cfg.n_rows}) nor this rank's block "
                             f"of it ({blk})")
        return blk[0], _dist._CTX.mesh

    # ------------------------------------------------------------ serve
    def _serve_seq(self, seq):
        """The query position: BERT4Rec predicts at a [MASK] appended
        after the history (the oldest item drops off); the causal archs
        query the history's last position itself."""
        if self.cfg.arch != "bert4rec":
            return seq
        mask_col = torch.full((seq.shape[0], 1), self.cfg.mask_id,
                              dtype=seq.dtype, device=seq.device)
        return torch.cat([seq[:, 1:], mask_col], 1)

    def score_last(self, p, seq):
        """Rank the full catalogue from the last position: [B, n_rows]
        (on a ``"model"`` mesh, this rank's column block of it; the
        metrics of ``train/metrics.py`` take it with ``rows=n_rows``)."""
        h = self.encode(p, self._serve_seq(seq))
        return self._mask_special(self.emb.logits(p["item_emb"], h[:, -1]))

    def bind_engine(self, p, spec, *, catalogue=None):
        """Bind a ``core.engine.RetrievalSpec`` to this model and params:
        a ``BoundRetrieval`` mapping a request (a [B, S] sequence, or a
        dict with ``user_hist``) through the encoder, the engine's scorer
        and the serve protocol.  The engine runs at an internal k of
        ``min(spec.k + 2, n_rows)``: the two extra candidates cover the
        pad and [MASK] rows that ``score_last`` masks, and the post step
        demotes those rows to NEG_INF and re-ranks, so the result equals
        the total-order top-k of ``score_last(p, seq)``."""
        n_rows = self.cfg.n_rows
        k_out = min(int(spec.k), n_rows)
        inner = dataclasses.replace(spec, k=min(k_out + 2, n_rows))
        eng = _engine.RetrievalEngine(inner, self.emb, p["item_emb"],
                                      catalogue=catalogue)

        def encode(request):
            seq = request["user_hist"] if isinstance(request, dict) \
                else request
            return self.encode(p, self._serve_seq(seq))[:, -1]

        def post(out):
            stats = None
            if inner.stats:
                v, i, stats = out
            else:
                v, i = out
            forbidden = (i == 0) | (i == n_rows - 1)
            v = torch.where(forbidden, NEG_INF, v)
            vv, ids = _engine.rerank_candidates(v, i, k_out)
            return (vv, ids, stats) if inner.stats else (vv, ids)

        return _engine.BoundRetrieval(eng, encode, post)

    def retrieve_topk(self, p, seq, *, k: int, fused: bool = True,
                      prune=None, perm=None, warm=None, block_n=None,
                      backend=None, return_stats: bool = False):
        """Top-k catalogue retrieval from the last position without the
        [B, n_rows] score matrix ``score_last`` builds: a RecJPQ table
        goes through the engine's fused PQTopK scorer (pruned with
        ``prune``), full and QR tables through materialise + top-k.
        Equal to the total-order top-k of ``score_last(p, seq)``.
        ``warm`` / ``return_stats`` are ``core/serve.retrieve_topk``'s
        (the stats' ``theta`` is the internal (k+2)-th value); ``backend``
        must be None (``engine.spec_for``)."""
        spec = _engine.spec_for(self.emb, k=k, fused=fused,
                                block_n=block_n, backend=backend,
                                prune=prune, perm=perm,
                                warm_decay=0.0 if warm is not None
                                else None,
                                stats=return_stats)
        bound = self.bind_engine(p, spec)
        if bound.engine.spec.prune:
            bound.engine.bind_catalogue(prune=prune, perm=perm)
        if warm is not None:
            warm = torch.as_tensor(warm, dtype=torch.float32,
                                   device=self.device)
        return bound.retrieve(seq, floor=warm)


def _count(valid):
    """The number of valid positions, at least 1: in the whole batch
    where the data group installed its counts (``dist.loss_count``),
    else in ``valid``."""
    n = _dist.loss_count("valid")
    return torch.clamp(valid.sum() if n is None else n, min=1)


def _xent(logits, labels):
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - picked


# --------------------------------------------------- bert4rec masking

def mask_batch(gen: torch.Generator, seq, mask_prob: float, mask_id: int):
    """Cloze-mask a batch for BERT4Rec: (masked seq, targets), targets 0
    where nothing is masked.  Each item is masked with probability
    ``mask_prob`` (uniforms drawn from ``gen``, a generator on ``seq``'s
    device; their bits are not jax.random's); pads never are, and the
    last real item of every row always is, so every non-empty row has a
    target and trains on the next-item position."""
    r = torch.rand(seq.shape, generator=gen, device=seq.device)
    is_item = seq > 0
    S = seq.shape[1]
    last = S - 1 - torch.argmax(torch.flip(is_item, [1]).int(), 1)
    force = torch.arange(S, device=seq.device)[None, :] == last[:, None]
    do_mask = ((r < mask_prob) | force) & is_item
    masked = torch.where(do_mask, mask_id, seq)
    targets = torch.where(do_mask, seq, 0)
    return masked, targets
