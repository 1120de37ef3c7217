"""Generic decoder-only transformer LM covering the assigned LM archs,
the reference's ``models/lm.py``:

  mixtral-8x7b   GQA 32/8, SwiGLU MoE 8e top-2, sliding-window 4096
  olmoe-1b-7b    MHA 16 heads, MoE 64e top-8 (fine-grained, d_ff 1024)
  stablelm-12b   GQA 32/8, dense SwiGLU
  qwen3-14b      GQA 40/8, dense SwiGLU, qk-norm
  stablelm-1.6b  MHA 32 heads, dense SwiGLU

One definition, config-driven.  With ``scan_layers`` the blocks are
stored stacked (``[L, ...]`` leaves, ``nn/module.stack_params``) and run
layer by layer from ``unstack_params``; otherwise as a list.  ``remat``
wraps each block in ``torch.utils.checkpoint`` (non-reentrant) while a
gradient is taken.  Weights are stored in fp32 and cast to
``compute_dtype`` where used.

Three programs: ``train_loss`` (the causal LM loss over [B, S] tokens,
plus the MoE aux loss), ``prefill`` (the full forward, last-position
logits; like the reference it fills no cache) and ``decode_step`` (one
token against per-layer KV caches, ring-buffered for sliding-window
archs, so mixtral's 500k-token decode holds an O(window) cache).

The vocabulary goes through ``core``'s embedding factory.  A full table
has its own ``lm_head``; its token gather trains through the
embedding_bag backward kernel (``kernels/embedding_bag/ops.gather``).
A RecJPQ vocabulary (``embedding.kind = "jpq"``, the repo's
beyond-paper experiment) ties the softmax to the codes: with
``use_kernel=True`` the logits are the jpq_scores kernels' forward and
backward and the lookup is the jpq_lookup kernels'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import EmbeddingConfig, make_embedding
from repro_torch.nn import layers as L
from repro_torch.nn.attention import (AttnConfig, attention, attention_init,
                                      decode_step as attn_decode, init_cache)
from repro_torch.nn.module import Tensors, hold, live, unstack_params
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    embedding: Optional[EmbeddingConfig] = None   # None -> full table
    scan_layers: bool = True
    remat: bool = True
    compute_dtype: str = "bfloat16"
    q_chunk: Optional[int] = None      # query blocking of the attention
    logits_bf16: bool = False          # CE logits in bf16 (fp32 lse)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv=self.n_kv, head_dim=self.hd,
                          qk_norm=self.qk_norm, causal=True,
                          window=self.window, rope=True,
                          rope_theta=self.rope_theta,
                          q_chunk=self.q_chunk)

    def emb_cfg(self) -> EmbeddingConfig:
        if self.embedding is not None:
            return dataclasses.replace(self.embedding, n_items=self.vocab,
                                       d=self.d_model)
        return EmbeddingConfig(n_items=self.vocab, d=self.d_model)

    def param_count(self) -> int:
        d, f, n, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.hd * (self.n_heads * 2 + self.n_kv * 2)
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff \
                + d * self.moe.n_experts
        else:
            ffn = 3 * d * f
        return n * (attn + ffn + 2 * d) + 2 * V * d + d

    def active_param_count(self) -> int:
        """6·N_active·D convention for MoE rooflines."""
        d, n, V = self.d_model, self.n_layers, self.vocab
        attn = d * self.hd * (self.n_heads * 2 + self.n_kv * 2)
        if self.moe:
            ffn = self.moe.top_k * 3 * d * self.moe.d_ff
        else:
            ffn = 3 * d * self.d_ff
        return n * (attn + ffn + 2 * d) + 2 * V * d + d


class TransformerLM(torch.nn.Module):
    """The LM's parameters, drawn from ``generator`` (on ``device``) in
    the reference's order: every block (``attn`` wq, wk, wv, wo; then
    ``moe`` router, wi_gate, wi_up, wo or ``mlp`` wi_gate, wi_up, wo;
    the norms are ones), then ``tok_emb``, then ``lm_head`` for a full
    table.  ``params()`` is the reference's tree of the live parameters
    (``{"tok_emb", "blocks", "ln_f"[, "lm_head"]}``, ``blocks`` a dict
    of ``[L, ...]`` stacks or a list of per-layer dicts), which the
    functional methods take, as the reference's take its params."""

    def __init__(self, cfg: LMConfig, codes=None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.norm not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {cfg.norm!r}")
        self.cfg = cfg
        self.emb = make_embedding(cfg.emb_cfg())
        self._codes = codes
        self.acfg = cfg.attn_cfg()
        self.dtype = getattr(torch, cfg.compute_dtype)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.init_params(generator)

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    # ------------------------------------------------------------ init
    def _norm_init(self, dev):
        return L.make_norm(self.cfg.norm, self.cfg.d_model, device=dev)[0]

    def _block_init(self, gen, dev):
        cfg = self.cfg
        blk = {"ln1": self._norm_init(dev),
               "attn": attention_init(gen, self.acfg, device=dev),
               "ln2": self._norm_init(dev)}
        if cfg.moe is not None:
            blk["moe"] = moe_init(gen, cfg.moe, device=dev)
        else:
            blk["mlp"] = L.gated_mlp_init(gen, cfg.d_model, cfg.d_ff,
                                          device=dev)
        return blk

    def _draw_blocks(self, gen, dev):
        """The blocks as a list, or with ``scan_layers`` as ``[L, ...]``
        stacks filled layer by layer (one layer's tree extra in memory,
        not a second copy of every layer)."""
        n = self.cfg.n_layers
        if not self.cfg.scan_layers:
            return [self._block_init(gen, dev) for _ in range(n)]

        def empty(t):
            if isinstance(t, dict):
                return {k: empty(v) for k, v in t.items()}
            return t.new_empty((n,) + tuple(t.shape))

        def fill(dst, src, i):
            for k, v in src.items():
                if isinstance(v, dict):
                    fill(dst[k], v, i)
                else:
                    dst[k][i].copy_(v)

        stacked = None
        for i in range(n):
            blk = self._block_init(gen, dev)
            if stacked is None:
                stacked = empty(blk)
            fill(stacked, blk, i)
            del blk
        return stacked

    def init_params(self, gen: torch.Generator):
        """(Re)draw every parameter from ``gen``; returns ``params()``."""
        cfg, dev = self.cfg, gen.device
        with torch.no_grad():
            self.blocks = hold(self._draw_blocks(gen, dev))
            self.tok_emb = Tensors(self.emb.init(gen, codes=self._codes,
                                                 device=dev))
            self.ln_f = Tensors(self._norm_init(dev))
            if self.emb.cfg.kind == "full":
                self.lm_head = torch.nn.Parameter(L.lecun_normal(
                    gen, (cfg.d_model, cfg.vocab), device=dev))
            else:
                self.lm_head = None
        return self.params()

    def params(self) -> dict:
        p = {"tok_emb": self.tok_emb.live(), "blocks": live(self.blocks),
             "ln_f": self.ln_f.live()}
        if self.lm_head is not None:
            p["lm_head"] = self.lm_head
        return p

    # ----------------------------------------------------------- block
    def _norm(self, pn, x):
        return (L.rmsnorm if self.cfg.norm == "rmsnorm"
                else L.layernorm)(pn, x)

    def _ffn(self, blk, hn):
        """The block's FFN on hn [B, S, d] -> (y, aux fp32)."""
        cfg = self.cfg
        if cfg.moe is None:
            return L.gated_mlp(blk["mlp"], hn), \
                torch.zeros((), dtype=torch.float32, device=hn.device)
        B, S, d = hn.shape
        y, aux = moe_apply(blk["moe"], cfg.moe, hn.reshape(B * S, d))
        return y.reshape(B, S, d), aux

    def _block(self, blk, x):
        x = x + attention(blk["attn"], self.acfg, self._norm(blk["ln1"], x))
        y, aux = self._ffn(blk, self._norm(blk["ln2"], x))
        return x + y, aux

    def _layers(self, p):
        blocks = p["blocks"]
        return unstack_params(blocks) if self.cfg.scan_layers else blocks

    # --------------------------------------------------------- forward
    def hidden_states(self, p, tokens):
        """tokens [B, S] -> (final-norm hidden [B, S, d] in
        ``compute_dtype``, the layers' aux loss summed in fp32)."""
        x = self.emb.lookup(p["tok_emb"], tokens).to(self.dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self._layers(p):
            if remat:
                x, a = checkpoint(self._block, blk, x, use_reentrant=False)
            else:
                x, a = self._block(blk, x)
            aux_total = aux_total + a
        return self._norm(p["ln_f"], x), aux_total

    def logits(self, p, h):
        """h [..., d] -> [..., vocab]: ``h @ lm_head`` (bf16 with
        ``logits_bf16``, else fp32), or the RecJPQ vocabulary's tied
        scores (``emb.logits``, fp32)."""
        if "lm_head" in p:
            if self.cfg.logits_bf16:
                return h.bfloat16() @ p["lm_head"].bfloat16()
            return h.float() @ p["lm_head"]
        return self.emb.logits(p["tok_emb"], h)

    # ------------------------------------------------------------ loss
    def train_loss(self, p, batch, generator=None):
        """(loss, metrics): the mean next-token cross-entropy (lse in
        fp32, the target's logit read in the logits' dtype) plus the MoE
        aux loss; metrics ``loss``, ``ce``, ``aux``."""
        del generator
        tokens, targets = batch["tokens"], batch["targets"]
        h, aux = self.hidden_states(p, tokens)
        logits = self.logits(p, h)
        lse = torch.logsumexp(logits.float(), -1)
        picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        ce = torch.mean(lse - picked.float())
        loss = ce + aux
        return loss, {"loss": loss.detach(), "ce": ce.detach(),
                      "aux": aux.detach()}

    # ----------------------------------------------------------- serve
    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """Stacked per-layer KV caches: ``k``, ``v`` [L, batch, C, Hkv,
        Dh], ``pos`` [L] int32 (``attention.init_cache`` a layer)."""
        one = init_cache(self.acfg, batch, max_len, dtype=dtype,
                         device=self.device)
        n = self.cfg.n_layers
        return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                               device=v.device) for k, v in one.items()}

    def prefill(self, p, tokens):
        """The full causal forward; returns the last position's logits
        [B, 1, vocab].  Like the reference, it fills no cache."""
        h, _ = self.hidden_states(p, tokens)
        return self.logits(p, h[:, -1:, :])

    def _decode_block(self, layer, x, cache):
        xn = self._norm(layer["ln1"], x)
        h, _ = attn_decode(layer["attn"], self.acfg, xn, cache)
        x = x + h
        y, _ = self._ffn(layer, self._norm(layer["ln2"], x))
        return x + y

    def decode_step(self, p, token, caches):
        """token [B, 1] int; caches stacked [L, ...] -> (logits [B, 1,
        vocab], caches).  Each layer's cache is updated in place
        (``attention.decode_step``); the returned caches are the same
        tensors, equal to the reference's new caches."""
        x = self.emb.lookup(p["tok_emb"], token).to(self.dtype)
        for i, blk in enumerate(self._layers(p)):
            x = self._decode_block(blk, x, {k: c[i] for k, c in
                                            caches.items()})
        x = self._norm(p["ln_f"], x)
        return self.logits(p, x), caches
