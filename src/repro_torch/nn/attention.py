"""Multi-head attention for the sequential recommenders, functional over
tensor dicts, in the reference's layouts: x [B, S, d]; q/k/v
[B, S, H, Dh]; weights ``wq/wk/wv [d, H, Dh]``, ``wo [H, Dh, d]``.

Causality and padding are an additive ``NEG_INF`` bias on fp32 scores
before the softmax, as in the reference (``scaled_dot_product_attention``
would mask differently).  RoPE, qk-norm, sliding windows, query blocking
and decoding are not needed by SASRec and are not yet ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import dist as _dist
from repro_torch.nn.layers import lecun_normal

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None
    rope: bool = True
    rope_theta: float = 10000.0
    q_chunk: Optional[int] = None


def _check_ported(cfg: AttnConfig):
    unported = [name for name, on in (
        ("rope", cfg.rope), ("qk_norm", cfg.qk_norm),
        ("window", cfg.window is not None), ("q_chunk", cfg.q_chunk),
        ("n_kv != n_heads", cfg.n_kv != cfg.n_heads)) if on]
    if unported:
        raise NotImplementedError(
            f"attention options {unported} are not yet ported to repro_torch "
            f"(the sequential recommenders use none of them)")


def attention_init(gen: torch.Generator, cfg: AttnConfig, *,
                   dtype=torch.float32, device="cuda"):
    _check_ported(cfg)
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim

    def w(shape, in_axis):
        return lecun_normal(gen, shape, dtype=dtype, device=device,
                            in_axis=in_axis, out_axis=2)

    return {"wq": w((d, H, Dh), 0), "wk": w((d, H, Dh), 0),
            "wv": w((d, H, Dh), 0), "wo": w((H, Dh, d), 1)}


def _mask_bias(cfg: AttnConfig, q_pos, kv_pos, pad_mask=None):
    """[B?, Sq, Skv] additive bias from causality and padding."""
    diff = q_pos[..., :, None] - kv_pos[..., None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if cfg.causal:
        m = m & (diff >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=diff.device)
    bias = torch.where(m, zero, neg)
    if pad_mask is not None:                       # [B, Skv] True = valid
        bias = bias + torch.where(pad_mask, zero, neg)[..., None, :]
    return bias


def _sdpa(q, k, v, bias):
    """q [B, Sq, H, Dh], k/v [B, Skv, H, Dh], bias broadcastable to
    [B, H, Sq, Skv]; softmax in fp32."""
    Dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(Dh)
    w = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention(p, cfg: AttnConfig, x, *, positions=None, pad_mask=None):
    """Full-sequence attention (training / prefill), x [B, S, d].  When
    ``wq/wk/wv/wo`` hold a block of the heads (a ``"model"`` mesh, the
    reference's ``heads`` axis), this rank runs its heads: ``x`` enters
    through ``dist.copy_to_model`` and the heads' partial outputs after
    ``wo`` are summed by ``dist.reduce_from_model``."""
    _check_ported(cfg)
    split = p["wq"].shape[1] != cfg.n_heads
    if split:
        x = _dist.copy_to_model(_ambient(x))
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    bias = _mask_bias(cfg, positions, positions, pad_mask)
    if bias.ndim == 3:
        bias = bias[:, None]                       # [B, 1, Sq, Skv]
    out = _sdpa(q, k, v, bias)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return _dist.reduce_from_model(out) if split else out


def _ambient(x):
    """``x``, after checking that a mesh is installed for a split leaf."""
    if _dist.model_size() <= 1:
        raise ValueError("the attention weights hold a block of the heads, "
                         "but no ambient mesh splits them "
                         "(dist.use_mesh_rules)")
    return x


def init_cache(*args, **kwargs):
    raise NotImplementedError("KV-cache decoding (init_cache, decode_step) "
                              "is not yet ported to repro_torch")


decode_step = init_cache
