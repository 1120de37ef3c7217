"""GQA attention with RoPE, sliding windows, qk-norm and a KV cache,
functional over tensor dicts, in the reference's layouts: x [B, S, d];
q [B, S, H, Dh]; k/v [B, S, Hkv, Dh]; weights ``wq [d, H, Dh]``,
``wk/wv [d, Hkv, Dh]``, ``wo [H, Dh, d]``.

Causality, windows and padding are an additive ``NEG_INF`` bias on fp32
scores before the softmax, as in the reference (``scaled_dot_product_
attention`` would mask differently).  Head ``h`` reads kv-group ``h //
G`` (G = H / Hkv), the reference's ``q.reshape(B, S, Hkv, G, Dh)``.
qk-norm (an RMSNorm over Dh) comes before RoPE (half-split pairs).  With
``q_chunk`` and a long unpadded sequence the queries run in blocks, so
the score tile is ``[B, H, q_chunk, S]``, not ``[B, H, S, S]``.
Decoding runs one token against a per-layer cache; a sliding-window
cache is a ring buffer of ``min(max_len, window)`` slots.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import dist as _dist
from repro_torch.nn.layers import (apply_rope, lecun_normal, rmsnorm,
                                   rmsnorm_init, rope_angles)

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None          # sliding-window size (None = full)
    rope: bool = True
    rope_theta: float = 10000.0
    # query blocking: caps the score tile at [B, H, q_chunk, S]
    q_chunk: Optional[int] = None


def attention_init(gen: torch.Generator, cfg: AttnConfig, *,
                   dtype=torch.float32, device="cuda"):
    """``wq``, ``wk``, ``wv``, ``wo`` drawn in that order, then the
    qk-norm scales (ones) where ``qk_norm``."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim

    def w(shape, in_axis):
        return lecun_normal(gen, shape, dtype=dtype, device=device,
                            in_axis=in_axis, out_axis=2)

    p = {"wq": w((d, H, Dh), 0), "wk": w((d, Hkv, Dh), 0),
         "wv": w((d, Hkv, Dh), 0), "wo": w((H, Dh, d), 1)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(Dh, dtype=dtype, device=device)
        p["k_norm"] = rmsnorm_init(Dh, dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg: AttnConfig, x, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.rope:
        sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _mask_bias(cfg: AttnConfig, q_pos, kv_pos, pad_mask=None):
    """[B?, Sq, Skv] additive bias from causality, the window and
    padding."""
    diff = q_pos[..., :, None] - kv_pos[..., None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if cfg.causal:
        m = m & (diff >= 0)
    if cfg.window is not None:
        m = m & (diff < cfg.window)
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=diff.device)
    bias = torch.where(m, zero, neg)
    if pad_mask is not None:                       # [B, Skv] True = valid
        bias = bias + torch.where(pad_mask, zero, neg)[..., None, :]
    return bias


def _sdpa(q, k, v, bias):
    """q [B, Sq, H, Dh], k/v [B, Skv, Hkv, Dh], bias [B?, Sq, Skv];
    softmax in fp32.  With Hkv < H, head h attends with kv-group h // G."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    if bias.dim() == 3:
        bias = bias[:, None]                       # [B, 1, Sq, Skv]
    if Hkv == H:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        scores = scores / math.sqrt(Dh)
        w = torch.softmax(scores + bias, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(Dh)
    if bias.dim() == 4:
        bias = bias[:, :, None]                    # [B, 1, 1, Sq, Skv]
    w = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, H, Dh)


def attention(p, cfg: AttnConfig, x, *, positions=None, pad_mask=None):
    """Full-sequence attention (training / prefill), x [B, S, d].  When
    ``wq/wk/wv/wo`` hold a block of the heads (a ``"model"`` mesh, the
    reference's ``heads`` axis), this rank runs its heads: ``x`` enters
    through ``dist.copy_to_model`` and the heads' partial outputs after
    ``wo`` are summed by ``dist.reduce_from_model``.  With ``q_chunk``,
    ``S > q_chunk``, ``S % q_chunk == 0``, no pad mask and positions of
    batch 1, the queries run in blocks of ``q_chunk`` against all S
    keys, as the reference's ``lax.map`` runs them."""
    split = p["wq"].shape[1] != cfg.n_heads
    if split:
        x = _dist.copy_to_model(_ambient(x))
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    qc = cfg.q_chunk
    if qc and S > qc and S % qc == 0 and pad_mask is None \
            and positions.shape[0] == 1:
        kv_pos = positions[0]
        out = torch.cat([
            _sdpa(q[:, i:i + qc], k, v,
                  _mask_bias(cfg, kv_pos[None, i:i + qc], kv_pos[None]))
            for i in range(0, S, qc)], 1)
    else:
        out = _sdpa(q, k, v, _mask_bias(cfg, positions, positions, pad_mask))
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return _dist.reduce_from_model(out) if split else out


def _ambient(x):
    """``x``, after checking that a mesh is installed for a split leaf."""
    if _dist.model_size() <= 1:
        raise ValueError("the attention weights hold a block of the heads, "
                         "but no ambient mesh splits them "
                         "(dist.use_mesh_rules)")
    return x


# ------------------------------------------------------------- decoding

def init_cache(cfg: AttnConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda"):
    """One layer's cache: ``k``, ``v`` [batch, C, Hkv, Dh] zeros, C =
    ``max_len`` or, with a window, ``min(max_len, window)`` (a ring
    buffer), and ``pos``, the absolute next position (int32 scalar)."""
    C = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, C, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(p, cfg: AttnConfig, x, cache):
    """x [B, 1, d] at position ``cache["pos"]`` -> (out [B, 1, d], cache).

    The reference returns a new cache; at decode shapes a copy a step
    would double the cache's memory and time, so this writes the new
    key and value into slot ``pos mod C`` of ``cache["k"]`` /
    ``cache["v"]`` and adds one to ``cache["pos"]`` in place (no
    autograd graph is kept there), and returns the same tensors, equal
    to the reference's new cache.  Slot ``s`` holds absolute position
    ``pos - ((pos - s) mod C)``, valid where that is >= 0."""
    B = x.shape[0]
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    C = ck.shape[1]
    positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    slot = torch.remainder(pos, C).reshape(1).long()
    with torch.no_grad():
        ck.index_copy_(1, slot, k.detach().to(ck.dtype))
        cv.index_copy_(1, slot, v.detach().to(cv.dtype))
    slot_ids = torch.arange(C, dtype=torch.int32, device=ck.device)
    kv_pos = pos - torch.remainder(pos - slot_ids, C)   # <= pos
    zero = torch.zeros((), dtype=torch.float32, device=ck.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ck.device)
    bias = torch.where(kv_pos >= 0, zero, neg)[None, None, :]
    bias = bias + _mask_bias(cfg, positions, kv_pos)   # [B, 1, C]
    out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), bias)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    with torch.no_grad():
        pos.add_(1)
    return out, cache
