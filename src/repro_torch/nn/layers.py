"""Linear layers, MLP towers, LayerNorm, RMSNorm, RoPE, the GELU FFN and
the SwiGLU FFN, functional over tensor dicts.

Weights keep the reference layout ``w [d_in, d_out]`` (``y = x @ w + b``),
so parameters bridge across without transposes.
"""
from __future__ import annotations

import math

import torch

from repro_torch import dist as _dist


def fan(shape, in_axis: int = -2, out_axis: int = -1):
    """(fan_in, fan_out) as the reference's ``nn._fan`` counts them: the
    named axes times the receptive field (the product of the others)."""
    if len(shape) < 2:
        return shape[0], shape[0]
    receptive = math.prod(shape) / (shape[in_axis] * shape[out_axis])
    return shape[in_axis] * receptive, shape[out_axis] * receptive


def lecun_normal(gen: torch.Generator, shape, *, dtype=torch.float32,
                 device="cuda", in_axis: int = -2, out_axis: int = -1):
    """Truncated normal on [-2, 2] scaled by sqrt(1 / fan_in) — the
    reference's ``nn.lecun_normal``.  For the attention weights
    ``[d, H, Dh]`` (in_axis 0, out_axis 2) fan_in is d·H, for
    ``[H, Dh, d]`` (in_axis 1) it is Dh·H = d."""
    fan_in, _ = fan(shape, in_axis, out_axis)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (math.sqrt(1.0 / max(1.0, fan_in)) * t).to(dtype)


def glorot_normal(gen: torch.Generator, shape, *, dtype=torch.float32,
                  device="cuda", in_axis: int = -2, out_axis: int = -1):
    """Truncated normal on [-2, 2] scaled by sqrt(2 / (fan_in +
    fan_out)) — the reference's ``nn.glorot_normal``."""
    fan_in, fan_out = fan(shape, in_axis, out_axis)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (math.sqrt(2.0 / max(1.0, fan_in + fan_out)) * t).to(dtype)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = True, dtype=torch.float32, device="cuda"):
    p = {"w": lecun_normal(gen, (d_in, d_out), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mlp_init(gen: torch.Generator, dims, *, bias: bool = True,
             dtype=torch.float32, device="cuda"):
    """Plain MLP tower: dims = [in, h1, ..., out]."""
    return {"layers": [linear_init(gen, a, b, bias=bias, dtype=dtype,
                                   device=device)
                       for a, b in zip(dims[:-1], dims[1:])]}


def mlp(p, x, *, act=torch.relu, final_act: bool = False, dims=None):
    """ReLU between layers, none after the last unless ``final_act``.
    ``dims`` (the whole widths ``[in, h1, ..., out]``): a layer whose
    weight is narrower holds this rank's block of it on a ``"model"``
    mesh (``split_linear``), and the tower runs tensor-parallel."""
    n = len(p["layers"])
    if dims is not None and any(
            tuple(lp["w"].shape) != (a, b)
            for lp, a, b in zip(p["layers"], dims[:-1], dims[1:])):
        return _split_mlp(p, x, act, final_act, dims)
    for i, lp in enumerate(p["layers"]):
        x = linear(lp, x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def split_linear(lp, x, d_in: int, d_out: int, *, x_block: bool = False):
    """One layer of a tower whose weight may be this rank's block on
    the ambient ``"model"`` mesh, as the reference's ``mlp_init`` axes
    place it (``("embed", "mlp")`` for layer 0, ``("mlp", "mlp")``
    after; the first dimension that divides takes the axis):
      * column block ``[d_in, d_out/S]`` (and its bias): the output is
        this rank's column block; the whole input enters through
        ``dist.copy_to_model`` (its gradient summed over the ranks), or
        where the layer narrows (d_out < d_in) through
        ``dist.column_linear`` (``dy`` gathered instead: fewer bytes);
      * row block ``[d_in/S, d_out]``: the input's column block (cut
        from a whole input by ``dist.scatter_to_model``) times it, the
        partial products summed by ``dist.reduce_from_model``, then the
        bias, gathered first where it is this rank's block;
      * whole: a block input is gathered first.
    ``x_block``: ``x`` is this rank's column block.  Returns (y, whether
    y is a column block)."""
    w, b = lp["w"], lp.get("b")
    if w.shape[1] != d_out:                              # column block
        if x_block:
            x = _dist.gather_from_model(x, -1)
        w = w.to(x.dtype)
        y = (_dist.column_linear(x, w) if d_out < d_in else
             _dist.copy_to_model(x) @ w)
        return (y if b is None else y + b.to(y.dtype)), True
    if w.shape[0] != d_in:                               # row block
        if not x_block:
            x = _dist.scatter_to_model(x, -1)
        y = _dist.reduce_from_model(x @ w.to(x.dtype))
        if b is not None:
            if b.shape[0] != d_out:
                b = _dist.gather_from_model(b, 0)
            y = y + b.to(y.dtype)
        return y, False
    if x_block:
        x = _dist.gather_from_model(x, -1)
    return linear(lp, x), False


def _split_mlp(p, x, act, final_act, dims):
    if _dist.model_size() <= 1:
        raise ValueError("a tower holds blocks of its weights, but no "
                         "ambient mesh splits them (dist.use_mesh_rules)")
    n = len(p["layers"])
    blk = False
    for i, lp in enumerate(p["layers"]):
        x, blk = split_linear(lp, x, dims[i], dims[i + 1], x_block=blk)
        if i < n - 1 or final_act:
            x = act(x)
    return _dist.gather_from_model(x, -1) if blk else x


def layernorm_init(d: int, *, dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-6):
    """Normalised in fp32 with the reference's eps 1e-6 (torch's
    ``layer_norm`` defaults to 1e-5)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form (the exact erf form
    differs by up to 4.7e-4)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def dense_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                   dtype=torch.float32, device="cuda"):
    """2-layer GELU FFN (SASRec/BERT4Rec-style)."""
    return {"wi": linear_init(gen, d_model, d_ff, dtype=dtype, device=device),
            "wo": linear_init(gen, d_ff, d_model, dtype=dtype, device=device)}


def dense_mlp(p, x, act=gelu, *, d_ff=None):
    """``wo(act(wi(x)))``.  With ``d_ff`` (the layer's whole width) and a
    narrower ``wi``, the weights hold this rank's block of the ``mlp``
    axis (a ``"model"`` mesh): ``wi`` and its bias column-parallel,
    ``wo`` row-parallel; ``x`` enters through ``dist.copy_to_model``,
    the partial products are summed by ``dist.reduce_from_model``, and
    ``wo``'s bias, which is whole, is added once after the sum."""
    if d_ff is None or p["wi"]["w"].shape[1] == d_ff:
        return linear(p["wo"], act(linear(p["wi"], x)))
    if _dist.model_size() <= 1:
        raise ValueError(f"wi holds {p['wi']['w'].shape[1]} of {d_ff} "
                         f"columns, but no ambient mesh splits them "
                         f"(dist.use_mesh_rules)")
    h = act(linear(p["wi"], _dist.copy_to_model(x)))
    y = _dist.reduce_from_model(h @ p["wo"]["w"].to(h.dtype))
    return y + p["wo"]["b"].to(y.dtype)


def rmsnorm_init(d: int, *, dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    """Normalised by the root mean square in fp32 (eps 1e-6), scaled,
    cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    ms = torch.square(x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps) * p["scale"]).to(dt)


def make_norm(kind: str, d: int, *, device="cuda"):
    """(init tree, apply function) of a ``"layernorm"`` or ``"rmsnorm"``."""
    if kind == "layernorm":
        return layernorm_init(d, device=device), layernorm
    if kind == "rmsnorm":
        return rmsnorm_init(d, device=device), rmsnorm
    raise ValueError(kind)


# ---------------------------------------------------------------- RoPE

_FREQS: dict = {}


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta ** (arange(half) / half)`` [half] fp32, the
    reference's bits: the exponent in fp32, the power rounded once from
    float64 to fp32 (as XLA's fp32 ``pow`` rounds it; torch's fp32
    ``pow`` is an ulp off for some entries), the reciprocal in fp32.  At
    position 524,287 one ulp of a frequency moves its angle by up to
    0.06 rad.  Made on the CPU once a (head_dim, theta, device)."""
    key = (int(head_dim), float(theta), str(torch.device(device)))
    if key not in _FREQS:
        half = head_dim // 2
        e = torch.arange(half, dtype=torch.float32) / half
        _FREQS[key] = (1.0 / (float(theta) ** e.double()).float()).to(device)
    return _FREQS[key]


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions [*, S] int -> (sin, cos) [*, S, head_dim/2] fp32."""
    freq = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x [..., S, H, D] rotated by half-split pairs (i, i + D/2), not
    interleaved; sin/cos [..., S, D/2].  In fp32 where sin is, cast back
    to ``x``'s dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------ gated MLP

def gated_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                   dtype=torch.float32, device="cuda"):
    """SwiGLU (LLaMA / Mixtral / Qwen-style) FFN, drawn in the
    reference's order: ``wi_gate``, ``wi_up``, ``wo``."""
    def w(shape):
        return lecun_normal(gen, shape, dtype=dtype, device=device)
    return {"wi_gate": w((d_model, d_ff)), "wi_up": w((d_model, d_ff)),
            "wo": w((d_ff, d_model))}


def gated_mlp(p, x, act=torch.nn.functional.silu):
    """``(act(x @ wi_gate) * (x @ wi_up)) @ wo``, weights cast to ``x``'s
    dtype."""
    dt = x.dtype
    g = act(x @ p["wi_gate"].to(dt))
    u = x @ p["wi_up"].to(dt)
    return (g * u) @ p["wo"].to(dt)
