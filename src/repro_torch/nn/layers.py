"""Linear layers and plain MLP towers, functional over tensor dicts.

Weights keep the reference layout ``w [d_in, d_out]`` (``y = x @ w + b``),
so parameters bridge across without transposes.
"""
from __future__ import annotations

import math

import torch


def lecun_normal(gen: torch.Generator, shape, *, dtype=torch.float32,
                 device="cuda"):
    """Truncated normal on [-2, 2] scaled by sqrt(1 / fan_in), fan_in the
    second-to-last dim — the reference's ``nn.lecun_normal``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (math.sqrt(1.0 / max(1.0, fan_in)) * t).to(dtype)


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


def mlp(p, x, *, act=torch.relu, final_act: bool = False):
    """ReLU between layers, none after the last unless ``final_act``."""
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = linear(lp, x)
        if i < n - 1 or final_act:
            x = act(x)
    return x
