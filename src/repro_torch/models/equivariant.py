"""Self-contained E(3)-equivariant building blocks (no e3nn available),
the reference's ``models/equivariant.py``.

Real orthonormal spherical harmonics up to l_max=2 are represented as
exact monomial polynomials in (x, y, z); coupling ("Gaunt") tensors
  G[l1,l2,l3][m1,m2,m3] = ∫_{S²} Y_{l1 m1} Y_{l2 m2} Y_{l3 m3} dΩ
are computed *exactly* from the closed-form sphere integral of monomials
  ∫ x^a y^b z^c dΩ = 4π (a-1)!!(b-1)!!(c-1)!! / (a+b+c+1)!!   (all even)
so there is no quadrature error and the tensors are true intertwiners —
the equivariance property tests rely on this.  The polynomial part is
the reference's, line for line (numpy float64, so its outputs are the
reference's bits); ``gaunt_tensor`` keeps one copy of each Gaunt tensor
per (path, device, dtype), so no step copies one from the host.

Feature convention: an irrep feature is a dict {l: [..., C, 2l+1]}.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch

LMAX = 2

# ---------------------------------------------------------- polynomials
# poly: dict[(a, b, c)] -> coeff, meaning sum coeff * x^a y^b z^c


def _pmul(p1: dict, p2: dict) -> dict:
    out: dict = {}
    for m1, c1 in p1.items():
        for m2, c2 in p2.items():
            k = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
            out[k] = out.get(k, 0.0) + c1 * c2
    return out


def _dfact(n: int) -> int:
    return 1 if n <= 0 else n * _dfact(n - 2)


def _mono_integral(a: int, b: int, c: int) -> float:
    """∫_{S²} x^a y^b z^c dΩ."""
    if a % 2 or b % 2 or c % 2:
        return 0.0
    num = _dfact(a - 1) * _dfact(b - 1) * _dfact(c - 1)
    return 4.0 * math.pi * num / _dfact(a + b + c + 1)


def _pint(p: dict) -> float:
    return sum(c * _mono_integral(*m) for m, c in p.items())


def _real_sh_polys() -> Dict[int, list]:
    """Orthonormal real SH as monomial polys, restricted to |r|=1."""
    s = math.sqrt
    pi = math.pi
    y0 = [{(0, 0, 0): 0.5 / s(pi)}]
    c1 = s(3.0 / (4 * pi))
    y1 = [{(0, 1, 0): c1},            # m=-1 ~ y
          {(0, 0, 1): c1},            # m=0  ~ z
          {(1, 0, 0): c1}]            # m=+1 ~ x
    c2a = 0.5 * s(15.0 / pi)
    c2b = 0.25 * s(5.0 / pi)
    c2c = 0.25 * s(15.0 / pi)
    y2 = [{(1, 1, 0): c2a},                                   # xy
          {(0, 1, 1): c2a},                                   # yz
          # 3z²-r² as a homogeneous quadratic: 2z² - x² - y²
          {(0, 0, 2): 2 * c2b, (2, 0, 0): -c2b, (0, 2, 0): -c2b},
          {(1, 0, 1): c2a},                                   # zx
          {(2, 0, 0): c2c, (0, 2, 0): -c2c}]                  # x²-y²
    return {0: y0, 1: y1, 2: y2}


_SH_POLYS = _real_sh_polys()


@functools.lru_cache(maxsize=None)
def gaunt(l1: int, l2: int, l3: int) -> np.ndarray:
    """Exact real-Gaunt tensor [2l1+1, 2l2+1, 2l3+1] (float64)."""
    G = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i, p1 in enumerate(_SH_POLYS[l1]):
        for j, p2 in enumerate(_SH_POLYS[l2]):
            for k, p3 in enumerate(_SH_POLYS[l3]):
                G[i, j, k] = _pint(_pmul(_pmul(p1, p2), p3))
    return G


@functools.lru_cache(maxsize=None)
def product_paths(lmax: int = LMAX):
    """All (l1, l2, l3) with non-vanishing Gaunt tensor, l* <= lmax."""
    paths = []
    for l1 in range(lmax + 1):
        for l2 in range(lmax + 1):
            for l3 in range(lmax + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2 and (l1 + l2 + l3) % 2 == 0:
                    if np.abs(gaunt(l1, l2, l3)).max() > 1e-12:
                        paths.append((l1, l2, l3))
    return tuple(paths)


@functools.lru_cache(maxsize=None)
def gaunt_tensor(l1: int, l2: int, l3: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """``gaunt(l1, l2, l3)`` rounded to ``dtype`` on ``device``, made
    once per (path, device, dtype) and shared by every call (read only).
    Made outside inference mode even when first asked for inside it, so
    a later step that takes a gradient may save it."""
    with torch.inference_mode(False):
        return torch.as_tensor(gaunt(l1, l2, l3), dtype=dtype,
                               device=device)


# -------------------------------------------------------- torch kernels

def spherical_harmonics(vec, lmax: int = LMAX, eps: float = 1e-9):
    """Unit-normalised real SH of vectors.

    vec [..., 3] -> {l: [..., 2l+1]} (fp32 for fp32 vectors).
    """
    r = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    u = vec / torch.clamp(r, min=eps)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    s = math.sqrt
    pi = math.pi
    out = {0: torch.full(x.shape + (1,), 0.5 / s(pi), dtype=u.dtype,
                         device=u.device)}
    if lmax >= 1:
        c1 = s(3.0 / (4 * pi))
        out[1] = torch.stack([c1 * y, c1 * z, c1 * x], -1)
    if lmax >= 2:
        c2a, c2b, c2c = 0.5 * s(15 / pi), 0.25 * s(5 / pi), 0.25 * s(15 / pi)
        # homogeneous form (2z²-x²-y², matching _SH_POLYS): |u| is 1 for
        # real directions but 0 for degenerate zero-length edges
        # (self-loops / padding), where the restricted form 3z²-1 would
        # inject a fixed non-equivariant l=2 component
        u2 = x * x + y * y + z * z
        out[2] = torch.stack([
            c2a * x * y, c2a * y * z,
            c2b * (3 * z * z - u2),
            c2a * z * x, c2c * (x * x - y * y)], -1)
    return out


def cg_product(u, v, l1: int, l2: int, l3: int):
    """Equivariant bilinear product via the exact Gaunt intertwiner, the
    reference's ``einsum("...a,...b,abc->...c", u, v, G)``.

    u [..., 2l1+1], v [..., 2l2+1] -> [..., 2l3+1], broadcasting the
    leading dimensions.  Where ``v`` is one row for all of ``u``'s
    channels (v [..., 1, 2l2+1], an edge's Y^l2 against [..., C, 2l1+1]
    features) it is folded into G first (``[..., 2l1+1, 2l3+1]``) and u
    multiplies that, so no ``[..., C, 2l1+1, 2l2+1]`` outer product is
    made; otherwise the outer product times G.  The order of the fp32
    sums differs from XLA's either way.
    """
    G = gaunt_tensor(l1, l2, l3, u.device, u.dtype)
    if v.dim() >= 2 and v.shape[-2] == 1 and u.shape[-2] != 1:
        vg = torch.einsum("...b,abc->...ac", v[..., 0, :], G)
        return torch.matmul(u, vg)
    outer = (u[..., :, None] * v[..., None, :]).flatten(-2)
    return outer @ G.reshape(-1, G.shape[-1])


def bessel_rbf(r, n_rbf: int = 8, r_cut: float = 1.0):
    """sin(nπr/rc)/r radial basis with a smooth polynomial cutoff.

    r [...,] -> [..., n_rbf].
    """
    rr = torch.clamp(r / r_cut, 1e-5, 1.0)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = torch.sin(math.pi * n * rr[..., None]) / rr[..., None]
    # smooth cutoff envelope (p=6 polynomial, PhysNet-style)
    p = 6.0
    env = (1.0 - (p + 1) * (p + 2) / 2 * rr ** p
           + p * (p + 2) * rr ** (p + 1)
           - p * (p + 1) / 2 * rr ** (p + 2))
    return basis * env[..., None]
