"""RecJPQ embedding: codebook of sub-item centroid ids + centroid tensor.

The embedding table ``[n_items, d]`` is replaced by
  codes      [n_items, m] uint8 (int32 when b > 256) — frozen, a buffer
  centroids  [m, b, d//m] float                      — trainable
Item i's embedding = concat_j centroids[j, codes[i, j]].

``p`` is a dict ``{"codes": ..., "centroids": ...}`` of tensors, the
port's counterpart of the reference's parameter subtree.

On a ``"model"`` mesh (``rows`` = the catalogue's row count, the codes
held whole or as this rank's block), ``lookup`` gathers the ids' code
rows across the ranks and ``logits`` scores this rank's rows only.

``use_kernel=True`` sends ``logits`` through the jpq_scores kernels and
``lookup`` through the jpq_lookup kernels (forward and backward, so the
model trains through them); on a CPU tensor they run their plain
versions.  ``use_kernel=False`` keeps the PyTorch gathers; ``lookup``'s
centroid gather then reads the flat ``[m * b, dk]`` view at ``j * b +
code``, so where the centroids take a gradient it comes from the
embedding_bag backward kernel (``kernels/embedding_bag/ops.gather``).
"""
from __future__ import annotations

import torch

from repro_torch import dist as _dist
from repro_torch.core import sharded as _sharded
from repro_torch.kernels.embedding_bag import ops as _bag


def init(gen: torch.Generator, n_items: int, d: int, m: int, b: int = 256,
         *, codes=None, dtype=torch.float32, init_scale: float | None = None,
         device="cuda"):
    """Random codes (unless given) and normal centroids, drawn from
    ``gen`` (a generator on ``device``)."""
    if d % m:
        raise ValueError(f"embedding dim {d} must be divisible by code "
                         f"length {m}")
    code_dtype = torch.uint8 if b <= 256 else torch.int32
    if codes is None:
        codes = torch.randint(0, b, (n_items, m), generator=gen,
                              device=device, dtype=torch.int32)
    codes = torch.as_tensor(codes, device=device).to(code_dtype)
    if tuple(codes.shape) != (n_items, m):
        raise ValueError(f"codes shape {tuple(codes.shape)} != "
                         f"{(n_items, m)}")
    scale = init_scale if init_scale is not None else d ** -0.5
    cent = scale * torch.randn((m, b, d // m), generator=gen, device=device)
    return {"codes": codes.contiguous(), "centroids": cent.to(dtype)}


def lookup(p, ids, *, use_kernel: bool = False, rows=None):
    """ids int[...] -> embeddings [..., d].  ``rows`` is the catalogue's
    row count: where ``p["codes"]`` holds only this rank's block of them
    (a ``"model"`` mesh), the ids' code rows are first gathered exactly
    across the ranks (``core/sharded.take_rows``), and the centroid
    gather (the jpq_lookup kernels with ``use_kernel``) runs on them."""
    cent = p["centroids"]
    codes = p["codes"]
    if rows is not None and codes.shape[0] != rows:
        codes = code_rows(codes, ids, rows)                # [..., m]
        if not use_kernel:
            return lookup_codes(cent, codes)
        from repro_torch.kernels.jpq_lookup import ops as kops
        flat = codes.reshape(-1, codes.shape[-1])
        at = torch.arange(flat.shape[0], dtype=torch.int32,
                          device=flat.device)
        return kops.jpq_lookup(at, flat, cent).reshape(*ids.shape, -1)
    if use_kernel:
        from repro_torch.kernels.jpq_lookup import ops as kops
        return kops.jpq_lookup(ids, codes, cent)
    return lookup_codes(cent, codes[ids.long()])


def code_rows(codes, ids, rows=None):
    """The code rows ``codes[ids]`` [..., m] of a codes table held whole
    or as this rank's block of a ``rows``-row catalogue (gathered across
    the ranks, exactly)."""
    if rows is None or codes.shape[0] == rows:
        return codes[ids.long()]
    return _sharded.take_rows(codes, ids, rows=rows)


def lookup_codes(cent, codes):
    """centroids [m, b, dk], the code rows of some items [..., m] ->
    their embeddings [..., d]: ``lookup``'s centroid gather."""
    m, b, dk = cent.shape
    flat = codes.long() + b * torch.arange(m, device=cent.device)  # j*b+code
    emb = _bag.gather(cent.reshape(m * b, dk), flat)      # [..., m, dk]
    return emb.reshape(*codes.shape[:-1], -1)


def partial_scores(p, h):
    """h [..., d] -> P [..., m, b] partial-score lookup table (fp32)."""
    cent = p["centroids"]
    m, b, dk = cent.shape
    hs = h.reshape(*h.shape[:-1], m, dk)
    return torch.einsum("...mk,mbk->...mb", hs.float(), cent.float())


def logits(p, h, *, use_kernel: bool = False, rows=None):
    """h [..., d] -> scores [..., n_items], summed in split order.  Where
    the ambient mesh splits the ``rows``-row catalogue over ``"model"``
    the scores are this rank's column block (its rows of the codes, held
    whole or as its block): ``h`` and the centroids enter the split
    region through ``dist.copy_to_model``, so their gradients from the
    ranks' columns are summed."""
    codes = p["codes"]
    if rows is not None:
        mesh, _, codes = _sharded._split(codes, rows)
        if mesh is not None:
            h = _dist.copy_to_model(h, mesh)
            p = {"centroids": _dist.copy_to_model(p["centroids"], mesh)}
    part = partial_scores(p, h)
    if use_kernel:
        from repro_torch.kernels.jpq_scores.ops import JPQScores
        m, b = part.shape[-2:]
        flat = part.reshape(-1, m, b).contiguous()
        return JPQScores.apply(flat, codes).reshape(*h.shape[:-1], -1)
    codes = codes.long()
    s = part[..., 0, :][..., codes[:, 0]]
    for j in range(1, codes.shape[1]):
        s = s + part[..., j, :][..., codes[:, j]]
    return s


def reconstruct_table(p):
    """Materialise the full [n_items, d] table (tests / tiny catalogues)."""
    n = p["codes"].shape[0]
    return lookup(p, torch.arange(n, device=p["codes"].device))


def embedding_param_count(n_items: int, d: int, m: int, b: int = 256):
    """(compressed float params, full-table float params, codebook ints)."""
    return b * d, n_items * d, n_items * m
