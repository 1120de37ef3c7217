"""PyTorch/CUDA port of the RecJPQ system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports
neither it nor ``jax``.  Public functions keep the reference's layouts
(LUT ``P [B, m, b]``, codes ``[N, m]``, centroids ``[m, b, dk]``,
linear weights ``w [d_in, d_out]``) so the parity tests compare like
with like.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels under ``csrc/`` run on a
CUDA tensor, their plain PyTorch versions on a CPU tensor.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            f"is False — pass device='cpu' (--device cpu) to run the "
            f"plain PyTorch path")
    return dev


def fp32_matmuls() -> None:
    """Keep float32 products in full float32 on the card: TF32 keeps
    about three decimal digits and would break parity with the
    reference's float32 LUT einsum and user tower."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
