"""Public wrappers for jpq_scores: full-catalogue scores through the codes,
differentiable in the LUT.

Chosen by where the LUT lies:
  a CUDA tensor - the hand-written Hopper kernels (``csrc/jpq_scores.cu``),
                  forward and a deterministic backward
  a CPU tensor  - their plain PyTorch versions (``ref``)
There is no fallback to the plain version on the card.  ``JPQScores``
carries the gradient to the LUT only (the codes are frozen ints);
``core.jpq.logits`` builds the LUT with ``partial_scores`` and autograd
takes the gradient on through that einsum to ``h`` and the centroids.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.jpq_scores import cuda as _cuda
from repro_torch.kernels.jpq_scores import ref as _ref


def jpq_scores_lut(partial, codes):
    """partial [T, m, b], codes [N, m] -> scores [T, N]."""
    if partial.is_cuda:
        return _cuda.jpq_scores(partial.contiguous(), codes)
    return _ref.jpq_scores_lut_ref(partial, codes)


def jpq_scores_lut_bwd(dS, codes, b: int):
    """dS [T, N], codes [N, m] -> dP [T, m, b]."""
    if dS.is_cuda:
        return _cuda.jpq_scores_bwd(dS.contiguous(), codes, b)
    return _ref.jpq_scores_lut_bwd_ref(dS, codes, b)


class JPQScores(torch.autograd.Function):
    """scores = jpq_scores_lut(partial, codes), with dP from the backward
    kernel.  The output is not saved, so a caller may write into it."""

    @staticmethod
    def forward(ctx, partial, codes):
        ctx.save_for_backward(codes)
        ctx.b = partial.shape[-1]
        return jpq_scores_lut(partial, codes)

    @staticmethod
    def backward(ctx, dS):
        (codes,) = ctx.saved_tensors
        return jpq_scores_lut_bwd(dS, codes, ctx.b), None

