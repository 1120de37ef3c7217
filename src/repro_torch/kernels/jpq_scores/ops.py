"""Public wrappers for jpq_scores: full-catalogue scores through the codes,
differentiable in the LUT.

``jpq_scores(h, centroids, codes)`` is the reference's public entry: the
LUT from the query vectors, then the same kernels.  Chosen by where the
LUT lies:
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


def jpq_scores(h, centroids, codes):
    """h [..., d], centroids [m, b, dk], codes [N, m] -> [..., N] fp32, the
    reference's public ``jpq_scores``: the fp32 LUT (``ref.lut_ref``),
    then ``JPQScores`` (the card kernel on CUDA tensors, its plain
    version on CPU ones, chosen by the device alone; differentiable in
    ``h`` and the centroids).  On one device it equals
    ``ref.jpq_scores_ref`` bit for bit."""
    out = JPQScores.apply(_ref.lut_ref(h, centroids).contiguous(), codes)
    return out.reshape(*h.shape[:-1], codes.shape[0])
