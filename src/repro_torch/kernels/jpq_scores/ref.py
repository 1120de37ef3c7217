"""Plain oracles for jpq_scores: the gather-sum over the codes, forward
and backward, in any float dtype.

The forward sums in split order j = 0..m-1, so on a shared LUT it is
bit-equal to the reference's ``jpq_scores_lut_ref`` and
``core.jpq.logits``.  The backward is the transpose: each split's column
of codes scatters ``dS`` into its bins (``index_add_``, sequential on the
CPU).
"""
from __future__ import annotations

import torch


def jpq_scores_lut_ref(partial, codes):
    """partial [B, m, b], codes [N, m] -> [B, N], summed in split order."""
    codes = codes.long()
    s = partial[:, 0, :][:, codes[:, 0]]
    for j in range(1, codes.shape[1]):
        s = s + partial[:, j, :][:, codes[:, j]]
    return s


def jpq_scores_lut_bwd_ref(dS, codes, b: int):
    """dS [B, N], codes [N, m] -> dP [B, m, b] with
    ``dP[t, j, c] = sum_{i : codes[i, j] = c} dS[t, i]``."""
    codes = codes.long()
    m = codes.shape[1]
    dP = torch.zeros((dS.shape[0], m, b), dtype=dS.dtype, device=dS.device)
    for j in range(m):
        dP[:, j, :].index_add_(1, codes[:, j], dS)
    return dP

