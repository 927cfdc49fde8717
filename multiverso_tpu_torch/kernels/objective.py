"""Pieces shared by the plain versions of the word2vec step kernels
(K4-K8): the window offsets and the clipped sigmoid cross-entropy with
its gradient formed as JAX's autodiff forms it (ROADMAP C9). The CUDA
kernels carry the same functions in ``csrc/w2v_common.cuh``.
"""

from __future__ import annotations

from typing import List

import torch

MAX_EXP = 6.0  # word2vec.c's sigmoid-table range (model.py _MAX_EXP)


def offsets(W: int) -> List[int]:
    """The 2W window offsets -W..-1, 1..W (column j of a pair mask)."""
    return [o for o in range(-W, W + 1) if o != 0]


def clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of ``minimum(6, maximum(-6, x))`` as JAX differentiates it
    (ties split the gradient in halves)."""
    one, half, zero = (torch.tensor(v, dtype=x.dtype, device=x.device)
                       for v in (1.0, 0.5, 0.0))
    lo = torch.where(x > -MAX_EXP, one, torch.where(x == -MAX_EXP, half,
                                                    zero))
    m = torch.clamp(x, min=-MAX_EXP)
    hi = torch.where(m < MAX_EXP, one, torch.where(m == MAX_EXP, half,
                                                   zero))
    return lo * hi


def xent(x: torch.Tensor, y) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (model.py
    ``_sigmoid_xent``); ``y`` a float or a tensor of labels like ``x``."""
    return torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


def xent_grad(x: torch.Tensor, y) -> torch.Tensor:
    """d xent / dx as JAX's autodiff forms it: 1/2 for ``max(x, 0)`` at
    x == 0 and d|x|/dx = 1 at x == 0, so the gradient at exactly 0 is
    -y (not sigmoid(0) - y) — which is what every logit against the
    zero-initialized output table gives."""
    e = torch.exp(-x.abs())
    relu = torch.where(x > 0, torch.ones_like(x),
                       torch.where(x == 0, torch.full_like(x, 0.5),
                                   torch.zeros_like(x)))
    sgn = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    return relu - y - sgn * (e / (1.0 + e))


def band_sum(coef: torch.Tensor, vec: torch.Tensor, W: int
             ) -> torch.Tensor:
    """The band pass of the banded objectives: ``out[c + W + off_j] +=
    coef[c, j] * vec[c]`` for every center c and offset j — the gradient
    of the C+2W band rows from per-(center, offset) coefficients.
    ``coef`` [C, 2W], ``vec`` [C, ...]; returns [C+2W, ...]."""
    C = coef.shape[0]
    out = vec.new_zeros((C + 2 * W,) + tuple(vec.shape[1:]))
    shape = (C,) + (1,) * (vec.dim() - 1)
    for j, off in enumerate(offsets(W)):
        out[W + off:W + off + C] += coef[:, j].reshape(shape) * vec
    return out
