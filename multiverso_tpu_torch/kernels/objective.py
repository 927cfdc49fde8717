"""Pieces shared by the plain versions of the word2vec step kernels
(K4-K10): the window offsets and the clipped sigmoid cross-entropy with
its gradient formed as JAX's autodiff forms it (ROADMAP C9). The CUDA
kernels carry the same functions in ``csrc/w2v_common.cuh``.

Every arithmetic operation of these plain versions flushes float32
subnormals on its inputs and its result (``flush.flush``), as the
reference's XLA does on the CPU and the kernels do through
``-ftz=true`` (ROADMAP C12); a clip, a ``where`` or a negation selects
or moves a value and flushes nothing. A dot product (``dot``: the
reference's ``sum`` of products, its ``einsum``) flushes its inputs,
each product and its result; its partial sums, taken in torch's order,
are not flushed one by one.
"""

from __future__ import annotations

from typing import List

import torch

from .flush import flush as f

MAX_EXP = 6.0  # word2vec.c's sigmoid-table range (model.py _MAX_EXP)


def offsets(W: int) -> List[int]:
    """The 2W window offsets -W..-1, 1..W (column j of a pair mask)."""
    return [o for o in range(-W, W + 1) if o != 0]


def dot(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``(a * b).sum(dim)`` (broadcasting) with the products and the sum
    flushed: an ``einsum`` of the reference as XLA's CPU runtime forms
    it, where a product below 2^-126 counts as zero. A sum starts from
    +0, so a sum of zeros is +0; over a dimension of one element there
    is no sum (XLA folds it away), and the product keeps its sign."""
    prod = f(a * b)
    if prod.shape[dim] == 1:
        return prod.squeeze(dim)
    return f(prod.sum(dim))


def sum_terms(terms) -> torch.Tensor:
    """``terms[-1] + ... + terms[0]``, each add flushed: the cotangents
    of an input used once a term, summed as JAX's backward pass sums
    them (the last use's first), with no zero to start from — a sum of
    zeros is -0 only where every term is."""
    acc = terms[-1]
    for t in reversed(terms[:-1]):
        acc = f(acc + t)
    return acc


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
    return f(f(torch.clamp(x, min=0) - f(x * y))
             + f(torch.log1p(f(torch.exp(-x.abs())))))


def xent_grad(x: torch.Tensor, y) -> torch.Tensor:
    """d xent / dx as JAX's autodiff forms it: 1/2 for ``max(x, 0)`` at
    x == 0 and d|x|/dx = 1 at x == 0, so the gradient at exactly 0 is
    -y (not sigmoid(0) - y) — which is what every logit against the
    zero-initialized output table gives."""
    e = f(torch.exp(-x.abs()))
    relu = torch.where(x > 0, torch.ones_like(x),
                       torch.where(x == 0, torch.full_like(x, 0.5),
                                   torch.zeros_like(x)))
    sgn = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    return f(f(relu - y) - f(sgn * f(e / f(1.0 + e))))


def masked_grad(x: torch.Tensor, raw: torch.Tensor, y,
                weight) -> torch.Tensor:
    """d/d raw of ``xent(clip(raw), y) * weight``, as JAX's autodiff forms
    it: the weight enters the cotangent first, and the cotangent is a
    sum of signed zeros with a +0 among them where the weight is zero
    (hence ``+ 0.0``: +0, never -0); then the clip's factor."""
    return f(f(f(xent_grad(x, y) * weight) + 0.0) * clip_grad(raw))


def band_sum(coef: torch.Tensor, vec: torch.Tensor, W: int
             ) -> torch.Tensor:
    """The band pass of the banded objectives: ``out[c + W + off_j] +=
    coef[c, j] * vec[c]`` for every center c and offset j — the gradient
    of the C+2W band rows from per-(center, offset) coefficients, as the
    reference's backward pass forms it: each offset's products padded
    with +0 to the band (a slice's transpose), the pads summed
    (``sum_terms``), every product and sum flushed. ``coef`` [C, 2W],
    ``vec`` [C, ...] (flushed); returns [C+2W, ...]."""
    C = coef.shape[0]
    shape = (C,) + (1,) * (vec.dim() - 1)
    pads = []
    for j, off in enumerate(offsets(W)):
        pad = vec.new_zeros((C + 2 * W,) + tuple(vec.shape[1:]))
        pad[W + off:W + off + C] = f(coef[:, j].reshape(shape) * vec)
        pads.append(pad)
    return sum_terms(pads)
