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

import math
import struct
from typing import List

import numpy as np
import torch

from .flush import flush as f
from .flush import fma

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


# -- K4's program, in XLA's order (ROADMAP C2) --
#
# Read from the reference's compiled ``_block_step_fn`` and
# ``_banded_sgns_loss_and_grads`` on the CPU (optimized HLO, LLVM IR and
# machine code at C 128, W 3, K 5, B 1 and 8, D 8, 50 and 128). Other
# programs fuse their products elsewhere (C13), so only K4's plain
# version uses these.


def _chain(p: torch.Tensor) -> torch.Tensor:
    """Sum of the last dimension from +0, one element after the other,
    every add flushed."""
    acc = torch.zeros_like(p[..., 0])
    for d in range(p.shape[-1]):
        acc = f(acc + p[..., d])
    return acc


def row_sum(prod: torch.Tensor) -> torch.Tensor:
    """XLA's reduce of the last dimension: from +0, one element after the
    other; a dimension longer than 32 is cut into windows of 32 (the tree
    reduction rewriter, zero pads split between both ends), each window
    summed so, then the windows so. Every add flushed."""
    D = prod.shape[-1]
    if D <= 32:
        return _chain(prod)
    n = -(-D // 32)
    lo = (n * 32 - D) // 2
    wide = torch.nn.functional.pad(prod, (lo, n * 32 - D - lo))
    return _chain(_chain(wide.reshape(wide.shape[:-1] + (n, 32))))


def fma_sum(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``(a * b).sum(dim)`` (broadcasting) as one fused multiply-add after
    the other, from +0, in index order: Eigen's contraction over an outer
    dimension, and XLA's column-major GEMV."""
    a, b = torch.broadcast_tensors(a, b)
    acc = torch.zeros_like(a.select(dim, 0))
    for i in range(a.shape[dim]):
        acc = fma(a.select(dim, i), b.select(dim, i), acc)
    return acc


def _lanes(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """``x[..., :m]`` as [..., m / n, n]: element l + n i at [..., i, l]."""
    return x[..., :m].reshape(x.shape[:-1] + (m // n, n))


def gemv_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)`` as XLA's tiled row-major GEMV forms it (a dot
    of one row a batch): eight lanes, lane l a fused chain over elements
    l, l + 8, ... from +0; the lanes halved pairwise (l + l + 4, then +
    2, then + 1); the elements past the last 8 a fused chain from +0,
    added last."""
    a, b = torch.broadcast_tensors(f(a), f(b))
    D = a.shape[-1]
    m = D - D % 8
    head = torch.zeros_like(a[..., 0])
    if m:
        a8, b8 = _lanes(a, m, 8), _lanes(b, m, 8)
        lanes = torch.zeros_like(a8[..., 0, :])
        for i in range(m // 8):
            lanes = fma(a8[..., i, :], b8[..., i, :], lanes)
        while lanes.shape[-1] > 1:
            half = lanes.shape[-1] // 2
            lanes = f(lanes[..., :half] + lanes[..., half:])
        head = lanes[..., 0]
    tail = torch.zeros_like(head)
    for d in range(m, D):
        tail = fma(a[..., d], b[..., d], tail)
    return f(head + tail)


def eigen_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)`` as Eigen's contraction forms it where both
    operands contract their inner dimension: four lanes, lane l a fused
    chain over elements l, l + 4, ... from its first product; then
    ``(l0 + l1) + (l2 + l3)``; the elements past the last 4 multiplied
    and added one after the other, then added. Under 4 elements one
    fused chain."""
    a, b = torch.broadcast_tensors(f(a), f(b))
    D = a.shape[-1]
    m = D - D % 4
    if not m:
        return fma_sum(a, b, a.dim() - 1)
    a4, b4 = _lanes(a, m, 4), _lanes(b, m, 4)
    lanes = f(a4[..., 0, :] * b4[..., 0, :])
    for i in range(1, m // 4):
        lanes = fma(a4[..., i, :], b4[..., i, :], lanes)
    acc = f(f(lanes[..., 0] + lanes[..., 1])
            + f(lanes[..., 2] + lanes[..., 3]))
    if m == D:
        return acc
    tail = f(a[..., m] * b[..., m])
    for d in range(m + 1, D):
        tail = f(tail + f(a[..., d] * b[..., d]))
    return f(acc + tail)


# XLA's log1p on the CPU (read from the LLVM IR of K4's programs): below
# sqrt(2) - 1 in magnitude a Cephes rational, x + (-x^2 / 2 + x^3 P/Q),
# its Horner steps fused; above it XLA's log of 1 + x.
def _bits32(*bits) -> tuple:
    return tuple(float(b) for b in np.array(bits, np.uint32).view(np.float32))


_LOG1P_Q = _bits32(0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                   0x43586D8A, 0x42707982)
_LOG1P_P = _bits32(0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                   0x4273CC76, 0x426473AD, 0x41A05101)
_LOG1P_SMALL = _bits32(0x3ED413CD)[0]
_FLT_MIN = _bits32(0x00800000)[0]  # the smallest normal float32


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` as the reference's XLA compiles it on the CPU, for
    finite ``x > -1``, every operation flushed."""
    from .logreg import log  # logreg imports this module
    x = f(x)
    zero = f(x * 0.0)  # the Horner chains start from 0 * x
    q = f(zero + 1.0)
    for k in _LOG1P_Q:
        q = fma(q, x, torch.full_like(x, k))
    p = f(zero + _LOG1P_P[0])
    for k in _LOG1P_P[1:]:
        p = fma(p, x, torch.full_like(x, k))
    x2 = f(x * x)
    small = f(x + fma(x2, torch.full_like(x, -0.5),
                      f(f(x * x2) * f(p / q))))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(f(x + 1.0)))


def sgns_xent(raw: torch.Tensor, weight: torch.Tensor,
              label: torch.Tensor):
    """(d/d raw of ``xent(clip(raw), label) * weight``, ``xent(clip(raw),
    label)``) element by element as XLA forms them in K4's programs
    (``label`` 1 or 0 an element), ``e = exp(-|x|)`` shared (XLA's exp).
    The cotangent: the log1p term's ``weight / (1 + e)`` times ``e``,
    its sign from a pair of selects; then ``- weight`` (label 1; label
    0 adds -0, the identity); then ``weight * relu'(x)`` fused into that
    sum; then the clip's upper and lower factors. The term:
    ``(max(x, 0) - x * label) + log1p(e)`` (XLA's log1p)."""
    from .logreg import exp  # logreg imports this module
    x = torch.clamp(raw, -MAX_EXP, MAX_EXP)
    zero = torch.zeros_like(x)
    e = exp(-x.abs())
    m = f(f(weight / f(e + 1.0)) * e)
    ge = x >= 0
    acc = f(torch.where(ge, -m, zero) - torch.where(ge, zero, -m))
    acc = torch.where(label > 0, f(acc - weight), acc)
    relu = torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))
    acc = fma(weight, relu, acc)
    lo = torch.where(raw > -MAX_EXP, 1.0,
                     torch.where(raw == -MAX_EXP, 0.5, 0.0))
    m6 = torch.clamp(raw, min=-MAX_EXP)
    hi = torch.where(m6 < MAX_EXP, 1.0,
                     torch.where(m6 == MAX_EXP, 0.5, 0.0))
    terms = f(f(torch.clamp(x, min=0.0) - f(x * label)) + log1p(e))
    return f(f(acc * hi) * lo), terms


def _halve(lanes: torch.Tensor) -> torch.Tensor:
    """The last dimension (a power of two) summed lane l + l + n/2 until
    one is left: a vector reduction's tree."""
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = f(lanes[..., :half] + lanes[..., half:])
    return lanes[..., 0]


def _windows(t: torch.Tensor) -> torch.Tensor:
    """A [32 n, cols] block of terms summed in windows of 32 rows, each as
    LLVM vectorizes XLA's window (8 lanes over its rows from +0 in lane 0
    and -0 in the others, a row's columns one after the other, then the
    lanes' tree), the windows then one after the other from +0."""
    n, cols = t.shape[0] // 32, t.shape[1]
    rows = t.reshape(n, 4, 8, cols)
    lanes = torch.full((n, 8), -0.0, dtype=t.dtype, device=t.device)
    lanes[:, 0] = 0.0
    for i in range(4):
        for k in range(cols):
            lanes = f(lanes + rows[:, i, :, k])
    return _chain(_halve(lanes))


def sgns_loss(pos_terms: torch.Tensor, neg_terms: torch.Tensor,
              pmask: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """K4's loss ``sum(xent(pos, 1) * pmask) + sum(xent(neg, 0) *
    nvalid)`` from the terms (``sgns_xent``; ``neg_terms`` [C/B, B, K])
    as the reference's programs sum it where they were read (C a
    multiple of 32 up to 1024, B 1 or 8):
    the positive terms' products in ``_windows``; at B = 1 the negative
    ones too; at B = 8 a lane a center, each lane the weighted terms
    fused in one after the other, lane 0 from the running total, then
    the lanes' tree, block after block; the two sums then added. Other
    shapes sum in torch's order."""
    C = pos_terms.shape[0]
    nb, B, K = neg_terms.shape
    pos_terms = f(pos_terms * pmask)
    nw = nvalid.reshape(nb, B, 1)
    if C % 32 or C > 1024 or B not in (1, 8):
        return f(f(pos_terms.sum()) + f(f(neg_terms * nw).sum()))
    pos = _windows(pos_terms)
    if B == 1:
        return f(pos + _windows(f(neg_terms * nw).reshape(C, K)))
    # Lanes 1-7 need no running total: their chains and their part of
    # the tree ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7)) run at
    # once; lane 0 then block after block.
    w = nw.expand_as(neg_terms)
    lanes = torch.full((nb, B), -0.0, dtype=pos.dtype, device=pos.device)
    for k in range(K):
        lanes = fma(w[:, :, k], neg_terms[:, :, k], lanes)
    right = f(f(lanes[:, 1] + lanes[:, 5]) + f(lanes[:, 3] + lanes[:, 7]))
    mid = f(lanes[:, 2] + lanes[:, 6])
    # The running total, block after block, in host floats (a few
    # hundred dependent operations: tensor launches would cost more).
    wk, tk = w[:, 0].tolist(), neg_terms[:, 0].tolist()
    l4, mid, right = lanes[:, 4].tolist(), mid.tolist(), right.tolist()
    total = 0.0
    for n in range(nb):
        lane0 = total
        for k in range(K):
            lane0 = _fma32(wk[n][k], tk[n][k], lane0)
        total = _fma32(1.0, _fma32(1.0, _fma32(1.0, lane0, l4[n]),
                                   mid[n]), right[n])
    return f(pos + total)


def _fma32(a: float, b: float, c: float) -> float:
    """``a * b + c`` of float32 values in Python floats, rounded once to
    float32 and flushed (``flush.fma`` for one element): the product is
    exact in float64, the sum's rounding error (TwoSum) decides a round
    to odd, after which the rounding to float32 is correct."""
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    if err and not struct.unpack("<q", struct.pack("<d", s))[0] & 1:
        s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    r = float(np.float32(s))
    return math.copysign(0.0, r) if abs(r) < _FLT_MIN else r


def band_sum_fused(coef: torch.Tensor, vec: torch.Tensor, W: int
                   ) -> torch.Tensor:
    """``band_sum`` as ``_banded_sgns_loss_and_grads``' own program forms
    it at rows wider than 8 floats (the block step's form is
    ``band_sum``): offset 2W-1's product rounded, then each lower
    offset's product fused into the sum. The fusion runs in 8 row
    partitions, and the last one is compiled apart: there offset 2W-1's
    product is fused into offset 2W-2's rounded one, and offset 0's
    product is rounded, then added."""
    C = coef.shape[0]
    R = C + 2 * W
    offs = offsets(W)
    vec = f(vec)
    shape = (C,) + (1,) * (vec.dim() - 1)
    top = 2 * W - 1

    def rows(j):
        return slice(W + offs[j], W + offs[j] + C)

    def coef_of(j):
        return coef[:, j].reshape(shape).expand_as(vec)

    pads = []
    for j in range(2 * W):
        pad = vec.new_zeros((R,) + tuple(vec.shape[1:]))
        pad[rows(j)] = f(coef_of(j) * vec)
        pads.append(pad)

    def chain(acc, js, round_last):
        for j in js:
            nxt = f(acc + 0.0)
            nxt[rows(j)] = f(acc[rows(j)] + pads[j][rows(j)]) \
                if round_last and j == 0 \
                else fma(coef_of(j), vec, acc[rows(j)])
            acc = nxt
        return acc

    acc = chain(pads[top], range(top - 1, -1, -1), False)
    start = 7 * -(-R // 8)
    if start < R:
        both = f(pads[top] + pads[top - 1])
        r0, r1 = W + offs[top], W + offs[top - 1] + C
        both[r0:r1] = fma(coef_of(top)[:r1 - r0], vec[:r1 - r0],
                          pads[top - 1][r0:r1])
        acc[start:] = chain(both, range(top - 2, -1, -1), True)[start:]
    return acc
