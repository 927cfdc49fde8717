"""Float32 subnormals flushed as the reference flushes them.

The reference's jitted programs run with flush-to-zero and
denormals-are-zero on the CPU (XLA sets both around every computation;
a TPU keeps no subnormals either): a float32 operation reads a
subnormal input as a zero of its sign and writes a subnormal result as
a zero of its sign. Gathers, copies and negations move bits and flush
nothing. The card's kernels do the same through ``-ftz=true``
(``kernels/build.py``), whose ``.ftz`` instructions flush inputs and
results alike. The plain versions of the row and dense update paths,
which are torch on both devices, flush through this module:
``flush`` after every float operation, on its inputs and its result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: The largest float32 subnormal: ``|x| <= SUBNORMAL_MAX`` is zero or
#: subnormal.
SUBNORMAL_MAX = float(np.float32(2.0 ** -126 - 2.0 ** -149))
#: Below this magnitude a nonzero float32 need not be a multiple of
#: 2^-126 (2^-126 is the spacing of floats at 2^-103).
_EXACT_FLOOR = 2.0 ** -103


def flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every float32 subnormal replaced by a zero of its sign
    (two passes; tensors of other dtypes are returned as they are)."""
    if x.dtype != torch.float32:
        return x
    return torch.copysign(F.hardshrink(x, SUBNORMAL_MAX), x)


def flush_(x: torch.Tensor) -> torch.Tensor:
    """``flush`` in place."""
    if x.dtype == torch.float32:
        torch.copysign(F.hardshrink(x, SUBNORMAL_MAX), x, out=x)
    return x


def plus_zero(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every float32 zero and subnormal replaced by +0 (one
    pass): what ``x + (+0)`` gives under denormals-are-zero, and ``x -
    z`` for a zero ``z`` of ``x``'s sign."""
    return F.hardshrink(x, SUBNORMAL_MAX)


def add_(data: torch.Tensor, delta: torch.Tensor,
         sign: int = 1) -> torch.Tensor:
    """``data += sign * delta`` (``sign`` 1 or -1) in place, flushed as
    the reference's elementwise add (or subtract) flushes it."""
    flush_(data)
    data.add_(flush(delta), alpha=sign)
    return flush_(data)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once, as a fused multiply-add
    (the card's ``__fmaf_rn``; the reference's XLA where it contracts the
    product into the add): the operands and the result flushed, the
    product neither rounded nor flushed. The product of two float32s is
    exact in float64; the float64 sum's rounding error (TwoSum) decides a
    round to odd, after which the one rounding to float32 is correct
    (53 >= 24 + 2 bits). Plain float64 then float32 would round twice."""
    a, b, c = flush(a), flush(b), flush(c)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return flush(s.float())


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the card's
    ``__fsqrt_rn``, the reference's ``vsqrtss``), flushed: taken in
    float64 and rounded once (53 >= 2 * 24 + 2 bits: the double rounding
    is innocuous); ``torch.sqrt`` of a float32 CPU tensor is not
    correctly rounded for some inputs."""
    return flush(torch.sqrt(flush(x).double()).float())


def _inexact(x: torch.Tensor) -> torch.Tensor:
    """Where a float32 is nonzero and below 2^-103 in magnitude: a sum
    of such values can be subnormal; a sum of the others cannot."""
    return (x != 0) & (x.abs() < _EXACT_FLOOR)


def add_rows(table: torch.Tensor, rows: torch.Tensor,
             src: torch.Tensor) -> None:
    """``table[rows[i]] += src[i]`` in place, in position order, each add
    flushed on its inputs and its result, as the reference's scatter-add
    takes repeated rows one after another. ``rows`` int64 in range.

    Where no table element it reads and no source element is nonzero
    below 2^-103, every term and every partial sum is a multiple of
    2^-126, so no add meets a subnormal and ``index_add_`` (sequential
    in position order) gives the same bits. Otherwise the rows are
    added occurrence by occurrence: the i-th occurrence of every row at
    once (this checks on the host; it is a plain version)."""
    if rows.numel() == 0:
        return
    src = flush(src)
    if not bool(_inexact(src).any()) and \
            not bool(_inexact(table.index_select(0, rows)).any()):
        table.index_add_(0, rows, src)
        return
    keys, order = torch.sort(rows, stable=True)
    n = keys.numel()
    at = torch.arange(n, device=rows.device)
    heads = torch.ones(n, dtype=torch.bool, device=rows.device)
    heads[1:] = keys[1:] != keys[:-1]
    start = torch.cummax(torch.where(heads, at, torch.zeros_like(at)),
                         0).values
    rank = torch.empty_like(at)
    rank[order] = at - start
    for r in range(int(rank.max()) + 1):
        pick = rank == r
        rr = rows[pick]
        summed = flush(table.index_select(0, rr)) + src[pick]
        table.index_copy_(0, rr, flush(summed))
