"""K11 sparse_lr_forward and K12 sparse_lr_apply: the sparse logistic
regression step.

Together they replace ``make_sparse_step``
(``multiverso_tpu/models/logreg/objective.py:89-116``) as fused into
``LocalModel.fused`` (``multiverso_tpu/models/logreg/model.py:54-59``),
``PSModel.update`` (``:144-163``, with ``_scale``/``_apply_local``/
``_gather_rows`` ``:123-127``) and ``FTRLModel.fused`` (``:211-223``).

- ``sparse_lr_forward`` (K11) scores a padded batch ``keys``/``values``
  ``[B, K]`` against ``W [R, C]`` — ``w``, or FTRL's ``weights_of(z, n)``
  formed for the gathered rows only — and returns ``pred``, ``diff =
  (pred - onehot) * weight``, the per-sample loss times its weight and
  the per-sample hit. ``w[keys]`` follows JAX's gather: ids in [-R, -1]
  wrap, then every id clamps into [0, R-1]. On the card ``forward_lanes``
  lanes score a sample, each summing its positions in order, then their
  xor tree: ``sparse_lr_forward_ordered`` is that order on the CPU (the
  plain version sums in torch's).
- ``sparse_lr_apply`` (K12) adds ``values * diff / count`` over the
  batch's UNIQUE touched rows into the regularization of their old
  weights, and applies the sgd or FTRL update to those rows in place.
  The touched rows follow JAX's ``.at[keys].add``: ids in [-R, -1] wrap,
  every other out-of-range id is dropped. Each row's terms add in
  position order, as the reference's CPU scatter loop adds them: on the
  card the ids are sorted by K20 (``keysort.py``, stable), the lane at
  a run's head sums a run inside a tile of ``SPAN`` sorted positions, a
  block each run that leaves its tile (a stretch of tiles whose terms
  are all zeros adds as one zero), with no host sync; the plain version
  prepares them with ``touched_rows`` (a stable sort into a CSR of
  occurrences).
- ``dense_lr_forward`` (K21) is K11's elementwise part for the dense
  models: the stages after their ``x @ w`` (``make_dense_step``,
  ``objective.py:67``), from given logits.

Sums, products, exp and log are formed as the reference's compiled
programs form them (ROADMAP C13, C14), so both match it bit for bit: the
products it fuses into adds (``LocalModel``'s ``w - g * lr``, FTRL's ``n
+ g * g`` and ``weights_of``'s ``+ lambda2``, the loss's products), its
division by the constant ``alpha`` as a multiplication by ``1/alpha``,
its polynomial exp (``sigmoid``, ``softmax``) and log (``sample_loss``).
The dense models' elementwise stages use the same functions.

On a CUDA tensor each wrapper launches its kernel
(``csrc/sparse_logreg.cu``; both bound by bytes) or raises; on a CPU
tensor it runs the plain version beside it, whose elementwise numerics
are also the dense model's (``models/logreg/objective.py``). The plain
versions flush float32 subnormals on every operation's inputs and
result, as the reference and the kernels (``-ftz=true``) do (ROADMAP
C12).
``sparse_lr_forward.launches``, ``sparse_lr_apply.launches`` and
``dense_lr_forward.launches`` count kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import build
from ._launch import is_plain, require, stream_of
from .flush import add_rows, fma, plus_zero, sqrt
from .flush import flush as f
from .keysort import key_sort
from .objective import dot

ACT_LINEAR, ACT_SIGMOID, ACT_SOFTMAX = 0, 1, 2
REG_NONE, REG_L1, REG_L2 = 0, 1, 2
LOG_CLIP = 1e-6  # ref: objective.cpp:16-18
#: Sorted positions one K12 warp sums at a level (``kSpan``).
SPAN = 256


@dataclass(frozen=True)
class Ftrl:
    """FTRL-proximal hyperparameters (ref: configure.h:45-48)."""
    alpha: float
    beta: float
    lambda1: float
    lambda2: float

    @property
    def inv_alpha(self) -> float:
        """``1 / alpha`` rounded to float32: the reference's XLA turns a
        division by the constant ``alpha`` into a multiplication by its
        float32 reciprocal."""
        return float(np.float32(1) / np.float32(self.alpha))


Table = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


# -- the objective's elementwise numerics (objective.py:36-65, 119-125) --

def onehot(labels: torch.Tensor, classes: int) -> torch.Tensor:
    """Binary (one output): target = (label == 1); multiclass: one-hot,
    an out-of-range label giving a zero row (``jax.nn.one_hot``)."""
    if classes == 1:
        return (labels == 1).to(torch.float32)[:, None]
    return (labels.to(torch.int64)[:, None] == torch.arange(
        classes, device=labels.device)[None, :]).to(torch.float32)


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# XLA's exp on the CPU (an inlined Cephes-style polynomial, read from the
# reference's compiled programs with its constants): the input clamped,
# 2^k split off, a degree-5 polynomial; K11's ``xla_sigmoid`` the same.
_EXP_LO, _EXP_HI = _f32(0xC2AF999A), _f32(0x42B1999A)
_LOG2E, _LN2_HI, _LN2_LO = _f32(0x3FB8AA3B), _f32(0x3F318000), \
    _f32(0xB95E8083)
_EXP_POLY = tuple(_f32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908,
                                    0x3D2AA9C1, 0x3E2AAAAA)) + (0.5,)


def _exp_parts(x: torch.Tensor):
    """XLA's exp of ``x`` before its last step: ``(e1, scale)`` with
    ``exp(x) = e1 * scale`` (``scale`` = 2^k)."""
    c = lambda v: _scalar(v, x)  # noqa: E731
    x = torch.where((x >= _EXP_LO) | torch.isnan(x), x, c(_EXP_LO))
    x = torch.where((x <= _EXP_HI) | torch.isnan(x), x, c(_EXP_HI))
    k = torch.clamp(torch.floor(fma(x, c(_LOG2E), c(0.5))), -127.0, 127.0)
    r = fma(-k, c(_LN2_LO), fma(-k, c(_LN2_HI), x))
    y = c(_EXP_POLY[0])
    for p in _EXP_POLY[1:]:
        y = fma(y, r, c(p))
    e1 = f(fma(y, f(r * r), r) + 1)
    return e1, ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` as the reference's XLA compiles it on the CPU: the
    polynomial of ``sigmoid``, then ``e1 * 2^k`` as a product."""
    e1, scale = _exp_parts(f(x))
    return f(e1 * scale)


def sigmoid(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference's XLA compiles it on the CPU
    (ROADMAP C13): ``1 / (exp(-z) + 1)`` with XLA's polynomial exp, its
    products fused into the adds that follow them as the machine code
    fuses them (the scaling by 2^k into the ``+ 1``), every operation
    flushed."""
    e1, scale = _exp_parts(-f(z))
    one = _scalar(1.0, z)
    return f(one / fma(e1, scale, one))


# XLA's log on the CPU (read from the reference's compiled loss): the
# exponent e split off and the mantissa reduced to m in [sqrt(1/2) - 1,
# sqrt(2) - 1), a degree-8 polynomial in three fused chains, e * ln 2
# added in two parts.
_LOG_SQRTHF = _f32(0x3F3504F3)
_LOG_P = tuple(_f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,
                                  0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
                                  0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32(0xB95E8083), _f32(0x3F318000)
_FLT_MIN = _f32(0x00800000)


def log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` as the reference's XLA compiles it on the CPU, its
    products fused as its machine code fuses them, every operation
    flushed: a zero (or subnormal) gives -inf, a negative or NaN input
    NaN (all bits set), +inf itself."""
    c = lambda v: _scalar(v, x)  # noqa: E731
    x = f(x)
    bits = torch.where(x > _FLT_MIN, x, c(_FLT_MIN)).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    mant = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
    low = mant < _LOG_SQRTHF
    e = e - low.to(torch.float32)
    m = f(f(mant - 1.0) + torch.where(low, mant, c(0.0)))
    m2 = f(m * m)
    m3 = f(m2 * m)
    p = _LOG_P
    y = fma(fma(m, c(p[0]), c(p[1])), m, c(p[2]))
    y1 = fma(fma(m, c(p[3]), c(p[4])), m, c(p[5]))
    y2 = fma(fma(m, c(p[6]), c(p[7])), m, c(p[8]))
    y = fma(fma(fma(y, m3, y1), m3, y2), m3, f(e * _LOG_Q1))
    r = fma(e, c(_LOG_Q2), f(fma(c(-0.5), m2, m) + y))
    nan = torch.tensor(-1, dtype=torch.int32,
                       device=x.device).view(torch.float32)
    r = torch.where(x > 0, r, nan)
    r = torch.where(x == float("inf"), x, r)
    return torch.where(x == 0, c(float("-inf")), r)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis as the reference's XLA
    compiles it on the CPU: the max and then the sum of XLA's exp taken
    class by class in order (the sum from +0), then a division."""
    m = logits[..., 0]
    for j in range(1, logits.shape[-1]):
        m = torch.maximum(m, logits[..., j])
    e = exp(f(logits - m[..., None]))
    s = torch.zeros_like(m)
    for j in range(logits.shape[-1]):
        s = f(s + e[..., j])
    return f(e / s[..., None])


def activation(logits: torch.Tensor, act: int) -> torch.Tensor:
    if act == ACT_SIGMOID:
        return sigmoid(logits)
    if act == ACT_SOFTMAX:
        return softmax(logits)
    return logits


def sample_loss(pred: torch.Tensor, y: torch.Tensor, act: int
                ) -> torch.Tensor:
    """Per-sample loss: clipped-log loss for sigmoid and softmax, the
    mean squared error over classes for the linear prediction; as the
    reference's XLA forms it: its ``log``, each class's product fused
    into the sum over classes (taken in order from +0), the mean a
    product by the float32 ``1/C``."""
    c = lambda v: _scalar(v, pred)  # noqa: E731
    clip = c(LOG_CLIP)
    acc = torch.zeros_like(pred[..., 0])
    if act == ACT_SIGMOID:
        terms = fma(y, log(torch.maximum(pred, clip)),
                    f(f(1 - y) * log(torch.maximum(f(1 - pred), clip))))
        if pred.shape[-1] == 1:  # XLA folds a sum over one class away
            return -terms[..., 0]
        for j in range(pred.shape[-1]):
            acc = f(acc + terms[..., j])
        return -acc
    if act == ACT_SOFTMAX:
        logs = log(torch.maximum(pred, clip))
        for j in range(pred.shape[-1]):
            acc = fma(y[..., j], logs[..., j], acc)
        return -acc
    d = f(pred - y)
    for j in range(pred.shape[-1]):
        acc = fma(d[..., j], d[..., j], acc)
    return f(acc * c(float(np.float32(1) / np.float32(pred.shape[-1]))))


def sample_hits(pred: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """1 where the prediction is right (binary: pred >= 0.5, else the
    first argmax) and the sample weighs more than 0, int32."""
    if pred.shape[1] == 1:
        guess = (pred[:, 0] >= 0.5).to(torch.int32)
    else:
        guess = torch.argmax(pred, dim=-1).to(torch.int32)
    return ((guess == labels) & (weights > 0)).to(torch.int32)


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, +1, or the zero (or NaN) itself (``torch.sign``
    gives +0 for -0 and NaN)."""
    return torch.where(x > 0, torch.ones_like(x),
                       torch.where(x < 0, -torch.ones_like(x), x))


def regular_grad(w: torch.Tensor, reg: int, coef: float) -> torch.Tensor:
    if reg == REG_L1:
        return f(coef * sign(f(w)))
    if reg == REG_L2:
        return f(coef * f(w))
    return torch.zeros_like(w)


def regular_fma(w: torch.Tensor, reg: int, coef: float,
                g: torch.Tensor) -> torch.Tensor:
    """``g + reg(w)`` as the reference's dense programs form it: the
    regularizer's product fused into the add, ``fma(w, coef, g)`` (L2) or
    ``fma(sign(w), coef, g)`` (L1); without one the ``+ 0`` is folded
    away and ``g`` is returned as it is."""
    if reg == REG_NONE:
        return g
    w = f(w)
    return fma(sign(w) if reg == REG_L1 else w, _scalar(coef, w), g)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device: dividing by it
    is an elementwise IEEE division, as in the kernels (a Python scalar
    divisor may become a multiplication by its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def ftrl_weights(z: torch.Tensor, n: torch.Tensor, ftrl: Ftrl
                 ) -> torch.Tensor:
    """FTRL's ``weights_of`` (model.py:211-213), every operation
    flushed, as the reference's XLA compiles it (ROADMAP C13): the
    division by ``alpha`` a multiplication by ``inv_alpha``, fused with
    the add of ``lambda2``: ``-shrunk / fma(sqrt(n) + beta, 1/alpha,
    lambda2)``."""
    z, n = f(z), f(n)
    shrunk = f(torch.sign(z) * torch.clamp(f(torch.abs(z) - ftrl.lambda1),
                                           min=0.0))
    den = fma(f(sqrt(n) + ftrl.beta), _scalar(ftrl.inv_alpha, z),
              _scalar(ftrl.lambda2, z))
    return f(-shrunk / den)


def gather_ids(keys: torch.Tensor, rows: int) -> torch.Tensor:
    """The rows JAX's ``w[keys]`` reads (int64)."""
    k = keys.to(torch.int64)
    k = torch.where(k < 0, k + rows, k)
    return torch.clamp(k, 0, rows - 1)


# -- K11 --

#: Terms a K11 lane loads at once (``kTerms``).
FWD_TERMS = 8


def forward_lanes(K: int, C: int) -> int:
    """K11's lanes a sample (``G``): for one class the least power of two
    that leaves a lane at most ``FWD_TERMS`` of the K positions (at most
    32: 8 at criteo's K of 39, or 64 padded); a warp for several
    classes."""
    if C != 1:
        return 32
    lanes = 1
    while lanes < 32 and lanes * FWD_TERMS < K:
        lanes *= 2
    return lanes


def _forward_rows(table: Table, keys: torch.Tensor,
                  ftrl: Optional[Ftrl]) -> torch.Tensor:
    """The rows ``w[keys]`` (or FTRL's weights of them), flushed."""
    ids = gather_ids(keys, (table if ftrl is None else table[0]).shape[0])
    if ftrl is None:
        return f(table[ids])
    return ftrl_weights(table[0][ids], table[1][ids], ftrl)


def dense_lr_forward_plain(logits: torch.Tensor,
                           labels: Optional[torch.Tensor],
                           weights: Optional[torch.Tensor], act: int):
    """Plain version of K21, and K11's stages after its logits: ``pred``
    without labels, else ``(pred, diff, loss * weight, hit)``, every
    operation flushed and formed as the reference's programs form it
    (ROADMAP C14)."""
    pred = activation(logits, act)
    if labels is None:
        return pred
    y = onehot(labels, pred.shape[1])
    weights = f(weights)
    diff = f(f(pred - y) * weights[:, None])
    return (pred, diff, f(sample_loss(pred, y, act) * weights),
            sample_hits(pred, labels, weights))


def sparse_lr_forward_plain(table: Table, keys: torch.Tensor,
                            values: torch.Tensor,
                            labels: Optional[torch.Tensor],
                            weights: Optional[torch.Tensor], act: int,
                            ftrl: Optional[Ftrl] = None):
    """Plain version of K11: ``pred`` without labels, else ``(pred,
    diff, loss * weight, hit)``; every operation flushed, as the
    reference's (ROADMAP C12); the logits summed in torch's order."""
    rows = _forward_rows(table, keys, ftrl)
    return dense_lr_forward_plain(dot(f(values)[..., None], rows, 1),
                                  labels, weights, act)


def sparse_lr_forward_ordered(table: Table, keys: torch.Tensor,
                              values: torch.Tensor,
                              labels: Optional[torch.Tensor],
                              weights: Optional[torch.Tensor], act: int,
                              ftrl: Optional[Ftrl] = None):
    """K11's own summation order on the CPU, the model its results are
    held to bit for bit: with ``G = forward_lanes(K, C)``, lane g sums
    the products of positions g, g + G, ... in order from +0, then the
    lanes' xor tree (``s[i] + s[i ^ o]`` for o = G/2, ..., 1); then the
    plain version's elementwise stages."""
    rows = _forward_rows(table, keys, ftrl)
    terms = f(f(values)[..., None] * rows)            # [B, K, C]
    B, K, C = terms.shape
    G = forward_lanes(K, C)
    acc = terms.new_zeros((B, G, C))
    for k0 in range(0, K, G):
        n = min(G, K - k0)
        acc[:, :n] = f(acc[:, :n] + terms[:, k0:k0 + n])
    lane = torch.arange(G, device=terms.device)
    o = G // 2
    while o:
        acc = f(acc + acc[:, lane ^ o])
        o //= 2
    return dense_lr_forward_plain(acc[:, 0], labels, weights, act)


# -- K21 --

def dense_lr_forward(logits: torch.Tensor,
                     labels: Optional[torch.Tensor] = None,
                     weights: Optional[torch.Tensor] = None,
                     act: int = ACT_SIGMOID):
    """K21 on float32 ``logits [B, C]`` (``x @ w``); ``labels`` int32 and
    ``weights`` float32 ``[B]``, both or neither. Returns what
    ``sparse_lr_forward`` returns."""
    if is_plain(logits):
        return dense_lr_forward_plain(logits, labels, weights, act)
    dev = logits.device
    require(logits, "logits", torch.float32, dev, 2)
    B, C = logits.shape
    pred = torch.empty((B, C), dtype=torch.float32, device=dev)
    diff = loss = hit = None
    if labels is not None:
        require(labels, "labels", torch.int32, dev, 1)
        require(weights, "weights", torch.float32, dev, 1)
        if labels.shape[0] != B or weights.shape[0] != B:
            raise ValueError("labels and weights need one entry a sample")
        diff = torch.empty((B, C), dtype=torch.float32, device=dev)
        loss = torch.empty(B, dtype=torch.float32, device=dev)
        hit = torch.empty(B, dtype=torch.int32, device=dev)
    lib = build.library()
    build.check(lib.mv_dense_lr_forward(
        logits.data_ptr(), B, C, _ptr(labels), _ptr(weights), act,
        float(np.float32(1) / np.float32(C)), pred.data_ptr(), _ptr(diff),
        _ptr(loss), _ptr(hit), stream_of(logits)), "dense_lr_forward")
    dense_lr_forward.launches += 1
    if labels is None:
        return pred
    return pred, diff, loss, hit


dense_lr_forward.launches = 0


def _check_table(table: Table, ftrl: Optional[Ftrl]) -> torch.Tensor:
    """The table tensor(s), checked for a launch; returns the first."""
    parts = (table,) if ftrl is None else tuple(table)
    first = parts[0]
    for name, t in zip(("w",) if ftrl is None else ("z", "n"), parts):
        require(t, name, torch.float32, first.device, 2)
        if t.shape != first.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(first.shape)}")
    return first


def sparse_lr_forward(table: Table, keys: torch.Tensor,
                      values: torch.Tensor,
                      labels: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None,
                      act: int = ACT_SIGMOID, ftrl: Optional[Ftrl] = None):
    """K11. ``table`` is ``w [R, C]``, or ``(z, n)`` with ``ftrl``;
    ``keys`` int32 and ``values`` float32 ``[B, K]``; ``labels`` int32
    and ``weights`` float32 ``[B]``, both or neither. Returns ``pred
    [B, C]`` without labels, else ``(pred, diff [B, C], loss * weight
    [B], hit [B] int32)``."""
    first = table if ftrl is None else table[0]
    if is_plain(first):
        return sparse_lr_forward_plain(table, keys, values, labels,
                                       weights, act, ftrl)
    w = _check_table(table, ftrl)
    dev = w.device
    require(keys, "keys", torch.int32, dev, 2)
    require(values, "values", torch.float32, dev, 2)
    if keys.shape != values.shape:
        raise ValueError(f"keys {tuple(keys.shape)} vs values "
                         f"{tuple(values.shape)}")
    B, K = keys.shape
    C = w.shape[1]
    pred = torch.empty((B, C), dtype=torch.float32, device=dev)
    diff = loss = hit = None
    if labels is not None:
        require(labels, "labels", torch.int32, dev, 1)
        require(weights, "weights", torch.float32, dev, 1)
        if labels.shape[0] != B or weights.shape[0] != B:
            raise ValueError("labels and weights need one entry a sample")
        diff = torch.empty((B, C), dtype=torch.float32, device=dev)
        loss = torch.empty(B, dtype=torch.float32, device=dev)
        hit = torch.empty(B, dtype=torch.int32, device=dev)
    f = ftrl or Ftrl(1.0, 0.0, 0.0, 0.0)
    lib = build.library()
    build.check(lib.mv_sparse_lr_forward(
        w.data_ptr() if ftrl is None else None,
        None if ftrl is None else table[0].data_ptr(),
        None if ftrl is None else table[1].data_ptr(), w.shape[0], C,
        keys.data_ptr(), values.data_ptr(), B, K, _ptr(labels),
        _ptr(weights), act, int(ftrl is not None), f.inv_alpha, f.beta,
        f.lambda1, f.lambda2, forward_lanes(K, C),
        float(np.float32(1) / np.float32(C)), pred.data_ptr(), _ptr(diff),
        _ptr(loss), _ptr(hit), stream_of(w)), "sparse_lr_forward")
    sparse_lr_forward.launches += 1
    if labels is None:
        return pred
    return pred, diff, loss, hit


sparse_lr_forward.launches = 0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# -- K12 --

@dataclass
class Touched:
    """A batch's touched rows as a CSR of occurrences: the sorted unique
    rows ``rows`` (int64 [U]), their occurrence counts, the flat
    positions ``b * K + k`` sorted by row and then by position (int32),
    and each row's first occurrence ``starts`` (int64 [U + 1])."""
    rows: torch.Tensor
    counts: torch.Tensor
    occ: torch.Tensor
    starts: torch.Tensor


def touched_rows(keys: torch.Tensor, rows: int) -> Touched:
    """The rows ``.at[keys].add`` touches in a table of ``rows`` rows,
    prepared on the keys' device with a stable sort."""
    flat = keys.reshape(-1).to(torch.int64)
    flat = torch.where(flat < 0, flat + rows, flat)
    # Dropped ids become the sentinel ``rows``, which sorts last.
    flat = torch.where((flat >= 0) & (flat < rows), flat,
                       torch.full_like(flat, rows))
    ordered, order = torch.sort(flat, stable=True)
    uniq, counts = torch.unique_consecutive(ordered, return_counts=True)
    if uniq.numel() and int(uniq[-1]) == rows:
        uniq, counts = uniq[:-1], counts[:-1]
    starts = torch.zeros(uniq.numel() + 1, dtype=torch.int64,
                         device=keys.device)
    torch.cumsum(counts, 0, out=starts[1:])
    occ = order[:int(starts[-1])].to(torch.int32)
    return Touched(uniq, counts, occ, starts)


class SettleFlag:
    """Whether a model's next sparse step settles the rows its batch does
    not touch as the reference's dense update does (``settle_untouched``,
    ROADMAP C12): after state came in from outside the step (a load, a
    pull: ``request``), and, under a regularizer and in FTRL's state
    (``plus``), after K12 wrote a -0 into a touched row. Two int32 slots
    on the table's device, read and written by the kernels (no host
    sync): the call of step ``epoch`` settles where slot ``(epoch - 1) %
    2`` holds ``epoch - 1``, and writes ``epoch`` into slot ``epoch % 2``
    when it writes a -0 under ``plus``."""

    def __init__(self, device, plus: bool):
        self.slots = torch.full((2,), -1, dtype=torch.int32, device=device)
        self.epoch = 1
        self.plus = plus

    def request(self) -> None:
        """Have the next step settle (no host sync)."""
        e = self.epoch - 1
        self.slots[e % 2] = e

    def raised(self) -> bool:
        """Whether the next step settles (a host read)."""
        e = self.epoch - 1
        return int(self.slots[e % 2]) == e


def settle_untouched(table: Table, touched: torch.Tensor,
                     plus: bool) -> None:
    """Plain version of K12's settle pass: what the reference's sparse
    step does to the rows its batch does not touch, in place on ``w`` or
    FTRL's ``(z, n)``: it subtracts (FTRL: adds) a dense update whose
    rows there are zeros, and that flushes a subnormal. Under a
    regularizer and in FTRL's state that zero is of the element's own
    sign or +0, so every zero and subnormal becomes +0 (``plus``); else
    each flushes to a zero of its sign. ``touched`` holds the touched
    rows (any order, repeats and the sentinel R allowed); their rows are
    the step's and stay as they are."""
    tensors = (table,) if isinstance(table, torch.Tensor) else table
    R = tensors[0].shape[0]
    hit = torch.zeros(R + 1, dtype=torch.bool, device=touched.device)
    hit[touched] = True
    keep = hit[:R, None]
    for x in tensors:
        torch.where(keep, x, plus_zero(x) if plus else f(x), out=x)


def _written_zero(*written: torch.Tensor) -> bool:
    """Whether any of the tensors holds a -0."""
    return any(bool(((x == 0) & torch.signbit(x)).any()) for x in written)


def sparse_lr_apply_plain(table: Table, touched: Touched,
                          values: torch.Tensor, diff: torch.Tensor,
                          count: torch.Tensor, reg: int, coef: float,
                          scale: float, ftrl: Optional[Ftrl],
                          delta_rows: bool,
                          push: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          ) -> Tuple[Optional[torch.Tensor], bool]:
    """Plain version of K12 on the prepared ``touched`` rows, in place;
    returns (the delta rows when ``delta_rows``, whether a -0 was
    written). Every operation flushed, and the sums and products formed
    as the reference's programs form them (ROADMAP C12, C13): a row's
    gradient starts from its regularization term (XLA folds ``zeros.
    at[keys].add(u) + touched * reg(w)`` into one scatter-add into
    ``touched * reg(w)``; +0 without a regularizer) and its terms add in
    position order, each add flushed (``flush.add_rows``), as the CPU
    scatter loop adds them. ``LocalModel``'s fused program contracts
    ``w - g * lr`` into one fused multiply-add; ``PSModel`` (the
    ``delta_rows`` form) rounds its delta ``g * lr`` in a program of its
    own. FTRL contracts ``n + g * g`` and multiplies by ``1/alpha``."""
    K = values.shape[1]
    pos = touched.occ.to(torch.int64)
    seg = torch.repeat_interleave(
        torch.arange(touched.rows.numel(), device=pos.device),
        touched.counts)
    terms = f(f(f(values.reshape(-1)[pos][:, None]) * f(diff[pos // K]))
              / count)
    rows = touched.rows
    if ftrl is None:
        w_old = f(table[rows])
    else:
        z, n = table
        z_old, n_old = f(z[rows]), f(n[rows])
        w_old = ftrl_weights(z_old, n_old, ftrl)
    g = regular_grad(w_old, reg, coef) if reg != REG_NONE \
        else torch.zeros_like(w_old)
    add_rows(g, seg, terms)
    if ftrl is None:
        lr = _scalar(scale, g)
        if delta_rows:
            d = f(g * lr)
            w_new = f(w_old - d)
        else:
            d, w_new = None, fma(-g, lr, w_old)
        table.index_copy_(0, rows, w_new)
        return d, _written_zero(w_new)
    g2 = f(g * g)
    n_new = fma(g, g, n_old)
    sigma = f(f(sqrt(n_new) - sqrt(n_old)) * _scalar(ftrl.inv_alpha, g))
    step = f(g - f(sigma * w_old))
    z_new = f(z_old + step)
    z.index_copy_(0, rows, z_new)
    n.index_copy_(0, rows, n_new)
    if push is not None:
        push[0].index_copy_(0, rows, step)
        push[1].index_copy_(0, rows, g2)
    return None, _written_zero(z_new, n_new)


def sparse_lr_apply(table: Table, keys: torch.Tensor, values: torch.Tensor,
                    diff: torch.Tensor, count: torch.Tensor, *,
                    reg: int = REG_NONE, coef: float = 0.0,
                    scale: float = 1.0, ftrl: Optional[Ftrl] = None,
                    delta_rows: bool = False,
                    push: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    settle: Optional[SettleFlag] = None
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K12: the update of the rows ``keys`` touches, in place. ``table``
    is ``w [R, C]`` (sgd: ``w -= scale * g``) or ``(z, n)`` with
    ``ftrl``; ``diff [B, C]`` is K11's; ``count`` a one-element float32
    tensor, ``max(#(weight > 0), 1)``. ``push`` (FTRL) is a pair of
    zeroed ``[R, C]`` buffers that receive ``g - sigma * w`` and ``g^2``
    at those rows. ``delta_rows`` (sgd, the PS step) asks for the touched
    rows and their ``scale * g``: returns (rows int64 [B*K]: the U
    touched rows ascending, then R; delta [B*K, C]: the first U rows
    theirs), else (None, None). ``settle`` (a ``SettleFlag``) first
    settles the untouched rows where it is up, and is raised when a -0
    is written into a touched row under its ``plus``. On the card the
    ids are sorted by K20 and nothing waits for the card: the call makes
    no host sync."""
    first = table if ftrl is None else table[0]
    R = first.shape[0]
    want_rows = delta_rows and ftrl is None
    epoch = 0
    if settle is not None:
        epoch, settle.epoch = settle.epoch, settle.epoch + 1
    if is_plain(first):
        touched = touched_rows(keys, R)
        if settle is not None and \
                int(settle.slots[(epoch - 1) % 2]) == epoch - 1:
            settle_untouched(table, touched.rows, settle.plus)
        delta, wrote_zero = sparse_lr_apply_plain(
            table, touched, values, diff, count, reg, coef, scale, ftrl,
            want_rows, push)
        if settle is not None and settle.plus and wrote_zero:
            settle.slots[epoch % 2] = epoch
        if not want_rows:
            return None, None
        n, U = keys.numel(), touched.rows.numel()
        rows = torch.full((n,), R, dtype=torch.int64, device=first.device)
        rows[:U] = touched.rows
        out = torch.zeros((n, first.shape[1]), dtype=torch.float32,
                          device=first.device)
        out[:U] = delta
        return rows, out
    w = _check_table(table, ftrl)
    dev = w.device
    require(keys, "keys", torch.int32, dev, 2)
    require(values, "values", torch.float32, dev, 2)
    require(diff, "diff", torch.float32, dev, 2)
    require(count, "count", torch.float32, dev)
    B, K = keys.shape
    C = w.shape[1]
    if values.shape != keys.shape or diff.shape != (B, C) \
            or count.numel() != 1:
        raise ValueError("sparse_lr_apply: keys/values [B, K], diff [B, C] "
                         "and a one-element count")
    if push is not None:
        for name, t in zip(("dz", "dn"), push):
            require(t, name, torch.float32, dev, 2)
            if t.shape != w.shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}")
    if settle is not None:
        require(settle.slots, "settle", torch.int32, dev, 1)
    n = B * K
    sorted_keys, order = key_sort(keys, R)
    tiles = -(-n // SPAN)
    # int32 scratch: the long runs' heads and count, the tiles' run ends;
    # then a byte a tile's first and last segment and column.
    scratch = torch.empty(tiles + 1 + tiles + (2 * tiles * C + 3) // 4,
                          dtype=torch.int32, device=dev)
    rows = delta = delta_end = None
    if want_rows:
        rows = torch.empty(n, dtype=torch.int64, device=dev)
        delta = torch.empty((n, C), dtype=torch.float32, device=dev)
        delta_end = torch.empty((n, C), dtype=torch.float32, device=dev)
    f = ftrl or Ftrl(1.0, 0.0, 0.0, 0.0)
    lib = build.library()
    build.check(lib.mv_sparse_lr_apply(
        w.data_ptr() if ftrl is None else None,
        None if ftrl is None else table[0].data_ptr(),
        None if ftrl is None else table[1].data_ptr(), C, R,
        sorted_keys.data_ptr(), order.data_ptr(), n, values.data_ptr(),
        diff.data_ptr(), K, count.data_ptr(), reg, float(coef),
        int(ftrl is not None), f.inv_alpha, f.beta, f.lambda1, f.lambda2,
        float(scale), int(not delta_rows),
        None if push is None else push[0].data_ptr(),
        None if push is None else push[1].data_ptr(), scratch.data_ptr(),
        None if settle is None else settle.slots.data_ptr(), epoch,
        int(settle is not None and settle.plus),
        _ptr(delta_end), _ptr(rows), _ptr(delta), stream_of(w)),
        "sparse_lr_apply")
    sparse_lr_apply.launches += 1
    return rows, delta


sparse_lr_apply.launches = 0
