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
  wrap, then every id clamps into [0, R-1].
- ``sparse_lr_apply`` (K12) adds ``values * diff / count`` over the
  batch's UNIQUE touched rows, plus the regularization of their old
  weights, and applies the sgd or FTRL update to those rows in place.
  The touched rows follow JAX's ``.at[keys].add``: ids in [-R, -1] wrap,
  every other out-of-range id is dropped. The ids are prepared in plain
  torch (``touched_rows``: a stable sort into a CSR of occurrences); the
  arithmetic is the kernel's.

On a CUDA tensor each wrapper launches its kernel
(``csrc/sparse_logreg.cu``; both bound by bytes) or raises; on a CPU
tensor it runs the plain version beside it, whose elementwise numerics
are also the dense model's (``models/logreg/objective.py``).
``sparse_lr_forward.launches`` and ``sparse_lr_apply.launches`` count
kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from . import build
from ._launch import is_plain, require, stream_of

ACT_LINEAR, ACT_SIGMOID, ACT_SOFTMAX = 0, 1, 2
REG_NONE, REG_L1, REG_L2 = 0, 1, 2
LOG_CLIP = 1e-6  # ref: objective.cpp:16-18
#: Positions one K12 warp sums; a row with more is split over warps.
TASK = 256


@dataclass(frozen=True)
class Ftrl:
    """FTRL-proximal hyperparameters (ref: configure.h:45-48)."""
    alpha: float
    beta: float
    lambda1: float
    lambda2: float


Table = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


# -- the objective's elementwise numerics (objective.py:36-65, 119-125) --

def onehot(labels: torch.Tensor, classes: int) -> torch.Tensor:
    """Binary (one output): target = (label == 1); multiclass: one-hot,
    an out-of-range label giving a zero row (``jax.nn.one_hot``)."""
    if classes == 1:
        return (labels == 1).to(torch.float32)[:, None]
    return (labels.to(torch.int64)[:, None] == torch.arange(
        classes, device=labels.device)[None, :]).to(torch.float32)


def activation(logits: torch.Tensor, act: int) -> torch.Tensor:
    if act == ACT_SIGMOID:
        return torch.sigmoid(logits)
    if act == ACT_SOFTMAX:
        return torch.softmax(logits, dim=-1)
    return logits


def sample_loss(pred: torch.Tensor, y: torch.Tensor, act: int
                ) -> torch.Tensor:
    """Per-sample loss: clipped-log loss for sigmoid and softmax, the
    mean squared error over classes for the linear prediction."""
    if act == ACT_SIGMOID:
        return -torch.sum(y * torch.log(torch.clamp(pred, min=LOG_CLIP))
                          + (1 - y) * torch.log(
                              torch.clamp(1 - pred, min=LOG_CLIP)), dim=-1)
    if act == ACT_SOFTMAX:
        return -torch.sum(y * torch.log(torch.clamp(pred, min=LOG_CLIP)),
                          dim=-1)
    return torch.mean((pred - y) ** 2, dim=-1)


def sample_hits(pred: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """1 where the prediction is right (binary: pred >= 0.5, else the
    first argmax) and the sample weighs more than 0, int32."""
    if pred.shape[1] == 1:
        guess = (pred[:, 0] >= 0.5).to(torch.int32)
    else:
        guess = torch.argmax(pred, dim=-1).to(torch.int32)
    return ((guess == labels) & (weights > 0)).to(torch.int32)


def regular_grad(w: torch.Tensor, reg: int, coef: float) -> torch.Tensor:
    if reg == REG_L1:
        return coef * torch.sign(w)
    if reg == REG_L2:
        return coef * w
    return torch.zeros_like(w)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device: dividing by it
    is an elementwise IEEE division, as in the kernels (a Python scalar
    divisor may become a multiplication by its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def ftrl_weights(z: torch.Tensor, n: torch.Tensor, ftrl: Ftrl
                 ) -> torch.Tensor:
    """FTRL's ``weights_of`` (model.py:211-213)."""
    shrunk = torch.sign(z) * torch.clamp(torch.abs(z) - ftrl.lambda1,
                                         min=0.0)
    den = (ftrl.beta + torch.sqrt(n)) / _scalar(ftrl.alpha, z) \
        + ftrl.lambda2
    return -shrunk / den


def gather_ids(keys: torch.Tensor, rows: int) -> torch.Tensor:
    """The rows JAX's ``w[keys]`` reads (int64)."""
    k = keys.to(torch.int64)
    k = torch.where(k < 0, k + rows, k)
    return torch.clamp(k, 0, rows - 1)


# -- K11 --

def sparse_lr_forward_plain(table: Table, keys: torch.Tensor,
                            values: torch.Tensor,
                            labels: Optional[torch.Tensor],
                            weights: Optional[torch.Tensor], act: int,
                            ftrl: Optional[Ftrl] = None):
    """Plain version of K11: ``pred`` without labels, else ``(pred,
    diff, loss * weight, hit)``."""
    ids = gather_ids(keys, (table if ftrl is None else table[0]).shape[0])
    if ftrl is None:
        rows = table[ids]
    else:
        rows = ftrl_weights(table[0][ids], table[1][ids], ftrl)
    pred = activation(torch.einsum("bk,bkc->bc", values, rows), act)
    if labels is None:
        return pred
    y = onehot(labels, pred.shape[1])
    diff = (pred - y) * weights[:, None]
    return (pred, diff, sample_loss(pred, y, act) * weights,
            sample_hits(pred, labels, weights))


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
        _ptr(weights), act, int(ftrl is not None), f.alpha, f.beta,
        f.lambda1, f.lambda2, pred.data_ptr(), _ptr(diff), _ptr(loss),
        _ptr(hit), stream_of(w)), "sparse_lr_forward")
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


def sparse_lr_apply_plain(table: Table, touched: Touched,
                          values: torch.Tensor, diff: torch.Tensor,
                          count: torch.Tensor, reg: int, coef: float,
                          scale: float, ftrl: Optional[Ftrl],
                          delta_rows: bool,
                          push: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          ) -> Optional[torch.Tensor]:
    """Plain version of K12 on the prepared ``touched`` rows, in place;
    returns the delta rows when ``delta_rows``."""
    K = values.shape[1]
    pos = touched.occ.to(torch.int64)
    seg = torch.repeat_interleave(
        torch.arange(touched.rows.numel(), device=pos.device),
        touched.counts)
    terms = values.reshape(-1)[pos][:, None] * diff[pos // K] / count
    gsum = torch.zeros((touched.rows.numel(), diff.shape[1]),
                       dtype=torch.float32, device=diff.device)
    gsum.index_add_(0, seg, terms)
    rows = touched.rows
    if ftrl is None:
        w_old = table[rows]
        g = gsum + regular_grad(w_old, reg, coef)
        d = g * scale
        table.index_copy_(0, rows, w_old - d)
        return d if delta_rows else None
    z, n = table
    z_old, n_old = z[rows], n[rows]
    w_old = ftrl_weights(z_old, n_old, ftrl)
    g = gsum + regular_grad(w_old, reg, coef)
    g2 = g * g
    sigma = (torch.sqrt(n_old + g2) - torch.sqrt(n_old)) \
        / _scalar(ftrl.alpha, g)
    step = g - sigma * w_old
    z.index_copy_(0, rows, z_old + step)
    n.index_copy_(0, rows, n_old + g2)
    if push is not None:
        push[0].index_copy_(0, rows, step)
        push[1].index_copy_(0, rows, g2)
    return None


def sparse_lr_apply(table: Table, keys: torch.Tensor, values: torch.Tensor,
                    diff: torch.Tensor, count: torch.Tensor, *,
                    reg: int = REG_NONE, coef: float = 0.0,
                    scale: float = 1.0, ftrl: Optional[Ftrl] = None,
                    delta_rows: bool = False,
                    push: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K12: the update of the rows ``keys`` touches, in place. ``table``
    is ``w [R, C]`` (sgd: ``w -= scale * g``) or ``(z, n)`` with
    ``ftrl``; ``diff [B, C]`` is K11's; ``count`` a one-element float32
    tensor, ``max(#(weight > 0), 1)``. ``delta_rows`` (sgd) asks for the
    rows' ``scale * g``; ``push`` (FTRL) is a pair of zeroed ``[R, C]``
    buffers that receive ``g - sigma * w`` and ``g^2`` at those rows.
    Returns (the touched rows, sorted int64 [U], the delta rows [U, C]
    or None)."""
    first = table if ftrl is None else table[0]
    touched = touched_rows(keys, first.shape[0])
    if is_plain(first):
        return touched.rows, sparse_lr_apply_plain(
            table, touched, values, diff, count, reg, coef, scale, ftrl,
            delta_rows, push)
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
    U = touched.rows.numel()
    tasks = (touched.counts + TASK - 1) // TASK
    task_start = torch.zeros(U + 1, dtype=torch.int64, device=dev)
    torch.cumsum(tasks, 0, out=task_start[1:])
    n_tasks = int(task_start[-1])
    task_row = torch.repeat_interleave(
        torch.arange(U, dtype=torch.int32, device=dev), tasks,
        output_size=n_tasks)
    partial = torch.empty(n_tasks * C, dtype=torch.float32, device=dev)
    arrived = torch.zeros(U, dtype=torch.int32, device=dev)
    delta = torch.empty((U, C), dtype=torch.float32, device=dev) \
        if delta_rows and ftrl is None else None
    f = ftrl or Ftrl(1.0, 0.0, 0.0, 0.0)
    lib = build.library()
    build.check(lib.mv_sparse_lr_apply(
        w.data_ptr() if ftrl is None else None,
        None if ftrl is None else table[0].data_ptr(),
        None if ftrl is None else table[1].data_ptr(), C,
        touched.rows.data_ptr(), touched.starts.data_ptr(),
        task_row.data_ptr(), task_start.data_ptr(), n_tasks, TASK,
        touched.occ.data_ptr(), values.data_ptr(), diff.data_ptr(), K,
        count.data_ptr(), reg, float(coef), int(ftrl is not None),
        f.alpha, f.beta, f.lambda1, f.lambda2, float(scale), _ptr(delta),
        None if push is None else push[0].data_ptr(),
        None if push is None else push[1].data_ptr(),
        partial.data_ptr(), arrived.data_ptr(), stream_of(w)),
        "sparse_lr_apply")
    sparse_lr_apply.launches += 1
    return touched.rows, delta


sparse_lr_apply.launches = 0
