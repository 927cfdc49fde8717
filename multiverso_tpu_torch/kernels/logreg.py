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
  every other out-of-range id is dropped. On the card the ids are
  sorted by K20 (``keysort.py``) and the kernel sums each row's run of
  sorted positions in a fixed order, level by level (K3's levels over
  tiles of ``SPAN``: ``rows.scatter_levels``),
  with no host sync; the plain version prepares them with ``touched_rows``
  (a stable sort into a CSR of occurrences).

On a CUDA tensor each wrapper launches its kernel
(``csrc/sparse_logreg.cu``; both bound by bytes) or raises; on a CPU
tensor it runs the plain version beside it, whose elementwise numerics
are also the dense model's (``models/logreg/objective.py``). The plain
versions flush float32 subnormals on every operation's inputs and
result, as the reference and the kernels (``-ftz=true``) do (ROADMAP
C12).
``sparse_lr_forward.launches`` and ``sparse_lr_apply.launches`` count
kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .flush import add_rows, plus_zero
from .flush import flush as f
from .keysort import key_sort
from .objective import dot
from .rows import scatter_levels

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
        return f(torch.sigmoid(logits))
    if act == ACT_SOFTMAX:
        return f(torch.softmax(logits, dim=-1))
    return logits


def sample_loss(pred: torch.Tensor, y: torch.Tensor, act: int
                ) -> torch.Tensor:
    """Per-sample loss: clipped-log loss for sigmoid and softmax, the
    mean squared error over classes for the linear prediction."""
    if act == ACT_SIGMOID:
        return -f(torch.sum(f(f(y * f(torch.log(torch.clamp(
            pred, min=LOG_CLIP)))) + f(f(1 - y) * f(torch.log(torch.clamp(
                f(1 - pred), min=LOG_CLIP))))), dim=-1))
    if act == ACT_SOFTMAX:
        return -f(torch.sum(f(y * f(torch.log(torch.clamp(
            pred, min=LOG_CLIP)))), dim=-1))
    return f(torch.mean(f(f(pred - y) ** 2), dim=-1))


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
        return f(coef * torch.sign(f(w)))
    if reg == REG_L2:
        return f(coef * f(w))
    return torch.zeros_like(w)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device: dividing by it
    is an elementwise IEEE division, as in the kernels (a Python scalar
    divisor may become a multiplication by its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def ftrl_weights(z: torch.Tensor, n: torch.Tensor, ftrl: Ftrl
                 ) -> torch.Tensor:
    """FTRL's ``weights_of`` (model.py:211-213), every operation
    flushed."""
    z, n = f(z), f(n)
    shrunk = f(torch.sign(z) * torch.clamp(f(torch.abs(z) - ftrl.lambda1),
                                           min=0.0))
    den = f(f(f(ftrl.beta + f(torch.sqrt(n))) / _scalar(ftrl.alpha, z))
            + ftrl.lambda2)
    return f(-shrunk / den)


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
    diff, loss * weight, hit)``; every operation flushed, as the
    reference's (ROADMAP C12)."""
    ids = gather_ids(keys, (table if ftrl is None else table[0]).shape[0])
    if ftrl is None:
        rows = f(table[ids])
    else:
        rows = ftrl_weights(table[0][ids], table[1][ids], ftrl)
    pred = activation(dot(f(values)[..., None], rows, 1), act)
    if labels is None:
        return pred
    y = onehot(labels, pred.shape[1])
    weights = f(weights)
    diff = f(f(pred - y) * weights[:, None])
    return (pred, diff, f(sample_loss(pred, y, act) * weights),
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


def settle_untouched(table: Table, touched: torch.Tensor,
                     plus: bool) -> None:
    """What the reference's sparse step does to the rows its batch does
    not touch, in place on ``w`` or FTRL's ``(z, n)``: it subtracts
    (FTRL: adds) a dense update whose rows there are zeros, and that
    flushes a subnormal. Under a regularizer and in FTRL's state that
    zero is of the element's own sign or +0, so every zero and subnormal
    becomes +0 (``plus``); else each flushes to a zero of its sign.
    ``touched`` holds the touched rows (any order, repeats and the
    sentinel R allowed); their rows are the step's and stay as they
    are. Needed only where state came in from outside the step (a load,
    a pull): the step's own results are flushed already."""
    tensors = (table,) if isinstance(table, torch.Tensor) else table
    R = tensors[0].shape[0]
    hit = torch.zeros(R + 1, dtype=torch.bool, device=touched.device)
    hit[touched] = True
    keep = hit[:R, None]
    for x in tensors:
        torch.where(keep, x, plus_zero(x) if plus else f(x), out=x)


def sparse_lr_apply_plain(table: Table, touched: Touched,
                          values: torch.Tensor, diff: torch.Tensor,
                          count: torch.Tensor, reg: int, coef: float,
                          scale: float, ftrl: Optional[Ftrl],
                          delta_rows: bool,
                          push: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          ) -> Optional[torch.Tensor]:
    """Plain version of K12 on the prepared ``touched`` rows, in place;
    returns the delta rows when ``delta_rows``. Every operation flushed,
    as the reference's (ROADMAP C12): a row's terms add in position
    order, each add flushed (``flush.add_rows``)."""
    K = values.shape[1]
    pos = touched.occ.to(torch.int64)
    seg = torch.repeat_interleave(
        torch.arange(touched.rows.numel(), device=pos.device),
        touched.counts)
    terms = f(f(f(values.reshape(-1)[pos][:, None]) * f(diff[pos // K]))
              / count)
    # A row's terms add in position order from -0 (the identity: a sum
    # of zeros is -0 only where every term is, as in the reference, whose
    # XLA folds ``zeros.at[keys].add(u) + reg(w)`` into a scatter-add
    # into ``reg(w)``), then the regularization, as the kernel adds them.
    gsum = torch.full((touched.rows.numel(), diff.shape[1]), -0.0,
                      dtype=torch.float32, device=diff.device)
    add_rows(gsum, seg, terms)
    rows = touched.rows
    if ftrl is None:
        w_old = f(table[rows])
        g = f(gsum + regular_grad(w_old, reg, coef))
        d = f(g * scale)
        table.index_copy_(0, rows, f(w_old - d))
        return d if delta_rows else None
    z, n = table
    z_old, n_old = f(z[rows]), f(n[rows])
    w_old = ftrl_weights(z_old, n_old, ftrl)
    g = f(gsum + regular_grad(w_old, reg, coef))
    g2 = f(g * g)
    sigma = f(f(f(torch.sqrt(f(n_old + g2))) - f(torch.sqrt(n_old)))
              / _scalar(ftrl.alpha, g))
    step = f(g - f(sigma * w_old))
    z.index_copy_(0, rows, f(z_old + step))
    n.index_copy_(0, rows, f(n_old + g2))
    if push is not None:
        push[0].index_copy_(0, rows, step)
        push[1].index_copy_(0, rows, g2)
    return None


def sparse_lr_apply(table: Table, keys: torch.Tensor, values: torch.Tensor,
                    diff: torch.Tensor, count: torch.Tensor, *,
                    reg: int = REG_NONE, coef: float = 0.0,
                    scale: float = 1.0, ftrl: Optional[Ftrl] = None,
                    delta_rows: bool = False,
                    push: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    settle: Optional[bool] = None
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K12: the update of the rows ``keys`` touches, in place. ``table``
    is ``w [R, C]`` (sgd: ``w -= scale * g``) or ``(z, n)`` with
    ``ftrl``; ``diff [B, C]`` is K11's; ``count`` a one-element float32
    tensor, ``max(#(weight > 0), 1)``. ``push`` (FTRL) is a pair of
    zeroed ``[R, C]`` buffers that receive ``g - sigma * w`` and ``g^2``
    at those rows. ``delta_rows`` (sgd) asks for the touched rows and
    their ``scale * g``: returns (rows int64 [B*K]: the U touched rows
    ascending, then R; delta [B*K, C]: the first U rows theirs), else
    (None, None). ``settle`` (``plus``, not None) then settles the
    untouched rows (``settle_untouched``) with the touched rows the
    call already has. On the card the ids are sorted by K20 and nothing
    waits for the card: the call makes no host sync."""
    first = table if ftrl is None else table[0]
    R = first.shape[0]
    want_rows = delta_rows and ftrl is None
    if is_plain(first):
        touched = touched_rows(keys, R)
        delta = sparse_lr_apply_plain(table, touched, values, diff, count,
                                      reg, coef, scale, ftrl, want_rows,
                                      push)
        if settle is not None:
            settle_untouched(table, touched.rows, settle)
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
    n = B * K
    sorted_keys, order = key_sort(keys, R)
    sizes = scatter_levels(n, SPAN)
    cap_a = sizes[1] if len(sizes) > 1 else 0
    cap = cap_a + (sizes[2] if len(sizes) > 2 else 0)
    slot_ids = torch.empty(2 * cap, dtype=torch.int32, device=dev)
    slot_vals = torch.empty(cap * C, dtype=torch.float32, device=dev)
    rows = delta = delta_end = tile_ends = None
    if want_rows:
        rows = torch.empty(n, dtype=torch.int64, device=dev)
        delta = torch.empty((n, C), dtype=torch.float32, device=dev)
        delta_end = torch.empty((n, C), dtype=torch.float32, device=dev)
        tile_ends = torch.empty(-(-n // SPAN), dtype=torch.int32,
                                device=dev)
    f = ftrl or Ftrl(1.0, 0.0, 0.0, 0.0)
    lib = build.library()
    build.check(lib.mv_sparse_lr_apply(
        w.data_ptr() if ftrl is None else None,
        None if ftrl is None else table[0].data_ptr(),
        None if ftrl is None else table[1].data_ptr(), C, R,
        sorted_keys.data_ptr(), order.data_ptr(), n, values.data_ptr(),
        diff.data_ptr(), K, count.data_ptr(), reg, float(coef),
        int(ftrl is not None), f.alpha, f.beta, f.lambda1, f.lambda2,
        float(scale), None if push is None else push[0].data_ptr(),
        None if push is None else push[1].data_ptr(), slot_ids.data_ptr(),
        slot_ids[cap:].data_ptr(), slot_vals.data_ptr(), cap_a,
        _ptr(delta_end), _ptr(tile_ends), _ptr(rows), _ptr(delta),
        stream_of(w)), "sparse_lr_apply")
    sparse_lr_apply.launches += 1
    if settle is not None:
        settle_untouched(table, sorted_keys, settle)
    return rows, delta


sparse_lr_apply.launches = 0
