"""Batched objectives: linear / sigmoid / softmax (+ regularizers).

Port of ``multiverso_tpu/models/logreg/objective.py`` (ref:
Applications/LogisticRegression/src/objective/objective.cpp,
sigmoid_objective.h, softmax_objective.h). One minibatch at a time:
``logits = x @ w`` for dense input, with the gradient ``xᵀ diff``
(plain matmuls, as the reference leaves them to XLA) and the kernel K21
(activation, diff, loss) between them; for sparse input the
hand-written kernels K11 (gather, dot, activation, loss) and K12 (the
gradient over the touched rows, their regularization and the update,
in place) of ``kernels/logreg.py``. Semantics preserved:

- diff = predict - onehot(label) (ref: objective.cpp Diff);
- displayed loss: clipped-log loss for sigmoid/softmax (MathLog clips at
  1e-6, ref: objective.cpp:16-18), squared error for linear — also for
  ``objective_type=ftrl``, which falls through to it as in the reference;
- regularization: L1 = coef*sign(w), L2 = coef*w added to the gradient
  (sparse models only regularize touched rows, ref: objective.cpp
  AddRegularization) — the padding row ``input_size`` is a touched row;
- prediction correctness: argmax (binary: pred >= 0.5), ref:
  objective.cpp Correct.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...kernels import logreg as lrk
from ...kernels.flush import flush as f
from .config import Configure


def _act_code(objective_type: str) -> int:
    if objective_type == "sigmoid":
        return lrk.ACT_SIGMOID
    if objective_type in ("softmax", "ftrl_softmax"):
        return lrk.ACT_SOFTMAX
    return lrk.ACT_LINEAR  # default and ftrl: linear, squared loss


def _reg_code(regular_type: str) -> int:
    return {"L1": lrk.REG_L1, "L2": lrk.REG_L2}.get(regular_type,
                                                    lrk.REG_NONE)


def ftrl_params(config: Configure) -> lrk.Ftrl:
    return lrk.Ftrl(config.alpha, config.beta, config.lambda1,
                    config.lambda2)


def dense_count(weights: torch.Tensor) -> torch.Tensor:
    """``max(#(weight > 0), 1)`` as a one-element float32 tensor."""
    return torch.clamp(torch.sum(weights > 0), min=1).to(
        torch.float32).reshape(1)


def dense_grad(gsum: torch.Tensor, count: torch.Tensor, w: torch.Tensor,
               reg: int, coef: float) -> torch.Tensor:
    """The gradient from ``x.T @ diff``: ``gsum / count + reg(w)``, the
    division an IEEE division and the regularizer's product fused into
    the add (``lrk.regular_fma``)."""
    return lrk.regular_fma(w, reg, coef, f(f(gsum) / count))


def dense_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on flushed inputs, flushed: a plain float32 product that
    sums in another order than the reference's dot (full float32 on the
    card: no TF32)."""
    return f(torch.matmul(f(a), f(b)))


def make_dense_step(config: Configure) -> Callable:
    """(w, x, labels, weights) -> (loss_sum, correct, grad). ``w`` is
    [input_size, output_size]; grad is batch-averaged
    (ref: model.cpp:78-103 averages delta over the minibatch). The two
    products are ``torch.matmul`` (``dense_matmul``); between them K21
    (``lrk.dense_lr_forward``) forms the elementwise stages, and
    ``dense_grad`` the gradient, as the reference's XLA compiles them."""
    act = _act_code(config.objective_type)
    reg = _reg_code(config.regular_type)
    coef = config.regular_coef

    def step(w, x, labels, weights):
        _, diff, loss, hit = lrk.dense_lr_forward(dense_matmul(x, w),
                                                  labels, weights, act)
        grad = dense_grad(dense_matmul(x.T, diff), dense_count(weights), w,
                          reg, coef)
        return f(loss.sum()), hit.sum(), grad

    return step


class SparseStep:
    """The sparse step on K11 and K12, applied in place:
    ``(table, keys, values, labels, weights, scale=, delta_rows=, push=,
    settle=) -> (loss_sum, correct, touched rows, delta rows or None)``.
    ``table`` is ``w [input_size + 1, C]`` (last row = padding) with
    ``w -= scale * grad`` on the touched rows, or ``(z, n)`` for FTRL
    (``ftrl`` given). ``delta_rows`` returns the touched rows ascending
    as a host tensor (the PS push's ids: one copy from the card) and
    their ``scale * grad`` rows on the table's device, else None for
    both; ``push`` takes FTRL's ``(g - sigma*w, g^2)``; ``settle`` (a
    ``lrk.SettleFlag``) settles the untouched rows where it is up."""

    def __init__(self, config: Configure, ftrl: Optional[lrk.Ftrl] = None):
        self.act = _act_code(config.objective_type)
        self.reg = _reg_code(config.regular_type)
        self.coef = config.regular_coef
        self.ftrl = ftrl

    def __call__(self, table, keys, values, labels, weights,
                 scale: float = 1.0, delta_rows: bool = False, push=None,
                 settle: Optional[lrk.SettleFlag] = None):
        _, diff, loss, hit = lrk.sparse_lr_forward(
            table, keys, values, labels, weights, self.act, self.ftrl)
        count = dense_count(weights)
        rows, delta = lrk.sparse_lr_apply(
            table, keys, values, diff, count, reg=self.reg, coef=self.coef,
            scale=scale, ftrl=self.ftrl, delta_rows=delta_rows, push=push,
            settle=settle)
        if rows is not None:
            # The touched rows, then the sentinel R: cut at R on the host.
            rows = rows.cpu()
            touched = int(torch.searchsorted(
                rows, torch.tensor(table.shape[0], dtype=rows.dtype)))
            rows, delta = rows[:touched], delta[:touched]
        return loss.sum(), hit.sum(), rows, delta


def make_sparse_step(config: Configure,
                     ftrl: Optional[lrk.Ftrl] = None) -> SparseStep:
    return SparseStep(config, ftrl)


def make_predict(config: Configure,
                 ftrl: Optional[lrk.Ftrl] = None) -> Callable:
    """Sparse: ``(table, keys, values) -> pred`` on K11 (``table`` is
    ``(z, n)`` with ``ftrl``); dense: ``(w, x) -> pred``."""
    code = _act_code(config.objective_type)
    if config.sparse:
        def predict(table, keys, values):
            return lrk.sparse_lr_forward(table, keys, values, act=code,
                                         ftrl=ftrl)
    else:
        def predict(w, x):
            return lrk.dense_lr_forward(dense_matmul(x, w), act=code)
    return predict


def learning_rate(config: Configure, update_count: int) -> float:
    """ref: updater.cpp:67-69."""
    return max(1e-3, config.learning_rate
               - update_count / (config.learning_rate_coef
                                 * config.minibatch_size))
