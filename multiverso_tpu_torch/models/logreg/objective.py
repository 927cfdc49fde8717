"""Batched objectives: linear / sigmoid / softmax (+ regularizers).

Port of ``multiverso_tpu/models/logreg/objective.py`` (ref:
Applications/LogisticRegression/src/objective/objective.cpp,
sigmoid_objective.h, softmax_objective.h). One minibatch at a time:
``logits = x @ w`` for dense input, with the gradient ``xᵀ diff``
(plain matmuls, as the reference leaves them to XLA); for sparse input
the hand-written kernels K11 (gather, dot, activation, loss) and K12
(the gradient over the touched rows, their regularization and the
update, in place) of ``kernels/logreg.py``. Semantics preserved:

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


_onehot = lrk.onehot


def _regular_grad(regular_type: str, coef: float) -> Callable:
    code = _reg_code(regular_type)
    return lambda w: lrk.regular_grad(w, code, coef)


def _activation_and_loss(objective_type: str):
    """Returns (activation, per-sample loss(pred, onehot))."""
    code = _act_code(objective_type)
    return (lambda z: lrk.activation(z, code),
            lambda p, y: lrk.sample_loss(p, y, code))


def _count_correct(pred, labels, weights) -> torch.Tensor:
    return lrk.sample_hits(pred, labels, weights).sum()


def ftrl_params(config: Configure) -> lrk.Ftrl:
    return lrk.Ftrl(config.alpha, config.beta, config.lambda1,
                    config.lambda2)


def make_dense_step(config: Configure) -> Callable:
    """(w, x, labels, weights) -> (loss_sum, correct, grad). ``w`` is
    [input_size, output_size]; grad is batch-averaged
    (ref: model.cpp:78-103 averages delta over the minibatch)."""
    act, loss_fn = _activation_and_loss(config.objective_type)
    reg = _regular_grad(config.regular_type, config.regular_coef)
    classes = max(config.output_size, 1)

    def step(w, x, labels, weights):
        pred = act(x @ w)
        y = _onehot(labels, classes)
        diff = (pred - y) * weights[:, None]
        count = torch.clamp(torch.sum(weights > 0), min=1)
        grad = x.T @ diff / count + reg(w)
        loss_sum = torch.sum(loss_fn(pred, y) * weights)
        return loss_sum, _count_correct(pred, labels, weights), grad

    return step


class SparseStep:
    """The sparse step on K11 and K12, applied in place:
    ``(table, keys, values, labels, weights, scale=, delta_rows=, push=)
    -> (loss_sum, correct, touched rows, delta rows or None)``.
    ``table`` is ``w [input_size + 1, C]`` (last row = padding) with
    ``w -= scale * grad`` on the touched rows, or ``(z, n)`` for FTRL
    (``ftrl`` given). ``delta_rows`` returns the rows' ``scale * grad``
    (the PS push); ``push`` takes FTRL's ``(g - sigma*w, g^2)``."""

    def __init__(self, config: Configure, ftrl: Optional[lrk.Ftrl] = None):
        self.act = _act_code(config.objective_type)
        self.reg = _reg_code(config.regular_type)
        self.coef = config.regular_coef
        self.ftrl = ftrl

    def __call__(self, table, keys, values, labels, weights,
                 scale: float = 1.0, delta_rows: bool = False, push=None):
        _, diff, loss, hit = lrk.sparse_lr_forward(
            table, keys, values, labels, weights, self.act, self.ftrl)
        count = torch.clamp(torch.sum(weights > 0), min=1).to(
            torch.float32).reshape(1)
        rows, delta = lrk.sparse_lr_apply(
            table, keys, values, diff, count, reg=self.reg, coef=self.coef,
            scale=scale, ftrl=self.ftrl, delta_rows=delta_rows, push=push)
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
            return lrk.activation(x @ w, code)
    return predict


def learning_rate(config: Configure, update_count: int) -> float:
    """ref: updater.cpp:67-69."""
    return max(1e-3, config.learning_rate
               - update_count / (config.learning_rate_coef
                                 * config.minibatch_size))
