"""Server-side update rules over torch table storage.

Port of ``multiverso_tpu/updater/rules.py`` (ref: include/multiverso/
updater/, src/updater/updater.cpp:23-58):

- default: ``data += delta`` (ref: src/updater/updater.cpp:24-31)
- sgd: ``data -= delta`` — the caller pre-multiplies the learning rate
  (ref: include/multiverso/updater/sgd_updater.h:15-19)
- momentum: ``smooth = m*smooth + (1-m)*delta; data -= smooth``
  (ref: include/multiverso/updater/momentum_updater.h:17-26)
- adagrad: per-worker accumulator ``G[w] += (delta/lr)^2``;
  ``data -= rho * (delta/lr) / sqrt(G[w] + e)`` — the intended AdaGrad
  the reference's header describes, as the JAX package implements it
- dcasgd: delay-compensated ASGD (Zheng et al. 2017) with a per-worker
  parameter backup, the JAX package's working form of the hook the
  reference ships disabled

The reference's rules are pure functions whose storage XLA updates in
place through buffer donation (``donate_argnums``,
``multiverso_tpu/updater/engine.py:83-84``); here each rule updates the
table tensor and its state IN PLACE. ``dense`` is elementwise torch,
every operation flushing float32 subnormals on its inputs and result
as the reference's does, and fusing a product into the add that follows
it where the reference's XLA contracts it (``kernels/flush.py`` ``fma``;
ROADMAP C13);
``rows`` runs the row scatter-add kernel (K3, ``kernels/rows.py``) for
the stateless rules — duplicate ids sum, out-of-range ids drop — and
K13 (``kernels/rules.py``) for the stateful ones, where every occurrence
of a repeated id takes its step from the pre-update rows and state, the
steps sum on the table and the state keeps the last occurrence.
``rows_gather`` is the fused row update + gather of K14.

A worker id at or past the per-worker state's slots: ``dense`` reads
the last slot (JAX's clamped dynamic index) and ``rows`` reads zeros
(``mode="fill"``); both drop the state write.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..kernels.flush import add_, flush, fma
from ..kernels.rows import row_scatter_add, row_scatter_add_bounded
from ..kernels.rules import ADAGRAD_EPS, inv_sqrt
from ..kernels.rules import row_rule_apply, rows_apply_gather, rule_step
from ..kernels.rules import safe_lr as _safe_lr
from ..kernels.rules import scalar
from ..sharding.mesh import torch_dtype
from ..util import log
from ..util.configure import define_string, get_flag

define_string("updater_type", "default",
              "server updater: default / sgd / momentum / adagrad / "
              "dcasgd")


class UpdaterRule:
    """An update rule: (data, state, delta, hyp, worker_id) -> (data,
    state), with ``data`` and ``state`` updated in place."""

    name = "base"
    # True when init_state returns None — i.e. duplicate row ids in one
    # scatter-add SUM correctly.
    stateless = True

    def init_state(self, shape, dtype, num_workers: int,
                   device=None) -> Any:
        return None

    def dense(self, data, state, delta, hyp, worker_id):
        raise NotImplementedError

    def rows(self, data, state, row_ids, delta, hyp, worker_id,
             distinct: bool = False):
        """Row-sparse update. ``row_ids`` may be padded with
        out-of-range indices (>= data.shape[0]), which are dropped;
        ``delta`` [k, d] may have fewer rows than ids and fewer columns
        than the storage (zero extension). ``distinct``: the in-range
        ids strictly ascend (K13 sorts them all the same)."""
        row_rule_apply(self.name, data, state, row_ids, delta, hyp,
                       worker_id)
        return data, state

    def rows_gather(self, data, state, row_ids, delta, hyp, worker_id,
                    get_ids, n_col: int,
                    distinct: bool = False) -> torch.Tensor:
        """``rows``, then ``data[get_ids, :n_col]`` of the updated table
        (zero rows for out-of-range ids), in one launch (K14).
        ``distinct``: the in-range ids strictly ascend (the stateless
        rules then add without a sort; the stateful ones ignore it)."""
        return rows_apply_gather(self.name, data, state, row_ids, delta,
                                 hyp, worker_id, get_ids, n_col,
                                 distinct=distinct)


class DefaultRule(UpdaterRule):
    name = "default"

    def dense(self, data, state, delta, hyp, worker_id):
        add_(data, delta)
        return data, state

    sign = 1.0

    def rows(self, data, state, row_ids, delta, hyp, worker_id,
             distinct: bool = False):
        # Ids that can repeat (device keys of PS pushes, fused requests)
        # take K3's sorted form; ids the engine found strictly ascending
        # (lr_sparse_ps's unique rows, the tbl_* rounds' every 10th row)
        # its one-writer form.
        row_scatter_add(data, row_ids, delta, self.sign, distinct=distinct)
        return data, state

    def rows_bounded(self, data, row_ids, delta, bounds) -> None:
        """``rows`` over a server shard's window ``bounds=(offset, n)`` of
        GLOBAL ids (K16); the stateful rules have no bounded form."""
        row_scatter_add_bounded(data, row_ids, delta, bounds[0], bounds[1],
                                self.sign)


class SGDRule(DefaultRule):
    name = "sgd"
    sign = -1.0

    def dense(self, data, state, delta, hyp, worker_id):
        add_(data, delta, -1)
        return data, state


def _per_worker_zeros(shape, dtype, num_workers: int, device):
    return torch.zeros((num_workers,) + tuple(shape),
                       dtype=torch_dtype(dtype), device=device)


def _read_slot(state, worker_id: int):
    """``state[worker_id]`` as JAX's dynamic index reads it: clamped."""
    return state[min(worker_id, state.shape[0] - 1)]


class MomentumRule(UpdaterRule):
    name = "momentum"
    stateless = False

    def init_state(self, shape, dtype, num_workers: int, device=None):
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                           device=device)

    def dense(self, data, state, delta, hyp, worker_id):
        step, smooth = rule_step(self.name, hyp, data, state, delta)
        add_(data, step, -1)
        state.copy_(smooth)
        return data, state


class AdaGradRule(UpdaterRule):
    name = "adagrad"
    stateless = False

    def init_state(self, shape, dtype, num_workers: int, device=None):
        # Per-worker historic squared gradients, leading worker axis
        # (ref: adagrad_updater.h:17-21).
        return _per_worker_zeros(shape, dtype, num_workers, device)

    def dense(self, data, state, delta, hyp, worker_id):
        # The reference's dense program also contracts the table's
        # update, ``data - (rho * g) * r``, into a fused multiply-add.
        f = flush
        s0 = _read_slot(state, worker_id)
        grad = f(f(delta) / scalar(_safe_lr(hyp[1]), data))
        g_sqr = fma(grad, grad, s0)
        rg = f(scalar(hyp[2], data) * grad)
        r = inv_sqrt(f(g_sqr + scalar(ADAGRAD_EPS, data)))
        data.copy_(fma(-rg, r, data))
        if worker_id < state.shape[0]:
            state[worker_id].copy_(g_sqr)
        return data, state


class DCASGDRule(UpdaterRule):
    """Delay-compensated ASGD: a delta from worker m (``lr * g``, the sgd
    convention) is compensated for the staleness since that worker's last
    update, ``w -= lr * (g + lambda * g * g * (w - backup[m]))``, and
    ``backup[m] = w``. The backup starts at zero."""

    name = "dcasgd"
    stateless = False

    def init_state(self, shape, dtype, num_workers: int, device=None):
        return _per_worker_zeros(shape, dtype, num_workers, device)

    def dense(self, data, state, delta, hyp, worker_id):
        f = flush
        lr = scalar(hyp[1], data)
        delta = f(delta)
        grad = f(delta / scalar(_safe_lr(hyp[1]), data))
        comp = f(f(f(scalar(hyp[3], data) * grad) * grad)
                 * f(f(data) - f(_read_slot(state, worker_id))))
        add_(data, fma(lr, comp, delta), -1)
        if worker_id < state.shape[0]:
            # A copy of the new table, never a view of the live storage.
            state[worker_id].copy_(data)
        return data, state


_RULES = {cls.name: cls for cls in
          (DefaultRule, SGDRule, MomentumRule, AdaGradRule, DCASGDRule)}
# The reference's flag value for the momentum updater is "momentum_sgd"
# (ref: src/updater/updater.cpp:47-58); accept both spellings.
_RULES["momentum_sgd"] = MomentumRule


def create_rule(updater_type: Optional[str] = None,
                dtype=np.float32) -> UpdaterRule:
    """Factory on the -updater_type flag (ref: src/updater/updater.cpp:
    42-58). Integer tables always get the default adder, as in the
    reference."""
    if np.issubdtype(np.dtype(dtype), np.integer):
        return DefaultRule()
    name = updater_type if updater_type is not None \
        else get_flag("updater_type")
    cls = _RULES.get(name)
    if cls is None:
        log.error("unknown updater_type %r; using default", name)
        return DefaultRule()
    return cls()
