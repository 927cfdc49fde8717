"""Server-side update rules over torch table storage.

Port of ``multiverso_tpu/updater/rules.py`` (ref: include/multiverso/
updater/, src/updater/updater.cpp:23-58) for the stateless rules the
slice needs:

- default: ``data += delta`` (ref: src/updater/updater.cpp:24-31)
- sgd: ``data -= delta`` — the caller pre-multiplies the learning rate
  (ref: include/multiverso/updater/sgd_updater.h:15-19)

The reference's rules are pure functions whose storage XLA updates in
place through buffer donation (``donate_argnums``,
``multiverso_tpu/updater/engine.py:83-84``); here each rule updates the
table tensor IN PLACE and returns it. Row updates run on the row
scatter-add kernel (K3, ``kernels/rows.py``): duplicate ids sum,
out-of-range ids drop. The stateful rules (momentum, adagrad, dcasgd)
are ROADMAP item B12 and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..kernels.rows import row_scatter_add
from ..util import log
from ..util.configure import define_string, get_flag

define_string("updater_type", "default",
              "server updater: default / sgd / momentum / adagrad / "
              "dcasgd")

#: Stateful rules of the reference not ported yet (ROADMAP B12).
UNPORTED_RULES = ("momentum", "momentum_sgd", "adagrad", "dcasgd")


class UpdaterRule:
    """An update rule: (data, state, delta, hyp, worker_id) -> (data,
    state), with ``data`` updated in place."""

    name = "base"
    # True when init_state returns None — i.e. duplicate row ids in one
    # scatter-add SUM correctly.
    stateless = True

    def init_state(self, shape, dtype, num_workers: int) -> Any:
        return None

    def dense(self, data, state, delta, hyp, worker_id):
        raise NotImplementedError

    def rows(self, data, state, row_ids, delta, hyp, worker_id):
        """Row-sparse update. ``row_ids`` may be padded with
        out-of-range indices (>= data.shape[0]), which are dropped;
        ``delta`` [k, d] may have fewer rows than ids and fewer columns
        than the storage (zero extension)."""
        raise NotImplementedError


class DefaultRule(UpdaterRule):
    name = "default"

    def dense(self, data, state, delta, hyp, worker_id):
        data += delta
        return data, state

    def rows(self, data, state, row_ids, delta, hyp, worker_id):
        row_scatter_add(data, row_ids, delta, 1.0)
        return data, state


class SGDRule(UpdaterRule):
    name = "sgd"

    def dense(self, data, state, delta, hyp, worker_id):
        data -= delta
        return data, state

    def rows(self, data, state, row_ids, delta, hyp, worker_id):
        row_scatter_add(data, row_ids, delta, -1.0)
        return data, state


_RULES = {cls.name: cls for cls in (DefaultRule, SGDRule)}


def create_rule(updater_type: Optional[str] = None,
                dtype=np.float32) -> UpdaterRule:
    """Factory on the -updater_type flag (ref: src/updater/updater.cpp:
    42-58). Integer tables always get the default adder, as in the
    reference."""
    if np.issubdtype(np.dtype(dtype), np.integer):
        return DefaultRule()
    name = updater_type if updater_type is not None \
        else get_flag("updater_type")
    if name in UNPORTED_RULES:
        raise NotImplementedError(
            f"updater {name!r} keeps per-row state; the stateful rules "
            f"are not ported yet (ROADMAP B12)")
    cls = _RULES.get(name)
    if cls is None:
        log.error("unknown updater_type %r; using default", name)
        return DefaultRule()
    return cls()
