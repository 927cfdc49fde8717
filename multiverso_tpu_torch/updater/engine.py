"""Updater engine: in-place updates of a table's torch storage.

Port of ``multiverso_tpu/updater/engine.py``. Binds an ``UpdaterRule``
to a concrete table. The reference donates the table buffers to XLA
(``donate_argnums``) so its jitted updates happen in place in HBM; the
port updates the storage tensor in place directly (every caller
rebinds to the returned tensor, which is the same object).

Row calls keep the reference's bucket contract: host row ids pad to a
power-of-two bucket with the out-of-range sentinel (``pad_ids`` /
``pad_rows``, unchanged), so the ids on the wire and in the API have
the same shapes in both packages; the row scatter-add kernel drops the
sentinel, zero-extends the delta in columns and rows, and sums
duplicates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.blob import is_device_array
from ..util.log import CHECK
from .options import AddOption
from .rules import UpdaterRule, create_rule

_DEFAULT_HYP = AddOption().hyper_array()


def bucket_size(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= n (>= minimum)."""
    size = minimum
    while size < n:
        size *= 2
    return size


def _on(x, device: torch.device) -> torch.Tensor:
    """A host array or tensor as a tensor on ``device``."""
    if is_device_array(x):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class UpdateEngine:
    """Applies a rule to a table's storage tensor, in place."""

    def __init__(self, rule: Optional[UpdaterRule], shape, dtype,
                 num_workers: int):
        self.rule = rule if rule is not None else create_rule(dtype=dtype)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._state = self.rule.init_state(self.shape, self.dtype,
                                           num_workers)

    def apply_dense(self, data: torch.Tensor, delta,
                    option: Optional[AddOption] = None) -> torch.Tensor:
        """Whole-shard update; ``delta`` covers the logical rows and
        columns (a 1-D shard: the logical elements) and is zero-extended
        to the storage shape (the padding adds zero, so only the logical
        block is touched)."""
        hyp, worker_id = _unpack(option)
        delta = _on(delta, data.device)
        if data.dim() == 1:
            size = delta.numel()
            self.rule.dense(data[:size], self._state, delta.reshape(size),
                            hyp, worker_id)
            return data
        rows, cols = delta.shape[0], delta.shape[-1]
        view = data[:rows, :cols]
        self.rule.dense(view, self._state, delta.reshape(rows, cols), hyp,
                        worker_id)
        return data

    def apply_rows(self, data: torch.Tensor, row_ids, delta,
                   option: Optional[AddOption] = None) -> torch.Tensor:
        """``row_ids`` int32[k], ``delta`` [k, ...]: host ids pad to a
        power-of-two bucket with out-of-range indices (dropped). Device
        ids (a tensor of any shape, delta shaped ids.shape + row shape)
        pass as they are."""
        hyp, worker_id = _unpack(option)
        if is_device_array(row_ids):
            # Device-key ids may carry duplicates, which only SUM
            # correctly under stateless rules.
            CHECK(self._state is None,
                  "device-key row adds need a stateless updater "
                  "(default/sgd): duplicate ids must sum")
        else:
            row_ids, delta = pad_rows(row_ids, delta, self.shape[0])
        ids = _on(row_ids, data.device).to(torch.int32)
        delta = _on(delta, data.device)
        delta = delta.reshape(-1, delta.shape[-1]) if delta.dim() >= 2 \
            else delta.reshape(ids.numel(), -1)
        self.rule.rows(data, self._state, ids.reshape(-1),
                       delta.contiguous(), hyp, worker_id)
        return data

    @property
    def state(self):
        return self._state


def _unpack(option: Optional[AddOption]) -> Tuple[np.ndarray, int]:
    if option is None:
        return _DEFAULT_HYP, 0
    return option.hyper_array(), max(option.worker_id, 0)


def pad_ids(row_ids, num_rows: int) -> np.ndarray:
    """Pad a row-id vector to the next bucket size with an out-of-range
    sentinel (gather fills zeros, scatter drops)."""
    row_ids = np.asarray(row_ids, dtype=np.int32)
    b = bucket_size(row_ids.shape[0])
    if b != row_ids.shape[0]:
        row_ids = np.concatenate(
            [row_ids, np.full(b - row_ids.shape[0], num_rows,
                              dtype=np.int32)])
    return row_ids


def pad_rows(row_ids, delta, num_rows: int):
    """Pad (row_ids, delta) to the next bucket size; padding rows index
    out-of-range so scatter drops them and gather fills zeros. DEVICE
    deltas pass through logical-sized — the scatter kernel extends them
    to the id count itself."""
    row_ids = np.asarray(row_ids, dtype=np.int32)
    k = row_ids.shape[0]
    b = bucket_size(k)
    if b != k:
        row_ids = np.concatenate(
            [row_ids, np.full(b - k, num_rows, dtype=np.int32)])
        if not is_device_array(delta):
            pad = ((0, b - k),) + ((0, 0),) * (len(np.shape(delta)) - 1)
            delta = np.pad(np.asarray(delta), pad)
    return row_ids, delta
