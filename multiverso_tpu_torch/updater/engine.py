"""Updater engine: in-place updates of a table's torch storage.

Port of ``multiverso_tpu/updater/engine.py``. Binds an ``UpdaterRule``
to a concrete table. The reference donates the table buffers to XLA
(``donate_argnums``) so its jitted updates happen in place in HBM; the
port updates the storage tensor in place directly (every caller
rebinds to the returned tensor, which is the same object).

On a table of several servers a device-key row add carries GLOBAL
ids to every server; ``apply_rows(..., bounds=)`` keeps each server to
its window (K16, the reference's ``_bounded_rows_fn``).

Row calls keep the reference's bucket contract: host row ids pad to a
power-of-two bucket with the out-of-range sentinel (``pad_ids`` /
``pad_rows``, unchanged), so the ids on the wire and in the API have
the same shapes in both packages; the row kernels (K3 for the stateless
rules, K13 for the stateful ones, K14 for the fused update + gather)
drop the sentinel. The reference zero-extends a row delta to the table's
width and to the id count (``pad_cols``, ``pad_row_count``), and adding
that zero flushes a subnormal table element and moves a stateful rule's
state (ROADMAP C12): ``_extend`` does the same wherever an in-range id
lies past the delta's rows, or the delta is narrower than the engine's
``cols``, and copies nothing on the usual shapes. A table's storage
columns past ``cols`` are padding that every rule keeps at +0.
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
                 num_workers: int, device=None, cols: Optional[int] = None):
        self.rule = rule if rule is not None else create_rule(dtype=dtype)
        self.shape = tuple(shape)
        # The columns that hold values: a row delta is zero-extended to
        # them; the storage past them stays +0 under every rule.
        self.cols = self.shape[-1] if cols is None else cols
        self.dtype = np.dtype(dtype)
        # Optimizer state lives on the table's device, shaped like the
        # storage (with a leading worker axis for adagrad and dcasgd).
        self._state = self.rule.init_state(self.shape, self.dtype,
                                           num_workers, device)

    def apply_dense(self, data: torch.Tensor, delta,
                    option: Optional[AddOption] = None) -> torch.Tensor:
        """Whole-shard update; ``delta`` covers the logical rows and
        columns (a 1-D shard: the logical elements). The reference
        zero-extends it to the storage shape; the rule runs on the
        logical block of the table and of its state instead, which is
        the same: the padding holds zeros in both and a zero delta
        leaves it so under every rule."""
        hyp, worker_id = _unpack(option)
        delta = _on(delta, data.device)
        if data.dim() == 1:
            block = (slice(0, delta.numel()),)
            delta = delta.reshape(-1)
        else:
            rows, cols = delta.shape[0], delta.shape[-1]
            block = (slice(0, rows), slice(0, cols))
            delta = delta.reshape(rows, cols)
        state = self._state
        if state is not None:
            lead = (slice(None),) * (state.dim() - data.dim())
            state = state[lead + block]
        self.rule.dense(data[block], state, delta, hyp, worker_id)
        return data

    def apply_rows(self, data: torch.Tensor, row_ids, delta,
                   option: Optional[AddOption] = None,
                   bounds: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``row_ids`` int32[k], ``delta`` [k, ...]: host ids pad to a
        power-of-two bucket with out-of-range indices (dropped). Device
        ids (a tensor of any shape, delta shaped ids.shape + row shape)
        pass as they are. ``bounds=(offset, n)``: the ids are GLOBAL and
        only those in ``[offset, offset + n)`` update this shard, at
        local row ``id - offset`` (K16); every other id drops (the
        reference's ``_bounded_rows_fn``). Stateless rules only."""
        hyp, worker_id = _unpack(option)
        if is_device_array(row_ids) or bounds is not None:
            # Device-key ids may carry duplicates, which only SUM
            # correctly under stateless rules.
            CHECK(self._state is None,
                  "device-key row adds need a stateless updater "
                  "(default/sgd): duplicate ids must sum")
        distinct = False
        host = not is_device_array(row_ids)
        if host:
            distinct = ascending(row_ids, self.shape[0])
            row_ids, delta = pad_rows(row_ids, delta, self.shape[0])
        delta = _on(delta, data.device)
        delta = delta.reshape(-1, delta.shape[-1]) if delta.dim() >= 2 \
            else delta.reshape(int(np.prod(np.shape(row_ids))), -1)
        if host:
            row_ids = _trim(row_ids, delta.shape[0], self.shape[0])
        ids = _on(row_ids, data.device).to(torch.int32)
        delta = self._extend(ids.numel(), delta)
        if bounds is None:
            self.rule.rows(data, self._state, ids.reshape(-1),
                           delta.contiguous(), hyp, worker_id,
                           distinct=distinct)
        else:
            self.rule.rows_bounded(data, ids.reshape(-1),
                                   delta.contiguous(), bounds)
        return data

    def apply_rows_gather(self, data: torch.Tensor, row_ids, delta,
                          option: Optional[AddOption], get_ids,
                          n_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """FUSED row update + row gather in ONE launch (K14): apply the
        delta, then gather ``get_ids`` from the UPDATED table. Returns
        (data, values ``[len(get_ids), n_col]``). Both id vectors arrive
        padded to power-of-two buckets (out-of-range ids drop or gather
        zeros), as in the reference, which compiles one program a
        bucket width; the add ids' padding is CHECKed as there."""
        hyp, worker_id = _unpack(option)
        k = int(np.shape(row_ids)[0])
        CHECK(k == bucket_size(k),
              "apply_rows_gather ids must be bucket-padded "
              "(pad_ids on the host, a pad_ids-built device mirror)")
        # Host ids are inspected here, a device mirror is not: only host
        # ids found ascending (before their bucket padding) are claimed
        # distinct, and the stateless rules' add then needs no sort.
        distinct = not is_device_array(row_ids) and ascending(
            unpadded(row_ids, self.shape[0]), self.shape[0])
        delta = _on(delta, data.device)
        delta = delta.reshape(-1, delta.shape[-1]).contiguous()
        if not is_device_array(row_ids):
            row_ids = _trim(row_ids, delta.shape[0], self.shape[0])
        ids = _on(row_ids, data.device).to(torch.int32).reshape(-1)
        gets = _on(get_ids, data.device).to(torch.int32).reshape(-1)
        # A device mirror is built by ``pad_ids``: past the delta's rows
        # it holds the sentinel only.
        delta = self._extend(delta.shape[0] if is_device_array(row_ids)
                             else ids.numel(), delta)
        values = self.rule.rows_gather(data, self._state, ids, delta, hyp,
                                       worker_id, gets, n_col,
                                       distinct=distinct)
        return data, values

    def _extend(self, n: int, delta: torch.Tensor) -> torch.Tensor:
        """``delta`` [k, d] zero-extended to ``n`` rows and ``cols``
        columns, as the reference's engine extends it; the tensor itself
        where it already covers them."""
        k, d = delta.shape
        if k >= n and d >= self.cols:
            return delta
        out = delta.new_zeros((max(n, k), max(d, self.cols)))
        out[:k, :d] = delta
        return out

    @property
    def state(self):
        return self._state


def _unpack(option: Optional[AddOption]) -> Tuple[np.ndarray, int]:
    if option is None:
        return _DEFAULT_HYP, 0
    return option.hyper_array(), max(option.worker_id, 0)


def _trim(row_ids, k: int, num_rows: int) -> np.ndarray:
    """Host ids without the ids past the delta's ``k`` rows where those
    are all out of range (the bucket padding's sentinels: they take a
    zero delta and drop, so the delta need not be extended for them)."""
    ids = np.asarray(row_ids).reshape(-1)
    tail = ids[k:]
    if tail.size and not np.any((tail >= -num_rows) & (tail < num_rows)):
        return ids[:k]
    return ids


def ascending(row_ids, num_rows: int) -> bool:
    """Whether host row ids are all in ``[0, num_rows)`` and strictly
    ascending (then distinct: the row scatter needs no sort; the bucket
    padding that follows adds only sentinels, which drop)."""
    ids = np.asarray(row_ids).reshape(-1)
    return ids.size == 0 or (int(ids[0]) >= 0 and int(ids[-1]) < num_rows
                             and bool(np.all(ids[1:] > ids[:-1])))


def unpadded(row_ids, num_rows: int) -> np.ndarray:
    """Host row ids without the trailing run of the pad sentinel
    ``num_rows`` that ``pad_ids`` appends."""
    ids = np.asarray(row_ids).reshape(-1)
    kept = np.flatnonzero(ids != num_rows)
    return ids[:kept[-1] + 1 if kept.size else 0]


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
