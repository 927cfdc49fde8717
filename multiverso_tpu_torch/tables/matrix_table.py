"""2-D row-sharded distributed matrix table, dense or sparse.

Port of ``multiverso_tpu/tables/matrix_table.py`` — the reference's
``MatrixWorkerTable/MatrixServerTable`` (ref: include/multiverso/table/
matrix_table.h:16-127, src/table/matrix_table.cpp:13-468) and its sparse
variant (ref: src/table/sparse_matrix_table.cpp). Semantics preserved:

- row-range partition: each server owns ``num_row/num_servers`` rows,
  the last takes the remainder (ref: matrix_table.cpp:23-45);
- request keys: sentinel -1 = whole table, else an int32 row-id vector
  (ref: matrix_table.cpp:267-276);
- whole-table Get replies carry ``[keys, values, server_id]``; row Gets
  reply ``[row_ids, values]`` (ref: matrix_table.cpp:317-341, 420-454);
- DEVICE keys: a ``torch.Tensor`` of row ids (any shape, duplicates
  welcome) travels through the actors by reference and the reply is the
  tensor ``table[ids]`` — the in-process device path the word2vec
  pipeline pulls and pushes through;
- ``store``/``load`` stream the logical rows as raw row-major bytes
  (ref: matrix_table.cpp:456-464), so the two packages read each
  other's checkpoints;
- ``random_init`` draws the same numpy values as the reference
  (ref: matrix_table.cpp:372-384);
- SPARSE tables (``is_sparse=True``) keep a per-consumer bitmap of
  up-to-date rows on the server, ``num_workers`` consumers, twice that
  with ``is_pipeline`` (ref: sparse_matrix_table.cpp:184-197). Every
  Get carries the asking worker's id; a whole-table Get replies only
  that worker's dirty rows (all rows the first time) and marks them
  clean, and the worker places them at their global ids in a zeroed
  buffer unless the caller passes its own; a row Get marks its rows
  clean; an Add dirties its rows for every consumer but the adder,
  whose flags it leaves as they were (ref: sparse_matrix_table.cpp:
  200-309).

Each server shard is one ``torch.Tensor`` on the zoo's device. Row Gets
run on the row gather kernel (K2) and row Adds on the row scatter-add
kernel (K3) through the updater engine; the table is updated in place
(the reference donates its buffers to XLA instead). The sparse tables'
device-reply dirty Get (``get_dirty_device``, the ``-2`` sentinel) and
fused add + dirty Get (``add_get_dirty_device``, ``-4``, on B3) and
the segmented device protocol are later items of the port (ROADMAP A6,
B3, B11). The reference compresses sparse traffic only on a wire, which
comes with the multi-process transport (A9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.blob import Blob, is_device_array
from ..core.message import MsgType
from ..kernels.rows import row_gather
from ..sharding import mesh as meshlib
from ..updater import AddOption, GetOption, UpdateEngine, create_rule
from ..updater.engine import pad_ids
from ..util.log import CHECK
from .client_cache import place_rows
from .table_interface import ServerTable, WorkerTable

_ALL_KEY = np.array([-1], dtype=np.int32)


def row_offsets(num_row: int, num_servers: int) -> List[int]:
    """Row ranges per server incl. the degenerate rows<servers layout
    (ref: matrix_table.cpp:24-41). Returns num_actual_servers+1 offsets."""
    offsets = [0]
    length = num_row // num_servers
    if length > 0:
        offset = length
        i = 0
        while length > 0 and offset < num_row and i + 1 < num_servers:
            offsets.append(offset)
            offset += length
            i += 1
    else:
        offset = 1
        i = 0
        while offset < num_row and i + 1 < num_servers:
            offsets.append(offset)
            offset += 1
            i += 1
    offsets.append(num_row)
    return offsets


def _trim_rows(values, n_rows: int):
    """Slice gather output down to the real row count when padding added
    rows."""
    if values.shape[0] != n_rows:
        values = values[:n_rows]
    return values


@dataclass
class MatrixTableOption:
    """ref: include/multiverso/table/matrix.h:116-123."""
    num_row: int
    num_col: int
    dtype: object = np.float32
    is_sparse: bool = False
    is_pipeline: bool = False
    updater_type: Optional[str] = None


class MatrixWorker(WorkerTable):
    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 is_sparse: bool = False, is_pipeline: bool = False,
                 zoo=None, updater_type: Optional[str] = None):
        super().__init__(zoo=zoo)
        self.num_row = int(num_row)
        self.num_col = int(num_col)
        self.dtype = np.dtype(dtype)
        self.is_sparse = bool(is_sparse)
        # Device-key row adds may carry duplicate ids, which only sum
        # correctly under stateless rules: validate in the CALLER's
        # thread (a CHECK inside the server actor would only be logged).
        self._updater_stateless = create_rule(updater_type,
                                              self.dtype).stateless
        self._offsets = row_offsets(self.num_row, self._zoo.num_servers)
        self._num_server = len(self._offsets) - 1  # actual servers used
        self._row_length = max(self.num_row // self._num_server, 1)
        # One outstanding Get per table (the reference's shared row_index_
        # registers, ref: matrix_table.cpp:66-76). _dest xor
        # _device_shards names the reply destination.
        self._dest: Optional[np.ndarray] = None
        self._dest_rows: Optional[np.ndarray] = None
        self._device_shards: Optional[Dict[int, torch.Tensor]] = None

    def _server_of_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.minimum(rows // self._row_length, self._num_server - 1)

    def _check_row_ids(self, row_ids: np.ndarray) -> None:
        """Fail fast in the CALLER on out-of-range ids (partition runs in
        the worker actor, where an exception is only logged)."""
        if row_ids.size:
            lo, hi = int(row_ids.min()), int(row_ids.max())
            CHECK(lo >= 0 and hi < self.num_row,
                  "row ids out of range [0, num_row)")

    # -- Get API (ref: matrix_table.cpp:58-105) --
    def get(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        self.wait(self.get_async(out))
        return self._dest

    def get_async(self, out: Optional[np.ndarray] = None) -> int:
        if out is None:
            # A sparse whole-table Get returns only dirty rows, so a fresh
            # destination must be zeroed or the clean rows would surface
            # uninitialized memory; callers wanting incremental semantics
            # pass a persistent buffer.
            alloc = np.zeros if self.is_sparse else np.empty
            out = alloc((self.num_row, self.num_col), self.dtype)
        CHECK(out.shape == (self.num_row, self.num_col), "bad output shape")
        self._dest, self._dest_rows, self._device_shards = out, None, None
        return self._request_get(Blob(_ALL_KEY.view(np.uint8)))

    def get_rows(self, row_ids, out: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        self.wait(self.get_rows_async(row_ids, out))
        return self._dest

    def get_rows_async(self, row_ids,
                       out: Optional[np.ndarray] = None) -> int:
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int32).reshape(-1)
        self._check_row_ids(row_ids)
        if out is None:
            out = np.empty((row_ids.size, self.num_col), self.dtype)
        CHECK(out.shape == (row_ids.size, self.num_col), "bad output shape")
        self._dest = out
        # The requested id vector, kept for reply placement (ids may
        # repeat; every requested position gets its id's row).
        self._dest_rows = row_ids
        self._device_shards = None
        return self._request_get(Blob(row_ids.view(np.uint8)))

    def get_rows_device(self, row_ids) -> torch.Tensor:
        """Device-resident row pull: ``[k, num_col]`` as a tensor on the
        table's device, zero host copies (the reference's RequestParameter
        row pull, communicator.cpp:117-155, without leaving the card)."""
        self.wait(self.get_rows_device_async(row_ids))
        return self.take_device_rows()

    def get_rows_device_async(self, row_ids) -> int:
        """Async device row pull.

        HOST ids must be non-decreasing so each server's reply is one
        contiguous segment and the result reassembles by concatenation.

        DEVICE ids (a ``torch.Tensor``, int32) pass through the stack
        without touching the host: any shape, any order, duplicates
        welcome — the reply is ``table[row_ids]`` with shape
        ``row_ids.shape + (num_col,)``."""
        if is_device_array(row_ids):
            CHECK(self._zoo.servers_in_process,
                  "device-key row gets need the servers in this process")
            CHECK(not self.is_sparse,
                  "device-key gets are for dense tables (the sparse dirty "
                  "bookkeeping needs host ids)")
            CHECK(row_ids.dtype == torch.int32,
                  "device row ids must be int32")
            CHECK(self._num_server == 1,
                  "device-key row gets on a multi-server table (masked "
                  "broadcast, B1 bounded form) are not ported yet")
            self._dest, self._dest_rows = None, None
            self._device_shards = {}
            return self._request_get(Blob(row_ids))
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int32).reshape(-1)
        CHECK(row_ids.size > 0, "empty device row get")
        self._check_row_ids(row_ids)
        if self._num_server > 1:
            CHECK(bool(np.all(np.diff(row_ids) >= 0)),
                  "device row gets need sorted row ids")
        self._dest, self._dest_rows = None, None
        self._device_shards = {}
        return self._request_get(Blob(row_ids.view(np.uint8)))

    def _request_get(self, keys: Blob) -> int:
        extra = []
        if self.is_sparse:
            # Sparse gets carry the asking worker's id
            # (ref: sparse_matrix_table.h:27-43).
            extra.append(GetOption(self._zoo.worker_id).to_blob())
        return self.get_async_raw(keys, extra)

    def get_dirty_device(self):
        """The sparse dirty-row Get with a device reply (the ``-2``
        sentinel): not ported yet."""
        raise NotImplementedError(
            "get_dirty_device (the -2 device-reply dirty Get) is not "
            "ported yet (ROADMAP A6)")

    def add_get_dirty_device(self, row_ids, delta,
                             option: Optional[AddOption] = None,
                             get_worker: Optional[int] = None,
                             row_ids_device=None):
        """The fused sparse add + dirty Get (the ``-4`` sentinel): not
        ported yet."""
        raise NotImplementedError(
            "add_get_dirty_device (the -4 fused add + dirty Get) is not "
            "ported yet (ROADMAP B3)")

    def take_device_rows(self) -> torch.Tensor:
        """Assembled result of the last ``get_rows_device_async`` (call
        after ``wait``); clears the reply slot."""
        ordered = self.take_device_row_parts()
        if len(ordered) == 1:
            return ordered[0]
        return torch.cat(ordered, dim=0)

    def take_device_row_parts(self) -> List[torch.Tensor]:
        """The raw per-server reply shards of the last device get, in
        SERVER order, without assembling them."""
        shards = self._device_shards
        CHECK(shards is not None and len(shards) > 0,
              "no device row get outstanding")
        self._device_shards = None
        return [shards[sid] for sid in sorted(shards)]

    # -- Add API (ref: matrix_table.cpp:110-147) --
    def add(self, delta, option: Optional[AddOption] = None) -> None:
        self.wait(self.add_async(delta, option))

    def add_async(self, delta, option: Optional[AddOption] = None) -> int:
        """Whole-table add; a tensor delta stays on its device."""
        if not is_device_array(delta):
            delta = np.ascontiguousarray(delta, self.dtype).reshape(-1)
        CHECK(int(np.prod(tuple(delta.shape))) == self.num_row * self.num_col,
              "bad delta size")
        return self.add_async_raw(Blob(_ALL_KEY.view(np.uint8)),
                                  Blob(delta), self._option_blob(option))

    def add_rows(self, row_ids, delta,
                 option: Optional[AddOption] = None) -> None:
        self.wait(self.add_rows_async(row_ids, delta, option))

    def add_rows_async(self, row_ids, delta,
                       option: Optional[AddOption] = None) -> int:
        """Row-delta push. A tensor delta stays on the card end to end
        (the device twin of the reference's AddDeltaParameter,
        communicator.cpp:157-249). DEVICE row_ids keep the ids on the
        card too: any shape, delta shaped ``row_ids.shape +
        (num_col,)``. Duplicate ids SUM only under stateless updaters
        (default/sgd)."""
        if is_device_array(row_ids):
            CHECK(self._zoo.servers_in_process,
                  "device-key row adds need the servers in this process")
            CHECK(not self.is_sparse,
                  "device-key adds are for dense tables (the sparse dirty "
                  "bookkeeping needs host ids)")
            CHECK(self._updater_stateless,
                  "device-key row adds need a stateless updater "
                  "(default/sgd): duplicate ids must sum")
            CHECK(is_device_array(delta),
                  "device-key adds need a device delta")
            CHECK(tuple(delta.shape) ==
                  tuple(row_ids.shape) + (self.num_col,),
                  "bad device delta shape")
            CHECK(row_ids.dtype == torch.int32,
                  "device row ids must be int32")
            CHECK(self._num_server == 1,
                  "device-key row adds on a multi-server table (masked "
                  "broadcast, B2 bounded form) are not ported yet")
            return self.add_async_raw(Blob(row_ids), Blob(delta),
                                      self._option_blob(option))
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int32).reshape(-1)
        self._check_row_ids(row_ids)
        if not is_device_array(delta):
            delta = np.ascontiguousarray(delta, self.dtype).reshape(-1)
        CHECK(int(np.prod(tuple(delta.shape))) == row_ids.size * self.num_col,
              "bad delta size")
        return self.add_async_raw(Blob(row_ids.view(np.uint8)),
                                  Blob(delta), self._option_blob(option))

    def _option_blob(self, option: Optional[AddOption]) -> Blob:
        if option is None:
            option = AddOption(worker_id=max(self._zoo.worker_id, 0))
        return option.to_blob()

    def partition(self, blobs, msg_type) -> Dict[int, List[Blob]]:
        if blobs[0].on_device:
            # Device-key requests: the same blob list goes to the server
            # (object references — zero copies in-process).
            return {sid: list(blobs) for sid in range(self._num_server)}
        keys = blobs[0].as_array(np.int32)
        out: Dict[int, List[Blob]] = {}
        if keys.size == 1 and keys[0] < 0:
            CHECK(keys[0] == -1,
                  "negative key must be the whole-table sentinel (-1)")
            is_add = msg_type == MsgType.Request_Add
            values = blobs[1].typed(self.dtype) if is_add else None
            # Values may arrive flat [R*C] (host callers) or row-shaped
            # [R, C] (tensor deltas); slice in whichever layout they came.
            row_shaped = values is not None and len(values.shape) == 2
            for sid in range(self._num_server):
                shard = [blobs[0]]
                if values is not None:
                    lo, hi = self._offsets[sid], self._offsets[sid + 1]
                    chunk = values[lo:hi] if row_shaped \
                        else values[lo * self.num_col:hi * self.num_col]
                    shard.append(Blob(chunk))
                    if len(blobs) == 3:
                        shard.append(blobs[2])
                elif len(blobs) == 2:  # sparse Get: GetOption rides along
                    shard.append(blobs[1])
                out[sid] = shard
            return out
        # Row-id requests: bucket rows by owning server
        # (ref: matrix_table.cpp:267-276).
        CHECK(keys.size == 0 or (int(keys.min()) >= 0
                                 and int(keys.max()) < self.num_row),
              "row ids out of range [0, num_row)")
        is_add = msg_type == MsgType.Request_Add
        dest = self._server_of_rows(keys)
        values = dev_values = None
        if is_add:
            if blobs[1].on_device:
                dev_values = blobs[1].typed(self.dtype).reshape(
                    keys.size, self.num_col)
                if self._num_server > 1:
                    CHECK(bool(np.all(np.diff(dest) >= 0)),
                          "device row adds need sorted row ids")
            else:
                values = blobs[1].as_array(self.dtype).reshape(
                    keys.size, self.num_col)
        for sid in range(self._num_server):  # not np.unique: kv_table.py
            mask = dest == sid
            if not mask.any():
                continue
            shard = [Blob(np.ascontiguousarray(keys[mask]).view(np.uint8))]
            if dev_values is not None:
                lo, hi = np.searchsorted(dest, [sid, sid + 1])
                shard.append(Blob(dev_values[lo:hi]))
            elif values is not None:
                shard.append(Blob(np.ascontiguousarray(values[mask])))
            if is_add and len(blobs) == 3:
                shard.append(blobs[2])
            elif not is_add and len(blobs) == 2:  # sparse GetOption
                shard.append(blobs[1])
            out[int(sid)] = shard
        return out

    # -- replies (ref: matrix_table.cpp:317-341) --
    def process_reply_get(self, reply_blobs: List[Blob]) -> None:
        if reply_blobs[0].on_device:
            # Device-key reply: values shaped row_ids.shape + (num_col,),
            # still on the card — keyed by the origin server id.
            CHECK(self._device_shards is not None,
                  "device reply with no device get outstanding")
            sid = int(reply_blobs[2].as_array(np.int32)[0])
            self._device_shards[sid] = reply_blobs[1].typed(self.dtype)
            return
        keys = reply_blobs[0].as_array(np.int32)
        if keys.size == 1 and keys[0] == -1:
            server_id = int(reply_blobs[2].as_array(np.int32)[0])
            CHECK(self._dest is not None,
                  "Get reply with no outstanding destination — only one "
                  "Get may be in flight per table (as in the reference)")
            lo, hi = self._offsets[server_id], self._offsets[server_id + 1]
            values = reply_blobs[1].as_array(self.dtype)
            self._dest[lo:hi] = values.reshape(hi - lo, self.num_col)
            return
        if self._device_shards is not None:
            # Host-key device pull: keep the server's gather on the card,
            # keyed by the owning server (one contiguous key segment).
            sid = 0 if keys.size == 0 else \
                int(min(keys[0] // self._row_length, self._num_server - 1))
            self._device_shards[sid] = reply_blobs[1].typed(
                self.dtype).reshape(keys.size, self.num_col)
            return
        values = reply_blobs[1].as_array(self.dtype).reshape(
            keys.size, self.num_col)
        if self._dest_rows is None:
            # Sparse whole-table Get: dirty rows land at their global ids.
            self._dest[keys] = values
            return
        # Every requested position whose row id appears in THIS reply
        # shard gets that row's value (requests may repeat ids).
        place_rows(keys, values, self._dest_rows, self._dest)


class MatrixServer(ServerTable):
    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 is_sparse: bool = False, is_pipeline: bool = False,
                 zoo=None, updater_type: Optional[str] = None,
                 random_init: Optional[tuple] = None, seed: int = 0):
        rule = None if updater_type is None \
            else create_rule(updater_type, dtype)
        super().__init__(zoo=zoo)
        self.dtype = np.dtype(dtype)
        self.num_col = int(num_col)
        self.num_row = int(num_row)
        self.is_sparse = bool(is_sparse)
        offsets = row_offsets(int(num_row), self._zoo.num_servers)
        sid = self._zoo.server_id
        self.server_id = sid
        if sid >= len(offsets) - 1:
            self.row_offset, self.my_rows = 0, 0  # idle server
        else:
            self.row_offset = offsets[sid]
            self.my_rows = offsets[sid + 1] - offsets[sid]
        device = self._zoo.device
        padded = meshlib.padded_size(max(self.my_rows, 1))
        # Column storage pads to a multiple of 128 when that costs at
        # most 4x (the reference's storage layout, kept so the kernels
        # see the same [R, S >= num_col] shapes in both packages).
        self._col_store = self.num_col
        if self.num_col % 128:
            col_padded = ((self.num_col + 127) // 128) * 128
            if col_padded <= 4 * self.num_col:
                self._col_store = col_padded
        self._data = meshlib.zeros_sharded((padded, self._col_store),
                                           self.dtype, device)
        if random_init is not None:
            # Server ctor variant with uniform random init
            # (ref: matrix_table.cpp:372-384): the reference's numpy draw,
            # bit for bit.
            lo, hi = random_init
            rng = np.random.default_rng(seed + sid)
            values = rng.uniform(lo, hi, (self.my_rows, self.num_col)
                                 ).astype(self.dtype)
            self._data[:self.my_rows, :self.num_col] = \
                torch.from_numpy(values).to(device)
        num_workers = max(self._zoo.num_workers, 1)
        self._engine = UpdateEngine(rule, (padded, self._col_store),
                                    self.dtype, num_workers)
        self._updater_stateless = self._engine.rule.stateless
        # Sparse staleness bitmap: one slot per logical consumer;
        # pipelined workers count twice (ref: sparse_matrix_table.cpp:
        # 184-197).
        consumers = num_workers * (2 if is_pipeline else 1)
        self._up_to_date = np.zeros((consumers, self.my_rows), dtype=bool) \
            if is_sparse else None

    # -- Add (ref: matrix_table.cpp:386-418)
    def process_add(self, blobs: List[Blob]) -> None:
        CHECK(len(blobs) in (2, 3), "add needs [keys, values(, option)]")
        option = AddOption.from_blob(blobs[2]) if len(blobs) == 3 else None
        if blobs[0].on_device:
            # Device-key scatter-add: ids and delta never touch the host.
            CHECK(self._up_to_date is None,
                  "device-key adds are for dense tables")
            self._data = self._engine.apply_rows(
                self._data, blobs[0].typed(np.int32),
                blobs[1].typed(self.dtype), option)
            return
        keys = blobs[0].as_array(np.int32)
        delta = blobs[1].typed(self.dtype)
        if keys.size == 1 and keys[0] == -1:
            CHECK(int(np.prod(tuple(delta.shape)))
                  == self.my_rows * self.num_col,
                  "whole-table add size mismatch")
            self._data = self._engine.apply_dense(
                self._data, delta.reshape(self.my_rows, self.num_col),
                option)
            if self._up_to_date is not None:
                self._mark_dirty(slice(None), option)
            return
        local_rows = keys - self.row_offset
        self._data = self._engine.apply_rows(
            self._data, local_rows, delta.reshape(keys.size, self.num_col),
            option)
        if self._up_to_date is not None:
            self._mark_dirty(local_rows, option)

    def _mark_dirty(self, rows, option: Optional[AddOption]) -> None:
        """An Add invalidates the rows for every consumer except the adder,
        whose existing flags are left untouched — only Gets may mark a row
        up-to-date (ref: sparse_matrix_table.cpp:200-223). Setting the
        adder's flag True here would erase a pending dirty mark another
        worker's Add left on the same row."""
        adder = option.worker_id if option is not None else -1
        if 0 <= adder < self._up_to_date.shape[0]:
            saved = self._up_to_date[adder, rows].copy()
            self._up_to_date[:, rows] = False
            self._up_to_date[adder, rows] = saved
        else:
            self._up_to_date[:, rows] = False

    # -- Get (ref: matrix_table.cpp:420-454)
    def process_get(self, blobs: List[Blob]) -> List[Blob]:
        if blobs[0].on_device:
            # Device-key gather: reply values shaped ids.shape + (C,), on
            # the card. The server id rides along so the worker can key
            # the reply shard by ORIGIN server.
            CHECK(self._up_to_date is None,
                  "device-key gets are for dense tables")
            rows = blobs[0].typed(np.int32)
            return [blobs[0], Blob(row_gather(self._data, rows,
                                              self.num_col)),
                    Blob(np.array([self.server_id], dtype=np.int32))]
        keys = blobs[0].as_array(np.int32)
        if keys.size == 1 and keys[0] == -1:
            if self._up_to_date is not None and len(blobs) >= 2:
                return self._sparse_get_all(GetOption.from_blob(blobs[1]))
            return [blobs[0], Blob(self._values()),
                    Blob(np.array([self.server_id], dtype=np.int32))]
        values = self._gather_rows(keys)
        self._mark_clean(keys, blobs)
        return [blobs[0], Blob(values)]

    def _mark_clean(self, keys: np.ndarray, blobs: List[Blob]) -> None:
        """A sparse row Get marks its rows up-to-date for the asking
        worker (ref: sparse_matrix_table.cpp:261-308)."""
        if self._up_to_date is not None and len(blobs) >= 2:
            opt = GetOption.from_blob(blobs[1])
            if 0 <= opt.worker_id < self._up_to_date.shape[0]:
                self._up_to_date[opt.worker_id,
                                 keys - self.row_offset] = True

    def _sparse_get_all(self, opt: GetOption) -> List[Blob]:
        """Only this worker's dirty rows, flipped clean on read
        (ref: sparse_matrix_table.cpp:226-258)."""
        dirty = self._dirty_ids(opt.worker_id)
        return [Blob(dirty + self.row_offset), Blob(self._gather_rows(
            dirty + self.row_offset))]

    def _dirty_ids(self, wid: int) -> np.ndarray:
        CHECK(0 <= wid < self._up_to_date.shape[0], "bad worker id")
        dirty = np.nonzero(~self._up_to_date[wid])[0].astype(np.int32)
        self._up_to_date[wid, dirty] = True
        return dirty

    def _gather_rows(self, keys: np.ndarray) -> torch.Tensor:
        """Host row ids -> [k, num_col] on the card, through the bucket
        padding of the reference (the sentinel rows gather zeros)."""
        padded_rows = pad_ids(keys - self.row_offset, self._data.shape[0])
        ids = torch.from_numpy(padded_rows).to(self._data.device)
        return _trim_rows(row_gather(self._data, ids, self.num_col),
                          keys.size)

    # -- server-side request fusion (runtime/fusion.py) --
    def fuse_eligible(self, blobs: List[Blob], is_get: bool) -> bool:
        """Plain row-keyed host requests only (device keys and the
        whole-table sentinel keep their serial paths); fused Adds need a
        stateless rule, whose duplicates sum inside one scatter."""
        if not blobs or blobs[0].on_device:
            return False
        keys = blobs[0].as_array(np.int32)
        if keys.size == 0 or int(keys[0]) < 0:
            return False
        if is_get:
            return True
        return (self._updater_stateless and len(blobs) in (2, 3)
                and not blobs[1].on_device)

    def process_fused_get(self, requests: List[List[Blob]]
                          ) -> List[List[Blob]]:
        """N row Gets, ONE gather: concatenate the keys, dedup rows
        requested by more than one client, gather once and slice per
        request through the dedup inverse. Bit-identical to serial."""
        keys_list = [blobs[0].as_array(np.int32) for blobs in requests]
        uniq, inverse = np.unique(np.concatenate(keys_list),
                                  return_inverse=True)
        values = self._gather_rows(uniq.astype(np.int32))
        inverse = torch.from_numpy(inverse.astype(np.int64)).to(
            values.device)
        out: List[List[Blob]] = []
        pos = 0
        for blobs, keys in zip(requests, keys_list):
            sel = inverse[pos:pos + keys.size]
            pos += keys.size
            self._mark_clean(keys, blobs)
            out.append([blobs[0], Blob(values[sel])])
        return out

    def process_fused_add(self, requests: List[List[Blob]]) -> None:
        """N row Adds, ONE scatter per run of equal option bytes:
        stateless rules SUM duplicate ids inside one scatter, so the
        concatenation equals the serial left fold up to summation
        order. Every request parses before the first apply."""
        from ..runtime.fusion import PartialFuseError
        runs: List[tuple] = []  # (option bytes, option, [(keys, delta)])
        for blobs in requests:
            keys = blobs[0].as_array(np.int32)
            option = AddOption.from_blob(blobs[2]) \
                if len(blobs) == 3 else None
            okey = blobs[2].as_array(np.uint8).tobytes() \
                if len(blobs) == 3 else None
            delta = blobs[1].as_array(self.dtype).reshape(
                keys.size, self.num_col)
            if not runs or runs[-1][0] != okey:
                runs.append((okey, option, []))
            runs[-1][2].append((keys, delta))
        applied = 0
        for _, option, items in runs:
            try:
                local = (np.concatenate([k for k, _ in items])
                         - self.row_offset).astype(np.int32)
                delta = np.ascontiguousarray(
                    np.concatenate([d for _, d in items]))
                self._data = self._engine.apply_rows(self._data, local,
                                                     delta, option)
            except Exception as exc:  # noqa: BLE001
                raise PartialFuseError(applied, exc) from exc
            for keys, _ in items:
                applied += 1
                if self._up_to_date is not None:
                    self._mark_dirty(keys - self.row_offset, option)

    def _values(self) -> torch.Tensor:
        """A CLONE of the logical rows: the live storage is updated in
        place by every later Add, so a reply or snapshot must never
        alias it."""
        return self._data[:self.my_rows, :self.num_col].clone()

    # -- checkpoint (ref: matrix_table.cpp:456-464) --
    def store(self, stream) -> None:
        stream.write(self._values().cpu().numpy().tobytes())

    def load(self, stream) -> None:
        raw = stream.read(self.my_rows * self.num_col * self.dtype.itemsize)
        values = np.frombuffer(raw, dtype=self.dtype).reshape(
            self.my_rows, self.num_col)
        self._data.zero_()
        self._data[:self.my_rows, :self.num_col] = \
            torch.from_numpy(values.copy()).to(self._data.device)

    @property
    def raw(self) -> torch.Tensor:
        return self._values()
