"""2-D row-sharded distributed matrix table, dense or sparse.

Port of ``multiverso_tpu/tables/matrix_table.py`` — the reference's
``MatrixWorkerTable/MatrixServerTable`` (ref: include/multiverso/table/
matrix_table.h:16-127, src/table/matrix_table.cpp:13-468) and its sparse
variant (ref: src/table/sparse_matrix_table.cpp). Semantics preserved:

- row-range partition: each server owns ``num_row/num_servers`` rows,
  the last takes the remainder (ref: matrix_table.cpp:23-45);
- request keys: sentinel -1 = whole table, else an int32 row-id vector
  (ref: matrix_table.cpp:267-276); the sparse tables' device protocols
  add -2 (dirty rows, device reply) and -4 (fused add + dirty rows);
- whole-table Get replies carry ``[keys, values, server_id]``; row Gets
  reply ``[row_ids, values]`` (ref: matrix_table.cpp:317-341, 420-454);
- DEVICE keys: a ``torch.Tensor`` of row ids (any shape, duplicates
  welcome) travels through the actors by reference and the reply is the
  tensor ``table[ids]`` — the in-process device path the word2vec
  pipeline pulls and pushes through. On a table of several servers the
  SAME ids go to every server, each gathers (K15) or adds (K16) only the
  rows of its window and the worker sums the replies; a SEGMENTED
  request (``-3``) instead carries one id segment a server, which goes
  to that server alone;
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
kernel (K3, stateless rules) or the row rule kernel (K13, stateful
rules) through the updater engine; the table is updated in place (the
reference donates its buffers to XLA instead). Device replies stay on
the card: ``get_device`` (a dense whole-table Get, a clone of the
table), the sparse tables' ``get_dirty_device`` (``-2``: host dirty
ids, rows gathered by K2) and ``add_get_dirty_device`` (``-4``: a row
add and the dirty Get in one launch of K14, for one in-process
server). The reference compresses sparse traffic only on a wire,
which comes with the multi-process transport (A9).

The dense tables' host row path carries the client cache
(``client_cache.RowCache``, ``-max_get_staleness``): a row Get serves
its fresh rows locally and fetches only the missing ones, an own Add
blocks the rows it dirties until its ack, ``prefetch_rows_async`` warms
the cache and a Get whose missing rows a prefetch in flight covers
joins it. The cache is never built under ``-sync``. ``-one_bit_push``
quantizes a dense float32 table's host Add traffic to sign bits and
two means a server shard (``util.quantization.OneBitFilter``), with the
quantization error fed back into the worker's next push of the same
rows; the server decodes it and applies it through its usual rule
(K3 for host row ids).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.blob import Blob, is_device_array
from ..core.message import MsgType
from ..kernels.rows import row_gather, row_gather_bounded
from ..sharding import mesh as meshlib
from ..updater import AddOption, GetOption, UpdateEngine, create_rule
from ..updater.engine import bucket_size, pad_ids
from ..util.configure import define_bool, get_flag
from ..util.dashboard import count as count_event
from ..util.log import CHECK
from ..util.quantization import OneBitFilter
from . import client_cache
from .client_cache import RowCache, place_rows
from .table_interface import ServerTable, WorkerTable

define_bool("verify_device_ids", False,
            "read back a fused add's device row-id mirror on its first "
            "use and CHECK it against the host ids")
define_bool("one_bit_push", False,
            "1-bit quantize matrix Add traffic (sign bitmap + per-sign "
            "means, worker-side error feedback)")

_ALL_KEY = np.array([-1], dtype=np.int32)
# Sparse dirty-row Get whose values reply on the device (host ids).
_ALL_KEY_DEVICE_REPLY = np.array([-2], dtype=np.int32)
# Pre-segmented device-key request: [-3, seg_0..seg_{S-1}] (Get), or
# [-3, seg_0..seg_{S-1}, delta_0..delta_{S-1}, option] (Add).
_SEGMENTED_KEY = np.array([-3], dtype=np.int32)
# Fused sparse add + dirty-row Get, one in-process server: a Get whose
# blobs are [-4, rows, delta, add option, get option(, device rows)].
_ADD_GET_DIRTY_KEY = np.array([-4], dtype=np.int32)


def _onebit_blobs(chunk: np.ndarray):
    """Encode one server's (error-feedback-adjusted) delta chunk as
    [sign bits, meta]; meta = [pos_mean, neg_mean, element count].
    Returns (blobs, residual) — the caller accumulates the residual into
    its feedback buffer."""
    encoded, residual = OneBitFilter().encode(chunk)
    bits, pos_mean, neg_mean, size = encoded
    meta = np.array([pos_mean, neg_mean, float(size)], np.float64)
    return [Blob(bits), Blob(meta)], residual


def _onebit_decode(bits_blob: Blob, meta_blob: Blob) -> np.ndarray:
    meta = meta_blob.as_array(np.float64)
    return OneBitFilter().decode(
        (bits_blob.as_array(np.uint8), float(meta[0]),
         float(meta[1]), int(meta[2])))


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
        # Consumer-slot count, mirroring the server's bitmap height, so
        # a bad consumer id fails in the caller instead of hanging on a
        # reply the server actor never sends.
        self._num_consumers = max(self._zoo.num_workers, 1) \
            * (2 if is_pipeline else 1)
        # Device-key row adds may carry duplicate ids, which only sum
        # correctly under stateless rules: validate in the CALLER's
        # thread (a CHECK inside the server actor would only be logged).
        self._updater_stateless = create_rule(updater_type,
                                              self.dtype).stateless
        # 1-bit push quantization (dense float32 tables): only host
        # pushes quantize, pulls stay full precision. The error-feedback
        # buffer is table-shaped, made at the first push.
        self._one_bit = (not self.is_sparse
                         and self.dtype == np.float32
                         and bool(get_flag("one_bit_push")))
        self._residual: Optional[np.ndarray] = None
        self._offsets = row_offsets(self.num_row, self._zoo.num_servers)
        self._num_server = len(self._offsets) - 1  # actual servers used
        self._row_length = max(self.num_row // self._num_server, 1)
        # One outstanding Get per table (the reference's shared row_index_
        # registers, ref: matrix_table.cpp:66-76). _dest xor
        # _device_shards names the reply destination.
        self._dest: Optional[np.ndarray] = None
        self._dest_rows: Optional[np.ndarray] = None
        self._device_shards: Optional[Dict[int, torch.Tensor]] = None
        # Device-key replies over several servers SUM (each server
        # zero-fills foreign rows); every other device reply concatenates.
        self._device_sum = False
        # Host ids of each server's device dirty-row reply (-2, -4).
        self._device_shard_ids: Optional[Dict[int, np.ndarray]] = None
        self._mirror_verified = False  # -verify_device_ids: once a table
        # Client cache: row-granular, DENSE host-path row Gets only.
        # Sparse tables are excluded (their dirty-row protocol is a
        # server-tracked staleness cache) and device replies bypass it.
        # Built on the dense path whatever the bound (bound 0 is an
        # inactive pass-through, so a live retune can widen it), never
        # under -sync: a locally served Get would bypass the vector
        # clocks.
        self._row_cache: Optional[RowCache] = None
        if not self.is_sparse and not get_flag("sync", False):
            self._row_cache = RowCache(
                client_cache.staleness_bound(), self._server_of_rows,
                max(self._zoo.num_servers, self._num_server),
                self._version_tracker)
            self._caches.append(self._row_cache)
        # In-flight prefetches: msg_id -> sorted unique ids being
        # fetched; _pf_by_key dedups identical prefetches; _pf_joined
        # holds Gets deferred onto an in-flight prefetch. Prefetches and
        # joins issue on the requester's thread, completion runs on the
        # worker actor's.
        self._pf_lock = threading.Lock()
        self._pf_rows: Dict[int, np.ndarray] = {}
        self._pf_by_key: Dict[bytes, int] = {}
        self._pf_joined: Dict[int, List] = {}

    def _live_cache(self) -> Optional[RowCache]:
        """The row cache when ACTIVE (live bound > 0), else None: the
        gate of every read-path use."""
        cache = self._row_cache
        if cache is not None and cache.active:
            return cache
        return None

    def observed_versions(self) -> Dict[int, int]:
        """Latest shard version this worker has OBSERVED, per server id
        (-1 before any reply): what the client cache measures staleness
        against."""
        return {s: self._version_tracker.latest(s)
                for s in range(self._num_server)}

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
        if self._live_cache() is not None:
            # Partial-hit serve: fresh rows fill their positions
            # locally; only the MISSING unique rows are requested (the
            # reply placement handles subset keys).
            missing = self._row_cache.fetch_into(row_ids, out)
            if missing.size == 0:
                return self._local_done()
            # Missing rows a prefetch in flight is already fetching:
            # defer onto its completion instead of a second request.
            joined = self._join_inflight(missing, row_ids, out)
            if joined is not None:
                return joined
            return self._request_get(Blob(missing.view(np.uint8)))
        return self._request_get(Blob(row_ids.view(np.uint8)))

    # -- client-cache prefetch + in-flight Get dedup --
    def prefetch_rows_async(self, row_ids) -> int:
        """Warm the client cache for ``row_ids`` without touching the
        one-Get-in-flight destination registers: the reply routes into
        the cache, so a later ``get_rows`` for (a subset of) these rows
        hits locally or joins the fetch in flight. Returns a request id
        (``wait`` is optional). A no-op when the cache is inactive
        (``-max_get_staleness=0``, or ``-sync``)."""
        if self._live_cache() is None:
            return self._local_done()
        rows = np.unique(np.ascontiguousarray(
            row_ids, dtype=np.int32).reshape(-1))
        self._check_row_ids(rows)
        # Fetch only what the cache is missing.
        rows = self._row_cache.missing_of(rows)
        if rows.size == 0:
            return self._local_done()
        key = rows.tobytes()
        with self._pf_lock:
            existing = self._pf_by_key.get(key)
            if existing is not None:
                return existing  # identical prefetch already in flight
            msg_id = self._new_request()
            self._pf_rows[msg_id] = rows
            self._pf_by_key[key] = msg_id
            # Registered BEFORE the send: the completion sweep must find
            # this prefetch however fast the reply lands.
            self.add_completion(msg_id, self._on_prefetch_done)
        count_event(client_cache.PREFETCH)
        self._send_request(MsgType.Request_Get,
                           [Blob(rows.view(np.uint8))], msg_id)
        return msg_id

    def _join_inflight(self, missing: np.ndarray, row_ids: np.ndarray,
                       out: np.ndarray) -> Optional[int]:
        """If a prefetch in flight covers every MISSING row, defer this
        Get onto it: completion re-serves from the cache, requesting
        only what still is not there. Either way the returned id
        completes."""
        with self._pf_lock:
            if not self._pf_rows:
                return None
            for pf_id, pf_rows in self._pf_rows.items():
                if np.isin(missing, pf_rows).all():
                    msg_id = self._new_request()
                    self._pf_joined.setdefault(pf_id, []).append(
                        (msg_id, row_ids, out))
                    count_event(client_cache.JOIN)
                    return msg_id
        return None

    def _on_prefetch_done(self, pf_id: int) -> None:
        """Prefetch completion (worker actor thread): retire the entry
        and settle every joined Get — from the cache for whatever landed
        and survived, with a request only for rows still missing (an
        invalidation raced the prefetch)."""
        with self._pf_lock:
            rows = self._pf_rows.pop(pf_id, None)
            if rows is not None:
                self._pf_by_key.pop(rows.tobytes(), None)
            joined = self._pf_joined.pop(pf_id, [])
        for msg_id, req_rows, out in joined:
            # count_stats=False: the joined Get counted its miss at
            # issue time.
            missing = self._row_cache.fetch_into(req_rows, out,
                                                 count_stats=False)
            if missing.size == 0:
                self.notify(msg_id)
            else:
                self._send_request(MsgType.Request_Get,
                                   [Blob(missing.view(np.uint8))],
                                   msg_id)

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
        ``row_ids.shape + (num_col,)``. On several servers the SAME ids
        go to every server; each gathers only its own rows (foreign rows
        fill 0, K15) and the worker SUMS the replies — every row is owned
        by exactly one server, so the sum is the exact gather, at one
        more ``[k, C]`` pass a server."""
        if is_device_array(row_ids):
            CHECK(self._zoo.servers_in_process,
                  "device-key row gets need the servers in this process")
            CHECK(not self.is_sparse,
                  "device-key gets are for dense tables (the sparse dirty "
                  "bookkeeping needs host ids)")
            CHECK(row_ids.dtype == torch.int32,
                  "device row ids must be int32")
            self._dest, self._dest_rows = None, None
            self._device_shards = {}
            self._device_sum = self._num_server > 1
            return self._request_get(Blob(row_ids))
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int32).reshape(-1)
        CHECK(row_ids.size > 0, "empty device row get")
        self._check_row_ids(row_ids)
        if self._num_server > 1:
            CHECK(bool(np.all(np.diff(row_ids) >= 0)),
                  "device row gets need sorted row ids")
        self._dest, self._dest_rows = None, None
        self._device_shards = {}
        self._device_sum = False  # host-key replies CONCATENATE (a stale
        # True from an errored device-key get must not survive)
        return self._request_get(Blob(row_ids.view(np.uint8)))

    def _request_get(self, keys: Blob) -> int:
        extra = []
        if self.is_sparse:
            # Sparse gets carry the asking worker's id
            # (ref: sparse_matrix_table.h:27-43).
            extra.append(GetOption(self._zoo.worker_id).to_blob())
        return self.get_async_raw(keys, extra)

    def get_dirty_device(self):
        """Sparse dirty-row pull with a device reply: ``(row_ids,
        values)``, the ids on the host (the staleness bookkeeping is a
        host bitmap) and the values ``[k, num_col]`` on the table's
        device — the reference's dirty-only Get (ref:
        sparse_matrix_table.cpp:226-258) without the host copy."""
        CHECK(self.is_sparse, "dirty gets are for sparse tables")
        CHECK(self._zoo.servers_in_process,
              "device dirty gets need the servers in this process "
              "(the reply payload is a live device tensor)")
        self._begin_dirty_reply()
        self.wait(self._request_get(
            Blob(_ALL_KEY_DEVICE_REPLY.view(np.uint8))))
        shards, ids = self._end_dirty_reply()
        CHECK(len(shards) == self._num_server,
              "dirty get: one reply per server")
        order = sorted(shards)
        if len(order) == 1:
            return ids[order[0]], shards[order[0]]
        # Each server's dirty set is sorted within its own row range, so
        # server order is global order.
        return (np.concatenate([ids[sid] for sid in order]),
                torch.cat([shards[sid] for sid in order]))

    def add_get_dirty_device(self, row_ids, delta,
                             option: Optional[AddOption] = None,
                             get_worker: Optional[int] = None,
                             row_ids_device=None):
        """FUSED add + dirty pull: apply a row delta, then return the
        dirty rows of consumer ``get_worker`` (default: this worker) —
        the exact composition of ``add_rows`` and ``get_dirty_device``,
        as one request and one launch on the server (K14). One
        in-process server, async mode (a hidden add inside a Get would
        bypass the BSP clocks). ``option`` names the adder as usual.

        ``row_ids_device``: an optional device mirror of ``row_ids``,
        bucket-padded (``pad_ids(row_ids, num_row)`` on the table's
        device), which the server scatters with instead of uploading the
        host ids; stateless updaters only, as with device-key adds."""
        CHECK(self.is_sparse, "fused add+dirty-get is for sparse tables")
        CHECK(self._num_server == 1 and self._zoo.servers_in_process,
              "fused add+dirty-get is a single-server extension with "
              "the server in this process (multi-server callers "
              "compose add_rows + get_dirty_device)")
        CHECK(not bool(get_flag("sync", False)),
              "fused add+dirty-get is async-only: the embedded add "
              "would bypass the BSP vector clocks")
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int32).reshape(-1)
        self._check_row_ids(row_ids)
        CHECK(is_device_array(delta), "fused add needs a device delta")
        CHECK(tuple(delta.shape) == (row_ids.size, self.num_col),
              "bad delta shape")
        if get_worker is None:
            get_worker = max(self._zoo.worker_id, 0)
        CHECK(0 <= int(get_worker) < self._num_consumers,
              "get_worker out of the consumer-slot range (the "
              "server-side CHECK would fire inside the actor and the "
              "caller would hang)")
        blobs = [Blob(_ADD_GET_DIRTY_KEY.view(np.uint8)),
                 Blob(row_ids.view(np.uint8)), Blob(delta),
                 self._option_blob(option),
                 GetOption(int(get_worker)).to_blob()]
        if row_ids_device is not None:
            self._check_mirror(row_ids, row_ids_device)
            blobs.append(Blob(row_ids_device))
        self._begin_dirty_reply()
        self.wait(self.get_async_raw(blobs[0], blobs[1:]))
        shards, ids = self._end_dirty_reply()
        CHECK(len(shards) == 1, "fused dirty get: one reply")
        return ids[0], shards[0]

    def _check_mirror(self, row_ids: np.ndarray, mirror) -> None:
        """The device mirror of the add ids: ``[bucket_size(k)]`` int32,
        a stateless rule; with ``-verify_device_ids`` its first use is
        read back and compared with the host ids."""
        CHECK(is_device_array(mirror),
              "row_ids_device must be a device tensor")
        bucket = bucket_size(row_ids.size)
        CHECK(tuple(mirror.shape) == (bucket,)
              and mirror.dtype == torch.int32,
              "row_ids_device must mirror row_ids padded to the host "
              "bucket ([bucket_size(k)] int32; build it as "
              "torch.from_numpy(pad_ids(row_ids, num_row)) on the "
              "table's device)")
        CHECK(self._updater_stateless,
              "device-id fused adds need a stateless updater")
        if get_flag("verify_device_ids") and not self._mirror_verified:
            # A mirror that disagrees with the host ids would mark one
            # row set dirty and scatter the delta at another.
            host = mirror.cpu().numpy()
            CHECK(np.array_equal(host[:row_ids.size], row_ids),
                  "-verify_device_ids: row_ids_device disagrees with the "
                  "host row ids")
            CHECK(row_ids.size == bucket
                  or int(host[row_ids.size:].min()) >= self.num_row,
                  "-verify_device_ids: mirror padding ids must be "
                  ">= num_row (in-range padding would scatter into live "
                  "rows)")
            self._mirror_verified = True

    def _begin_dirty_reply(self) -> None:
        self._dest, self._dest_rows = None, None
        self._device_shards, self._device_shard_ids = {}, {}

    def _end_dirty_reply(self):
        shards, ids = self._device_shards, self._device_shard_ids
        self._device_shards, self._device_shard_ids = None, None
        return shards, ids

    def get_device(self) -> torch.Tensor:
        """Dense whole-table Get returning a tensor ``[num_row,
        num_col]`` on the table's device: the servers' reply clones, in
        server order."""
        CHECK(not self.is_sparse,
              "device get is for dense tables (sparse replies are ragged)")
        self._dest, self._dest_rows, self._device_shards = None, None, {}
        self._device_sum = False
        self.wait(self._request_get(Blob(_ALL_KEY.view(np.uint8))))
        return self.take_device_rows()

    def take_device_rows(self) -> torch.Tensor:
        """Assembled result of the last ``get_rows_device_async`` (call
        after ``wait``); clears the reply slot. Device-key replies of
        several servers SUM (each server zero-fills foreign rows);
        host-key replies concatenate (each server returned its
        contiguous sorted segment)."""
        device_sum, self._device_sum = self._device_sum, False
        ordered = self.take_device_row_parts()
        if len(ordered) == 1:
            return ordered[0]
        if device_sum:
            return functools.reduce(torch.add, ordered)
        return torch.cat(ordered, dim=0)

    def get_rows_device_segments_async(self, segments) -> int:
        """Pre-segmented device row pull: ``segments`` is one int32 id
        vector on the card PER SERVER (the caller cut its sorted ids per
        server, e.g. with K18). Each server receives ONLY its segment;
        entries outside its window (slice slack, padding) gather as zero
        rows (K15). Replies are keyed by server id: take them with
        ``take_device_row_parts``. The per-server gather follows the
        segment's size, not the full id count."""
        CHECK(self._zoo.servers_in_process,
              "segmented device gets need the servers in this process")
        CHECK(not self.is_sparse, "segmented device gets are for dense "
              "tables")
        CHECK(len(segments) == self._num_server, "one segment per server")
        # Shape/dtype violations would otherwise surface inside the
        # server actor, where the exception is only logged and the
        # caller hangs in wait() — fail in the CALLER.
        for seg in segments:
            CHECK(is_device_array(seg) and seg.dtype == torch.int32
                  and seg.dim() == 1,
                  "segments must be 1-D int32 id tensors")
        self._dest, self._dest_rows = None, None
        self._device_shards = {}
        self._device_sum = False
        return self.get_async_raw(Blob(_SEGMENTED_KEY.view(np.uint8)),
                                  [Blob(s) for s in segments])

    def add_rows_device_segments_async(self, segments, deltas,
                                       option: Optional[AddOption] = None
                                       ) -> int:
        """Pre-segmented device row push: per-server (ids, delta) pairs;
        each server scatter-adds only the entries of its segment in its
        window (K16; slack and padding drop). The stateless-updater
        contract of device-key ``add_rows_async``."""
        CHECK(self._zoo.servers_in_process,
              "segmented device adds need the servers in this process")
        CHECK(not self.is_sparse, "segmented device adds are for dense "
              "tables")
        CHECK(len(segments) == self._num_server
              and len(deltas) == self._num_server,
              "one (segment, delta) pair per server")
        CHECK(self._updater_stateless,
              "device-key row adds need a stateless updater "
              "(default/sgd): duplicate ids must sum")
        for seg, delta in zip(segments, deltas):
            CHECK(is_device_array(seg) and is_device_array(delta),
                  "segments and deltas must be device tensors")
            CHECK(seg.dtype == torch.int32 and seg.dim() == 1,
                  "segments must be 1-D int32 id tensors")
            CHECK(delta.dtype == torch.float32
                  and tuple(delta.shape) == (seg.shape[0], self.num_col),
                  "bad segment delta shape")
        msg_id = self._new_request()
        self._send_request(
            MsgType.Request_Add,
            [Blob(_SEGMENTED_KEY.view(np.uint8))]
            + [Blob(s) for s in segments] + [Blob(d) for d in deltas]
            + [self._option_blob(option)], msg_id)
        return msg_id

    def take_device_row_parts(self) -> List[torch.Tensor]:
        """The raw per-server reply shards of the last device get, in
        SERVER order, without assembling them (segmented pulls
        reassemble them positionally, with K17)."""
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
        tok = self._cache_begin_add(None)
        mid = self.add_async_raw(Blob(_ALL_KEY.view(np.uint8)),
                                 Blob(delta), self._option_blob(option))
        self._cache_resolve_on(mid, tok)
        return mid

    def _cache_begin_add(self, row_ids: Optional[np.ndarray]):
        """Block the client-cache slots this Add dirties (None = whole
        table) until its ack resolves them — read-your-writes. Not gated
        on the cache being active: an inactive cache still fences its
        shard floors on the ack (``RowCache.begin_add``)."""
        cache = self._row_cache
        if cache is None:
            return None
        return cache.begin_add(row_ids)

    def _cache_resolve_on(self, msg_id: int, token) -> None:
        if token is not None:
            self.add_completion(
                msg_id,
                lambda _mid, tok=token: self._row_cache.finish_add(tok))

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
            # Device ids cannot be enumerated without a host sync: the
            # whole cache blocks until the ack.
            tok = self._cache_begin_add(None)
            mid = self.add_async_raw(Blob(row_ids), Blob(delta),
                                     self._option_blob(option))
            self._cache_resolve_on(mid, tok)
            return mid
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int32).reshape(-1)
        self._check_row_ids(row_ids)
        if self._one_bit:
            # The error feedback's gather and write-back break on
            # duplicates; the chunk encoder's CHECK would fire inside the
            # worker actor, so the caller raises here instead.
            CHECK(np.unique(row_ids).size == row_ids.size,
                  "error-feedback row pushes need unique row ids")
        if not is_device_array(delta):
            delta = np.ascontiguousarray(delta, self.dtype).reshape(-1)
        CHECK(int(np.prod(tuple(delta.shape))) == row_ids.size * self.num_col,
              "bad delta size")
        tok = self._cache_begin_add(row_ids)
        mid = self.add_async_raw(Blob(row_ids.view(np.uint8)),
                                 Blob(delta), self._option_blob(option))
        self._cache_resolve_on(mid, tok)
        return mid

    def _option_blob(self, option: Optional[AddOption]) -> Blob:
        if option is None:
            option = AddOption(worker_id=max(self._zoo.worker_id, 0))
        return option.to_blob()

    def _onebit_chunk(self, chunk, lo: int, hi: int,
                      rows: Optional[np.ndarray] = None) -> List[Blob]:
        """One server's 1-bit Add chunk with error feedback: the previous
        quantization error of these slots (rows ``lo:hi``, or ``rows``)
        is folded into the delta before encoding, and the new error
        replaces it. Row pushes need UNIQUE row ids: a repeated row
        would gather its residual once an occurrence and keep only the
        last write-back."""
        if self._residual is None:
            self._residual = np.zeros((self.num_row, self.num_col),
                                      np.float32)
        chunk2d = np.asarray(chunk).reshape(-1, self.num_col)
        if rows is None:
            res = self._residual[lo:hi]
        else:
            CHECK(np.unique(rows).size == rows.size,
                  "error-feedback row pushes need unique row ids")
            res = self._residual[rows]
        blobs, residual = _onebit_blobs((chunk2d + res).reshape(-1))
        residual = residual.reshape(chunk2d.shape)
        if rows is None:
            self._residual[lo:hi] = residual
        else:
            self._residual[rows] = residual
        return blobs

    def partition(self, blobs, msg_type) -> Dict[int, List[Blob]]:
        if blobs[0].on_device:
            # Device-key requests: the same blob list goes to EVERY
            # server (object references — zero copies in-process); each
            # server masks foreign rows on the card. Splitting the ids
            # here would need their values on the host.
            return {sid: list(blobs) for sid in range(self._num_server)}
        keys = blobs[0].as_array(np.int32)
        out: Dict[int, List[Blob]] = {}
        if keys.size == 1 and keys[0] == -3:
            # Pre-segmented device-key request: segment s (and its delta
            # for adds) goes to server s ONLY.
            S = self._num_server
            rest = blobs[1:]
            if msg_type == MsgType.Request_Get:
                CHECK(len(rest) == S, "segmented get: one id blob per "
                      "server")
                return {s: [rest[s]] for s in range(S)}
            CHECK(len(rest) == 2 * S + 1, "segmented add: per-server ids "
                  "+ deltas + option")
            return {s: [rest[s], rest[S + s], rest[2 * S]]
                    for s in range(S)}
        if keys.size == 1 and keys[0] == -4 \
                and msg_type == MsgType.Request_Get:
            # The fused add + dirty Get is a Get: one server (the caller
            # CHECKs it) takes the whole blob list. A Request_Add with -4
            # falls through to the fail-fast below.
            CHECK(self._num_server == 1 and len(blobs) in (5, 6),
                  "fused add+dirty-get: [marker, rows, delta, "
                  "add_option, get_option(, device rows)] to one server")
            return {0: list(blobs)}
        if keys.size == 1 and keys[0] < 0:
            # Only the defined sentinels may go negative: a stray negative
            # row id must fail here, not fan out as a whole-table request.
            CHECK(keys[0] in (-1, -2),
                  "negative key must be a whole-table sentinel (-1/-2)")
            is_add = msg_type == MsgType.Request_Add
            values = blobs[1].typed(self.dtype) if is_add else None
            # Values may arrive flat [R*C] (host callers) or row-shaped
            # [R, C] (tensor deltas); slice in whichever layout they came.
            row_shaped = values is not None and len(values.shape) == 2
            one_bit = (is_add and self._one_bit and values is not None
                       and not is_device_array(values))
            for sid in range(self._num_server):
                shard = [blobs[0]]
                if values is not None:
                    lo, hi = self._offsets[sid], self._offsets[sid + 1]
                    chunk = values[lo:hi] if row_shaped \
                        else values[lo * self.num_col:hi * self.num_col]
                    if one_bit:
                        shard.extend(self._onebit_chunk(
                            np.asarray(chunk), lo, hi))
                    else:
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
                chunk = np.ascontiguousarray(values[mask])
                if self._one_bit:
                    shard.extend(self._onebit_chunk(chunk, 0, 0,
                                                    rows=keys[mask]))
                else:
                    shard.append(Blob(chunk))
            if is_add and len(blobs) == 3:
                shard.append(blobs[2])
            elif not is_add and len(blobs) == 2:  # sparse GetOption
                shard.append(blobs[1])
            out[int(sid)] = shard
        return out

    # -- replies (ref: matrix_table.cpp:317-341) --
    def process_reply_get(self, reply_blobs: List[Blob]) -> None:
        if (self._reply_msg_id >= 0
                and self._pf_rows.get(self._reply_msg_id) is not None):
            # Prefetch reply shard: one server's [keys, values] segment
            # goes into the cache ONLY — the destination registers belong
            # to whatever real Get may be in flight.
            keys = reply_blobs[0].as_array(np.int32)
            values = reply_blobs[1].as_array(self.dtype).reshape(
                keys.size, self.num_col)
            if self._row_cache is not None:
                self._row_cache.store(keys, values, self._reply_version,
                                      self._reply_server)
            return
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
            if self._device_shards is not None:  # get_device
                self._device_shards[server_id] = \
                    reply_blobs[1].typed(self.dtype)
                return
            CHECK(self._dest is not None,
                  "Get reply with no outstanding destination — only one "
                  "Get may be in flight per table (as in the reference)")
            lo, hi = self._offsets[server_id], self._offsets[server_id + 1]
            values = reply_blobs[1].as_array(self.dtype)
            self._dest[lo:hi] = values.reshape(hi - lo, self.num_col)
            return
        if self._device_shards is not None:
            # Host-key device pull: keep the server's gather on the card,
            # keyed by the owning server (one contiguous key segment). A
            # dirty-row reply ([ids, values, server_id]) may hold ZERO
            # rows, so it names its server.
            if len(reply_blobs) >= 3:
                sid = int(reply_blobs[2].as_array(np.int32)[0])
            else:
                sid = 0 if keys.size == 0 else \
                    int(min(keys[0] // self._row_length,
                            self._num_server - 1))
            self._device_shards[sid] = reply_blobs[1].typed(
                self.dtype).reshape(keys.size, self.num_col)
            if self._device_shard_ids is not None:
                self._device_shard_ids[sid] = keys
            return
        values = reply_blobs[1].as_array(self.dtype).reshape(
            keys.size, self.num_col)
        if self._row_cache is not None and self._dest_rows is not None:
            # Every real row Get refreshes the cache (and, through the
            # reply context, the version tracker).
            self._row_cache.store(keys, values, self._reply_version,
                                  self._reply_server)
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
        self._one_bit = (not self.is_sparse
                         and self.dtype == np.float32
                         and bool(get_flag("one_bit_push")))
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
                                    self.dtype, num_workers, device,
                                    cols=self.num_col)
        self._updater_stateless = self._engine.rule.stateless
        # Sparse staleness bitmap: one slot per logical consumer;
        # pipelined workers count twice (ref: sparse_matrix_table.cpp:
        # 184-197).
        consumers = num_workers * (2 if is_pipeline else 1)
        self._up_to_date = np.zeros((consumers, self.my_rows), dtype=bool) \
            if is_sparse else None
        # The last dirty set of the fused path and its padded device id
        # vector: an unchanged set reuses it instead of uploading again.
        self._dirty_dev_cache: Optional[tuple] = None

    # -- Add (ref: matrix_table.cpp:386-418)
    def process_add(self, blobs: List[Blob]) -> None:
        if self._one_bit and len(blobs) == 4 and not blobs[1].on_device:
            # 1-bit layout: exactly [keys, sign bits, meta, option]
            # (matrix adds always carry an option blob); device deltas
            # stay full precision and arrive as 3 blobs.
            option = AddOption.from_blob(blobs[3])
            blobs = [blobs[0], Blob(_onebit_decode(blobs[1], blobs[2]))]
        else:
            CHECK(len(blobs) in (2, 3),
                  "add needs [keys, values(, option)]")
            option = AddOption.from_blob(blobs[2]) \
                if len(blobs) == 3 else None
        if blobs[0].on_device:
            # Device-key scatter-add: ids and delta never touch the host.
            # Several servers: every server receives the full request (or
            # its segment); foreign rows drop (K16).
            CHECK(self._up_to_date is None,
                  "device-key adds are for dense tables")
            self._data = self._engine.apply_rows(
                self._data, blobs[0].typed(np.int32),
                blobs[1].typed(self.dtype), option,
                bounds=self._shard_bounds)
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
            # the card. Several servers: foreign rows gather as 0 (K15)
            # and the worker sums the replies (or reassembles segments).
            # The server id rides along so the worker can key the reply
            # shard by ORIGIN server.
            CHECK(self._up_to_date is None,
                  "device-key gets are for dense tables")
            rows = blobs[0].typed(np.int32)
            bounds = self._shard_bounds
            values = row_gather(self._data, rows, self.num_col) \
                if bounds is None else \
                row_gather_bounded(self._data, rows, *bounds, self.num_col)
            return [blobs[0], Blob(values),
                    Blob(np.array([self.server_id], dtype=np.int32))]
        keys = blobs[0].as_array(np.int32)
        if keys.size == 1 and keys[0] == -4:
            return self._fused_add_get_dirty(blobs)
        if keys.size == 1 and keys[0] == -2:
            CHECK(self._up_to_date is not None and len(blobs) >= 2,
                  "-2 sentinel is the sparse dirty device-reply get")
            return self._sparse_get_all_device(GetOption.from_blob(blobs[1]))
        if keys.size == 1 and keys[0] == -1:
            if self._up_to_date is not None and len(blobs) >= 2:
                return self._sparse_get_all(GetOption.from_blob(blobs[1]))
            # A clone of the table: the host Get copies it off the card,
            # get_device keeps it there.
            return [blobs[0], Blob(self._values()),
                    Blob(np.array([self.server_id], dtype=np.int32))]
        values = self._gather_rows(keys)
        self._mark_clean(keys, blobs)
        return [blobs[0], Blob(values)]

    @property
    def _shard_bounds(self) -> Optional[tuple]:
        """(row_offset, my_rows) when the global ids of a device-key
        request need masking to this shard — several servers only (the
        reference's ``_shard_bounds``); None keeps one server's device
        requests on K2 and K3."""
        if self._zoo.num_servers > 1:
            return (self.row_offset, self.my_rows)
        return None

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

    def _sparse_get_all_device(self, opt: GetOption) -> List[Blob]:
        """-2: the dirty rows with the values left on the card (host ids,
        device payload). The server id rides along: a server with ZERO
        dirty rows replies an empty id vector, which the worker could
        not attribute by key range."""
        dirty = self._dirty_ids(opt.worker_id)
        return [Blob(dirty + self.row_offset),
                Blob(self._gather_rows(dirty + self.row_offset)),
                Blob(np.array([self.server_id], dtype=np.int32))]

    def _fused_add_get_dirty(self, blobs: List[Blob]) -> List[Blob]:
        """-4: apply a row add, then reply the get-worker's dirty rows
        gathered from the UPDATED table, in one launch (K14) — the exact
        composition of a row ``process_add`` and
        ``_sparse_get_all_device``, sharing their bookkeeping. The caller
        may ship a bucket-padded device mirror of the add ids (blob 5)."""
        CHECK(self._up_to_date is not None and len(blobs) in (5, 6),
              "-4 is the fused sparse add+dirty-get")
        rows = blobs[1].as_array(np.int32)
        delta = blobs[2].typed(self.dtype)
        add_opt = AddOption.from_blob(blobs[3])
        get_opt = GetOption.from_blob(blobs[4])
        local = rows - self.row_offset
        self._mark_dirty(local, add_opt)
        dirty = self._dirty_ids(get_opt.worker_id)
        if len(blobs) == 6:
            # One server owns row offset 0: global ids are local ids.
            add_ids = blobs[5].typed(np.int32)
        else:
            add_ids = pad_ids(local, self._data.shape[0])
        cached = self._dirty_dev_cache
        if cached is not None and np.array_equal(cached[0], dirty):
            get_ids = cached[1]
        else:
            get_ids = torch.from_numpy(pad_ids(
                dirty, self._data.shape[0])).to(self._data.device)
            self._dirty_dev_cache = (dirty, get_ids)
        self._data, values = self._engine.apply_rows_gather(
            self._data, add_ids, delta.reshape(rows.size, self.num_col),
            add_opt, get_ids, self.num_col)
        return [Blob(dirty + self.row_offset),
                Blob(_trim_rows(values, dirty.size)),
                Blob(np.array([self.server_id], dtype=np.int32))]

    def _dirty_ids(self, wid: int) -> np.ndarray:
        """The consumer's dirty row set, flipped clean on read: the ONE
        copy of the bookkeeping the composed and fused dirty paths share,
        so they cannot diverge."""
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
