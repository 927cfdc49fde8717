"""Distributed key-value table (hash-sharded map), host only.

Port of ``multiverso_tpu/tables/kv_table.py`` (ref: include/multiverso/
table/kv_table.h:18-124), cut to the frozen layout. Semantics preserved:

- partition by ``key % num_servers`` (ref: kv_table.h:48-65);
- server ``process_add`` does ``table[k] += v`` (ref: kv_table.h:99-106);
- the worker keeps a local ``raw`` dict refreshed by Get
  (ref: kv_table.h:40, 68-75).

KV state is host-side: it backs control-plane things like WordEmbedding's
global word count (ref: Applications/WordEmbedding/src/communicator.cpp:
251-259). Under ``-max_get_staleness`` a Get is served from the
snapshot cache (``client_cache.SnapshotCache``: keyed by the exact
requested keys, versioned a contributing server shard). Elastic bucket
resharding is a later item of the port.
"""

from __future__ import annotations

import pickle
import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.blob import Blob
from ..util.log import CHECK
from . import client_cache
from .client_cache import SnapshotCache
from .table_interface import ServerTable, WorkerTable


class KVWorker(WorkerTable):
    def __init__(self, key_dtype=np.int64, val_dtype=np.float32, zoo=None):
        super().__init__(zoo=zoo)
        self.key_dtype = np.dtype(key_dtype)
        self.val_dtype = np.dtype(val_dtype)
        self._num_server = self._zoo.num_servers
        self.raw: Dict[int, float] = {}
        # Client cache (-max_get_staleness > 0): whole-request snapshots
        # keyed by the exact requested key set, versioned per
        # contributing server shard.
        bound = client_cache.staleness_bound()
        self._snap_cache: Optional[SnapshotCache] = None
        if bound > 0:
            self._snap_cache = SnapshotCache(bound, self._version_tracker)
            self._caches.append(self._snap_cache)
        self._collect_versions: Optional[Dict[int, int]] = None

    def get(self, keys) -> Dict[int, float]:
        """Refresh ``raw`` for the requested keys and return it."""
        keys = np.ascontiguousarray(keys, dtype=self.key_dtype).reshape(-1)
        if self._snap_cache is not None:
            sids = np.unique(keys.astype(np.int64) % self._num_server)
            snap = self._snap_cache.fetch(keys.tobytes(), sids)
            if snap is not None:
                self.raw.update(snap)
                return self.raw
            # Collect each shard's version stamp as the replies land
            # (the worker actor's reply context carries them).
            self._collect_versions = {}
        self.wait(self.get_async_raw(Blob(keys.view(np.uint8))))
        if self._snap_cache is not None:
            versions, self._collect_versions = self._collect_versions, None
            if versions is not None and \
                    {int(s) for s in sids} <= set(versions):
                self._snap_cache.store(
                    keys.tobytes(), versions,
                    {int(k): self.raw.get(int(k), 0.0) for k in keys})
        return self.raw

    def add(self, keys, values) -> None:
        self.wait(self.add_async(keys, values))

    def add_async(self, keys, values) -> int:
        keys = np.ascontiguousarray(keys, dtype=self.key_dtype).reshape(-1)
        values = np.ascontiguousarray(values,
                                      dtype=self.val_dtype).reshape(-1)
        CHECK(keys.size == values.size, "keys/values size mismatch")
        if self._snap_cache is not None:
            # Self-invalidation until the ack's version resolves it.
            self._snap_cache.begin_add()
        mid = self.add_async_raw(Blob(keys.view(np.uint8)),
                                 Blob(values.view(np.uint8)))
        if self._snap_cache is not None:
            self.add_completion(
                mid, lambda _mid: self._snap_cache.finish_add())
        return mid

    # ref: kv_table.h:48-65
    def partition(self, blobs, msg_type) -> Dict[int, List[Blob]]:
        keys = blobs[0].as_array(self.key_dtype)
        values = blobs[1].as_array(self.val_dtype) \
            if len(blobs) >= 2 else None
        out: Dict[int, List[Blob]] = {}
        dest = keys.astype(np.int64) % self._num_server
        # One mask per server, not np.unique: the first np.unique of a
        # process imports numpy.ma (~0.1 s), which would stall the
        # worker actor — and every request queued behind it — the first
        # time a word count is flushed.
        for sid in range(self._num_server):
            mask = dest == sid
            if not mask.any():
                continue
            shard = [Blob(np.ascontiguousarray(keys[mask]).view(np.uint8))]
            if values is not None:
                shard.append(
                    Blob(np.ascontiguousarray(values[mask]).view(np.uint8)))
            out[int(sid)] = shard
        return out

    # ref: kv_table.h:68-75
    def process_reply_get(self, reply_blobs: List[Blob]) -> None:
        keys = reply_blobs[0].as_array(self.key_dtype)
        values = reply_blobs[1].as_array(self.val_dtype)
        for k, v in zip(keys, values):
            self.raw[int(k)] = v.item()
        if (self._collect_versions is not None
                and self._reply_version >= 0):
            self._collect_versions[self._reply_server] = \
                self._reply_version


class KVServer(ServerTable):
    def __init__(self, key_dtype=np.int64, val_dtype=np.float32, zoo=None):
        super().__init__(zoo=zoo)
        self.key_dtype = np.dtype(key_dtype)
        self.val_dtype = np.dtype(val_dtype)
        self._store: Dict[int, float] = {}

    # ref: kv_table.h:99-106
    def process_add(self, blobs: List[Blob]) -> None:
        keys = blobs[0].as_array(self.key_dtype)
        values = blobs[1].as_array(self.val_dtype)
        for k, v in zip(keys, values):
            self._store[int(k)] = self._store.get(int(k), 0) + v.item()

    # ref: kv_table.h:88-97
    def process_get(self, blobs: List[Blob]) -> List[Blob]:
        keys = blobs[0].as_array(self.key_dtype)
        values = np.array([self._store.get(int(k), 0) for k in keys],
                          dtype=self.val_dtype)
        return [blobs[0], Blob(values.view(np.uint8))]

    def fuse_eligible(self, blobs: List[Blob], is_get: bool) -> bool:
        """Host-dict table: fusion is the serial loop under one
        dispatch, so any host request qualifies."""
        return bool(blobs) and not blobs[0].on_device

    def process_fused_get(self, requests: List[List[Blob]]
                          ) -> List[List[Blob]]:
        return [self.process_get(blobs) for blobs in requests]

    def process_fused_add(self, requests: List[List[Blob]]) -> None:
        from ..runtime.fusion import PartialFuseError
        for i, blobs in enumerate(requests):
            try:
                self.process_add(blobs)
            except Exception as exc:  # noqa: BLE001
                raise PartialFuseError(i, exc) from exc

    def store(self, stream) -> None:
        payload = pickle.dumps(self._store)
        stream.write(struct.pack("<Q", len(payload)))
        stream.write(payload)

    def load(self, stream) -> None:
        (length,) = struct.unpack("<Q", stream.read(8))
        self._store = pickle.loads(stream.read(length))

    @property
    def raw(self) -> Dict[int, float]:
        return self._store
