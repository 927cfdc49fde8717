"""1-D dense distributed tensor table.

Port of ``multiverso_tpu/tables/array_table.py`` — the reference's
``ArrayWorker/ArrayServer`` (ref: include/multiverso/table/
array_table.h:13-73, src/table/array_table.cpp:10-156). Semantics
preserved:

- element-range partition over servers: server i owns
  ``[i*length, (i+1)*length)`` with the last server absorbing the
  remainder (ref: array_table.cpp:14-20, 98-108);
- Get uses the whole-table sentinel key -1 (ref: array_table.cpp:29-35);
- Get replies are ``[server_id, values]`` and land at the server's offset
  (ref: array_table.cpp:95-106, 130-141);
- ``store``/``load`` stream the shard as raw bytes, so the two packages
  read each other's checkpoints.

Each server shard is one 1-D ``torch.Tensor`` on the zoo's device,
updated in place by the dense rule (default ``+=``, sgd ``-=``, or a
stateful rule whose state lives beside it) through the updater engine;
replies and snapshots are clones of it. A tensor
delta rides the whole stack without touching the host, and
``get_device`` returns the table as a tensor on the zoo's device.
Under ``-max_get_staleness`` a host Get is served from the whole-blob
client cache (``client_cache.BlobCache``: one entry a server shard, a
hit needs every shard fresh), which ``prefetch_async`` warms.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.blob import Blob, is_device_array
from ..core.message import MsgType
from ..sharding import mesh as meshlib
from ..updater import AddOption, UpdateEngine, create_rule
from ..util.log import CHECK
from . import client_cache
from .client_cache import BlobCache
from .table_interface import ServerTable, WorkerTable

_ALL_KEY = np.array([-1], dtype=np.int32)


def server_offsets(size: int, num_servers: int) -> List[int]:
    """Element ranges per server (ref: array_table.cpp:14-20)."""
    length = size // num_servers
    offsets = [i * length for i in range(num_servers)]
    offsets.append(size)
    return offsets


class ArrayWorker(WorkerTable):
    def __init__(self, size: int, dtype=np.float32, zoo=None):
        super().__init__(zoo=zoo)
        CHECK(size >= self._zoo.num_servers,
              "array table smaller than server count")
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        self._num_server = self._zoo.num_servers
        self._offsets = server_offsets(self.size, self._num_server)
        # One outstanding Get per table, as in the reference's shared
        # destination registers (ref: matrix_table.cpp:66-76). _dest xor
        # _device_shards names the reply destination.
        self._dest: Optional[np.ndarray] = None
        self._device_shards: Optional[Dict[int, torch.Tensor]] = None
        # Client cache (-max_get_staleness > 0): whole-blob, one entry a
        # server shard; device Gets bypass it.
        bound = client_cache.staleness_bound()
        self._blob_cache: Optional[BlobCache] = None
        if bound > 0:
            self._blob_cache = BlobCache(bound, self._num_server,
                                         self._version_tracker)
            self._caches.append(self._blob_cache)
        self._pf_id: Optional[int] = None  # whole-table prefetch in flight

    # -- public API (ref: array_table.cpp:29-66) --
    def get(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        self.wait(self.get_async(out))
        return self._dest

    def get_async(self, out: Optional[np.ndarray] = None) -> int:
        if out is None:
            out = np.empty(self.size, self.dtype)
        CHECK(out.size == self.size, "output buffer size mismatch")
        self._dest, self._device_shards = out, None
        if self._blob_cache is not None:
            shards = self._blob_cache.fetch_all()
            if shards is not None:
                # The uncached reply path's write form (_dest[lo:hi] =
                # values): reshape(-1) would silently COPY a
                # non-contiguous buffer and drop the fill.
                for sid, values in shards.items():
                    out[self._offsets[sid]:self._offsets[sid + 1]] = \
                        values
                return self._local_done()
        return self.get_async_raw(Blob(_ALL_KEY.view(np.uint8)))

    def prefetch_async(self) -> int:
        """Warm the whole-blob client cache without touching the Get
        destination registers; identical prefetches in flight dedup to
        one request. A no-op when the cache is disabled."""
        if self._blob_cache is None:
            return self._local_done()
        if self._pf_id is not None:
            return self._pf_id  # join the outstanding fetch
        if self._blob_cache.fresh_all():  # counter-free planning check
            return self._local_done()
        msg_id = self._new_request()
        self._pf_id = msg_id
        self.add_completion(msg_id, self._on_prefetch_done)
        self._send_request(MsgType.Request_Get,
                           [Blob(_ALL_KEY.view(np.uint8))], msg_id)
        return msg_id

    def _on_prefetch_done(self, msg_id: int) -> None:
        if self._pf_id == msg_id:
            self._pf_id = None

    def add(self, delta, option: Optional[AddOption] = None) -> None:
        self.wait(self.add_async(delta, option))

    def add_async(self, delta, option: Optional[AddOption] = None) -> int:
        """Accepts a host array or a tensor; a tensor delta stays on its
        device end to end."""
        if not is_device_array(delta):
            delta = np.ascontiguousarray(delta,
                                         dtype=self.dtype).reshape(-1)
        CHECK(int(np.prod(tuple(delta.shape))) == self.size,
              "delta size mismatch")
        if self._blob_cache is not None:
            # Self-invalidation until the ack's version stamp resolves
            # it (read-your-writes).
            self._blob_cache.begin_add()
        mid = self.add_async_raw(
            Blob(_ALL_KEY.view(np.uint8)), Blob(delta.reshape(-1)),
            option.to_blob() if option is not None else None)
        if self._blob_cache is not None:
            self.add_completion(
                mid, lambda _mid: self._blob_cache.finish_add())
        return mid

    # -- partition (ref: array_table.cpp:68-86) --
    def partition(self, blobs, msg_type) -> Dict[int, List[Blob]]:
        out: Dict[int, List[Blob]] = {}
        # typed() keeps a tensor payload a tensor: the per-server slice is
        # then a view on its device, not a host copy.
        values = blobs[1].typed(self.dtype) if len(blobs) >= 2 else None
        for server_id in range(self._num_server):
            shard = [blobs[0]]
            if values is not None:
                lo, hi = self._offsets[server_id], self._offsets[server_id + 1]
                shard.append(Blob(values[lo:hi]))
                if len(blobs) == 3:
                    shard.append(blobs[2])
            out[server_id] = shard
        return out

    # -- device-resident Get --
    def get_device(self) -> torch.Tensor:
        """Whole-table Get returning a tensor on the zoo's device: the
        servers' reply clones, concatenated when there are several."""
        self._dest, self._device_shards = None, {}
        self.wait(self.get_async_raw(Blob(_ALL_KEY.view(np.uint8))))
        shards = [self._device_shards[sid]
                  for sid in range(len(self._device_shards))]
        self._device_shards = None
        if len(shards) == 1:
            return shards[0]
        return torch.cat(shards)

    # -- reply (ref: array_table.cpp:95-106) --
    def process_reply_get(self, reply_blobs: List[Blob]) -> None:
        server_id = int(reply_blobs[0].as_array(np.int32)[0])
        if self._reply_msg_id >= 0 and self._reply_msg_id == self._pf_id:
            # Prefetch reply shard: cache only — the destination
            # registers belong to whatever real Get is in flight.
            if self._blob_cache is not None:
                self._blob_cache.store(
                    server_id, reply_blobs[1].as_array(self.dtype),
                    self._reply_version)
            return
        if self._device_shards is not None:  # device-resident get
            self._device_shards[server_id] = reply_blobs[1].typed(self.dtype)
            return
        CHECK(self._dest is not None,
              "Get reply with no outstanding destination — only one Get "
              "may be in flight per table (as in the reference)")
        values = reply_blobs[1].as_array(self.dtype)
        lo, hi = self._offsets[server_id], self._offsets[server_id + 1]
        CHECK(values.size == hi - lo, "reply shard size mismatch")
        self._dest[lo:hi] = values
        if self._blob_cache is not None:
            # Real Gets refresh the cache too.
            self._blob_cache.store(server_id, values, self._reply_version)


class ArrayServer(ServerTable):
    def __init__(self, size: int, dtype=np.float32, zoo=None,
                 updater_type: Optional[str] = None):
        super().__init__(zoo=zoo)
        self.dtype = np.dtype(dtype)
        num_servers = self._zoo.num_servers
        server_id = self._zoo.server_id
        # ref: array_table.cpp:98-108 — size/num_servers, the last takes
        # the remainder.
        my_size = size // num_servers
        if server_id == num_servers - 1:
            my_size += size % num_servers
        self.size = my_size
        self.server_id = server_id
        padded = meshlib.padded_size(my_size)
        self._data = meshlib.zeros_sharded((padded,), self.dtype,
                                           self._zoo.device)
        rule = None if updater_type is None \
            else create_rule(updater_type, dtype)
        self._engine = UpdateEngine(rule, (padded,), self.dtype,
                                    max(self._zoo.num_workers, 1),
                                    self._zoo.device)
        # Only a stateless rule lets fused adds fold deltas before one
        # apply (the MatrixServer precedent).
        self._updater_stateless = self._engine.rule.stateless

    # -- server logic (ref: array_table.cpp:116-141) --
    def process_add(self, blobs: List[Blob]) -> None:
        CHECK(len(blobs) in (2, 3), "add needs [keys, values(, option)]")
        option = AddOption.from_blob(blobs[2]) if len(blobs) == 3 else None
        delta = blobs[1].typed(self.dtype)  # tensor deltas stay tensors
        CHECK(int(np.prod(tuple(delta.shape))) == self.size,
              "add delta shard size mismatch")
        self._data = self._engine.apply_dense(self._data, delta, option)

    def process_get(self, blobs: List[Blob]) -> List[Blob]:
        key = int(blobs[0].as_array(np.int32)[0])
        CHECK(key == -1, "array table only serves whole-table gets")
        return [Blob(np.array([self.server_id], dtype=np.int32)),
                Blob(self._values())]

    # -- server-side request fusion (runtime/fusion.py) --
    def fuse_eligible(self, blobs: List[Blob], is_get: bool) -> bool:
        """Whole-table host requests only: a Get must carry the -1
        sentinel (anything else raises in process_get — keep that on the
        serial path), an Add a host delta and a stateless rule (fused adds
        FOLD deltas before one apply, which is only sum-equivalent for
        linear updates)."""
        if not blobs or blobs[0].on_device:
            return False
        if is_get:
            return blobs[0].size >= 4 \
                and int(blobs[0].as_array(np.int32)[0]) == -1
        if len(blobs) not in (2, 3) or blobs[1].on_device:
            return False
        return self._updater_stateless

    def process_fused_get(self, requests: List[List[Blob]]
                          ) -> List[List[Blob]]:
        """N whole-table Gets, ONE clone shared by every reply (read-only
        on the reply path). Bit-identical to serial."""
        values = self._values()
        return [[Blob(np.array([self.server_id], dtype=np.int32)),
                 Blob(values)] for _ in requests]

    def process_fused_add(self, requests: List[List[Blob]]) -> None:
        """N dense Adds, ONE apply per run of equal option bytes: the host
        deltas are left-folded in arrival order, then applied once —
        linear for stateless rules, so sum-equivalent to the serial loop.
        Every delta is validated before the first apply."""
        from ..runtime.fusion import PartialFuseError
        runs: List[tuple] = []  # (option bytes, option, [deltas])
        for blobs in requests:
            CHECK(len(blobs) in (2, 3),
                  "add needs [keys, values(, option)]")
            option = AddOption.from_blob(blobs[2]) \
                if len(blobs) == 3 else None
            okey = blobs[2].as_array(np.uint8).tobytes() \
                if len(blobs) == 3 else None
            delta = blobs[1].as_array(self.dtype).ravel()
            CHECK(delta.size == self.size,
                  "add delta shard size mismatch")
            if not runs or runs[-1][0] != okey:
                runs.append((okey, option, []))
            runs[-1][2].append(delta)
        applied = 0
        for _, option, deltas in runs:
            try:
                acc = deltas[0].astype(self.dtype, copy=True)
                for d in deltas[1:]:
                    acc += d
                self._data = self._engine.apply_dense(self._data, acc,
                                                      option)
            except Exception as exc:  # noqa: BLE001
                raise PartialFuseError(applied, exc) from exc
            applied += len(deltas)

    def _values(self) -> torch.Tensor:
        """A CLONE of the logical elements: the live storage is updated
        in place by every later Add, so a reply or snapshot must never
        alias it."""
        return self._data[:self.size].clone()

    # -- checkpoint (ref: array_table.cpp:143-151) --
    def store(self, stream) -> None:
        stream.write(self._values().cpu().numpy().tobytes())

    def load(self, stream) -> None:
        raw = stream.read(self.size * self.dtype.itemsize)
        values = np.frombuffer(raw, dtype=self.dtype)
        CHECK(values.size == self.size, "checkpoint size mismatch")
        self._data.zero_()
        self._data[:self.size] = torch.from_numpy(values.copy()).to(
            self._data.device)

    @property
    def raw(self) -> torch.Tensor:
        return self._values()
