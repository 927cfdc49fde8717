"""Worker/Server table bases: the async Get/Add plumbing.

Port of ``multiverso_tpu/tables/table_interface.py`` (ref: include/
multiverso/table_interface.h:24-75, src/table.cpp:13-112), cut to the
in-process slice. Contract preserved exactly:

- ``get_async``/``add_async`` allocate a per-request ``Waiter``, build a
  request message and hand it to the worker actor (ref: src/table.cpp:
  41-82);
- the worker actor calls ``partition`` to split the request into
  per-server-shard blob lists and re-arms the waiter via
  ``reset(msg_id, n)`` (ref: src/worker.cpp:30-76);
- each server reply triggers ``process_reply_get`` + ``notify`` until
  the waiter releases ``wait(msg_id)`` (ref: src/worker.cpp:78-88,
  src/table.cpp:84-111).

``abort`` (driven by ``Zoo.abort``, when a sibling rank of a
``LocalCluster`` fails) releases every outstanding waiter; a blocked or
later ``wait`` and any new request raise ``ClusterAborted`` instead of
hanging on a reply that never comes.

``ServerTable`` is ``Serializable`` — ``store``/``load`` stream the
shard state in the reference's byte format
(ref: include/multiverso/table_interface.h:61-75).

The client cache's plumbing (``tables/client_cache.py``): the version
every reply carries feeds a per-server ``VersionTracker``; a version
regression (a restarted server) invalidates the registered caches and
bumps the data generation; an Add ack also raises this worker's
read-your-writes floor for its shard; a request served locally
completes at once (``_local_done``), and completion callbacks
(``add_completion``) resolve a cache's blocked slots once the ack's
version has landed. Retries after a lost peer, request timeouts,
replicas and elastic resharding are later items of the port.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..core.blob import Blob
from ..core.message import Message, MsgType, stamp_trace
from ..runtime import actor as actors
from ..runtime.zoo import ClusterAborted, current_zoo
from ..util import log, tracing
from ..util.waiter import Waiter
from .client_cache import VersionTracker

#: Completed-request errors retained for late ``wait`` calls. Beyond
#: this, the oldest completed entries are reaped — fire-and-forget async
#: requests that fail are otherwise a slow leak over a long run.
_MAX_RETAINED_ERRORS = 128


class TableRequestError(RuntimeError):
    """A table request failed remotely (server-side table logic or
    worker-side partition); raised by ``wait`` in the REQUESTER's
    thread."""


class WorkerTable:
    """Client-side handle; lives on every worker rank."""

    def __init__(self, zoo=None):
        self._zoo = zoo if zoo is not None else current_zoo()
        self.table_id: int = self._zoo.register_worker_table(self)
        self._msg_id = 0
        self._waitings: Dict[int, Waiter] = {}
        self._errors: Dict[int, str] = {}
        self._mutex = threading.Lock()
        # Client-cache plumbing: per-server latest-version tracking and
        # the reply context the worker actor sets around
        # process_reply_get (server id, version stamp, request id) so
        # subclasses can attribute replies without a signature change.
        self._version_tracker = VersionTracker()
        #: Client caches registered by subclasses — invalidated when a
        #: serving shard changes GENERATION (a restarted server's
        #: version counter starts again).
        self._caches: List = []
        #: Data-generation counter for DERIVED read-side caches: bumped
        #: on every event that makes version arithmetic against the old
        #: shard counters meaningless (a server-generation regression).
        #: Written on the worker actor thread — int assignment.
        self._data_generation = 0
        self._on_complete: Dict[int, List[Callable]] = {}
        # Read-your-writes floors per server shard: the latest version
        # OUR OWN Add acks carried (worker actor thread only).
        self._add_floor: Dict[int, int] = {}
        self._reply_server = -1
        self._reply_version = -1
        self._reply_msg_id = -1
        # Sampled requests' open ROOT spans: msg_id -> (trace id, issue
        # timestamp, span name) (util/tracing.py).
        self._trace_open: Dict[int, tuple] = {}
        # Set by abort(): every later wait and request raises.
        self._abort_reason: Optional[str] = None

    # -- async API (ref: src/table.cpp:41-82) --
    def get_async_raw(self, keys: Blob, extra: Sequence[Blob] = ()) -> int:
        msg_id = self._new_request()
        self._send_request(MsgType.Request_Get, [keys, *extra], msg_id)
        return msg_id

    def add_async_raw(self, keys: Blob, values: Blob,
                      option_blob: Optional[Blob] = None) -> int:
        blobs = [keys, values]
        if option_blob is not None:
            blobs.append(option_blob)
        msg_id = self._new_request()
        self._send_request(MsgType.Request_Add, blobs, msg_id)
        return msg_id

    def _send_request(self, msg_type: MsgType, blobs: Sequence[Blob],
                      msg_id: int) -> None:
        """Build and route a request message for an ALREADY-allocated
        id — the prefetch machinery allocates first (so reply routing
        state can be registered before anything is in flight) and sends
        later (possibly from a completion callback)."""
        msg = Message(src=self._zoo.rank, dst=-1, msg_type=msg_type,
                      table_id=self.table_id, msg_id=msg_id)
        # Distributed-trace sampling at request issue (util/tracing.py);
        # 0 (the default-off common case) skips all bookkeeping.
        tid = tracing.new_trace(self._zoo.rank)
        if tid:
            stamp_trace(msg, tid)
            self._trace_open[msg_id] = (
                tid, tracing.now_ns(),
                f"worker_issue:{msg_type.name}[t{self.table_id}]")
        for blob in blobs:
            msg.push(blob)
        self._zoo.send_to(actors.WORKER, msg)

    def _local_done(self) -> int:
        """A request satisfied locally (cache hit, no-op prefetch): a
        normal request id, completed at once, so an async caller's
        ``wait`` returns immediately."""
        msg_id = self._new_request()
        self.notify(msg_id)
        return msg_id

    def _new_request(self) -> int:
        # A request made AFTER an abort would wait on a reply that can
        # never come (its waiter postdates abort()'s release sweep).
        self._check_aborted()
        with self._mutex:
            self._msg_id += 1
            msg_id = self._msg_id
            self._waitings[msg_id] = Waiter(1)
        return msg_id

    # -- waiter plumbing, driven by the worker actor
    #    (ref: src/table.cpp:84-111) --
    def wait(self, msg_id: int, timeout: Optional[float] = None) -> bool:
        self._check_aborted()
        with self._mutex:
            waiter = self._waitings.get(msg_id)
        if waiter is None:
            self._raise_if_failed(msg_id)
            return True  # already completed
        ok = waiter.wait(timeout=timeout)
        self._check_aborted()
        if ok:
            with self._mutex:
                self._waitings.pop(msg_id, None)
            self._raise_if_failed(msg_id)
        return ok

    def _raise_if_failed(self, msg_id: int) -> None:
        with self._mutex:
            error = self._errors.pop(msg_id, None)
        if error is not None:
            raise TableRequestError(error)

    def _check_aborted(self) -> None:
        if self._abort_reason is not None:
            raise ClusterAborted(self._abort_reason)

    def abort(self, reason: str) -> None:
        """Release every outstanding waiter; blocked and later ``wait``
        calls raise ClusterAborted."""
        self._abort_reason = reason
        self._trace_open.clear()  # roots of aborted requests never close
        with self._mutex:
            waiters = list(self._waitings.values())
        for waiter in waiters:
            waiter.release()

    def fail(self, msg_id: int, reason: str, count: bool = True) -> None:
        """Record a remote failure for a request; the requester's
        ``wait(msg_id)`` raises TableRequestError once the request
        completes. With ``count`` the failure also counts as one shard
        reply (notify); reply handlers whose control flow already
        notifies pass ``count=False``."""
        with self._mutex:
            # First error wins.
            self._errors.setdefault(msg_id, reason)
            if len(self._errors) > _MAX_RETAINED_ERRORS:
                for stale in list(self._errors):
                    if stale != msg_id and stale not in self._waitings:
                        del self._errors[stale]
                        if len(self._errors) <= _MAX_RETAINED_ERRORS:
                            break
        if count:
            self.notify(msg_id)

    def reset(self, msg_id: int, num_wait: int) -> None:
        with self._mutex:
            waiter = self._waitings.get(msg_id)
        if waiter is not None:
            waiter.reset(num_wait)
            if num_wait <= 0:
                # Re-armed to zero (empty partition): completion
                # callbacks must still fire or cache blocks strand.
                self._complete_if_done(msg_id, waiter)

    def notify(self, msg_id: int) -> None:
        with self._mutex:
            waiter = self._waitings.get(msg_id)
        if waiter is not None:
            waiter.notify()
            if waiter.done:
                self._complete_if_done(msg_id, waiter)

    def _complete_if_done(self, msg_id: int, waiter: Waiter) -> None:
        """Reap the completed waiter (fire-and-forget async adds would
        otherwise leak one per request), close its trace span and run
        its completion callbacks exactly once."""
        if not waiter.done:
            return
        opened = self._trace_open.pop(msg_id, None)
        if opened is not None:
            tid, t0_ns, name = opened
            tracing.end_root(tid, name, self._zoo.rank, t0_ns,
                             args={"table": self.table_id,
                                   "msg_id": msg_id})
        with self._mutex:
            if self._waitings.get(msg_id) is waiter:
                self._waitings.pop(msg_id, None)
            callbacks = self._on_complete.pop(msg_id, None)
        for fn in callbacks or ():
            try:
                fn(msg_id)
            except Exception:  # noqa: BLE001 - a callback must not
                # poison the worker actor's reply loop
                log.error("table %d: completion callback for request "
                          "%d raised", self.table_id, msg_id)
                import traceback
                traceback.print_exc()

    def add_completion(self, msg_id: int,
                       fn: Callable[[int], None]) -> None:
        """Run ``fn(msg_id)`` when the request completes (all shard
        replies in). If it already completed, run it now — the check
        and the registration share the mutex with the completion sweep,
        so a racing reply cannot orphan a callback."""
        run_now = False
        with self._mutex:
            if msg_id in self._waitings:
                self._on_complete.setdefault(msg_id, []).append(fn)
            else:
                run_now = True
        if run_now:
            fn(msg_id)

    # -- client-cache version plumbing (driven by the worker actor) --
    def note_version(self, server_id: int, version: int) -> None:
        """Record a version stamp observed on a reply from a server. A
        version REGRESSION (a reply below the shard's latest observed)
        means the server restarted with an older state: re-anchor the
        tracker and invalidate every registered cache for that shard."""
        if self._version_tracker.regressed(server_id, version):
            log.error("table %d: server shard %d version regressed "
                      "(%d -> %d): server generation change, "
                      "invalidating client caches for that shard",
                      self.table_id, server_id,
                      self._version_tracker.latest(server_id), version)
            self._version_tracker.reset(server_id, version)
            self._data_generation += 1
            for cache in self._caches:
                cache.invalidate_server(server_id)
        self._version_tracker.note(server_id, version)

    def note_add_ack(self, server_id: int, version: int) -> None:
        """An Add ack from a server shard: raises this worker's
        read-your-writes floor for that shard, besides the normal
        version observation."""
        if version >= 0:
            floor = self._add_floor.get(server_id, -1)
            if version > floor:
                self._add_floor[server_id] = version
        self.note_version(server_id, version)

    def add_floor(self, server_id: int) -> int:
        return self._add_floor.get(server_id, -1)

    def cache_generation(self) -> int:
        """Current data generation (see ``_data_generation``): derived
        read-side caches compare it with the value they recorded at
        build time and rebuild on any difference."""
        return self._data_generation

    def _begin_reply(self, server_id: int, version: int,
                     msg_id: int) -> None:
        self._reply_server = server_id
        self._reply_version = version
        self._reply_msg_id = msg_id
        self.note_version(server_id, version)

    def _end_reply(self) -> None:
        self._reply_server = self._reply_version = self._reply_msg_id = -1

    def partition(self, blobs: List[Blob],
                  msg_type: MsgType) -> Dict[int, List[Blob]]:
        raise NotImplementedError

    def process_reply_get(self, reply_blobs: List[Blob]) -> None:
        raise NotImplementedError

    @property
    def zoo(self):
        return self._zoo


class ServerTable:
    """Storage-side shard; lives on every server rank. Serializable
    (ref: table_interface.h:61-75)."""

    def __init__(self, zoo=None):
        self._zoo = zoo if zoo is not None else current_zoo()
        self.table_id: int = self._zoo.register_server_table(self)
        #: Monotonically increasing shard version: bumped by the server
        #: actor once per applied Add and stamped on every reply.
        self.version = 0

    def process_add(self, blobs: List[Blob]) -> None:
        raise NotImplementedError

    def process_get(self, blobs: List[Blob]) -> List[Blob]:
        raise NotImplementedError

    # -- server-side request fusion hooks (runtime/fusion.py; server
    #    actor thread only) --
    def fuse_eligible(self, blobs: List[Blob], is_get: bool) -> bool:
        """May this request join a fused (table, op) group? Default NO:
        a table type opts in per request."""
        return False

    def process_fused_get(self, requests: List[List[Blob]]
                          ) -> List[List[Blob]]:
        raise NotImplementedError

    def process_fused_add(self, requests: List[List[Blob]]) -> None:
        raise NotImplementedError

    def store(self, stream) -> None:
        raise NotImplementedError

    def load(self, stream) -> None:
        raise NotImplementedError

    @property
    def zoo(self):
        return self._zoo
