"""Server actor: owns table shards and applies updates.

Port of ``multiverso_tpu/runtime/server.py`` (ref: include/multiverso/
server.h:13-24, src/server.cpp:23-233), cut to the asynchronous server
of the in-process slice: it invokes table logic directly and replies.
The table storage it fronts is a ``torch.Tensor`` on the zoo's device;
the per-message work here is host-side control only, and the row
arithmetic runs on the row gather / scatter-add kernels
(``multiverso_tpu_torch/kernels/rows.py``).

Server-side request fusion (``runtime/fusion.py``) is kept: when the
mailbox holds more than one message the actor drains a bounded batch
and executes one gather or one scatter-add per (table, op) group of
host-keyed row requests. Device-key requests — the word2vec pipeline's
— are never fusable (as in the reference) and take the serial path.

The BSP ``SyncServer`` (``-sync``, ref: src/server.cpp:60-222) gates
requests behind per-worker vector clocks so that every worker's i-th
Get observes exactly the state after all workers' i-th Adds; with
``-backup_worker_ratio`` the slowest workers stop gating the clocks.
Snapshots, replicas and elastic resharding are later items of the port.
"""

from __future__ import annotations

import collections
from typing import Deque, List

from ..core.message import (Message, MsgType, mark_error, stamp_version,
                            trace_of)
from ..util import log, tracing
from ..util.configure import define_double, get_flag
from ..util.dashboard import monitor, samples
from . import actor as actors
from . import fusion
from .actor import Actor

define_double("backup_worker_ratio", 0.0,
              "straggler cutoff for the BSP sync server: this share of "
              "workers ('set 20 means 20%'; fractional 0.2 accepted "
              "too) are treated as backups: the global vector clock "
              "advances once the fastest (1 - ratio) of workers have "
              "ticked. 0 (default) = strict BSP")

_INF = float("inf")


def backup_worker_count(num_workers: int) -> int:
    """-backup_worker_ratio as a worker count: 'set 20 means 20%' (the
    reference's convention) with fractional values (0.2) accepted too;
    clamped so at least one worker always gates the clock."""
    ratio = float(get_flag("backup_worker_ratio"))
    if ratio >= 1.0:
        ratio = ratio / 100.0
    if ratio <= 0 or num_workers <= 1:
        return 0
    return min(int(ratio * num_workers), num_workers - 1)


class Server(Actor):
    def __init__(self, zoo) -> None:
        super().__init__(actors.SERVER, zoo)
        self._store: List = []  # registered ServerTables, by table id
        self.register_handler(MsgType.Request_Get, self._process_get)
        self.register_handler(MsgType.Request_Add, self._process_add)
        self._fuse_max = max(int(get_flag("server_fuse_max")), 1)
        self._fuse_bytes = max(int(get_flag("server_fuse_bytes")), 1)

    @staticmethod
    def get_server(zoo) -> "Server":
        """Factory on the -sync flag (ref: src/server.cpp:224-231)."""
        if get_flag("sync"):
            log.info("Create a sync server")
            return SyncServer(zoo)
        log.debug("Create a async server")
        return Server(zoo)

    def register_table(self, server_table) -> int:
        self._store.append(server_table)
        return len(self._store) - 1

    def _table(self, table_id: int):
        if 0 <= table_id < len(self._store):
            return self._store[table_id]
        raise RuntimeError(f"table {table_id} not registered on rank "
                           f"{self._zoo.rank}")

    # -- server-side request fusion (runtime/fusion.py) --
    def _main(self) -> None:
        if self._fuse_max <= 1:
            return super()._main()
        while True:
            batch = self.mailbox.pop_batch(
                self._fuse_max, self._fuse_bytes,
                size_of=fusion.message_nbytes)
            if not batch:
                break
            if len(batch) == 1:
                self._safe_dispatch(batch[0])
                continue
            samples("SERVER_FUSE_BATCH").add(len(batch))
            try:
                self._dispatch_fused(batch)
            except Exception:  # noqa: BLE001 - the actor must not die
                # silently; per-entry errors already travel in replies
                log.error("server: fused batch dispatch raised")
                import traceback
                traceback.print_exc()

    def _dispatch_fused(self, batch: List[Message]) -> None:
        """Execute one drained batch: eligible Get/Add units fuse into
        (table, op) groups; everything else is a barrier that
        dispatches through the ordinary serial handler. Replies are
        deferred and emitted in arrival order at each barrier and at
        batch end."""
        infos = [fusion.classify(self, i, m)
                 for i, m in enumerate(batch)]
        plan = fusion.split_plan(batch, infos)
        cursor = 0

        def emit(upto: int) -> None:
            nonlocal cursor
            while cursor < upto:
                if infos[cursor] is not None:
                    self._send_fused_reply(batch[cursor], infos[cursor])
                cursor += 1

        for kind, payload in plan:
            if kind == "serial":
                emit(payload)
                self._safe_dispatch(batch[payload])
                cursor = payload + 1
            else:
                for table, is_get, entries in payload:
                    self._run_fused_group(table, is_get, entries)
        emit(len(batch))

    def _run_fused_group(self, table, is_get: bool, entries) -> None:
        """One (table, op) group, ONE kernel launch. A failure falls
        back to per-entry serial replay — exact serial semantics, with
        per-entry errors captured into the deferred replies."""
        name = "SERVER_PROCESS_GET" if is_get else "SERVER_PROCESS_ADD"
        if len(entries) == 1:
            with monitor(name):
                self._replay_serial(table, is_get, entries)
            return
        try:
            with monitor(name):
                if is_get:
                    results = table.process_fused_get(
                        [e.blobs for e in entries])
                    for e, blobs in zip(entries, results):
                        e.result = blobs
                        e.version = table.version
                else:
                    table.process_fused_add([e.blobs for e in entries])
                    # Every reply carries the POST-BATCH version.
                    table.version += len(entries)
                    for e in entries:
                        e.version = table.version
        except fusion.PartialFuseError as err:
            # A prefix was folded into table state before the failure:
            # account it, then replay only the unapplied tail.
            log.error("server: fused add group failed after %d of %d "
                      "— replaying the tail serially",
                      err.applied, len(entries))
            table.version += err.applied
            for e in entries[:err.applied]:
                e.version = table.version
            self._replay_serial(table, is_get, entries,
                                start=err.applied)
        except Exception:  # noqa: BLE001
            log.error("server: fused %s group failed — replaying "
                      "serially", "get" if is_get else "add")
            self._replay_serial(table, is_get, entries)

    def _replay_serial(self, table, is_get: bool, entries,
                       start: int = 0) -> None:
        for e in entries[start:]:
            try:
                if is_get:
                    e.result = table.process_get(e.blobs)
                else:
                    table.process_add(e.blobs)
                    table.version += 1
                e.version = table.version
            except Exception as exc:  # noqa: BLE001
                e.error = exc
                e.version = table.version
                log.error("server: serial replay of fused entry failed "
                          "(error travels in the reply)")

    def _send_fused_reply(self, msg: Message, entries) -> None:
        e = entries[0]
        reply = msg.create_reply_message()
        if e.error is not None:
            mark_error(reply, e.error)
        else:
            if e.is_get:
                reply.data = e.result
            stamp_version(reply, e.version)
        self.send_to(actors.COMMUNICATOR, reply)

    # ref: src/server.cpp:36-46
    def _process_get(self, msg: Message) -> None:
        with monitor("SERVER_PROCESS_GET"), \
                tracing.span(trace_of(msg), "server_process_get",
                             self._zoo.rank,
                             args={"table": msg.table_id}):
            reply = msg.create_reply_message()
            # The reply goes out even if table logic raises — a
            # swallowed reply would deadlock the requester's waiter —
            # and a failure travels back as an error reply so the
            # requester's wait() RAISES.
            try:
                if not msg.data:
                    # Sync-mode clock-tick shard (the worker's
                    # full-coverage padding): no table logic, no payload;
                    # the empty reply only counts down the requester's
                    # waiter (a SyncServer ticks its clock around this).
                    return
                table = self._table(msg.table_id)
                reply.data = table.process_get(msg.data)
                stamp_version(reply, table.version)
            except Exception as exc:  # noqa: BLE001
                mark_error(reply, exc)
                raise
            finally:
                self.send_to(actors.COMMUNICATOR, reply)

    # ref: src/server.cpp:48-58
    def _process_add(self, msg: Message) -> None:
        with monitor("SERVER_PROCESS_ADD"), \
                tracing.span(trace_of(msg), "server_process_add",
                             self._zoo.rank,
                             args={"table": msg.table_id}):
            reply = msg.create_reply_message()
            try:
                if not msg.data:
                    # Clock-tick shard: see _process_get. No version
                    # bump: nothing was applied.
                    return
                table = self._table(msg.table_id)
                table.process_add(msg.data)
                # One bump per APPLIED Add; the ack carries the
                # post-add version.
                table.version += 1
                stamp_version(reply, table.version)
            except Exception as exc:  # noqa: BLE001
                mark_error(reply, exc)
                raise
            finally:
                self.send_to(actors.COMMUNICATOR, reply)



class _VectorClock:
    """SyncServer's vector clock (ref: src/server.cpp:81-137).

    ``update(i)`` ticks worker i's local clock and returns True exactly
    when the global clock catches up to the max local clock (all workers
    level). ``finish_train(i)`` retires worker i (clock -> +inf).

    With ``num_backup`` > 0 (``-backup_worker_ratio``) the global clock
    follows the ``num_backup``-th smallest local clock instead of the
    minimum: the slowest ``num_backup`` workers no longer gate anyone,
    though their late ticks still count. With ``num_backup == 0`` every
    path is the reference's strict BSP."""

    def __init__(self, n: int, num_backup: int = 0):
        self._local = [0.0] * n
        self.global_clock = 0.0
        self._num_backup = min(max(int(num_backup), 0), max(n - 1, 0))

    @property
    def num_backup(self) -> int:
        return self._num_backup

    def local_clock(self, i: int) -> float:
        return self._local[i]

    def _max_finite(self) -> float:
        finite = [v for v in self._local if v != _INF]
        return max([self.global_clock] + finite)

    def _cutoff_min(self) -> float:
        """The (num_backup+1)-th smallest local clock: retired (+inf)
        workers sort last and hold nothing back; the num_backup slowest
        are skipped."""
        return sorted(self._local)[self._num_backup]

    def update(self, i: int) -> bool:
        self._local[i] += 1
        if self._num_backup == 0:
            if self.global_clock < min(self._local):
                self.global_clock += 1
                if self.global_clock == self._max_finite():
                    return True
            return False
        advanced = False
        # A straggler's late tick can move the cutoff several steps at
        # once; catch up fully.
        target = min(self._cutoff_min(), self._max_finite())
        while self.global_clock < target:
            self.global_clock += 1
            advanced = True
        return advanced and self.global_clock == self._max_finite()

    def finish_train(self, i: int) -> bool:
        self._local[i] = _INF
        if self._num_backup == 0:
            if self.global_clock < min(self._local):
                self.global_clock = min(self._local)
                if self.global_clock == self._max_finite():
                    return True
            return False
        target = self._cutoff_min()
        if self.global_clock < target:
            self.global_clock = min(target, max(self._max_finite(),
                                                self.global_clock))
            if self.global_clock == self._max_finite():
                return True
        return False


class SyncServer(Server):
    """BSP server (ref: src/server.cpp:67-222).

    Assumes all workers issue the same number of Adds and Gets an
    iteration. Faster workers' requests are cached and drained when the
    global clock advances; ``Server_Finish_Train`` retires a worker (at
    shutdown, or a worker that stops early under backup workers).
    """

    def __init__(self, zoo) -> None:
        super().__init__(zoo)
        # No request fusion in BSP mode, whatever -server_fuse_max says:
        # the vector clocks count ONE request per worker per step, and
        # the clock-gated caching reorders requests.
        self._fuse_max = 1
        self.register_handler(MsgType.Server_Finish_Train,
                              self._process_finish_train)
        n = zoo.num_workers
        self._num_backup = backup_worker_count(n)
        if self._num_backup:
            log.info("sync server: %d of %d workers treated as "
                     "backups (straggler cutoff)", self._num_backup, n)
        self._get_clocks = _VectorClock(n, self._num_backup)
        self._add_clocks = _VectorClock(n, self._num_backup)
        self._num_waited_add = [0] * n
        self._add_cache: Deque[Message] = collections.deque()
        self._get_cache: Deque[Message] = collections.deque()

    # ref: src/server.cpp:141-163
    def _process_add(self, msg: Message) -> None:
        worker = self._zoo.rank_to_worker_id(msg.src)
        if (self._get_clocks.local_clock(worker)
                > self._get_clocks.global_clock):
            self._add_cache.append(msg)
            self._num_waited_add[worker] += 1
            return
        # The clock ticks even when table logic raises (the error reply
        # went out): a worker whose clock stayed behind would have every
        # other worker's requests cached forever.
        try:
            super()._process_add(msg)
        finally:
            if self._add_clocks.update(worker):
                if self._num_backup == 0:
                    assert not self._add_cache
                self._drain_caches(gets=True)

    # ref: src/server.cpp:165-188
    def _process_get(self, msg: Message) -> None:
        worker = self._zoo.rank_to_worker_id(msg.src)
        if (self._add_clocks.local_clock(worker)
                > self._add_clocks.global_clock
                or self._num_waited_add[worker] > 0):
            self._get_cache.append(msg)
            return
        try:
            super()._process_get(msg)
        finally:
            if self._get_clocks.update(worker):
                self._drain_caches(adds=True)

    # ref: src/server.cpp:190-213
    def _process_finish_train(self, msg: Message) -> None:
        worker = self._zoo.rank_to_worker_id(msg.src)
        if self._add_clocks.finish_train(worker):
            if self._num_backup == 0:
                assert not self._add_cache
            self._drain_caches(gets=True)
        if self._get_clocks.finish_train(worker):
            if self._num_backup == 0:
                assert not self._get_cache
            self._drain_caches(adds=True)

    def _drain_caches(self, gets: bool = False, adds: bool = False) -> None:
        """Drain the requested cache; when a drained request levels the
        OTHER clock (only under a straggler cutoff, where a late tick can
        move the global clock several steps), alternate into the other
        cache until both settle. Strict BSP keeps the reference's single
        pass and its no-releveling invariant."""
        while gets or adds:
            if gets:
                gets = False
                while self._get_cache:
                    get_msg = self._get_cache.popleft()
                    worker = self._zoo.rank_to_worker_id(get_msg.src)
                    # A raising drained request already sent its error
                    # reply; the rest of the cache still drains and the
                    # clocks stay level.
                    try:
                        Server._process_get(self, get_msg)
                    except Exception:  # noqa: BLE001
                        log.error("sync server: drained get failed "
                                  "(error reply sent)")
                    leveled = self._get_clocks.update(worker)
                    if self._num_backup == 0:
                        assert not leveled
                    elif leveled:
                        adds = True
            else:
                adds = False
                while self._add_cache:
                    add_msg = self._add_cache.popleft()
                    worker = self._zoo.rank_to_worker_id(add_msg.src)
                    try:
                        Server._process_add(self, add_msg)
                    except Exception:  # noqa: BLE001
                        log.error("sync server: drained add failed "
                                  "(error reply sent)")
                    leveled = self._add_clocks.update(worker)
                    if self._num_backup == 0:
                        assert not leveled
                    elif leveled:
                        gets = True
                    self._num_waited_add[worker] -= 1
