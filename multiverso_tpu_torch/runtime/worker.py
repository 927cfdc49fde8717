"""Worker actor: routes table requests to server shards.

Port of ``multiverso_tpu/runtime/worker.py`` (ref: include/multiverso/
worker.h:12-25, src/worker.cpp:12-89), cut to the in-process path. On
Get/Add it asks the table to ``partition`` the request into
per-server-shard blob lists, re-arms the table's waiter to the shard
count, and sends one message per shard through the communicator; on
replies it hands the payload back to the table and counts down the
waiter. Under ``-sync`` every server sees one request from this worker
a step: a server the partition skips gets an empty clock-tick shard,
and so does every server when ``partition`` raises. Add coalescing (a
wire optimization), replica repair and the dead-peer sweep belong to
the cross-process transports, later items of the port.
"""

from __future__ import annotations

from ..core.message import (Message, MsgType, reply_version, take_error,
                            trace_of)
from ..util import tracing
from ..util.configure import get_flag
from ..util.dashboard import monitor
from . import actor as actors
from .actor import Actor


class Worker(Actor):
    def __init__(self, zoo) -> None:
        super().__init__(actors.WORKER, zoo)
        self._cache = []  # registered WorkerTables, indexed by table id
        self.register_handler(MsgType.Request_Get, self._process_get)
        self.register_handler(MsgType.Request_Add, self._process_add)
        self.register_handler(MsgType.Reply_Get, self._process_reply_get)
        self.register_handler(MsgType.Reply_Add, self._process_reply_add)

    def register_table(self, worker_table) -> int:
        self._cache.append(worker_table)
        return len(self._cache) - 1

    def abort_tables(self, reason: str) -> None:
        for table in self._cache:
            table.abort(reason)

    # ref: src/worker.cpp:30-51
    def _process_get(self, msg: Message) -> None:
        with monitor("WORKER_PROCESS_GET"):
            self._partition_and_send(msg, MsgType.Request_Get)

    # ref: src/worker.cpp:53-76
    def _process_add(self, msg: Message) -> None:
        with monitor("WORKER_PROCESS_ADD"):
            self._partition_and_send(msg, MsgType.Request_Add)

    def _partition_and_send(self, msg: Message, msg_type: MsgType) -> None:
        table = self._cache[msg.table_id]
        num_servers = self._zoo.num_servers
        sync = bool(get_flag("sync"))
        try:
            partitions = table.partition(msg.data, msg_type)
        except Exception as exc:
            # Record the failure on the request and release the caller's
            # waiter — wait() raises instead of returning 'success' over
            # an untouched destination buffer (the actor loop only logs).
            if not sync:
                table.fail(msg.msg_id, f"partition failed: {exc}")
                raise
            # BSP: the sync servers must still see one request from this
            # worker, or its clock falls behind and every other worker's
            # requests stay cached forever. An empty shard to every
            # server takes the tick-only path; the caller still raises
            # from the failure recorded here.
            table.fail(msg.msg_id, f"partition failed: {exc}",
                       count=False)
            table.reset(msg.msg_id, num_servers)
            for server_id in range(num_servers):
                self._send_shard(msg, msg_type, server_id, None)
            raise
        # BSP full coverage: a server the partition skips (a KV add to
        # one key reaches one shard) gets an empty clock-tick shard.
        pad_sync = sync and len(partitions) < num_servers
        table.reset(msg.msg_id,
                    num_servers if pad_sync else len(partitions))
        targets = range(num_servers) if pad_sync else partitions.keys()
        for server_id in targets:
            self._send_shard(msg, msg_type, server_id,
                             partitions.get(server_id))

    def _send_shard(self, msg: Message, msg_type: MsgType, server_id: int,
                    blobs) -> None:
        shard = Message(src=self._zoo.rank,
                        dst=self._zoo.server_rank(server_id),
                        msg_type=msg_type,
                        table_id=msg.table_id, msg_id=msg.msg_id)
        if blobs is not None:
            shard.data = list(blobs)
        self.send_to(actors.COMMUNICATOR, shard)

    # ref: src/worker.cpp:78-84
    def _process_reply_get(self, msg: Message) -> None:
        table = self._cache[msg.table_id]
        # Every shard reply — error or not — counts exactly one notify
        # (the finally), so the waiter completes only after ALL shards
        # report; wait() then raises on any recorded failure.
        try:
            error = take_error(msg)
            if error is not None:
                table.fail(msg.msg_id, error, count=False)
            elif not msg.data:
                # Benign tick reply (sync-mode full-coverage padding):
                # nothing to hand to the table, only a count down.
                pass
            else:
                table._begin_reply(self._zoo.rank_to_server_id(msg.src),
                                   reply_version(msg), msg.msg_id)
                try:
                    with tracing.span(trace_of(msg), "reply_handle:get",
                                      self._zoo.rank):
                        table.process_reply_get(msg.data)
                finally:
                    table._end_reply()
        except Exception as exc:
            table.fail(msg.msg_id, f"reply handling failed: {exc}",
                       count=False)
            raise
        finally:
            table.notify(msg.msg_id)

    # ref: src/worker.cpp:86-88
    def _process_reply_add(self, msg: Message) -> None:
        table = self._cache[msg.table_id]
        # The piggybacked version lands BEFORE the notify: the adder's
        # completion callback reads the tracker to resolve its
        # self-invalidated cache slots (read-your-writes); it also
        # raises this worker's read-your-writes floor for the shard.
        table.note_add_ack(self._zoo.rank_to_server_id(msg.src),
                           reply_version(msg))
        error = take_error(msg)
        if error is not None:
            table.fail(msg.msg_id, error, count=False)
        table.notify(msg.msg_id)
