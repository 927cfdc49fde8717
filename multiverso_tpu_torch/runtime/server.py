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
The BSP sync server, snapshots, replicas and elastic resharding are
later items of the port.
"""

from __future__ import annotations

from typing import List

from ..core.message import (Message, MsgType, mark_error, stamp_version,
                            trace_of)
from ..util import log, tracing
from ..util.configure import get_flag
from ..util.dashboard import monitor, samples
from . import actor as actors
from . import fusion
from .actor import Actor


class Server(Actor):
    def __init__(self, zoo) -> None:
        super().__init__(actors.SERVER, zoo)
        self._store: List = []  # registered ServerTables, by table id
        self.register_handler(MsgType.Request_Get, self._process_get)
        self.register_handler(MsgType.Request_Add, self._process_add)
        self._fuse_max = max(int(get_flag("server_fuse_max")), 1)
        self._fuse_bytes = max(int(get_flag("server_fuse_bytes")), 1)

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

