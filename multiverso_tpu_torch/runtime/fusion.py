"""Server-side request fusion: drain the mailbox, one device program
per (table, op) group (docs/SERVER_ENGINE.md).

Every inbound Get/Add costs the server actor one mailbox pop plus one
jitted XLA dispatch — a fixed launch cost that dominates small-row
traffic. When the mailbox holds more than one message, the server
drains a bounded batch (``MtQueue.pop_batch``, capped by
``-server_fuse_max`` / ``-server_fuse_bytes``) and fuses compatible
requests: eligible Get/Add/BatchAdd units group by (table, op) and
each group executes ONE device program — a concatenated-id gather with
cross-request row dedup for Gets, a concatenated scatter-add (stateless
rules sum duplicate ids inside the program) for Adds.

The planner in this module is pure bookkeeping — no device work, no
table state — so its invariants are unit-testable in isolation:

* **Barriers.** Any message that cannot join a fused window (control,
  shard, replica, fwd traffic — or a Get/Add the table declares
  ineligible via ``ServerTable.fuse_eligible``) is a barrier: every
  pending group executes and replies before the barrier dispatches
  through the ordinary serial handler.
* **Per-table op exclusivity.** Within one window a table holds only
  ONE op kind; a Get arriving for a table with pending Adds (or vice
  versa) flushes the window first. Groups are therefore
  order-independent: fused Gets observe exactly the adds that preceded
  them (bit-identity), fused Adds commute only with each other
  (sum-equivalence under a deterministic arrival-order fold).
* **Reply order.** Replies are deferred and emitted in arrival order
  at each barrier (and at batch end); a parent Request_BatchAdd's
  single batched ack waits for all of its sub-adds.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..core.message import Message, MsgType, unpack_add_batch
from ..util.configure import define_int

define_int("server_fuse_max", 16,
           "max requests the server actor drains from its mailbox per "
           "batch for request fusion (docs/SERVER_ENGINE.md); 1 "
           "disables fusion (strict one-message-at-a-time dispatch). "
           "Force-disabled in -sync mode: the BSP vector clocks count "
           "one request per worker per step")
define_int("server_fuse_bytes", 16 << 20,
           "byte cap on a drained fusion batch (payload bytes, summed "
           "over messages); the first message always pops regardless "
           "of size, so the cap bounds the batch tail, not a single "
           "oversized request")


class PartialFuseError(RuntimeError):
    """``process_fused_add`` failed after ``applied`` requests were
    already folded into table state. The server bumps the version for
    the applied prefix and replays only the unapplied tail serially —
    replaying an applied request would double-count its delta.
    Implementations that parse/validate every request BEFORE the first
    state mutation raise plain exceptions instead (nothing applied,
    the whole group replays)."""

    def __init__(self, applied: int, cause: BaseException):
        super().__init__(str(cause))
        self.applied = int(applied)
        self.cause = cause


class FuseEntry:
    """One fusable unit: a standalone Get/Add request, or one sub-add
    of a Request_BatchAdd (tagged with its parent via ``batch_index``
    so the batched ack reassembles per original message)."""

    __slots__ = ("batch_index", "table_id", "table", "is_get", "blobs",
                 "msg_id", "result", "version", "error")

    def __init__(self, batch_index: int, table_id: int, table,
                 is_get: bool, blobs, msg_id: int):
        self.batch_index = batch_index
        self.table_id = table_id
        self.table = table
        self.is_get = is_get
        self.blobs = blobs
        self.msg_id = msg_id
        self.result = None        # reply blobs (Gets)
        self.version = -1         # post-apply version stamp
        self.error: Optional[BaseException] = None


def message_nbytes(msg: Message) -> int:
    """Payload size of one queued message — the ``size_of`` callable
    for ``MtQueue.pop_batch``'s byte cap."""
    return sum(b.size for b in msg.data)


def classify(server, batch_index: int,
             msg: Message) -> Optional[List[FuseEntry]]:
    """The fusable units of one drained message, or None (barrier).

    A Request_BatchAdd is all-or-nothing: if ANY sub-add is ineligible
    (or the batch fails to unpack) the whole message dispatches
    serially — partial fusion would interleave the batch's own subs
    around a barrier. Table-lookup failures (rejoin gate) are barriers
    too: the serial handler owns the retryable-NACK reply shape.
    """
    t = msg.type_int
    if t in (int(MsgType.Request_Get), int(MsgType.Request_Add)):
        if not msg.data:
            return None  # sync-mode clock tick (empty payload)
        try:
            table = server._table(msg.table_id)
        except Exception:  # noqa: BLE001 - rejoin gap: serial NACK
            return None
        is_get = t == int(MsgType.Request_Get)
        try:
            eligible = table.fuse_eligible(msg.data, is_get)
        except Exception:  # noqa: BLE001 - malformed blobs: the serial
            return None    # handler owns the error-reply shape
        if not eligible:
            return None
        return [FuseEntry(batch_index, msg.table_id, table, is_get,
                          msg.data, msg.msg_id)]
    if t == int(MsgType.Request_BatchAdd):
        try:
            subs = unpack_add_batch(msg)
        except Exception:  # noqa: BLE001 - malformed batch: the
            return None    # serial handler acks every named sub failed
        entries = []
        for sub in subs:
            try:
                table = server._table(sub.table_id)
            except Exception:  # noqa: BLE001
                return None
            try:
                eligible = table.fuse_eligible(sub.data, False)
            except Exception:  # noqa: BLE001 - see above
                return None
            if not eligible:
                return None
            entries.append(FuseEntry(batch_index, sub.table_id, table,
                                     False, sub.data, sub.msg_id))
        return entries or None
    return None


#: One executable unit of a plan: ``("serial", batch_index)`` — flush
#: replies up to here, then dispatch the message through the ordinary
#: handler — or ``("fused", groups)`` with ``groups`` an ordered list
#: of ``(table, is_get, [FuseEntry])``.
PlanStep = Tuple[str, object]


def split_plan(batch: List[Message],
               infos: List[Optional[List[FuseEntry]]]) -> List[PlanStep]:
    """Turn a drained batch + its per-message classification into an
    ordered execution plan enforcing the barrier and per-table
    op-exclusivity invariants (module docstring). Pure: no table or
    device state is touched, so the plan shape is unit-testable with
    stub tables."""
    steps: List[PlanStep] = []
    groups: List[list] = []   # ordered [table, is_get, entries]
    by_key: dict = {}         # (table_id, is_get) -> group
    op_of: dict = {}          # table_id -> is_get in current window

    def flush() -> None:
        if groups:
            steps.append(("fused",
                          [(g[0], g[1], g[2]) for g in groups]))
        groups.clear()
        by_key.clear()
        op_of.clear()

    for i, msg in enumerate(batch):
        entries = infos[i]
        if not entries:
            flush()
            steps.append(("serial", i))
            continue
        for e in entries:
            cur = op_of.get(e.table_id)
            if cur is not None and cur != e.is_get:
                # Opposite op on a table already in the window: the
                # Get must observe the pending Adds (or the Adds must
                # not leak into an already-planned Get) — flush.
                flush()
            op_of[e.table_id] = e.is_get
            key = (e.table_id, e.is_get)
            g = by_key.get(key)
            if g is None:
                g = by_key[key] = [e.table, e.is_get, []]
                groups.append(g)
            g[2].append(e)
    flush()
    return steps
