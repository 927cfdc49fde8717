"""Wire message: 8-int header + list of payload blobs.

TPU-native equivalent of the reference's ``Message``
(ref: include/multiverso/message.h:13-66). Header layout and ``MsgType``
values are preserved exactly (src, dst, type, table_id, msg_id in
header[0..4]; requests positive, replies negative, control types >32) so the
routing rules in the communicator (ref: src/communicator.cpp:93-105) carry
over and a future cross-language transport can interoperate.
"""

from __future__ import annotations

import enum
from typing import List, Optional

import numpy as np

from .blob import Blob


class MsgType(enum.IntEnum):
    """ref: include/multiverso/message.h:13-24."""
    Default = 0
    Request_Get = 1
    Request_Add = 2
    # Coalesced Add: several pending Adds to the same server ride ONE
    # wire message (extension — the reference sends one message per
    # shard; value chosen inside the server-bound request band).
    Request_BatchAdd = 3
    # Hot-shard read replication (extension, docs/SHARDING.md): an
    # OWNER server pushes refreshed values + its shard version for
    # promoted rows to a replica-holding server. Fire-and-forget —
    # no requester waiter exists, so no reply type pairs with it
    # (value inside the server-bound request band).
    Request_ReplicaSync = 4
    # Live elastic resharding (extension, docs/SHARDING.md "Elastic
    # resharding"): all in the server-bound request band so they route
    # to the server actor. ShardData streams a migrating range's rows
    # source→destination (seq-numbered chunks; the FINAL chunk flips
    # the source into its dual-read/forwarding window); ShardAck is
    # the destination's retransmit request for seqs lost in flight;
    # ShardBegin/ShardAbort are the controller's move start/rollback
    # orders; FwdGet is a source-forwarded Get whose piggybacked
    # source-served rows ride the reply as a REPLICA_SLOT group
    # attributed to the source shard (the PR-7 reply contract reused
    # verbatim — no new reply format).
    Request_ShardData = 5
    Request_ShardAck = 6
    Request_ShardBegin = 7
    Request_ShardAbort = 8
    Request_FwdGet = 9
    Request_FwdAdd = 10
    #: LOCAL-ONLY (server actor self-nudge, never on the wire): stream
    #: the next migration chunk, then re-enqueue — serving traffic
    #: interleaves between chunks.
    Server_Shard_Pump = 30
    Reply_Get = -1
    Reply_Add = -2
    Reply_BatchAdd = -3
    Server_Finish_Train = 31
    Control_Barrier = 33
    Control_Reply_Barrier = -33
    Control_Register = 34
    Control_Reply_Register = -34
    # Fault-tolerance control plane (extension — the reference has no
    # failure detection at all, SURVEY.md section 5.3). Heartbeats ride
    # the controller band (>32 routes to the controller actor); the
    # reply and the dead-peer fanout use values below the worker band
    # (<= -33) and are intercepted by name in the communicator's
    # routing (they must NOT fall through to the Zoo mailbox, where a
    # blocked barrier would consume them).
    Control_Heartbeat = 35
    Control_Reply_Heartbeat = -35
    Control_Dead_Peer = -36
    #: Local-only nudge (HeartbeatMonitor -> controller actor, never
    #: on the wire): re-check whether a declared-dead rank has
    #: overstayed -rejoin_grace_s and pending barriers must fail.
    Control_Check_Barriers = 36
    # Hot-shard replication control plane (docs/SHARDING.md): servers
    # report per-row Get rates to the controller (controller band,
    # >32); the controller broadcasts the promoted-row map to every
    # rank with a value below the worker band, intercepted BY NAME in
    # the communicator's routing (like Control_Dead_Peer — it must not
    # fall through to the Zoo mailbox where a blocked barrier would
    # consume it).
    Control_Replica_Report = 37
    Control_Replica_Map = -37
    # Observability control plane (docs/OBSERVABILITY.md): each rank
    # ships its Dashboard/Samples snapshot (+ new trace events) to the
    # controller every -metrics_interval_s. Controller band (>32),
    # fire-and-forget — no reply type pairs with it.
    Control_Metrics = 38
    # Elastic-resharding control plane (docs/SHARDING.md): the
    # migration destination commits (or refuses) a move toward the
    # controller (Shard_Done, re-announced on traffic until the
    # committed map broadcast confirms it landed); applications ask
    # for a respread (Shard_Request, fire-and-forget — callers poll
    # the table's adopted epoch); the controller broadcasts the
    # epoch-stamped map (Shard_Map, below the worker band and
    # intercepted BY NAME in the communicator like
    # Control_Replica_Map — cloned to the worker AND server actors).
    # Shard_Tick is LOCAL-ONLY (HeartbeatMonitor -> controller actor,
    # never on the wire): re-send a possibly-lost Begin, re-broadcast
    # maps, check the in-flight move against declared-dead ranks.
    Control_Shard_Done = 39
    Control_Shard_Request = 40
    Control_Shard_Tick = 41
    Control_Shard_Map = -39
    # Serving-fleet pressure exchange (docs/SERVING.md fleet section):
    # each serving frontend periodically reports its admission stats
    # ([rank, admitted, shed, inflight] int64 blob) to the controller
    # (controller band, >32); the controller answers the reporter with
    # the fleet-aggregate view as a JSON blob (below the worker band,
    # intercepted BY NAME in the communicator's routing like
    # Control_Reply_Heartbeat — it must not fall through to the Zoo
    # mailbox where a blocked barrier would consume it). Both
    # directions ride net.send_async (the liveness-frame discipline —
    # mvlint pass 6).
    Control_Serving_Report = 42
    Control_Reply_Serving = -42
    # Closed-loop self-tuning control plane (runtime/autotune.py,
    # docs/AUTOTUNE.md): the controller's AutotuneManager broadcasts
    # epoch-stamped live-config updates (JSON blob
    # {"epoch": N, "flags": {...}}, every flag declared in
    # util/configure.py TUNABLE_FLAGS) to every rank — below the
    # worker band and intercepted BY NAME in the communicator's
    # routing like Control_Shard_Map (it must not fall through to the
    # Zoo mailbox where a blocked barrier would consume it). The
    # receiving rank acks with Control_Reply_Config (int64
    # [rank, applied_epoch, applied]; the type negation of the
    # broadcast, riding the controller band) so the controller's
    # gauges can show per-rank config convergence. Both directions
    # ride net.send_async (the liveness-frame discipline —
    # mvlint pass 6).
    Control_Reply_Config = 43
    Control_Config = -43
    # Shared-memory transport announce (runtime/shm.py, docs/MEMORY.md
    # "Below the socket"): the sender of a freshly created shm ring
    # segment tells the receiver to attach, carrying int64
    # [nonce, token]. Controller band by VALUE, but intercepted below
    # the communicator (ShmNet.recv consumes it before routing ever
    # sees it) — it rides TCP so it orders after every frame already
    # queued toward the destination, fencing the transport switch.
    Control_Shm_Announce = 44

HEADER_SIZE = 10  # ints (8 in the reference; slot 8 added for
#                   replication, slot 9 for request tracing)


class Message:
    __slots__ = ("header", "data")

    def __init__(self, src: int = -1, dst: int = -1,
                 msg_type: MsgType = MsgType.Default,
                 table_id: int = -1, msg_id: int = -1):
        self.header = [0] * HEADER_SIZE
        self.header[0] = src
        self.header[1] = dst
        self.header[2] = int(msg_type)
        self.header[3] = table_id
        self.header[4] = msg_id
        self.data: List[Blob] = []

    # -- header accessors (ref: message.h:28-38) --
    @property
    def src(self) -> int:
        return self.header[0]

    @src.setter
    def src(self, v: int) -> None:
        self.header[0] = v

    @property
    def dst(self) -> int:
        return self.header[1]

    @dst.setter
    def dst(self, v: int) -> None:
        self.header[1] = v

    @property
    def type(self) -> MsgType:
        return MsgType(self.header[2])

    @type.setter
    def type(self, v: MsgType) -> None:
        self.header[2] = int(v)

    @property
    def table_id(self) -> int:
        return self.header[3]

    @table_id.setter
    def table_id(self, v: int) -> None:
        self.header[3] = v

    @property
    def msg_id(self) -> int:
        return self.header[4]

    @msg_id.setter
    def msg_id(self, v: int) -> None:
        self.header[4] = v

    @property
    def type_int(self) -> int:
        """The raw type header int. Unlike ``.type`` this never raises
        on a value outside ``MsgType`` (a newer peer's message type must
        be loggable/routable as a plain int, not a ValueError) — actor
        dispatch and wire routing read this."""
        return self.header[2]

    def push(self, blob) -> None:
        if not isinstance(blob, Blob):
            blob = Blob(np.ascontiguousarray(blob))
        self.data.append(blob)

    def text_payload(self, index: int = 0,
                     errors: str = "replace") -> str:
        """UTF-8 text of payload blob ``index``, decoded straight from
        the blob's uint8 view — no intermediate ``bytes(...)`` copy.
        THE reader for every JSON/error-text payload on the wire
        (error replies, serving-fleet aggregates, Control_Config
        broadcasts, metrics snapshots): one helper instead of five
        scattered ``bytes(blob.as_array(np.uint8)).decode()`` sites,
        and the one place the decode policy (``errors``) lives."""
        arr = np.ascontiguousarray(self.data[index].as_array(np.uint8))
        return str(memoryview(arr), "utf-8", errors)

    def size(self) -> int:
        return len(self.data)

    def create_reply_message(self) -> "Message":
        """Reply with src/dst swapped and type negated (ref: message.h:51-59)."""
        reply = Message(src=self.dst, dst=self.src,
                        msg_type=MsgType(-self.header[2]),
                        table_id=self.table_id, msg_id=self.msg_id)
        # The reply leg belongs to the same sampled request: carrying
        # the trace id back lets the requester's rank pair reply-side
        # spans under one trace (0 = unsampled, the common case).
        reply.header[TRACE_SLOT] = self.header[TRACE_SLOT]
        return reply

    def __repr__(self) -> str:
        return (f"Message(src={self.src}, dst={self.dst}, type={self.type.name}, "
                f"table={self.table_id}, msg_id={self.msg_id}, blobs={len(self.data)})")


# Header slot 5 carries an error flag on replies (0 = ok). The reference
# leaves slots 5-7 unused (message.h:28-38); using one lets a server-side
# failure travel back to the requester instead of degrading to an empty
# reply, so the caller's wait() can raise rather than return garbage.
ERROR_SLOT = 5


def mark_error(reply: "Message", exc: BaseException) -> None:
    """Flag a reply as failed and replace its payload with the error text
    (utf-8 bytes in a single blob)."""
    reply.header[ERROR_SLOT] = 1
    text = f"{type(exc).__name__}: {exc}".encode(errors="replace")
    reply.data = [Blob(np.frombuffer(text, np.uint8).copy())]


def take_error(msg: "Message") -> Optional[str]:
    """The error text of a failed reply, or None for a normal one."""
    if msg.header[ERROR_SLOT] == 0:
        return None
    if msg.data:
        return msg.text_payload()
    return "remote table operation failed"


#: Marker carried inside error-reply text when the failure is a LOST
#: PEER rather than table logic: the wire to the serving rank broke, or
#: the controller declared it dead. Requests failed this way are
#: RETRYABLE (the peer may restart and rejoin) — ``WorkerTable.wait``
#: raises ``PeerLostError`` instead of ``TableRequestError`` when the
#: recorded error carries this marker, and the sync-call retry loop
#: keys off that type. Travels as plain text so it survives the
#: mark_error/take_error round trip unchanged across builds.
PEER_LOST_MARK = "[peer-lost]"


# Header slot 6 marks a codec-encoded payload (see util/wire_codec.py):
# the communicator's filter stage sets it on encode and the receive path
# decodes before routing, so frames stay self-describing on the wire.
CODEC_SLOT = 6


def is_wire_encoded(msg: "Message") -> bool:
    return bool(msg.header[CODEC_SLOT])


# Header slot 7 carries the serving table shard's VERSION on replies
# (client-cache staleness tracking, tables/client_cache.py): servers
# bump a per-shard counter once per applied Add and stamp every reply.
# The wire value is version+1 so that 0 — the header default, and what
# a pre-version peer sends — reads as "unstamped" (-1), never as a real
# version.
VERSION_SLOT = 7


#: WIRE-SLOT REGISTRY — the single source of truth for the reserved
#: header slots (5-7). Everything outside this module must index
#: ``msg.header`` through these names (or the 0-4 property accessors),
#: never a raw int literal: ``tools/mvlint``'s wire-slot pass enforces
#: that, and cross-checks this literal against the slot table in
#: ``docs/WIRE_FORMAT.md`` so the doc cannot silently drift from the
#: wire. Keep the values literal (the lint parses, it does not import).
WIRE_SLOTS: dict = {
    "ERROR_SLOT": 5,
    "CODEC_SLOT": 6,
    "VERSION_SLOT": 7,
    "REPLICA_SLOT": 8,
    "TRACE_SLOT": 9,
}

assert ERROR_SLOT == WIRE_SLOTS["ERROR_SLOT"]
assert CODEC_SLOT == WIRE_SLOTS["CODEC_SLOT"]
assert VERSION_SLOT == WIRE_SLOTS["VERSION_SLOT"]


# Header slot 8 marks a Get reply that carries REPLICA-SERVED rows
# (hot-shard read replication, docs/SHARDING.md): the wire value is
# n_replica_rows + 1 (0 = header default = no replica content, the only
# value pre-replication builds ever send). A marked reply's LAST payload
# blob is an int32 replica descriptor
#   [n_groups, (owner_sid, floor_version+1, n_rows) * n_groups]
# and the reply's key vector is ordered [owned rows..., group 0 rows...,
# group n-1 rows...]: the serving server attributes each replica group
# to the shard that OWNS the rows, with the group's version floor (the
# oldest owner version among the served rows). Growing the header from
# 8 to 9 ints is a declared WIRE BREAK for mixed-build clusters
# (docs/WIRE_FORMAT.md).
REPLICA_SLOT = 8

assert REPLICA_SLOT == WIRE_SLOTS["REPLICA_SLOT"]


def mark_replica_reply(reply: "Message", n_replica_rows: int) -> None:
    reply.header[REPLICA_SLOT] = int(n_replica_rows) + 1


def replica_row_count(msg: "Message") -> int:
    """Replica-served rows a Get reply carries (0 = none / pre-replica
    peer)."""
    raw = int(msg.header[REPLICA_SLOT])
    return raw - 1 if raw > 0 else 0


# Header slot 9 carries the DISTRIBUTED TRACE ID of a sampled request
# (util/tracing.py, docs/OBSERVABILITY.md): 0 — the header default, and
# the only value a -trace_sample_rate=0 build (or a pre-trace peer)
# ever sends — means "unsampled"; a nonzero id is carried verbatim on
# every shard/batch/reply message the request spawns so span events
# recorded on different ranks pair under one trace. Growing the header
# from 9 to 10 ints is a declared WIRE BREAK for mixed-build TCP
# clusters (docs/WIRE_FORMAT.md), the same class as the PR-7 slot-8
# bump.
TRACE_SLOT = 9

assert TRACE_SLOT == WIRE_SLOTS["TRACE_SLOT"]


def stamp_trace(msg: "Message", trace_id: int) -> None:
    msg.header[TRACE_SLOT] = int(trace_id)


def trace_of(msg: "Message") -> int:
    """The trace id a message carries (0 = unsampled / pre-trace
    peer)."""
    return int(msg.header[TRACE_SLOT])


def stamp_version(reply: "Message", version: int) -> None:
    reply.header[VERSION_SLOT] = int(version) + 1


def reply_version(msg: "Message") -> int:
    """The shard version stamped on a reply, or -1 when the peer didn't
    stamp one (legacy build / error reply)."""
    return int(msg.header[VERSION_SLOT]) - 1


# -- Add coalescing (Request_BatchAdd / Reply_BatchAdd) --
#
# Batch request layout: blob 0 is an int32 descriptor
#   [n_sub, table_id_0, msg_id_0, n_blobs_0, ..., table_id_{n-1}, ...]
# followed by every sub-message's blobs in order. Batch reply layout:
# blob 0 is int32 [n_sub, table_id_0, msg_id_0, err_0, version_0, ...]
# followed by one utf-8 error-text blob per err_i != 0 (in sub order);
# version_i is the shard version after the sub was applied (-1 when the
# server could not resolve the table), the batched twin of the
# VERSION_SLOT stamp on per-message replies.

def pack_add_batch(subs: List["Message"]) -> "Message":
    """Coalesce several Request_Add shard messages (same src, same dst)
    into one Request_BatchAdd wire message."""
    first = subs[0]
    batch = Message(src=first.src, dst=first.dst,
                    msg_type=MsgType.Request_BatchAdd)
    for sub in subs:
        # The batch inherits the first SAMPLED sub's trace id: a trace
        # that lands in a coalesced flush keeps its wire spans (the
        # batch is that sub's wire message; sibling sampled subs are
        # attributed by their own issue/reply spans).
        if sub.header[TRACE_SLOT]:
            batch.header[TRACE_SLOT] = sub.header[TRACE_SLOT]
            break
    desc = [len(subs)]
    for sub in subs:
        desc.extend((sub.table_id, sub.msg_id, len(sub.data)))
    batch.push(Blob(np.asarray(desc, dtype=np.int32)))
    for sub in subs:
        batch.data.extend(sub.data)
    return batch


def unpack_add_batch(batch: "Message") -> List["Message"]:
    """Reverse ``pack_add_batch`` into per-table Request_Add messages."""
    desc = batch.data[0].as_array(np.int32)
    n = int(desc[0])
    subs: List[Message] = []
    off = 1
    blob_off = 1
    for _ in range(n):
        table_id, msg_id, n_blobs = (int(v) for v in desc[off:off + 3])
        off += 3
        sub = Message(src=batch.src, dst=batch.dst,
                      msg_type=MsgType.Request_Add,
                      table_id=table_id, msg_id=msg_id)
        sub.data = list(batch.data[blob_off:blob_off + n_blobs])
        blob_off += n_blobs
        subs.append(sub)
    if blob_off != len(batch.data):
        raise ValueError(
            f"batch add: descriptor claims {blob_off - 1} blobs, "
            f"message carries {len(batch.data) - 1}")
    return subs


def is_server_bound(msg_type: int) -> bool:
    """Request types route to the server actor (ref: communicator.cpp:93-105)."""
    return 0 < msg_type < 32


def is_worker_bound(msg_type: int) -> bool:
    """Reply types route to the worker actor."""
    return -32 < msg_type < 0


def is_controller_bound(msg_type: int) -> bool:
    """Control requests route to the controller actor."""
    return msg_type > 32
