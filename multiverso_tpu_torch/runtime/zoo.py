"""Zoo: per-rank runtime singleton — bootstrap, routing, barrier.

Port of ``multiverso_tpu/runtime/zoo.py`` (ref: include/multiverso/
zoo.h:19-85, src/zoo.cpp:41-188), cut to the in-process paths: one
process is worker, server and controller at once over a one-rank
``LocalFabric``, or it runs several virtual ranks, one zoo each, over
one ``LocalFabric`` (``runtime/cluster.py`` ``LocalCluster``, where a
``role=`` per zoo replaces the process-wide ``-ps_role``, and ``abort``
wakes every rank blocked on a failed sibling). Start order mirrors the
reference
(ref: src/zoo.cpp:73-102): controller, communicator, register with the
controller to learn the rank→worker_id/server_id map, then server and
worker actors, then a barrier. With ``-ma=true`` (model-average mode)
the zoo starts no parameter server at all: no actors, no registration,
no barrier; the ranks meet only in the fabric's collectives
(``mv.aggregate``, ``parallel/ma.py``).

The zoo owns the ``torch.device`` that every table of this rank keeps
its storage on (``mv.init(argv, device=...)``): ``cuda:0`` unless the
caller asks for another device. A flag that selects a feature of the
reference that this port does not have yet raises
``NotImplementedError`` naming its ROADMAP item; none is silently
ignored.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..core.blob import Blob
from ..core.message import Message, MsgType
from ..core.node import Node, Role, is_server, is_worker, role_from_string
from ..util import chaos  # noqa: F401  (registers -chaos_* flags)
from ..util import log
from ..util.configure import (define_bool, define_double, define_int,
                              define_string, get_flag, parse_cmd_flags)
from ..util.mt_queue import MtQueue
from . import actor as actors
from .communicator import Communicator
from .controller import Controller
from .net import LocalFabric, NetInterface
from .server import Server
from .worker import Worker

define_string("ps_role", "default", "none / worker / server / default(all)")
define_bool("ma", False, "model-average mode: skip the parameter server")
# Flags of reference features that are not ported yet. Defined here (with
# the reference's defaults) so that they parse; a non-default value
# raises in Zoo.start.
define_string("machine_file", "", "TCP mesh machine file (not ported)")
define_bool("sync", False, "BSP sync server")
define_bool("rejoin", False, "restarted rank rejoining a live cluster")
define_int("rpc_retry_max", 0, "retries of a Get/Add after a lost peer")
define_double("rpc_timeout_s", 0.0, "diagnostic table request timeout")
define_double("heartbeat_interval_s", 0.0, "liveness heartbeat period")
define_string("snapshot_dir", "", "server snapshot directory")
define_double("snapshot_interval_s", 0.0, "server snapshot period")
define_int("replica_hot_rows", 0, "hot-row read replication")
define_bool("reshard_auto", False, "automatic elastic resharding")
define_int("shard_initial_servers", 0, "servers owning rows at creation")
define_int("serving_port", 0, "online serving frontend port")
define_double("metrics_interval_s", 0.0, "metrics export period")
define_int("metrics_port", 0, "controller metrics scrape port")
define_double("autotune_interval_s", 0.0, "closed-loop autotune period")
define_int("max_get_staleness", 0, "worker row cache staleness bound")
define_bool("one_bit_push", False, "1-bit quantized matrix pushes")

#: flag -> (ROADMAP item, the reference feature it selects)
UNPORTED_FLAGS: Dict[str, tuple] = {
    "machine_file": ("A9", "the multi-process TCP transport"),
    "sync": ("A5", "the BSP sync server"),
    "rejoin": ("A9", "rank rejoin (fault tolerance)"),
    "rpc_retry_max": ("A9", "peer-loss retries (fault tolerance)"),
    "rpc_timeout_s": ("A9", "request timeouts (fault tolerance)"),
    "heartbeat_interval_s": ("A9", "liveness heartbeats"),
    "snapshot_dir": ("A9", "server snapshots"),
    "snapshot_interval_s": ("A9", "server snapshots"),
    "replica_hot_rows": ("A9", "hot-row replication"),
    "reshard_auto": ("A9", "elastic resharding"),
    "shard_initial_servers": ("A9", "elastic resharding"),
    "serving_port": ("A12", "the serving tier"),
    "metrics_interval_s": ("A5", "metrics export"),
    "metrics_port": ("A5", "metrics export"),
    "autotune_interval_s": ("A9", "closed-loop autotune"),
    "max_get_staleness": ("A6", "the worker row cache"),
    "one_bit_push": ("A6", "1-bit quantized pushes"),
    "chaos_frames": ("A9", "the chaos harness"),
    "chaos_kill_on": ("A9", "the chaos harness"),
}

#: Defaults of UNPORTED_FLAGS (the reference's CANONICAL_FLAGS values).
_UNPORTED_DEFAULTS = {
    "machine_file": "", "sync": False, "rejoin": False,
    "rpc_retry_max": 0, "rpc_timeout_s": 0.0,
    "heartbeat_interval_s": 0.0, "snapshot_dir": "",
    "snapshot_interval_s": 0.0, "replica_hot_rows": 0,
    "reshard_auto": False, "shard_initial_servers": 0, "serving_port": 0,
    "metrics_interval_s": 0.0, "metrics_port": 0,
    "autotune_interval_s": 0.0, "max_get_staleness": 0,
    "one_bit_push": False, "chaos_frames": "", "chaos_kill_on": "",
}

CONTROLLER_RANK = 0

_ABORT = object()  # mailbox sentinel: unblocks control waits on abort


class ClusterAborted(RuntimeError):
    """Raised out of blocking control calls after Zoo.abort()."""


_tls = threading.local()
_default_zoo: Optional["Zoo"] = None


def current_zoo() -> "Zoo":
    zoo = getattr(_tls, "zoo", None) or _default_zoo
    if zoo is None:
        raise RuntimeError("multiverso not initialized: call mv.init() first")
    return zoo


def set_thread_zoo(zoo: Optional["Zoo"]) -> None:
    _tls.zoo = zoo


def set_default_zoo(zoo: Optional["Zoo"]) -> None:
    global _default_zoo
    _default_zoo = zoo


def resolve_device(device=None):
    """The zoo's ``torch.device``: ``cuda:0`` by default. A CUDA device
    on a host without CUDA raises — there is no CPU fallback; the CPU
    runs only when the caller asks for it."""
    import torch
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"multiverso_tpu_torch: device {dev} requested but CUDA "
                f"is not available (pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_unported_flags() -> None:
    """Raise for any flag selecting a reference feature not ported
    yet (see UNPORTED_FLAGS)."""
    for name, (item, what) in UNPORTED_FLAGS.items():
        if get_flag(name) != _UNPORTED_DEFAULTS[name]:
            raise NotImplementedError(
                f"-{name}={get_flag(name)!r} selects {what}, which "
                f"multiverso_tpu_torch does not port yet (ROADMAP {item})")
    role = str(get_flag("ps_role")).lower()
    if role not in ("default", "all"):
        raise NotImplementedError(
            f"-ps_role={role!r}: a rank of one role per process needs the "
            f"multi-process runtime (ROADMAP A9); virtual ranks in one "
            f"process take a role each from LocalCluster(roles=...)")


class Zoo:
    def __init__(self) -> None:
        self._net: Optional[NetInterface] = None
        self._actors: Dict[str, object] = {}
        self.mailbox: MtQueue = MtQueue()
        self._nodes: List[Node] = []
        self._num_workers = 0
        self._num_servers = 0
        self._started = False
        self._server_tables: List = []
        self._aborted = False
        self._role_override: Optional[str] = None
        self._ma = False
        self.device = None

    # -- lifecycle (ref: src/zoo.cpp:41-60) --
    def start(self, argv: Optional[List[str]] = None,
              net: Optional[NetInterface] = None,
              device=None, role: Optional[str] = None) -> List[str]:
        """``role`` overrides the -ps_role flag for this zoo (the flag
        registry is process-global; virtual ranks with heterogeneous
        roles need a per-zoo override). It needs an in-process net."""
        remaining = parse_cmd_flags(argv)
        check_unported_flags()
        self.device = resolve_device(device)
        self._net = net if net is not None else LocalFabric(1).endpoint(0)
        if role is not None and not self._net.in_process:
            raise NotImplementedError(
                f"role={role!r} on a net that leaves the process: split "
                f"roles across processes need the multi-process runtime "
                f"(ROADMAP A9)")
        self._role_override = role
        self._ma = bool(get_flag("ma"))
        if not self._ma:
            try:
                self._start_ps()
            except BaseException:
                self._teardown_partial_start()
                raise
        self._started = True
        log.debug("Rank %d: multiverso started on %s", self.rank,
                  self.device)
        return remaining

    def _teardown_partial_start(self) -> None:
        for name in (actors.WORKER, actors.SERVER, actors.CONTROLLER):
            actor = self._actors.get(name)
            if actor is not None:
                actor.stop()
        comm = self._actors.get(actors.COMMUNICATOR)
        if comm is not None:
            comm.stop()
        elif self._net is not None:
            self._net.finalize()
        self._actors.clear()

    def stop(self, finalize_net: bool = True) -> None:
        """ref: src/zoo.cpp:52-60,104-114."""
        if not self._started:
            return
        if self._ma:
            # No actors to stop (the reference's runtime/zoo.py:287): the
            # endpoint is only the collectives'.
            if finalize_net:
                self._net.finalize()
        else:
            self._stop_ps(finalize_net)
        self._actors.clear()
        self._server_tables.clear()
        self._started = False
        log.debug("Rank %d: multiverso shut down", self.rank)

    def _stop_ps(self, finalize_net: bool) -> None:
        # After an abort the barrier would block on peers that are gone;
        # tear the actors down directly.
        if not self._aborted:
            self.barrier()
        # Reverse start order (ref: src/zoo.cpp:104-113); communicator
        # last so in-flight replies still route.
        for name in (actors.WORKER, actors.SERVER, actors.CONTROLLER):
            actor = self._actors.get(name)
            if actor is not None:
                actor.stop()
        comm = self._actors.get(actors.COMMUNICATOR)
        if comm is not None:
            comm.stop(finalize_net=finalize_net)

    def _start_ps(self) -> None:
        role = int(role_from_string(self._role_override
                                    or get_flag("ps_role")))
        self._nodes = [Node(rank=r, role=int(Role.NONE))
                       for r in range(self.net_size)]
        self._nodes[self.rank].role = role
        # Start order is non-trivial (ref: src/zoo.cpp:83-99): the
        # controller must be routable before any register traffic lands.
        if self.rank == CONTROLLER_RANK:
            Controller(self).start()
        Communicator(self).start()
        self._register_node(role)
        if is_server(role):
            Server(self).start()
        if is_worker(role):
            Worker(self).start()
        self.barrier()

    # -- registration protocol (ref: src/zoo.cpp:116-145) --
    def _register_node(self, role: int) -> None:
        msg = Message(src=self.rank, dst=CONTROLLER_RANK,
                      msg_type=MsgType.Control_Register)
        msg.push(Blob(np.array([self.rank, role], dtype=np.int32)))
        self.send_to(actors.COMMUNICATOR, msg)
        reply = self._pop_control()
        assert reply.type == MsgType.Control_Reply_Register
        table = reply.data[0].as_array(np.int32).reshape(-1, 4)
        counts = reply.data[1].as_array(np.int32)
        for rank, node_role, worker_id, server_id in table:
            node = self._nodes[rank]
            node.role = int(node_role)
            node.worker_id = int(worker_id)
            node.server_id = int(server_id)
        self._num_workers = int(counts[0])
        self._num_servers = int(counts[1])

    # -- identity --
    @property
    def net(self) -> NetInterface:
        return self._net

    @property
    def rank(self) -> int:
        return self._net.rank if self._net is not None else 0

    @property
    def size(self) -> int:
        return self.net_size

    @property
    def net_size(self) -> int:
        return self._net.size if self._net is not None else 1

    @property
    def num_workers(self) -> int:
        return self._num_workers

    @property
    def num_servers(self) -> int:
        return self._num_servers

    def rank_to_worker_id(self, rank: int) -> int:
        return self._nodes[rank].worker_id

    def rank_to_server_id(self, rank: int) -> int:
        return self._nodes[rank].server_id

    def server_rank(self, server_id: int) -> int:
        for node in self._nodes:
            if node.server_id == server_id:
                return node.rank
        return -1

    @property
    def servers_in_process(self) -> bool:
        """True when every server shard lives in this process — the
        zero-copy device data plane (tensors in requests and replies)
        is then valid. Always true on the in-process fabric."""
        return self.net.in_process

    @property
    def worker_id(self) -> int:
        return self.rank_to_worker_id(self.rank)

    @property
    def server_id(self) -> int:
        return self.rank_to_server_id(self.rank)

    # -- actor registry / routing (ref: src/zoo.cpp:64-71,146-149) --
    def register_actor(self, actor) -> None:
        self._actors[actor.name] = actor

    def deregister_actor(self, actor) -> None:
        self._actors.pop(actor.name, None)

    def send_to(self, name: str, msg: Message) -> None:
        actor = self._actors.get(name)
        if actor is None:
            raise RuntimeError(f"no actor named {name!r} on rank {self.rank}")
        actor.receive(msg)

    route = send_to  # alias used by the communicator's inbound path

    # -- abort: unblock every control wait after a peer failure --
    def abort(self) -> None:
        """Mark this zoo dead and wake any thread blocked in barrier(),
        registration, or a table wait. LocalCluster calls it on every
        rank when one rank fails: without it, mispaired barriers and
        requests to the dead rank hang forever."""
        self._aborted = True
        self.mailbox.push(_ABORT)
        worker = self._actors.get(actors.WORKER)
        if worker is not None:
            worker.abort_tables(f"rank {self.rank}: cluster aborted")

    def _pop_control(self):
        reply = self.mailbox.pop()
        if reply is _ABORT or self._aborted:
            raise ClusterAborted(f"rank {self.rank}: cluster aborted")
        return reply

    # -- collective control (ref: src/zoo.cpp:152-176) --
    def barrier(self) -> None:
        msg = Message(src=self.rank, dst=CONTROLLER_RANK,
                      msg_type=MsgType.Control_Barrier)
        self.send_to(actors.COMMUNICATOR, msg)
        reply = self._pop_control()
        assert reply.type == MsgType.Control_Reply_Barrier

    # -- table registration (ref: src/zoo.cpp:178-186) --
    def register_worker_table(self, worker_table) -> int:
        worker = self._actors.get(actors.WORKER)
        if worker is None:
            raise RuntimeError("no worker actor on this rank")
        return worker.register_table(worker_table)

    def register_server_table(self, server_table) -> int:
        server = self._actors.get(actors.SERVER)
        if server is None:
            raise RuntimeError("no server actor on this rank")
        tid = server.register_table(server_table)
        self._server_tables.append(server_table)
        return tid

    @property
    def server_tables(self) -> List:
        return self._server_tables
