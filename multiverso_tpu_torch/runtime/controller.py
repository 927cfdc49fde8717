"""Rank-0 coordination actor: registration + barrier.

Port of ``multiverso_tpu/runtime/controller.py`` (ref: include/
multiverso/controller.h:9-22, src/controller.cpp:12-104), cut to the
two sub-controllers the in-process slice runs:

- barrier: collects one Control_Barrier per rank, then replies
  Control_Reply_Barrier to every sender (ref: src/controller.cpp:12-36);
- register: collects one Control_Register (carrying the rank's declared
  role) per rank, assigns dense worker_id/server_id in rank order, then
  broadcasts the node table + counts to every rank
  (ref: src/controller.cpp:38-80);
- metrics: every rank's ``Control_Metrics`` report folds into
  ``self.metrics``, a ``ClusterMetrics`` view (``runtime/metrics.py``).

Liveness, rejoin, replica and shard planning and autotune are later
items of the port.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.blob import Blob
from ..core.message import Message, MsgType
from ..core.node import Node, is_server, is_worker
from ..util import log
from . import actor as actors
from . import metrics as metrics_mod
from .actor import Actor


class Controller(Actor):
    def __init__(self, zoo) -> None:
        super().__init__(actors.CONTROLLER, zoo)
        self._barrier_waiting: List[Message] = []
        self._register_waiting: List[Message] = []
        self.register_handler(MsgType.Control_Barrier, self._process_barrier)
        self.register_handler(MsgType.Control_Register,
                              self._process_register)
        self.metrics = metrics_mod.ClusterMetrics()
        self.register_handler(MsgType.Control_Metrics,
                              self._process_metrics)

    def _process_barrier(self, msg: Message) -> None:
        self._barrier_waiting.append(msg)
        if len(self._barrier_waiting) == self._zoo.net_size:
            for request in self._barrier_waiting:
                self.send_to(actors.COMMUNICATOR,
                             request.create_reply_message())
            self._barrier_waiting = []

    def _process_register(self, msg: Message) -> None:
        self._register_waiting.append(msg)
        if len(self._register_waiting) != self._zoo.net_size:
            return
        # Assign dense worker/server ids in rank order
        # (ref: src/controller.cpp:46-66).
        nodes = [Node(rank=r) for r in range(self._zoo.net_size)]
        for request in self._register_waiting:
            reg = request.data[0].as_array(np.int32)
            nodes[int(reg[0])].role = int(reg[1])
        num_workers = num_servers = 0
        for node in nodes:
            if is_worker(node.role):
                node.worker_id = num_workers
                num_workers += 1
            if is_server(node.role):
                node.server_id = num_servers
                num_servers += 1
        table = np.array(
            [[n.rank, n.role, n.worker_id, n.server_id] for n in nodes],
            dtype=np.int32)
        counts = np.array([num_workers, num_servers], dtype=np.int32)
        for request in self._register_waiting:
            reply = request.create_reply_message()
            reply.push(Blob(table.copy()))
            reply.push(Blob(counts.copy()))
            self.send_to(actors.COMMUNICATOR, reply)
        self._register_waiting = []

    def _process_metrics(self, msg: Message) -> None:
        """A rank's periodic metrics snapshot (fire-and-forget)."""
        payload = metrics_mod.parse_report(msg)
        if payload is None:
            log.error("controller: undecodable metrics report from "
                      "rank %d", msg.src)
            return
        self.metrics.ingest(payload)
