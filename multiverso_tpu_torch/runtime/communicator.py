"""Bridge between local actors and the wire.

Port of ``multiverso_tpu/runtime/communicator.py`` (ref: include/
multiverso/communicator.h:11-28, src/communicator.cpp:31-107), cut to
the in-process path. ``receive`` routes ON THE CALLER'S THREAD: a
loop-back message is forwarded to the right local actor by message
type — requests to the server, replies to the worker, control requests
to the controller, control replies to the Zoo mailbox
(ref: src/communicator.cpp:13-29, 93-105); a message for another
virtual rank of the same fabric goes to that rank's inbox. One receive
thread drains this rank's inbox (ref: src/communicator.cpp:42-48,77-91).

The reference waits for device payloads before they cross into a
sibling virtual rank (``jax.block_until_ready``,
``multiverso_tpu/runtime/communicator.py:156-159``). Here every thread
launches on the one CUDA stream, so a tensor handed to another actor is
already ordered before anything that actor launches on it: no sync.
The wire codec, chaos faults and peer-loss handling belong to the
cross-process transports, which are later items of the port.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..core.message import (Message, is_controller_bound, is_server_bound,
                            is_worker_bound)
from ..util import log
from . import actor as actors
from . import thread_roles


class Communicator:
    """Message router between this rank's actors and the fabric. Not an
    ``Actor``: it owns no mailbox, only the inbox's receive thread."""

    def __init__(self, zoo) -> None:
        self.name = actors.COMMUNICATOR
        self._zoo = zoo
        self._net = zoo.net
        self._recv_thread: Optional[threading.Thread] = None
        zoo.register_actor(self)

    def start(self) -> None:
        self._net.acquire_recv_owner()
        # DISPATCH: the recv thread routes inbound frames into actor
        # mailboxes — anything blocking it starves replies.
        self._recv_thread = thread_roles.spawn(
            thread_roles.DISPATCH, target=self._recv_main,
            name=f"mv-comm-recv-r{self._zoo.rank}")

    def stop(self, finalize_net: bool = True) -> None:
        if finalize_net:
            self._net.finalize()
        else:
            self._net.interrupt_recv()
        if self._recv_thread is not None:
            self._recv_thread.join(timeout=30)
        self._net.release_recv_owner()
        self._zoo.deregister_actor(self)

    # -- messaging (zoo.route/send_to call this like any actor's) --
    def receive(self, msg: Message) -> None:
        self._safe_dispatch(msg)

    def _safe_dispatch(self, msg: Message) -> None:
        """Dispatch one message; a routing failure must not kill the
        calling actor's loop (same contract as Actor._safe_dispatch)."""
        try:
            self._dispatch(msg)
        except Exception:  # noqa: BLE001
            log.error("actor %s: handling message type %d raised",
                      self.name, msg.type_int)
            import traceback
            traceback.print_exc()

    def _dispatch(self, msg: Message) -> None:
        if msg.dst != self._zoo.rank:
            self._net.send_async(msg)
        else:
            self._local_forward(msg)

    # Inbound path: fabric -> local actor mailboxes
    # (ref: src/communicator.cpp:77-91).
    def _recv_main(self) -> None:
        while True:
            msg = self._net.recv()
            if msg is None:
                break
            self._safe_dispatch(msg)

    # Routing rule (ref: src/communicator.cpp:13-29).
    def _local_forward(self, msg: Message) -> None:
        msg_type = int(msg.type_int)
        if is_server_bound(msg_type):
            self._zoo.route(actors.SERVER, msg)
        elif is_worker_bound(msg_type):
            self._zoo.route(actors.WORKER, msg)
        elif is_controller_bound(msg_type):
            self._zoo.route(actors.CONTROLLER, msg)
        else:
            self._zoo.mailbox.push(msg)
