"""Actor base: a named thread draining a mailbox through a handler table.

TPU-native equivalent of the reference's ``Actor``
(ref: include/multiverso/actor.h:18-58, src/actor.cpp:14-55). Same design:
each actor owns one thread whose main loop pops messages off ``mailbox`` and
dispatches on ``MsgType`` via a registered handler map; ``send_to`` routes to
sibling actors through the owning Zoo by name. Actor names match the
reference (ref: include/multiverso/actor.h:60-67) so routing rules carry
over verbatim.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..core.message import Message
from ..util import log
from ..util.mt_queue import MtQueue
from . import thread_roles

# ref: include/multiverso/actor.h:60-67
WORKER = "worker"
SERVER = "server"
CONTROLLER = "controller"
COMMUNICATOR = "communicator"


class Actor:
    #: Thread role the run loop registers at spawn (docs/THREADS.md).
    #: Subclasses override — the Communicator's loop is DISPATCH: it
    #: must never block (mvlint pass 9 proves it can't).
    ROLE = thread_roles.ACTOR

    def __init__(self, name: str, zoo) -> None:
        self.name = name
        self._zoo = zoo
        self.mailbox: MtQueue = MtQueue()
        self._handlers: Dict[int, Callable[[Message], None]] = {}
        self._thread: Optional[threading.Thread] = None
        zoo.register_actor(self)

    # -- lifecycle --
    def start(self) -> None:
        self._thread = thread_roles.spawn(
            self.ROLE, target=self._main,
            name=f"mv-{self.name}-r{self._zoo.rank}")

    def stop(self) -> None:
        """Drain-exit: the thread finishes the current message then stops."""
        self.mailbox.exit()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=30)
        self._zoo.deregister_actor(self)

    # -- messaging --
    def receive(self, msg: Message) -> None:
        self.mailbox.push(msg)

    def send_to(self, name: str, msg: Message) -> None:
        self._zoo.send_to(name, msg)

    def register_handler(self, msg_type, fn: Callable[[Message], None]) -> None:
        self._handlers[int(msg_type)] = fn

    # -- main loop (ref: src/actor.cpp:38-50) --
    def _main(self) -> None:
        while True:
            msg = self.mailbox.pop()
            if msg is None:
                break
            self._safe_dispatch(msg)

    def _safe_dispatch(self, msg: Message) -> None:
        """Dispatch one message; an actor must not die silently."""
        try:
            self._dispatch(msg)
        except Exception:  # noqa: BLE001
            log.error("actor %s: handling message type %d raised",
                      self.name, msg.type_int)
            import traceback
            traceback.print_exc()

    def _dispatch(self, msg: Message) -> None:
        handler = self._handlers.get(int(msg.type_int))
        if handler is None:
            log.error("actor %s: unhandled message type %d",
                      self.name, msg.type_int)
            return
        handler(msg)
