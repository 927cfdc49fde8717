"""Transport layer: abstract NetInterface + in-process fabric.

Port of ``multiverso_tpu/runtime/net.py`` (ref: include/multiverso/
net.h:15-49, src/net.cpp:13-24), cut to what the in-process slice runs:
``LocalFabric``/``LocalNet``, an in-process mesh of mailbox queues where
rank 0 is worker, server and controller at once (the reference's
single-process mode, ref: Test/unittests/multiverso_env.h:9-31).
Messages are delivered whole, and tensors ride inside Blobs by
reference. The TCP and shared-memory transports and the collectives
are later items of the port.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.message import Message
from ..util.mt_queue import MtQueue


class PeerLostError(RuntimeError):
    """A peer endpoint died while the mesh was supposed to be up
    (raised to table ``wait`` calls whose request was in flight toward
    it). Retryable in the reference; the in-process fabric never loses
    a peer, but table code still names the type."""


class NetInterface:
    """Abstract transport (ref: include/multiverso/net.h:15-49)."""

    #: True when every rank shares this OS process (messages pass by
    #: reference, so Blob payloads — tensors included — arrive
    #: zero-copy).
    in_process = False

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    def send(self, msg: Message) -> int:
        """Dispatch a message toward ``msg.dst``; returns bytes queued."""
        raise NotImplementedError

    def send_async(self, msg: Message) -> int:
        """Queue a message for delivery and return immediately (the
        in-process fabric's send is already instantaneous)."""
        return self.send(msg)

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Block for the next inbound message; None once finalized."""
        raise NotImplementedError

    def finalize(self) -> None:
        raise NotImplementedError

    def interrupt_recv(self) -> None:
        """Make one pending/future ``recv`` return None without tearing
        the endpoint down (used for non-finalizing shutdown)."""
        self.finalize()

    def acquire_recv_owner(self) -> None:
        """Mark this endpoint as drained by the communicator's recv
        thread."""
        self._recv_owned = True

    def release_recv_owner(self) -> None:
        self._recv_owned = False

    def name(self) -> str:
        return type(self).__name__


_RECV_INTERRUPT = object()  # sentinel: unblocks recv without finalizing


class LocalFabric:
    """Shared in-process wire: one inbox queue per virtual rank."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError("fabric needs >= 1 rank")
        self._size = size
        self._inboxes: List[MtQueue] = [
            MtQueue(name=f"fabric.inbox[{r}]") for r in range(size)]

    @property
    def size(self) -> int:
        return self._size

    def endpoint(self, rank: int) -> "LocalNet":
        if not 0 <= rank < self._size:
            raise ValueError(f"rank {rank} out of range [0,{self._size})")
        return LocalNet(self, rank)

    def deliver(self, msg: Message) -> None:
        self._inboxes[msg.dst].push(msg)

    def inbox(self, rank: int) -> MtQueue:
        return self._inboxes[rank]


class LocalNet(NetInterface):
    in_process = True

    def __init__(self, fabric: LocalFabric, rank: int):
        self._fabric = fabric
        self._rank = rank

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._fabric.size

    def send(self, msg: Message) -> int:
        if not 0 <= msg.dst < self.size:
            raise ValueError(f"bad dst rank {msg.dst}")
        self._fabric.deliver(msg)
        return sum(b.size for b in msg.data) + 32

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        item = self._fabric.inbox(self._rank).pop(timeout=timeout)
        if item is _RECV_INTERRUPT:
            return None
        return item

    def finalize(self) -> None:
        self._fabric.inbox(self._rank).exit()

    def interrupt_recv(self) -> None:
        self._fabric.inbox(self._rank).push(_RECV_INTERRUPT)
