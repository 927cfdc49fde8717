"""Transport layer: abstract NetInterface + in-process fabric.

Port of ``multiverso_tpu/runtime/net.py`` (ref: include/multiverso/
net.h:15-49, src/net.cpp:13-24), cut to what the in-process slice runs:
``LocalFabric``/``LocalNet``, an in-process mesh of mailbox queues where
rank 0 is worker, server and controller at once (the reference's
single-process mode, ref: Test/unittests/multiverso_env.h:9-31).
Messages are delivered whole, and tensors ride inside Blobs by
reference. The fabric also carries the model-average mode's host
collective (``LocalFabric.allreduce``: contributions summed in rank
order), behind each endpoint's collective FIFO. The TCP and
shared-memory transports, and the allreduce engine that runs over them,
are later items of the port (ROADMAP A9).
"""

from __future__ import annotations

from typing import List, Optional

from ..core.message import Message
from ..util.lock_witness import named_condition
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

    def allreduce(self, array: "np.ndarray",
                  slot: Optional[int] = None) -> "np.ndarray":
        """Sum-allreduce a host array across ranks (the transport-level
        collective behind MV_Aggregate, ref: mpi_net.h:147-151), in ma
        mode only: the PS actors must not own the endpoint. The
        reference's default drives its AllreduceEngine over the raw
        send/recv of a transport that leaves the process; the port has
        no such transport yet, and ``LocalNet`` overrides this with the
        fabric's rank-ordered sum.

        FIFO-serialized per endpoint: collectives are matched
        POSITIONALLY across ranks, so execution order must equal call
        order on every rank. Each call runs in turn behind a ticket —
        taken here on the calling thread, or reserved earlier with
        ``reserve_collective_slot`` and passed as ``slot``."""
        if getattr(self, "_recv_owned", False):
            raise RuntimeError(
                "transport-level allreduce (mv.aggregate) requires ma mode "
                "on this transport: the PS actors own the endpoint's recv "
                "stream (start with -ma=true, ref: src/net.cpp:27-35)")
        raise NotImplementedError(
            f"{self.name}.allreduce: the allreduce engine over a "
            f"transport that leaves the process belongs to the "
            f"multi-process runtime, which multiverso_tpu_torch does not "
            f"port yet (ROADMAP A9)")

    def sharded_average(self, array: "np.ndarray",
                        slot: Optional[int] = None) -> "np.ndarray":
        """Cross-rank MEAN with sharded reduce state (the reference's
        AllreduceEngine.sharded_average). Same ma-mode contract and
        per-endpoint FIFO ticketing as ``allreduce``; ``LocalNet``
        overrides it."""
        if getattr(self, "_recv_owned", False):
            raise RuntimeError(
                "transport-level sharded_average requires ma mode on "
                "this transport: the PS actors own the endpoint's recv "
                "stream (start with -ma=true, ref: src/net.cpp:27-35)")
        raise NotImplementedError(
            f"{self.name}.sharded_average: the allreduce engine belongs "
            f"to the multi-process runtime, which multiverso_tpu_torch "
            f"does not port yet (ROADMAP A9)")

    # -- per-endpoint collective FIFO --
    def _collective_fifo(self) -> dict:
        # Lazily created; the instance-dict setdefault is atomic under
        # the GIL. The fast-path get avoids building a throwaway
        # dict + Condition per call once initialized.
        state = self.__dict__.get("_coll_fifo")
        if state is None:
            state = self.__dict__.setdefault(
                "_coll_fifo",
                {"next": 0, "serving": 0,
                 "cond": named_condition(f"{self.name}.collective_fifo")})
        return state

    def reserve_collective_slot(self) -> int:
        """Take the next FIFO ticket on THIS thread. Pass it to a later
        ``allreduce(..., slot=...)`` call (possibly from another
        thread) to run that collective in the order the slot was
        reserved rather than the order workers get scheduled."""
        state = self._collective_fifo()
        with state["cond"]:
            slot = state["next"]
            state["next"] += 1
        return slot

    def _run_collective(self, fn, slot: Optional[int] = None):
        state = self._collective_fifo()
        if slot is None:
            slot = self.reserve_collective_slot()
        with state["cond"]:
            state["cond"].wait_for(lambda: state["serving"] == slot)
        try:
            return fn()
        finally:
            with state["cond"]:
                state["serving"] += 1
                state["cond"].notify_all()

    @property
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
        # Shared-memory allreduce state (one in-flight collective at a
        # time, like the reference's serialized MPI_Allreduce).
        self._ar_cond = named_condition("fabric.allreduce")
        self._ar_parts = {}  # rank -> contribution for the open collective
        self._ar_result = None
        self._ar_generation = 0

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

    def allreduce(self, array, rank: int = -1) -> "np.ndarray":
        import numpy as np
        contribution = np.asarray(array)
        with self._ar_cond:
            generation = self._ar_generation
            # Contributions are kept per rank and summed in RANK order at
            # completion: summing in thread-arrival order would make the
            # float result depend on scheduling, and the MA overlap tests
            # assert sync-vs-async trainer runs are bit-identical.
            self._ar_parts[len(self._ar_parts) if rank < 0 else rank] = \
                contribution
            if len(self._ar_parts) == self._size:
                acc = None
                for r in sorted(self._ar_parts):
                    part = self._ar_parts[r]
                    acc = part.copy() if acc is None else acc + part
                self._ar_result = acc
                self._ar_parts = {}
                self._ar_generation += 1
                self._ar_cond.notify_all()
            else:
                if not self._ar_cond.wait_for(
                        lambda: self._ar_generation > generation,
                        timeout=120):
                    raise TimeoutError(
                        "allreduce: peers never joined the collective")
            # Per-rank copy: a caller mutating its result in place must
            # not corrupt what sibling ranks see.
            return self._ar_result.copy()


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

    def allreduce(self, array, slot=None):
        return self._run_collective(
            lambda: self._fabric.allreduce(array, self._rank), slot)

    def sharded_average(self, array, slot=None):
        # Shared memory has no wire to save and no per-rank memory
        # budget to shard (every virtual rank is one process): the
        # native rank-ordered fabric sum + divide is the same
        # deterministic math with none of the frame round trips.
        return self._run_collective(
            lambda: self._fabric.allreduce(array, self._rank)
            / self.size, slot)
