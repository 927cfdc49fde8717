"""In-process virtual cluster: several ranks, one thread and one Zoo each.

Port of ``multiverso_tpu/runtime/cluster.py``. The reference tests
distributed behavior by launching ``mpirun -np 4`` (ref: deploy/docker/
Dockerfile:100-110); here each virtual rank is a thread over a shared
``LocalFabric`` — the same actor stack, registration and barrier
protocol, no transport. Every rank's tables live on ``device``, the one
card by default, so a table of several servers keeps all its shards on
it and the device-key data plane (tensors in requests and replies) stays
valid across ranks.

The reference enables its process-wide device lock while several ranks
run (XLA's CPU runtime can wedge on concurrent multi-device programs);
the port needs none: every rank thread launches onto the same CUDA
stream (``runtime/device_lock.py``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from . import thread_roles
from .net import LocalFabric
from .zoo import ClusterAborted, Zoo, set_thread_zoo


class LocalCluster:
    """Run ``fn(rank)`` on ``n`` virtual ranks, each with its own Zoo."""

    def __init__(self, n: int, argv: Optional[List[str]] = None,
                 roles: Optional[List[str]] = None,
                 nets: Optional[List[Any]] = None, device=None):
        """``roles`` optionally gives one -ps_role value per rank (the flag
        registry is process-global, so heterogeneous roles are passed here
        instead of via argv). ``nets`` optionally gives one pre-built
        in-process ``NetInterface`` per rank. ``device`` is every rank's
        table device (``Zoo.start``): ``cuda:0`` unless the caller asks
        for another (``device="cpu"``)."""
        self.n = n
        self.argv = list(argv or [])
        if roles is not None and len(roles) != n:
            raise ValueError("roles must have one entry per rank")
        if nets is not None and len(nets) != n:
            raise ValueError("nets must have one entry per rank")
        self.roles = roles
        self.nets = nets
        self.device = device
        self.timeout = 120.0

    def run(self, fn: Callable[[int], Any]) -> List[Any]:
        """``fn(rank)`` on every rank; the list of their results. A rank
        that raises aborts every sibling (their blocked barriers and
        waits raise ClusterAborted) and its error — not a sibling's
        ClusterAborted — is raised here; ranks still alive after
        ``timeout`` seconds raise TimeoutError."""
        if self.nets is not None:
            endpoints = list(self.nets)
        else:
            fabric = LocalFabric(self.n)
            endpoints = [fabric.endpoint(r) for r in range(self.n)]
        results: List[Any] = [None] * self.n
        errors: List[Optional[BaseException]] = [None] * self.n
        zoos: List[Optional[Zoo]] = [None] * self.n

        def abort_all() -> None:
            for z in zoos:
                if z is not None:
                    z.abort()

        def rank_main(rank: int) -> None:
            zoo = Zoo()
            zoos[rank] = zoo
            set_thread_zoo(zoo)
            started = False
            try:
                zoo.start(list(self.argv), net=endpoints[rank],
                          device=self.device,
                          role=self.roles[rank] if self.roles else None)
                started = True
                results[rank] = fn(rank)
            except BaseException as exc:  # noqa: BLE001 - reported to caller
                errors[rank] = exc
                # Unblock every sibling barrier/wait — a failed rank would
                # otherwise mispair barriers and hang the whole cluster.
                abort_all()
            finally:
                try:
                    if started:
                        zoo.stop()
                except BaseException as exc:  # noqa: BLE001
                    if errors[rank] is None:
                        errors[rank] = exc
                finally:
                    set_thread_zoo(None)

        threads = [thread_roles.spawn(thread_roles.BACKGROUND,
                                      target=rank_main, args=(r,),
                                      name=f"mv-rank-{r}")
                   for r in range(self.n)]
        hung = []
        for t in threads:
            t.join(timeout=self.timeout)
            if t.is_alive():
                hung.append(t.name)
        # Report a primary error over collateral ClusterAborted fallout.
        primary = [e for e in errors
                   if e is not None and not isinstance(e, ClusterAborted)]
        if primary:
            raise primary[0]
        for exc in errors:
            if exc is not None:
                raise exc
        if hung:
            abort_all()
            raise TimeoutError(f"virtual rank threads hung: {hung}")
        return results
