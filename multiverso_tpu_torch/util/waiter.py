"""Countdown latch used by async table requests.

TPU-native equivalent of the reference's ``Waiter``
(ref: include/multiverso/util/waiter.h:9-33): ``wait()`` blocks until
``notify()`` has been called ``num_wait`` times; ``reset(n)`` re-arms.
"""

from __future__ import annotations

import itertools

from .lock_witness import monotonic, named_condition, named_lock

_serial = itertools.count()


class Waiter:
    def __init__(self, num_wait: int = 1, name: str = ""):
        name = name or f"waiter[{next(_serial)}]"
        self._mutex = named_lock(name)
        self._cond = named_condition(f"{name}.cond", self._mutex)
        self._num_wait = num_wait

    def wait(self, timeout=None) -> bool:
        deadline = None if timeout is None else monotonic() + timeout
        with self._cond:
            while self._num_wait > 0:
                remaining = None if deadline is None \
                    else deadline - monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                if not self._cond.wait(timeout=remaining):
                    return False
            return True

    def notify(self) -> None:
        with self._cond:
            self._num_wait -= 1
            if self._num_wait <= 0:
                self._cond.notify_all()

    def add_waits(self, k: int) -> None:
        """Raise the pending count by ``k`` — the replica-repair path:
        one shard reply is being REPLACED by ``k+1`` follow-up shards
        (the worker actor suppresses that reply's notify and sends the
        follow-ups), so the waiter must expect the extras. Only valid
        while at least one notify is still outstanding and only from
        the thread that would have delivered it (the worker actor):
        a completed waiter must never be re-armed this way."""
        with self._cond:
            if self._num_wait <= 0:
                # Completed (an abort's release raced the repair):
                # re-arming would strand the releaser — drop the
                # extension; the repair replies land as no-ops.
                return
            self._num_wait += k

    def release(self) -> None:
        """Force-complete: wake every waiter regardless of pending count
        (abort path — the caller records why)."""
        with self._cond:
            self._num_wait = 0
            self._cond.notify_all()

    @property
    def done(self) -> bool:
        with self._mutex:
            return self._num_wait <= 0

    @property
    def pending(self) -> int:
        """Outstanding notifies (diagnostic: how many shard replies a
        timed-out request was still missing)."""
        with self._mutex:
            return max(self._num_wait, 0)

    def reset(self, num_wait: int) -> None:
        with self._cond:
            self._num_wait = num_wait
            if self._num_wait <= 0:
                # Re-arming to zero must release anyone already blocked
                # (e.g. a request whose partition produced no shards).
                self._cond.notify_all()
