"""Blocking multi-producer/multi-consumer queue with explicit exit.

TPU-native equivalent of the reference's ``MtQueue``
(ref: include/multiverso/util/mt_queue.h:19-147). ``pop`` blocks until an
item arrives or ``exit()`` is called; after exit, ``pop``/``try_pop`` return
``None``/False immediately. Built on a deque + condition variable, like the
reference's mutex+condvar design.
"""

from __future__ import annotations

import collections
import itertools
from typing import (Callable, Deque, Generic, List, Optional, Tuple,
                    TypeVar)

from .configure import get_flag
from .dashboard import samples
from .lock_witness import monotonic, named_condition, named_lock

T = TypeVar("T")

_serial = itertools.count()


def depth_sampling_enabled() -> bool:
    """Whether actor mailboxes should pay the per-push depth SAMPLE
    (reservoir lock + append per message on hot paths): only when
    something actually consumes the samples — the serving tier's
    pressure surface (-serving_port) or the metrics exporter
    (-metrics_interval_s). The high watermark alone is one compare and
    stays tracked unconditionally. Read at actor construction, after
    flag parsing (the -sparse_compress precedent)."""
    return (int(get_flag("serving_port", 0)) > 0
            or float(get_flag("metrics_interval_s", 0.0)) > 0)


class MtQueue(Generic[T]):
    def __init__(self, name: str = "") -> None:
        name = name or f"mt_queue[{next(_serial)}]"
        self._mutex = named_lock(name)
        self._cond = named_condition(f"{name}.cond", self._mutex)
        # _cond shares _mutex, so holding either satisfies the guard
        # (the mvlint guarded-by alias group).
        self._buffer: Deque[T] = collections.deque()  # guarded_by: _mutex
        self._exit = False  # guarded_by: _mutex
        # Depth observability (docs/SERVING.md admission control +
        # bench mailbox-pressure reporting): the high watermark is
        # always tracked (one compare per push); per-push depth
        # SAMPLES (p50/p99 via util/dashboard.py Samples) only when a
        # metric name was opted in via track_depth — the reservoir's
        # lock + append per push is real cost on a hot mailbox.
        self._depth_high = 0  # guarded_by: _mutex
        # Set once by track_depth before any producer thread runs;
        # read lock-free per push on purpose.
        self._depth_metric: Optional[str] = None

    def track_depth(self, metric_name: str) -> None:
        """Record every post-push depth into the named Dashboard
        ``Samples`` reservoir (``MAILBOX_DEPTH[*]`` family). The server
        and worker actors opt their mailboxes in: admission-control
        decisions and the serving bench both read mailbox pressure."""
        self._depth_metric = metric_name

    def push(self, item: T) -> None:
        with self._cond:
            self._buffer.append(item)
            depth = len(self._buffer)
            if depth > self._depth_high:
                self._depth_high = depth
            self._cond.notify()
        if self._depth_metric is not None:
            # Outside the queue lock: the reservoir has its own, and a
            # sampler must never extend this queue's critical section.
            # Re-resolved per push (not cached) so a bench-phase
            # reset_samples() cannot orphan the writer (the
            # dashboard.monitor re-resolve precedent).
            samples(self._depth_metric).add(depth)

    @property
    def depth_high_watermark(self) -> int:
        """Deepest the queue has ever been (monotonic; cheap enough to
        track unconditionally)."""
        with self._mutex:
            return self._depth_high

    def reset_depth_watermark(self) -> None:
        """Re-anchor the watermark at the current depth (bench windows
        measure per-phase pressure, not lifetime)."""
        with self._mutex:
            self._depth_high = len(self._buffer)

    def pop(self, timeout: Optional[float] = None) -> Optional[T]:
        """Block until an item is available; None once exited (or timeout)."""
        deadline = None if timeout is None else monotonic() + timeout
        with self._cond:
            while not self._buffer and not self._exit:
                remaining = None if deadline is None \
                    else deadline - monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                if not self._cond.wait(timeout=remaining):
                    return None
            if self._buffer:
                return self._buffer.popleft()
            return None

    def pop_batch(self, max_items: int = 64,
                  max_bytes: Optional[int] = None,
                  size_of: Optional[Callable[[T], int]] = None,
                  timeout: Optional[float] = None) -> List[T]:
        """Bounded atomic drain (server request fusion,
        docs/SERVER_ENGINE.md): block like ``pop`` for the FIRST item,
        then take whatever else is already queued — no further waiting
        — up to ``max_items`` and, when ``size_of`` is given, up to
        ``max_bytes`` of summed item size. The first item is always
        taken regardless of its size (the one-message fallback: an
        oversized request must still make progress), so the byte cap
        bounds the batch TAIL, not a single message. Returns ``[]``
        only on exit/timeout.

        Depth semantics match ``pop``: the high watermark is a
        push-side property and is untouched here, and ``track_depth``
        sampling stays push-only — a drain never writes the reservoir.
        """
        max_items = max(int(max_items), 1)
        deadline = None if timeout is None else monotonic() + timeout
        with self._cond:
            while not self._buffer and not self._exit:
                remaining = None if deadline is None \
                    else deadline - monotonic()
                if remaining is not None and remaining <= 0:
                    return []
                if not self._cond.wait(timeout=remaining):
                    return []
            if not self._buffer:
                return []
            batch: List[T] = [self._buffer.popleft()]
            budget = None
            if max_bytes is not None and size_of is not None:
                budget = max(int(max_bytes), 0) - size_of(batch[0])
            while self._buffer and len(batch) < max_items:
                if budget is not None:
                    nxt = size_of(self._buffer[0])
                    if budget - nxt < 0:
                        break
                    budget -= nxt
                batch.append(self._buffer.popleft())
            return batch

    def try_pop(self) -> Tuple[bool, Optional[T]]:
        with self._mutex:
            if self._buffer:
                return True, self._buffer.popleft()
            return False, None

    def front(self) -> Optional[T]:
        """Block until an item is available and peek it without removing."""
        with self._cond:
            while not self._buffer and not self._exit:
                self._cond.wait()
            return self._buffer[0] if self._buffer else None

    def empty(self) -> bool:
        with self._mutex:
            return not self._buffer

    def size(self) -> int:
        with self._mutex:
            return len(self._buffer)

    def exit(self) -> None:
        with self._cond:
            self._exit = True
            self._cond.notify_all()

    @property
    def alive(self) -> bool:
        with self._mutex:
            return not self._exit
