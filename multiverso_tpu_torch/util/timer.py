"""Millisecond stopwatch (ref: include/multiverso/util/timer.h:9-24)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self._start = time.perf_counter()

    def start(self) -> None:
        self._start = time.perf_counter()

    def elapse(self) -> float:
        """Elapsed milliseconds since construction or last start()."""
        return (time.perf_counter() - self._start) * 1e3
