"""Worker-side version tracking for table replies.

Copy of the parts of ``multiverso_tpu/tables/client_cache.py`` the slice
needs: ``VersionTracker`` (latest shard version observed per server, fed
from reply stamps) and ``place_rows`` (vectorized reply placement). The
row and snapshot caches (``-max_get_staleness``) are a later item of the
port.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np

from ..util.lock_witness import named_lock

_lock_serial = itertools.count()


def place_rows(keys: np.ndarray, values, req: np.ndarray, out) -> None:
    """Vectorized subset placement: every position of ``req`` whose row
    id appears in ``keys`` receives that id's row of ``values``;
    positions for absent ids are left untouched. Shared by the cache's
    partial-hit fill and the table reply path — ``req`` may repeat ids
    thousands of times (power-of-two padded row sets), so per-position
    Python loops are pathological here."""
    if len(keys) == 0 or len(req) == 0:
        return
    sorter = np.argsort(keys, kind="stable")
    sorted_keys = keys[sorter]
    slot = np.searchsorted(sorted_keys, req)
    slot = np.minimum(slot, sorted_keys.size - 1)
    hit = sorted_keys[slot] == req
    out[hit] = values[sorter[slot[hit]]]


class VersionTracker:
    """Latest table-shard version observed per server id (-1 before any
    observation). Fed by the worker actor from reply version stamps."""

    def __init__(self) -> None:
        self._lock = named_lock(
            f"client_cache.VersionTracker[{next(_lock_serial)}]")
        self._latest: Dict[int, int] = {}  # guarded_by: _lock

    def note(self, server_id: int, version: int) -> None:
        if version < 0:
            return
        with self._lock:
            if version > self._latest.get(server_id, -1):
                self._latest[server_id] = version

    def latest(self, server_id: int) -> int:
        # Under the lock like every other reader: a torn read is not
        # possible for one dict probe, but the freshness math in
        # RowCache._fresh must not see a version OLDER than one a
        # concurrent note() already published to another field.
        with self._lock:
            return self._latest.get(server_id, -1)

    def regressed(self, server_id: int, version: int) -> bool:
        """True when a stamped reply carries a LOWER version than the
        latest observed from that shard. Versions per shard only ever
        grow within one server generation (monotonic counter, FIFO
        reply stream), so a regression means the server RESTARTED and
        reset/restored its counter — the generation-change signal the
        caches invalidate on (docs/CLIENT_CACHE.md)."""
        return 0 <= version < self.latest(server_id)

    def reset(self, server_id: int, version: int) -> None:
        """Re-anchor a shard's latest-observed version downward after a
        server generation change (``note`` only moves it up)."""
        with self._lock:
            self._latest[server_id] = version

    def known_servers(self) -> List[int]:
        with self._lock:
            return list(self._latest)
