"""Worker-side versioned parameter cache (the client cache).

Port of ``multiverso_tpu/tables/client_cache.py``, whole: the version
tracker and reply placement, the row cache of dense matrix tables, the
whole-blob cache of array tables and the snapshot cache of KV tables,
behind ``-max_get_staleness`` and ``-client_cache_rows``. The
reference's workers re-issue a full server roundtrip for every ``Get``
(ref: src/worker.cpp:30-51); this cache serves a Get locally while its
rows are fresh enough.

Versioning model
----------------
* every ``ServerTable`` shard keeps a monotonically increasing
  ``version``, bumped once per successfully applied Add (the server
  actor owns the bump, runtime/server.py);
* Get/Add replies carry the serving shard's version
  (``core.message.VERSION_SLOT``);
* each worker table tracks, per server shard, the LATEST version it has
  observed (``VersionTracker``);
* a cache entry fetched at version ``v`` may serve a Get only while
  ``v >= latest_observed - max_get_staleness``.

``-max_get_staleness=0`` (the default) disables the cache outright:
every Get takes the request path, byte-identical. BSP sync mode
force-disables it regardless of the flag: a locally served Get is a Get
the sync server's vector clocks never count, which would break the
every-i-th-Get-sees-every-i-th-Add contract.

Read-your-writes
----------------
Issuing an Add immediately *blocks* the touched slots (they neither
serve nor accept stores), and the Add's ack — which carries the
post-add version — resolves the block and raises the slots' floor to
the latest observed version: only values fetched at or after the
worker's own write can serve again.

Staleness is measured against the latest version THIS worker has
observed, not the server's true head: a worker that never hears from
the server cannot age its entries. Every real Get refreshes entries and
the tracker, which keeps the two converged in any workload that misses
occasionally; a caller needing a hard recency guarantee sets the bound
to 0 or reads through the tables' uncached device paths.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..util.configure import (define_int, get_flag,
                              register_tunable_hook)
from ..util.dashboard import count
from ..util.lock_witness import named_lock

# Per-INSTANCE witness names: the lock-order graph is keyed by name,
# so two tables' caches sharing one name would hide real cross-table
# cycles and manufacture false ones (same reason mt_queue/waiter/tcp
# use serial/rank names).
_lock_serial = itertools.count()

define_int("max_get_staleness", 0,
           "client-side parameter-cache staleness bound, in server-shard "
           "versions (one version = one applied Add): a cached Get may "
           "serve while its fetch version is within this many versions "
           "of the latest version observed from the owning shard. "
           "0 (default) disables the cache; BSP sync mode force-disables "
           "it (a locally served Get would bypass the vector clocks)")
define_int("client_cache_rows", 65536,
           "row capacity of the matrix client cache (oldest entries "
           "evicted past this; bounds worker memory at rows * num_col * "
           "itemsize)")

#: Dashboard counter names (util/dashboard.py `count`).
HIT = "CLIENT_CACHE_HIT"
MISS = "CLIENT_CACHE_MISS"
JOIN = "CLIENT_CACHE_JOIN"
PREFETCH = "CLIENT_CACHE_PREFETCH"


def staleness_bound() -> int:
    """The active staleness bound; 0 = cache disabled. Read at table
    construction time (matching ``-sparse_compress`` and friends)."""
    if bool(get_flag("sync", False)):
        return 0
    try:
        bound = int(get_flag("max_get_staleness", 0))
    except (TypeError, ValueError):
        return 0
    return max(bound, 0)


def cache_enabled() -> bool:
    return staleness_bound() > 0


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


class RowCache:
    """Row-granular cache for dense matrix worker tables.

    The reference's ``RowCache`` (``multiverso_tpu/tables/client_cache.py``)
    with the same semantics, held per row id in numpy arrays instead of
    dicts, so that a Get, a store or an own add of ~10^5 rows (the
    host-batch PS trainer's) costs a few vectorized passes instead of a
    Python loop a row: the entry's fetch version (-1: none), its
    insertion sequence (eviction takes the oldest first, as the
    reference's insertion-ordered dict does), its slot in a pool of
    ``capacity`` value rows, the read-your-writes floor and the count of
    own adds in flight.

    Every public method is thread-safe: lookups/invalidation run on the
    requester's thread, stores and add-resolution on the worker actor's
    reply thread.
    """

    def __init__(self, bound: int, server_of: Callable, num_servers: int,
                 tracker: VersionTracker,
                 capacity: Optional[int] = None) -> None:
        self._bound = int(bound)
        self._server_of = server_of  # vectorized row ids -> server ids
        self._num_servers = int(num_servers)
        self._tracker = tracker
        self._capacity = int(capacity if capacity is not None  # guarded_by: _lock
                             else get_flag("client_cache_rows"))
        self._lock = named_lock(
            f"client_cache.RowCache[{next(_lock_serial)}]")
        # _bound stays unannotated by choice: the hot read path probes
        # it lock-free (one int) and _retune_bound rebinds it under the
        # lock — a stale read is one Get at the old bound.
        # Per row id, grown to the largest id seen (see the docstring).
        self._version = np.zeros(0, np.int64)  # guarded_by: _lock
        self._seq = np.zeros(0, np.int64)      # guarded_by: _lock
        self._slot = np.zeros(0, np.int64)     # guarded_by: _lock
        self._floor = np.zeros(0, np.int64)    # guarded_by: _lock
        self._pending = np.zeros(0, np.int64)  # guarded_by: _lock
        self._entries = 0                      # guarded_by: _lock
        self._next_seq = 0                     # guarded_by: _lock
        self._pool: Optional[np.ndarray] = None  # guarded_by: _lock
        self._free: List[int] = []             # guarded_by: _lock
        # _floor_all: per-server floor; _pending_all: whole-table
        # own-adds.
        self._floor_all: Dict[int, int] = {}  # guarded_by: _lock
        self._pending_all = 0                 # guarded_by: _lock
        # hits/misses: whole-Get accounting (full-local vs needed the
        # wire); rows_hit/rows_missed: row-granular across both.
        self.hits = 0        # guarded_by: _lock
        self.misses = 0      # guarded_by: _lock
        self.rows_hit = 0    # guarded_by: _lock
        self.rows_missed = 0  # guarded_by: _lock
        #: test hook: fn(row, entry_version, latest_observed, bound),
        #: called under the cache lock for every row actually SERVED.
        self.on_hit = None
        # Live retuning: the bound and capacity were cached above at
        # construction, so a config change must land through these hooks
        # — bound methods held weakly by the registry, so a dropped
        # table unregisters itself. Registered LAST: a change may fire
        # them the instant they register.
        register_tunable_hook("max_get_staleness", self._retune_bound)
        register_tunable_hook("client_cache_rows",
                              self._retune_capacity)

    # -- per-row state (caller holds the lock) --
    def _grow(self, rows: np.ndarray) -> None:
        need = int(rows.max()) + 1 if rows.size else 0
        have = self._version.size
        if need <= have:
            return
        size = max(need, 2 * have)
        pad = size - have

        def grown(a, fill):
            return np.concatenate([a, np.full(pad, fill, np.int64)])
        self._version = grown(self._version, -1)
        self._seq = grown(self._seq, 0)
        self._slot = grown(self._slot, -1)
        self._floor = grown(self._floor, -1)
        self._pending = grown(self._pending, 0)

    def _per_server(self, sids: np.ndarray, table: Callable) -> np.ndarray:
        """``table(sid)`` for each element of ``sids``, one call a
        distinct server."""
        sids = np.asarray(sids, np.int64)
        uniq, inv = np.unique(sids, return_inverse=True)
        return np.asarray([table(int(s)) for s in uniq],
                          np.int64).reshape(-1)[inv] if uniq.size \
            else np.zeros(0, np.int64)

    def _fresh(self, rows: np.ndarray, sids: np.ndarray,
               record: bool = True) -> np.ndarray:
        """Which of the sorted unique ``rows`` may serve now: present,
        no own add in flight, fetched at or past their floors, within the
        bound of the latest version observed from their server."""
        if self._pending_all or not rows.size:
            return np.zeros(rows.size, bool)
        version = self._version[rows]
        latest = self._per_server(sids, self._tracker.latest)
        floor = np.maximum(self._floor[rows], self._per_server(
            sids, lambda s: self._floor_all.get(s, -1)))
        ok = (version >= 0) & (self._pending[rows] == 0) \
            & (version >= floor) & (latest - version <= self._bound)
        if record and self.on_hit is not None:
            for i in np.flatnonzero(ok):
                self.on_hit(int(rows[i]), int(version[i]), int(latest[i]),
                            self._bound)
        return ok

    def _drop(self, rows: np.ndarray) -> None:
        """Remove the entries of ``rows`` (unique), freeing their slots."""
        present = rows[self._version[rows] >= 0]
        if present.size:
            self._free.extend(self._slot[present].tolist())
            self._version[present] = -1
            self._slot[present] = -1
            self._entries -= int(present.size)

    def _clear(self) -> None:
        self._drop(np.flatnonzero(self._version >= 0))

    def _evict_to(self, capacity: int) -> None:
        """Drop the oldest entries until at most ``capacity`` remain."""
        excess = self._entries - capacity
        if excess <= 0:
            return
        present = np.flatnonzero(self._version >= 0)
        oldest = present[np.argsort(self._seq[present], kind="stable")]
        self._drop(oldest[:excess])

    # -- read side --
    def missing_of(self, row_ids: np.ndarray) -> np.ndarray:
        """The sorted unique requested rows that would NOT hit (no
        copies, no counter bumps) — the prefetch planning check; an
        empty result means full coverage."""
        uniq = np.unique(row_ids).astype(np.int64)
        if self._bound <= 0:  # inactive: everything misses
            return uniq.astype(np.int32)
        sids = self._server_of(uniq)
        with self._lock:
            self._grow(uniq)
            ok = self._fresh(uniq, sids, record=False)
        return uniq[~ok].astype(np.int32)

    def fetch_into(self, row_ids: np.ndarray, out: np.ndarray,
                   count_stats: bool = True) -> np.ndarray:
        """Partial-hit fill: copy every fresh row into its requested
        positions (duplicates welcome) and return the sorted unique
        MISSING rows — empty = full local hit. The caller fetches only
        the missing set; its reply placement fills the remaining
        positions. The join-completion re-serve passes
        ``count_stats=False`` so one logical Get contributes exactly one
        hit-or-miss."""
        uniq = np.unique(row_ids).astype(np.int64)
        if self._bound <= 0:
            # Inactive (deactivated mid-flight): everything misses,
            # nothing is counted.
            return uniq.astype(np.int32)
        sids = self._server_of(uniq)
        with self._lock:
            self._grow(uniq)
            ok = self._fresh(uniq, sids, record=count_stats)
            keys = uniq[ok]
            values = self._pool[self._slot[keys]] if keys.size else None
            missing = uniq[~ok]
            if count_stats:
                self.rows_hit += int(keys.size)
                self.rows_missed += int(missing.size)
                if missing.size:
                    self.misses += 1
                else:
                    self.hits += 1
        if count_stats:
            count(MISS if missing.size else HIT)
        if keys.size:
            place_rows(keys, values, row_ids, out)
        return missing.astype(np.int32)

    # -- write side (worker actor reply thread) --
    def store(self, row_ids: np.ndarray, values: np.ndarray,
              version: int, server_id: int) -> None:
        """Record one reply shard's rows at the version it was served.
        Slots blocked by an outstanding own-add, or whose floor exceeds
        the fetch version, are skipped — never silently resurrected. A
        stored row keeps its place in the eviction order if it had an
        entry; a new one goes last; then the oldest go past the
        capacity."""
        if version < 0:  # unstamped legacy peer
            return
        if self._bound <= 0:  # inactive: store nothing
            return
        rows = np.asarray(row_ids, np.int64).reshape(-1)
        values = np.asarray(values)
        with self._lock:
            if self._pending_all:
                return
            if version < self._floor_all.get(int(server_id), -1):
                return
            self._grow(rows)
            ok = (self._pending[rows] == 0) & (version >= self._floor[rows])
            rows, values = rows[ok], values[ok]
            if not rows.size:
                return
            # Replies per server arrive version-ordered, so a passed
            # floor never needs re-checking.
            self._floor[rows] = -1
            # A row stored twice keeps its last value and its first
            # insertion: the rows in first-occurrence order.
            uniq, first = np.unique(rows, return_index=True)
            last = rows.size - 1 - np.unique(rows[::-1],
                                             return_index=True)[1]
            order = np.argsort(first, kind="stable")
            rows, values = uniq[order], values[last[order]]
            is_new = self._version[rows] < 0
            new = rows[is_new]
            self._seq[new] = self._next_seq + np.arange(new.size)
            self._next_seq += int(new.size)
            # Eviction after the insertions, oldest first: the entries
            # there were (overwritten ones keep their place), then the
            # earliest of this store's new rows.
            before = self._entries
            excess = before + new.size - self._capacity
            if excess > 0:
                self._evict_to(before - min(excess, before))
                new = new[max(excess - before, 0):]
            old = rows[~is_new]
            old_values = values[~is_new]
            live = self._version[old] >= 0
            old, old_values = old[live], old_values[live]
            new_values = values[is_new][values[is_new].shape[0]
                                        - new.size:]
            if self._pool is None or self._pool.shape[0] != \
                    self._capacity or self._pool.shape[1:] \
                    != values.shape[1:]:
                self._repool(values.shape[1:], values.dtype)
            if old.size:
                self._pool[self._slot[old]] = old_values
                self._version[old] = version
            if new.size:
                slots = np.asarray([self._free.pop()
                                    for _ in range(new.size)], np.int64)
                self._slot[new] = slots
                self._pool[slots] = new_values
                self._version[new] = version
                self._entries += int(new.size)

    def _repool(self, row_shape, dtype) -> None:
        """A pool of ``capacity`` value rows, the live entries moved in."""
        pool = np.empty((self._capacity,) + tuple(row_shape), dtype)
        present = np.flatnonzero(self._version >= 0)
        if present.size and self._pool is not None:
            pool[:present.size] = self._pool[self._slot[present]]
        self._slot[present] = np.arange(present.size)
        self._free = list(range(self._capacity - 1, present.size - 1, -1))
        self._pool = pool

    # -- own-add self-invalidation --
    def begin_add(self, row_ids: Optional[np.ndarray] = None):
        """Block the slots an own Add is about to dirty (None = whole
        table). Returns a token for ``finish_add``.

        While INACTIVE there are no entries to block, but the ack must
        still FENCE the owning shards' floors: a Get reply served
        before this add could land after a live activation, store the
        pre-add value, and serve it within the widened bound — a
        read-your-writes violation across the activation edge. The
        fence token costs O(owning servers), not O(rows)."""
        if self._bound <= 0:
            if row_ids is None:
                sids = list(range(self._num_servers))
            else:
                rows = np.unique(np.asarray(
                    row_ids, dtype=np.int64).reshape(-1))
                sids = [int(s) for s in np.unique(
                    self._server_of(rows))]
            return ("fence", sids)
        if row_ids is None:
            with self._lock:
                self._pending_all += 1
            return (None, None)
        rows = np.unique(np.asarray(row_ids, dtype=np.int64).reshape(-1))
        sids = np.asarray(self._server_of(rows), np.int64)
        with self._lock:
            self._grow(rows)
            self._pending[rows] += 1
            self._drop(rows)
        return (rows, sids)

    def finish_add(self, token) -> None:
        """Resolve a ``begin_add`` once its ack arrived: unblock the
        slots and raise their floor to the latest observed version (the
        ack was noted before this runs), so only values fetched at-or-
        after the write serve again."""
        if token is None:
            return
        if isinstance(token[0], str):  # ("fence", sids)
            # Inactive-mode ack fence: raise the per-shard floor to the
            # latest version observed at ack; _fresh and store() both
            # honor _floor_all.
            with self._lock:
                for sid in token[1]:
                    self._floor_all[sid] = max(
                        self._floor_all.get(sid, -1),
                        self._tracker.latest(sid))
            return
        rows, sids = token
        with self._lock:
            if rows is None:
                self._pending_all -= 1
                if self._pending_all == 0:
                    self._clear()
                    for sid in range(self._num_servers):
                        self._floor_all[sid] = max(
                            self._floor_all.get(sid, -1),
                            self._tracker.latest(sid))
                return
            self._pending[rows] = np.maximum(self._pending[rows] - 1, 0)
            self._floor[rows] = np.maximum(
                self._floor[rows], self._per_server(sids,
                                                    self._tracker.latest))

    @property
    def bound(self) -> int:
        """The LIVE staleness bound (retunable via the dynamic-flag
        layer)."""
        return self._bound

    @property
    def active(self) -> bool:
        """False while the bound is 0: the cache object exists (so a
        live config change can activate it) but serves nothing and
        stores nothing — the table's ``_live_cache`` treats it exactly
        like the no-cache construction path."""
        return self._bound > 0

    # -- live retuning (dynamic-flag apply hooks) --
    def _retune_bound(self, value) -> None:
        """``-max_get_staleness`` landed live. Widening/narrowing just
        rebinds the freshness check; a FLIP (activation 0 -> n or
        deactivation -> 0) also drops every entry — the cache must
        start from scratch, never from state recorded across the edge.
        Floors are KEPT on a flip: they only ever make serving stricter.
        BSP sync mode keeps its force-disable."""
        if bool(get_flag("sync", False)):
            value = 0
        new = max(int(value), 0)
        with self._lock:
            flipped = (new > 0) != (self._bound > 0)
            self._bound = new
            if flipped:
                self._clear()

    def _retune_capacity(self, value) -> None:
        with self._lock:
            self._capacity = max(int(value), 0)
            self._evict_to(self._capacity)
            if self._pool is not None:
                self._repool(self._pool.shape[1:], self._pool.dtype)

    def versions_of(self, row_ids) -> Dict[int, int]:
        """Fetch version per requested row currently present (rows
        absent — evicted, never fetched, or blocked by a pending
        own-add — are simply omitted)."""
        rows = np.unique(np.asarray(row_ids).reshape(-1)).astype(np.int64)
        with self._lock:
            rows = rows[(rows >= 0) & (rows < self._version.size)]
            version = self._version[rows]
            keep = version >= 0
            return {int(r): int(v) for r, v in zip(rows[keep],
                                                   version[keep])}

    def invalidate_server(self, server_id: int) -> None:
        """Drop every row owned by a shard whose server changed
        generation (restart + snapshot restore): entries and floors
        recorded against the old generation's version counter are
        meaningless against the restored one."""
        sid = int(server_id)
        with self._lock:
            touched = np.flatnonzero((self._version >= 0)
                                     | (self._floor >= 0))
            if touched.size:
                owned = touched[np.asarray(self._server_of(touched))
                                == sid]
                self._drop(owned)
                self._floor[owned] = -1
            self._floor_all.pop(sid, None)

    @property
    def stats(self) -> Dict[str, float]:
        # One consistent cut under the lock: the counters move together
        # in fetch_into, and a rate computed from a half-updated pair
        # can exceed 1.0.
        with self._lock:
            hits, misses = self.hits, self.misses
            rows_hit, rows_missed = self.rows_hit, self.rows_missed
            nrows = self._entries
        total = hits + misses
        rows_total = rows_hit + rows_missed
        return {"hits": hits, "misses": misses,
                "hit_rate": hits / total if total else 0.0,
                "rows_hit": rows_hit,
                "rows_missed": rows_missed,
                "row_hit_rate": rows_hit / rows_total
                if rows_total else 0.0,
                "rows": nrows}


class BlobCache:
    """Whole-shard cache for Array worker tables: one entry per server
    shard; a hit requires EVERY shard fresh (array Gets are whole-table)."""

    def __init__(self, bound: int, num_servers: int,
                 tracker: VersionTracker) -> None:
        self._bound = int(bound)
        self._num_servers = int(num_servers)
        self._tracker = tracker
        self._lock = named_lock(
            f"client_cache.BlobCache[{next(_lock_serial)}]")
        self._shards: Dict[int, Tuple[int, np.ndarray]] = {}  # guarded_by: _lock
        self._floor: Dict[int, int] = {}  # guarded_by: _lock
        self._pending = 0  # guarded_by: _lock
        self.hits = 0  # guarded_by: _lock
        self.misses = 0  # guarded_by: _lock
        self.on_hit = None  # fn(server_id, entry_version, latest, bound)

    def fresh_all(self) -> bool:
        """Counter-free freshness probe (the prefetch planning check —
        hit/miss accounting must reflect Get serving only)."""
        with self._lock:
            if self._pending:
                return False
            for sid in range(self._num_servers):
                ent = self._shards.get(sid)
                if ent is None:
                    return False
                version, _ = ent
                if version < self._floor.get(sid, -1) \
                        or self._tracker.latest(sid) - version \
                        > self._bound:
                    return False
        return True

    def fetch_all(self) -> Optional[Dict[int, np.ndarray]]:
        with self._lock:
            if self._pending:
                out = None
            else:
                out = {}
                for sid in range(self._num_servers):
                    ent = self._shards.get(sid)
                    if ent is None:
                        out = None
                        break
                    version, value = ent
                    if version < self._floor.get(sid, -1):
                        out = None
                        break
                    latest = self._tracker.latest(sid)
                    if latest - version > self._bound:
                        out = None
                        break
                    if self.on_hit is not None:
                        self.on_hit(sid, version, latest, self._bound)
                    out[sid] = value
            if out is None:
                self.misses += 1
            else:
                self.hits += 1
        count(HIT if out is not None else MISS)
        return out

    def store(self, server_id: int, values: np.ndarray,
              version: int) -> None:
        if version < 0:
            return
        with self._lock:
            if self._pending:
                return
            if version < self._floor.get(int(server_id), -1):
                return
            self._floor.pop(int(server_id), None)
            self._shards[int(server_id)] = (version,
                                            np.array(values, copy=True))

    def begin_add(self) -> None:
        with self._lock:
            self._pending += 1
            self._shards.clear()

    def finish_add(self) -> None:
        with self._lock:
            self._pending -= 1
            if self._pending == 0:
                for sid in range(self._num_servers):
                    self._floor[sid] = max(self._floor.get(sid, -1),
                                           self._tracker.latest(sid))

    def invalidate_server(self, server_id: int) -> None:
        """Server generation change: the shard's entry and floor are
        stamped against a counter that no longer exists."""
        with self._lock:
            self._shards.pop(int(server_id), None)
            self._floor.pop(int(server_id), None)


class SnapshotCache:
    """Request-granular snapshot cache for KV worker tables: keyed by
    the exact requested key bytes; an entry records the version of every
    server shard that contributed."""

    def __init__(self, bound: int, tracker: VersionTracker,
                 capacity: int = 256) -> None:
        self._bound = int(bound)
        self._tracker = tracker
        self._capacity = int(capacity)
        self._lock = named_lock(
            f"client_cache.SnapshotCache[{next(_lock_serial)}]")
        self._entries: Dict[bytes, Tuple[Dict[int, int], dict]] = {}  # guarded_by: _lock
        self._floor: Dict[int, int] = {}  # guarded_by: _lock
        self._pending = 0  # guarded_by: _lock
        self.hits = 0  # guarded_by: _lock
        self.misses = 0  # guarded_by: _lock

    def fetch(self, key: bytes, server_ids) -> Optional[dict]:
        with self._lock:
            snap = None
            if not self._pending:
                ent = self._entries.get(key)
                if ent is not None:
                    versions, values = ent
                    ok = True
                    for sid in server_ids:
                        sid = int(sid)
                        v = versions.get(sid)
                        if (v is None or v < self._floor.get(sid, -1)
                                or self._tracker.latest(sid) - v
                                > self._bound):
                            ok = False
                            break
                    if ok:
                        snap = dict(values)
            if snap is None:
                self.misses += 1
            else:
                self.hits += 1
        count(HIT if snap is not None else MISS)
        return snap

    def store(self, key: bytes, versions: Dict[int, int],
              values: dict) -> None:
        with self._lock:
            if self._pending:
                return
            for sid, v in versions.items():
                if v < 0 or v < self._floor.get(int(sid), -1):
                    return
            self._entries[key] = (dict(versions), dict(values))
            while len(self._entries) > self._capacity:
                self._entries.pop(next(iter(self._entries)))

    def begin_add(self) -> None:
        with self._lock:
            self._pending += 1
            self._entries.clear()

    def finish_add(self) -> None:
        with self._lock:
            self._pending -= 1
            if self._pending == 0:
                for sid in self._tracker.known_servers():
                    self._floor[sid] = max(self._floor.get(sid, -1),
                                           self._tracker.latest(sid))

    def invalidate_server(self, server_id: int) -> None:
        """Server generation change: snapshots record multi-shard
        version vectors, so any entry touching the restarted shard is
        stale — clearing all is the simple safe sweep (rare event)."""
        with self._lock:
            self._entries.clear()
            self._floor.pop(int(server_id), None)
