"""Named performance counters (tracing/profiling subsystem).

Port of the reference's ``Dashboard``/``Monitor``
(ref: include/multiverso/dashboard.h:16-74, src/dashboard.cpp:14-49): global
registry of named monitors, each accumulating call count and elapsed ms;
``Dashboard.display()`` dumps all. The MONITOR_BEGIN/END macro pair becomes a
context manager (``with monitor("name"):``); ``trace=True`` layers a
``torch.profiler.record_function`` range (which also emits an NVTX range
when the CUDA profiler's NVTX capture is on) so monitored regions show up
in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from .lock_witness import named_lock

#: CANONICAL METRIC-NAME REGISTRY — the one name-and-meaning table for
#: every ``monitor("X")`` / ``samples("X")`` / ``count("X")`` literal
#: in the tree. ``tools/mvlint``'s metric-name pass parses this literal
#: (never imports) and fails CI on any call site naming an unlisted
#: metric, and cross-checks the table against the metric table in
#: ``docs/OBSERVABILITY.md`` in both directions. A trailing ``*``
#: matches a per-destination / per-table FAMILY suffix
#: (``DISPATCH_MS[d*]`` covers ``DISPATCH_MS[d0]``, ``DISPATCH_MS[d7]``,
#: ...). Keep the literal plain (no computed values).
METRIC_NAMES: Dict[str, str] = {
    # -- worker actor / table layer --
    "WORKER_PROCESS_GET": "worker actor Get partition+send handling",
    "WORKER_PROCESS_ADD": "worker actor Add partition+send handling",
    "WORKER_COALESCE_FLUSH": "coalesced BatchAdd flushes packed",
    "WORKER_TABLE_SYNC_GET": "blocking table get_raw issue-to-reply",
    "WORKER_TABLE_SYNC_ADD": "blocking table add_raw issue-to-ack",
    # -- server actor --
    "SERVER_PROCESS_GET": "server-side Get table op + reply",
    "SERVER_PROCESS_ADD": "server-side Add apply + ack",
    "SERVER_PROCESS_BATCH_ADD": "server-side coalesced batch apply",
    # -- server request fusion (runtime/fusion.py; docs/SERVER_ENGINE.md) --
    "SERVER_FUSE_BATCH": "fused mailbox batch sizes (messages drained "
                         "per dispatch; sampled only when > 1)",
    "SERVER_DEVICE_DISPATCHES": "device programs dispatched by server "
                                "table ops (serial + fused paths)",
    "SERVER_FUSE_DEDUP_ROWS": "cross-request duplicate rows gathered "
                              "once by a fused Get",
    # -- model / collective stalls --
    "PS_GET_STALL": "trainer blocked on a parameter Get (prefetch miss)",
    "PS_BLOCK_IDS": "PS device trainer: one block's draws + ids (host "
                    "time to launch them)",
    "PS_STEP": "PS device trainer: one block's SGNS step launch",
    "PS_PUSH": "PS device trainer: one block's two delta pushes "
               "issued",
    "PS_EPOCH_PREP": "PS device trainer: epoch prologue (draws, "
                     "subsample + compaction, the n_kept read)",
    "PS_EPOCH_DRAIN": "PS device trainer: epoch epilogue (push drain, "
                      "word-count flush, barrier)",
    "MA_COMM_STALL": "model-average blocked on the collective",
    # -- sparse collective tier (runtime/allreduce_engine.py) --
    "SPARSE_FILL[*]": "sparse collective fill-in: union density per "
                      "merge hop ([reduce]) and probed input density "
                      "([input])",
    # -- snapshotter --
    "SNAPSHOT_CAPTURE": "consistent state cut under the table lock",
    "SNAPSHOT_WRITE": "snapshot serialize+write off the lock",
    # -- wire transport --
    "tcp_serialize": "message -> wire frame serialize",
    "tcp_send": "blocking socket send of one frame",
    "tcp_recv": "socket read of one inbound frame body",
    "tcp_deserialize": "wire frame -> message parse",
    # -- zero-copy wire path (runtime/tcp.py, util/buffer_pool.py;
    #    docs/MEMORY.md) --
    "WIRE_BYTES_COPIED": "payload+framing bytes memcpy'd by "
                         "serialize/deserialize (the zero-copy "
                         "bench signal)",
    "WIRE_PAYLOAD_BYTES": "payload bytes that crossed "
                          "serialize/deserialize (the copy-ratio "
                          "denominator)",
    "POOL_HIT": "receive-frame leases served from the buffer pool",
    "POOL_MISS": "receive-frame leases that allocated fresh",
    "POOL_RESIDENT_KB": "buffer-pool retained free bytes (KB) at "
                        "each return",
    # -- shared-memory transport (runtime/shm.py; docs/MEMORY.md
    #    "Below the socket") --
    "shm_send": "ring-slot copy of one outbound frame (the shm data "
                "path's single copy)",
    "shm_recv": "in-place parse (or chunk reassembly) of one "
                "ring-borne frame",
    "SHM_FRAMES": "frames sent through shm rings",
    "SHM_BYTES": "frame bytes sent through shm rings",
    "SHM_RING_FULL_WAITS": "ring-full backpressure episodes on shm "
                           "writer threads (slow-reader signal)",
    "SHM_CHUNKED_FRAMES": "frames larger than one ring slot, streamed "
                          "as CONT chunks",
    "SHM_BYTES_COPIED": "bytes copied out of ring slots reassembling "
                        "chunked frames (single-slot frames parse in "
                        "place and count nothing here)",
    "SHM_SLOT_PARKED": "ring slots parked because a Blob view "
                       "outlived its message (freed on re-probe)",
    "SHM_PIN_COPIES": "frames copied off the ring because consumer-"
                      "held frames pinned half the slots (the anti-"
                      "deadlock pressure valve)",
    # -- client cache (tables/client_cache.py) --
    "CLIENT_CACHE_HIT": "cache lookups served locally",
    "CLIENT_CACHE_MISS": "cache lookups that crossed the wire",
    "CLIENT_CACHE_JOIN": "gets joined onto an in-flight prefetch",
    "CLIENT_CACHE_PREFETCH": "prefetch requests issued",
    # -- hot-shard replication (runtime/replica.py) --
    "REPLICA_HIT": "rows served from a replica store",
    "REPLICA_MISS": "replicated rows a holder could not serve",
    "REPLICA_REPAIR": "repair requests issued to row owners",
    "REPLICA_STALE": "replica groups rejected below a RYW floor",
    "REPLICA_SYNC": "write-through refreshes fanned out",
    # -- elastic resharding + chaos harness (runtime/shard_map.py,
    #    util/chaos.py; docs/SHARDING.md) --
    "SHARD_MIGRATE_ROWS": "rows/buckets streamed between servers by "
                          "live migrations",
    "SHARD_FWD": "requests routed through a dual-read/forwarding "
                 "window",
    "SHARD_RETRANSMIT": "migration chunks re-sent after a detected "
                        "seq gap",
    "CHAOS_DROPPED": "frames dropped by the -chaos_frames harness",
    "CHAOS_DELAYED": "frames delayed by the -chaos_frames harness",
    # -- event-loop transport core (runtime/tcp.py; docs/THREADS.md) --
    "DISPATCH_MS[d*]": "per-destination submit-to-wire-complete "
                       "latency (ms) on the event loop",
    "DISPATCH_QUEUE_DEPTH[d*]": "per-destination outbound frame-queue "
                                "depth at submit",
    "EVENTLOOP_TICK_MS": "event-loop tick duration (ms): one "
                         "select-wake's worth of handler+timer work",
    "EVENTLOOP_READY_FDS": "fds reported ready per selector wake",
    "NET_PEER_STATE[*]": "peer state-machine transitions entered "
                         "(CONNECTING/HANDSHAKE/READY/DRAINING/DEAD)",
    "TRANSPORT_THREADS": "live transport threads per rank (EVENTLOOP "
                         "+ shm WRITER); the O(1)-in-peers invariant",
    # -- observability export (runtime/metrics.py) --
    "METRICS_REPORT": "per-rank metrics snapshots shipped",
    "METRICS_DROPPED_STALE": "out-of-order/stale rank reports the "
                             "controller aggregation dropped",
    # -- closed-loop self-tuning (runtime/autotune.py) --
    "AUTOTUNE_DECISION": "knob changes broadcast by the autotune "
                         "controller",
    # -- actor mailboxes (util/mt_queue.py track_depth) --
    "MAILBOX_DEPTH[*]": "actor mailbox depth at each push",
    # -- thread-role blocking watchdog (runtime/thread_roles.py;
    #    docs/THREADS.md) --
    "ROLE_BLOCKED_MS[*]": "wall-clock ms a DISPATCH/LIVENESS/"
                          "EVENTLOOP thread sat blocked past "
                          "-role_block_budget_ms (per role, "
                          "-debug_locks watchdog)",
    # -- online serving tier (serving/; docs/SERVING.md) --
    "SERVING_REQUESTS": "serving-frontend requests admitted and served",
    "SERVING_SHED": "serving-frontend requests rejected by admission",
    "SERVING_LATENCY_MS": "serving-frontend request latency (ms)",
    "SERVING_BATCH_SIZE": "requests folded into one serving read batch",
    "SERVING_CACHE_HIT": "requests served whole from the hot-response "
                         "cache",
    "ANN_PROBE_MS": "IVF neighbors probe latency (ms)",
}

#: Version stamp on serialized metrics snapshots
#: (``metrics_snapshot()``): consumers reject a snapshot whose version
#: they do not understand instead of mis-merging it.
#: Family matching against the registry (trailing-``*`` entries) lives
#: in ``tools/mvlint/metric_lint.py family_match`` — the one
#: implementation, used by the lint that enforces this registry.
METRICS_SNAPSHOT_VERSION = 1


class Monitor:
    def __init__(self, name: str):
        self.name = name
        self._count = 0
        self._elapsed_ms = 0.0
        self._local = threading.local()  # per-thread begin time
        self._lock = named_lock(f"dashboard.monitor[{name}]")

    def begin(self) -> None:
        self._local.begin = time.perf_counter()

    def end(self) -> None:
        begin = getattr(self._local, "begin", None)
        if begin is None:
            return
        elapsed = (time.perf_counter() - begin) * 1e3
        with self._lock:
            self._count += 1
            self._elapsed_ms += elapsed
        self._local.begin = None

    def add(self, elapsed_ms: float) -> None:
        with self._lock:
            self._count += 1
            self._elapsed_ms += elapsed_ms

    def add_count(self, n: int) -> None:
        """Bulk count bump with no elapsed time (row-granular event
        counters — replica hit/miss rows per reply)."""
        with self._lock:
            self._count += n

    @property
    def count(self) -> int:
        return self._count

    @property
    def elapse(self) -> float:
        return self._elapsed_ms

    @property
    def average(self) -> float:
        return self._elapsed_ms / self._count if self._count else 0.0

    def __str__(self) -> str:
        return (f"[{self.name}] count = {self._count} "
                f"elapse = {self._elapsed_ms:.2f}ms "
                f"average = {self.average:.3f}ms")


class Dashboard:
    _monitors: Dict[str, Monitor] = {}
    # Module-level singleton: witnessed only when -debug_locks was set
    # before the first dashboard import (util/lock_witness.py).
    _lock = named_lock("dashboard.registry")

    @classmethod
    def get(cls, name: str) -> Monitor:
        with cls._lock:
            mon = cls._monitors.get(name)
            if mon is None:
                mon = Monitor(name)
                cls._monitors[name] = mon
            return mon

    @classmethod
    def add_monitor(cls, monitor: Monitor) -> None:
        with cls._lock:
            cls._monitors[monitor.name] = monitor

    @classmethod
    def watch(cls, name: str) -> str:
        with cls._lock:
            mon = cls._monitors.get(name)
            return str(mon) if mon else f"[{name}] <unregistered>"

    @classmethod
    def display(cls) -> str:
        """Full registry report: monitors AND sample reservoirs, each
        section sorted by name so successive dumps diff cleanly (dict
        insertion order made the report depend on which code path ran
        first)."""
        with cls._lock:
            lines = [str(m) for _, m in sorted(cls._monitors.items())]
        with _samples_lock:
            reservoirs = sorted(_samples.items())
        for name, s in reservoirs:
            snap = s.snapshot()
            if snap.get("count"):
                lines.append(
                    f"[{name}] count = {snap['count']} "
                    f"p50 = {snap.get('p50', 0.0):.3f} "
                    f"p90 = {snap.get('p90', 0.0):.3f} "
                    f"p99 = {snap.get('p99', 0.0):.3f} "
                    f"max = {snap.get('max', 0.0):.3f}")
        return "\n".join(lines)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._monitors.clear()


class monitor:
    """Context manager replacing MONITOR_BEGIN/END macro pair.

    With ``trace=True`` also opens a ``torch.profiler.record_function``
    range so the region is visible in a ``torch.profiler`` trace.
    """

    def __init__(self, name: str, trace: bool = False):
        self._name = name
        self._monitor: Optional[Monitor] = None
        self._trace_ctx = None
        if trace:
            import torch.profiler
            self._trace_ctx = torch.profiler.record_function(name)

    def __enter__(self) -> Monitor:
        if self._trace_ctx is not None:
            self._trace_ctx.__enter__()
        # Re-resolved per entry, NOT cached at construction: a
        # ``Dashboard.reset()`` (every bench phase does one) replaces
        # the registry, and a long-lived ``monitor(...)`` instance
        # caching its Monitor would keep writing to an unregistered
        # orphan that no display()/snapshot ever sees.
        self._monitor = Dashboard.get(self._name)
        self._monitor.begin()
        return self._monitor

    def __exit__(self, *exc) -> None:
        if self._monitor is not None:
            self._monitor.end()
        if self._trace_ctx is not None:
            self._trace_ctx.__exit__(*exc)
        return None


class Samples:
    """Bounded reservoir of per-op scalar samples (latencies, queue
    depths) with percentile readout — the p50/p99 companion to the
    cumulative ``Monitor``. Ring-buffer overwrite past ``cap`` keeps the
    cost O(1) per sample and the memory bounded; percentiles are then
    over the most recent ``cap`` observations, which is what a bench
    window wants anyway."""

    def __init__(self, name: str, cap: int = 8192):
        self.name = name
        self._cap = int(cap)
        self._buf: list = []
        self._next = 0
        self._total = 0
        self._lock = named_lock(f"dashboard.samples[{name}]")

    def add(self, value: float) -> None:
        with self._lock:
            if len(self._buf) < self._cap:
                self._buf.append(float(value))
            else:
                self._buf[self._next] = float(value)
                self._next = (self._next + 1) % self._cap
            self._total += 1

    @property
    def count(self) -> int:
        return self._total

    @staticmethod
    def _nearest_rank(data: list, p: float) -> float:
        """Nearest-rank percentile over sorted ``data``: the
        ceil(p/100 * n)-th smallest value (1-indexed), so p50 of a
        2-element window is the LOWER value and a 1-element window
        answers every p with its only value."""
        idx = max(math.ceil(len(data) * min(max(p, 0.0), 100.0)
                            / 100.0), 1) - 1
        return data[min(idx, len(data) - 1)]

    def percentile(self, p: float) -> float:
        """The p-th percentile (0-100, nearest-rank) of the retained
        window; 0.0 when empty."""
        with self._lock:
            data = sorted(self._buf)
        if not data:
            return 0.0
        return self._nearest_rank(data, p)

    def snapshot(self) -> dict:
        """Bench-friendly summary: count + p50/p90/p99/max."""
        with self._lock:
            data = sorted(self._buf)
            total = self._total
        if not data:
            return {"count": total}
        return {"count": total,
                "p50": self._nearest_rank(data, 50),
                "p90": self._nearest_rank(data, 90),
                "p99": self._nearest_rank(data, 99),
                "max": data[-1]}

    def export_recent(self, limit: int = 256) -> List[float]:
        """Up to ``limit`` of the most recent retained values, oldest
        first — the raw window the controller merges cluster-wide
        percentiles from (summary snapshots cannot be merged without
        the underlying samples; docs/OBSERVABILITY.md)."""
        with self._lock:
            if len(self._buf) < self._cap or self._next == 0:
                ordered = list(self._buf)
            else:  # ring wrapped: oldest sits at _next
                ordered = self._buf[self._next:] + self._buf[:self._next]
        return ordered[-max(int(limit), 1):]


_samples: Dict[str, Samples] = {}
_samples_lock = named_lock("dashboard.samples_registry")


def samples(name: str, cap: int = 8192) -> Samples:
    """Registry accessor for ``Samples`` (mirrors ``Dashboard.get``)."""
    with _samples_lock:
        s = _samples.get(name)
        if s is None:
            s = Samples(name, cap)
            _samples[name] = s
        return s


def reset_samples() -> None:
    with _samples_lock:
        _samples.clear()


def metrics_snapshot(max_samples: int = 256) -> dict:
    """Serialize the whole registry (monitors + sample reservoirs) into
    a versioned plain dict — the per-rank payload of the
    ``Control_Metrics`` export (runtime/metrics.py) and the local half
    of every ``/metrics`` scrape. ``max_samples`` caps the raw window
    shipped per reservoir (the controller merges these into cluster
    percentiles)."""
    with Dashboard._lock:
        monitors = list(Dashboard._monitors.items())
    with _samples_lock:
        reservoirs = list(_samples.items())
    return {
        "v": METRICS_SNAPSHOT_VERSION,
        "monitors": {name: {"count": m.count,
                            "elapsed_ms": round(m.elapse, 3)}
                     for name, m in monitors},
        "samples": {name: {"count": s.count,
                           "recent": s.export_recent(max_samples)}
                    for name, s in reservoirs},
    }


def count(name: str, n: int = 1) -> None:
    """Bump a named counter by ``n`` — a Monitor used purely for its
    call count (elapsed stays 0). The client cache's hit/miss/join
    counters ride the same registry as the timing monitors so
    ``Dashboard.display()`` shows them side by side. ``n`` > 1 serves
    row-granular counters (replica hit/miss rows per reply) without a
    per-row Python loop."""
    if n > 0:
        Dashboard.get(name).add_count(n)


def trace_to(log_dir: str):
    """Whole-program profiler capture: everything inside the block —
    including ``monitor(..., trace=True)`` ranges — lands as a Chrome
    trace (``trace.json``) under ``log_dir``, host and CUDA activity
    both (the port's counterpart of the reference's xprof capture).

        with trace_to("/tmp/trace"):
            trainer.train_epoch(seed=0, max_steps=4)
    """
    import contextlib
    import os

    import torch
    import torch.profiler

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def capture():
        os.makedirs(log_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    return capture()
