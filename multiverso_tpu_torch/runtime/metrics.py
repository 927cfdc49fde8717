"""Cluster metrics export: per-rank reporters + controller aggregation.

Port of ``multiverso_tpu/runtime/metrics.py``. Each rank runs a
``MetricsReporter`` thread (enabled by ``-metrics_interval_s``) that
serializes its ``Dashboard``/``Samples`` registries
(``util.dashboard.metrics_snapshot``) plus the trace events recorded
since its last report (``util.tracing.drain_since``) into a JSON blob
and ships it to the controller as a fire-and-forget ``Control_Metrics``
message. Remote ranks send through ``net.send_async``, so that the
reporter never blocks on the wire.

The controller folds every report into a ``ClusterMetrics`` view:
per-rank and summed monitor counters, cluster percentiles merged from
the raw sample windows each report carries (summary snapshots cannot
be merged; windows can), and one bounded merged trace-event buffer,
rendered as Prometheus text (``prometheus_text``) and Chrome-trace JSON
(``chrome_trace_json``). The HTTP endpoint that serves them
(``-metrics_port``, ``io/metrics_http.py``) is ROADMAP A12.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.blob import Blob
from ..core.message import Message, MsgType
from ..util import log, tracing
from ..util.configure import define_double, define_int, get_flag
from ..util.dashboard import (METRICS_SNAPSHOT_VERSION, Samples, count,
                              metrics_snapshot)
from ..util.lock_witness import named_condition, named_lock
from . import thread_roles

define_double("metrics_interval_s", 0.0,
              "ship this rank's Dashboard/Samples snapshot (+ new "
              "trace events) to the controller as a Control_Metrics "
              "message at this period, feeding the controller's "
              "ClusterMetrics view. 0 (default) disables the reporter; "
              "per-rank registries still accumulate locally")
define_int("metrics_port", 0,
           "controller metrics scrape port (io/metrics_http.py; not "
           "ported)")

#: Merged trace events the controller retains (newest win) — a
#: multiple of the per-rank ring so a short cluster's full windows fit.
MERGED_TRACE_CAP = 32768


class MetricsReporter:
    """Per-rank export thread (enabled by ``-metrics_interval_s``)."""

    def __init__(self, zoo) -> None:
        self._zoo = zoo
        self._interval = float(get_flag("metrics_interval_s"))
        self._stop_cond = named_condition(
            f"metrics_reporter[r{zoo.rank}].stop")
        self._stopped = False  # guarded_by: _stop_cond
        self._thread: Optional[threading.Thread] = None
        # flush() runs on app threads while the reporter thread ticks:
        # serializing reports keeps _sent_seq consistent (a racing pair
        # would ship the same trace events twice).
        self._report_lock = named_lock(
            f"metrics_reporter[r{zoo.rank}].report")
        self._sent_seq = 0  # guarded_by: _report_lock
        # Report ordering guard: every report carries this reporter
        # INCARNATION (unique per reporter lifetime — a restarted/
        # rejoined rank gets a fresh one) plus a monotonic sequence,
        # so the controller can drop out-of-order or stale reports
        # instead of folding them into the cluster view
        # (ClusterMetrics.ingest).
        self._incarnation = f"{os.getpid():x}-{id(self):x}-" \
                            f"{time.time_ns():x}"
        self._report_seq = 0  # guarded_by: _report_lock

    def start(self) -> None:
        if self._interval <= 0 or self._thread is not None:
            return
        self._thread = thread_roles.spawn(
            thread_roles.BACKGROUND, target=self._main,
            name=f"mv-metrics-r{self._zoo.rank}")

    def stop(self) -> None:
        with self._stop_cond:
            self._stopped = True
            self._stop_cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _main(self) -> None:
        while True:
            with self._stop_cond:
                if self._stopped:
                    return
                self._stop_cond.wait(timeout=self._interval)
                if self._stopped:
                    # Final best-effort flush so shutdown-window counts
                    # reach the controller (apps that need a guaranteed
                    # final cut call flush() + barrier themselves).
                    self._report_once()
                    return
            self._report_once()

    def flush(self) -> None:
        """One immediate report from the calling thread (tests / apps
        that want a deterministic final cut before scraping)."""
        self._report_once()

    def _report_once(self) -> None:
        with self._report_lock:
            self._report_locked()

    def _report_locked(self) -> None:
        try:
            from . import actor as actors
            from .zoo import CONTROLLER_RANK
            events = tracing.drain_since(self._sent_seq)
            payload = metrics_snapshot()
            payload["rank"] = self._zoo.rank
            payload["trace_events"] = events
            self._report_seq += 1
            payload["inc"] = self._incarnation
            payload["seq"] = self._report_seq
            msg = Message(src=self._zoo.rank, dst=CONTROLLER_RANK,
                          msg_type=MsgType.Control_Metrics)
            text = json.dumps(payload).encode()
            msg.push(Blob(np.frombuffer(text, np.uint8).copy()))
            if self._zoo.rank == CONTROLLER_RANK:
                controller = self._zoo._actors.get(actors.CONTROLLER)
                if controller is None:
                    return
                controller.receive(msg)
            else:
                # Non-blocking like the liveness frames: the
                # communicator's dispatch thread can park toward a dead
                # peer, and this thread must never block on the wire.
                self._zoo.net.send_async(msg)
            if events:
                self._sent_seq = max(e["seq"] for e in events)
            count("METRICS_REPORT")
        except Exception as exc:  # noqa: BLE001 - a failed report is a
            # lost sample, never a crashed reporter (the next tick
            # retries; drain_since re-sends undelivered events).
            log.debug("rank %d: metrics report failed: %s",
                      self._zoo.rank, exc)


def parse_report(msg: Message) -> Optional[Dict]:
    """Decode one Control_Metrics payload; None when undecodable or a
    version this build does not understand (mis-merging a foreign
    layout is worse than dropping it)."""
    if not msg.data:
        return None
    try:
        payload = json.loads(msg.text_payload())
    except Exception:  # noqa: BLE001
        return None
    if not isinstance(payload, dict) \
            or payload.get("v") != METRICS_SNAPSHOT_VERSION:
        return None
    return payload


def split_family(name: str) -> tuple:
    """``DISPATCH_MS[d1]`` -> (``DISPATCH_MS``, ``d1``); plain names
    keep an empty key."""
    if name.endswith("]") and "[" in name:
        base, _, key = name.partition("[")
        return base, key[:-1]
    return name, ""


def _escape_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt(value) -> str:
    if isinstance(value, float):
        return format(value, ".10g")
    return str(value)


class ClusterMetrics:
    """Controller-side merge of per-rank metric reports."""

    def __init__(self) -> None:
        self._lock = named_lock("cluster_metrics")
        # rank -> latest snapshot
        self._ranks: Dict[int, Dict] = {}  # guarded_by: _lock
        self._trace: collections.deque = collections.deque(  # guarded_by: _lock
            maxlen=MERGED_TRACE_CAP)
        # Per-rank report-ordering watermark: (incarnation, seq) of
        # the newest report folded in. A report whose seq does not
        # advance WITHIN the same incarnation is out-of-order or stale
        # (async send reordering; a de-parked frame from before a
        # rank's crash) and must not roll the rank's view backward. A
        # NEW incarnation (rank restarted/rejoined) resets the
        # watermark — its counters legitimately start over — but a
        # SUPERSEDED incarnation (seen before, then replaced) is a
        # de-parked pre-crash frame and is dropped: folding it would
        # roll the rank's view back to the dead process AND reset the
        # watermark under it.
        self._report_mark: Dict[int, Tuple[str, int]] = {}  # guarded_by: _lock
        # Ordered (dict-as-ordered-set): the cap must evict the OLDEST
        # superseded incarnation, never the most recent predecessor —
        # whose de-parked frames are exactly the ones to drop.
        self._prior_incs: Dict[int, Dict[str, None]] = {}  # guarded_by: _lock
        self.dropped_stale = 0  # guarded_by: _lock

    #: Superseded incarnations remembered per rank (a de-parked frame
    #: can only be from a recent predecessor; a tiny cap bounds a
    #: crash-looping rank's footprint).
    _PRIOR_INC_CAP = 8

    def ingest(self, payload: Dict) -> None:
        rank = int(payload.get("rank", -1))
        events = payload.get("trace_events") or []
        inc = payload.get("inc")
        seq = payload.get("seq")
        dropped = False
        with self._lock:
            if seq is not None:  # pre-seq builds always fold (legacy)
                mark = self._report_mark.get(rank)
                if mark is not None and mark[0] == inc \
                        and int(seq) <= mark[1]:
                    # Same incarnation, non-advancing seq: reordered
                    # or replayed frame.
                    self.dropped_stale += 1
                    dropped = True
                elif inc in self._prior_incs.get(rank, ()):
                    # A SUPERSEDED incarnation: a de-parked frame from
                    # before the rank's crash arriving after its
                    # replacement already reported.
                    self.dropped_stale += 1
                    dropped = True
                else:
                    if mark is not None and mark[0] != inc:
                        prior = self._prior_incs.setdefault(rank, {})
                        prior[mark[0]] = None
                        while len(prior) > self._PRIOR_INC_CAP:
                            del prior[next(iter(prior))]  # oldest
                    self._report_mark[rank] = (inc, int(seq))
            if not dropped:
                self._ranks[rank] = {
                    "monitors": dict(payload.get("monitors") or {}),
                    "samples": dict(payload.get("samples") or {}),
                }
                self._trace.extend(events)
        if dropped:
            log.debug("cluster metrics: dropped stale/out-of-order "
                      "report from rank %d (seq %s)", rank, seq)
            count("METRICS_DROPPED_STALE")

    def cluster_view(self) -> Dict:
        """Per-rank and cluster-summed counters + merged percentile
        windows, as one versioned dict."""
        with self._lock:
            ranks = {r: {"monitors": dict(s["monitors"]),
                         "samples": {n: dict(v)
                                     for n, v in s["samples"].items()}}
                     for r, s in self._ranks.items()}
            # Captured WITH the snapshots: ingest increments it
            # concurrently, and the view should be one consistent cut.
            dropped = self.dropped_stale
        monitors_sum: Dict[str, Dict] = {}
        windows: Dict[str, List[float]] = {}
        counts: Dict[str, int] = {}
        for snap in ranks.values():
            for name, m in snap["monitors"].items():
                agg = monitors_sum.setdefault(
                    name, {"count": 0, "elapsed_ms": 0.0})
                agg["count"] += int(m.get("count", 0))
                agg["elapsed_ms"] += float(m.get("elapsed_ms", 0.0))
            for name, s in snap["samples"].items():
                windows.setdefault(name, []).extend(
                    float(v) for v in s.get("recent") or [])
                counts[name] = counts.get(name, 0) \
                    + int(s.get("count", 0))
        samples_merged = {}
        for name, window in windows.items():
            if not window:
                samples_merged[name] = {"count": counts.get(name, 0)}
                continue
            data = sorted(window)
            samples_merged[name] = {
                "count": counts.get(name, 0),
                "p50": Samples._nearest_rank(data, 50),
                "p90": Samples._nearest_rank(data, 90),
                "p99": Samples._nearest_rank(data, 99),
                "max": data[-1]}
        return {"v": METRICS_SNAPSHOT_VERSION, "ranks": ranks,
                "monitors_sum": monitors_sum,
                "samples_merged": samples_merged,
                "dropped_reports": dropped}

    # -- scrape renderings --
    def prometheus_text(self) -> str:
        """The cluster view in Prometheus text exposition format 0.0.4:
        per-rank series labeled ``rank``, cluster sums as
        ``mv_cluster_*``, sample reservoirs as quantile gauges."""
        view = self.cluster_view()
        lines = [
            "# HELP mv_monitor_count_total cumulative call count of a "
            "named Dashboard monitor (per rank)",
            "# TYPE mv_monitor_count_total counter",
        ]
        for rank in sorted(view["ranks"]):
            for name, m in sorted(
                    view["ranks"][rank]["monitors"].items()):
                lines.append(
                    f'mv_monitor_count_total{{name='
                    f'"{_escape_label(name)}",rank="{rank}"}} '
                    f'{_fmt(int(m.get("count", 0)))}')
        lines += [
            "# HELP mv_monitor_elapsed_ms_total cumulative elapsed "
            "milliseconds of a named Dashboard monitor (per rank)",
            "# TYPE mv_monitor_elapsed_ms_total counter",
        ]
        for rank in sorted(view["ranks"]):
            for name, m in sorted(
                    view["ranks"][rank]["monitors"].items()):
                lines.append(
                    f'mv_monitor_elapsed_ms_total{{name='
                    f'"{_escape_label(name)}",rank="{rank}"}} '
                    f'{_fmt(float(m.get("elapsed_ms", 0.0)))}')
        lines += [
            "# HELP mv_cluster_monitor_count_total cluster-wide sum of "
            "a named Dashboard monitor's call count",
            "# TYPE mv_cluster_monitor_count_total counter",
        ]
        for name, m in sorted(view["monitors_sum"].items()):
            lines.append(
                f'mv_cluster_monitor_count_total{{name='
                f'"{_escape_label(name)}"}} '
                f'{_fmt(int(m["count"]))}')
        lines += [
            "# HELP mv_cluster_monitor_elapsed_ms_total cluster-wide "
            "summed elapsed milliseconds of a named Dashboard monitor",
            "# TYPE mv_cluster_monitor_elapsed_ms_total counter",
        ]
        for name, m in sorted(view["monitors_sum"].items()):
            lines.append(
                f'mv_cluster_monitor_elapsed_ms_total{{name='
                f'"{_escape_label(name)}"}} '
                f'{_fmt(float(m["elapsed_ms"]))}')
        lines += [
            "# HELP mv_cluster_samples cluster-merged percentile of a "
            "named Samples reservoir's retained window",
            "# TYPE mv_cluster_samples gauge",
            "# HELP mv_cluster_samples_count cluster-wide total "
            "observations of a named Samples reservoir",
            "# TYPE mv_cluster_samples_count counter",
        ]
        for name, snap in sorted(view["samples_merged"].items()):
            base, key = split_family(name)
            label = (f'name="{_escape_label(base)}",'
                     f'key="{_escape_label(key)}"')
            for q, field in (("0.5", "p50"), ("0.9", "p90"),
                             ("0.99", "p99"), ("1", "max")):
                if field in snap:
                    lines.append(
                        f'mv_cluster_samples{{{label},'
                        f'quantile="{q}"}} {_fmt(float(snap[field]))}')
            lines.append(f'mv_cluster_samples_count{{{label}}} '
                         f'{_fmt(int(snap.get("count", 0)))}')
        return "\n".join(lines) + "\n"

    def chrome_trace_json(self) -> Dict:
        """Merged Chrome-trace JSON of every rank's shipped span
        events (plus nothing else: the controller's own events arrive
        through its local reporter like any rank's)."""
        with self._lock:
            events = list(self._trace)
        return tracing.chrome_trace([events])
