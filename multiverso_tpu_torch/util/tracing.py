"""Distributed request tracing (docs/OBSERVABILITY.md).

Flag-gated per-request tracing across the PS runtime: with
``-trace_sample_rate > 0`` a request issued at a worker table draws a
cluster-unique trace id (rank in the high bits), which travels in wire
header slot 9 (``TRACE_SLOT``, core/message.py) on every shard, batch
and reply message the request spawns. Each hop — worker issue, coalesce
flush, event-loop submit, tcp serialize/send, server table op, waiter
notify — records a span event into a bounded process-local ring buffer;
``chrome_trace`` merges per-rank buffers into one Chrome-trace/Perfetto
JSON where spans from different ranks pair under the request's trace id
(pid = rank, tid = thread name).

Timestamps are ``time.time_ns()`` — the WALL clock, so spans recorded
on different ranks of a same-host cluster nest correctly in the merged
view; cross-host skew shifts a rank's lane without breaking the
per-trace grouping. Durations are wall-clock too.

Default (``-trace_sample_rate=0``) is a no-op: ``new_trace`` returns 0
after one flag read, every ``span(0, ...)`` hands back a shared inert
context manager, and the wire stays byte-identical to an untraced build
everywhere except the declared header-length bump
(docs/WIRE_FORMAT.md). The ``-trace_slow_ms`` watchdog logs any sampled
request whose root span exceeds the threshold, with the full locally
recorded span timeline for its trace id.
"""

from __future__ import annotations

import collections
import itertools
import random
import threading
import time
from typing import Dict, Iterable, List, Optional

from . import log
from .configure import define_double, define_int, get_flag
from .lock_witness import named_lock

define_double("trace_sample_rate", 0.0,
              "fraction of worker table requests that record a "
              "distributed trace (0 = tracing off, the default: no "
              "ids are drawn, no spans are recorded, and the wire "
              "carries 0 in the trace header slot — byte-identical to "
              "an untraced build modulo the declared header-length "
              "bump). 1.0 traces every request; sampled requests pay "
              "~a dict append per hop (docs/OBSERVABILITY.md)")
define_double("trace_slow_ms", 0.0,
              "slow-request watchdog: a SAMPLED request whose "
              "issue-to-completion root span exceeds this many "
              "milliseconds is logged with its full locally-recorded "
              "span timeline (queue vs wire vs table attribution "
              "without scraping /trace.json). 0 (default) disables "
              "the watchdog")
define_int("trace_buffer", 4096,
           "per-process span-event ring buffer capacity: the newest "
           "this many events are retained for export/merge; older "
           "events are overwritten (bounded memory under 100% "
           "sampling)")

#: Trace id layout: [7 bits rank | 23 bits counter], always > 0 (the
#: counter starts at 1), always < 2^30 so the id rides a signed-int32
#: wire header slot with room to spare. Ranks beyond 127 wrap — ids
#: stay unique per rank window, merely less attributable by eye.
_COUNTER_BITS = 23
_COUNTER_MASK = (1 << _COUNTER_BITS) - 1

_counter = itertools.count(1)
_seq = itertools.count(1)
_lock = named_lock("tracing.events")
_events: Optional[collections.deque] = None


def trace_rank(trace_id: int) -> int:
    """The issuing rank encoded in a trace id."""
    return (int(trace_id) >> _COUNTER_BITS) & 0x7F


def new_trace(rank: int) -> int:
    """Sampling decision at request issue: a fresh cluster-unique trace
    id, or 0 (untraced — the common, near-free path)."""
    rate = float(get_flag("trace_sample_rate"))
    if rate <= 0.0:
        return 0
    if rate < 1.0 and random.random() >= rate:
        return 0
    counter = next(_counter) & _COUNTER_MASK
    return ((int(rank) & 0x7F) << _COUNTER_BITS) | (counter or 1)


def now_ns() -> int:
    return time.time_ns()


def _record(entry: Dict) -> None:
    global _events
    with _lock:
        if _events is None:
            _events = collections.deque(
                maxlen=max(int(get_flag("trace_buffer")), 16))
        entry["seq"] = next(_seq)
        _events.append(entry)


def add_span(trace_id: int, name: str, rank: int, t0_ns: int,
             dur_ns: int, args: Optional[Dict] = None) -> None:
    """Record one completed span with an externally measured window
    (e.g. a queue wait whose start was stamped at enqueue)."""
    if not trace_id:
        return
    entry = {"trace": int(trace_id), "name": name, "ph": "X",
             "rank": int(rank), "ts": int(t0_ns), "dur": int(dur_ns),
             "thread": threading.current_thread().name}
    if args:
        entry["args"] = dict(args)
    _record(entry)


def event(trace_id: int, name: str, rank: int,
          args: Optional[Dict] = None) -> None:
    """Record one instant event (a hop marker with no duration)."""
    if not trace_id:
        return
    entry = {"trace": int(trace_id), "name": name, "ph": "i",
             "rank": int(rank), "ts": now_ns(),
             "thread": threading.current_thread().name}
    if args:
        entry["args"] = dict(args)
    _record(entry)


class _NullSpan:
    """Shared inert context manager for the untraced path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_trace", "_name", "_rank", "_args", "_t0")

    def __init__(self, trace_id: int, name: str, rank: int,
                 args: Optional[Dict]):
        self._trace = trace_id
        self._name = name
        self._rank = rank
        self._args = args
        self._t0 = 0

    def __enter__(self):
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc):
        add_span(self._trace, self._name, self._rank, self._t0,
                 now_ns() - self._t0, self._args)
        return None


def span(trace_id: int, name: str, rank: int,
         args: Optional[Dict] = None):
    """Span context manager; inert (shared no-op) when ``trace_id`` is
    0, so untraced hot paths pay one truthiness check."""
    if not trace_id:
        return _NULL_SPAN
    return _Span(trace_id, name, rank, args)


def end_root(trace_id: int, name: str, rank: int, t0_ns: int,
             args: Optional[Dict] = None) -> None:
    """Close a request's ROOT span (issue -> waiter completion) and run
    the ``-trace_slow_ms`` watchdog: a root over the threshold logs its
    full locally-recorded timeline."""
    if not trace_id:
        return
    dur_ns = now_ns() - t0_ns
    add_span(trace_id, name, rank, t0_ns, dur_ns, args)
    slow_ms = float(get_flag("trace_slow_ms"))
    if slow_ms > 0 and dur_ns > slow_ms * 1e6:
        log.error("slow request: trace %d (%s, rank %d) took %.2f ms "
                  "(> -trace_slow_ms=%.1f); timeline:\n%s",
                  trace_id, name, rank, dur_ns / 1e6, slow_ms,
                  format_timeline(trace_id))


def format_timeline(trace_id: int) -> str:
    """Human-readable span timeline of one trace from the local buffer
    (the slow-request watchdog's payload), oldest first, offsets
    relative to the first event."""
    entries = [e for e in snapshot_events() if e["trace"] == trace_id]
    if not entries:
        return "  (no local span events retained)"
    entries.sort(key=lambda e: e["ts"])
    base = entries[0]["ts"]
    lines = []
    for e in entries:
        off_ms = (e["ts"] - base) / 1e6
        dur = f" dur={e['dur'] / 1e6:.3f}ms" if e.get("ph") == "X" \
            else ""
        lines.append(f"  +{off_ms:9.3f}ms r{e['rank']} "
                     f"{e['name']}{dur} [{e.get('thread', '?')}]")
    return "\n".join(lines)


def snapshot_events() -> List[Dict]:
    """Copy of the process-local event buffer (export / tests)."""
    with _lock:
        return list(_events) if _events is not None else []


def drain_since(last_seq: int) -> List[Dict]:
    """Events recorded after ``last_seq`` (incremental export: the
    metrics reporter ships only what the controller has not seen).
    Events that aged out of the ring before a drain are simply lost —
    the buffer bounds memory, not completeness."""
    with _lock:
        if _events is None:
            return []
        return [e for e in _events if e["seq"] > last_seq]


def reset() -> None:
    """Drop buffered events (tests / bench phase isolation); the next
    record re-reads -trace_buffer."""
    global _events
    with _lock:
        _events = None


def chrome_trace(event_lists: Iterable[List[Dict]]) -> Dict:
    """Merge per-rank event dumps into one Chrome-trace/Perfetto JSON
    object: ``pid`` = rank, ``tid`` = recording thread name, ``ts``/
    ``dur`` in microseconds, each event's ``args.trace`` carrying the
    request's trace id so cross-rank spans group under it."""
    out = []
    for events in event_lists:
        for e in events:
            entry = {"name": e["name"], "ph": e.get("ph", "X"),
                     "ts": e["ts"] / 1e3, "pid": int(e["rank"]),
                     "tid": str(e.get("thread", "?")),
                     "args": {"trace": int(e["trace"]),
                              **e.get("args", {})}}
            if entry["ph"] == "X":
                entry["dur"] = e.get("dur", 0) / 1e3
            else:
                entry["s"] = "p"  # instant scope: process
            out.append(entry)
    out.sort(key=lambda e: e["ts"])
    return {"traceEvents": out, "displayTimeUnit": "ms"}
