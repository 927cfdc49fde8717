"""Flag-gated fault injection: frame drop/delay/reorder + scripted kills.

The elastic-resharding protocol (docs/SHARDING.md) claims every
migration either completes or rolls back to a consistent epoch under
message loss and process death. This module makes those claims
TESTABLE instead of aspirational: the transports call
:func:`filter_frames` on every outbound message (one flag probe and a
falsy check when disarmed — nothing else runs), and protocol
code marks named points with :func:`kill_point` so a test can SIGKILL
a process at an exact protocol instant.

``-chaos_frames`` spec (comma-separated ``key=value``):

    drop=0.3        drop matching frames with this probability
    delay_ms=25     sleep this long before sending a matching frame
    reorder=0.2     hold a matching frame and release it AFTER the
                    next matching frame to the same destination
    classes=shard   which frames match: ``shard`` (migration + shard
                    map control), ``ctrl`` (everything outside the
                    get/add data plane), ``data``, ``all``
    dst=2           additionally restrict to one destination rank
    for_s=5         faults only fire for this long after the FIRST
                    matching frame (a healing partition); 0 = forever
    seed=7          deterministic RNG

``-chaos_kill_on=point[:n]`` SIGKILLs this process the ``n``-th time
the named :func:`kill_point` is reached (default n=1). Points are
documented where they are placed (grep ``chaos.kill_point``).

Test/bench harness only — never enable in production. Everything here
is process-local and thread-safe via one small lock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from . import log
from .configure import define_string, get_flag
from .dashboard import count as count_event

define_string("chaos_frames", "",
              "fault-injection spec for outbound frames "
              "(drop=/delay_ms=/reorder=/classes=/dst=/for_s=/seed=; "
              "empty = off). Test harness only — docs/SHARDING.md "
              "chaos matrix")
define_string("chaos_kill_on", "",
              "SIGKILL this process at a named protocol point "
              "('point' or 'point:n' for the n-th hit); empty = off. "
              "Test harness only")

#: Dashboard counters (util/dashboard.py METRIC_NAMES).
CHAOS_DROPPED = "CHAOS_DROPPED"
CHAOS_DELAYED = "CHAOS_DELAYED"


class _FrameChaos:
    def __init__(self, spec: str):
        import random
        kv = {}
        for part in spec.split(","):
            part = part.strip()
            if part and "=" in part:
                k, v = part.split("=", 1)
                kv[k.strip()] = v.strip()
        self.drop = float(kv.get("drop", 0.0))
        self.delay_ms = float(kv.get("delay_ms", 0.0))
        self.reorder = float(kv.get("reorder", 0.0))
        self.classes = kv.get("classes", "all")
        self.dst = int(kv.get("dst", -1))
        self.for_s = float(kv.get("for_s", 0.0))
        self.rng = random.Random(int(kv.get("seed", 1)))
        self.armed_at: Optional[float] = None
        self.lock = threading.Lock()
        #: per-destination 1-slot hold for reorder
        self.held: Dict[int, object] = {}

    def matches(self, msg) -> bool:
        if self.dst >= 0 and msg.dst != self.dst:
            return False
        t = int(msg.type_int)
        if self.classes == "all":
            return True
        is_shard = t in _SHARD_TYPES
        if self.classes == "shard":
            return is_shard
        is_data = -32 < t < 32 and t != 0 and not is_shard
        if self.classes == "data":
            return is_data
        if self.classes == "ctrl":
            return not is_data
        return True

    def window_open(self) -> bool:
        if self.for_s <= 0:
            return True
        if self.armed_at is None:
            self.armed_at = time.monotonic()
        return time.monotonic() - self.armed_at <= self.for_s


_SHARD_TYPES: set = set()


def _init_shard_types() -> None:
    # Lazy: core.message imports nothing from util, so this is safe,
    # but keep the import out of module load (chaos is imported by the
    # transports, which core code imports early).
    from ..core.message import MsgType
    _SHARD_TYPES.update(int(t) for t in (
        MsgType.Request_ShardData, MsgType.Request_ShardAck,
        MsgType.Request_ShardBegin, MsgType.Request_ShardAbort,
        MsgType.Request_FwdGet, MsgType.Request_FwdAdd,
        MsgType.Control_Shard_Done, MsgType.Control_Shard_Map,
        MsgType.Control_Shard_Request))


_frames: Optional[_FrameChaos] = None
_frames_spec: Optional[str] = None
_kill_lock = threading.Lock()
_kill_counts: Dict[str, int] = {}


def _frame_state() -> Optional[_FrameChaos]:
    """The active frame-fault config, rebuilt when the flag changes
    (tests flip it between cluster runs). The disarmed common path is
    one flag probe and a falsy check — no str()/parse work per
    frame."""
    global _frames, _frames_spec
    spec = get_flag("chaos_frames", "")
    if not spec:
        if _frames is not None:
            _frames, _frames_spec = None, ""
        return None
    spec = str(spec)
    if spec != _frames_spec:
        _frames_spec = spec
        _init_shard_types()
        _frames = _FrameChaos(spec)
        log.info("chaos: frame faults armed (%s)", spec)
    return _frames


def filter_frames(msg) -> Optional[List]:
    """Transport hook: returns the list of messages to actually send
    now (possibly empty — dropped/held; possibly two — a held frame
    released ahead of schedule), or None meaning "no chaos, send as
    is" (the zero-cost common path)."""
    state = _frame_state()
    if state is None:
        return None
    if not state.matches(msg) or not state.window_open():
        return None
    out: List = []
    with state.lock:
        if state.drop > 0 and state.rng.random() < state.drop:
            count_event(CHAOS_DROPPED)
            log.debug("chaos: dropped %r", msg)
            return out  # dropped (plus anything held stays held)
        if state.reorder > 0:
            held = state.held.pop(msg.dst, None)
            if held is not None:
                out.append(msg)      # the newer frame jumps the queue
                out.append(held)
                return out
            if state.rng.random() < state.reorder:
                state.held[msg.dst] = msg
                return out           # held for the next matching frame
        delay = state.delay_ms
    if delay > 0:
        count_event(CHAOS_DELAYED)
        time.sleep(delay / 1e3)
    out.append(msg)
    return out


def kill_point(name: str) -> None:
    """SIGKILL this process if ``-chaos_kill_on`` names this point
    (optionally its n-th occurrence). Placed at protocol instants the
    chaos matrix needs deterministic deaths at (docs/SHARDING.md)."""
    spec = str(get_flag("chaos_kill_on", ""))
    if not spec:
        return
    target, _, nth = spec.partition(":")
    if target != name:
        return
    want = int(nth) if nth else 1
    with _kill_lock:
        _kill_counts[name] = _kill_counts.get(name, 0) + 1
        hit = _kill_counts[name]
    if hit < want:
        return
    import os
    import signal
    log.error("chaos: kill point %r reached (hit %d) — SIGKILL",
              name, hit)
    import sys
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)
