"""Thread-role registry, the ``spawn`` wrapper, and the blocking
watchdog — the runtime twin of mvlint pass 9 (``thread-role``).

Every thread the package starts carries a declared **role**:

* ``EVENTLOOP`` — the transport's selector loop (one per endpoint):
  every socket accept/connect/read/write, retry and pacing timers,
  and the shm doorbell multiplex onto it. The ONLY call that may park
  it is ``selector.select(timeout)`` in its entry frame — pass 9
  proves nothing else blocking is reachable from a handler.
* ``DISPATCH`` — the communicator's receive loop. A blocked dispatch
  thread starves every control/liveness frame behind it (the PR-6/
  PR-9/PR-12 failure class, ROADMAP item 3).
* ``LIVENESS`` — the heartbeat monitor. Blocking here turns a healthy
  cluster into a false-positive death sentence.
* ``ACTOR`` — worker/server/controller run loops. May block on their
  own mailbox and on bounded table work.
* ``WRITER`` — the shm ring writers, the one queue-drainer class left:
  a full ring blocks the producer by design (bounded backpressure),
  which the event loop must never do. Blocking on the transport is
  their *job*: they exist so nothing latency-critical has to.
* ``BACKGROUND`` — everything else (metrics, snapshots, autotune,
  serving, prefetchers). Bounded-blocking by design, no budget
  enforced.

Threads register their role at spawn through :func:`spawn` (mvlint
pass 9 bans raw ``threading.Thread`` in the package), and the literal
:data:`THREAD_ROLES` table below is the canonical inventory — pass 9
cross-checks it BOTH directions against the spawn sites it discovers
through the call graph, and against the ``docs/THREADS.md`` table
(the WIRE_FORMAT.md registry precedent). Keys are
``<path-under-multiverso_tpu>::<qualname>`` of the *bound* entry
point: ``Actor._main`` spawned by a ``Server`` registers as
``runtime/server.py::Server._main`` — the role follows the
receiver's class, not where the ``def`` lexically lives.

Under ``-debug_locks`` a watchdog samples ``sys._current_frames()``
and reports any DISPATCH/LIVENESS thread whose innermost frame has
not moved for ``-role_block_budget_ms``, with the stack — the dynamic
confirmation of pass 9's static claim, exercised by the chaos
harness. A thread parked in its own entry frame or in the mailbox
(``mt_queue.py``) is *idle*, not blocked — idling in the run loop is
the healthy state the budget must not flag.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from ..util import log
from ..util.configure import define_double, get_flag

define_double("role_block_budget_ms", 250.0,
              "blocking-watchdog budget for DISPATCH/LIVENESS threads "
              "(-debug_locks only): a latency-critical thread whose "
              "stack sits still longer than this is reported with the "
              "stack and stamped into ROLE_BLOCKED_MS[role]")

DISPATCH = "DISPATCH"
ACTOR = "ACTOR"
LIVENESS = "LIVENESS"
WRITER = "WRITER"
BACKGROUND = "BACKGROUND"
EVENTLOOP = "EVENTLOOP"

ROLES = (DISPATCH, ACTOR, LIVENESS, WRITER, BACKGROUND, EVENTLOOP)

#: Roles the watchdog budgets (and pass 9 proves non-blocking).
CRITICAL_ROLES = (DISPATCH, LIVENESS, EVENTLOOP)

#: Canonical thread inventory: entry point -> role. mvlint pass 9
#: derives the same table from the spawn sites + call graph and
#: fails on any disagreement in either direction; docs/THREADS.md
#: mirrors it for humans (also cross-checked). Literal on purpose —
#: the linter parses, never imports.
THREAD_ROLES = {
    "runtime/actor.py::Actor._main": ACTOR,
    "runtime/worker.py::Worker._main": ACTOR,
    "runtime/server.py::Server._main": ACTOR,
    "runtime/server.py::SyncServer._main": ACTOR,
    "runtime/controller.py::Controller._main": ACTOR,
    "runtime/communicator.py::Communicator._recv_main": DISPATCH,
    "runtime/controller.py::HeartbeatMonitor._main": LIVENESS,
    "runtime/tcp.py::_EventLoop._main": EVENTLOOP,
    "runtime/shm.py::_ShmPeerWriter._main": WRITER,
    "runtime/metrics.py::MetricsReporter._main": BACKGROUND,
    "runtime/snapshot.py::SnapshotManager._main": BACKGROUND,
    "runtime/autotune.py::AutotuneManager._main": BACKGROUND,
    "runtime/cluster.py::LocalCluster.run.rank_main": BACKGROUND,
    "util/async_buffer.py::ASyncBuffer._prefetch.run": BACKGROUND,
    "parallel/ma.py::model_average_async.run": BACKGROUND,
    "parallel/ma.py::sharded_model_average_async.run": BACKGROUND,
    "models/logreg/reader.py::PrefetchReader._fill": BACKGROUND,
    "models/wordembedding/data.py::BlockLoader._fill": BACKGROUND,
    "serving/frontend.py::ServingFrontend._fleet_main": BACKGROUND,
    "serving/batch.py::BatchedTableReader._run": BACKGROUND,
    "io/http_server.py::serve_forever": BACKGROUND,
}


# -- live registry ----------------------------------------------------

class _Entry:
    __slots__ = ("role", "thread", "entry_code")

    def __init__(self, role: str, thread: threading.Thread,
                 entry_code) -> None:
        self.role = role
        self.thread = thread
        self.entry_code = entry_code


_registry: Dict[int, _Entry] = {}
_registry_lock = threading.Lock()
_watchdog: Optional[threading.Thread] = None

#: Watchdog diagnostics, in order (tests assert on this — its own
#: list, separate from lock_witness.reports(), so lock-order
#: assertions stay unpolluted).
_reports: List[str] = []


def spawn(role: str, target, *, name: Optional[str] = None,
          args: Tuple = (), kwargs: Optional[dict] = None,
          daemon: bool = True) -> threading.Thread:
    """``threading.Thread`` with a declared role: the only sanctioned
    way to start a thread inside ``multiverso_tpu`` (pass 9 enforces
    this). Registers the thread for the blocking watchdog and starts
    the watchdog lazily the first time a critical role appears while
    ``-debug_locks`` is on."""
    if role not in ROLES:
        raise ValueError(f"unknown thread role {role!r} "
                         f"(choose from {ROLES})")
    entry_code = getattr(target, "__code__", None)

    def _main(*a, **k):
        ident = threading.get_ident()
        with _registry_lock:
            _registry[ident] = _Entry(role, threading.current_thread(),
                                      entry_code)
        try:
            target(*a, **k)
        finally:
            with _registry_lock:
                _registry.pop(ident, None)

    thread = threading.Thread(target=_main, name=name, daemon=daemon,
                              args=args, kwargs=kwargs or {})
    if role in CRITICAL_ROLES and bool(get_flag("debug_locks")):
        _ensure_watchdog()
    thread.start()
    return thread


def roles_alive() -> Dict[str, int]:
    """Live thread count per role (observability/tests)."""
    out: Dict[str, int] = {}
    with _registry_lock:
        for entry in _registry.values():
            out[entry.role] = out.get(entry.role, 0) + 1
    return out


def reports() -> List[str]:
    with _registry_lock:
        return list(_reports)


def reset_reports() -> None:
    with _registry_lock:
        _reports.clear()


# -- blocking watchdog (-debug_locks only) ----------------------------

def _ensure_watchdog() -> None:
    global _watchdog
    with _registry_lock:
        if _watchdog is not None and _watchdog.is_alive():
            return
        _watchdog = threading.Thread(  # the watchdog itself carries no
            target=_watchdog_main,     # role: it must outlive budgets
            name="mv-role-watchdog", daemon=True)
        _watchdog.start()


def _budget_ms() -> float:
    try:
        return float(get_flag("role_block_budget_ms"))
    except Exception:  # noqa: BLE001 - unparsed flags must not kill it
        return 250.0


def _idle(entry: _Entry, frame) -> bool:
    """Parked-not-blocked: the innermost package frame is the thread's
    own entry function (a run loop waiting for work), or any frame
    sits in the mailbox (``mt_queue.pop`` is the idle state of every
    actor)."""
    innermost_pkg = None
    f = frame
    while f is not None:
        fname = f.f_code.co_filename
        if fname.endswith("mt_queue.py"):
            return True
        if innermost_pkg is None and "multiverso_tpu" in fname:
            innermost_pkg = f.f_code
        f = f.f_back
    return innermost_pkg is None or innermost_pkg is entry.entry_code


def _watchdog_main() -> None:
    # signature -> first-seen monotonic time; reported signatures.
    first_seen: Dict[Tuple[int, str, int], float] = {}
    reported: Dict[Tuple[int, str, int], bool] = {}
    while True:
        budget_ms = _budget_ms()
        time.sleep(max(budget_ms / 4000.0, 0.01))
        with _registry_lock:
            critical = {ident: entry for ident, entry
                        in _registry.items()
                        if entry.role in CRITICAL_ROLES}
        # Stays alive through empty windows: registration happens on
        # the spawned thread, so exiting on a transiently-empty
        # registry would race the very first registrant. A parked
        # daemon sampler is cheap.
        if not critical:
            continue
        frames = sys._current_frames()
        now = time.monotonic()
        live: set = set()
        for ident, entry in critical.items():
            frame = frames.get(ident)
            if frame is None or _idle(entry, frame):
                continue
            sig = (ident, frame.f_code.co_filename, frame.f_lineno)
            live.add(sig)
            start = first_seen.setdefault(sig, now)
            blocked_ms = (now - start) * 1000.0
            if blocked_ms > budget_ms and not reported.get(sig):
                reported[sig] = True
                _report(entry, frame, blocked_ms)
        for sig in list(first_seen):
            if sig not in live:
                first_seen.pop(sig, None)
                reported.pop(sig, None)


def _report(entry: _Entry, frame, blocked_ms: float) -> None:
    from ..util.dashboard import samples  # local: avoid import cycle
    stack = "".join(traceback.format_stack(frame))
    text = (f"{entry.role} thread {entry.thread.name!r} blocked "
            f"{blocked_ms:.0f}ms (budget "
            f"{_budget_ms():.0f}ms) at "
            f"{frame.f_code.co_filename}:{frame.f_lineno}\n{stack}")
    with _registry_lock:
        _reports.append(text)
    samples(f"ROLE_BLOCKED_MS[{entry.role}]").add(blocked_ms)
    log.error("role watchdog: %s", text)
