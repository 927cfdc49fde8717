"""Runtime lock-order witness: named locks + deadlock-cycle detection.

The static half of the project's concurrency discipline lives in
``tools/mvlint`` (lock-discipline / device-dispatch passes); this module
is the *runtime* half — the witness(4)-style checker that catches what
lexical analysis cannot: cross-module acquisition ORDER. Three of the
four merged PRs fixed latent ordering hangs after the fact (the PR-1
server-vs-server XLA wedge, the PR-4 two_workers device-pool wedge);
the witness turns the next one from a flaky CI hang into a diagnostic
naming both threads, both locks, and both acquisition stacks.

Usage: construct locks through the factories —

    self._lock = named_lock("tcp[r0].lifecycle")
    self._cond = named_condition("mt_queue[3]")

With ``-debug_locks`` **off** (the default) the factories return plain
``threading`` primitives: zero wrapper frames, zero steady-state
overhead — the production hot path is byte-identical to before. With
the flag **on at construction time**, each factory returns a witness
wrapper that, per acquisition, records the per-thread held-set and adds
edges to one process-wide lock-order graph: acquiring B while holding A
records A -> B. The first acquisition that would close a cycle (a
B -> A edge when A -> B is on record) raises :class:`LockOrderError`
*before blocking*, so the potential deadlock is reported even on runs
where the fatal interleaving never actually fires — that is the whole
point of witness-style checking.

Because the flag is sampled at construction, locks created at import
time (module-level singletons) are witnessed only when the flag is set
before their module first loads — e.g. ``-debug_locks=true`` on the
command line, or ``set_flag`` at the top of a test. Everything the
LocalCluster/TcpNet runtime builds per run is constructed after flag
parsing and is fully covered.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from .configure import define_bool, get_flag

define_bool("debug_locks", False,
            "construct witness-wrapped named locks: per-thread held-set "
            "tracking + global lock-order graph with cycle detection "
            "(raises LockOrderError naming both threads, both locks and "
            "both acquisition stacks on a potential-deadlock edge). "
            "Sampled at lock CONSTRUCTION time; off = plain "
            "threading primitives, zero overhead")


class LockOrderError(RuntimeError):
    """A lock acquisition would close a cycle in the lock-order graph."""


# -- witness state (one graph per process) --

_tls = threading.local()  # .held: List[_WitnessLock] for this thread

#: (held_name, acquired_name) -> (thread name, held stack, acquire stack)
_edges: Dict[Tuple[str, str], Tuple[str, str, str]] = {}
_graph_lock = threading.Lock()

#: Every diagnostic the witness produced, in order (tests assert on
#: this; the raising path appends before it raises).
_reports: List[str] = []


def enabled() -> bool:
    """Whether locks constructed NOW would be witnessed."""
    return bool(get_flag("debug_locks"))


def reports() -> List[str]:
    with _graph_lock:
        return list(_reports)


def reset() -> None:
    """Drop the order graph and report log (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _reports.clear()


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack() -> str:
    # Skip the witness frames themselves; keep the caller context.
    return "".join(traceback.format_stack(limit=16)[:-3])


_RLOCK_TYPE = type(threading.RLock())


def _note_attempt(lock: "_WitnessLock", blocking: bool = True,
                  timeout: float = -1) -> None:
    """Record order edges for acquiring ``lock`` while holding the
    thread's current held-set; raise on a would-be cycle. Runs BEFORE
    the real acquire blocks, so a true AB/BA interleaving reports
    instead of deadlocking."""
    held = _held()
    me = threading.current_thread().name
    for h, h_stack in held:
        if h is not lock:
            continue
        if isinstance(lock.lock, _RLOCK_TYPE):
            return  # RLock re-entry: legal, no new ordering fact
        if not blocking or timeout >= 0:
            return  # bounded probe: fails naturally, caller handles it
        # Re-acquiring a held NON-reentrant lock with an unbounded
        # blocking acquire: the simplest deadlock there is — report it
        # instead of silently hanging (the hang is what this tool
        # exists to replace).
        report = (f"self-deadlock: thread {me!r} re-acquiring "
                  f"non-reentrant lock {lock.name!r} it already "
                  f"holds\n  first held at:\n{_indent(h_stack)}"
                  f"  re-acquired at:\n{_indent(_stack())}")
        with _graph_lock:
            _reports.append(report)
        raise LockOrderError(report)
    if not blocking or timeout >= 0:
        # Bounded probes cannot deadlock forever: a cycle report here
        # would crash shutdown paths (acquire_timeout) that are
        # deadlock-free by construction, and a pre-recorded edge for an
        # acquire that then times out would poison later reports. The
        # witness stays conservative: no edges, no raise.
        return
    if not held:
        return  # nothing to order against: skip the stack capture
    my_stack = _stack()
    with _graph_lock:
        for h, h_stack in held:
            if h.name == lock.name:
                continue
            edge = (h.name, lock.name)
            if edge in _edges:
                continue
            cycle = _find_path(lock.name, h.name)
            if cycle is not None:
                other_thread, other_held_stack, other_acq_stack = \
                    _edges[(cycle[0], cycle[1])]
                report = (
                    f"potential deadlock: lock-order cycle "
                    f"{' -> '.join(cycle)} -> {cycle[0]}\n"
                    f"  thread {me!r} holds {h.name!r} and wants "
                    f"{lock.name!r}; held at:\n{_indent(h_stack)}"
                    f"  ... wants it at:\n{_indent(my_stack)}"
                    f"  thread {other_thread!r} previously took "
                    f"{cycle[1]!r} while holding {cycle[0]!r}; "
                    f"held at:\n{_indent(other_held_stack)}"
                    f"  ... acquired at:\n{_indent(other_acq_stack)}")
                _reports.append(report)
                raise LockOrderError(report)
            _edges[edge] = (me, h_stack, my_stack)


def _note_acquired(lock: "_WitnessLock") -> None:
    _held().append((lock, _stack()))


def _note_released(lock: "_WitnessLock") -> bool:
    """Drop the most recent held entry for ``lock``; True iff one was
    actually held (callers re-add only what they removed)."""
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            del held[i]
            return True
    return False


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS over the order graph: a path src ->* dst (edge list held
    under _graph_lock by the caller). Returns the node path or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for (a, b) in _edges:
            if a == node and b not in seen:
                seen.add(b)
                stack.append((b, path + [b]))
    return None


def _indent(text: str) -> str:
    return "".join(f"    {line}\n" for line in text.rstrip().splitlines())


class _WitnessLock:
    """Witness wrapper around a Lock/RLock. Not re-entrant bookkeeping
    itself — re-entrant acquires of a wrapped RLock are recognized in
    ``_note_attempt`` and tracked per nesting level in the held list."""

    __slots__ = ("lock", "name")

    def __init__(self, inner, name: str):
        self.lock = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Re-check the flag per acquire: a wrapper outlives a flag
        # flip (monitors in the process-wide Dashboard registry, for
        # one), and witness bookkeeping — the stack captures above
        # all — must not keep taxing hot paths after -debug_locks is
        # turned off. Release stays unconditional so an entry added
        # while enabled is always removed.
        if not enabled():
            return self.lock.acquire(blocking, timeout)
        _note_attempt(self, blocking, timeout)
        got = self.lock.acquire(blocking, timeout)
        if got:
            _note_acquired(self)
        return got

    def release(self) -> None:
        self.lock.release()
        _note_released(self)

    def locked(self) -> bool:
        return self.lock.locked()

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<witness {self.name} over {self.lock!r}>"


class _WitnessCondition:
    """Witness wrapper around ``threading.Condition``.

    The underlying lock is tracked through a :class:`_WitnessLock`;
    ``wait``/``wait_for`` drop it from the held-set for the duration
    (the condition releases its lock while waiting — holding it in the
    witness view would manufacture false ordering edges from whatever
    the *waking* code acquires)."""

    __slots__ = ("_wit", "_cond")

    def __init__(self, name: str, lock=None):
        if isinstance(lock, _WitnessLock):
            self._wit = lock
        elif lock is None:
            self._wit = _WitnessLock(threading.Lock(), name)
        else:  # a plain primitive handed in: wrap it under this name
            self._wit = _WitnessLock(lock, name)
        self._cond = threading.Condition(self._wit.lock)

    @property
    def name(self) -> str:
        return self._wit.name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._wit.acquire(blocking, timeout)

    def release(self) -> None:
        self._wit.release()

    def __enter__(self) -> "_WitnessCondition":
        self._wit.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._wit.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        # Re-add only what was actually removed: wait() on an
        # un-acquired condition raises RuntimeError, and a phantom
        # held entry would turn the thread's NEXT legitimate acquire
        # into a false self-deadlock report.
        removed = _note_released(self._wit)
        try:
            return self._cond.wait(timeout)
        finally:
            if removed:
                _note_acquired(self._wit)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        removed = _note_released(self._wit)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            if removed:
                _note_acquired(self._wit)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# -- injectable thread model (tools/mvchk) --

#: When a model is installed, the factories below build ITS
#: cooperative primitives instead of ``threading``'s, and
#: :func:`monotonic` reads its virtual clock — that is the entire
#: hook surface the mvchk deterministic-schedule checker needs to run
#: MtQueue/Waiter under controlled interleavings. Sampled at
#: CONSTRUCTION time like ``-debug_locks``: primitives built while no
#: model is installed are plain ``threading`` objects with zero
#: steady-state overhead.
_THREAD_MODEL = None


def install_thread_model(model) -> None:
    """``model`` provides ``lock(name)``, ``rlock(name)``,
    ``condition(name, lock)`` and ``monotonic()``."""
    global _THREAD_MODEL
    _THREAD_MODEL = model


def clear_thread_model() -> None:
    global _THREAD_MODEL
    _THREAD_MODEL = None


def monotonic() -> float:
    """``time.monotonic()``, or the installed model's virtual clock —
    deadline math in the primitives routes through here so a model
    checker can expire timeouts deterministically."""
    if _THREAD_MODEL is not None:
        return _THREAD_MODEL.monotonic()
    return time.monotonic()


# -- factories (the only public construction path) --

def named_lock(name: str):
    """A ``threading.Lock`` — witness-wrapped iff -debug_locks is set
    at the moment of construction."""
    if _THREAD_MODEL is not None:
        return _THREAD_MODEL.lock(name)
    if enabled():
        return _WitnessLock(threading.Lock(), name)
    return threading.Lock()


def named_rlock(name: str):
    if _THREAD_MODEL is not None:
        return _THREAD_MODEL.rlock(name)
    if enabled():
        return _WitnessLock(threading.RLock(), name)
    return threading.RLock()


def named_condition(name: str, lock=None):
    """A ``threading.Condition``. Pass ``lock`` to share a mutex the
    way ``threading.Condition(mutex)`` does — a ``named_lock`` result
    (plain or witnessed) is accepted."""
    if _THREAD_MODEL is not None:
        return _THREAD_MODEL.condition(name, lock)
    if enabled() or isinstance(lock, _WitnessLock):
        return _WitnessCondition(name, lock)
    return threading.Condition(lock)


@contextlib.contextmanager
def acquire_timeout(lock, timeout: float):
    """``with``-discipline bounded acquisition: yields True iff the
    lock was taken within ``timeout`` seconds, releasing on exit iff
    taken. The body must branch on the yielded flag. This is the one
    sanctioned alternative to a bare ``acquire/release`` pair (the
    lock-discipline lint flags those), for paths — e.g. shutdown —
    where blocking forever on a wedged peer is worse than skipping."""
    got = lock.acquire(timeout=timeout)
    try:
        yield got
    finally:
        if got:
            lock.release()
