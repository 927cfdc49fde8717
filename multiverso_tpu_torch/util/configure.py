"""Typed flag/configuration registry.

TPU-native re-design of the reference's gflags-like system
(ref: include/multiverso/util/configure.h:11-114, src/util/configure.cpp:9-54).
Semantics preserved:

- flags are registered with a name, default value and description;
- ``parse_cmd_flags(argv)`` consumes ``-key=value`` entries (leaving every
  other entry in place, compacting the list) and returns the remaining argv;
- values are readable/writable at any time (``get_flag`` / ``set_flag``,
  the reference's ``MV_CONFIG_<name>`` / ``MV_SetFlag``).

Unlike the reference there is one registry keyed by name (the reference keeps
one static registry per C++ type); type is enforced by the registered default.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

#: CENTRAL FLAG REGISTRY — the one canonical (default, description) per
#: flag name, for the whole tree. ``define_*`` calls scattered across
#: modules keep working (a flag only becomes *parseable* once its module
#: imports), but every name and default they register must match this
#: table: ``tools/mvlint``'s flag-lint pass reads the literal below and
#: fails CI on any ``get_flag``/``set_flag``/``define_*`` site naming an
#: unlisted flag or registering a drifted default. Keep the literal
#: plain (no computed values) — the lint parses it without importing.
CANONICAL_FLAGS: Dict[str, Any] = {
    # -- runtime / transport (runtime/tcp.py, runtime/zoo.py) --
    "machine_file": "",
    "port": 55555,
    "rank": -1,
    "send_queue_mb": 32,
    "net_pace_mbps": 0.0,
    # -- zero-copy wire path (runtime/tcp.py, util/buffer_pool.py;
    #    docs/MEMORY.md) --
    "zero_copy": True,
    "buffer_pool_mb": 32,
    "buffer_pool_classes": 12,
    # -- shared-memory transport for co-located ranks (runtime/shm.py;
    #    docs/MEMORY.md "Below the socket") --
    "shm": True,
    "shm_ring_slots": 16,
    "shm_slot_kb": 512,
    "ps_role": "default",
    "ma": False,
    "sync": False,
    # -- server / worker actors --
    "backup_worker_ratio": 0.0,
    "server_fuse_max": 16,
    "server_fuse_bytes": 16777216,
    "coalesce_adds": True,
    "coalesce_max_msgs": 64,
    "coalesce_max_kb": 4096,
    # -- sharding / scale-out (runtime/replica.py; docs/SHARDING.md) --
    "replica_hot_rows": 0,
    "replica_report_gets": 256,
    "replica_min_gets": 8,
    "replica_sync_rows": 8192,
    "replica_sync_every": 8,
    # -- fault tolerance (runtime/snapshot.py, runtime/controller.py,
    #    runtime/zoo.py, runtime/worker.py, runtime/tcp.py) --
    "snapshot_interval_s": 0.0,
    "snapshot_dir": "",
    "rejoin": False,
    "rpc_retry_max": 0,
    "rpc_backoff_ms": 50.0,
    "rpc_timeout_s": 0.0,
    "heartbeat_interval_s": 0.0,
    "heartbeat_timeout_s": 5.0,
    "rejoin_grace_s": 30.0,
    "connect_timeout_s": 30.0,
    # -- elastic resharding + chaos harness (runtime/shard_map.py,
    #    util/chaos.py; docs/SHARDING.md) --
    "reshard_chunk_rows": 4096,
    "reshard_auto": False,
    "reshard_skew": 2.0,
    "shard_initial_servers": 0,
    "chaos_frames": "",
    "chaos_kill_on": "",
    # -- allreduce engine (runtime/allreduce_engine.py) --
    "allreduce_algo": "auto",
    "allreduce_chunk_kb": 512,
    "allreduce_window": 4,
    "allreduce_ring_kb": 256,
    "allreduce_timeout_s": 120.0,
    "allreduce_stash_cap": 4096,
    "allreduce_lossy": False,
    "allreduce_sparse_density": 0.25,
    "allreduce_sparse_idx_budget": 8388608,
    # -- wire codec (util/wire_codec.py) --
    "wire_codec": True,
    "wire_codec_lossy": False,
    "wire_codec_density": 0.5,
    # -- tables (tables/matrix_table.py, tables/client_cache.py) --
    "sparse_compress": True,
    "verify_device_ids": False,
    "one_bit_push": False,
    "max_get_staleness": 0,
    "client_cache_rows": 65536,
    # -- updater --
    "updater_type": "default",
    # -- diagnostics (util/lock_witness.py,
    #    runtime/thread_roles.py) --
    "debug_locks": False,
    "role_block_budget_ms": 250.0,
    # -- observability (util/tracing.py, runtime/metrics.py,
    #    io/metrics_http.py; docs/OBSERVABILITY.md) --
    "trace_sample_rate": 0.0,
    "trace_slow_ms": 0.0,
    "trace_buffer": 4096,
    "metrics_interval_s": 0.0,
    "metrics_port": 0,
    # -- closed-loop self-tuning (runtime/autotune.py;
    #    docs/AUTOTUNE.md) --
    "autotune_interval_s": 0.0,
    "autotune_slo_p99_ms": 50.0,
    "autotune_pin": "",
    # -- online serving tier (serving/frontend.py,
    #    serving/admission.py; docs/SERVING.md) --
    "serving_port": 0,
    "serving_max_rows": 4096,
    "serving_max_inflight": 64,
    "serving_shed_depth": 256,
    "serving_retry_after_s": 0.05,
    "serving_drain_s": 5.0,
    "serving_scatter": True,
    "serving_batch_window_ms": 2.0,
    "serving_batch_max_rows": 1024,
    "serving_hot_rows": 4096,
    "serving_fleet_interval_s": 2.0,
    "ann_nlist": 0,
    "ann_nprobe": 8,
    # -- wordembedding model (models/wordembedding/) --
    "train_file": "",
    "output_file": "vectors.txt",
    "vocab_file": "",
    "save_vocab_file": "",
    "sw_file": "",
    "stopwords": "",
    "size": 100,
    "window": 5,
    "negative": 5,
    "epoch": 1,
    "min_count": 5,
    "sample": 1e-3,
    "init_learning_rate": 0.025,
    "cbow": False,
    "hs": False,
    "use_ps": False,
    "batch_size": 4096,
    "neg_block": 1,
    "per_pair": False,
    "is_pipeline": True,
    "device_pipeline": True,
}

#: LIVE-RETUNABLE FLAG REGISTRY — the subset of ``CANONICAL_FLAGS`` the
#: closed-loop autotune layer (runtime/autotune.py, docs/AUTOTUNE.md)
#: may change on a RUNNING cluster via an epoch-stamped
#: ``Control_Config`` broadcast. Every entry must (a) name a canonical
#: flag and (b) have at least one ``register_tunable_hook(...)`` call
#: site somewhere in the tree, so hot paths that cached the value at
#: construction (admission watermarks, cache bounds/capacities, batch
#: caps) actually pick the change up — ``tools/mvlint``'s tunable-lint
#: pass enforces both, parsing this literal without importing. A flag
#: NOT listed here is rejected at broadcast time (``apply_config``
#: raises), so a typo'd or genuinely-static knob can never be mutated
#: mid-run. Keep the literal plain (no computed values); the value is
#: a one-line note on how the new value lands.
TUNABLE_FLAGS: Dict[str, str] = {
    "max_get_staleness": "RowCache hook rebinds the live bound "
                         "(0 deactivates and clears)",
    "client_cache_rows": "RowCache hook resizes; eviction on next "
                         "store",
    "coalesce_max_msgs": "worker-actor hook re-caps staged-batch "
                         "message flushes",
    "coalesce_max_kb": "worker-actor hook re-caps staged-batch byte "
                       "flushes",
    "serving_max_inflight": "AdmissionController hook re-knobs the "
                            "per-endpoint in-flight cap",
    "serving_shed_depth": "AdmissionController hook re-knobs the "
                          "mailbox-depth shed watermark",
    "serving_batch_window_ms": "BatchedTableReader hook rewrites the "
                               "live batch window",
    "serving_batch_max_rows": "BatchedTableReader hook rewrites the "
                              "live batch row cap",
    "serving_hot_rows": "HotRowCache hook resizes the rendered-"
                        "response capacity",
    "replica_hot_rows": "controller reads live per report; reporter "
                        "hook re-sizes its report window",
    "allreduce_chunk_kb": "read per collective call; hook logs the "
                          "handoff",
    "wire_codec_density": "read per encoded frame; hook logs the "
                          "handoff",
}


#: Registered apply hooks per tunable flag. Bound methods are held as
#: ``weakref.WeakMethod`` so a dead owner (a table dropped between
#: bench phases) silently unregisters instead of leaking or firing on
#: a corpse; plain functions are held strongly. Guarded by
#: ``_tunable_lock`` together with the applied-epoch watermark.
_tunable_hooks: Dict[str, List] = {}
_tunable_lock = threading.Lock()
_applied_config_epoch = 0


def register_tunable_hook(name: str,
                          hook: Callable[[Any], None]) -> None:
    """Declare how a live config change to tunable flag ``name`` lands
    in a hot path that cached the value (docs/AUTOTUNE.md). The hook is
    called with the freshly-coerced value after every ``apply_tunable``
    / ``apply_config`` touching the flag; it must be idempotent and
    cheap (it runs on the communicator's receive thread). Raises
    ``KeyError`` for a flag not in ``TUNABLE_FLAGS`` — declaring a hook
    for a non-tunable flag is a registration bug, not a no-op."""
    if name not in TUNABLE_FLAGS:
        raise KeyError(
            f"register_tunable_hook({name!r}): not in TUNABLE_FLAGS "
            f"(util/configure.py) — only declared-tunable flags take "
            f"live apply hooks")
    ref: Any
    try:
        # Bound methods are held weakly so a dead owner (a table
        # dropped between bench phases) unregisters itself; plain
        # functions and builtin bound methods hold strongly.
        ref = weakref.WeakMethod(hook)
    except TypeError:
        ref = hook
    with _tunable_lock:
        # Prune dead weak refs HERE too, not only on fire: with
        # autotune off no broadcast ever fires the hooks, and a
        # process that repeatedly constructs/drops tables and
        # frontends would otherwise grow the list without bound.
        hooks = _tunable_hooks.setdefault(name, [])
        hooks[:] = [r for r in hooks
                    if not (isinstance(r, weakref.WeakMethod)
                            and r() is None)]
        hooks.append(ref)


def _fire_tunable_hooks(name: str, value: Any) -> None:
    with _tunable_lock:
        refs = list(_tunable_hooks.get(name, ()))
    live = []
    for ref in refs:
        fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
        if fn is None:
            continue  # owner collected: pruned below
        live.append(ref)
        try:
            fn(value)
        except Exception as exc:  # noqa: BLE001 - one mis-behaving
            # hook must not stop the rest of the config from landing
            from . import log
            log.error("tunable hook for -%s failed on value %r: %s",
                      name, value, exc)
    if len(live) != len(refs):
        with _tunable_lock:
            current = _tunable_hooks.get(name)
            if current is not None:
                _tunable_hooks[name] = [
                    r for r in current
                    if not (isinstance(r, weakref.WeakMethod)
                            and r() is None)]


def is_tunable(name: str) -> bool:
    return name in TUNABLE_FLAGS


def apply_tunable(name: str, value: Any) -> Any:
    """``set_flag`` + fire the flag's apply hooks with the coerced
    value. The ONLY sanctioned way to change a tunable flag on a live
    cluster — a bare ``set_flag`` would leave construction-time caches
    (admission watermarks, batch caps, cache bounds) on the old value.
    Raises ``KeyError`` for non-tunable flags."""
    if name not in TUNABLE_FLAGS:
        raise KeyError(
            f"apply_tunable({name!r}): not in TUNABLE_FLAGS "
            f"(util/configure.py) — non-tunable flags are rejected at "
            f"broadcast time")
    set_flag(name, value)
    coerced = get_flag(name)
    _fire_tunable_hooks(name, coerced)
    return coerced


def _coerce_tunable(name: str, value: Any) -> Any:
    """Coerce ``value`` to the flag's registered (or canonical) type,
    raising ``ValueError`` on a bad value — the pre-validation step
    that keeps ``apply_config`` atomic."""
    reg = FlagRegister.get()
    typ = reg._flags[name].type if reg.has(name) \
        else type(CANONICAL_FLAGS[name])
    try:
        return _coerce(value, typ)
    except (TypeError, ValueError) as exc:
        raise ValueError(
            f"bad value for tunable flag -{name} "
            f"(expected {typ.__name__}): {value!r}") from exc


def apply_config(epoch: int, flags: Dict[str, Any]) -> bool:
    """Apply one epoch-stamped ``Control_Config`` broadcast
    (runtime/autotune.py). Returns False — applying NOTHING — when
    ``epoch`` does not advance the process's applied-config watermark
    (a replayed or reordered broadcast must not roll knobs backward).
    Raises — before touching ANY flag or the watermark — ``KeyError``
    if any flag is non-tunable and ``ValueError`` if any value fails
    type coercion: a broadcast naming an undeclared flag or carrying a
    garbage value is a controller bug and the whole update is refused,
    never half-applied (and the consumed epoch never burned on a
    refusal, so a corrected re-broadcast at the same epoch lands)."""
    global _applied_config_epoch
    bad = sorted(n for n in flags if n not in TUNABLE_FLAGS)
    if bad:
        raise KeyError(
            f"config broadcast (epoch {epoch}) names non-tunable "
            f"flag(s) {bad} — not in TUNABLE_FLAGS (util/configure.py)")
    # Pre-coerce EVERYTHING before the watermark moves or any flag is
    # set: a mid-loop coercion failure would otherwise leave the
    # config half-applied with the epoch permanently consumed.
    coerced = {name: _coerce_tunable(name, flags[name])
               for name in sorted(flags)}
    with _tunable_lock:
        if int(epoch) <= _applied_config_epoch:
            return False
        _applied_config_epoch = int(epoch)
    for name, value in coerced.items():
        set_flag(name, value)
        _fire_tunable_hooks(name, value)
    return True


def applied_config_epoch() -> int:
    """The last config-broadcast epoch this process applied (0 =
    none yet)."""
    with _tunable_lock:
        return _applied_config_epoch


class _Flag:
    __slots__ = ("name", "value", "default", "type", "description")

    def __init__(self, name: str, default: Any, description: str = ""):
        self.name = name
        self.default = default
        self.value = default
        self.type = type(default)
        self.description = description


class FlagRegister:
    """Process-wide flag registry (singleton)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}

    @classmethod
    def get(cls) -> "FlagRegister":
        with cls._lock:
            if cls._instance is None:
                cls._instance = FlagRegister()
            return cls._instance

    def define(self, name: str, default: Any, description: str = "") -> None:
        if name in CANONICAL_FLAGS and (
                default != CANONICAL_FLAGS[name]
                # Type drift changes coercion semantics even when ==
                # holds (55555.0 == 55555 but -port would parse float).
                or type(default) is not type(CANONICAL_FLAGS[name])):
            # Default drift: two call sites disagree about a flag's
            # default. mvlint fails CI on this statically; warn loudly
            # at runtime too (dynamic define paths bypass the lint).
            from . import log
            log.error("flag -%s registered with default %r but the "
                      "canonical default (util/configure.py "
                      "CANONICAL_FLAGS) is %r — fix the call site or "
                      "the registry", name, default,
                      CANONICAL_FLAGS[name])
        if name in self._flags:
            # Re-definition keeps the current value (module reloads in tests).
            return
        self._flags[name] = _Flag(name, default, description)

    def has(self, name: str) -> bool:
        return name in self._flags

    def get_value(self, name: str) -> Any:
        if name not in self._flags:
            raise KeyError(f"unknown flag: {name}")
        return self._flags[name].value

    def set_value(self, name: str, value: Any) -> None:
        if name not in self._flags:
            # Mirrors reference behavior: SetCMDFlag on an unregistered flag
            # registers it implicitly (string-typed if value is a string).
            self._flags[name] = _Flag(name, value)
            return
        flag = self._flags[name]
        try:
            flag.value = _coerce(value, flag.type)
        except (TypeError, ValueError) as exc:
            raise ValueError(
                f"bad value for flag -{name} "
                f"(expected {flag.type.__name__}): {value!r}") from exc

    def reset(self) -> None:
        for flag in self._flags.values():
            flag.value = flag.default

    def all_flags(self) -> Dict[str, Any]:
        return {k: f.value for k, f in self._flags.items()}


def _coerce(value: Any, typ: type) -> Any:
    if isinstance(value, typ) and not (typ is int and isinstance(value, bool)):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "on")
        return bool(value)
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return str(value)


def define_int(name: str, default: int, description: str = "") -> None:
    FlagRegister.get().define(name, int(default), description)


def define_bool(name: str, default: bool, description: str = "") -> None:
    FlagRegister.get().define(name, bool(default), description)


def define_string(name: str, default: str, description: str = "") -> None:
    FlagRegister.get().define(name, str(default), description)


def define_double(name: str, default: float, description: str = "") -> None:
    FlagRegister.get().define(name, float(default), description)


#: Unknown flag names already warned about (one loud line per process —
#: a typo'd flag read on a hot path must not flood the log).
_warned_unknown: set = set()


def _warn_unknown_flag(name: str) -> None:
    """A ``get_flag`` name that is neither registered nor canonical is
    almost always a typo — and the old behavior (silently return the
    caller's default) made such typos invisible: the flag the operator
    set on the command line simply never took effect. Warn ONCE per
    process per name, with the nearest registered flag (difflib) so the
    fix is one copy-paste away."""
    if name in _warned_unknown:
        return
    _warned_unknown.add(name)
    import difflib
    candidates = set(CANONICAL_FLAGS) | set(FlagRegister.get()._flags)
    close = difflib.get_close_matches(name, sorted(candidates), n=1)
    hint = f"; did you mean -{close[0]}?" if close else ""
    from . import log
    log.error("get_flag(%r): not a registered or canonical flag — "
              "returning the caller's default, so -%s=... on the "
              "command line would be IGNORED%s", name, name, hint)


def get_flag(name: str, default: Any = None) -> Any:
    reg = FlagRegister.get()
    if not reg.has(name):
        # A canonical flag whose defining module simply is not imported
        # yet reads as its caller default silently (legitimate late
        # binding); anything else is a likely typo and warns loudly.
        if name not in CANONICAL_FLAGS:
            _warn_unknown_flag(name)
        if default is not None:
            return default
        raise KeyError(f"unknown flag: {name}")
    return reg.get_value(name)


def set_flag(name: str, value: Any) -> None:
    FlagRegister.get().set_value(name, value)


def reset_flags() -> None:
    FlagRegister.get().reset()


def parse_cmd_flags(argv: List[str]) -> List[str]:
    """Consume ``-key=value`` entries matching registered flags.

    Returns the compacted argv with consumed entries removed — the same
    contract as the reference's ``ParseCMDFlags`` (configure.cpp:19-53):
    only entries that match a registered flag are consumed; everything else
    (including unknown ``-key=value`` pairs) is left for downstream parsers.
    """
    if argv is None:
        return []
    remaining: List[str] = []
    reg = FlagRegister.get()
    for arg in argv:
        if isinstance(arg, bytes):
            arg = arg.decode()
        if arg.startswith("-") and "=" in arg:
            key, _, value = arg.lstrip("-").partition("=")
            if reg.has(key):
                reg.set_value(key, value)
                continue
        remaining.append(arg)
    return remaining
