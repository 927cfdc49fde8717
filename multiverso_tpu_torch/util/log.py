"""Leveled logging + CHECK macros.

TPU-native equivalent of the reference logger
(ref: include/multiverso/util/log.h:22-142, src/util/log.cpp). Levels
Debug/Info/Error/Fatal, ``[LEVEL] [TIME]`` prefix, optional file tee, and
``CHECK`` / ``CHECK_NOTNULL`` that raise (the reference's Fatal optionally
kills the process; here it raises ``FatalError`` so tests can assert on it,
with ``set_kill_fatal(True)`` restoring abort semantics).
"""

from __future__ import annotations

import enum
import os
import sys
import threading
import time
from typing import Optional


class LogLevel(enum.IntEnum):
    Debug = 0
    Info = 1
    Error = 2
    Fatal = 3


class FatalError(RuntimeError):
    pass


class Logger:
    def __init__(self, level: LogLevel = LogLevel.Info):
        self._level = level
        self._file = None
        self._kill_fatal = False
        self._lock = threading.Lock()

    def reset_log_file(self, filename: Optional[str]) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            if filename:
                self._file = open(filename, "a")

    def reset_log_level(self, level: LogLevel) -> None:
        self._level = LogLevel(level)

    def reset_kill_fatal(self, is_kill: bool) -> None:
        self._kill_fatal = bool(is_kill)

    @property
    def level(self) -> LogLevel:
        return self._level

    def write(self, level: LogLevel, fmt: str, *args) -> None:
        if level < self._level and level != LogLevel.Fatal:
            return
        msg = (fmt % args) if args else fmt
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        line = f"[{level.name.upper()}] [{stamp}] {msg}"
        if not line.endswith("\n"):
            line += "\n"
        with self._lock:
            stream = sys.stderr if level >= LogLevel.Error else sys.stdout
            stream.write(line)
            stream.flush()
            if self._file is not None:
                self._file.write(line)
                self._file.flush()
        if level == LogLevel.Fatal:
            if self._kill_fatal:
                os._exit(1)
            raise FatalError(msg)

    def debug(self, fmt: str, *args) -> None:
        self.write(LogLevel.Debug, fmt, *args)

    def info(self, fmt: str, *args) -> None:
        self.write(LogLevel.Info, fmt, *args)

    def error(self, fmt: str, *args) -> None:
        self.write(LogLevel.Error, fmt, *args)

    def fatal(self, fmt: str, *args) -> None:
        self.write(LogLevel.Fatal, fmt, *args)


def _env_level() -> LogLevel:
    raw = os.environ.get("MV_LOG_LEVEL", "")
    try:
        return LogLevel(int(raw))
    except (ValueError, KeyError):
        by_name = {l.name.lower(): l for l in LogLevel}
        return by_name.get(raw.strip().lower(), LogLevel.Info)


_logger = Logger(_env_level())


def logger() -> Logger:
    return _logger


def debug(fmt: str, *args) -> None:
    _logger.debug(fmt, *args)


def info(fmt: str, *args) -> None:
    _logger.info(fmt, *args)


def error(fmt: str, *args) -> None:
    _logger.error(fmt, *args)


def fatal(fmt: str, *args) -> None:
    _logger.fatal(fmt, *args)


def set_log_level(level: LogLevel) -> None:
    _logger.reset_log_level(level)


def set_log_file(filename: Optional[str]) -> None:
    _logger.reset_log_file(filename)


def set_kill_fatal(is_kill: bool) -> None:
    _logger.reset_kill_fatal(is_kill)


def CHECK(condition, msg: str = "") -> None:
    """ref: include/multiverso/util/log.h:10-13."""
    if not condition:
        fatal("Check failed: %s", msg or "<condition>")


def CHECK_NOTNULL(pointer, name: str = "pointer"):
    """ref: include/multiverso/util/log.h:15-17."""
    if pointer is None:
        fatal("%s must not be None", name)
    return pointer
