"""URI-dispatched stream IO + checkpoints.

Copy of ``multiverso_tpu/io/stream.py``: a ``StreamFactory`` keyed on
URI scheme (``file://`` default; other schemes register via
``register_scheme``), the buffered ``TextReader.get_line``
(ref: include/multiverso/io/io.h:24-132, src/io/io.cpp:8-62), and the
checkpoints: ``save_checkpoint`` stores every server table of the
rank (through the tables' ``store``) beside a manifest of sizes, crc32s
and versions, written atomically; ``load_checkpoint`` validates every
payload against the manifest before it loads any table, and loads a
checkpoint without a manifest through the legacy per-file path. The
bytes are the reference's, so either package loads the other's
checkpoints.
"""

from __future__ import annotations

import io
import json
import os
import zlib
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import urlparse

from ..runtime.zoo import current_zoo
from ..util import log


class Stream:
    """Binary stream (ref: io.h:24-60)."""

    def __init__(self, fileobj, path: str):
        self._f = fileobj
        self.path = path

    def write(self, data: bytes) -> int:
        return self._f.write(data)

    def read(self, size: int = -1) -> bytes:
        return self._f.read(size)

    def good(self) -> bool:
        return not self._f.closed

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _open_local(path: str, mode: str) -> Stream:
    binary_mode = mode if "b" in mode else mode + "b"
    parent = os.path.dirname(path)
    if parent and "w" in mode:
        os.makedirs(parent, exist_ok=True)
    return Stream(open(path, binary_mode), path)


class StreamFactory:
    """Scheme-dispatched open (ref: io.h:62-117, io.cpp:8-21)."""

    _openers: Dict[str, Callable[[str, str], Stream]] = {}

    @classmethod
    def register_scheme(cls, scheme: str,
                        opener: Callable[[str, str], Stream]) -> None:
        cls._openers[scheme] = opener

    @classmethod
    def get_stream(cls, uri: str, mode: str = "r") -> Stream:
        parsed = urlparse(uri)
        scheme = parsed.scheme or "file"
        if scheme == "file" or len(scheme) == 1:  # len==1: windows drive
            if parsed.scheme == "file":
                # file://tmp/x parses 'tmp' into netloc — a relative-path
                # URI; rejoin it rather than silently opening /x.
                path = (parsed.netloc + parsed.path) if parsed.netloc \
                    else parsed.path
            else:
                path = uri
            return _open_local(path, mode)
        opener = cls._openers.get(scheme)
        if opener is None:
            raise ValueError(f"unsupported stream scheme: {scheme}://")
        return opener(uri, mode)


class TextReader:
    """Buffered line reader (ref: io.h:119-132, io.cpp:33-55)."""

    def __init__(self, uri: str, buf_size: int = 1 << 20):
        self._stream = StreamFactory.get_stream(uri, "r")
        self._buf_size = buf_size
        self._buf = b""
        self._eof = False

    def get_line(self) -> Optional[str]:
        while True:
            newline = self._buf.find(b"\n")
            if newline >= 0:
                line, self._buf = self._buf[:newline], self._buf[newline + 1:]
                return line.decode("utf-8", errors="replace").rstrip("\r")
            if self._eof:
                if self._buf:
                    line, self._buf = self._buf, b""
                    return line.decode("utf-8",
                                       errors="replace").rstrip("\r")
                return None
            chunk = self._stream.read(self._buf_size)
            if not chunk:
                self._eof = True
            else:
                self._buf += chunk

    def close(self) -> None:
        self._stream.close()


# -- atomic whole-object writes (checkpoint/snapshot robustness) --

def _local_path(uri: str) -> Optional[str]:
    """The local filesystem path behind a uri, or None for remote
    schemes."""
    parsed = urlparse(uri)
    if parsed.scheme == "file":
        return (parsed.netloc + parsed.path) if parsed.netloc \
            else parsed.path
    if not parsed.scheme or len(parsed.scheme) == 1:  # plain / drive
        return uri
    return None


def write_bytes_atomic(uri: str, data: bytes, fsync: bool = False) -> None:
    """Write a whole object so a crash mid-write can never leave a
    half-written file under the final name: local files go to a
    ``.tmp.{pid}`` sibling first (optionally fsync'd) and are
    ``os.replace``d into place — the POSIX atomic-rename guarantee.
    Remote schemes write through their stream directly (object stores
    are typically whole-object-or-nothing already); readers must still
    validate (the checkpoint manifest records size+crc32 per file)."""
    path = _local_path(uri)
    if path is None:
        with StreamFactory.get_stream(uri, "w") as stream:
            stream.write(data)
        return
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def read_bytes_or_none(uri: str) -> Optional[bytes]:
    """Whole-object read; None when the object does not exist (any
    scheme's open/read failure counts as absent — PRESENT-but-torn
    payloads are caught by the manifest's size/crc validation)."""
    try:
        with StreamFactory.get_stream(uri, "r") as stream:
            return stream.read()
    except Exception:  # noqa: BLE001 - absent object
        return None


# -- checkpoints of every registered server table --

CHECKPOINT_FORMAT = 1


class CheckpointError(RuntimeError):
    """A checkpoint failed validation on load: torn table file, torn or
    partial manifest, or a manifest whose entries do not match the
    registered tables. Loading it would silently serve corrupt or
    spliced parameters, so it fails loudly instead."""


def _table_uri(uri_prefix: str, i: int, rank: int) -> str:
    return f"{uri_prefix}.table{i}.rank{rank}"


def _manifest_uri(uri_prefix: str, rank: int) -> str:
    return f"{uri_prefix}.manifest.rank{rank}.json"


def save_checkpoint(uri_prefix: str, zoo=None) -> int:
    """Store every server table shard under ``{prefix}.table{i}.rank{r}``
    plus an fsync'd, atomically-renamed manifest recording size, crc32
    and shard version per file — so ``load_checkpoint`` can reject torn
    or mixed-save checkpoints instead of restoring garbage. Returns the
    number of tables written."""
    zoo = zoo if zoo is not None else current_zoo()
    tables = zoo.server_tables
    entries = []
    for i, table in enumerate(tables):
        buf = io.BytesIO()
        table.store(buf)
        data = buf.getvalue()
        # fsync'd: the manifest below commits the save — every payload
        # it names must be durable before the manifest rename.
        write_bytes_atomic(_table_uri(uri_prefix, i, zoo.rank), data,
                           fsync=True)
        entries.append({"table": i,
                        "file": f"table{i}.rank{zoo.rank}",
                        "bytes": len(data),
                        "crc32": zlib.crc32(data),
                        "version": int(getattr(table, "version", 0))})
    manifest = {"format": CHECKPOINT_FORMAT, "rank": zoo.rank,
                "complete": True, "tables": entries}
    write_bytes_atomic(_manifest_uri(uri_prefix, zoo.rank),
                       json.dumps(manifest, indent=1).encode(),
                       fsync=True)
    log.info("rank %d: checkpointed %d tables to %s",
             zoo.rank, len(tables), uri_prefix)
    return len(tables)


def _validated_payloads(uri_prefix: str, zoo,
                        raw_manifest: bytes) -> Dict[int, Tuple[bytes,
                                                                int]]:
    """Parse + validate a checkpoint manifest against the registered
    tables; returns {table_id: (bytes, version)} or raises
    CheckpointError naming exactly what is wrong."""
    try:
        manifest = json.loads(raw_manifest.decode("utf-8"))
    except ValueError as exc:
        raise CheckpointError(
            f"checkpoint manifest for {uri_prefix!r} is torn "
            f"(unparseable JSON): {exc}") from exc
    if manifest.get("format") != CHECKPOINT_FORMAT \
            or not manifest.get("complete"):
        raise CheckpointError(
            f"checkpoint manifest for {uri_prefix!r} is partial or of "
            f"an unknown format ({manifest.get('format')!r}, "
            f"complete={manifest.get('complete')!r})")
    entries = manifest.get("tables", [])
    if len(entries) != len(zoo.server_tables):
        raise CheckpointError(
            f"checkpoint for {uri_prefix!r} covers {len(entries)} "
            f"tables but this rank registered "
            f"{len(zoo.server_tables)} — partial save or table-"
            f"creation drift; refusing a mixed restore")
    payloads: Dict[int, Tuple[bytes, int]] = {}
    for entry in entries:
        i = int(entry["table"])
        data = read_bytes_or_none(_table_uri(uri_prefix, i, zoo.rank))
        if data is None:
            raise CheckpointError(
                f"checkpoint table file "
                f"{_table_uri(uri_prefix, i, zoo.rank)!r} is missing")
        if len(data) != int(entry["bytes"]) \
                or zlib.crc32(data) != int(entry["crc32"]):
            raise CheckpointError(
                f"checkpoint table file "
                f"{_table_uri(uri_prefix, i, zoo.rank)!r} is torn or "
                f"from a different save ({len(data)} bytes vs "
                f"{entry['bytes']} in the manifest / crc mismatch)")
        payloads[i] = (data, int(entry.get("version", 0)))
    return payloads


def load_checkpoint(uri_prefix: str, zoo=None) -> int:
    """Load every server table shard saved by ``save_checkpoint``.

    With a manifest present every payload is validated (size + crc32,
    complete flag, table count) BEFORE any table is touched — a torn
    write or a manifest spliced across saves raises ``CheckpointError``
    with nothing restored. Pre-manifest checkpoints (no manifest file)
    load through the legacy per-file path unchanged."""
    zoo = zoo if zoo is not None else current_zoo()
    tables = zoo.server_tables
    raw_manifest = read_bytes_or_none(_manifest_uri(uri_prefix, zoo.rank))
    if raw_manifest is not None:
        payloads = _validated_payloads(uri_prefix, zoo, raw_manifest)
        for i, table in enumerate(tables):
            data, version = payloads[i]
            table.load(io.BytesIO(data))
            table.version = version
    else:
        for i, table in enumerate(tables):
            with StreamFactory.get_stream(
                    _table_uri(uri_prefix, i, zoo.rank), "r") as stream:
                table.load(stream)
    log.info("rank %d: restored %d tables from %s",
             zoo.rank, len(tables), uri_prefix)
    return len(tables)
