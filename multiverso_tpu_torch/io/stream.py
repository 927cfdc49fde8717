"""URI-dispatched stream IO.

Copy of ``multiverso_tpu/io/stream.py``'s stream half (the checkpoint
driver is not ported yet): a ``StreamFactory`` keyed on URI scheme
(``file://`` default; other schemes register via ``register_scheme``)
and the buffered ``TextReader.get_line``
(ref: include/multiverso/io/io.h:24-132, src/io/io.cpp:8-62).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional
from urllib.parse import urlparse


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
