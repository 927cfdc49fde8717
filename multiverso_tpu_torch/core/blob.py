"""Shared byte buffer with typed views.

Port of ``multiverso_tpu/core/blob.py``, the reference's ``Blob``
(ref: include/multiverso/blob.h:13-53, src/blob.cpp:8-46). The reference is
a ref-counted byte chunk whose copies share memory and whose ``As<T>(i)``
reinterpret-casts. In Python the natural carrier is a numpy array: numpy
views already give zero-copy sharing with refcounting (the Allocator/refcount
machinery of the reference collapses into CPython's GC), and ``as_array``
gives the reinterpret-cast view. A Blob can also wrap a ``torch.Tensor``
lazily — tensor blobs defer any host copy until host bytes are demanded,
which is what lets table keys and replies stay on the card end to end.

Two zero-copy carrier forms beyond the plain host array
(docs/MEMORY.md):

- **parted** (``Blob.from_parts``): the payload is the concatenation of
  several buffers that are never joined on the send side — the
  scatter-gather framer (``tcp.serialize_views``) reads each part as its
  own vectored-write view, so a codec frame's ``(header, payload)`` pair
  crosses the wire without the ``head + payload.tobytes()`` concat copy.
  Materialized (one concatenate) only if something demands the flat
  payload locally.
- **pool-backed** (``Blob.from_lease``): a READ-ONLY view into a leased
  receive-frame buffer (``util/buffer_pool.py``). The lease rides the
  Blob; when the last Blob cut from a frame dies, the frame returns to
  the pool. Pool views must never be written — a recycled buffer would
  be scribbled — so mutation raises and the rare consumer that needs a
  writable payload calls ``materialize()`` first (copy-on-write).
"""

from __future__ import annotations

import sys
from typing import Any, List

import numpy as np


def is_device_array(x: Any) -> bool:
    """True for ``torch.Tensor`` payloads, on ANY device: a tensor is the
    port's device array. Counting CPU tensors too lets the device-key
    table path run on the CPU (the tests pass ``device="cpu"``). Checked
    through ``sys.modules`` so core stays import-free of torch."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _host_array(x: Any) -> np.ndarray:
    """Host numpy view of a payload; a tensor is copied off its device
    (this IS the host boundary)."""
    if is_device_array(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Blob:
    # Slot order matters for the pool: on deallocation CPython clears
    # slots in definition order, so the payload view (_data) drops its
    # buffer export before the lease's __del__ probes the frame for
    # reuse — the common single-owner case re-pools immediately instead
    # of parking on the pending list.
    __slots__ = ("_data", "_parts", "_lease")

    def __init__(self, data: Any = None, size: int = None):
        """Wrap existing data (zero-copy for numpy/bytes/memoryview
        inputs) or allocate.

        ``Blob(size=n)`` allocates ``n`` bytes; ``Blob(array)`` wraps.
        """
        self._parts = None
        self._lease = None
        if data is None:
            if size is None:
                raise ValueError("Blob needs data or size")
            self._data = np.zeros(size, dtype=np.uint8)
        elif isinstance(data, Blob):
            # Shallow share, like the reference copy-ctor: payload,
            # pending parts and frame lease all ride along.
            self._data = data._data
            self._parts = data._parts
            self._lease = data._lease
        elif isinstance(data, np.ndarray):
            # Zero-copy only holds for contiguous input; a non-contiguous
            # array is copied here so as_array views stay writable+attached.
            self._data = np.ascontiguousarray(data)
        elif isinstance(data, bytes):
            # Zero-copy wrap: bytes is immutable, so the view is
            # read-only and can alias the caller's object safely
            # (the old frombuffer(bytes(..)).copy() paid two copies).
            self._data = np.frombuffer(data, dtype=np.uint8)
        elif isinstance(data, memoryview):
            # Zero-copy wrap; writability (and the no-alias discipline)
            # is the caller's — the wire path hands out read-only
            # pool views through from_lease, never through here.
            self._data = np.frombuffer(data, dtype=np.uint8)
        elif isinstance(data, bytearray):
            # ONE copy (down from two): the caller may keep mutating
            # its bytearray, so aliasing it would let later writes
            # bleed into the blob.
            self._data = np.frombuffer(data, dtype=np.uint8).copy()
        else:
            # torch.Tensor and anything else exposing __array__ kept as-is;
            # converted to host bytes only on demand.
            self._data = data

    @classmethod
    def from_parts(cls, parts: List[Any]) -> "Blob":
        """Scatter-gather blob: the payload is the concatenation of
        ``parts`` (bytes / contiguous arrays), kept separate so
        ``wire_views`` can hand each to a vectored write with no join
        copy. Anything that needs the flat payload (``data``,
        ``as_array``) materializes it lazily — once."""
        blob = cls.__new__(cls)
        blob._data = None
        blob._lease = None
        norm = []
        for part in parts:
            if isinstance(part, np.ndarray):
                norm.append(np.ascontiguousarray(part)
                            .view(np.uint8).reshape(-1))
            else:
                norm.append(np.frombuffer(part, dtype=np.uint8))
        blob._parts = norm
        return blob

    @classmethod
    def from_lease(cls, view: np.ndarray, lease: Any) -> "Blob":
        """Pool-backed blob: ``view`` is a (read-only) uint8 view into a
        leased receive-frame buffer; the blob keeps ``lease`` alive so
        the frame cannot be recycled under it (util/buffer_pool.py)."""
        blob = cls.__new__(cls)
        blob._data = view
        blob._parts = None
        blob._lease = lease
        return blob

    @property
    def data(self) -> Any:
        if self._parts is not None:
            self._materialize_parts()
        return self._data

    @property
    def pool_backed(self) -> bool:
        """True while the payload views a pooled receive frame (and is
        therefore read-only; see ``materialize``)."""
        return self._lease is not None

    def _materialize_parts(self) -> None:
        parts = self._parts
        self._data = parts[0] if len(parts) == 1 \
            else np.concatenate(parts)
        self._parts = None

    @property
    def on_device(self) -> bool:
        """True when the payload is a tensor (``is_device_array``) that has
        not been materialized to host bytes. Device blobs flow through the PS
        stack with zero host copies."""
        return self._parts is None and is_device_array(self._data)

    def typed(self, dtype=np.float32) -> Any:
        """Typed payload without forcing a host transfer: the device array
        itself when on device, else the host view."""
        return self._data if self.on_device else self.as_array(dtype)

    def _host(self) -> np.ndarray:
        if self._parts is not None:
            self._materialize_parts()
        if not isinstance(self._data, np.ndarray):
            self._data = _host_array(self._data)
        return self._data

    @property
    def size(self) -> int:
        """Size in bytes (the reference's ``size()``). Computed from
        shape/dtype for device payloads — materializing here would silently
        defeat the zero-copy device path — and summed over pending parts
        for scatter-gather blobs."""
        if self._parts is not None:
            return sum(p.nbytes for p in self._parts)
        if self.on_device:
            return self._data.numel() * self._data.element_size()
        return self._host().nbytes

    def count(self, dtype=np.float32) -> int:
        """Element count under a typed view (the reference's ``size<T>()``)."""
        return self.size // np.dtype(dtype).itemsize

    def as_array(self, dtype=np.float32) -> np.ndarray:
        """Typed zero-copy view (the reference's ``As<T>``). Pool-backed
        payloads yield READ-ONLY views — ``materialize()`` first for a
        writable private copy (the copy-on-write contract,
        docs/MEMORY.md)."""
        arr = self._host()
        if arr.dtype == np.dtype(dtype) and arr.ndim == 1:
            return arr
        return arr.reshape(-1).view(dtype)

    def materialize(self) -> "Blob":
        """Copy-on-write escape hatch: replace a pool-backed (or
        otherwise read-only) payload with a private writable copy and
        drop the frame lease, so the buffer can recycle. The few wire
        consumers that mutate a received payload in place call this
        once; everything else reads through the zero-copy view."""
        arr = self._host()
        if self._lease is not None or not arr.flags.writeable:
            self._data = arr.copy()
        self._lease = None
        return self

    def wire_bytes(self) -> np.ndarray:
        """Flat uint8 view of the payload for wire serialization
        (materializes device arrays — this IS the host boundary). The
        single place the byte layout of an outgoing blob is defined:
        the TCP framer and the wire-codec filter both read through it,
        so a filtered and an unfiltered serialization path cannot
        disagree on what the raw bytes are."""
        arr = _host_array(self.data)
        return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)

    def wire_views(self) -> List[memoryview]:
        """The payload as buffer views for scatter-gather serialization
        (``tcp.serialize_views``): one view per pending part — never
        joined — or a single view of the flat payload. Zero-copy for
        host payloads; device arrays materialize exactly as in
        ``wire_bytes``."""
        if self._parts is not None:
            return [memoryview(p) for p in self._parts]
        return [memoryview(self.wire_bytes())]

    def __getitem__(self, i: int) -> int:
        return int(self._host().reshape(-1).view(np.uint8)[i])

    def copy(self) -> "Blob":
        """Deep copy (the reference's CopyFrom)."""
        return Blob(self._host().copy())

    def __len__(self) -> int:
        return self.size


def typed_blob(arr: np.ndarray) -> Blob:
    """Wrap a typed array as a Blob without byte-flattening."""
    return Blob(np.ascontiguousarray(arr))
