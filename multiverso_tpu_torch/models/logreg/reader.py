"""Sample readers: libsvm-style text + binary sparse, with prefetch.

Copy of ``multiverso_tpu/models/logreg/reader.py`` on the port's
``bucket_size`` and ``thread_roles``; ``Batch``, ``make_batches``,
``_pack`` and ``PrefetchReader`` are unchanged, so both packages batch
a file bit for bit alike. Formats of the reference's threaded
``SampleReader`` (ref: Applications/LogisticRegression/src/reader.cpp,
data formats documented at configure.h:56-69):

- ``default``: text; dense = ``label v v v ...``, sparse = libsvm
  ``label k:v k:v ...``
- ``weight``: first column is ``label:weight``
- ``bsparse``: binary ``count(u64) label(i32) weight(f64) key(u64)...``

Instead of the reference's per-sample ring buffer, samples are batched
into fixed-shape minibatch arrays: dense batches are ``[B, input_size]``
matrices; sparse batches are padded ``[B, max_nnz]`` (keys, values)
pairs with key==input_size as padding (a real row of the weights, which
the padding's zero values leave unchanged). A background thread
prefetches the next batch while the current one trains (the reference's
async reader + the ``-pipeline`` overlap collapse into this).
"""

from __future__ import annotations

import struct
import queue as queue_mod
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ...io import StreamFactory, TextReader
from ...runtime import thread_roles
from ...updater.engine import bucket_size
from .config import Configure


class Sample:
    __slots__ = ("label", "weight", "keys", "values")

    def __init__(self, label: int, weight: float = 1.0,
                 keys: Optional[np.ndarray] = None,
                 values: Optional[np.ndarray] = None):
        self.label = label
        self.weight = weight
        self.keys = keys
        self.values = values


def parse_text_line(line: str, sparse: bool,
                    weighted: bool) -> Optional[Sample]:
    parts = line.split()
    if not parts:
        return None
    head = parts[0]
    if weighted:
        label_s, _, weight_s = head.partition(":")
        label, weight = int(float(label_s)), float(weight_s or 1.0)
    else:
        label, weight = int(float(head)), 1.0
    if sparse:
        keys, values = [], []
        for tok in parts[1:]:
            k, _, v = tok.partition(":")
            keys.append(int(k))
            values.append(float(v))
        return Sample(label, weight, np.asarray(keys, np.int64),
                      np.asarray(values, np.float32))
    values = np.asarray([float(v) for v in parts[1:]], np.float32)
    return Sample(label, weight, None, values)


def iter_samples(config: Configure, path: str) -> Iterator[Sample]:
    if config.reader_type == "bsparse":
        yield from _iter_bsparse(path)
        return
    weighted = config.reader_type == "weight"
    for one_path in path.split(";"):
        reader = TextReader(one_path)
        while True:
            line = reader.get_line()
            if line is None:
                break
            sample = parse_text_line(line, config.sparse, weighted)
            if sample is not None:
                yield sample
        reader.close()


def _iter_bsparse(path: str) -> Iterator[Sample]:
    """ref: configure.h:66-69 binary format."""
    for one_path in path.split(";"):
        with StreamFactory.get_stream(one_path, "r") as stream:
            while True:
                raw = stream.read(8)
                if len(raw) < 8:
                    break
                (count,) = struct.unpack("<Q", raw)
                label, weight = struct.unpack("<id", stream.read(12))
                keys = np.frombuffer(stream.read(8 * count), dtype="<u8")
                yield Sample(label, weight, keys.astype(np.int64),
                             np.ones(count, np.float32))


class Batch:
    """Fixed-shape minibatch. Dense: ``x [B, D]``. Sparse: padded
    ``keys [B, K]`` / ``values [B, K]`` with ``keys == input_size`` padding.
    ``count`` = real samples (rows beyond it are zero-weight padding)."""

    __slots__ = ("labels", "weights", "x", "keys", "values", "count")

    def __init__(self, labels, weights, x=None, keys=None, values=None,
                 count: int = 0):
        self.labels = labels
        self.weights = weights
        self.x = x
        self.keys = keys
        self.values = values
        self.count = count


def make_batches(config: Configure, samples: Iterator[Sample],
                 batch_size: Optional[int] = None) -> Iterator[Batch]:
    batch_size = batch_size or config.minibatch_size
    buf: List[Sample] = []
    for sample in samples:
        buf.append(sample)
        if len(buf) == batch_size:
            yield _pack(config, buf, batch_size)
            buf = []
    if buf:
        yield _pack(config, buf, batch_size)


def _pack(config: Configure, buf: List[Sample], batch_size: int) -> Batch:
    n = len(buf)
    labels = np.zeros(batch_size, np.int32)
    weights = np.zeros(batch_size, np.float32)  # padding rows weigh 0
    labels[:n] = [s.label for s in buf]
    weights[:n] = [s.weight for s in buf]
    if not config.sparse:
        x = np.zeros((batch_size, config.input_size), np.float32)
        for i, sample in enumerate(buf):
            x[i, :sample.values.size] = sample.values
        return Batch(labels, weights, x=x, count=n)
    max_nnz = bucket_size(max(s.keys.size for s in buf))
    keys = np.full((batch_size, max_nnz), config.input_size, np.int64)
    values = np.zeros((batch_size, max_nnz), np.float32)
    for i, sample in enumerate(buf):
        keys[i, :sample.keys.size] = sample.keys
        values[i, :sample.values.size] = sample.values
    return Batch(labels, weights, keys=keys, values=values, count=n)


class PrefetchReader:
    """Background-thread batch prefetcher (the reference's async
    SampleReader ring buffer, ref: reader.cpp; double-buffering like
    ASyncBuffer, ref: include/multiverso/util/async_buffer.h:11-116)."""

    def __init__(self, config: Configure, path: str, depth: int = 4):
        self._queue: "queue_mod.Queue[Optional[Batch]]" = \
            queue_mod.Queue(maxsize=depth)
        self._config = config
        self._path = path
        self._thread = thread_roles.spawn(
            thread_roles.BACKGROUND, target=self._fill,
            name="mv-logreg-prefetch")

    def _fill(self) -> None:
        try:
            for batch in make_batches(self._config,
                                      iter_samples(self._config, self._path)):
                self._queue.put(batch)
        finally:
            self._queue.put(None)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            yield batch
