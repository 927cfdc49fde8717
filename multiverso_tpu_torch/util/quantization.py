"""Wire compression filters for sparse table traffic.

TPU-native equivalent of the reference's ``SparseFilter``
(ref: include/multiverso/util/quantization_util.h:25-158). Per payload blob:
if more than half of the values are within ``clip_value`` of zero, the blob
is rewritten as a compact codec frame (int32 indices + typed values — see
``multiverso_tpu.util.wire_codec``); a side "size record" carries the
original element count, with -1 meaning "left uncompressed". ``filter_in``
compresses an outgoing list of arrays, ``filter_out`` reverses it.

The reference encoded surviving pairs as float64 (16 bytes per pair,
break-even only below 50% density); that format is REMOVED — frames are
now int32 index + fp32 value (8 bytes per pair, lossless) or the codec's
quantized tiers when the caller opts into lossy transport.

The reference's ``OneBitsFilter`` is an empty stub
(quantization_util.h:160-161); here ``OneBitFilter`` implements the standard
1-bit SGD scheme (sign + per-blob scale, error feedback left to the caller)
as the functional completion of that stub.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import wire_codec

UNCOMPRESSED = -1


class SparseFilter:
    def __init__(self, clip_value: float = 0.0, lossy: bool = False):
        self._clip = float(clip_value)
        self._lossy = bool(lossy)
        #: Error-feedback residual of the last lossy ``filter_in`` (one
        #: entry per blob; None where the encoding was lossless). The
        #: caller folds it into the next delta, OneBitFilter-style.
        self.last_residuals: List[Optional[np.ndarray]] = []

    def filter_in(self, blobs: Sequence[np.ndarray]
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Compress each blob independently.

        Returns (compressed_blobs, size_record) where size_record[i] is the
        original element count if blob i was compressed, else UNCOMPRESSED.
        """
        out: List[np.ndarray] = []
        self.last_residuals = []
        sizes = np.empty(len(blobs), dtype=np.int64)
        for i, blob in enumerate(blobs):
            arr = np.asarray(blob)
            flat = arr.reshape(-1)
            nonzero = np.abs(flat) > self._clip
            n_keep = int(np.count_nonzero(nonzero))
            if flat.size > 0 and n_keep * 2 < flat.size:
                frame, residual = wire_codec.encode_blob(
                    flat, lossy=self._lossy, clip=self._clip)
                out.append(np.frombuffer(frame, np.uint8))
                self.last_residuals.append(residual)
                sizes[i] = flat.size
            else:
                out.append(flat)
                self.last_residuals.append(None)
                sizes[i] = UNCOMPRESSED
        return out, sizes

    def filter_out(self, blobs: Sequence[np.ndarray], size_record: np.ndarray,
                   dtype=np.float32) -> List[np.ndarray]:
        """Reverse ``filter_in``."""
        out: List[np.ndarray] = []
        for blob, size in zip(blobs, size_record):
            if size == UNCOMPRESSED:
                out.append(np.asarray(blob, dtype=dtype))
                continue
            full = wire_codec.decode_blob(np.asarray(blob))
            out.append(full.astype(dtype, copy=False))
        return out


class OneBitFilter:
    """1-bit quantization: sign bitmap + mean-magnitude scales per sign.

    Functional completion of the reference's empty ``OneBitsFilter`` stub
    (quantization_util.h:160-161). Encoding per blob: (packed sign bits,
    positive mean, negative mean, original size). Decoding reconstructs
    each element as the mean magnitude of its sign class. Error-feedback
    residual is returned to the caller to accumulate locally.
    """

    def encode(self, arr: np.ndarray):
        flat = np.asarray(arr, dtype=np.float32).reshape(-1)
        pos = flat > 0
        pos_mean = float(flat[pos].mean()) if pos.any() else 0.0
        neg = ~pos
        neg_mean = float(flat[neg].mean()) if neg.any() else 0.0
        bits = np.packbits(pos.astype(np.uint8))
        decoded = np.where(pos, pos_mean, neg_mean).astype(np.float32)
        residual = flat - decoded
        return (bits, pos_mean, neg_mean, flat.size), residual

    def decode(self, encoded) -> np.ndarray:
        bits, pos_mean, neg_mean, size = encoded
        pos = np.unpackbits(bits)[:size].astype(bool)
        return np.where(pos, np.float32(pos_mean), np.float32(neg_mean))
