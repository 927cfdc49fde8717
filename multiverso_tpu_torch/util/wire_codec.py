"""Compact quantized wire codec for PS / model-average traffic.

Replaces the float64 (index, value) pair encoding of the original
``SparseFilter`` (which spent 16 bytes per surviving pair and only broke
even below 50% density) with a compact self-describing frame:

    [24-byte header][payload]

    offset  size  field
    0       2     magic  b"MV"
    2       1     version (1)
    3       1     tier
    4       1     original dtype code (see _DTYPES)
    5       1     index encoding (sparse tiers: 0 = absolute int32,
                  1 = u32 first index + u16 gaps — SparCML-style
                  delta-compressed index stream)
    6       2     quantization chunk size (u16; int8 tiers)
    8       8     n    — original element count (u64)
    16      8     nnz  — stored element count (u64; == n for dense tiers)

Tiers (SparCML-style sparse index + value streams; EQuARX-style
quantized values). Per-pair cost shown with absolute / gap indices:

    RAW        (0)  original bytes verbatim, any dtype
    SPARSE_F32 (1)  idx[nnz] + float32 val[nnz]      (lossless, 8 / 6 B)
    SPARSE_F16 (2)  idx[nnz] + float16 val[nnz]      (lossy,    6 / 4 B)
    SPARSE_I8  (3)  idx[nnz] + f32 scale/chunk + i8  (lossy,   ~5 / 3 B)
    DENSE_F16  (4)  float16 val[n]                    (lossy)
    DENSE_I8   (5)  f32 scale/chunk + int8 val[n]     (lossy)

Tier selection is per blob: among the tiers the caller allows (lossless
only by default), pick the smallest wire size, breaking ties toward
higher fidelity. fp16 tiers are only eligible when the blob's magnitudes
fit fp16's normal range (no overflow to inf, no flush of the largest
values); int8 tiers only when the per-blob dynamic range is modest enough
that a per-chunk scale keeps quantization noise below ~1% of the chunk
max. Lossy encodes return an error-feedback residual (``OneBitFilter``
convention: the caller folds it into the next delta), so quantization
noise averages out over steps instead of accumulating.

The message-level helpers (``encode_message``/``decode_message``) apply
the codec blob-by-blob as the transport filter stage: header slot
``CODEC_SLOT`` marks an encoded message, so frames are self-describing
on the wire and a receiver never guesses. Senders must still negotiate —
``encode_message`` is only called for peers that advertised
``CAP_WIRE_CODEC`` during registration (zoo/controller), so a peer
running without the codec keeps receiving plain frames.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .configure import (define_bool, define_double, get_flag,
                        register_tunable_hook)

define_bool("wire_codec", True,
            "advertise + apply the compact wire codec on cross-process "
            "transports (lossless tiers at the transport filter stage; "
            "negotiated per peer at registration)")
define_bool("wire_codec_lossy", False,
            "allow the int8/fp16 value tiers for sparse matrix Add "
            "traffic, with worker-side error-feedback residuals "
            "(pulls stay lossless)")
define_double("wire_codec_density", 0.5,
              "break-even density for the LOSSLESS sparse tier: float32 "
              "payloads whose nonzero fraction sits below this ride "
              "sparse index+value streams; denser ones pass through "
              "RAW. 0.5 is the wire-cost break-even for the worst-case "
              "absolute-int32 index stream (8 B/pair vs 4 B/element); "
              "lower it when encode CPU dominates a fast local wire, "
              "raise it (toward ~0.67) when the u16-gap stream (6 "
              "B/pair) is known to engage")


def _density_retuned(value) -> None:
    """``-wire_codec_density`` is read fresh per encoded frame
    (``break_even_density``), so a live retune needs no state rebind —
    the hook declares the handoff (TUNABLE_FLAGS contract) and logs
    the step for rank-local traceability (docs/AUTOTUNE.md)."""
    from . import log
    log.info("wire codec: -wire_codec_density retuned to %s (applies "
             "from the next encoded frame)", value)


register_tunable_hook("wire_codec_density", _density_retuned)

MAGIC = b"MV"
VERSION = 1
HEADER = struct.Struct("<2sBBBBHQQ")  # magic, ver, tier, dtype, idx, chunk, n, nnz
HEADER_BYTES = HEADER.size  # 24

# Index-stream encodings for the sparse tiers.
IDX_I32 = 0   # absolute int32 indices
IDX_GAP16 = 1  # u32 first index + u16 gaps (all gaps must fit 16 bits)

# Tier codes (wire-stable; new tiers append).
RAW = 0
SPARSE_F32 = 1
SPARSE_F16 = 2
SPARSE_I8 = 3
DENSE_F16 = 4
DENSE_I8 = 5

_TIER_NAMES = {RAW: "raw", SPARSE_F32: "sparse_f32", SPARSE_F16: "sparse_f16",
               SPARSE_I8: "sparse_i8", DENSE_F16: "dense_f16",
               DENSE_I8: "dense_i8"}

# Wire-stable dtype codes for the ORIGINAL array (decode restores it).
_DTYPES = [np.dtype(d) for d in (
    np.float32, np.float64, np.int32, np.int64, np.uint8, np.float16,
    np.int8, np.int16, np.uint16, np.uint32, np.uint64, np.bool_)]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}

_CHUNK = 256          # int8 quantization chunk (one fp32 scale per chunk)
_FP16_MAX = 65504.0   # largest finite fp16
# int8 eligibility: per-chunk scale gives a step of chunkmax/127; a blob
# whose magnitudes span more than this ratio would quantize its small
# values to zero outright (error feedback covers noise, not starvation).
_I8_MAX_DYNAMIC_RANGE = 1e4

# Message header slot marking a codec-encoded payload — single source
# of truth lives next to the header layout in core.message (slot 5 is
# the error flag; the reference leaves 5-7 unused, message.h:28-38);
# re-exported here because every codec caller already imports this
# module.
from ..core.message import CODEC_SLOT  # noqa: E402

# Capability bit advertised in the registration handshake.
CAP_WIRE_CODEC = 1


def tier_name(tier: int) -> str:
    return _TIER_NAMES.get(tier, f"tier{tier}")


def _dtype_code(dtype: np.dtype) -> Optional[int]:
    return _DTYPE_CODE.get(np.dtype(dtype))


def _quantize_i8(vals: np.ndarray, chunk: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chunk symmetric int8: q = round(v * 127 / chunkmax)."""
    n = vals.size
    nchunks = max((n + chunk - 1) // chunk, 1)
    padded = np.zeros(nchunks * chunk, np.float32)
    padded[:n] = vals
    mags = np.abs(padded).reshape(nchunks, chunk).max(axis=1)
    scales = (mags / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(padded.reshape(nchunks, chunk) / safe[:, None]),
                -127, 127).astype(np.int8)
    return q.reshape(-1)[:n], scales


def _dequantize_i8(q: np.ndarray, scales: np.ndarray, chunk: int) -> np.ndarray:
    n = q.size
    nchunks = scales.size
    padded = np.zeros(nchunks * chunk, np.int8)
    padded[:n] = q
    vals = padded.reshape(nchunks, chunk).astype(np.float32) * scales[:, None]
    return vals.reshape(-1)[:n]


def _fp16_fits(vals: np.ndarray) -> bool:
    if vals.size == 0:
        return True
    peak = float(np.max(np.abs(vals)))
    return np.isfinite(peak) and peak <= _FP16_MAX


def _i8_fits(vals: np.ndarray) -> bool:
    if vals.size == 0:
        return True
    mags = np.abs(vals[vals != 0])
    if mags.size == 0:
        return True
    peak = float(mags.max())
    return np.isfinite(peak) and peak / float(mags.min()) \
        <= _I8_MAX_DYNAMIC_RANGE


def encode_blob(arr, *, lossy: bool = False,
                clip: float = 0.0) -> Tuple[bytes, Optional[np.ndarray]]:
    """Encode one array into a flat codec frame (compat wrapper over
    ``encode_blob_views``; the transport filter stage uses the views
    form directly so the header/payload never get joined).

    Returns ``(frame_bytes, residual)``; ``residual`` is the fp32
    error-feedback vector (original - decoded) when a lossy tier was
    chosen, else None. Non-float32 arrays and empty arrays ride RAW.
    """
    parts, residual = encode_blob_views(arr, lossy=lossy, clip=clip)
    frame = b"".join(  # mvlint: ignore[copy-lint] - the FLAT form IS
        # this wrapper's contract (table-level codec frames, tests,
        # bench); the wire path rides the unjoined parts
        p if isinstance(p, (bytes, bytearray))
        else p.tobytes() for p in parts)  # mvlint: ignore[copy-lint]
    return frame, residual


def encode_blob_views(arr, *, lossy: bool = False,
                      clip: float = 0.0
                      ) -> Tuple[List, Optional[np.ndarray]]:
    """Encode one array into codec-frame PARTS: ``parts[0]`` is the
    24-byte header, the rest are the payload streams (index / scale /
    value arrays) in wire order — handed to ``Blob.from_parts`` so the
    scatter-gather framer writes each straight from its own memory
    instead of paying the old ``head + payload.tobytes()`` concat. For
    a RAW-tier float-dense payload the value stream is a zero-copy
    view of the caller's array. Joining the parts reproduces
    ``encode_blob``'s frame byte for byte."""
    arr = np.asarray(arr)
    flat = np.ascontiguousarray(arr).reshape(-1)
    dcode = _dtype_code(flat.dtype)
    if dcode is None:
        flat = flat.view(np.uint8)
        dcode = _DTYPE_CODE[np.dtype(np.uint8)]
    n = flat.size
    if flat.dtype != np.float32 or n == 0:
        head = HEADER.pack(MAGIC, VERSION, RAW, dcode, 0, 0, n, n)
        return [head, flat], None

    # Non-finite values MUST survive: NaN compares False against the
    # clip so a plain magnitude test would drop a diverging trainer's
    # NaN gradients and deliver zeros — masking the divergence and
    # desyncing remote state from local. (NaN also poisons the fp16/i8
    # eligibility checks below, so lossy tiers stay out too.)
    nonzero = (np.abs(flat) > clip) | ~np.isfinite(flat)
    nnz = int(np.count_nonzero(nonzero))
    # Sparse tiers cannot win at >= 80% density (cheapest is ~5 B/pair
    # vs 4 B/element raw), so skip the index-stream work entirely for
    # dense blobs — np.nonzero would allocate an int64 vector up to 2x
    # the payload just to throw it away.
    if nnz * 5 <= n * 4:
        idx = np.nonzero(nonzero)[0]
        # Index stream: u16 gaps when every gap fits (the common case
        # for power-law ML traffic — SparCML's insight), else absolute
        # int32.
        gaps = np.diff(idx)
        gap_ok = nnz > 0 and (gaps.size == 0 or int(gaps.max()) < 65536) \
            and int(idx[0]) < 2 ** 32
    else:
        idx = gaps = None
        gap_ok = False
    idx_enc = IDX_GAP16 if gap_ok else IDX_I32
    idx_bytes = (4 + 2 * (nnz - 1)) if gap_ok else 4 * nnz
    nchunks_d = max((n + _CHUNK - 1) // _CHUNK, 1)
    nchunks_s = max((nnz + _CHUNK - 1) // _CHUNK, 1)
    # (cost_bytes, fidelity_rank, tier): min cost wins, ties -> fidelity.
    candidates = [(n * 4, 0, RAW)]
    if idx is not None:
        candidates.append((idx_bytes + nnz * 4, 1, SPARSE_F32))
    if lossy:
        # Dense blobs skip the boolean-mask gather: the eligibility
        # checks ignore zeros anyway (fp16 looks at the max magnitude,
        # i8 excludes exact zeros), and flat[nonzero] would copy ~the
        # whole payload — the dominant encode cost for the allreduce
        # engine's dense model-average segments.
        vals = flat if idx is None else flat[idx]
        if _fp16_fits(vals):
            candidates.append((n * 2, 2, DENSE_F16))
            if idx is not None:
                candidates.append((idx_bytes + nnz * 2, 2, SPARSE_F16))
        if _i8_fits(vals):
            candidates.append((n + nchunks_d * 4, 3, DENSE_I8))
            if idx is not None:
                candidates.append((idx_bytes + nnz + nchunks_s * 4, 3,
                                   SPARSE_I8))
    _, _, tier = min(candidates)

    residual: Optional[np.ndarray] = None
    if tier == RAW:
        payload = [flat]  # zero-copy view: the dense fast path
        stored = n
        idx_enc = 0
    elif tier in (SPARSE_F32, SPARSE_F16, SPARSE_I8):
        vals = flat[idx]
        stored = nnz
        if idx_enc == IDX_GAP16:
            idx_stream = [np.asarray([idx[0]], np.uint32),
                          gaps.astype(np.uint16)]
        else:
            idx_stream = [idx.astype(np.int32)]
        if tier == SPARSE_F32:
            payload = idx_stream + [vals]
        elif tier == SPARSE_F16:
            half = vals.astype(np.float16)
            payload = idx_stream + [half]
            residual = np.zeros(n, np.float32)
            residual[idx] = vals - half.astype(np.float32)
        else:
            q, scales = _quantize_i8(vals, _CHUNK)
            payload = idx_stream + [scales, q]
            residual = np.zeros(n, np.float32)
            residual[idx] = vals - _dequantize_i8(q, scales, _CHUNK)
    elif tier == DENSE_F16:
        half = flat.astype(np.float16)
        payload = [half]
        stored = n
        idx_enc = 0
        residual = flat - half.astype(np.float32)
    else:  # DENSE_I8
        q, scales = _quantize_i8(flat, _CHUNK)
        payload = [scales, q]
        stored = n
        idx_enc = 0
        residual = flat - _dequantize_i8(q, scales, _CHUNK)
    head = HEADER.pack(MAGIC, VERSION, tier, dcode, idx_enc,
                       _CHUNK if tier in (SPARSE_I8, DENSE_I8) else 0,
                       n, stored)
    return [head] + payload, residual


def is_codec_frame(data) -> bool:
    """Structural sniff: does this buffer start with a valid codec
    header? Used by receivers whose peer MAY be running without the
    table-level codec (e.g. a cross-rank -sparse_compress mismatch) to
    fall back to the raw layout instead of raising into an actor loop.
    A raw float32 payload whose first bytes spell the magic+version is
    astronomically unlikely (a specific denormal pattern)."""
    buf = _as_bytes(data)
    if len(buf) < HEADER_BYTES:
        return False
    magic, version, tier, dcode, idx_enc, _, n, nnz = \
        HEADER.unpack_from(buf, 0)
    return (magic == MAGIC and version == VERSION
            and tier in _TIER_NAMES and dcode < len(_DTYPES)
            and idx_enc in (IDX_I32, IDX_GAP16) and nnz <= n)


def peek_tier(data) -> int:
    """Tier code of a codec frame (raises on a non-codec buffer)."""
    buf = _as_bytes(data)
    magic, version, tier, _, _, _, _, _ = HEADER.unpack_from(buf, 0)
    if magic != MAGIC or version != VERSION:
        raise ValueError("not a wire-codec frame")
    return tier


def _as_bytes(data) -> memoryview:
    if isinstance(data, np.ndarray):
        return memoryview(np.ascontiguousarray(data).view(np.uint8)
                          .reshape(-1))
    return memoryview(data)


def _validated_header(buf) -> Tuple[int, int, int, int, int, int]:
    """Unpack + validate one frame header; the single unpack site both
    decode paths share. Returns (tier, dcode, idx_enc, chunk, n, nnz)."""
    magic, version, tier, dcode, idx_enc, chunk, n, nnz = \
        HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError("wire codec: bad magic (not a codec frame)")
    if version != VERSION:
        raise ValueError(f"wire codec: unsupported version {version}")
    return tier, dcode, idx_enc, chunk, n, nnz


def decode_blob_sparse(data) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Sparse-stream view of one codec frame: ``(idx, vals)``.

    For the sparse tiers ``idx`` is the int64 index vector and ``vals``
    the float32 values, one per index — WITHOUT materializing the dense
    array. This is the collective merge path: an owner folds
    ``acc[idx] += vals`` in O(nnz) per incoming stream instead of the
    O(n) a dense decode + dense add would cost. For RAW / dense tiers
    ``idx`` is None and ``vals`` is the full flat payload (RAW keeps its
    original dtype; dense lossy tiers dequantize to float32).
    ``vals`` may be a read-only view into the frame buffer — callers
    must not mutate it (``decode_blob`` copies where its contract needs
    ownership)."""
    buf = _as_bytes(data)
    tier, dcode, idx_enc, chunk, n, nnz = _validated_header(buf)
    return _decode_streams(buf, tier, dcode, idx_enc, chunk, n, nnz)


def _decode_streams(buf, tier, dcode, idx_enc, chunk, n,
                    nnz) -> Tuple[Optional[np.ndarray], np.ndarray]:
    body = buf[HEADER_BYTES:]
    dtype = _DTYPES[dcode]
    if tier == RAW:
        return None, np.frombuffer(body, dtype, n)
    if tier == DENSE_F16:
        return None, np.frombuffer(body, np.float16, n).astype(np.float32)
    if tier == DENSE_I8:
        nchunks = max((n + chunk - 1) // chunk, 1)
        scales = np.frombuffer(body, np.float32, nchunks)
        q = np.frombuffer(body, np.int8, n, nchunks * 4)
        return None, _dequantize_i8(q, scales, chunk)
    if tier not in (SPARSE_F32, SPARSE_F16, SPARSE_I8):
        raise ValueError(f"wire codec: unknown tier {tier}")
    if idx_enc == IDX_GAP16:
        first = int(np.frombuffer(body, np.uint32, 1)[0])
        gaps = np.frombuffer(body, np.uint16, nnz - 1, 4)
        idx = np.empty(nnz, np.int64)
        idx[0] = first
        idx[1:] = first + np.cumsum(gaps.astype(np.int64))
        off = 4 + 2 * (nnz - 1)
    else:
        idx = np.frombuffer(body, np.int32, nnz)
        off = nnz * 4
    if tier == SPARSE_F32:
        vals = np.frombuffer(body, np.float32, nnz, off)
    elif tier == SPARSE_F16:
        vals = np.frombuffer(body, np.float16, nnz, off) \
            .astype(np.float32)
    else:
        nchunks = max((nnz + chunk - 1) // chunk, 1)
        scales = np.frombuffer(body, np.float32, nchunks, off)
        q = np.frombuffer(body, np.int8, nnz, off + nchunks * 4)
        vals = _dequantize_i8(q, scales, chunk)
    return idx, vals


def decode_blob(data) -> np.ndarray:
    """Decode one codec frame back to a flat array of its original dtype."""
    buf = _as_bytes(data)
    tier, dcode, idx_enc, chunk, n, nnz = _validated_header(buf)
    idx, vals = _decode_streams(buf, tier, dcode, idx_enc, chunk, n, nnz)
    dtype = _DTYPES[dcode]
    if idx is None:
        if tier == RAW:
            return vals.copy()  # the caller owns its decoded array
        return vals.astype(dtype, copy=False)
    full = np.zeros(n, np.float32)
    full[idx] = vals
    return full.astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# Message-level filter stage (used by the communicator + allreduce engine).
# ---------------------------------------------------------------------------

#: Below this total payload size, framing overhead + the density scan
#: cost more than the bytes they could save — the message passes through.
MIN_ENCODE_BYTES = 1024


def density_of(arr) -> float:
    """Nonzero fraction of a host array (0.0 for an empty one) — one
    cheap count_nonzero pass, the signal every sparse-vs-dense decision
    in the tree keys on (this filter gate, the allreduce engine's
    ``choose_algo``)."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return 0.0
    return float(np.count_nonzero(arr)) / arr.size


def break_even_density() -> float:
    """Density below which the LOSSLESS sparse tier beats RAW, as a
    wire-cost model: worst case the index stream is absolute int32
    (8 B/pair vs 4 B/element raw → 0.5); the common power-law case
    lands the u16-gap stream (6 B/pair → ~0.67). ``-wire_codec_density``
    (default 0.5, the conservative bound) is the canonical knob — the
    allreduce engine's sparse-tier switchover clamps its own cutoff to
    this value, so one flag moves every break-even decision."""
    return float(get_flag("wire_codec_density"))


def worth_encoding(arr: np.ndarray) -> bool:
    """Would the LOSSLESS codec actually shrink this host array? Only
    float32 payloads can land in a sub-RAW tier, and sparsity must pay
    for the index stream (``break_even_density``). The density pass
    spares dense traffic the full frame-copy round trip (encode +
    decode) that a RAW frame would cost for -24 bytes of 'savings'."""
    if arr.dtype != np.float32 or arr.nbytes < MIN_ENCODE_BYTES:
        return False
    return density_of(arr) < break_even_density()


def _compressible(blob) -> bool:
    """Message-filter gate: ``worth_encoding`` over a Blob (keys as
    uint8 views, option blobs, and table-level codec frames that are
    ALREADY compressed all sniff False by dtype)."""
    if blob.on_device:
        # Probing a device payload would transfer it host-side TWICE
        # (once here, once at serialize); let it pass through raw.
        return False
    dtype = getattr(blob.data, "dtype", None)
    if dtype is None or np.dtype(dtype) != np.float32:
        return False
    return worth_encoding(np.asarray(blob.data))


def encode_message(msg, *, lossy: bool = False) -> bool:
    """Encode a message's blobs in place (lossless tiers only by
    default) and mark header slot ``CODEC_SLOT``. Returns True when the
    message was encoded. Callers must have negotiated codec support with
    ``msg.dst`` first — an un-negotiated peer cannot decode the frame.
    Messages with no compressible blob pass through untouched."""
    from ..core.blob import Blob
    if not msg.data or msg.header[CODEC_SLOT]:
        return False
    if not any(_compressible(b) for b in msg.data):
        return False
    encoded: List = []
    for blob in msg.data:
        # Scatter-gather frames: header and payload streams stay
        # separate parts all the way to the vectored socket write
        # (tcp.serialize_views) — the old head+payload join copied
        # every encoded byte once more for nothing.
        parts, _ = encode_blob_views(np.asarray(blob.data), lossy=lossy)
        encoded.append(Blob.from_parts(parts))
    msg.data = encoded
    msg.header[CODEC_SLOT] = 1
    return True


def decode_message(msg) -> None:
    """Reverse ``encode_message`` (no-op unless the codec slot is set)."""
    from ..core.blob import Blob
    if not msg.header[CODEC_SLOT]:
        return
    msg.data = [Blob(decode_blob(b.data)) for b in msg.data]
    msg.header[CODEC_SLOT] = 0
