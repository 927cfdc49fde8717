"""K17 segment_merge and K18 segment_split: the segmented PS pipeline's
reassembly and re-slicing (B11).

They replace the gathers and slices of ``_segmented_step_fn``
(``multiverso_tpu/models/wordembedding/device_train.py:877-920``). A
group's ids are sorted on the card (``order``: sorted position ->
position, ``inv`` its inverse) and cut at ``bounds`` ``[S + 1]`` into
one segment a server; segment s travels in a fixed capacity ``caps[s]``
(host ints, calibrated once), past the ids' end padded.

- ``segment_merge(parts, bounds, inv, caps)`` (K17): ``out[j] =
  parts[s][p - bounds[s]]`` for ``p = inv[j]``, s the owner of p
  (``bounds[s] <= p < bounds[s+1]``), when ``p - bounds[s] <
  caps[s]``; zeros otherwise (a segment past its capacity: the
  reference's zero buffer, where the last writer of a position is its
  owner).
- ``segment_split(src, order, bounds, caps, fill)`` (K18): ``seg[s][k] =
  src[order[bounds[s] + k]]`` for ``bounds[s] + k < n``, ``fill`` past
  n; the S segments are views of one buffer. Slack rows past
  ``bounds[s+1]`` are COPIED, as the reference's ``dynamic_slice``
  copies them (server s drops them: their ids are foreign to it). On
  int32 ids with ``fill`` the pad sentinel it cuts the sorted ids.

On a CUDA tensor each wrapper launches its kernel (``csrc/segments.cu``,
bound by bytes) or raises; on a CPU tensor it runs the plain version
beside it. ``segment_merge.launches`` and ``segment_split.launches``
count kernel launches. ``bounds`` is int32, ``order`` and ``inv`` int64
(``torch.sort``'s indices); no wrapper reads a device tensor back.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from . import build
from ._launch import is_plain, require, stream_of

#: The most segments (servers) one launch takes (``csrc/segments.cu``).
MAX_SEGMENTS = 16


def _starts(caps: Sequence[int]) -> List[int]:
    starts = [0]
    for cap in caps:
        starts.append(starts[-1] + int(cap))
    return starts


def _check(caps: Sequence[int], bounds: torch.Tensor) -> None:
    if not 1 <= len(caps) <= MAX_SEGMENTS:
        raise ValueError(f"{len(caps)} segments: 1 to {MAX_SEGMENTS}")
    if bounds.numel() != len(caps) + 1:
        raise ValueError(f"bounds {tuple(bounds.shape)} for {len(caps)} "
                         f"segments")


def segment_merge_plain(parts: Sequence[torch.Tensor], bounds: torch.Tensor,
                        inv: torch.Tensor, caps: Sequence[int]
                        ) -> torch.Tensor:
    """Plain version of K17: ``[n, d]`` from the per-server rows."""
    d = parts[0].shape[-1]
    p = inv.reshape(-1).to(torch.int64)
    # The owner of each sorted position: the last s with bounds[s] <= p.
    s = torch.searchsorted(bounds[1:-1].to(torch.int64).contiguous(), p,
                           right=True)
    local = p - bounds.to(torch.int64)[s]
    cap = torch.tensor([int(c) for c in caps], dtype=torch.int64,
                       device=p.device)[s]
    ok = local < cap
    start = torch.tensor(_starts(caps)[:-1], dtype=torch.int64,
                         device=p.device)[s]
    flat = torch.cat([part.reshape(-1, d) for part in parts])
    rows = flat[torch.where(ok, start + local, 0)]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                      device=rows.device))


def segment_merge(parts: Sequence[torch.Tensor], bounds: torch.Tensor,
                  inv: torch.Tensor, caps: Sequence[int]) -> torch.Tensor:
    """K17: the rows of the S per-server replies ``parts`` (``[caps[s],
    d]`` float32) back in the positions of the unsorted ids: ``[n, d]``,
    n = ``inv.numel()``."""
    _check(caps, bounds)
    if len(parts) != len(caps):
        raise ValueError(f"{len(parts)} parts for {len(caps)} segments")
    if is_plain(parts[0]):
        return segment_merge_plain(parts, bounds, inv, caps)
    dev = parts[0].device
    d = parts[0].shape[-1]
    for s, (part, cap) in enumerate(zip(parts, caps)):
        require(part, f"parts[{s}]", torch.float32, dev, 2)
        if tuple(part.shape) != (int(cap), d):
            raise ValueError(f"parts[{s}] {tuple(part.shape)}, expected "
                             f"({int(cap)}, {d})")
    require(bounds, "bounds", torch.int32, dev, 1)
    require(inv, "inv", torch.int64, dev, 1)
    n = inv.numel()
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    S = len(caps)
    ptrs = (ctypes.c_void_p * S)(*[p.data_ptr() for p in parts])
    caps_arr = (ctypes.c_int64 * S)(*[int(c) for c in caps])
    lib = build.library()
    build.check(lib.mv_segment_merge(
        ptrs, caps_arr, S, bounds.data_ptr(), inv.data_ptr(), n, d,
        out.data_ptr(), stream_of(out)), "segment_merge")
    segment_merge.launches += 1
    return out


segment_merge.launches = 0


def _fill_bits(fill, dtype: torch.dtype) -> int:
    """The 4-byte word ``fill`` stores as a ``dtype`` element."""
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    return int(np.array(fill, dtype=np_dtype).view(np.uint32))


def _views(buf: torch.Tensor, starts: List[int]
           ) -> List[torch.Tensor]:
    return [buf[a:b] for a, b in zip(starts[:-1], starts[1:])]


def segment_split_plain(src: torch.Tensor, order: torch.Tensor,
                        bounds: torch.Tensor, caps: Sequence[int],
                        fill=0) -> List[torch.Tensor]:
    """Plain version of K18: the S segments, views of one buffer."""
    n = order.numel()
    flat = src.reshape(n, -1)
    starts = _starts(caps)
    r = torch.arange(starts[-1], dtype=torch.int64, device=src.device)
    s = torch.searchsorted(torch.tensor(starts[1:-1], dtype=torch.int64,
                                        device=src.device), r, right=True)
    q = bounds.to(torch.int64)[s] + r - torch.tensor(
        starts[:-1], dtype=torch.int64, device=src.device)[s]
    ok = q < n
    rows = flat[order.to(torch.int64)[torch.where(ok, q, 0)]] if n else \
        torch.empty((starts[-1], flat.shape[1]), dtype=src.dtype,
                    device=src.device)
    buf = torch.where(ok[:, None], rows, torch.full(
        (), fill, dtype=src.dtype, device=src.device))
    if src.dim() == 1:
        buf = buf.reshape(-1)
    return _views(buf, starts)


def segment_split(src: torch.Tensor, order: torch.Tensor,
                  bounds: torch.Tensor, caps: Sequence[int],
                  fill=0) -> List[torch.Tensor]:
    """K18: cut ``src`` (``[n]`` int32 ids or ``[n, d]`` float32 rows, in
    the unsorted positions) in sorted order into S segments of
    ``caps[s]`` rows each, ``fill`` past the n-th sorted position; a list
    of S contiguous views of one new buffer."""
    _check(caps, bounds)
    if is_plain(src):
        return segment_split_plain(src, order, bounds, caps, fill)
    dev = src.device
    dtype = src.dtype
    if dtype not in (torch.int32, torch.float32):
        raise TypeError(f"src: dtype {dtype}, expected int32 or float32")
    require(src, "src", dtype, dev)
    require(order, "order", torch.int64, dev, 1)
    require(bounds, "bounds", torch.int32, dev, 1)
    n = order.numel()
    if src.dim() not in (1, 2) or src.shape[0] != n:
        raise ValueError(f"src {tuple(src.shape)} for {n} ids")
    d = 1 if src.dim() == 1 else src.shape[1]
    starts = _starts(caps)
    shape = (starts[-1],) if src.dim() == 1 else (starts[-1], d)
    buf = torch.empty(shape, dtype=dtype, device=dev)
    S = len(caps)
    caps_arr = (ctypes.c_int64 * S)(*[int(c) for c in caps])
    lib = build.library()
    build.check(lib.mv_segment_split(
        src.data_ptr(), n, d, order.data_ptr(), bounds.data_ptr(), S,
        caps_arr, _fill_bits(fill, dtype), buf.data_ptr(), stream_of(buf)),
        "segment_split")
    segment_split.launches += 1
    return _views(buf, starts)


segment_split.launches = 0
