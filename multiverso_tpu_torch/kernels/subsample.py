"""K1 subsample_compact: per-epoch word2vec subsampling + stable
compaction of the device-resident corpus.

Replaces ``_prep`` (``multiverso_tpu/models/wordembedding/
device_train.py:61-73``): keep token t iff ``u[t] < keep[flat[t]]``;
kept tokens move to the front in corpus order, dropped tokens follow in
corpus order with sentence id -1; returns the kept count. The uniforms
``u`` come from the caller, so the kernel is deterministic.

On a CUDA tensor the wrapper launches the kernel (``csrc/
subsample_compact.cu``: tiles of ``TILE`` tokens read once, the kept
prefix from a decoupled look-back over per-tile status words, the kept
tokens written to their slots and the dropped ones to a list that a
second, light launch moves behind them — bound by bytes, 20 bytes a
token and 12 more a dropped one) or raises; on a CPU tensor it runs the
plain version.
``subsample_compact_tiled`` is the CPU model of the kernel's tiles,
look-back and two passes. ``subsample_compact.launches`` counts wrapper
calls that launched the kernel (two CUDA launches each).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import build
from ._launch import is_plain, multiprocessors, require, stream_of

#: Tokens a tile (``csrc/subsample_compact.cu`` ``kTile``).
TILE = 4096
#: Predecessors a look-back step reads (a warp).
WINDOW = 32
#: A status word's flags: the tile's own kept count, or its inclusive
#: prefix (``kAggregate``, ``kPrefix``).
AGGREGATE, PREFIX = 1, 2
#: Epochs a status buffer serves before it is cleared (30 bits).
_EPOCHS = 1 << 30


def subsample_compact_plain(flat: torch.Tensor, sent: torch.Tensor,
                            keep: torch.Tensor, u: torch.Tensor):
    """Plain version of K1: (kept, ksent, n_kept) with n_kept a 0-d
    int32 tensor."""
    mask = u < keep[flat.to(torch.int64)]
    order = torch.cat([torch.nonzero(mask).reshape(-1),
                       torch.nonzero(~mask).reshape(-1)])
    kept = flat[order]
    ksent = torch.where(mask[order], sent[order],
                        torch.full((), -1, dtype=sent.dtype,
                                   device=sent.device))
    return kept, ksent, mask.sum(dtype=torch.int32)


def tiles_of(n: int) -> int:
    """The kernel's tiles (its first launch's blocks) for ``n`` tokens,
    and its status words; its other scratch is ``n`` int32 for the
    dropped list."""
    return -(-n // TILE)


def look_back(status: List[Tuple[int, int]], tile: int) -> int:
    """The kept tokens before ``tile`` as the kernel's warp finds them
    (``look_back``), from the predecessors' status words ``(flag,
    count)``: windows of ``WINDOW`` tiles from ``tile - 1`` down, each
    summed up to its nearest ``PREFIX`` word (a tile before 0 reads as a
    prefix of 0), where the walk ends."""
    total = 0
    top = tile - 1
    while True:
        window = [status[at] if at >= 0 else (PREFIX, 0)
                  for at in range(top, top - WINDOW, -1)]
        stops = [i for i, (flag, _) in enumerate(window) if flag == PREFIX]
        stop = stops[0] if stops else WINDOW - 1
        total += sum(count for _, count in window[:stop + 1])
        if stops:
            return total
        top -= WINDOW


def subsample_compact_tiled(flat: torch.Tensor, sent: torch.Tensor,
                            keep: torch.Tensor, u: torch.Tensor,
                            seed: int = 0):
    """The kernel's bookkeeping on the CPU: each tile's kept count, its
    exclusive prefix by ``look_back`` over predecessors that have
    published either their count or their prefix (chosen from ``seed``),
    the kept tokens at their slots and the dropped ones listed at their
    rank among the dropped, then the second pass. Returns what
    ``subsample_compact`` does, plus the tiles' prefixes."""
    rng = np.random.default_rng(seed)
    n = flat.numel()
    mask = (u < keep[flat.to(torch.int64)]).numpy()
    kept = np.empty(n, np.int32)
    ksent = np.empty(n, np.int32)
    dropped = np.empty(n, np.int32)
    flat_np, sent_np = flat.numpy(), sent.numpy()
    status: List[Tuple[int, int]] = []
    inclusive = 0
    prefixes = []
    for tile in range(tiles_of(n)):
        lo, hi = tile * TILE, min((tile + 1) * TILE, n)
        m = mask[lo:hi]
        count = int(m.sum())
        before = 0 if tile == 0 else look_back(status, tile)
        inclusive += count
        status.append((PREFIX, inclusive) if rng.random() < 0.5
                      or tile == 0 else (AGGREGATE, count))
        prefixes.append(before)
        kept[before:before + count] = flat_np[lo:hi][m]
        ksent[before:before + count] = sent_np[lo:hi][m]
        first = lo - before
        dropped[first:first + (hi - lo) - count] = flat_np[lo:hi][~m]
    n_kept = inclusive
    kept[n_kept:] = dropped[:n - n_kept]
    ksent[n_kept:] = -1
    return (torch.from_numpy(kept), torch.from_numpy(ksent),
            torch.tensor(n_kept, dtype=torch.int32), prefixes)


_status = {}


def _status_words(device: torch.device, tiles: int):
    """(status words, epoch) for a launch on ``device``: a buffer kept
    per device, read by each call under a new epoch, so the words of an
    earlier call read as not ready (one stream at a time)."""
    words, epoch = _status.get(device, (None, _EPOCHS))
    if words is None or words.numel() < tiles or epoch + 1 >= _EPOCHS:
        words = torch.zeros(max(tiles, 2048), dtype=torch.int64,
                            device=device)
        epoch = 0
    epoch += 1
    _status[device] = (words, epoch)
    return words, epoch


def subsample_compact(flat: torch.Tensor, sent: torch.Tensor,
                      keep: torch.Tensor, u: torch.Tensor):
    """K1 on int32 ``flat``/``sent`` [T], float32 ``keep`` [V] and
    float32 ``u`` [T]: returns (kept [T], ksent [T], n_kept 0-d int32),
    all on the input's device."""
    if is_plain(flat):
        return subsample_compact_plain(flat, sent, keep, u)
    dev = flat.device
    require(flat, "flat", torch.int32, dev, 1)
    require(sent, "sent", torch.int32, dev, 1)
    require(keep, "keep", torch.float32, dev, 1)
    require(u, "u", torch.float32, dev, 1)
    n = flat.numel()
    if sent.numel() != n or u.numel() != n:
        raise ValueError("flat, sent and u must have one entry a token")
    if n >= 1 << 31:
        raise ValueError("K1 counts tokens in int32")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    words, epoch = _status_words(dev, tiles_of(n))
    dropped = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    n_kept = torch.empty((), dtype=torch.int32, device=dev)
    kept = torch.empty_like(flat)
    ksent = torch.empty_like(sent)
    lib = build.library()
    build.check(lib.mv_subsample_compact(
        flat.data_ptr(), sent.data_ptr(), keep.data_ptr(), u.data_ptr(), n,
        words.data_ptr(), epoch, dropped.data_ptr(), n_kept.data_ptr(),
        kept.data_ptr(), ksent.data_ptr(), multiprocessors(dev),
        stream_of(flat)),
        "subsample_compact")
    subsample_compact.launches += 1
    return kept, ksent, n_kept


subsample_compact.launches = 0
