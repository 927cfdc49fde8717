"""K1 subsample_compact: per-epoch word2vec subsampling + stable
compaction of the device-resident corpus.

Replaces ``_prep`` (``multiverso_tpu/models/wordembedding/
device_train.py:61-73``): keep token t iff ``u[t] < keep[flat[t]]``;
kept tokens move to the front in corpus order, dropped tokens follow in
corpus order with sentence id -1; returns the kept count. The uniforms
``u`` come from the caller, so the kernel is deterministic.

On a CUDA tensor the wrapper launches the kernel (``csrc/
subsample_compact.cu``: block counts, one-block scan, stable write —
bound by bytes, ~20 bytes a token) or raises; on a CPU tensor it runs
the plain version. ``subsample_compact.launches`` counts wrapper calls
that launched the kernel (three CUDA launches each).
"""

from __future__ import annotations

import torch

from . import build
from ._launch import is_plain, require, stream_of

_TILE = 1024  # tokens per block (csrc/subsample_compact.cu kThreads)


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
    nblocks = max((n + _TILE - 1) // _TILE, 1)
    scratch = torch.empty(2 * nblocks + 1, dtype=torch.int32, device=dev)
    kept = torch.empty_like(flat)
    ksent = torch.empty_like(sent)
    lib = build.library()
    build.check(lib.mv_subsample_compact(
        flat.data_ptr(), sent.data_ptr(), keep.data_ptr(), u.data_ptr(), n,
        scratch.data_ptr(), scratch[nblocks:].data_ptr(),
        scratch[2 * nblocks:].data_ptr(), kept.data_ptr(), ksent.data_ptr(),
        stream_of(flat)), "subsample_compact")
    subsample_compact.launches += 1
    return kept, ksent, scratch[2 * nblocks]


subsample_compact.launches = 0
