"""K8 pair_offset_grad: one window offset's sub-step of the per-pair
skip-gram quality mode.

Replaces ``_pair_offset_loss_and_grads`` (``multiverso_tpu/models/
wordembedding/device_train.py:233-250``) as ``_seq_pair_step``
(``:253-285``) drives it: 2W sequential sub-steps, each against the live
tables. For C pairs (center rows ``v`` [C, D], the offset's context
OUTPUT rows and each pair's own K negatives, ``u`` = [contexts (C) |
negatives (C*K)] [., D], pair validity ``m`` [C]): sigmoid xent at
label 1 against the context and label 0 against the negatives, masked by
``m``. Outputs ``scale * grad`` for both row sets (``scale = -lr``), the
loss and the example count (the sum of ``m``).

On a CUDA tensor the wrapper launches the kernel (``csrc/
pair_offset.cu``; bound by bytes: ~15 MB of rows a sub-step at full
width; every output row is owned by one pair, no atomics; a one-block
second launch sums the loss and the count) or raises; on a CPU tensor it runs the
plain version. ``pair_offset_grad.launches`` counts wrapper calls that
launched the kernel.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .objective import MAX_EXP, clip_grad, xent, xent_grad

_PAIRS_PER_BLOCK = 8  # one warp a pair (csrc/pair_offset.cu kWarps)


def pair_offset_grad_plain(v: torch.Tensor, u: torch.Tensor,
                           m: torch.Tensor, K: int, scale: float):
    """Plain version of K8: (d_v, d_u, loss, examples)."""
    C, D = v.shape
    u_pos = u[:C]
    u_neg = u[C:].reshape(C, K, D)
    pos_raw = (v * u_pos).sum(-1)
    neg_raw = torch.einsum("cd,ckd->ck", v, u_neg)
    pos = torch.clamp(pos_raw, -MAX_EXP, MAX_EXP)
    neg = torch.clamp(neg_raw, -MAX_EXP, MAX_EXP)
    loss = (xent(pos, 1.0) * m).sum() + (xent(neg, 0.0) * m[:, None]).sum()
    gpos = xent_grad(pos, 1.0) * clip_grad(pos_raw) * m
    gneg = xent_grad(neg, 0.0) * clip_grad(neg_raw) * m[:, None]
    g_v = gpos[:, None] * u_pos + torch.einsum("ck,ckd->cd", gneg, u_neg)
    g_pos = gpos[:, None] * v
    g_neg = (gneg[:, :, None] * v[:, None, :]).reshape(C * K, D)
    return (g_v * scale, torch.cat([g_pos, g_neg]) * scale, loss,
            m.sum())


def pair_offset_grad(v: torch.Tensor, u: torch.Tensor, m: torch.Tensor,
                     K: int, scale: float):
    """K8 on float32 ``v`` [C, D], ``u`` [C+C*K, D] and ``m`` [C]:
    returns (d_v [C, D], d_u like u, loss 0-d, examples 0-d)."""
    C, D = v.shape
    if tuple(u.shape) != (C + C * K, D):
        raise ValueError(f"u {tuple(u.shape)}: expected ({C + C * K}, "
                         f"{D})")
    if tuple(m.shape) != (C,):
        raise ValueError(f"m {tuple(m.shape)}: expected ({C},)")
    if is_plain(v):
        return pair_offset_grad_plain(v, u, m, K, scale)
    dev = v.device
    require(v, "v", torch.float32, dev, 2)
    require(u, "u", torch.float32, dev, 2)
    require(m, "m", torch.float32, dev, 1)
    d_v = torch.empty_like(v)
    d_u = torch.empty_like(u)
    nparts = max((C + _PAIRS_PER_BLOCK - 1) // _PAIRS_PER_BLOCK, 1)
    parts = torch.empty(2 * nparts + 2, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.mv_pair_offset_grad(
        v.data_ptr(), u.data_ptr(), m.data_ptr(), C, K, D, float(scale),
        d_v.data_ptr(), d_u.data_ptr(), parts.data_ptr(),
        parts[nparts:].data_ptr(), parts[2 * nparts:].data_ptr(),
        parts[2 * nparts + 1:].data_ptr(), stream_of(v)),
        "pair_offset_grad")
    pair_offset_grad.launches += 1
    return d_v, d_u, parts[2 * nparts], parts[2 * nparts + 1]


pair_offset_grad.launches = 0
