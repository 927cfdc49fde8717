"""K5 banded_cbow_grad: the CBOW negative-sampling step of the local
word2vec pipeline, in banded form.

Replaces ``_banded_cbow_loss_and_grads`` (``multiverso_tpu/models/
wordembedding/device_train.py:159-193``) as ``_apply_step(cbow=True)``
(``:211-221``) drives it. Inputs: the band's INPUT rows ``u_band``
[C+2W, D], the OUTPUT rows ``u_out`` = [centers (C) | block-shared
negatives (C/B*K)] [., D] and the pair mask ``pmask`` [C, 2W]. The
masked mean of each center's window rows predicts the center (label 1)
and its block's K negatives (label 0); loss and gradients are masked by
``has_ctx`` (the center has a valid context). Outputs ``scale * grad``
for both row sets (``scale = -lr``), the loss and the example count
(centers with a context).

On a CUDA tensor the wrapper launches the kernel (``csrc/
banded_cbow.cu``; bound by bytes: ~45 MB of rows a step at full width,
two launches, no atomics) or raises; on a CPU tensor it runs the plain
version. ``banded_cbow_grad.launches`` counts wrapper calls that
launched the kernel.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .objective import (MAX_EXP, band_sum, clip_grad, offsets, xent,
                        xent_grad)


def window_mean(u_band: torch.Tensor, pmask: torch.Tensor, W: int):
    """(masked window mean vmean [C, D], has_ctx [C], denom [C]) as the
    reference forms them: ``acc / max(nvalid, 1)``."""
    C = pmask.shape[0]
    nvalid = pmask.sum(dim=1)
    acc = torch.zeros((C, u_band.shape[1]), dtype=u_band.dtype,
                      device=u_band.device)
    for j, off in enumerate(offsets(W)):
        acc = acc + pmask[:, j:j + 1] * u_band[W + off:W + off + C]
    denom = torch.clamp(nvalid, min=1.0)
    return acc / denom[:, None], (nvalid > 0).to(u_band.dtype), denom


def banded_cbow_grad_plain(u_band: torch.Tensor, u_out: torch.Tensor,
                           pmask: torch.Tensor, W: int, K: int, B: int,
                           scale: float):
    """Plain version of K5: (d_band, d_out, loss, examples)."""
    C = pmask.shape[0]
    D = u_band.shape[1]
    nb = C // B
    u_center = u_out[:C]
    u_neg = u_out[C:].reshape(nb, K, D)
    vmean, has_ctx, denom = window_mean(u_band, pmask, W)
    pos_raw = (vmean * u_center).sum(-1)
    vb = vmean.reshape(nb, B, D)
    neg_raw = torch.einsum("nbd,nkd->nbk", vb, u_neg)
    pos = torch.clamp(pos_raw, -MAX_EXP, MAX_EXP)
    neg = torch.clamp(neg_raw, -MAX_EXP, MAX_EXP)
    hc = has_ctx.reshape(nb, B, 1)
    loss = (xent(pos, 1.0) * has_ctx).sum() + (xent(neg, 0.0) * hc).sum()
    gpos = xent_grad(pos, 1.0) * clip_grad(pos_raw) * has_ctx
    gneg = xent_grad(neg, 0.0) * clip_grad(neg_raw) * hc
    g_vmean = gpos[:, None] * u_center + torch.einsum(
        "nbk,nkd->nbd", gneg, u_neg).reshape(C, D)
    g_center = gpos[:, None] * vmean
    g_neg = torch.einsum("nbk,nbd->nkd", gneg, vb).reshape(nb * K, D)
    g_band = band_sum(pmask, g_vmean / denom[:, None], W)
    return (g_band * scale, torch.cat([g_center, g_neg]) * scale, loss,
            has_ctx.sum())


def banded_cbow_grad(u_band: torch.Tensor, u_out: torch.Tensor,
                     pmask: torch.Tensor, W: int, K: int, B: int,
                     scale: float):
    """K5 on float32 ``u_band`` [C+2W, D], ``u_out`` [C+C/B*K, D] and
    ``pmask`` [C, 2W]: returns (d_band like u_band, d_out like u_out,
    loss 0-d, examples 0-d)."""
    C = pmask.shape[0]
    D = u_band.shape[1]
    if C % B:
        raise ValueError(f"neg_block {B} must divide {C} centers")
    nb = C // B
    if tuple(pmask.shape) != (C, 2 * W):
        raise ValueError(f"pmask {tuple(pmask.shape)}: expected "
                         f"({C}, {2 * W})")
    if tuple(u_band.shape) != (C + 2 * W, D):
        raise ValueError(f"u_band {tuple(u_band.shape)}: expected "
                         f"({C + 2 * W}, {D})")
    if tuple(u_out.shape) != (C + nb * K, D):
        raise ValueError(f"u_out {tuple(u_out.shape)}: expected "
                         f"({C + nb * K}, {D})")
    if is_plain(u_band):
        return banded_cbow_grad_plain(u_band, u_out, pmask, W, K, B, scale)
    dev = u_band.device
    require(u_band, "u_band", torch.float32, dev, 2)
    require(u_out, "u_out", torch.float32, dev, 2)
    require(pmask, "pmask", torch.float32, dev, 2)
    d_band = torch.empty_like(u_band)
    d_out = torch.empty_like(u_out)
    gacc = torch.empty((C, D), dtype=torch.float32, device=dev)
    parts = torch.empty(2 * nb + 2, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.mv_banded_cbow_grad(
        u_band.data_ptr(), u_out.data_ptr(), pmask.data_ptr(), C, W, K, B,
        D, float(scale), d_band.data_ptr(), d_out.data_ptr(),
        gacc.data_ptr(), parts.data_ptr(), parts[nb:].data_ptr(),
        parts[2 * nb:].data_ptr(), parts[2 * nb + 1:].data_ptr(),
        stream_of(u_band)), "banded_cbow_grad")
    banded_cbow_grad.launches += 1
    return d_band, d_out, parts[2 * nb], parts[2 * nb + 1]


banded_cbow_grad.launches = 0
