"""K6 banded_hs_sg_grad and K7 hs_cbow_grad: the hierarchical-softmax
steps of the local word2vec pipeline.

K6 replaces ``_hs_sg_loss_and_grads`` (``multiverso_tpu/models/
wordembedding/device_train.py:316-347``): each center row against the
Huffman-path rows of its context words. The path rows are gathered once
per band position (``u_bp`` [(C+2W)*L, D], row ``p*L + l`` is node l of
band position p) and the 2W context logits come from shifted slices.
K7 replaces ``_hs_cbow_loss_and_grads`` (``:350-377``): the masked mean
of the window's INPUT rows against the center's own path rows
(``u_path`` [C*L, D]). Both as ``_group_fn_hs`` (``:381-416``) drives
them. Paths and codes are int32 [., L], padded with -1; a padded node
(gathered from row 0) has mask 0, so its gradient is exactly zero and
its scatter into row 0 adds nothing. Labels are ``1 - code``.

On a CUDA tensor each wrapper launches its kernel (``csrc/
banded_hs.cu``; bound by bytes: ~195 MB of path rows a step at full
width, two launches each, no atomics) or raises; on a CPU tensor it
runs the plain version. ``.launches`` counts wrapper calls that
launched a kernel.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .cbow import window_mean
from .objective import (MAX_EXP, band_sum, clip_grad, offsets, xent,
                        xent_grad)


def _node_labels(path: torch.Tensor, code: torch.Tensor):
    """(node_ok, labels) as floats: a node counts where both its path id
    and its code are >= 0; its label is ``1 - code``."""
    ok = ((path >= 0) & (code >= 0)).to(torch.float32)
    return ok, 1.0 - code.to(torch.float32)


def banded_hs_sg_grad_plain(v: torch.Tensor, u_bp: torch.Tensor,
                            path_band: torch.Tensor,
                            code_band: torch.Tensor, pmask: torch.Tensor,
                            W: int, scale: float):
    """Plain version of K6: (d_v, d_bp, loss, pairs)."""
    C, D = v.shape
    L = path_band.shape[1]
    u3 = u_bp.reshape(C + 2 * W, L, D)
    node_ok, labels_band = _node_labels(path_band, code_band)
    loss = torch.zeros((), dtype=v.dtype, device=v.device)
    g_v = torch.zeros_like(v)
    coef = torch.empty((C, 2 * W, L), dtype=v.dtype, device=v.device)
    for j, off in enumerate(offsets(W)):
        u_off = u3[W + off:W + off + C]
        mask = node_ok[W + off:W + off + C] * pmask[:, j:j + 1]
        labels = labels_band[W + off:W + off + C] * mask
        raw = torch.einsum("cd,cld->cl", v, u_off)
        logits = torch.clamp(raw, -MAX_EXP, MAX_EXP)
        loss = loss + (xent(logits, labels) * mask).sum()
        g = xent_grad(logits, labels) * clip_grad(raw) * mask
        g_v = g_v + torch.einsum("cl,cld->cd", g, u_off)
        coef[:, j] = g
    g_bp = torch.zeros_like(u3)
    for j, off in enumerate(offsets(W)):
        g_bp[W + off:W + off + C] += coef[:, j, :, None] * v[:, None, :]
    return g_v * scale, g_bp.reshape(-1, D) * scale, loss, pmask.sum()


def banded_hs_sg_grad(v: torch.Tensor, u_bp: torch.Tensor,
                      path_band: torch.Tensor, code_band: torch.Tensor,
                      pmask: torch.Tensor, W: int, scale: float):
    """K6 on float32 ``v`` [C, D], ``u_bp`` [(C+2W)*L, D], int32
    ``path_band``/``code_band`` [C+2W, L] and float32 ``pmask``
    [C, 2W]: returns (d_v [C, D], d_bp like u_bp, loss 0-d, pairs 0-d)."""
    C, D = v.shape
    if path_band.dim() != 2 or path_band.shape[0] != C + 2 * W:
        raise ValueError(f"path_band {tuple(path_band.shape)}: expected "
                         f"({C + 2 * W}, L)")
    L = path_band.shape[1]
    if tuple(code_band.shape) != tuple(path_band.shape):
        raise ValueError("code_band must match path_band")
    if tuple(u_bp.shape) != ((C + 2 * W) * L, D):
        raise ValueError(f"u_bp {tuple(u_bp.shape)}: expected "
                         f"({(C + 2 * W) * L}, {D})")
    if tuple(pmask.shape) != (C, 2 * W):
        raise ValueError(f"pmask {tuple(pmask.shape)}: expected "
                         f"({C}, {2 * W})")
    if is_plain(v):
        return banded_hs_sg_grad_plain(v, u_bp, path_band, code_band,
                                       pmask, W, scale)
    dev = v.device
    require(v, "v", torch.float32, dev, 2)
    require(u_bp, "u_bp", torch.float32, dev, 2)
    require(path_band, "path_band", torch.int32, dev, 2)
    require(code_band, "code_band", torch.int32, dev, 2)
    require(pmask, "pmask", torch.float32, dev, 2)
    d_v = torch.empty_like(v)
    d_bp = torch.empty_like(u_bp)
    coef = torch.empty((C, 2 * W, L), dtype=torch.float32, device=dev)
    parts = torch.empty(2 * C + 2, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.mv_banded_hs_sg_grad(
        v.data_ptr(), u_bp.data_ptr(), path_band.data_ptr(),
        code_band.data_ptr(), pmask.data_ptr(), C, W, L, D, float(scale),
        d_v.data_ptr(), d_bp.data_ptr(), coef.data_ptr(), parts.data_ptr(),
        parts[C:].data_ptr(), parts[2 * C:].data_ptr(),
        parts[2 * C + 1:].data_ptr(), stream_of(v)), "banded_hs_sg_grad")
    banded_hs_sg_grad.launches += 1
    return d_v, d_bp, parts[2 * C], parts[2 * C + 1]


banded_hs_sg_grad.launches = 0


def hs_cbow_grad_plain(u_band: torch.Tensor, u_path: torch.Tensor,
                       path: torch.Tensor, code: torch.Tensor,
                       pmask: torch.Tensor, W: int, scale: float):
    """Plain version of K7: (d_band, d_path, loss, examples)."""
    C, L = path.shape
    D = u_band.shape[1]
    up = u_path.reshape(C, L, D)
    vmean, has_ctx, denom = window_mean(u_band, pmask, W)
    node_ok, labels = _node_labels(path, code)
    mask = node_ok * has_ctx[:, None]
    labels = labels * mask
    raw = torch.einsum("cd,cld->cl", vmean, up)
    logits = torch.clamp(raw, -MAX_EXP, MAX_EXP)
    loss = (xent(logits, labels) * mask).sum()
    g = xent_grad(logits, labels) * clip_grad(raw) * mask
    g_path = g[:, :, None] * vmean[:, None, :]
    g_acc = torch.einsum("cl,cld->cd", g, up) / denom[:, None]
    g_band = band_sum(pmask, g_acc, W)
    return (g_band * scale, g_path.reshape(C * L, D) * scale, loss,
            has_ctx.sum())


def hs_cbow_grad(u_band: torch.Tensor, u_path: torch.Tensor,
                 path: torch.Tensor, code: torch.Tensor,
                 pmask: torch.Tensor, W: int, scale: float):
    """K7 on float32 ``u_band`` [C+2W, D], ``u_path`` [C*L, D], int32
    ``path``/``code`` [C, L] and float32 ``pmask`` [C, 2W]: returns
    (d_band like u_band, d_path like u_path, loss 0-d, examples 0-d)."""
    if path.dim() != 2:
        raise ValueError(f"path {tuple(path.shape)}: expected (C, L)")
    C, L = path.shape
    D = u_band.shape[1]
    if tuple(code.shape) != (C, L):
        raise ValueError("code must match path")
    if tuple(u_band.shape) != (C + 2 * W, D):
        raise ValueError(f"u_band {tuple(u_band.shape)}: expected "
                         f"({C + 2 * W}, {D})")
    if tuple(u_path.shape) != (C * L, D):
        raise ValueError(f"u_path {tuple(u_path.shape)}: expected "
                         f"({C * L}, {D})")
    if tuple(pmask.shape) != (C, 2 * W):
        raise ValueError(f"pmask {tuple(pmask.shape)}: expected "
                         f"({C}, {2 * W})")
    if is_plain(u_band):
        return hs_cbow_grad_plain(u_band, u_path, path, code, pmask, W,
                                  scale)
    dev = u_band.device
    require(u_band, "u_band", torch.float32, dev, 2)
    require(u_path, "u_path", torch.float32, dev, 2)
    require(path, "path", torch.int32, dev, 2)
    require(code, "code", torch.int32, dev, 2)
    require(pmask, "pmask", torch.float32, dev, 2)
    d_band = torch.empty_like(u_band)
    d_path = torch.empty_like(u_path)
    gacc = torch.empty((C, D), dtype=torch.float32, device=dev)
    parts = torch.empty(2 * C + 2, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.mv_hs_cbow_grad(
        u_band.data_ptr(), u_path.data_ptr(), path.data_ptr(),
        code.data_ptr(), pmask.data_ptr(), C, W, L, D, float(scale),
        d_band.data_ptr(), d_path.data_ptr(), gacc.data_ptr(),
        parts.data_ptr(), parts[C:].data_ptr(), parts[2 * C:].data_ptr(),
        parts[2 * C + 1:].data_ptr(), stream_of(u_band)), "hs_cbow_grad")
    hs_cbow_grad.launches += 1
    return d_band, d_path, parts[2 * C], parts[2 * C + 1]


hs_cbow_grad.launches = 0
