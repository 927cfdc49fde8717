"""K9 pairlist_ns_grad and K10 pairlist_hs_grad: the host-batch word2vec
step over explicit per-pair row lists.

Both replace the objective of the reference's host-batch trainer:
``Word2Vec._compact_loss`` (``multiverso_tpu/models/wordembedding/
model.py:337-384``) as ``_build_ps_step`` (``:755-767``) differentiates
it, and ``_make_step_core`` (``:395-453``), which gathers the rows of
the whole tables by global id, takes the gradients of the gathered rows
and scatter-adds ``-lr`` times them back. Each kernel reads its rows BY
INDEX straight from the buffers it is given — the local path passes the
whole tables with global ids, the PS path the pulled row buffers with
slot maps — and returns the per-position gradient rows (times
``scale``), which K3 then scatter-adds at the same indices, so duplicate
rows sum as the reference's differentiated gather makes them sum.

The input side is the same in both: skip-gram takes ``in_idx`` [B] (the
center rows); CBOW takes ``in_idx`` [B, 2W] with ``win_mask`` [B, 2W]
(1 for a real context slot) and uses the masked mean over
``max(n, 1)`` slots; its input gradient is one row per window slot,
``mask * g_v / max(n, 1)`` ([B*2W, D]). A window with no context gives
exactly zero gradient and counts no example.

- K9 (negative sampling): each pair against its target row
  ``tgt_idx`` [B] (label 1) and the K rows ``neg_idx`` [B/nb, K] that
  its block of ``nb`` consecutive pairs shares (label 0). Output rows
  ``[targets (B) | negatives (B/nb*K)]``.
- K10 (hierarchical softmax): each pair against its target's Huffman
  path ``points_idx`` [B, L] with ``codes`` [B, L] (-1 padded); a node
  counts where ``code >= 0``, its label is ``1 - code``, and a padded
  node's output row is exactly zero. Output rows ``[B*L]``.

Pairs are masked by ``pair_mask`` [B]; logits are clipped at +-6 with
the gradient JAX's autodiff forms (ROADMAP C9, ``objective.py``). The
count is the masked pairs (skip-gram) or the masked windows with a
context (CBOW).

On a CUDA tensor each wrapper launches its kernel (``csrc/
pairlist_ns.cu``, ``csrc/pairlist_hs.cu``; bound by bytes: the rows the
pairs name are read once and every gradient row is written once; a warp
owns a negative block (K9) or a pair (K10), so no atomics) or raises; on
a CPU tensor it runs the plain version. ``.launches`` counts wrapper
calls that launched a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .objective import MAX_EXP, clip_grad, xent, xent_grad

_MAX_SMEM = 96 * 1024   # shared memory a block of warps may take


def _input_vec(ein: torch.Tensor, in_idx: torch.Tensor,
               win_mask: Optional[torch.Tensor]):
    """(v [B, D], denom [B] or None, has_ctx [B] float): the center rows,
    or the masked window mean ``sum(mask * rows) / max(n, 1)``."""
    D = ein.shape[1]
    if win_mask is None:
        v = ein.index_select(0, in_idx.to(torch.int64))
        return v, None, torch.ones(v.shape[0], dtype=v.dtype,
                                   device=v.device)
    B, W2 = in_idx.shape
    rows = ein.index_select(0, in_idx.reshape(-1).to(torch.int64))
    rows = rows.reshape(B, W2, D) * win_mask[:, :, None]
    n = win_mask.sum(dim=1)
    denom = torch.clamp(n, min=1.0)
    return rows.sum(dim=1) / denom[:, None], denom, (n > 0).to(ein.dtype)


def _input_grad(g_v: torch.Tensor, win_mask: Optional[torch.Tensor],
                denom: Optional[torch.Tensor], scale: float):
    """``scale`` times the gradient of each input position: [B, D]
    (skip-gram) or one row a window slot [B*2W, D] (CBOW)."""
    if win_mask is None:
        return g_v * scale
    g = g_v / denom[:, None]
    rows = g[:, None, :] * win_mask[:, :, None]
    return (rows * scale).reshape(-1, g_v.shape[1])


def pairlist_ns_grad_plain(ein, eout, in_idx, win_mask, tgt_idx, neg_idx,
                           pair_mask, scale: float):
    """Plain version of K9: (d_in, d_out, loss, count)."""
    D = ein.shape[1]
    B = tgt_idx.shape[0]
    NB, K = neg_idx.shape
    nb = B // NB
    v, denom, has_ctx = _input_vec(ein, in_idx, win_mask)
    u_t = eout.index_select(0, tgt_idx.to(torch.int64))
    u_n = eout.index_select(0, neg_idx.reshape(-1).to(torch.int64)
                            ).reshape(NB, K, D)
    vb = v.reshape(NB, nb, D)
    pos_raw = (v * u_t).sum(-1)
    neg_raw = torch.einsum("nbd,nkd->nbk", vb, u_n)
    pos = torch.clamp(pos_raw, -MAX_EXP, MAX_EXP)
    neg = torch.clamp(neg_raw, -MAX_EXP, MAX_EXP)
    mb = pair_mask.reshape(NB, nb, 1)
    loss = (xent(pos, 1.0) * pair_mask).sum() + (xent(neg, 0.0) * mb).sum()
    gpos = xent_grad(pos, 1.0) * clip_grad(pos_raw) * pair_mask
    gneg = xent_grad(neg, 0.0) * clip_grad(neg_raw) * mb
    g_v = gpos[:, None] * u_t + torch.einsum("nbk,nkd->nbd", gneg,
                                             u_n).reshape(B, D)
    g_t = gpos[:, None] * v
    g_n = torch.einsum("nbk,nbd->nkd", gneg, vb).reshape(NB * K, D)
    return (_input_grad(g_v, win_mask, denom, scale),
            torch.cat([g_t, g_n]) * scale, loss,
            (pair_mask * has_ctx).sum())


def pairlist_hs_grad_plain(ein, eout, in_idx, win_mask, points_idx, codes,
                           pair_mask, scale: float):
    """Plain version of K10: (d_in, d_out, loss, count)."""
    D = ein.shape[1]
    B, L = points_idx.shape
    v, denom, has_ctx = _input_vec(ein, in_idx, win_mask)
    u = eout.index_select(0, points_idx.reshape(-1).to(torch.int64)
                          ).reshape(B, L, D)
    mask = (codes >= 0).to(ein.dtype) * pair_mask[:, None]
    labels = (1.0 - codes.to(ein.dtype)) * mask
    raw = torch.einsum("bd,bld->bl", v, u)
    x = torch.clamp(raw, -MAX_EXP, MAX_EXP)
    loss = (xent(x, labels) * mask).sum()
    g = xent_grad(x, labels) * clip_grad(raw) * mask
    g_v = torch.einsum("bl,bld->bd", g, u)
    g_u = (g[:, :, None] * v[:, None, :]).reshape(B * L, D)
    return (_input_grad(g_v, win_mask, denom, scale), g_u * scale, loss,
            (pair_mask * has_ctx).sum())


def _check_inputs(ein, eout, in_idx, win_mask, pair_mask, B: int):
    """Shape checks shared by K9 and K10; returns 2W (0 for skip-gram)."""
    if ein.dim() != 2 or eout.dim() != 2 or ein.shape[1] != eout.shape[1]:
        raise ValueError(f"ein {tuple(ein.shape)} and eout "
                         f"{tuple(eout.shape)} need [R, D] of one width")
    if tuple(pair_mask.shape) != (B,):
        raise ValueError(f"pair_mask {tuple(pair_mask.shape)}: expected "
                         f"({B},)")
    if win_mask is None:
        if tuple(in_idx.shape) != (B,):
            raise ValueError(f"in_idx {tuple(in_idx.shape)}: expected "
                             f"({B},) for skip-gram")
        return 0
    if in_idx.dim() != 2 or in_idx.shape[0] != B \
            or tuple(win_mask.shape) != tuple(in_idx.shape):
        raise ValueError(f"CBOW in_idx {tuple(in_idx.shape)} and win_mask "
                         f"{tuple(win_mask.shape)} need [{B}, 2W]")
    return int(in_idx.shape[1])


def _require_all(ein, eout, in_idx, win_mask, pair_mask, ids):
    dev = ein.device
    require(ein, "ein", torch.float32, dev, 2)
    require(eout, "eout", torch.float32, dev, 2)
    require(in_idx, "in_idx", torch.int32, dev)
    require(pair_mask, "pair_mask", torch.float32, dev, 1)
    if win_mask is not None:
        require(win_mask, "win_mask", torch.float32, dev, 2)
    for name, t in ids:
        require(t, name, torch.int32, dev, 2)


def _warps_per_block(floats_per_warp: int) -> int:
    per_warp = 4 * floats_per_warp
    if per_warp > 227 * 1024:
        raise ValueError("a row of this width does not fit one warp's "
                         "shared memory")
    warps = 8
    while warps > 1 and warps * per_warp > _MAX_SMEM:
        warps //= 2
    return warps


def _outputs(ein, B: int, W2: int, n_out: int, warps: int, n_warps: int):
    dev, D = ein.device, ein.shape[1]
    d_in = torch.empty((B * max(W2, 1), D), dtype=torch.float32, device=dev)
    d_out = torch.empty((n_out, D), dtype=torch.float32, device=dev)
    blocks = max((n_warps + warps - 1) // warps, 1)
    parts = torch.empty(2 * blocks + 2, dtype=torch.float32, device=dev)
    return d_in, d_out, parts, blocks


def pairlist_ns_grad(ein: torch.Tensor, eout: torch.Tensor,
                     in_idx: torch.Tensor,
                     win_mask: Optional[torch.Tensor],
                     tgt_idx: torch.Tensor, neg_idx: torch.Tensor,
                     pair_mask: torch.Tensor, scale: float):
    """K9 on float32 row buffers ``ein`` [R_in, D] and ``eout`` [R_out,
    D]: int32 ``in_idx`` [B] (skip-gram, ``win_mask`` None) or [B, 2W]
    with float32 ``win_mask`` [B, 2W] (CBOW), int32 ``tgt_idx`` [B] and
    ``neg_idx`` [B/nb, K], float32 ``pair_mask`` [B]; every id in its
    buffer's range. Returns (d_in [B, D] or [B*2W, D], d_out
    [B + B/nb*K, D], loss 0-d, count 0-d)."""
    B = tgt_idx.shape[0]
    W2 = _check_inputs(ein, eout, in_idx, win_mask, pair_mask, B)
    if neg_idx.dim() != 2 or neg_idx.shape[0] < 1 \
            or B % neg_idx.shape[0]:
        raise ValueError(f"neg_idx {tuple(neg_idx.shape)}: expected "
                         f"[B/nb, K] with nb dividing B={B}")
    if is_plain(ein):
        return pairlist_ns_grad_plain(ein, eout, in_idx, win_mask, tgt_idx,
                                      neg_idx, pair_mask, scale)
    _require_all(ein, eout, in_idx, win_mask, pair_mask,
                 (("neg_idx", neg_idx),))
    require(tgt_idx, "tgt_idx", torch.int32, ein.device, 1)
    NB, K = neg_idx.shape
    D = ein.shape[1]
    warps = _warps_per_block(D + K * D + K + 1)
    d_in, d_out, parts, blocks = _outputs(ein, B, W2, B + NB * K, warps, NB)
    lib = build.library()
    build.check(lib.mv_pairlist_ns_grad(
        ein.data_ptr(), eout.data_ptr(), in_idx.data_ptr(),
        0 if win_mask is None else win_mask.data_ptr(), W2,
        tgt_idx.data_ptr(), neg_idx.data_ptr(), pair_mask.data_ptr(), B,
        B // NB, K, D, float(scale), warps, d_in.data_ptr(),
        d_out.data_ptr(), parts.data_ptr(), parts[blocks:].data_ptr(),
        parts[2 * blocks:].data_ptr(), parts[2 * blocks + 1:].data_ptr(),
        stream_of(ein)), "pairlist_ns_grad")
    pairlist_ns_grad.launches += 1
    return d_in, d_out, parts[2 * blocks], parts[2 * blocks + 1]


pairlist_ns_grad.launches = 0


def pairlist_hs_grad(ein: torch.Tensor, eout: torch.Tensor,
                     in_idx: torch.Tensor,
                     win_mask: Optional[torch.Tensor],
                     points_idx: torch.Tensor, codes: torch.Tensor,
                     pair_mask: torch.Tensor, scale: float):
    """K10 on float32 row buffers ``ein`` [R_in, D] and ``eout`` [R_out,
    D]: the input side as K9's, int32 ``points_idx`` [B, L] (rows of
    ``eout``, read only where the node counts) and ``codes`` [B, L]
    (-1 padded), float32 ``pair_mask`` [B]. Returns (d_in [B, D] or
    [B*2W, D], d_out [B*L, D], loss 0-d, count 0-d)."""
    if points_idx.dim() != 2 or tuple(codes.shape) != tuple(
            points_idx.shape):
        raise ValueError(f"points_idx {tuple(points_idx.shape)} and codes "
                         f"{tuple(codes.shape)} need one [B, L] shape")
    B, L = points_idx.shape
    W2 = _check_inputs(ein, eout, in_idx, win_mask, pair_mask, B)
    if is_plain(ein):
        return pairlist_hs_grad_plain(ein, eout, in_idx, win_mask,
                                      points_idx, codes, pair_mask, scale)
    _require_all(ein, eout, in_idx, win_mask, pair_mask,
                 (("points_idx", points_idx), ("codes", codes)))
    D = ein.shape[1]
    warps = _warps_per_block(2 * D)
    d_in, d_out, parts, blocks = _outputs(ein, B, W2, B * L, warps, B)
    lib = build.library()
    build.check(lib.mv_pairlist_hs_grad(
        ein.data_ptr(), eout.data_ptr(), in_idx.data_ptr(),
        0 if win_mask is None else win_mask.data_ptr(), W2,
        points_idx.data_ptr(), codes.data_ptr(), pair_mask.data_ptr(), B, L,
        D, float(scale), warps, d_in.data_ptr(), d_out.data_ptr(),
        parts.data_ptr(), parts[blocks:].data_ptr(),
        parts[2 * blocks:].data_ptr(), parts[2 * blocks + 1:].data_ptr(),
        stream_of(ein)), "pairlist_hs_grad")
    pairlist_hs_grad.launches += 1
    return d_in, d_out, parts[2 * blocks], parts[2 * blocks + 1]


pairlist_hs_grad.launches = 0
