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
banded_hs.cu``; bound by bytes: ~177 MB of path rows and gradients a
step at full width; no atomics) or raises; on a CPU tensor it runs the
plain version. ``.launches`` counts wrapper calls that launched a
kernel. K6 is one span kernel (then a one-warp launch that sums the
blocks' loss and pair counts in block order): a block owns S
consecutive centers and their band positions, streams the path rows of
its positions node by node through shared memory, and recomputes the
2W-center halo that its edge positions share with the block before, so
each path row crosses HBM about (S + 2W) / S times and nothing is summed
across blocks. ``span_geometry`` picks S and the block's warps,
``span_smem`` is the block's shared memory (``mv_hs_span_smem``). K7
is one span kernel too (then the same one-warp sum): a block owns S
centers (``cbow_span_geometry``), stages their windows' band rows once,
and a warp takes a center, reading its own path rows straight from HBM
in chunks of 8 nodes (a masked node's row is not read); the window
gradients stay in shared memory, and the 2W that a span's first band
positions need come from the span before by a handoff
(``_launch.handoff``), so each path row crosses HBM once
(``cbow_span_smem``, ``mv_hs_cbow_smem``).
"""

from __future__ import annotations

import torch

from . import build
from ._launch import (SMEM_LIMIT, cbow_span_floats, handoff, is_plain,
                      multiprocessors, require, round_up, stream_of)
from .cbow import window_mean
from .flush import flush as f
from .objective import (MAX_EXP, band_sum, dot, masked_grad, offsets,
                        sum_terms, xent)


#: Warps of K6 an SM holds at once: its 168 registers a thread at most
#: (``__maxnreg__``) leave room for 12 warps in the SM's 65,536.
WARPS_PER_SM = 12


def span_smem(S: int, W: int, D: int, L: int, warps: int) -> int:
    """Bytes of shared memory of one K6 block (``hs_span`` of
    ``csrc/banded_hs.cu``): the V rows of its S + 2W logits-centers
    rounded up to tiles of 8 (NC), two node buffers of NC path rows, the
    d_v accumulators, the coefficients by center and (for two nodes) by
    position, the pair mask, two slots a warp for the sums and the NC
    positions' codes at every node."""
    W2 = 2 * W
    NC, DP = round_up(S + W2, 8), round_up(D, 4)
    KS, OFF = round_up(W2 + 1, 4), (4 - W2 % 4) % 4
    GPW = round_up(NC + KS + OFF, 4)
    floats = 4 * NC * DP + KS * NC + 2 * KS * GPW + NC * W2 + 2 * warps \
        + NC * L
    return 4 * floats


def span_cost(C: int, W: int, D: int, L: int, sms: int, nt: int):
    """(waves, -S) of a K6 span of NT tiles, or None where it does not
    fit: the blocks run in waves of ``sms`` x (blocks an SM holds at
    once, by shared memory and by WARPS_PER_SM), a wave about as long
    as one block's walk over its tiles (NT / warps of them a warp): each
    warp's chain of dependent steps sets the pace, and blocks that share
    an SM hide theirs from one another."""
    S, warps = 8 * nt - 2 * W, min(nt, 8)
    if S < 1:
        return None
    smem = span_smem(S, W, D, L, warps)
    if smem > SMEM_LIMIT:
        return None
    resident = max(1, min(SMEM_LIMIT // smem, WARPS_PER_SM // warps))
    waves = -(-(-(-C // S)) // (sms * resident))
    return waves * -(-nt // warps), -S


def span_geometry(C: int, W: int, D: int, L: int, sms: int):
    """(S centers a block, warps a block) of K6 for C centers and paths
    of L nodes on a card of ``sms`` multiprocessors: blocks of NT tiles
    of 8 logits-centers (S = 8 NT - 2W: the owned centers and the halo
    of 2W), one warp a tile (NT <= 8) or 8 warps of NT / 8 tiles each;
    the NT of least ``span_cost``: the fewest waves, then the widest
    span (the least halo)."""
    best = None
    for nt in list(range(1, 8)) + list(range(8, 65, 8)):
        cost = span_cost(C, W, D, L, sms, nt)
        if cost is not None and (best is None or cost < best[0]):
            best = (cost, nt)
    if best is None:
        raise ValueError(f"K6: no span of window {W} fits rows of {D} "
                         f"floats in {SMEM_LIMIT} bytes of shared memory")
    nt = best[1]
    return 8 * nt - 2 * W, min(nt, 8)


def cbow_span_smem(S: int, W: int, D: int) -> int:
    """Bytes of shared memory of one K7 block: the CBOW span's
    (``cbow_span`` of ``csrc/w2v_common.cuh``, ``mv_hs_cbow_smem``)."""
    return 4 * cbow_span_floats(S, W, D)


def cbow_span_geometry(C: int, W: int, D: int, sms: int) -> int:
    """S centers a K7 span: 64 where that still gives two blocks an SM
    (``sms`` of them), else 32; at least 2W (the handoff takes the 2W
    centers before a span from the one span before) unless one span
    holds all C."""
    S = 64 if -(-C // 64) >= 2 * sms else 32
    S = min(max(S, 2 * W), C)
    if cbow_span_smem(S, W, D) > SMEM_LIMIT:
        raise ValueError(f"K7: a span of {S} centers (window {W}) of rows "
                         f"of {D} floats needs more than {SMEM_LIMIT} "
                         f"bytes of shared memory")
    return S


def _node_labels(path: torch.Tensor, code: torch.Tensor):
    """(node_ok, labels) as floats: a node counts where both its path id
    and its code are >= 0; its label is ``1 - code``."""
    ok = ((path >= 0) & (code >= 0)).to(torch.float32)
    return ok, 1.0 - code.to(torch.float32)


def banded_hs_sg_grad_plain(v: torch.Tensor, u_bp: torch.Tensor,
                            path_band: torch.Tensor,
                            code_band: torch.Tensor, pmask: torch.Tensor,
                            W: int, scale: float):
    """Plain version of K6: (d_v, d_bp, loss, pairs), every operation
    flushed (``objective``'s note)."""
    C, D = v.shape
    L = path_band.shape[1]
    v, u_bp = f(v), f(u_bp)
    u3 = u_bp.reshape(C + 2 * W, L, D)
    node_ok, labels_band = _node_labels(path_band, code_band)
    loss = torch.zeros((), dtype=v.dtype, device=v.device)
    g_v, g_bp = [], []
    for j, off in enumerate(offsets(W)):
        u_off = u3[W + off:W + off + C]
        mask = node_ok[W + off:W + off + C] * pmask[:, j:j + 1]
        labels = labels_band[W + off:W + off + C] * mask
        raw = dot(v[:, None], u_off, -1)
        logits = torch.clamp(raw, -MAX_EXP, MAX_EXP)
        loss = f(loss + f(f(xent(logits, labels) * mask).sum()))
        g = masked_grad(logits, raw, labels, mask)
        g_v.append(dot(g[..., None], u_off, 1))
        pad = torch.zeros_like(u3)
        pad[W + off:W + off + C] = f(g[:, :, None] * v[:, None, :])
        g_bp.append(pad)
    return (f(sum_terms(g_v) * scale),
            f(sum_terms(g_bp).reshape(-1, D) * scale), loss, pmask.sum())


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
    S, warps = span_geometry(C, W, D, L, multiprocessors(dev))
    blocks = -(-C // S)
    d_v = torch.empty_like(v)
    d_bp = torch.empty_like(u_bp)
    parts = torch.empty(2 * blocks + 2, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.mv_banded_hs_sg_grad(
        v.data_ptr(), u_bp.data_ptr(), path_band.data_ptr(),
        code_band.data_ptr(), pmask.data_ptr(), C, W, L, D, S, warps,
        float(scale), d_v.data_ptr(), d_bp.data_ptr(), parts.data_ptr(),
        parts[blocks:].data_ptr(), parts[2 * blocks:].data_ptr(),
        parts[2 * blocks + 1:].data_ptr(), stream_of(v)),
        "banded_hs_sg_grad")
    banded_hs_sg_grad.launches += 1
    return d_v, d_bp, parts[2 * blocks], parts[2 * blocks + 1]


banded_hs_sg_grad.launches = 0


def hs_cbow_grad_plain(u_band: torch.Tensor, u_path: torch.Tensor,
                       path: torch.Tensor, code: torch.Tensor,
                       pmask: torch.Tensor, W: int, scale: float):
    """Plain version of K7: (d_band, d_path, loss, examples), every
    operation flushed (``objective``'s note)."""
    C, L = path.shape
    D = u_band.shape[1]
    u_band, u_path = f(u_band), f(u_path)
    up = u_path.reshape(C, L, D)
    vmean, has_ctx, denom = window_mean(u_band, pmask, W)
    node_ok, labels = _node_labels(path, code)
    mask = node_ok * has_ctx[:, None]
    labels = labels * mask
    raw = dot(vmean[:, None], up, -1)
    logits = torch.clamp(raw, -MAX_EXP, MAX_EXP)
    loss = f(f(xent(logits, labels) * mask).sum())
    g = masked_grad(logits, raw, labels, mask)
    g_path = f(g[:, :, None] * vmean[:, None, :])
    g_acc = f(dot(g[..., None], up, 1) / denom[:, None])
    g_band = band_sum(pmask, g_acc, W)
    return (f(g_band * scale), f(g_path.reshape(C * L, D) * scale), loss,
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
    S = cbow_span_geometry(C, W, D, multiprocessors(dev))
    blocks = -(-C // S)
    d_band = torch.empty_like(u_band)
    d_path = torch.empty_like(u_path)
    parts = torch.empty(2 * blocks + 2, dtype=torch.float32, device=dev)
    halo = torch.empty(max(blocks - 1, 1) * 2 * W * D, dtype=torch.float32,
                       device=dev)
    ctr, flags = handoff(dev, blocks)
    lib = build.library()
    build.check(lib.mv_hs_cbow_grad(
        u_band.data_ptr(), u_path.data_ptr(), path.data_ptr(),
        code.data_ptr(), pmask.data_ptr(), C, W, L, D, S, float(scale),
        d_band.data_ptr(), d_path.data_ptr(), parts.data_ptr(),
        parts[blocks:].data_ptr(), ctr.data_ptr(), flags.data_ptr(),
        halo.data_ptr(), parts[2 * blocks:].data_ptr(),
        parts[2 * blocks + 1:].data_ptr(), stream_of(u_band)),
        "hs_cbow_grad")
    hs_cbow_grad.launches += 1
    return d_band, d_path, parts[2 * blocks], parts[2 * blocks + 1]


hs_cbow_grad.launches = 0
