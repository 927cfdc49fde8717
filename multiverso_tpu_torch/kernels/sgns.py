"""K4 banded_sgns_grad: the skip-gram negative-sampling step of the PS
word2vec pipeline, on pulled rows.

Replaces the objective of ``_block_step_fn`` (skip-gram, negative
sampling, ``per_pair=False``; ``multiverso_tpu/models/wordembedding/
device_train.py:729-788``) and ``_banded_sgns_loss_and_grads``
(``:131-156``). Inputs: the C pulled center rows ``v`` [C, D], the
pulled output rows ``u`` = [band (C+2W) | negatives (C/B*K)] [., D] and
the pair mask ``pmask`` [C, 2W]. Outputs ``scale * grad`` for both row
sets (the push deltas, ``scale = -lr / num_workers``), the loss and the
valid-pair count. Gradients follow JAX's: zero where a logit was
clipped past +-6 (one half exactly on the bound), the label-0 terms of
a center's block-shared negatives weighted by its valid-pair count.

On a CUDA tensor the wrapper launches the kernel (``csrc/
banded_sgns.cu``; bound by bytes: ~90 MB of rows a block at full
width; no atomics) or raises; on a CPU tensor it runs the plain
version. ``banded_sgns_grad.launches`` counts wrapper calls that
launched the kernel. The kernel is one span kernel (then a one-warp
launch that sums the blocks' loss and pair counts in block order): a
block owns S centers, a multiple of the negative block B, stages their
rows, the 2W halo centers', the band rows of its positions and its
negatives' rows once, and writes every gradient row it owns once
(``span_geometry``, ``span_smem``); two blocks share an SM, so one
stages while the other computes.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import SMEM_LIMIT, is_plain, require, round_up, stream_of
from .flush import flush as f
from .flush import fma
from .objective import (band_sum, band_sum_fused, eigen_dot, fma_sum,
                        gemv_dot, offsets, row_sum, sgns_loss, sgns_xent)


def span_smem(S: int, W: int, K: int, B: int, D: int, warps: int) -> int:
    """Bytes of shared memory of one K4 block (``sgns_span`` of
    ``csrc/banded_sgns.cu``): the V rows of its S + 2W logits-centers and
    the band rows of its positions, both rounded up to tiles of 8 (NC),
    its S / B * K negative rows, the positive coefficients by center and
    by position, the negative ones, the pair mask, the valid-pair counts
    and two slots a warp for the sums."""
    W2 = 2 * W
    NC, DP = round_up(S + W2, 8), round_up(D, 4)
    KS, OFF = round_up(W2 + 1, 4), (4 - W2 % 4) % 4
    GCW, GPW = round_up(NC + OFF + 8, 4), round_up(NC + KS + OFF, 4)
    SW = round_up(S, 8)
    floats = (2 * NC + S // B * K) * DP + KS * (GCW + GPW) \
        + round_up(K, 4) * SW + NC * W2 + SW + 2 * warps
    return 4 * floats


def span_geometry(C: int, W: int, K: int, B: int, D: int):
    """(S centers a block, warps a block) of K4: the largest multiple of
    the negative block B whose S + 2W logits-centers fill at most 8
    tiles of 8 (one a warp; at least one negative block a span) and
    whose shared memory fits. C is a multiple of B."""
    m = max(1, (64 - 2 * W) // B)
    while m >= 1:
        S = min(B * m, C)
        warps = min(-(-(S + 2 * W) // 8), 8)
        if span_smem(S, W, K, B, D, warps) <= SMEM_LIMIT:
            return S, warps
        m -= 1
    raise ValueError(f"K4: a span of one negative block ({B} centers, "
                     f"window {W}, {K} negatives) of rows of {D} floats "
                     f"needs more than {SMEM_LIMIT} bytes of shared memory")


def banded_sgns_grad_plain(v: torch.Tensor, u: torch.Tensor,
                           pmask: torch.Tensor, W: int, K: int, B: int,
                           scale: float, fused_band: bool = False):
    """Plain version of K4: (d_v, d_u, loss, pairs), every operation
    flushed (``objective``'s note), formed in the order of the
    reference's compiled block step (ROADMAP C2): the logits' sums as
    XLA's reduce (``row_sum``) and, for the negatives, its GEMV
    (``gemv_dot``, B = 1) or Eigen's contraction (``eigen_dot``); each
    cotangent and loss term as ``sgns_xent``, the loss summed as
    ``sgns_loss``; ``g_v`` from the negatives' fused sum over K, then
    each offset's product fused in from the last; ``g_neg`` a fused sum
    over the block's B centers (their product at B = 1).
    ``fused_band`` forms the band rows as ``_banded_sgns_loss_and_grads``'
    own program does at rows wider than 8 floats (``band_sum_fused``);
    the block step sums them as ``band_sum``."""
    C, D = v.shape
    nb = C // B
    offs = offsets(W)
    v, u = f(v), f(u)
    u_band = u[:C + 2 * W]
    u_neg = u[C + 2 * W:].reshape(nb, K, D)
    nvalid = pmask.sum(dim=1)
    pos_raw = row_sum(f(v[:, None] * torch.stack(
        [u_band[W + off:W + off + C] for off in offs], dim=1)))
    vb = v.reshape(nb, B, D)
    neg_dot = gemv_dot if B == 1 else eigen_dot
    neg_raw = neg_dot(vb[:, :, None], u_neg[:, None])
    # Both logits' cotangents and terms in one pass (label 1, then 0).
    n_pos = pos_raw.numel()
    cot, terms = sgns_xent(
        torch.cat([pos_raw.reshape(-1), neg_raw.reshape(-1)]),
        torch.cat([pmask.reshape(-1),
                   nvalid.reshape(nb, B, 1).expand(nb, B, K).reshape(-1)]),
        torch.cat([torch.ones_like(pos_raw.reshape(-1)),
                   torch.zeros_like(neg_raw.reshape(-1))]))
    gpos, gneg = cot[:n_pos].reshape(C, -1), cot[n_pos:].reshape(nb, B, K)
    loss = sgns_loss(terms[:n_pos].reshape(C, -1),
                     terms[n_pos:].reshape(nb, B, K), pmask, nvalid)
    g_v = fma_sum(gneg[..., None], u_neg[:, None], 2).reshape(C, D)
    for j in reversed(range(2 * W)):
        g_v = fma(gpos[:, j:j + 1].expand(C, D),
                  u_band[W + offs[j]:W + offs[j] + C], g_v)
    g_band = (band_sum_fused if fused_band and D > 8 else band_sum)(
        gpos, v, W)
    # over one center XLA's dot is the product itself
    g_neg = (f(gneg[..., None] * vb[:, :, None]) if B == 1 else
             fma_sum(gneg[..., None], vb[:, :, None], 1)).reshape(nb * K, D)
    d_u = f(torch.cat([g_band, g_neg]) * scale)
    return f(g_v * scale), d_u, loss, pmask.sum()


def banded_sgns_grad(v: torch.Tensor, u: torch.Tensor, pmask: torch.Tensor,
                     W: int, K: int, B: int, scale: float):
    """K4 on float32 ``v`` [C, D], ``u`` [C+2W+C/B*K, D] and ``pmask``
    [C, 2W]: returns (d_v [C, D], d_u like u, loss 0-d, pairs 0-d)."""
    C, D = v.shape
    if C % B:
        raise ValueError(f"neg_block {B} must divide {C} centers")
    nb = C // B
    if tuple(u.shape) != (C + 2 * W + nb * K, D):
        raise ValueError(f"u {tuple(u.shape)}: expected "
                         f"({C + 2 * W + nb * K}, {D})")
    if tuple(pmask.shape) != (C, 2 * W):
        raise ValueError(f"pmask {tuple(pmask.shape)}: expected "
                         f"({C}, {2 * W})")
    if is_plain(v):
        return banded_sgns_grad_plain(v, u, pmask, W, K, B, scale)
    dev = v.device
    require(v, "v", torch.float32, dev, 2)
    require(u, "u", torch.float32, dev, 2)
    require(pmask, "pmask", torch.float32, dev, 2)
    S, warps = span_geometry(C, W, K, B, D)
    blocks = -(-C // S)
    d_v = torch.empty_like(v)
    d_u = torch.empty_like(u)
    parts = torch.empty(2 * blocks + 2, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.mv_banded_sgns_grad(
        v.data_ptr(), u.data_ptr(), pmask.data_ptr(), C, W, K, B, D, S,
        warps, float(scale), d_v.data_ptr(), d_u.data_ptr(),
        parts.data_ptr(), parts[blocks:].data_ptr(),
        parts[2 * blocks:].data_ptr(), parts[2 * blocks + 1:].data_ptr(),
        stream_of(v)), "banded_sgns_grad")
    banded_sgns_grad.launches += 1
    return d_v, d_u, parts[2 * blocks], parts[2 * blocks + 1]


banded_sgns_grad.launches = 0
