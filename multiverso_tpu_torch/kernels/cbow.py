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
banded_cbow.cu``; bound by bytes: ~45 MB of rows a step at full width;
no float atomics) or raises; on a CPU tensor it runs the plain version.
``banded_cbow_grad.launches`` counts wrapper calls that launched the
kernel. The kernel is one span kernel (then a one-warp launch that sums
the spans' loss and example counts in span order): a block owns S
centers, a multiple of the negative block B (``span_geometry``), stages
their windows' band rows, their output rows and their negatives' rows
once, keeps each center's window gradient in shared memory and writes
every gradient row it owns once; the 2W window gradients its first band
positions need from the span before come by a handoff through a small
scratch (``_launch.handoff``), not through a ``[C, D]`` array.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import (SMEM_LIMIT, align4, cbow_span_floats, handoff,
                      is_plain, require, stream_of)
from .flush import flush as f
from .objective import (MAX_EXP, band_sum, dot, masked_grad, offsets,
                        sum_terms, xent)


def span_smem(S: int, W: int, K: int, B: int, D: int) -> int:
    """Bytes of shared memory of one K5 block (``ns_span`` of
    ``csrc/banded_cbow.cu``, ``mv_banded_cbow_smem``): the CBOW span's
    (``_launch.cbow_span_floats``), then its S / B * K negative rows and
    its centers' K negative coefficients."""
    neg = cbow_span_floats(S, W, D)
    return 4 * align4(neg + S // B * K * align4(D) + S * K)


#: Centers a K5 span aims at: a span's barrier phases are short and
#: latency-bound, so short spans keep more blocks in flight, while each
#: span hands 2W window gradients on (PERF.md §6 gives K5's times).
SPAN_TARGET = 24


def span_geometry(C: int, W: int, K: int, B: int, D: int) -> int:
    """S centers a K5 span: the least multiple of the negative block B
    that is at least SPAN_TARGET and at least 2W (the handoff takes the
    2W centers before a span from the one span before), or all C where
    that is fewer. C is a multiple of B."""
    S = min(B * -(-max(SPAN_TARGET, 2 * W) // B), C)
    if span_smem(S, W, K, B, D) > SMEM_LIMIT:
        raise ValueError(f"K5: a span of {S} centers (negative block {B}, "
                         f"window {W}, {K} negatives) of rows of {D} floats "
                         f"needs more than {SMEM_LIMIT} bytes of shared "
                         f"memory")
    return S


def window_mean(u_band: torch.Tensor, pmask: torch.Tensor, W: int):
    """(masked window mean vmean [C, D], has_ctx [C], denom [C]) as the
    reference forms them: ``acc / max(nvalid, 1)``, ``u_band`` flushed,
    every operation flushed."""
    C = pmask.shape[0]
    nvalid = pmask.sum(dim=1)
    # The reference's ``0.0 + ...`` is folded away by XLA: the sum starts
    # from its first term (a sum of -0 terms stays -0).
    acc = sum_terms([f(pmask[:, j:j + 1] * u_band[W + off:W + off + C])
                     for j, off in reversed(list(enumerate(offsets(W))))])
    denom = torch.clamp(nvalid, min=1.0)
    return f(acc / denom[:, None]), (nvalid > 0).to(u_band.dtype), denom


def banded_cbow_grad_plain(u_band: torch.Tensor, u_out: torch.Tensor,
                           pmask: torch.Tensor, W: int, K: int, B: int,
                           scale: float):
    """Plain version of K5: (d_band, d_out, loss, examples), every
    operation flushed (``objective``'s note)."""
    C = pmask.shape[0]
    D = u_band.shape[1]
    nb = C // B
    u_band, u_out = f(u_band), f(u_out)
    u_center = u_out[:C]
    u_neg = u_out[C:].reshape(nb, K, D)
    vmean, has_ctx, denom = window_mean(u_band, pmask, W)
    pos_raw = dot(vmean, u_center, -1)
    vb = vmean.reshape(nb, B, D)
    neg_raw = dot(vb[:, :, None], u_neg[:, None], -1)
    pos = torch.clamp(pos_raw, -MAX_EXP, MAX_EXP)
    neg = torch.clamp(neg_raw, -MAX_EXP, MAX_EXP)
    hc = has_ctx.reshape(nb, B, 1)
    loss = f(f(f(xent(pos, 1.0) * has_ctx).sum())
             + f(f(xent(neg, 0.0) * hc).sum()))
    gpos = masked_grad(pos, pos_raw, 1.0, has_ctx)
    gneg = masked_grad(neg, neg_raw, 0.0, hc)
    g_vmean = f(f(gpos[:, None] * u_center)
                + dot(gneg[..., None], u_neg[:, None], 2).reshape(C, D))
    g_center = f(gpos[:, None] * vmean)
    g_neg = dot(gneg[..., None], vb[:, :, None], 1).reshape(nb * K, D)
    g_band = band_sum(pmask, f(g_vmean / denom[:, None]), W)
    return (f(g_band * scale), f(torch.cat([g_center, g_neg]) * scale),
            loss, has_ctx.sum())


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
    if K + 1 > 32:
        raise ValueError(f"banded_cbow_grad takes at most 31 negatives, "
                         f"got {K}")
    S = span_geometry(C, W, K, B, D)
    blocks = -(-C // S)
    d_band = torch.empty_like(u_band)
    d_out = torch.empty_like(u_out)
    parts = torch.empty(2 * blocks + 2, dtype=torch.float32, device=dev)
    halo = torch.empty(max(blocks - 1, 1) * 2 * W * D, dtype=torch.float32,
                       device=dev)
    ctr, flags = handoff(dev, blocks)
    lib = build.library()
    build.check(lib.mv_banded_cbow_grad(
        u_band.data_ptr(), u_out.data_ptr(), pmask.data_ptr(), C, W, K, B,
        D, S, float(scale), d_band.data_ptr(), d_out.data_ptr(),
        parts.data_ptr(), parts[blocks:].data_ptr(), ctr.data_ptr(),
        flags.data_ptr(), halo.data_ptr(), parts[2 * blocks:].data_ptr(),
        parts[2 * blocks + 1:].data_ptr(), stream_of(u_band)),
        "banded_cbow_grad")
    banded_cbow_grad.launches += 1
    return d_band, d_out, parts[2 * blocks], parts[2 * blocks + 1]


banded_cbow_grad.launches = 0
