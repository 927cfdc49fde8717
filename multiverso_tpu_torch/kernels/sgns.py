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
width, two launches, no atomics) or raises; on a CPU tensor it runs the
plain version. ``banded_sgns_grad.launches`` counts wrapper calls that
launched the kernel.
"""

from __future__ import annotations

from typing import List

import torch

from . import build
from ._launch import is_plain, require, stream_of

MAX_EXP = 6.0  # word2vec.c's sigmoid-table range (model.py _MAX_EXP)


def offsets(W: int) -> List[int]:
    return [o for o in range(-W, W + 1) if o != 0]


def clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of ``minimum(6, maximum(-6, x))`` as JAX differentiates it
    (ties split the gradient in halves)."""
    one, half, zero = (torch.tensor(v, dtype=x.dtype, device=x.device)
                       for v in (1.0, 0.5, 0.0))
    lo = torch.where(x > -MAX_EXP, one, torch.where(x == -MAX_EXP, half,
                                                    zero))
    m = torch.clamp(x, min=-MAX_EXP)
    hi = torch.where(m < MAX_EXP, one, torch.where(m == MAX_EXP, half,
                                                   zero))
    return lo * hi


def xent(x: torch.Tensor, y: float) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (model.py
    ``_sigmoid_xent``)."""
    return torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


def xent_grad(x: torch.Tensor, y: float) -> torch.Tensor:
    """d xent / dx as JAX's autodiff forms it: 1/2 for ``max(x, 0)`` at
    x == 0 and d|x|/dx = 1 at x == 0, so the gradient at exactly 0 is
    -y (not sigmoid(0) - y) — which is what every logit against the
    zero-initialized output table gives."""
    e = torch.exp(-x.abs())
    relu = torch.where(x > 0, torch.ones_like(x),
                       torch.where(x == 0, torch.full_like(x, 0.5),
                                   torch.zeros_like(x)))
    sgn = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    return relu - y - sgn * (e / (1.0 + e))


def banded_sgns_grad_plain(v: torch.Tensor, u: torch.Tensor,
                           pmask: torch.Tensor, W: int, K: int, B: int,
                           scale: float):
    """Plain version of K4: (d_v, d_u, loss, pairs)."""
    C, D = v.shape
    nb = C // B
    offs = offsets(W)
    u_band = u[:C + 2 * W]
    u_neg = u[C + 2 * W:].reshape(nb, K, D)
    nvalid = pmask.sum(dim=1)
    pos_raw = torch.stack(
        [(v * u_band[W + off:W + off + C]).sum(-1) for off in offs], dim=1)
    vb = v.reshape(nb, B, D)
    neg_raw = torch.einsum("nbd,nkd->nbk", vb, u_neg)
    pos = torch.clamp(pos_raw, -MAX_EXP, MAX_EXP)
    neg = torch.clamp(neg_raw, -MAX_EXP, MAX_EXP)
    nw = nvalid.reshape(nb, B, 1)
    loss = (xent(pos, 1.0) * pmask).sum() + (xent(neg, 0.0) * nw).sum()
    gpos = xent_grad(pos, 1.0) * clip_grad(pos_raw) * pmask
    gneg = xent_grad(neg, 0.0) * clip_grad(neg_raw) * nw
    g_v = torch.einsum("nbk,nkd->nbd", gneg, u_neg).reshape(C, D)
    g_band = torch.zeros_like(u_band)
    for j, off in enumerate(offs):
        g_v = g_v + gpos[:, j:j + 1] * u_band[W + off:W + off + C]
        g_band[W + off:W + off + C] += gpos[:, j:j + 1] * v
    g_neg = torch.einsum("nbk,nbd->nkd", gneg, vb).reshape(nb * K, D)
    d_u = torch.cat([g_band, g_neg]) * scale
    return g_v * scale, d_u, loss, pmask.sum()


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
    d_v = torch.empty_like(v)
    d_u = torch.empty_like(u)
    gpos = torch.empty((C, 2 * W), dtype=torch.float32, device=dev)
    parts = torch.empty(2 * nb + 2, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.mv_banded_sgns_grad(
        v.data_ptr(), u.data_ptr(), pmask.data_ptr(), C, W, K, B, D,
        float(scale), d_v.data_ptr(), d_u.data_ptr(), gpos.data_ptr(),
        parts.data_ptr(), parts[nb:].data_ptr(),
        parts[2 * nb:].data_ptr(), parts[2 * nb + 1:].data_ptr(),
        stream_of(v)), "banded_sgns_grad")
    banded_sgns_grad.launches += 1
    return d_v, d_u, parts[2 * nb], parts[2 * nb + 1]


banded_sgns_grad.launches = 0
