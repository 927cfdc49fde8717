"""K8 pair_offset_grad: one window offset's sub-step of the per-pair
skip-gram quality mode.

Replaces ``_pair_offset_loss_and_grads`` (``multiverso_tpu/models/
wordembedding/device_train.py:233-250``) as ``_seq_pair_step``
(``:253-285``) drives it: 2W sequential sub-steps, each against the live
tables. For C pairs (center rows ``v`` [C, D], the offset's context
OUTPUT rows ``u_pos`` [C, D] and each pair's own K negatives ``u_neg``
[C*K, D], pair validity ``m`` [C]): sigmoid xent at label 1 against the
context and label 0 against the negatives, masked by ``m``.

Two forms. ``pair_offset_grad`` (the local path, whose rows K2 gathered
into ``u`` = [contexts | negatives]) returns ``scale * grad`` for both
row sets (``scale = -lr``), the loss and the example count (the sum of
``m``); K3 scatters the gradients. ``pair_offset_grad_`` (the PS path's
local copies) adds ``scale * grad`` to ``v``, ``u_pos`` and ``u_neg`` in
place, rounded as ``x += d`` rounds, and returns the loss and the count:
no copy of the rows into one tensor, no separate adds.

On a CUDA tensor each launches the kernel (``csrc/pair_offset.cu``;
bound by bytes: ~7 MB of rows a sub-step at full width; one launch: the
last block to arrive sums the loss) or raises; on a CPU tensor it runs
the plain version. ``pair_offset_grad.launches`` counts the launches of
both forms.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .flush import add_
from .flush import flush as f
from .objective import MAX_EXP, dot, masked_grad, xent

_PAIRS_PER_BLOCK = 4  # one warp a pair (csrc/pair_offset.cu kPairWarps)
#: The most negatives a pair the kernel takes (K + 1 dot products in one
#: warp's transposed sum).
MAX_NEGATIVES = 31

#: A zeroed arrival counter a device, which each launch's last block
#: leaves zero again (the kernels run on one stream, in launch order).
_arrived = {}


def pair_offset_grad_plain(v: torch.Tensor, u: torch.Tensor,
                           m: torch.Tensor, K: int, scale: float):
    """Plain version of K8: (d_v, d_u, loss, examples), every operation
    flushed (``objective``'s note)."""
    C, D = v.shape
    v, u = f(v), f(u)
    u_pos = u[:C]
    u_neg = u[C:].reshape(C, K, D)
    pos_raw = dot(v, u_pos, -1)
    neg_raw = dot(v[:, None], u_neg, -1)
    pos = torch.clamp(pos_raw, -MAX_EXP, MAX_EXP)
    neg = torch.clamp(neg_raw, -MAX_EXP, MAX_EXP)
    loss = f(f(f(xent(pos, 1.0) * m).sum())
             + f(f(xent(neg, 0.0) * m[:, None]).sum()))
    gpos = masked_grad(pos, pos_raw, 1.0, m)
    gneg = masked_grad(neg, neg_raw, 0.0, m[:, None])
    g_v = f(f(gpos[:, None] * u_pos) + dot(gneg[..., None], u_neg, 1))
    g_pos = f(gpos[:, None] * v)
    g_neg = f(gneg[:, :, None] * v[:, None, :]).reshape(C * K, D)
    return (f(g_v * scale), f(torch.cat([g_pos, g_neg]) * scale), loss,
            m.sum())


def pair_offset_grad_inplace_plain(v: torch.Tensor, u_pos: torch.Tensor,
                                   u_neg: torch.Tensor, m: torch.Tensor,
                                   K: int, scale: float):
    """Plain version of the in-place form: the delta form, then the three
    ``+=``; returns (loss, examples)."""
    C = v.shape[0]
    d_v, d_u, loss, examples = pair_offset_grad_plain(
        v, torch.cat([u_pos, u_neg]), m, K, scale)
    add_(v, d_v)
    add_(u_pos, d_u[:C])
    add_(u_neg, d_u[C:])
    return loss, examples


def _check(v, u_pos, u_neg, m, K: int) -> None:
    C, D = v.shape
    if tuple(u_pos.shape) != (C, D) or tuple(u_neg.shape) != (C * K, D):
        raise ValueError(f"u_pos {tuple(u_pos.shape)}, u_neg "
                         f"{tuple(u_neg.shape)}: expected ({C}, {D}) and "
                         f"({C * K}, {D})")
    if tuple(m.shape) != (C,):
        raise ValueError(f"m {tuple(m.shape)}: expected ({C},)")


def _launch(v, u_pos, u_neg, m, K: int, scale: float, outs) -> tuple:
    """The kernel on CUDA tensors: ``outs`` None (in place) or (d_v,
    d_pos, d_neg); returns the 0-d loss and examples."""
    C, D = v.shape
    dev = v.device
    for name, t in (("v", v), ("u_pos", u_pos), ("u_neg", u_neg)):
        require(t, name, torch.float32, dev, 2)
    require(m, "m", torch.float32, dev, 1)
    if K > MAX_NEGATIVES:
        raise ValueError(f"pair_offset_grad takes at most {MAX_NEGATIVES} "
                         f"negatives a pair, got {K}")
    blocks = max(-(-C // _PAIRS_PER_BLOCK), 1)
    part = torch.empty(2 * blocks + 2, dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _arrived:
        _arrived[index] = torch.zeros(1, dtype=torch.int32, device=dev)
    d_v, d_pos, d_neg = outs if outs is not None else (None, None, None)
    lib = build.library()
    build.check(lib.mv_pair_offset_grad(
        v.data_ptr(), u_pos.data_ptr(), u_neg.data_ptr(), m.data_ptr(), C,
        K, D, float(scale), int(outs is None),
        None if d_v is None else d_v.data_ptr(),
        None if d_pos is None else d_pos.data_ptr(),
        None if d_neg is None else d_neg.data_ptr(), part.data_ptr(),
        _arrived[index].data_ptr(), part[2 * blocks:].data_ptr(),
        part[2 * blocks + 1:].data_ptr(), stream_of(v)),
        "pair_offset_grad")
    pair_offset_grad.launches += 1
    return part[2 * blocks], part[2 * blocks + 1]


def pair_offset_grad(v: torch.Tensor, u: torch.Tensor, m: torch.Tensor,
                     K: int, scale: float):
    """K8's delta form on float32 ``v`` [C, D], ``u`` [C+C*K, D] and
    ``m`` [C]: returns (d_v [C, D], d_u like u, loss 0-d, examples
    0-d)."""
    C, D = v.shape
    if tuple(u.shape) != (C + C * K, D):
        raise ValueError(f"u {tuple(u.shape)}: expected ({C + C * K}, "
                         f"{D})")
    _check(v, u[:C], u[C:], m, K)
    if is_plain(v):
        return pair_offset_grad_plain(v, u, m, K, scale)
    d_v = torch.empty_like(v)
    d_u = torch.empty_like(u)
    loss, examples = _launch(v, u[:C], u[C:], m, K, scale,
                             (d_v, d_u[:C], d_u[C:]))
    return d_v, d_u, loss, examples


def pair_offset_grad_(v: torch.Tensor, u_pos: torch.Tensor,
                      u_neg: torch.Tensor, m: torch.Tensor, K: int,
                      scale: float):
    """K8's in-place form: ``v``, ``u_pos`` and ``u_neg`` (float32 [C, D],
    [C, D], [C*K, D], each contiguous) take ``scale * grad`` in place;
    returns (loss 0-d, examples 0-d)."""
    _check(v, u_pos, u_neg, m, K)
    if is_plain(v):
        return pair_offset_grad_inplace_plain(v, u_pos, u_neg, m, K, scale)
    return _launch(v, u_pos, u_neg, m, K, scale, None)


pair_offset_grad.launches = 0
