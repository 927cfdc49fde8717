"""K5 ``banded_cbow_grad`` and K7 ``hs_cbow_grad`` as span kernels: their
span geometry, the shared-memory sizes the wrappers compute for them,
and the plain versions against the reference at the edges the span
code must meet.

The kernels run on the card only (``chip_smoke.py`` holds them against
these plain versions there, at every word2vec path's shape and at a
negative block of 512). Here, on CPU tensors, the wrappers run the plain
versions, which must agree with the reference's
``_banded_cbow_loss_and_grads`` and ``_hs_cbow_loss_and_grads``
(``multiverso_tpu/models/wordembedding/device_train.py``) on: C not a
multiple of the span, C below one span, windows W = 1 and 5, negative
blocks B = 1, 8 and 512, paths of one node, centers whose every node is
masked, and centers with no context. Tolerance rtol 1e-5 / atol 1e-6:
the same terms summed in torch's order instead of XLA's (the gradients
are scaled by ``-lr`` on both sides). No kernel launches on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu.models.wordembedding import device_train as jdt
from multiverso_tpu_torch import kernels
from multiverso_tpu_torch.kernels import _launch, cbow, hs

SCALE = -0.025
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _layout_floats(S: int, W: int, D: int, warps: int = 8) -> int:
    """``cbow_span`` of ``csrc/w2v_common.cuh``, region by region."""
    W2, DP = 2 * W, -(-D // 4) * 4
    band = (S + W2) * DP
    mean = S * DP
    gacc = (W2 + S) * DP
    pm = (W2 + S) * W2
    at = band + mean + gacc + pm
    at = -(-at // 4) * 4 + S          # context counts
    at = -(-at // 4) * 4 + 2 * warps  # two slots a warp
    return -(-at // 4) * 4


@pytest.mark.parametrize("S,W,D", [(24, 5, 128), (64, 5, 128), (32, 1, 3),
                                   (512, 5, 16)])
def test_cbow_span_shared_memory(S, W, D):
    assert _launch.cbow_span_floats(S, W, D) == _layout_floats(S, W, D)
    assert hs.cbow_span_smem(S, W, D) == 4 * _layout_floats(S, W, D)


@pytest.mark.parametrize("S,W,K,B,D", [(24, 5, 5, 8, 128), (512, 5, 5, 512,
                                                             16),
                                       (24, 1, 2, 1, 3)])
def test_k5_shared_memory(S, W, K, B, D):
    """K5 adds its S / B * K negative rows and S * K coefficients."""
    base = _layout_floats(S, W, D)
    neg = S // B * K * (-(-D // 4) * 4)
    want = 4 * (-(-(base + neg + S * K) // 4) * 4)
    assert cbow.span_smem(S, W, K, B, D) == want


@pytest.mark.parametrize("C,W,K,B,D", [
    (16384, 5, 5, 8, 128), (32768, 5, 5, 8, 128), (2048, 5, 5, 512, 16),
    (40, 1, 2, 1, 8), (16, 5, 5, 8, 8), (24, 5, 3, 8, 8), (1024, 5, 5, 1, 8)])
def test_k5_span_geometry(C, W, K, B, D):
    S = cbow.span_geometry(C, W, K, B, D)
    assert S % B == 0 and 0 < S <= C
    # Several spans: each is at least 2W (the handoff's 2W centers come
    # from one span before).
    assert S >= 2 * W or S == C
    assert cbow.span_smem(S, W, K, B, D) <= _launch.SMEM_LIMIT
    if (C, B) == (16384, 8):
        assert S == cbow.SPAN_TARGET


def test_k5_span_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cbow.span_geometry(4096, 5, 5, 4096, 128)


@pytest.mark.parametrize("C,W,D,sms,want", [
    (8192, 5, 128, 132, 32), (32768, 5, 128, 132, 64), (24, 5, 8, 132, 24),
    (100, 20, 8, 132, 40), (7, 1, 3, 132, 7)])
def test_k7_span_geometry(C, W, D, sms, want):
    S = hs.cbow_span_geometry(C, W, D, sms)
    assert S == want
    assert S >= 2 * W or S == C


def _pmask(rng, C: int, W: int) -> np.ndarray:
    pm = (rng.random((C, 2 * W)) < 0.75).astype(np.float32)
    pm[:3] = 0.0      # centers with no context
    pm[-1] = 1.0
    return pm


@pytest.mark.parametrize("C,W,K,B", [
    (40, 5, 5, 8),    # not a multiple of the span (24)
    (16, 5, 5, 8),    # below one span
    (48, 1, 2, 8),    # W = 1
    (30, 2, 3, 1),    # B = 1
    (1024, 5, 5, 512),  # a negative block wider than a span's target
    (24, 5, 31, 8),   # K = 31, the kernel's most
])
def test_banded_cbow_grad_matches_reference(C, W, K, B):
    rng = np.random.default_rng(C + 7 * W + K + B)
    D = 8
    ub = (rng.standard_normal((C + 2 * W, D)) * 0.6).astype(np.float32)
    uo = (rng.standard_normal((C + C // B * K, D)) * 0.6).astype(np.float32)
    pm = _pmask(rng, C, W)
    loss, gband, gc, gneg, ex = jax.jit(jdt._banded_cbow_loss_and_grads)(
        ub, uo[:C], uo[C:].reshape(C // B, K, D), pm)
    kernels.reset_launch_counts()
    d_band, d_out, tl, te = cbow.banded_cbow_grad(_t(ub), _t(uo), _t(pm), W,
                                                  K, B, SCALE)
    assert kernels.launch_counts()["banded_cbow_grad"] == 0
    np.testing.assert_allclose(d_band.numpy(), SCALE * np.asarray(gband),
                               **TOL)
    np.testing.assert_allclose(d_out.numpy()[:C], SCALE * np.asarray(gc),
                               **TOL)
    np.testing.assert_allclose(
        d_out.numpy()[C:], SCALE * np.asarray(gneg).reshape(-1, D), **TOL)
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    assert float(te) == float(ex)
    # No context: the center's output row takes no gradient.
    assert not d_out[:3].any()


def _paths(rng, C: int, L: int):
    path = rng.integers(0, 1000, (C, L)).astype(np.int32)
    code = rng.integers(0, 2, (C, L)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, L + 1, C)):
        path[i, n:] = -1
        code[i, n:] = -1
    path[5] = -1      # every node of a center masked
    code[6, :] = -1
    return path, code


@pytest.mark.parametrize("C,W,L", [
    (40, 5, 6),       # not a multiple of the span (32)
    (20, 5, 4),       # below one span
    (70, 1, 9),       # W = 1, more than 8 nodes (two node chunks)
    (33, 5, 1),       # paths of one node
    (64, 2, 22),      # the word2vec paths' depth
])
def test_hs_cbow_grad_matches_reference(C, W, L):
    rng = np.random.default_rng(C + 11 * W + L)
    D = 8
    ub = (rng.standard_normal((C + 2 * W, D)) * 0.6).astype(np.float32)
    up = (rng.standard_normal((C * L, D)) * 0.6).astype(np.float32)
    path, code = _paths(rng, C, L)
    pm = _pmask(rng, C, W)
    loss, gb, gp, ex = jax.jit(jdt._hs_cbow_loss_and_grads)(
        ub, up.reshape(C, L, D), path, code, pm)
    kernels.reset_launch_counts()
    d_band, d_path, tl, te = hs.hs_cbow_grad(_t(ub), _t(up), _t(path),
                                             _t(code), _t(pm), W, SCALE)
    assert kernels.launch_counts()["hs_cbow_grad"] == 0
    np.testing.assert_allclose(d_band.numpy(), SCALE * np.asarray(gb), **TOL)
    np.testing.assert_allclose(d_path.numpy(),
                               SCALE * np.asarray(gp).reshape(-1, D), **TOL)
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    assert float(te) == float(ex)
    # Masked nodes and centers without context: zero path gradients.
    d3 = d_path.reshape(C, L, D)
    assert not d3[5].any() and not d3[6].any() and not d3[:3].any()


def test_handoff_state_is_zero_and_grows():
    """The CBOW spans' flags and counters (one set a device, zeroed once,
    left zero by every launch) grow to the spans asked for."""
    saved = dict(_launch._handoff)
    try:
        _launch._handoff.clear()
        dev = torch.device("cpu")
        ctr, flags = _launch.handoff(dev, 10)
        assert ctr.numel() == 2 and flags.numel() >= 10
        assert not ctr.any() and not flags.any()
        assert _launch.handoff(dev, 10)[1] is flags
        bigger = _launch.handoff(dev, flags.numel() + 1)[1]
        assert bigger.numel() > flags.numel() and not bigger.any()
    finally:
        _launch._handoff.clear()
        _launch._handoff.update(saved)
