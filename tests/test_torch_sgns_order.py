"""K4's plain version in the reference's summation order (ROADMAP C2).

``sgns.banded_sgns_grad_plain`` forms the gradients of
``_banded_sgns_loss_and_grads`` (``multiverso_tpu/models/wordembedding/
device_train.py:131``) as the reference's compiled programs form them on
the CPU, read from their optimized HLO, LLVM IR and machine code: the
logits' sums as XLA's reduce (windows of 32 past 32 elements) and, for
the negatives, its row-major GEMV (one center a block) or Eigen's
contraction (four fused lanes); each cotangent as ``weight / (1 + e)``
times ``e``, then ``- weight``, then ``weight * relu'`` fused in, then
the clip's two factors; ``g_v`` the negatives' fused sum over K, then
each offset's product fused in from the last; ``g_neg`` a fused sum
over the block's centers; the loss's terms with XLA's exp and log1p,
summed as LLVM vectorizes XLA's reductions (``objective.sgns_loss``).
Inputs made by numpy from a seed — normal
rows, and small integers whose logits land on exact ties at 0 and +-6
— at C 128, W 3, K 5, B 8 and D 8, 50 and 128, pair-mask densities 0.5
and 1:

- against ``jax.jit(_banded_sgns_loss_and_grads)`` (the objective's
  own program, which fuses the band rows' products into their sum at
  rows wider than 8 floats: ``fused_band=True``): every gradient and
  the loss bit for bit;
- against ``_block_step_fn`` (the PS pipeline's program, ``-lr /
  num_workers`` times the gradients), neg_block 1 and 8: both deltas
  and the loss bit for bit.

``tests/test_torch_sync.py`` holds the whole BSP run's block losses and
tables bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu.models.wordembedding.device_train import (
    _banded_sgns_loss_and_grads, _block_step_fn)
from multiverso_tpu_torch.kernels.sgns import banded_sgns_grad_plain

C, W, K = 128, 3, 5


def _inputs(B: int, D: int, density: float, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    nb = C // B
    n_u = C + 2 * W + nb * K
    if kind == "normal":
        v = rng.standard_normal((C, D)) * 0.3
        u = rng.standard_normal((n_u, D)) * 0.3
    else:
        # Small integers, mostly zero: the logits are exact integers,
        # many exactly 0 or +-6 (the clip's ties), some past +-6.
        v = rng.choice([0, 0, 0, 1, -1, 2, -2], size=(C, D))
        u = rng.choice([0, 0, 0, 1, -1, 3, -3], size=(n_u, D))
    pm = (rng.random((C, 2 * W)) < density).astype(np.float32)
    return v.astype(np.float32), u.astype(np.float32), pm


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_bits(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    bad = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
    assert bad.size == 0, (
        f"{what}: {bad.size} of {got.size} elements differ, e.g. "
        f"{got.reshape(-1)[bad[:3]]} vs {want.reshape(-1)[bad[:3]]}")


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("density", [0.5, 1.0])
@pytest.mark.parametrize("D", [8, 50, 128])
def test_objective_gradients_bit_for_bit(D, density, kind):
    B = 8
    v, u, pm = _inputs(B, D, density, kind, seed=D + int(density * 10))
    nb = C // B
    loss, g_v, g_band, g_neg = jax.jit(_banded_sgns_loss_and_grads)(
        v, u[:C + 2 * W], u[C + 2 * W:].reshape(nb, K, D), pm)
    d_v, d_u, got_loss, pairs = banded_sgns_grad_plain(
        _t(v), _t(u), _t(pm), W, K, B, 1.0, fused_band=True)
    _assert_bits(d_v, g_v, "g_v")
    _assert_bits(d_u[:C + 2 * W], g_band, "g_band")
    _assert_bits(d_u[C + 2 * W:], g_neg, "g_neg")
    _assert_bits(np.float32(got_loss), np.float32(loss), "loss")
    assert float(pairs) == float(pm.sum())
    if kind == "ties":
        pos = v @ u[:C + 2 * W].T
        assert (pos == 0).any() and (np.abs(pos) == 6).any()


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("D", [8, 50, 128])
@pytest.mark.parametrize("B", [1, 8])
def test_block_step_deltas_bit_for_bit(B, D, kind):
    v, u, pm = _inputs(B, D, 0.5, kind, seed=7 * D + B)
    lr, inv = np.float32(0.02), np.float32(0.5)
    d_v, d_u, loss, pairs = _block_step_fn(C, W, K, False, B, False)(
        v, u, pm, lr, inv)
    scale = float(-np.float32(lr * inv))
    got_v, got_u, got_loss, got_pairs = banded_sgns_grad_plain(
        _t(v), _t(u), _t(pm), W, K, B, scale)
    _assert_bits(got_v, d_v, "d_v")
    _assert_bits(got_u, d_u, "d_u")
    _assert_bits(np.float32(got_loss), np.float32(loss), "loss")
    assert float(got_pairs) == float(pairs)




def test_loss_in_xla_order():
    """The loss alone, on inputs whose terms take both branches of XLA's
    log1p (``e`` above and below sqrt(2) - 1), at neg_block 1 and 8 and
    a mask with empty rows: bit for bit."""
    for B in (1, 8):
        v, u, pm = _inputs(B, 8, 0.5, "normal", seed=18 + B)
        pm[:5] = 0.0
        lr, inv = np.float32(0.02), np.float32(0.5)
        _, _, loss, _ = _block_step_fn(C, W, K, False, B, False)(
            v, u, pm, lr, inv)
        _, _, got, _ = banded_sgns_grad_plain(
            _t(v), _t(u), _t(pm), W, K, B, float(-np.float32(lr * inv)))
        _assert_bits(np.float32(got), np.float32(loss), "loss")
