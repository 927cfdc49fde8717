"""K8 ``pair_offset_grad`` (the per-pair mode's sub-step) against the
reference's ``_pair_offset_loss_and_grads``, at the kernel's edge
shapes: C not a multiple of the four pairs a block, K = 1, K > 8 (and
the most negatives the kernel takes, 31), D not a multiple of 4, pairs
with m = 0 (exact zero gradients). The in-place form the PS path runs on
its local copies must give the delta form plus the three ``+=`` bit for
bit. On CPU tensors the plain versions run; nothing launches.

Tolerance: rtol 1e-5 / atol 1e-7 against JAX (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models.wordembedding import device_train as jdt
from multiverso_tpu_torch.kernels import pair

SCALE = np.float32(-0.025)       # -lr
RTOL, ATOL = 1e-5, 1e-7


def _close(got, want, what: str) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _case(C: int, K: int, D: int, seed: int = 0):
    # Rows scaled so the logits spread as at D = 16: some past the clip.
    rng = np.random.default_rng(seed * 1000 + C * 37 + K * 7 + D)
    s = 1.5 * (16.0 / max(D, 1)) ** 0.25
    v = (rng.standard_normal((C, D)) * s).astype(np.float32)
    u = (rng.standard_normal((C + C * K, D)) * s).astype(np.float32)
    m = (rng.random(C) < 0.7).astype(np.float32)
    m[:min(2, C)] = 0.0
    return v, u, m


SHAPES = [(61, 5, 16), (2048, 5, 128), (7, 1, 3), (33, 9, 12), (5, 31, 8),
          (1, 1, 1), (4, 12, 130), (9, 5, 4)]


@pytest.mark.parametrize("C,K,D", SHAPES)
def test_pair_offset_grad_matches_jax_at_edge_shapes(C, K, D):
    v, u, m = _case(C, K, D)
    loss, g_v, g_pos, g_neg = jdt._pair_offset_loss_and_grads(
        jnp.asarray(v), jnp.asarray(u[:C]),
        jnp.asarray(u[C:].reshape(C, K, D)), jnp.asarray(m))
    before = pair.pair_offset_grad.launches
    got = pair.pair_offset_grad(torch.from_numpy(v), torch.from_numpy(u),
                                torch.from_numpy(m), K, float(SCALE))
    assert pair.pair_offset_grad.launches == before
    _close(got[0], SCALE * np.asarray(g_v), "d_v")
    _close(got[1], SCALE * np.concatenate(
        [np.asarray(g_pos), np.asarray(g_neg).reshape(C * K, D)]), "d_u")
    _close(got[2], loss, "loss")
    assert float(got[3]) == m.sum()
    # m == 0: exact zeros, in every gradient row of the pair.
    dead = np.flatnonzero(m == 0)
    assert not got[0].numpy()[dead].any()
    assert not got[1].numpy()[dead].any()
    neg_rows = (C + dead[:, None] * K + np.arange(K)[None, :]).reshape(-1)
    assert not got[1].numpy()[neg_rows].any()


@pytest.mark.parametrize("C,K,D", SHAPES)
def test_in_place_form_is_the_delta_form_plus_three_adds(C, K, D):
    v, u, m = _case(C, K, D, seed=1)
    tv, tu, tm = map(torch.from_numpy, (v, u, m))
    d_v, d_u, loss, ex = pair.pair_offset_grad(tv, tu, tm, K, float(SCALE))
    want_v, want_u = tv.clone(), tu.clone()
    want_v += d_v
    want_u[:C] += d_u[:C]
    want_u[C:] += d_u[C:]
    got_v, got_u = tv.clone(), tu.clone()
    got_loss, got_ex = pair.pair_offset_grad_(got_v, got_u[:C], got_u[C:],
                                              tm, K, float(SCALE))
    for got, want in ((got_v, want_v), (got_u, want_u),
                      (got_loss, loss), (got_ex, ex)):
        assert torch.equal(got.reshape(-1).view(torch.int32),
                           want.reshape(-1).view(torch.int32))


def test_in_place_form_on_the_ps_band_matches_jax_sub_steps():
    """The PS path's shape of the in-place form: 2W sub-steps on local
    copies, each on a slice of the band rows (overlapping from offset to
    offset) and its own negatives, against JAX's sub-steps in turn."""
    rng = np.random.default_rng(3)
    C, W, K, D = 19, 2, 5, 8
    v = (rng.standard_normal((C, D)) * 0.8).astype(np.float32)
    band = (rng.standard_normal((C + 2 * W, D)) * 0.8).astype(np.float32)
    negs = (rng.standard_normal((2 * W, C * K, D)) * 0.8).astype(np.float32)
    pmask = (rng.random((C, 2 * W)) < 0.8).astype(np.float32)
    jv, jband, jnegs = jnp.asarray(v), jnp.asarray(band), jnp.asarray(negs)
    tv, tband, tnegs = (torch.from_numpy(x.copy()) for x in (v, band, negs))
    offs = [o for o in range(-W, W + 1) if o != 0]
    for j, off in enumerate(offs):
        ctx = jband[W + off:W + off + C]
        loss, g_v, g_pos, g_neg = jdt._pair_offset_loss_and_grads(
            jv, ctx, jnegs[j].reshape(C, K, D), jnp.asarray(pmask[:, j]))
        jv = jv + SCALE * g_v
        jband = jband.at[W + off:W + off + C].add(SCALE * g_pos)
        jnegs = jnegs.at[j].add(SCALE * g_neg.reshape(C * K, D))
        got_loss, _ = pair.pair_offset_grad_(
            tv, tband[W + off:W + off + C], tnegs[j],
            torch.from_numpy(np.ascontiguousarray(pmask[:, j])), K,
            float(SCALE))
        _close(got_loss, loss, f"loss of offset {off}")
    _close(tv, jv, "centers")
    _close(tband, jband, "band")
    _close(tnegs, jnegs, "negatives")
