"""Plain versions of the port's four kernels against the JAX programs
they replace, on numpy inputs from a fixed seed (CPU tensors: the
wrappers run their plain versions here; the CUDA kernels are held
against the same plain versions on the card by chip_smoke.py).

- K2 row_gather vs ``MatrixServer._gather``: bit-exact, incl. the pad
  sentinel, ids past the table, negative ids (JAX wraps [-R, -1]) and
  ``n_col`` below the storage width.
- K3 row_scatter_add vs ``UpdateEngine.apply_rows`` (default and sgd):
  duplicates, the sentinel, a narrow delta with fewer rows than ids.
  Tolerance rtol=1e-6, atol=1e-7: duplicate rows sum in another order.
- K1 subsample_compact vs ``_prep`` with its ``jax.random.uniform`` draw
  replayed: kept, ksent and n_kept bit-exact; likewise ``_pad_stream``,
  ``_band_former`` and ``_draw_negs`` with replayed draws.
- K4 banded_sgns_grad vs ``_block_step_fn(C, W, K, False, B, False)``
  with logits past +-6: rtol=1e-5, atol=1e-6 — float32 sums of the
  same terms taken in another order (einsum/dot reductions), and the
  sigmoid-xent derivative formed from the same expression but not the
  same XLA fusion.
"""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models.wordembedding import device_train as jdt
from multiverso_tpu.tables.matrix_table import MatrixServer
from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu_torch.kernels import (banded_sgns_grad, row_gather,
                                          row_scatter_add,
                                          subsample_compact)
from multiverso_tpu_torch.kernels.sgns import banded_sgns_grad_plain
from multiverso_tpu_torch.models.wordembedding import (
    device_train as tdt, model as tmodel)
from multiverso_tpu_torch.updater import engine as tengine
from multiverso_tpu_torch.updater import rules as trules


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the PORT's role-thread count to its baseline
    (tests/conftest.py guards only the reference's thread registry) and
    leaves the port's flag registry at its defaults."""
    from multiverso_tpu_torch.runtime import thread_roles
    from multiverso_tpu_torch.util import configure
    before = sum(thread_roles.roles_alive().values())
    yield
    configure.reset_flags()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if sum(thread_roles.roles_alive().values()) <= before:
            break
        time.sleep(0.05)
    alive = thread_roles.roles_alive()
    assert sum(alive.values()) <= before, f"port threads leaked: {alive}"


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_gather(data, ids, n_col):
    fn = MatrixServer.__dict__["_gather"].func(
        types.SimpleNamespace(num_col=n_col))
    return np.asarray(fn(jnp.asarray(data), jnp.asarray(ids)))


@pytest.mark.parametrize("n_col", [16, 13, 10])
def test_row_gather_matches_jax(n_col):
    rng = np.random.default_rng(0)
    R, S = 37, 16
    data = rng.standard_normal((R, S)).astype(np.float32)
    ids = np.concatenate([
        rng.integers(0, R, 40), [R, R, R + 5, 10 ** 6],      # sentinel, past
        [-1, -R, -R - 1, -5, 0, R - 1]]).astype(np.int32)  # wrap / drop
    want = _jax_gather(data, ids, n_col)
    got = row_gather(_t(data), _t(ids), n_col).numpy()
    assert got.shape == (ids.size, n_col)
    np.testing.assert_array_equal(got, want)


def test_row_gather_keeps_id_shape():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((9, 8)).astype(np.float32)
    ids = rng.integers(-9, 12, (3, 4)).astype(np.int32)
    want = _jax_gather(data, ids, 8)
    got = row_gather(_t(data), _t(ids), 8).numpy()
    assert got.shape == (3, 4, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule", ["default", "sgd"])
@pytest.mark.parametrize("host_ids", [True, False])
def test_row_scatter_add_matches_apply_rows(rule, host_ids):
    rng = np.random.default_rng(2)
    R, S, k = 29, 16, 21
    data = rng.standard_normal((R, S)).astype(np.float32)
    ids = rng.integers(0, R, k).astype(np.int32)
    ids[:6] = [3, 3, 3, 7, 7, R - 1]                         # duplicates
    if not host_ids:
        ids[6:9] = [R, -1, -R]                               # sentinel, wrap
    delta = rng.standard_normal((k, S)).astype(np.float32)
    j = jengine.UpdateEngine(jrules.create_rule(rule), (R, S), np.float32,
                             1)
    if host_ids:
        want = j.apply_rows(jnp.asarray(data), ids, delta)
    else:
        want = j.apply_rows(jnp.asarray(data), jnp.asarray(ids),
                            jnp.asarray(delta))
    t = tengine.UpdateEngine(trules.create_rule(rule), (R, S), np.float32,
                             1)
    got = _t(data)
    got = t.apply_rows(got, ids if host_ids else _t(ids),
                       delta if host_ids else _t(delta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_row_scatter_add_narrow_short_delta():
    # A delta narrower than the storage and with fewer rows than ids is
    # zero-extended in both directions (engine.py pad_cols /
    # pad_row_count): the extension must add exactly nothing.
    rng = np.random.default_rng(3)
    R, S = 20, 16
    data = rng.standard_normal((R, S)).astype(np.float32)
    ids = np.array([4, 4, 19, 20, 0, 1, 2, 3], np.int32)    # 20 = sentinel
    delta = rng.standard_normal((5, 10)).astype(np.float32)
    j = jengine.UpdateEngine(jrules.create_rule("default"), (R, S),
                             np.float32, 1)
    want = np.asarray(j.apply_rows(jnp.asarray(data), jnp.asarray(ids),
                                   jnp.asarray(delta)))
    got = _t(data)
    row_scatter_add(got, _t(ids), _t(delta))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.numpy()[:, 10:], data[:, 10:])


def _corpus(seed=4, T=3000, V=50, n_sent=120):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, V, T).astype(np.int32)
    sent = np.sort(rng.integers(0, n_sent, T)).astype(np.int32)
    keep = rng.uniform(0.05, 1.0, V).astype(np.float32)
    return flat, sent, keep


def test_subsample_compact_matches_prep():
    flat, sent, keep = _corpus()
    key = jax.random.PRNGKey(7)
    want = [np.asarray(x) for x in jdt._prep(jnp.asarray(flat),
                                             jnp.asarray(sent),
                                             jnp.asarray(keep), key)]
    u = np.asarray(jax.random.uniform(key, flat.shape))
    got = subsample_compact(_t(flat), _t(sent), _t(keep), _t(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < int(got[2]) < flat.size


def test_pad_band_draw_match_jax():
    flat, sent, keep = _corpus(seed=5)
    C, W, K, B, V = 64, 3, 5, 8, 50
    key = jax.random.PRNGKey(11)
    kept, ksent, n_kept = jdt._prep(jnp.asarray(flat), jnp.asarray(sent),
                                    jnp.asarray(keep), key)
    jk, js = jdt._pad_stream(C, W, kept, ksent)
    tk, ts = tdt._pad_stream(C, W, _t(kept), _t(ksent))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rng = np.random.default_rng(6)
    neg_prob = rng.uniform(0, 1, V).astype(np.float32)
    neg_alias = rng.integers(0, V, V).astype(np.int32)
    n = int(n_kept)
    # Last block runs past n_kept: the in-stream masks must match too.
    for base in (0, C, (n // C) * C):
        step_key = jax.random.fold_in(key, base)
        k_shrink, k_idx, k_keep = jax.random.split(step_key, 3)
        want = jdt._band_former(C, W, n_kept, jk, js, k_shrink,
                                np.int32(base))
        shrink = jax.random.randint(k_shrink, (C,), 1, W + 1)
        got = tdt._band_former(C, W, n, tk, ts, _t(shrink), base)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        want_negs = jdt._draw_negs(C, K, B, jnp.asarray(neg_prob),
                                   jnp.asarray(neg_alias), k_idx, k_keep)
        idx = jax.random.randint(k_idx, (C // B, K), 0, V)
        uu = jax.random.uniform(k_keep, (C // B, K))
        got_negs = tmodel.draw_negs(_t(neg_prob), _t(neg_alias), _t(idx),
                                     _t(uu))
        assert got_negs.dtype == torch.int32
        np.testing.assert_array_equal(got_negs.numpy(),
                                      np.asarray(want_negs))


@pytest.mark.parametrize("C,W,K,B", [(64, 3, 5, 8), (32, 2, 3, 1)])
def test_banded_sgns_grad_matches_block_step(C, W, K, B):
    rng = np.random.default_rng(C + W + K + B)
    D = 16
    nb = C // B
    # Rows large enough that some logits pass +-6 (clipped, zero grad).
    v = (rng.standard_normal((C, D)) * 0.9).astype(np.float32)
    u = (rng.standard_normal((C + 2 * W + nb * K, D)) * 0.9).astype(
        np.float32)
    pmask = (rng.random((C, 2 * W)) < 0.7).astype(np.float32)
    pmask[:3] = 0.0                      # centers with no valid pairs
    lr, inv_w = np.float32(0.025), np.float32(0.5)
    step = jdt._block_step_fn(C, W, K, False, B, False)
    want = [np.asarray(x) for x in step(
        jnp.asarray(v), jnp.asarray(u), jnp.asarray(pmask),
        jnp.asarray(lr), jnp.asarray(inv_w))]
    logits = np.abs(v @ u.T)
    assert (logits > 6).any() and (logits < 6).any()
    scale = float(-(lr * inv_w))
    for fn in (banded_sgns_grad, banded_sgns_grad_plain):
        got = [x.numpy() for x in fn(_t(v), _t(u), _t(pmask), W, K, B,
                                     scale)]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        assert float(got[3]) == float(pmask.sum())


def test_banded_sgns_grad_exact_ties():
    # Logits exactly 0 (every logit against the zero-initialized output
    # table) and exactly +-6 (the clip bound): JAX's autodiff gives -y at
    # 0 and half the gradient on the bound — the port must too.
    C, W, K, B, D = 16, 2, 3, 4, 8
    nb = C // B
    v = np.zeros((C, D), np.float32)
    v[:, 0] = 1.0
    v[:4, 0] = 6.0
    u = np.zeros((C + 2 * W + nb * K, D), np.float32)
    u[::3, 0] = 1.0
    u[1::3, 0] = -1.0
    pmask = np.ones((C, 2 * W), np.float32)
    lr, inv_w = np.float32(0.025), np.float32(1.0)
    want = [np.asarray(x) for x in jdt._block_step_fn(
        C, W, K, False, B, False)(jnp.asarray(v), jnp.asarray(u),
                                  jnp.asarray(pmask), jnp.asarray(lr),
                                  jnp.asarray(inv_w))]
    got = banded_sgns_grad(_t(v), _t(u), _t(pmask), W, K, B,
                           float(-(lr * inv_w)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_kernel_wrappers_count_no_launch_on_cpu():
    from multiverso_tpu_torch import kernels
    before = kernels.launch_counts()
    row_gather(torch.zeros(4, 4), torch.zeros(2, dtype=torch.int32), 4)
    assert kernels.launch_counts() == before
