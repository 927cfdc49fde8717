"""Float32 subnormals in the step functions and on the row paths that
still kept them, against the reference (ROADMAP C12's remainder).

The reference's jitted programs run with flush-to-zero and
denormals-are-zero (XLA's CPU runtime): an arithmetic operation reads a
subnormal as a zero of its sign and writes a subnormal result as one;
gathers, copies and negations move bits. The port's kernels build with
``-ftz=true``; their plain versions flush every operation's inputs and
result (``multiverso_tpu_torch/kernels/flush.py``), a dot product on its
inputs, its products and its result.

Inputs: rows of integers in [-15, 15] times 2^-130 (subnormal: an
operation reads them as zero), rows of normal values times 2^-70 (the
product of two is below 2^-126 and flushes), and rows of normal values,
so that whole rows read as zero and some logits are exactly zero (where
JAX's gradient convention gives -y, not the limit from either side).
No sum of these products passes below 2^-126 on its way (a partial sum
of products near 2^-71 is a multiple of 2^-94), so the flushes do not
depend on the summation order.

Held, for each step function of the reference against the port's plain
version (scale 1, so the port's outputs are the gradients themselves):
every element where the reference holds a zero holds the same zero, its
sign included (int32 bits); every other element within rtol 1e-5 and
atol 1e-6, as ``tests/test_torch_kernels.py`` holds K4: the plain
versions sum the same terms in torch's order, the reference in XLA's.

Then the row paths, bit for bit against ``UpdateEngine.apply_rows``: ids
past the delta's rows and a delta narrower than the table take the
reference's zero extension (``pad_row_count``, ``pad_cols``), whose zero
add flushes a subnormal table element and moves a stateful rule's state.
AdaGrad's table is held within 4 ulps of each step that reaches an
element, its zeros and subnormals bit for bit (its ``rsqrt``: ROADMAP
C13).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models.logreg import objective as jobjective
from multiverso_tpu.models.logreg.config import Configure
from multiverso_tpu.models.wordembedding import device_train as jdt
from multiverso_tpu.models.wordembedding.model import Word2Vec as JWord2Vec
from multiverso_tpu.parallel import allreduce_mesh as jallreduce_mesh
from multiverso_tpu.parallel import pmean_mesh as jpmean_mesh
from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu.updater.options import AddOption as JAddOption
from multiverso_tpu_torch.kernels import cbow, hs, logreg, pair, pairlist
from multiverso_tpu_torch.kernels import sgns
from multiverso_tpu_torch.kernels.rows import row_scatter_add_plain
from multiverso_tpu_torch.parallel import allreduce_mesh, pmean_mesh
from multiverso_tpu_torch.sharding import mesh as meshlib
from multiverso_tpu_torch.updater import AddOption, UpdateEngine
from multiverso_tpu_torch.updater import rules as trules

TINY = 2.0 ** -130
RTOL, ATOL = 1e-5, 1e-6


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _tiny_rows(rng, shape, frac: float = 0.3) -> np.ndarray:
    """Rows of three kinds: a ``frac`` of integers in [-15, 15] times
    2^-130 (subnormal: they read as zero), a fifth of normal values times
    2^-70 (a product of two of them is below 2^-126 and flushes; one with
    a normal value does not), the rest normal (scale 0.5)."""
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    kind = rng.random(shape[0])
    sub = kind < frac
    x[sub] = (rng.integers(-15, 16, (int(sub.sum()),) + tuple(shape[1:]))
              * TINY).astype(np.float32)
    small = (kind >= frac) & (kind < frac + 0.2)
    x[small] = (x[small] * 2.0 ** -70).astype(np.float32)
    return x


def _assert_flushed(got, want, what: str) -> None:
    """The reference's zeros bit for bit (sign included); the rest within
    rtol 1e-5, atol 1e-6 (the module's note)."""
    got = np.asarray(got, np.float32).reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    assert got.shape == want.shape, what
    zero = want == 0
    bad = np.flatnonzero(_bits(got[zero]) != _bits(want[zero]))
    assert bad.size == 0, (
        f"{what}: {bad.size} of the reference's {int(zero.sum())} zeros "
        f"differ: {got[zero][bad[:5]]}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _pmask(rng, C: int, W: int) -> np.ndarray:
    pm = (rng.random((C, 2 * W)) < 0.8).astype(np.float32)
    pm[:2] = 0.0  # centers with no context
    return pm


@pytest.mark.parametrize("C,W,K,B", [(24, 2, 3, 4), (40, 5, 5, 8),
                                     (16, 1, 2, 16)])
def test_banded_sgns_flushes_as_reference(C, W, K, B):
    rng = np.random.default_rng(C + W)
    D = 8
    v = _tiny_rows(rng, (C, D))
    ub = _tiny_rows(rng, (C + 2 * W, D))
    un = _tiny_rows(rng, (C // B, K, D))
    pm = _pmask(rng, C, W)
    loss, gv, gb, gn = jax.jit(jdt._banded_sgns_loss_and_grads)(
        v, ub, un, pm)
    dv, du, tl, _ = sgns.banded_sgns_grad_plain(
        _t(v), _t(np.concatenate([ub, un.reshape(-1, D)])), _t(pm), W, K, B,
        1.0)
    _assert_flushed(dv, gv, "g_v")
    _assert_flushed(du[:C + 2 * W], gb, "g_band")
    _assert_flushed(du[C + 2 * W:], gn, "g_neg")
    _assert_flushed(tl, loss, "loss")


@pytest.mark.parametrize("C,W,K,B", [(24, 2, 3, 4), (40, 5, 5, 8),
                                     (16, 1, 2, 16)])
def test_banded_cbow_flushes_as_reference(C, W, K, B):
    rng = np.random.default_rng(3 * C + W)
    D = 8
    ub = _tiny_rows(rng, (C + 2 * W, D))
    uc = _tiny_rows(rng, (C, D))
    un = _tiny_rows(rng, (C // B, K, D))
    pm = _pmask(rng, C, W)
    loss, gband, gc, gneg, ex = jax.jit(jdt._banded_cbow_loss_and_grads)(
        ub, uc, un, pm)
    db, do, tl, te = cbow.banded_cbow_grad_plain(
        _t(ub), _t(np.concatenate([uc, un.reshape(-1, D)])), _t(pm), W, K,
        B, 1.0)
    _assert_flushed(db, gband, "g_band")
    _assert_flushed(do[:C], gc, "g_center")
    _assert_flushed(do[C:], gneg, "g_neg")
    _assert_flushed(tl, loss, "loss")
    assert float(te) == float(ex)


def _paths(rng, rows: int, L: int):
    path = rng.integers(0, 50, (rows, L)).astype(np.int32)
    code = rng.integers(0, 2, (rows, L)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, L + 1, rows)):
        path[i, n:] = -1
        code[i, n:] = -1
    return path, code


@pytest.mark.parametrize("C,W,L", [(20, 2, 4), (33, 5, 6), (12, 1, 1)])
def test_hs_steps_flush_as_reference(C, W, L):
    rng = np.random.default_rng(5 * C + L)
    D = 8
    pm = _pmask(rng, C, W)
    # Skip-gram: the center rows against the band positions' paths.
    v = _tiny_rows(rng, (C, D))
    ubp = _tiny_rows(rng, ((C + 2 * W) * L, D))
    pb, cb = _paths(rng, C + 2 * W, L)
    loss, gv, gbp = jax.jit(jdt._hs_sg_loss_and_grads)(
        v, ubp.reshape(C + 2 * W, L, D), pb, cb, pm)
    dv, dbp, tl, _ = hs.banded_hs_sg_grad_plain(
        _t(v), _t(ubp), _t(pb), _t(cb), _t(pm), W, 1.0)
    _assert_flushed(dv, gv, "hs_sg g_v")
    _assert_flushed(dbp, gbp, "hs_sg g_band_path")
    _assert_flushed(tl, loss, "hs_sg loss")
    # CBOW: the window mean against the center's own path.
    ub = _tiny_rows(rng, (C + 2 * W, D))
    up = _tiny_rows(rng, (C * L, D))
    path, code = _paths(rng, C, L)
    loss, gb, gp, ex = jax.jit(jdt._hs_cbow_loss_and_grads)(
        ub, up.reshape(C, L, D), path, code, pm)
    db, dp, tl, te = hs.hs_cbow_grad_plain(
        _t(ub), _t(up), _t(path), _t(code), _t(pm), W, 1.0)
    _assert_flushed(db, gb, "hs_cbow g_band")
    _assert_flushed(dp, gp, "hs_cbow g_path")
    _assert_flushed(tl, loss, "hs_cbow loss")
    assert float(te) == float(ex)


@pytest.mark.parametrize("C,K", [(20, 3), (9, 1)])
def test_pair_offset_flushes_as_reference(C, K):
    rng = np.random.default_rng(7 * C + K)
    D = 8
    v = _tiny_rows(rng, (C, D))
    up = _tiny_rows(rng, (C, D))
    un = _tiny_rows(rng, (C * K, D))
    m = (rng.random(C) < 0.8).astype(np.float32)
    loss, gv, gp, gn = jax.jit(jdt._pair_offset_loss_and_grads)(
        v, up, un.reshape(C, K, D), m)
    dv, du, tl, _ = pair.pair_offset_grad_plain(
        _t(v), _t(np.concatenate([up, un])), _t(m), K, 1.0)
    _assert_flushed(dv, gv, "g_v")
    _assert_flushed(du[:C], gp, "g_pos")
    _assert_flushed(du[C:], gn, "g_neg")
    _assert_flushed(tl, loss, "loss")


@pytest.mark.parametrize("mode", ["sgns", "cbow", "hs_sg", "hs_cbow"])
def test_compact_loss_flushes_as_reference(mode):
    """K9/K10's plain versions, their per-position rows summed into the
    tables in position order, against ``jax.value_and_grad`` of
    ``Word2Vec._compact_loss`` (NS and HS) jitted."""
    rng = np.random.default_rng(len(mode))
    B, W2, K, L, D, R_in, R_out, nb = 24, 4, 3, 5, 8, 16, 30, 4
    is_cbow, is_hs = "cbow" in mode, mode.startswith("hs")
    ein = _tiny_rows(rng, (R_in, D))
    eout = _tiny_rows(rng, (R_out, D))
    pair_mask = (rng.random(B) < 0.85).astype(np.float32)
    if is_cbow:
        win_l = rng.integers(0, R_in, (B, W2)).astype(np.int32)
        win_mask = (rng.random((B, W2)) < 0.6).astype(np.float32)
        win_mask[:2] = 0.0
        in_args = (win_l, win_mask)
    else:
        in_args = (rng.integers(0, R_in, B).astype(np.int32),)
    if is_hs:
        points = rng.integers(0, R_out, (B, L)).astype(np.int32)
        codes = np.full((B, L), -1, np.int32)
        for i, n in enumerate(rng.integers(1, L + 1, B)):
            codes[i, :n] = rng.integers(0, 2, n)
        out_args = (points, codes)
    else:
        out_args = (rng.integers(0, R_out, B).astype(np.int32),
                    rng.integers(0, R_out, (B // nb, K)).astype(np.int32))
    config = SimpleNamespace(cbow=is_cbow, hs=is_hs)
    loss_fn = JWord2Vec._compact_loss(SimpleNamespace(config=config))
    want_loss, (want_in, want_out) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1)))(ein, eout, in_args, out_args, pair_mask)
    in_idx = _t(in_args[0])
    win_mask = _t(in_args[1]) if is_cbow else None
    if is_hs:
        d_in, d_out, loss, _ = pairlist.pairlist_hs_grad_plain(
            _t(ein), _t(eout), in_idx, win_mask, _t(points), _t(codes),
            _t(pair_mask), 1.0)
        out_rows = _t(points).reshape(-1)
    else:
        d_in, d_out, loss, _ = pairlist.pairlist_ns_grad_plain(
            _t(ein), _t(eout), in_idx, win_mask, *(_t(a) for a in out_args),
            _t(pair_mask), 1.0)
        out_rows = torch.cat([_t(out_args[0]), _t(out_args[1]).reshape(-1)])
    g_in = torch.zeros(R_in, D)
    g_out = torch.zeros(R_out, D)
    row_scatter_add_plain(g_in, in_idx.reshape(-1), d_in)
    row_scatter_add_plain(g_out, out_rows, d_out)
    _assert_flushed(g_in, want_in, f"{mode} grad of ein")
    _assert_flushed(g_out, want_out, f"{mode} grad of eout")
    _assert_flushed(loss, want_loss, f"{mode} loss")


@pytest.mark.parametrize("objective,reg", [("sigmoid", "L2"),
                                           ("softmax", "L1"),
                                           ("linear", "")])
def test_sparse_step_flushes_as_reference(objective, reg):
    """K11 then K12 (sgd, scale 1: the touched rows' gradient) against
    ``make_sparse_step``'s gradient and loss."""
    rng = np.random.default_rng(len(objective))
    R, B, K = 40, 16, 5
    C = 3 if objective == "softmax" else 1
    w = _tiny_rows(rng, (R, C), frac=0.5)
    w[-1] = 0.0  # the padding row
    keys = rng.integers(0, R - 1, (B, K)).astype(np.int32)
    keys[:, -1] = R - 1
    keys[3, :2] = keys[2, :2]
    values = _tiny_rows(rng, (B, K), frac=0.3)
    labels = rng.integers(0, C if C > 1 else 2, B).astype(np.int32)
    weights = (rng.random(B) < 0.8).astype(np.float32)
    config = Configure(objective_type=objective, regular_type=reg,
                       regular_coef=0.25, output_size=C, input_size=R - 1,
                       sparse=True)
    loss_sum, _, grad = jobjective.make_sparse_step(config)(
        w, keys, values, labels, weights)
    act = {"sigmoid": logreg.ACT_SIGMOID, "softmax": logreg.ACT_SOFTMAX,
           "linear": logreg.ACT_LINEAR}[objective]
    regc = {"L1": logreg.REG_L1, "L2": logreg.REG_L2, "": logreg.REG_NONE}
    table = _t(w.copy())
    pred, diff, loss, _ = logreg.sparse_lr_forward_plain(
        table, _t(keys), _t(values), _t(labels), _t(weights), act)
    count = torch.tensor([max(float((weights > 0).sum()), 1.0)])
    rows, delta = logreg.sparse_lr_apply(
        table, _t(keys), _t(values), diff, count, reg=regc[reg], coef=0.25,
        scale=1.0, delta_rows=True)
    # The touched rows (K12 forms only these; the reference's gradient
    # is zero elsewhere).
    keep = rows < R
    _assert_flushed(delta[keep], np.asarray(grad)[rows[keep].numpy()],
                    f"{objective} gradient")
    _assert_flushed(loss.sum(), loss_sum, f"{objective} loss")


@pytest.mark.parametrize("shape", [(8, 6), (16, 5)])
def test_mesh_collectives_flush_as_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = _tiny_rows(rng, shape, frac=0.5)
    x[1::2] = (rng.integers(-40, 41, x[1::2].shape) * TINY).astype(
        np.float32)
    mesh = meshlib.local_mesh(8, device="cpu")
    _assert_flushed(allreduce_mesh(x, mesh), jallreduce_mesh(x),
                    "allreduce_mesh")
    _assert_flushed(pmean_mesh(_t(x), mesh), jpmean_mesh(x), "pmean_mesh")


# -- the row paths: the reference's zero extension of the delta --

R_TBL, C_TBL = 24, 50
RULES = ("default", "sgd", "momentum", "adagrad", "dcasgd")


def _tiny(rng, shape) -> np.ndarray:
    """Integers in [-40, 40] times 2^-130 with a fifth normal (~1e-37)
    and a tenth signed zeros."""
    x = (rng.integers(-40, 41, shape) * TINY).astype(np.float32)
    pick = rng.random(shape)
    x[pick < 0.2] = (rng.standard_normal(int((pick < 0.2).sum()))
                     * 1e-37).astype(np.float32)
    x[(pick >= 0.2) & (pick < 0.25)] = np.float32(-0.0)
    x[(pick >= 0.25) & (pick < 0.3)] = np.float32(0.0)
    return x


def _engines(rule: str, rng):
    want = jengine.UpdateEngine(jrules.create_rule(rule), (R_TBL, C_TBL),
                                np.float32, 2)
    got = UpdateEngine(trules.create_rule(rule), (R_TBL, C_TBL),
                       np.float32, 2, torch.device("cpu"))
    if want.state is not None:
        state = _tiny(rng, tuple(want.state.shape))
        if rule == "adagrad":
            state = np.abs(state)
        want._state = jnp.asarray(state)
        got._state.copy_(_t(state))
    return got, want


def _assert_table(rule: str, got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if rule != "adagrad":
        bad = np.flatnonzero(_bits(got) != _bits(want))
        assert bad.size == 0, f"{what}: {bad.size} elements differ"
        return
    small = np.abs(want) < 2.0 ** -126
    assert np.array_equal(_bits(got[small]), _bits(want[small])), what
    # 4 ulps a step; an id here repeats at most once, and the table's
    # values are far below the steps, so two steps can leave 8.
    d = np.abs(_bits(got).astype(np.int64) - _bits(want).astype(np.int64))
    assert d.max() <= 8, f"{what}: {d.max()} ulps"


@pytest.mark.parametrize("case", ["ids_past_delta", "narrow_delta", "both"])
@pytest.mark.parametrize("rule", RULES)
def test_row_zero_extension_flushes_as_reference(rule, case):
    """``apply_rows`` with host ids past a device delta's rows (in range,
    some repeating rows the delta reaches) and a delta narrower than
    the table: the table (and the state) bit for bit."""
    rng = np.random.default_rng(len(rule) * 7 + len(case))
    got, want = _engines(rule, rng)
    data = _tiny(rng, (R_TBL, C_TBL))
    ids = rng.permutation(R_TBL)[:14].astype(np.int32)
    ids = np.concatenate([ids, ids[:2], np.array([-3], np.int32)])
    k = ids.size if case == "narrow_delta" else ids.size - 7
    d = 37 if case != "ids_past_delta" else C_TBL
    delta = _tiny(rng, (k, d))
    kw = dict(worker_id=0, momentum=0.5, learning_rate=2.0 ** -7, rho=0.5,
              lambda_=2.0 ** -3)
    # A device delta keeps its rows (a host one is padded with the ids).
    jdata = want.apply_rows(jnp.asarray(data), ids, jnp.asarray(delta),
                            JAddOption(**kw))
    tdata = got.apply_rows(_t(data.copy()), ids, _t(delta), AddOption(**kw))
    _assert_table(rule, tdata.numpy(), jdata, f"{rule} {case}: table")
    if want.state is not None:
        assert np.array_equal(_bits(got.state.numpy()),
                              _bits(np.asarray(want.state))), \
            f"{rule} {case}: state"


@pytest.mark.parametrize("rule", RULES)
def test_fused_zero_extension_flushes_as_reference(rule):
    """``apply_rows_gather`` (K14) with a narrow delta of fewer rows than
    the bucket's ids, some past the delta in range: table, state and the
    gathered rows bit for bit."""
    rng = np.random.default_rng(len(rule) + 40)
    got, want = _engines(rule, rng)
    data = _tiny(rng, (R_TBL, C_TBL))
    ids = rng.permutation(R_TBL)[:16].astype(np.int32)  # a bucket of 16
    delta = _tiny(rng, (11, 44))
    get_ids = jengine.pad_ids(np.arange(0, R_TBL, 2), R_TBL)
    kw = dict(worker_id=0, momentum=0.5, learning_rate=2.0 ** -7, rho=0.5,
              lambda_=2.0 ** -3)
    jdata, jvals = want.apply_rows_gather(jnp.asarray(data), ids, delta,
                                          JAddOption(**kw), get_ids, C_TBL)
    tdata, tvals = got.apply_rows_gather(_t(data.copy()), ids, delta,
                                         AddOption(**kw), get_ids, C_TBL)
    _assert_table(rule, tdata.numpy(), jdata, f"{rule}: table")
    _assert_table(rule, tvals.numpy(), jvals, f"{rule}: gathered")
    if want.state is not None:
        assert np.array_equal(_bits(got.state.numpy()),
                              _bits(np.asarray(want.state))), f"{rule}: state"
