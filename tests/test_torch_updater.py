"""The port's updater rules and engine against the JAX package's.

The same seeded numpy inputs go through ``multiverso_tpu.updater``
(jitted on the CPU) and ``multiverso_tpu_torch.updater`` on CPU tensors,
so the kernels' plain versions run (K3 for the stateless rules' rows,
K13 for the stateful ones, K14 for the fused update + gather). Tables
are R=64 rows of C=5 columns, so rows are not 16-byte aligned.

Covered for every rule (default, sgd, momentum, adagrad, dcasgd):
``dense`` and ``rows`` on distinct ids, duplicate ids, the pad sentinel
and wrapped negative ids; a worker id in range and past the per-worker
slots (``dense`` reads the last slot, ``rows`` reads zeros, neither
writes the state); ``learning_rate=0``; the ``momentum_sgd`` alias and
integer tables; ``UpdateEngine.apply_dense`` on a storage wider than the
delta, ``apply_rows`` and ``apply_rows_gather`` with its bucket CHECK.

Tolerances: default and sgd on distinct ids bit for bit; every other
case rtol 1e-5 / atol 1e-7 (duplicate ids sum in another order, and
the reference's rsqrt differs by an ulp from the port's 1/sqrt). The
port's AdaGrad step is pinned to ``(rho*g) * (1/sqrt(G + eps))``, two
correctly rounded operations, bit for bit.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu.updater.options import AddOption as JAddOption
from multiverso_tpu_torch.updater import AddOption, UpdateEngine
from multiverso_tpu_torch.updater import rules as trules

R, C, W = 64, 5, 2
RULES = ("default", "sgd", "momentum", "adagrad", "dcasgd")
STATEFUL = ("momentum", "adagrad", "dcasgd")
HYP = np.array([0.9, 0.01, 0.1, 0.1], np.float32)  # m, lr, rho, lambda
TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Leaves the port's flag registry at its defaults and its role
    threads at their baseline (tests/conftest.py guards only the
    reference's)."""
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
    assert sum(thread_roles.roles_alive().values()) <= before


def _inputs(rule: str, seed: int = 0, shape=(R, C)):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape).astype(np.float32)
    if rule == "momentum":
        state = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    elif rule in ("adagrad", "dcasgd"):
        state = (np.abs(rng.standard_normal((W,) + shape))
                 * 0.01).astype(np.float32)
        if rule == "dcasgd":
            state = (data[None] + state).astype(np.float32)
    else:
        state = None
    return rng, data, state


def _jax_rule(rule: str):
    return jrules.create_rule(rule)


def _run_jax(fn, data, state, *args):
    out = jax.jit(fn)(jnp.asarray(data),
                      None if state is None else jnp.asarray(state), *args)
    return np.asarray(out[0]), None if out[1] is None else np.asarray(out[1])


def _run_port(rule: str, method: str, data, state, *args):
    d = torch.from_numpy(data.copy())
    s = None if state is None else torch.from_numpy(state.copy())
    getattr(trules.create_rule(rule), method)(d, s, *args)
    return d.numpy(), None if s is None else s.numpy()


def _same(got, want, exact: bool):
    for g, w, name in zip(got, want, ("data", "state")):
        if w is None:
            assert g is None
        elif exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("worker", [0, 1, 5])
@pytest.mark.parametrize("rule", RULES)
def test_dense_matches_reference(rule, worker):
    rng, data, state = _inputs(rule)
    delta = (rng.standard_normal((R, C)) * 0.01).astype(np.float32)
    want = _run_jax(_jax_rule(rule).dense, data, state, jnp.asarray(delta),
                    HYP, np.int32(worker))
    got = _run_port(rule, "dense", data, state, torch.from_numpy(delta),
                    HYP, worker)
    _same(got, want, exact=rule in ("default", "sgd"))
    if rule in ("adagrad", "dcasgd") and worker >= W:
        # The write drops; the read took the last slot, not zeros.
        np.testing.assert_array_equal(got[1], state)
        zero_read = _run_jax(_jax_rule(rule).dense, data,
                             np.zeros_like(state), jnp.asarray(delta), HYP,
                             np.int32(W - 1))
        assert not np.allclose(got[0], zero_read[0])


def _ids(kind: str, rng) -> np.ndarray:
    if kind == "distinct":
        return rng.permutation(R)[:24].astype(np.int32)
    if kind == "duplicates":
        ids = rng.integers(0, R, 24).astype(np.int32)
        ids[5:9] = ids[0]
        ids[12] = ids[3]
        return ids
    # The pad sentinel, ids past it, wrapped negatives (alone and
    # beside their positive twin) and ids below -R.
    ids = rng.permutation(R)[:16].astype(np.int32)
    return np.concatenate([ids, np.array(
        [R, R + 3, -1, -R, -(R + 2), R - 1, -2, 2 ** 30],
        np.int32)])


@pytest.mark.parametrize("worker", [0, 5])
@pytest.mark.parametrize("kind", ["distinct", "duplicates", "edges"])
@pytest.mark.parametrize("rule", RULES)
def test_rows_match_reference(rule, kind, worker):
    rng, data, state = _inputs(rule, seed=1)
    ids = _ids(kind, rng)
    k = ids.size - 3  # the last 3 ids take a zero delta (row extension)
    delta = (rng.standard_normal((k, C)) * 0.01).astype(np.float32)
    padded = np.concatenate([delta, np.zeros((3, C), np.float32)])
    want = _run_jax(_jax_rule(rule).rows, data, state, jnp.asarray(ids),
                    jnp.asarray(padded), HYP, np.int32(worker))
    got = _run_port(rule, "rows", data, state, torch.from_numpy(ids),
                    torch.from_numpy(delta), HYP, worker)
    _same(got, want, exact=rule in ("default", "sgd") and kind == "distinct")
    if rule in ("adagrad", "dcasgd") and worker >= W:
        np.testing.assert_array_equal(got[1], state)


@pytest.mark.parametrize("method", ["dense", "rows"])
@pytest.mark.parametrize("rule", ["adagrad", "dcasgd"])
def test_zero_learning_rate_stays_finite(rule, method):
    rng, data, state = _inputs(rule, seed=2)
    hyp = HYP.copy()
    hyp[1] = 0.0
    delta = np.zeros((R, C), np.float32)
    delta[3] = 0.5  # a nonzero delta at lr 0: the clamp keeps it finite
    if method == "dense":
        args_j = (jnp.asarray(delta), hyp, np.int32(0))
        args_t = (torch.from_numpy(delta), hyp, 0)
    else:
        ids = np.arange(R, dtype=np.int32)
        args_j = (jnp.asarray(ids), jnp.asarray(delta), hyp, np.int32(0))
        args_t = (torch.from_numpy(ids), torch.from_numpy(delta), hyp, 0)
    want = _run_jax(getattr(_jax_rule(rule), method), data, state, *args_j)
    got = _run_port(rule, method, data, state, *args_t)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    _same(got, want, exact=False)


def test_rule_names_and_integer_tables():
    for name, cls in (("momentum_sgd", trules.MomentumRule),
                      ("momentum", trules.MomentumRule),
                      ("adagrad", trules.AdaGradRule),
                      ("dcasgd", trules.DCASGDRule),
                      ("sgd", trules.SGDRule)):
        got, want = trules.create_rule(name), jrules.create_rule(name)
        assert isinstance(got, cls) and got.name == want.name
        assert got.stateless == want.stateless
        assert type(trules.create_rule(name, np.int32)) is trules.DefaultRule
        assert type(jrules.create_rule(name, np.int32)).__name__ \
            == "DefaultRule"
    state = trules.create_rule("adagrad").init_state((R, C), np.float32, 3,
                                                     "cpu")
    assert state.shape == (3, R, C) and state.device.type == "cpu"
    assert trules.create_rule("momentum").init_state(
        (R, C), np.float32, 3).shape == (R, C)


def _engines(rule: str, shape, workers: int = W):
    want = jengine.UpdateEngine(jrules.create_rule(rule), shape, np.float32,
                                workers)
    got = UpdateEngine(trules.create_rule(rule), shape, np.float32, workers,
                       torch.device("cpu"))
    return got, want


def _options(worker: int):
    kw = dict(worker_id=worker, momentum=0.9, learning_rate=0.01, rho=0.1,
              lambda_=0.1)
    return AddOption(**kw), JAddOption(**kw)


def _state_np(engine):
    st = engine.state
    return None if st is None else np.asarray(st)


@pytest.mark.parametrize("rule", RULES)
def test_engine_dense_on_wider_storage(rule):
    # The storage is 8 columns wide and 1-D shards pad too: the port runs
    # the rule on the logical block, the reference on a zero-extended
    # delta; tables and state must agree.
    for shape, delta_shape in (((R, 8), (R - 4, C)), ((R,), (R - 4,))):
        got, want = _engines(rule, shape)
        rng = np.random.default_rng(3)
        jdata = jnp.zeros(shape, jnp.float32)
        tdata = torch.zeros(shape)
        for step in range(3):
            delta = (rng.standard_normal(delta_shape) * 0.01).astype(
                np.float32)
            topt, jopt = _options(step % 2)
            jdata = want.apply_dense(jdata, jnp.asarray(delta), jopt)
            tdata = got.apply_dense(tdata, torch.from_numpy(delta), topt)
        np.testing.assert_allclose(tdata.numpy(), np.asarray(jdata), **TOL)
        if want.state is not None:
            np.testing.assert_allclose(_state_np(got), _state_np(want),
                                       **TOL)


@pytest.mark.parametrize("rule", RULES)
def test_engine_rows_and_fused_gather_match_reference(rule):
    got, want = _engines(rule, (R, C))
    rng = np.random.default_rng(4)
    jdata = jnp.asarray(rng.standard_normal((R, C)).astype(np.float32))
    tdata = torch.from_numpy(np.asarray(jdata).copy())
    for step in range(4):
        ids = rng.integers(0, R, 12).astype(np.int32)
        ids[3] = ids[0]  # a duplicate
        delta = (rng.standard_normal((12, C)) * 0.01).astype(np.float32)
        topt, jopt = _options(step % 2)
        jdata = want.apply_rows(jdata, ids, delta, jopt)
        tdata = got.apply_rows(tdata, ids, delta, topt)
        # The fused form: bucket-padded add ids, a device delta of the
        # logical rows, and padded get ids (the sentinel reads zeros).
        add = jengine.pad_ids(ids[:7], R)
        get = jengine.pad_ids(np.array([ids[0], 5, 63, 0, 9], np.int32), R)
        jdata, jvals = want.apply_rows_gather(
            jdata, jnp.asarray(add), jnp.asarray(delta[:7]), jopt,
            jnp.asarray(get), 3)
        tdata, tvals = got.apply_rows_gather(
            tdata, torch.from_numpy(add), torch.from_numpy(delta[:7]), topt,
            torch.from_numpy(get), 3)
        assert tuple(tvals.shape) == tuple(jvals.shape) == (8, 3)
        np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), **TOL)
        assert not tvals[5:].any()
    np.testing.assert_allclose(tdata.numpy(), np.asarray(jdata), **TOL)
    if want.state is not None:
        np.testing.assert_allclose(_state_np(got), _state_np(want), **TOL)


def test_fused_gather_needs_bucket_padded_ids():
    for engine, data, as_arr in (
            (_engines("sgd", (R, C))[0], torch.zeros(R, C),
             torch.from_numpy),
            (_engines("sgd", (R, C))[1], jnp.zeros((R, C)), jnp.asarray)):
        ids = np.arange(12, dtype=np.int32)
        with pytest.raises(Exception, match="bucket-padded"):
            engine.apply_rows_gather(data, as_arr(ids),
                                     as_arr(np.ones((12, C), np.float32)),
                                     None, as_arr(ids[:8]), C)


def test_device_key_rows_need_a_stateless_rule():
    got, _ = _engines("adagrad", (R, C))
    with pytest.raises(Exception, match="stateless"):
        got.apply_rows(torch.zeros(R, C), torch.tensor([1, 1],
                                                       dtype=torch.int32),
                       torch.ones(2, C))


def test_kernel_wrappers_check_rule_and_state():
    from multiverso_tpu_torch.kernels import rules as krules
    data, ids = torch.zeros(R, C), torch.arange(4, dtype=torch.int32)
    delta, state = torch.ones(4, C), torch.zeros(R, C)
    with pytest.raises(ValueError, match="expected one of"):
        krules.row_rule_apply("sgd", data, None, ids, delta, HYP, 0)
    with pytest.raises(ValueError, match="with state False"):
        krules.row_rule_apply("momentum", data, None, ids, delta, HYP, 0)
    with pytest.raises(ValueError, match="with state True"):
        krules.rows_apply_gather("default", data, state, ids, delta, HYP, 0,
                                 ids, C)
    with pytest.raises(ValueError, match="k <= 4 ids"):
        krules.row_rule_apply("momentum", data, state, ids,
                              torch.ones(5, C), HYP, 0)
    with pytest.raises(ValueError, match="n_col"):
        krules.rows_apply_gather("sgd", data, None, ids, delta, HYP, 0,
                                 ids, C + 1)


def test_adagrad_step_is_one_over_sqrt():
    # K13's plain AdaGrad step, formed step by step in float32 in the
    # reference's expression order with 1/sqrt, each operation correctly
    # rounded (numpy's, and K13's __fdiv_rn(1, __fsqrt_rn(.)) on the
    # card), bit for bit. (torch.sqrt of a float32 CPU tensor is not
    # correctly rounded for ~0.6% of inputs on an AVX512 host.) G + g*g
    # is one fused multiply-add, as the reference's XLA contracts it
    # (ROADMAP C13): the exact sum, rounded once.
    from fractions import Fraction
    from multiverso_tpu_torch.kernels import rules as krules
    rng = np.random.default_rng(21)
    rows, cols = 512, 16
    data = rng.standard_normal((rows, cols)).astype(np.float32)
    state = (np.abs(rng.standard_normal((1, rows, cols))) * 10.0
             ).astype(np.float32)
    ids = rng.permutation(rows)[:300].astype(np.int32)
    delta = (rng.standard_normal((ids.size, cols)) * 0.01
             ).astype(np.float32)
    m, lr, rho, lam = HYP
    g = delta / np.maximum(lr, np.float32(1e-12))
    g_sqr = np.array(
        [np.float32(Fraction(float(a)) * Fraction(float(a))
                    + Fraction(float(b)))
         for a, b in zip(g.reshape(-1), state[0, ids].reshape(-1))],
        np.float32).reshape(g.shape)
    inv_sqrt = np.float32(1) / np.sqrt(g_sqr + np.float32(1e-6))
    step = (rho * g) * inv_sqrt
    want = data.copy()
    want[ids] = data[ids] - step
    got_d, got_s = torch.from_numpy(data.copy()), torch.from_numpy(
        state.copy())
    krules.row_rule_apply_plain("adagrad", got_d, got_s,
                                torch.from_numpy(ids),
                                torch.from_numpy(delta), HYP, 0)
    np.testing.assert_array_equal(got_d.numpy(), want)
    np.testing.assert_array_equal(got_s.numpy()[0, ids], g_sqr)
