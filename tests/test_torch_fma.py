"""The stateful rules' fused multiply-adds, bit for bit against the
reference (ROADMAP C13).

The reference's XLA (on the CPU) contracts some products into the add
that follows them: the product is neither rounded nor flushed, and the
sum is rounded once. Which products it fuses depends on the program.
Pinned here, on inputs where the fused and the rounded forms differ in
the last bit (hyperparameters that are not powers of two, so products
are inexact):

- ``UpdateEngine.apply_rows`` and ``apply_rows_gather``
  (``MomentumRule.rows``, ``AdaGradRule.rows``, ``DCASGDRule.rows``):
  momentum ``fma(m, s, (1 - m) * d)``; AdaGrad ``fma(g, g, G)``; DCASGD
  ``fma(lr * lam * g * g, x - b, d)``.
- ``UpdateEngine.apply_dense``: momentum as above; AdaGrad ``fma(g, g,
  G)`` and the table's ``fma(-(rho * g), r, x)``; DCASGD
  ``fma(lr, comp, d)``.

The port forms the same: ``kernels/flush.py`` ``fma`` (exact, on both
devices) in the plain versions and the dense rules, ``__fmaf_rn`` in
K13/K14 on the card. Rows of 50 and 128 floats (the table benchmark's
and the word2vec tables' widths), and the narrow rows 1, 3, 5, 8 and 16:
there momentum's row programs fuse the OTHER product, ``(1 - m) * d``,
in the last column (``rules.momentum_swap_col``: XLA's CPU backend
unrolls the column loop of rows up to 29 floats and shares the last
column's fused multiply-add with the out-of-range branch; ROADMAP C13).
Both need a host with FMA instructions: without them the reference
rounds every product.

AdaGrad's step goes through the reference's ``rsqrt``, which XLA's CPU
code generation approximates; the port takes ``1 / sqrt`` correctly
rounded (ROADMAP C10) and the card cannot reproduce that approximation.
So AdaGrad's table is held within 4 ulps of its steps and of its value
(its zeros bit for bit), its state (no root in it) bit for bit.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu.updater.options import AddOption as JAddOption
from multiverso_tpu_torch.kernels import flush as ftz
from multiverso_tpu_torch.updater import AddOption, UpdateEngine
from multiverso_tpu_torch.updater import rules as trules

R, NW = 96, 2
STATEFUL = ("momentum", "adagrad", "dcasgd")
HYP = dict(momentum=0.9, learning_rate=0.01, rho=0.1, lambda_=0.3)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _assert_bits(got, want, what: str) -> None:
    g, w = _bits(got).reshape(-1), _bits(want).reshape(-1)
    bad = np.flatnonzero(g != w)
    assert bad.size == 0, (
        f"{what}: {bad.size} of {g.size} differ, first at {bad[:5]}: "
        f"{np.asarray(got).reshape(-1)[bad[:5]]} vs "
        f"{np.asarray(want).reshape(-1)[bad[:5]]}")


def _assert_ulps(got, want, steps, what: str) -> None:
    """Within 4 ulps (2^-21 relative) of the steps that reached each
    element (``steps``: the sum of their magnitudes) plus 4 of the
    result: the root's error scales each step, and the table's
    subtraction can cancel; zeros bit for bit."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    small = want == 0
    _assert_bits(got[small], want[small], f"{what} (zeros)")
    err = np.abs(got.astype(np.float64) - want)
    bound = 2.0 ** -21 * (np.asarray(steps, np.float64) + np.abs(want))
    bad = np.flatnonzero((err > bound).reshape(-1))
    assert bad.size == 0, f"{what}: {bad.size} past 4 ulps, at {bad[:5]}"


def _adagrad_steps(data, state, ids, delta, width) -> np.ndarray:
    """Per table element, the summed magnitude of AdaGrad's row steps
    (the port's plain ``rule_step``) of the ids in range."""
    from multiverso_tpu_torch.kernels.rules import rule_step
    ids = np.asarray(ids)
    k = delta.shape[0]
    ok = ids[:k] < R
    hyp = (HYP["momentum"], HYP["learning_rate"], HYP["rho"],
           HYP["lambda_"])
    x0 = torch.from_numpy(data[ids[:k][ok]])
    s0 = torch.from_numpy(np.asarray(state)[0][ids[:k][ok]])
    step, _ = rule_step("adagrad", hyp, x0, s0,
                        torch.from_numpy(np.asarray(delta)[ok]))
    out = np.zeros((R, width))
    np.add.at(out, ids[:k][ok], np.abs(step.numpy()))
    return out


def _values(rng, shape, kind: str) -> np.ndarray:
    """Normal values; under ``edge`` a third of them just above 2^-126,
    where a product with a factor below 1 is subnormal (kept inside a
    fused add, flushed by a rounded product)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "edge":
        pick = rng.random(shape) < 0.33
        x[pick] = (np.sign(x[pick]) * (1.0 + rng.random(int(pick.sum())))
                   * 2.0 ** -126).astype(np.float32)
    return x


def _engines(rule: str, width: int, rng, kind: str):
    want = jengine.UpdateEngine(jrules.create_rule(rule), (R, width),
                                np.float32, NW)
    got = UpdateEngine(trules.create_rule(rule), (R, width), np.float32,
                       NW, torch.device("cpu"))
    state = _values(rng, tuple(want.state.shape), kind)
    if rule == "adagrad":
        state = np.abs(state)
    want._state = jnp.asarray(state)
    got._state.copy_(torch.from_numpy(state))
    return got, want


def _check(rule, got, want, tdata, jdata, steps, what) -> None:
    if rule == "adagrad":
        _assert_ulps(tdata, jdata, steps, f"{what}: table")
    else:
        _assert_bits(tdata, jdata, f"{what}: table")
    _assert_bits(got.state.numpy(), np.asarray(want.state),
                 f"{what}: state")


def _rounded_differs(rule: str, x0, s0, dv) -> bool:
    """Whether the rule's contracted expression, rounded at every
    operation instead, differs somewhere from the fused form on these
    inputs (the inputs can tell the two apart)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    f = ftz.flush
    m, lr = np.float32(HYP["momentum"]), np.float32(HYP["learning_rate"])
    lam = np.float32(HYP["lambda_"])
    x0, s0, dv = f(t(x0)), f(t(s0)), f(t(dv))
    if rule == "momentum":
        a, b, c = torch.full_like(s0, float(m)), s0, f(
            float(np.float32(1) - m) * dv)
    elif rule == "adagrad":
        g = f(dv / float(lr))
        a, b, c = g, g, s0
    else:
        g = f(dv / float(lr))
        a = f(f(f(float(np.float32(lr * lam)) * g)) * g)
        b, c = f(x0 - s0), dv
    fused = ftz.fma(a, b, c)
    rounded = f(f(f(a) * f(b)) + c)
    return bool((_bits(fused.numpy()) != _bits(rounded.numpy())).any())


@pytest.mark.parametrize("seed", range(4))
def test_fma_rounds_once(seed):
    """``flush.fma`` against exact rational arithmetic rounded to nearest
    float32 (ties to even), on products whose sums land halfway cases
    and cancel."""
    rng = np.random.default_rng(seed)
    n = 400
    a = _values(rng, n, "normal")
    b = _values(rng, n, "normal")
    c = _values(rng, n, "normal")
    c[:100] = -(a[:100].astype(np.float64) * b[:100]).astype(np.float32)
    c[100:150] = np.float32(0)
    got = ftz.fma(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # The nearest float32 of the exact value, ties to even.
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        near = [v for v, d in zip(cands, dist) if d == best]
        want = near[0] if len(near) == 1 else \
            [v for v in near if _bits(v) % 2 == 0][0]
        if abs(float(want)) < 2.0 ** -126:
            want = np.float32(0.0) if float(exact) >= 0 else np.float32(-0.0)
        assert _bits(got[i]) == _bits(want), (i, a[i], b[i], c[i], got[i],
                                              want)


def test_fma_keeps_a_subnormal_product_and_flushes_operands():
    one = torch.tensor([2.0 ** -100], dtype=torch.float32)
    tiny = torch.tensor([2.0 ** -30], dtype=torch.float32)
    # The product 2^-130 is subnormal, kept inside the fused add.
    got = ftz.fma(one, tiny, torch.tensor([2.0 ** -120]))
    assert float(got) == float(np.float32(2.0 ** -120 + 2.0 ** -130))
    # A subnormal operand reads as zero; a subnormal result flushes.
    sub = torch.tensor([2.0 ** -140], dtype=torch.float32)
    assert float(ftz.fma(sub, torch.tensor([2.0 ** 100]),
                         torch.tensor([0.0]))) == 0.0
    res = ftz.fma(one, tiny, torch.tensor([0.0]))
    assert _bits(res.numpy())[0] == 0


def _ids(kind: str, rng) -> np.ndarray:
    if kind == "ascending":
        return np.sort(rng.permutation(R)[:40]).astype(np.int32)
    ids = rng.integers(0, R, 40).astype(np.int32)
    ids[5:9] = ids[0]
    return ids


#: (rule, row width): every rule at the wide rows; momentum (whose last
#: column swaps its fused product) and DCASGD at the narrow ones. AdaGrad
#: stays at the wide rows: where its repeated steps cancel to an exact
#: zero in the reference (width 8, repeats, edge), the port's correctly
#: rounded ``1 / sqrt`` leaves a residue (ROADMAP C10).
ROW_CASES = [(rule, w) for rule in STATEFUL for w in (50, 128)] + [
    (rule, w) for rule in ("momentum", "dcasgd") for w in (1, 3, 5, 8, 16)]


@pytest.mark.parametrize("kind", ["normal", "edge"])
@pytest.mark.parametrize("ids_kind", ["ascending", "repeats"])
@pytest.mark.parametrize("rule,width", ROW_CASES)
def test_apply_rows_contracts_as_reference(rule, width, ids_kind, kind):
    rng = np.random.default_rng(width + len(kind) + len(ids_kind))
    got, want = _engines(rule, width, rng, kind)
    data = _values(rng, (R, width), kind)
    ids = _ids(ids_kind, rng)
    delta = (_values(rng, (ids.size, width), kind) * 0.01).astype(np.float32)
    s0 = np.asarray(want.state)
    s0 = (s0 if rule == "momentum" else s0[0])[ids]
    assert _rounded_differs(rule, data[ids], s0, delta)
    opt, jopt = AddOption(worker_id=0, **HYP), JAddOption(worker_id=0,
                                                          **HYP)
    for step in range(2):
        steps = _adagrad_steps(data, want.state, ids, delta, width) \
            if rule == "adagrad" else None
        jdata = want.apply_rows(jnp.asarray(data), ids, delta, jopt)
        tdata = got.apply_rows(torch.from_numpy(data.copy()), ids, delta,
                               opt)
        _check(rule, got, want, tdata.numpy(), np.asarray(jdata), steps,
               f"{rule} apply_rows, step {step}")
        data = np.asarray(jdata).copy()
        got._state.copy_(torch.from_numpy(np.array(want.state)))


@pytest.mark.parametrize("kind", ["normal", "edge"])
@pytest.mark.parametrize("rule,width", ROW_CASES)
def test_apply_rows_gather_contracts_as_reference(rule, width, kind):
    rng = np.random.default_rng(3 * width + len(kind))
    got, want = _engines(rule, width, rng, kind)
    data = _values(rng, (R, width), kind)
    ids = jengine.pad_ids(_ids("repeats", rng)[:27], R)
    delta = (_values(rng, (27, width), kind) * 0.01).astype(np.float32)
    get_ids = jengine.pad_ids(np.arange(0, R, 3), R)
    opt, jopt = AddOption(worker_id=0, **HYP), JAddOption(worker_id=0,
                                                          **HYP)
    steps = _adagrad_steps(data, want.state, ids, delta, width) \
        if rule == "adagrad" else None
    jdata, jvals = want.apply_rows_gather(jnp.asarray(data), ids, delta,
                                          jopt, get_ids, width)
    tdata, tvals = got.apply_rows_gather(torch.from_numpy(data.copy()), ids,
                                         delta, opt, get_ids, width)
    _check(rule, got, want, tdata.numpy(), np.asarray(jdata), steps,
           f"{rule} apply_rows_gather")
    if rule == "adagrad":
        _assert_ulps(tvals.numpy(), np.asarray(jvals),
                     steps[np.minimum(get_ids, R - 1)], "gathered")
    else:
        _assert_bits(tvals.numpy(), np.asarray(jvals), "gathered")


@pytest.mark.parametrize("kind", ["normal", "edge"])
@pytest.mark.parametrize("width", [1, 16, 50, 128])
@pytest.mark.parametrize("rule", STATEFUL)
def test_apply_dense_contracts_as_reference(rule, width, kind):
    rng = np.random.default_rng(5 * width + len(kind))
    got, want = _engines(rule, width, rng, kind)
    data = _values(rng, (R, width), kind)
    delta = (_values(rng, (R, width), kind) * 0.01).astype(np.float32)
    opt, jopt = AddOption(worker_id=1, **HYP), JAddOption(worker_id=1,
                                                          **HYP)
    for step in range(2):
        steps = None
        if rule == "adagrad":
            steps = _adagrad_steps(data, want.state[1:], np.arange(R),
                                   delta, width)
        jdata = want.apply_dense(jnp.asarray(data), delta, jopt)
        tdata = got.apply_dense(torch.from_numpy(data.copy()), delta, opt)
        _check(rule, got, want, tdata.numpy(), np.asarray(jdata), steps,
               f"{rule} apply_dense, step {step}")
        data = np.asarray(jdata).copy()
        got._state.copy_(torch.from_numpy(np.array(want.state)))
