"""Float32 subnormals on the row and dense update paths, bit for bit
against the reference.

The reference's jitted updates run with flush-to-zero and
denormals-are-zero (XLA's CPU runtime; a TPU keeps no subnormals): an
operation reads a subnormal as a zero of its sign and writes a
subnormal result as one. The port flushes the same way: the kernels
through ``-ftz=true``, the plain versions through
``multiverso_tpu_torch/kernels/flush.py``. Tables, optimizer state and
deltas here are integers times 2^-130, so most values and many sums are
subnormal, mixed with normal values; every result is compared as int32
bits (a zero's sign included).

The port's side, on CPU tensors (the kernels' plain versions): K3
``row_scatter_add`` in both forms (host ids the engine finds
ascending: one writer; ids that repeat: the sequential plain version
and the kernel-order ``row_scatter_add_ordered``, which are the same
sums here: no run crosses a task's cut), K13 ``row_rule_apply``
(momentum, adagrad, dcasgd), the fused K14 ``rows_apply_gather``
(through ``UpdateEngine.apply_rows_gather``) and the dense rules
(``UpdateEngine.apply_dense``). The reference's side:
``UpdateEngine.apply_rows`` / ``apply_rows_gather`` / ``apply_dense``
of ``multiverso_tpu``, jitted on the CPU.

Two differences that are not about subnormals are kept out of the
comparison. (1) The reference's XLA contracts ``a * b + c`` into one
fused multiply-add, whose product is neither rounded nor flushed; the
port rounds and flushes each operation, as K13 does on the card. The
hyperparameters are powers of two (momentum 0.5, learning rate 2^-7,
rho 0.5, lambda 2^-3), so the products are exact wherever they are
normal, and under momentum the state and the deltas avoid [2^-126,
2^-125) in magnitude, where ``0.5 * s`` or ``0.5 * d`` would be a
subnormal product inside the reference's fused add (which of the two
products XLA fuses varies with the program). (2) AdaGrad's
step goes through the reference's ``rsqrt``, an approximation, where
the port takes ``1 / sqrt`` correctly rounded (ROADMAP C10): its table
is held within 4 ulps, with the same zeros (sign included) and the
same subnormals (untouched elements); its state bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu.updater.options import AddOption as JAddOption
from multiverso_tpu_torch.kernels import rows, rules
from multiverso_tpu_torch.updater import AddOption, UpdateEngine
from multiverso_tpu_torch.updater import rules as trules

R, C, W = 24, 5, 2
RULES = ("default", "sgd", "momentum", "adagrad", "dcasgd")
STATEFUL = ("momentum", "adagrad", "dcasgd")
TINY = 2.0 ** -130


def _tiny(rng, shape, spread: int = 40, rule: str = "") -> np.ndarray:
    """Integers in [-spread, spread] times 2^-130: below 16 in magnitude
    subnormal, above it normal; a fifth of them normal and ~1e-37, a
    tenth signed zeros. Under ``rule`` momentum none in [2^-126,
    2^-125) in magnitude (moved to 2^-125: see the module's note)."""
    x = (rng.integers(-spread, spread + 1, shape) * TINY).astype(np.float32)
    pick = rng.random(shape)
    x[pick < 0.2] = (rng.standard_normal(int((pick < 0.2).sum()))
                     * 1e-37).astype(np.float32)
    x[(pick >= 0.2) & (pick < 0.25)] = np.float32(-0.0)
    x[(pick >= 0.25) & (pick < 0.3)] = np.float32(0.0)
    if rule == "momentum":
        band = (np.abs(x) >= 2.0 ** -126) & (np.abs(x) < 2.0 ** -125)
        x[band] = np.copysign(np.float32(2.0 ** -125), x[band])
    return x


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _assert_bits(got, want, what: str) -> None:
    g, w = _bits(got), _bits(want)
    bad = np.flatnonzero(g.reshape(-1) != w.reshape(-1))
    assert bad.size == 0, (
        f"{what}: {bad.size} elements differ, first at {bad[:5]}: "
        f"{np.asarray(got).reshape(-1)[bad[:5]]} vs "
        f"{np.asarray(want).reshape(-1)[bad[:5]]}")


def _engines(rule: str, shape=(R, C)):
    want = jengine.UpdateEngine(jrules.create_rule(rule), shape, np.float32,
                                W)
    got = UpdateEngine(trules.create_rule(rule), shape, np.float32, W,
                       torch.device("cpu"))
    return got, want


def _seed_state(got, want, rng) -> None:
    """The same subnormal-laden optimizer state in both engines."""
    if want.state is None:
        return
    state = _tiny(rng, tuple(want.state.shape), rule=got.rule.name)
    want._state = jnp.asarray(state)
    got._state.copy_(torch.from_numpy(state))


def _options(worker: int = 0):
    kw = dict(worker_id=worker, momentum=0.5, learning_rate=2.0 ** -7,
              rho=0.5, lambda_=2.0 ** -3)
    return AddOption(**kw), JAddOption(**kw)


def _assert_near(got, want, what: str) -> None:
    """Bit for bit where the reference holds a zero or a subnormal (an
    untouched row, or a flushed result), within 4 ulps (2^-21 relative)
    elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    small = np.abs(want) < 2.0 ** -126
    _assert_bits(got[small], want[small], f"{what} (zeros, subnormals)")
    np.testing.assert_allclose(got, want, rtol=2.0 ** -21, atol=0,
                               err_msg=what)


def _check(got, want, tdata, jdata, what: str) -> None:
    if got.rule.name == "adagrad":
        _assert_near(tdata.numpy(), jdata, f"{what}: table")
    else:
        _assert_bits(tdata.numpy(), jdata, f"{what}: table")
    if want.state is not None:
        _assert_bits(got.state.numpy(), np.asarray(want.state),
                     f"{what}: state")


def _steps(rule: str) -> int:
    """Updates in a row: one under momentum and AdaGrad, whose first
    update can leave state in the band of the module's note (momentum)
    or table rows that cancel against the next step (AdaGrad, held to
    4 ulps)."""
    return 1 if rule in ("momentum", "adagrad") else 3


def _ids(kind: str, rng) -> np.ndarray:
    if kind == "ascending":
        return np.sort(rng.permutation(R)[:14]).astype(np.int32)
    ids = rng.integers(0, R, 20).astype(np.int32)
    ids[4:9] = ids[0]
    ids[12] = ids[3]
    return ids


def test_flush_keeps_the_sign_and_the_normals():
    from multiverso_tpu_torch.kernels import flush as ftz
    x = torch.tensor([1e-40, -1e-40, 2.0 ** -126, -(2.0 ** -126), 0.0, -0.0,
                      1.5, float("inf"), 2.0 ** -149], dtype=torch.float32)
    got = ftz.flush(x)
    want = np.array([0.0, -0.0, 2.0 ** -126, -(2.0 ** -126), 0.0, -0.0, 1.5,
                     np.inf, 0.0], np.float32)
    _assert_bits(got.numpy(), want, "flush")
    assert torch.isnan(ftz.flush(torch.tensor([float("nan")])))[0]
    ints = torch.tensor([1, -2, 3])
    assert ftz.flush(ints) is ints


@pytest.mark.parametrize("seed", range(3))
def test_add_rows_is_the_flushed_sequential_sum(seed):
    """Both arms of ``add_rows`` (index_add_ where no sum can reach a
    subnormal, else occurrence by occurrence) against a scalar loop in
    float32 with every add flushed."""
    from multiverso_tpu_torch.kernels import flush as ftz
    rng = np.random.default_rng(seed)
    for scale in (1.0, TINY):
        table = (rng.standard_normal((R, C)) * scale).astype(np.float32)
        rows_np = rng.integers(0, R, 40)
        rows_np[:9] = 3
        src = (rng.standard_normal((40, C)) * scale).astype(np.float32)

        def f(v):
            return np.float32(0.0) * v if abs(v) < 2.0 ** -126 else v

        want = table.copy()
        for r, s in zip(rows_np, src):
            for c in range(C):
                want[r, c] = f(np.float32(f(want[r, c]) + f(s[c])))
        got = torch.from_numpy(table.copy())
        ftz.add_rows(got, torch.from_numpy(rows_np), torch.from_numpy(src))
        _assert_bits(got.numpy(), want, f"add_rows at scale {scale}")


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_row_scatter_add_one_writer_flushes_as_reference(sign):
    rule = "default" if sign > 0 else "sgd"
    rng = np.random.default_rng(10)
    got, want = _engines(rule)
    data = _tiny(rng, (R, C))
    ids = _ids("ascending", rng)
    delta = _tiny(rng, (ids.size, C))
    jdata = want.apply_rows(jnp.asarray(data), ids, delta)
    tdata = got.apply_rows(torch.from_numpy(data.copy()), ids, delta)
    _check(got, want, tdata, jdata, f"{rule} engine, ascending ids")
    # The wrapper itself, with the claim the engine makes.
    direct = torch.from_numpy(data.copy())
    rows.row_scatter_add(direct, torch.from_numpy(ids),
                         torch.from_numpy(delta), sign, distinct=True)
    _assert_bits(direct.numpy(), jdata, f"{rule} row_scatter_add distinct")


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_row_scatter_add_sorted_flushes_as_reference(sign):
    rule = "default" if sign > 0 else "sgd"
    rng = np.random.default_rng(11)
    got, want = _engines(rule)
    data = _tiny(rng, (R, C))
    ids = _ids("repeated", rng)
    delta = _tiny(rng, (ids.size, C))
    jdata = want.apply_rows(jnp.asarray(data), ids, delta)
    tdata = got.apply_rows(torch.from_numpy(data.copy()), ids, delta)
    _check(got, want, tdata, jdata, f"{rule} engine, repeated ids")
    ids_t, delta_t = torch.from_numpy(ids), torch.from_numpy(delta)
    plain = torch.from_numpy(data.copy())
    rows.row_scatter_add(plain, ids_t, delta_t, sign)
    _assert_bits(plain.numpy(), jdata, f"{rule} row_scatter_add")
    ordered = torch.from_numpy(data.copy())
    rows.row_scatter_add_ordered(
        ordered, rows.scatter_plan(ids_t, ids.size, R), delta_t, sign)
    _assert_bits(ordered.numpy(), jdata, f"{rule} row_scatter_add_ordered")


@pytest.mark.parametrize("kind", ["ascending", "repeated"])
@pytest.mark.parametrize("rule", STATEFUL)
def test_row_rule_apply_flushes_as_reference(rule, kind):
    rng = np.random.default_rng(12)
    got, want = _engines(rule)
    _seed_state(got, want, rng)
    data = _tiny(rng, (R, C))
    topt, jopt = _options()
    for step in range(_steps(rule)):
        ids = _ids(kind, rng)
        delta = _tiny(rng, (ids.size, C), rule=rule)
        jdata = want.apply_rows(jnp.asarray(data), ids, delta, jopt)
        tdata = got.apply_rows(torch.from_numpy(data.copy()), ids, delta,
                               topt)
        _check(got, want, tdata, jdata, f"{rule} rows step {step}")
        data = np.asarray(jdata).copy()


@pytest.mark.parametrize("rule", RULES)
def test_rows_apply_gather_flushes_as_reference(rule):
    rng = np.random.default_rng(13)
    got, want = _engines(rule)
    _seed_state(got, want, rng)
    data = _tiny(rng, (R, C))
    topt, jopt = _options()
    for kind in ("ascending", "repeated"):
        add = jengine.pad_ids(_ids(kind, rng)[:11], R)
        get = jengine.pad_ids(np.array([0, 3, 7, R - 1, 5], np.int32), R)
        delta = _tiny(rng, (11, C), rule=rule)
        jdata, jvals = want.apply_rows_gather(
            jnp.asarray(data), jnp.asarray(add), jnp.asarray(delta), jopt,
            jnp.asarray(get), C)
        tdata, tvals = got.apply_rows_gather(
            torch.from_numpy(data.copy()), torch.from_numpy(add),
            torch.from_numpy(delta), topt, torch.from_numpy(get), C)
        _check(got, want, tdata, jdata, f"{rule} fused, {kind} ids")
        (_assert_near if rule == "adagrad" else _assert_bits)(
            tvals.numpy(), jvals, f"{rule} fused values")
        data = np.asarray(jdata).copy()


@pytest.mark.parametrize("shape", [(R, C), (R * C,)])
@pytest.mark.parametrize("rule", RULES)
def test_dense_flushes_as_reference(rule, shape):
    rng = np.random.default_rng(14)
    got, want = _engines(rule, shape)
    _seed_state(got, want, rng)
    jdata = jnp.asarray(_tiny(rng, shape))
    tdata = torch.from_numpy(np.asarray(jdata).copy())
    for step in range(_steps(rule)):
        delta = _tiny(rng, shape, rule=rule)
        topt, jopt = _options(step % 2)
        jdata = want.apply_dense(jdata, jnp.asarray(delta), jopt)
        tdata = got.apply_dense(tdata, torch.from_numpy(delta), topt)
        _check(got, want, tdata, jdata, f"{rule} dense step {step}")


def test_rule_step_flushes_every_operation():
    """A product of two normals below 2^-126 flushes before the sum:
    momentum's ``m * s0`` at s0 = 2^-126 is 0 in the reference."""
    s0 = torch.full((1, 1), 2.0 ** -126)
    dv = torch.zeros((1, 1))
    step, smooth = rules.rule_step("momentum", [0.5, 0.01, 0.1, 0.1],
                                   torch.zeros((1, 1)), s0, dv)
    assert float(step) == 0.0 and float(smooth) == 0.0
