"""K14's stateful arms in their distinct form, against the reference.

Where the engine finds host ids ascending (``UpdateEngine.
apply_rows_gather``), K14 takes the stateful rules (momentum, AdaGrad,
DCASGD) one writer an element, with no sort. Its plain version
(``kernels.rules.rule_apply_distinct_plain``) is held here against the
reference's ``UpdateEngine.apply_rows_gather`` through the port's engine
— ascending host ids padded to their bucket, rows of 1, 8, 29, 30, 33,
34 and 50 floats (momentum's last column swaps its fused product up to
29 floats),
worker 0 and a worker past the state slots (zero state read, its writes
dropped) — bit for bit, AdaGrad's table within 4 ulps (the reference's
rsqrt, ROADMAP C13; its zeros and its state bit for bit). And against
the sorted form's plain version (``row_rule_apply_plain``, which K14
runs on ids that can repeat), bit for bit, with ids past the delta's
rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu.updater.options import AddOption as JAddOption
from multiverso_tpu_torch.kernels import rules as krules
from multiverso_tpu_torch.updater import AddOption, UpdateEngine
from multiverso_tpu_torch.updater import rules as trules

R, NW = 64, 2
HYP = dict(momentum=0.9, learning_rate=0.01, rho=0.1, lambda_=0.3)
WIDTHS = (1, 8, 29, 30, 33, 34, 50)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _held(got, want, what: str, before=None) -> None:
    """Bit for bit; with ``before`` (the values before the step) within 4
    ulps (2^-21 relative) of the step plus 4 of the result, as
    ``test_torch_fma.py`` holds AdaGrad: the root's error scales the
    step, and the subtraction can cancel. Zeros bit for bit."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if before is None:
        bad = np.flatnonzero(_bits(got) != _bits(want))
        assert bad.size == 0, (f"{what}: {bad.size} differ, first "
                               f"{got.reshape(-1)[bad[:4]]} vs "
                               f"{want.reshape(-1)[bad[:4]]}")
        return
    zero = want == 0
    assert (_bits(got[zero]) == _bits(want[zero])).all(), f"{what}: zeros"
    err = np.abs(got.astype(np.float64) - want)
    step = np.abs(np.asarray(before, np.float64) - want)
    assert (err <= 2.0 ** -21 * (step + np.abs(want))).all(), \
        f"{what}: past 4 ulps"


def _inputs(rule: str, width: int, seed: int):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((R, width)).astype(np.float32)
    state = rng.standard_normal(
        ((R, width) if rule == "momentum" else (NW, R, width))
    ).astype(np.float32) * np.float32(0.1)
    if rule == "adagrad":
        state = np.abs(state)
    ids = np.sort(rng.permutation(R)[:21]).astype(np.int32)
    delta = (rng.standard_normal((ids.size, width)) * 0.01).astype(
        np.float32)
    return data, state, ids, delta


@pytest.mark.parametrize("worker", [0, NW])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("rule", krules.STATEFUL)
def test_distinct_form_as_reference(rule, width, worker):
    data, state, ids, delta = _inputs(rule, width, 3 * width + worker)
    want = jengine.UpdateEngine(jrules.create_rule(rule), (R, width),
                                np.float32, NW)
    got = UpdateEngine(trules.create_rule(rule), (R, width), np.float32,
                       NW, torch.device("cpu"))
    want._state = jnp.asarray(state)
    got._state.copy_(torch.from_numpy(state))
    padded = jengine.pad_ids(ids, R)
    get_ids = jengine.pad_ids(np.arange(1, R, 2), R)
    jdata, jvals = want.apply_rows_gather(
        jnp.asarray(data), padded, delta,
        JAddOption(worker_id=worker, **HYP), get_ids, width)
    calls = []
    real = krules.rule_apply_distinct_plain

    def spy(*args):
        calls.append(args[0])
        return real(*args)

    krules.rule_apply_distinct_plain = spy
    try:
        tdata, tvals = got.apply_rows_gather(
            torch.from_numpy(data.copy()), padded, delta,
            AddOption(worker_id=worker, **HYP), get_ids, width)
    finally:
        krules.rule_apply_distinct_plain = real
    assert calls == [rule], "the engine did not take the distinct form"
    what = f"{rule} width {width} worker {worker}"
    ada = rule == "adagrad"
    _held(tdata.numpy(), np.asarray(jdata), f"{what}: table",
          data if ada else None)
    gathered = np.zeros_like(np.asarray(jvals))
    gathered[:R // 2] = data[1::2]
    _held(tvals.numpy(), np.asarray(jvals), f"{what}: gathered",
          gathered if ada else None)
    _held(got.state.numpy(), np.asarray(want.state), f"{what}: state")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("rule", krules.STATEFUL)
def test_distinct_form_equals_sorted_form(rule, width):
    data, state, rows, delta = _inputs(rule, width, 7 * width)
    # The first row named by its wrapped id, two dropped ids at the end,
    # the last three rows past the delta's (a zero delta).
    ids = np.concatenate([rows, [R + 1, -(R + 1)]]).astype(np.int32)
    ids[0] -= R
    delta = delta[:rows.size - 3]
    hyp = AddOption(**HYP).hyper_array()
    t_ids = torch.from_numpy(ids)
    t_delta = torch.from_numpy(delta)
    for worker in (0, NW):
        a_d, a_s = torch.from_numpy(data.copy()), torch.from_numpy(
            state.copy())
        b_d, b_s = a_d.clone(), a_s.clone()
        va = krules.rows_apply_gather_plain(rule, a_d, a_s, t_ids, t_delta,
                                            hyp, worker, t_ids, width,
                                            distinct=True)
        vb = krules.rows_apply_gather_plain(rule, b_d, b_s, t_ids, t_delta,
                                            hyp, worker, t_ids, width)
        for what, x, y in (("table", a_d, b_d), ("state", a_s, b_s),
                           ("gathered", va, vb)):
            _held(x.numpy(), y.numpy(), f"{rule} {width} {worker} {what}")
