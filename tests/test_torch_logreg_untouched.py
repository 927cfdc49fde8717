"""The sparse logreg models' untouched rows, bit for bit against the
reference (ROADMAP C12).

The reference's sparse steps update every row: ``LocalModel`` and
``PSModel`` subtract a dense ``lr * grad`` from ``w``, ``FTRLModel``
adds a dense ``(g - sigma * w, g * g)`` to ``(z, n)``. Where a batch does
not touch a row that update is a zero, and under XLA's flush-to-zero
the subtraction still flushes a subnormal weight; its sign follows the
regularizer (``+0 * reg(w)``), so under L1 or L2, and in FTRL's state,
every zero and subnormal there becomes +0. The port's K12 updates only
the touched rows; state that comes in from outside the step (a load, a
pull) is settled once by the next step's settle pass (``kernels.logreg.
SettleFlag``, whose plain version is ``settle_untouched``).

Here weights (FTRL: ``z`` and ``n``) holding subnormals and signed zeros
in rows no batch touches are loaded into both packages, two sparse
updates run, and the untouched rows are compared as int32 bits. The PS
cases also pull rows that another worker moved on the server (whose
sgd rule flushes what it stores, so a pull brings no subnormal in: they
hold the settle pass after a pull, which runs under a regularizer
only). The touched rows are K12's, held bit for bit too: K12 sums a
row's gradient from its regularization term in position order, fuses
the products the reference's programs fuse (``LocalModel``'s ``w - grad
* lr``, FTRL's ``n + g * g``) and K11 forms the sigmoid with XLA's
polynomial exp (ROADMAP C13).

``test_written_zero_settles_as_reference``: K12 itself writes a -0 into
a touched row (a weight below 2^-103 whose update underflows is flushed
to a zero of its sign); under a regularizer the reference's next batch
that does not touch the row turns it into +0, and so does the port's
settle pass (``kernels.logreg.SettleFlag``, ROADMAP C12).
"""

import io

import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models.logreg import Configure as JConfigure
from multiverso_tpu.models.logreg import model as jmodel
from multiverso_tpu.models.logreg.reader import Batch as JBatch
from multiverso_tpu.updater.options import AddOption as JAddOption
from multiverso_tpu_torch.models.logreg import Configure
from multiverso_tpu_torch.models.logreg import model as tmodel
from multiverso_tpu_torch.models.logreg.reader import Batch

I_SIZE, B, K = 40, 8, 5
#: Batches touch rows [0, TOUCHED) and the padding row; the rest stay
#: untouched.
TOUCHED = 20
SUB = np.float32(3e-40)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _batches(make, seed: int = 1, n: int = 2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = rng.integers(0, TOUCHED, (B, K)).astype(np.int64)
        keys[:, -1] = I_SIZE
        values = rng.standard_normal((B, K)).astype(np.float32)
        values[:, -1] = 0.0
        labels = rng.integers(0, 2, B).astype(np.int32)
        out.append(make(labels, np.ones(B, np.float32), keys=keys,
                        values=values, count=B))
    return out


def _loaded(rng) -> np.ndarray:
    """Normal weights on the touched rows; on the untouched ones
    subnormals of both signs, signed zeros, tiny and plain normals."""
    w = (rng.standard_normal((I_SIZE + 1, 1)) * 0.3).astype(np.float32)
    w[-1] = 0.0
    tail = np.array([SUB, -SUB, np.float32(-0.0), np.float32(0.0),
                     np.float32(-1e-38 * 1.5), np.float32(2e-38),
                     np.float32(-SUB * 7), np.float32(0.25)], np.float32)
    w[TOUCHED:TOUCHED + 16, 0] = np.tile(tail, 2)
    w[TOUCHED + 16:I_SIZE, 0] = -SUB
    return w


def _held(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rows = np.arange(got.shape[0])
    untouched = (rows >= TOUCHED) & (rows < I_SIZE)
    g, w = _bits(got[untouched]), _bits(want[untouched])
    assert (g == w).all(), (
        f"{what}: untouched rows {rows[untouched][(g != w).any(-1)]}: "
        f"{got[untouched][g != w][:6]} vs {want[untouched][g != w][:6]}")
    g, w = _bits(got[~untouched]), _bits(want[~untouched])
    assert (g == w).all(), (
        f"{what}: touched rows {rows[~untouched][(g != w).any(-1)]}: "
        f"{got[~untouched][g != w][:6]} vs {want[~untouched][g != w][:6]}")


def _cfg(kw, jax_side: bool):
    return (JConfigure if jax_side else Configure)(**dict(
        dict(input_size=I_SIZE, output_size=1, sparse=True,
             objective_type="sigmoid", minibatch_size=B), **kw))


def _local(kw, w):
    ref = jmodel.LocalModel(_cfg(kw, True))
    port = tmodel.LocalModel(_cfg(kw, False), device="cpu")
    ref.load_weights(w)
    port.load_weights(w)
    for jb, tb in zip(_batches(JBatch), _batches(Batch)):
        ref.update(jb)
        port.update(tb)
    _held(port.weights, ref.weights, f"LocalModel {kw}")


def _server_zeros(model, option, underflow: bool) -> None:
    """Worker 1 adds to rows of worker 0's table: the sgd server leaves a
    tiny normal (row 38), a flushed +SUB (row 39) and a normal (row 36);
    worker 0's pull brings them in. With ``underflow`` row 37's
    difference underflows on the server (2e-38 - 2.5e-38): the
    reference's sharded row add on its 8-device CPU mesh turns the
    flushed -0 into +0, while its one-device program and the port keep
    -0 (ROADMAP C)."""
    table = model._table
    rows = np.array([36, 37, 38, 39], np.int32)
    table.add_rows(rows, np.array(
        [[-1.5], [-2e-38 if underflow else 0.0], [-2e-38], [0.0]],
        np.float32), option=option)
    table.add_rows(rows, np.array(
        [[0.25], [2.5e-38 if underflow else 0.0], [0.0], [-SUB]],
        np.float32), option=option)
    model._pull()


def _ps(kw, w, underflow: bool = False):
    def run(jax_side):
        if jax_side:
            jmv.init([])
            model = jmodel.PSModel(_cfg(kw, True))
            option, make = JAddOption(worker_id=1), JBatch
        else:
            tmv.init([], device="cpu")
            model = tmodel.PSModel(_cfg(kw, False))
            option, make = tmv.AddOption(worker_id=1), Batch
        try:
            model.load(io.BytesIO(w.tobytes()))
            _server_zeros(model, option, underflow)
            for b in _batches(make):
                model.update(b)
            return np.array(model.weights)
        finally:
            (jmv if jax_side else tmv).shutdown()

    _held(run(False), run(True), f"PSModel {kw}")


def _ftrl(kw, w, use_ps: bool):
    z = w.copy()
    n = np.abs(w)
    n[TOUCHED + 2:TOUCHED + 4, 0] = [np.float32(-0.0), -SUB]
    raw = z.tobytes() + n.tobytes()
    if use_ps:
        jmv.init([])
    try:
        ref = jmodel.FTRLModel(_cfg(kw, True), use_ps=use_ps)
        ref.load(io.BytesIO(raw))
        for b in _batches(JBatch):
            ref.update(b)
        want = np.array(ref._z), np.array(ref._n)
    finally:
        if use_ps:
            jmv.shutdown()
    if use_ps:
        tmv.init([], device="cpu")
    try:
        port = tmodel.FTRLModel(_cfg(kw, False), use_ps=use_ps,
                                device="cpu")
        port.load(io.BytesIO(raw))
        for b in _batches(Batch):
            port.update(b)
        got = port._z.numpy().copy(), port._n.numpy().copy()
    finally:
        if use_ps:
            tmv.shutdown()
    _held(got[0], want[0], f"FTRL z {kw}")
    _held(got[1], want[1], f"FTRL n {kw}")


FTRL = dict(updater_type="ftrl", alpha=0.1, beta=1.0, lambda1=0.01,
            lambda2=0.01)
CASES = [
    ("local", dict(updater_type="sgd", learning_rate=0.37)),
    ("local", dict(updater_type="sgd", regular_type="L2",
                   regular_coef=0.01, learning_rate=0.37)),
    ("local", dict(updater_type="default", regular_type="L1",
                   regular_coef=0.01, learning_rate=0.37)),
    ("ps", dict(updater_type="sgd", regular_type="L2", regular_coef=0.01,
                learning_rate=0.37, sync_frequency=1)),
    ("ps", dict(updater_type="sgd", learning_rate=0.37, sync_frequency=3)),
    ("ftrl", dict(FTRL)),
    ("ftrl", dict(FTRL, regular_type="L2", regular_coef=0.01)),
    ("ftrl_ps", dict(FTRL, use_ps=True, sync_frequency=3)),
    # Under L2 the pulled -0 settles to +0 in both packages.
    ("ps_underflow", dict(updater_type="sgd", regular_type="L2",
                          regular_coef=0.01, learning_rate=0.37,
                          sync_frequency=1)),
    pytest.param(
        "ps_underflow", dict(updater_type="sgd", learning_rate=0.37,
                             sync_frequency=3),
        marks=pytest.mark.xfail(strict=True, reason=(
            "the reference's 8-device sharded row add turns a flushed "
            "-0 into +0; the port keeps -0 (ROADMAP C)"))),
]


def _case_id(i: int, case) -> str:
    return f"{(case.values if hasattr(case, 'values') else case)[0]}-{i}"


@pytest.mark.parametrize("model,kw", CASES,
                         ids=[_case_id(i, c) for i, c in enumerate(CASES)])
def test_untouched_rows_settle_as_reference(model, kw):
    w = _loaded(np.random.default_rng(7))
    if model == "local":
        _local(kw, w)
    elif model.startswith("ps"):
        _ps(kw, w, underflow=model == "ps_underflow")
    else:
        _ftrl(kw, w, use_ps=model == "ftrl_ps")


#: A weight below 2^-103 and a batch whose update takes it below the
#: smallest normal: w - lr * (v * diff / count) with v * w ~ 0, so pred
#: is 1/2 and diff -1/2 for label 1: -2e-38 + 0.37 * 6e-37 / 16 (sgd;
#: the default updater without lr: v 2.2e-37) is a negative subnormal,
#: flushed to -0; L2's term 0.01 * w is flushed too.
ZERO_ROW, ZERO_W = 5, np.float32(-2e-38)


def _zero_batches(make, value):
    """Batch 1 touches ZERO_ROW in sample 0 alone (its other keys the
    padding key); batch 2 does not touch it."""
    first, second = _batches(make)
    keys, values = first.keys.copy(), first.values.copy()
    for k in (keys, second.keys):
        k[k == ZERO_ROW] = ZERO_ROW + 1
    keys[0] = I_SIZE
    values[0] = 0.0
    keys[0, 0], values[0, 0] = ZERO_ROW, value
    labels = first.labels.copy()
    labels[0] = 1
    return [make(labels, first.weights, keys=keys, values=values,
                 count=B), second]


@pytest.mark.parametrize("updater,value", [("sgd", 6e-37),
                                           ("default", 2.2e-37)])
def test_written_zero_settles_as_reference(updater, value):
    kw = dict(updater_type=updater, regular_type="L2", regular_coef=0.01,
              learning_rate=0.37)
    w = (np.random.default_rng(3).standard_normal((I_SIZE + 1, 1))
         * 0.3).astype(np.float32)
    w[-1] = 0.0
    w[ZERO_ROW] = ZERO_W
    ref = jmodel.LocalModel(_cfg(kw, True))
    port = tmodel.LocalModel(_cfg(kw, False), device="cpu")
    ref.load_weights(w)
    port.load_weights(w)
    seen = []
    value = np.float32(value)
    for jb, tb in zip(_zero_batches(JBatch, value),
                      _zero_batches(Batch, value)):
        ref.update(jb)
        port.update(tb)
        got, want = port.weights, np.asarray(ref.weights)
        assert (_bits(got) == _bits(want)).all(), (
            f"{updater}: rows {np.flatnonzero(_bits(got) != _bits(want))}")
        seen.append((_bits(got[ZERO_ROW])[0], port._settle.raised()))
    # Batch 1 wrote -0 and raised the flag; batch 2 settled it to +0.
    assert seen == [(np.int32(-2 ** 31), True), (0, False)], seen
