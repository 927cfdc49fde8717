"""The dense logreg models bit for bit against the reference (ROADMAP C14).

The reference's dense programs, read from XLA's optimized HLO and the
machine code of its CPU backend, form the elementwise stages around the
two matmuls as follows, and the port's ``dense_lr_forward`` (K21, here
its plain version), ``dense_grad`` and model updates form them alike,
every operation flushed:

- ``make_dense_step``: ``pred`` through XLA's exp (sigmoid, softmax: the
  max and the sum over classes in class order), ``diff = (pred - y) *
  weight`` in two rounded operations, the loss with XLA's log and each
  class's product fused into the sum over classes (the linear loss's
  mean a product by the float32 ``1/C``), ``x.T @ diff / count`` an IEEE
  division by the count, ``+ reg(w)`` fused: ``fma(w, coef, g)`` (L2),
  ``fma(sign(w), coef, g)`` (L1), folded away without a regularizer;
- ``LocalModel``'s fused program: ``w - grad * lr`` one fused
  multiply-add;
- ``PSModel``'s ``_scale`` and ``_apply_local``: ``grad * lr`` and ``w -
  delta``, each a program of its own, each rounded;
- ``FTRLModel``'s fused program: ``n + g * g`` fused, ``/ alpha`` a
  product by the float32 ``1/alpha``, ``sigma * w`` rounded before ``z +
  (g - sigma * w)``; ``weights_of`` as ``kernels.logreg.ftrl_weights``.

The two matmuls stay ``torch.matmul``, which sums in another order than
XLA's dot. So the inputs here make every partial sum of both exact: each
sample's row holds one nonzero, a power of two, in a column no other
sample of its batch uses. The learning rates and weights put the updates
where they round, and the underflow cases where they go subnormal. The
per-batch loss is a sum over the batch in an order XLA picks by the
batch's size, so it keeps a tolerance (rtol 2e-6); predictions, correct
counts and the weights are held bit for bit.
"""

import io
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models.logreg import Configure as JConfigure
from multiverso_tpu.models.logreg import model as jmodel
from multiverso_tpu.models.logreg.reader import Batch as JBatch
from multiverso_tpu_torch.kernels import logreg as lrk
from multiverso_tpu_torch.models.logreg import Configure
from multiverso_tpu_torch.models.logreg import model as tmodel
from multiverso_tpu_torch.models.logreg import objective
from multiverso_tpu_torch.models.logreg.reader import Batch

CPU = "cpu"
D, B, BATCHES = 24, 8, 5


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the port's role-thread count to its baseline
    and leaves its flag registry at the defaults."""
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


def grid_batches(seed: int, classes: int, d: int = D, b: int = B,
                 n: int = BATCHES):
    """``n`` batches of ``b`` samples over ``d`` features: one nonzero a
    row, ``±2^k`` for k in [-2, 2], in a column that no other sample of
    the batch uses; labels over ``classes`` (0/1 for one output), one a
    batch out of range; weights in {0, 0.5, 1, 2}."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = np.zeros((b, d), np.float32)
        cols = rng.permutation(d)[:b]
        x[np.arange(b), cols] = rng.choice([-1.0, 1.0], b) * 2.0 ** \
            rng.integers(-2, 3, b)
        labels = rng.integers(0, max(classes, 2), b).astype(np.int32)
        labels[0] = -1
        weights = rng.choice(np.float32([0.0, 0.5, 1.0, 1.0, 2.0]),
                             b).astype(np.float32)
        weights[1] = 1.0
        out.append((x, labels, weights))
    return out


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def same_bits(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, (what, bad.size, got.reshape(-1)[bad[:4]],
                           want.reshape(-1)[bad[:4]])


def run_model(model, batches, jax_side: bool, state=None):
    """(losses, per-batch predictions, weights after each batch) of
    ``model`` over ``batches``; ``state`` is loaded first."""
    make = JBatch if jax_side else Batch
    if state is not None:
        stream = io.BytesIO(np.asarray(state, np.float32).tobytes())
        model.load(stream)
    losses, preds, weights = [], [], []
    for x, labels, wts in batches:
        batch = make(labels.copy(), wts.copy(), x=x.copy(), count=len(x))
        losses.append(model.update(batch))
        preds.append(np.asarray(model.predict(batch)))
        weights.append(np.array(model.weights, np.float32))
    return losses, preds, weights


def two_packages(kw, make_ref, make_port, batches, ps=False, state=None):
    if ps:
        jmv.init([])
    try:
        ref = run_model(make_ref(JConfigure(**kw)), batches, True, state)
    finally:
        if ps:
            jmv.shutdown()
    if ps:
        tmv.init([], device=CPU)
    try:
        got = run_model(make_port(Configure(**kw)), batches, False, state)
    finally:
        if ps:
            tmv.shutdown()
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-6, atol=1e-30,
                               err_msg="losses")
    for i, (g, r) in enumerate(zip(got[1], ref[1])):
        same_bits(g, r, f"predictions after batch {i}")
    for i, (g, r) in enumerate(zip(got[2], ref[2])):
        same_bits(g, r, f"weights after batch {i}")
    return got


LOCAL = [
    dict(objective_type="sigmoid", regular_type="L2", regular_coef=0.01),
    dict(objective_type="sigmoid", regular_type="L1", regular_coef=0.003),
    dict(objective_type="sigmoid", updater_type="default",
         regular_type="L2", regular_coef=0.02),
    dict(objective_type="softmax", output_size=3, regular_type="L1",
         regular_coef=0.005),
    dict(objective_type="softmax", output_size=10, regular_type="L2",
         regular_coef=0.001),
    dict(objective_type="default", output_size=2),
    dict(objective_type="default", output_size=3, regular_type="L2",
         regular_coef=0.01),
]


def _kw(extra, **more):
    return dict(dict(input_size=D, output_size=1, updater_type="sgd",
                     learning_rate=0.3, learning_rate_coef=1e3,
                     minibatch_size=B), **extra, **more)


@pytest.mark.parametrize("extra", LOCAL, ids=lambda e: "-".join(
    str(v) for v in e.values()))
def test_local_dense_model_bit_for_bit(extra):
    kw = _kw(extra)
    batches = grid_batches(len(str(extra)), kw["output_size"])
    two_packages(kw, jmodel.LocalModel,
                 lambda c: tmodel.LocalModel(c, device=CPU), batches)


@pytest.mark.parametrize("extra,sync", [
    (dict(objective_type="softmax", output_size=3), 2),
    (dict(objective_type="sigmoid", regular_type="L2",
          regular_coef=0.01), 1),
    (dict(objective_type="default", output_size=2, regular_type="L1",
          regular_coef=0.002), 3),
])
def test_ps_dense_model_bit_for_bit(extra, sync):
    kw = _kw(extra, use_ps=True, sync_frequency=sync)
    batches = grid_batches(7 + sync, kw["output_size"])
    two_packages(kw, jmodel.PSModel, tmodel.PSModel, batches, ps=True)


@pytest.mark.parametrize("use_ps", [False, True])
@pytest.mark.parametrize("regular", ["default", "L2"])
def test_ftrl_dense_model_bit_for_bit(use_ps, regular):
    kw = _kw(dict(objective_type="sigmoid", updater_type="ftrl",
                  regular_type=regular, regular_coef=0.01, alpha=0.1,
                  beta=1.0, lambda1=0.01, lambda2=0.01, use_ps=use_ps,
                  sync_frequency=2))
    batches = grid_batches(3, 1)
    two_packages(kw, lambda c: jmodel.FTRLModel(c, use_ps=use_ps),
                 lambda c: tmodel.FTRLModel(c, use_ps=use_ps, device=CPU),
                 batches, ps=use_ps)


def tiny_state(seed: int, classes: int) -> np.ndarray:
    """Weights just above the float32 normal floor, of both signs, so that
    an update of ``coef * w`` goes subnormal and ``w`` minus a small step
    crosses into the subnormal range."""
    rng = np.random.default_rng(seed)
    mag = rng.choice(np.float32([1.2e-38, 1.5e-38, 3e-38, 1e-37]),
                     (D, classes))
    return (rng.choice([-1.0, 1.0], (D, classes)) * mag).astype(np.float32)


@pytest.mark.parametrize("family", ["local", "ps"])
def test_dense_update_underflows_as_the_reference(family):
    """The rows no sample of a batch touches get ``grad = coef * w``,
    subnormal at these weights: the reference flushes it to a zero and
    their weights stay as they are; the touched rows round as usual. The
    port does the same, bit for bit; without the flush those rows would
    move by a subnormal step."""
    kw = _kw(dict(objective_type="sigmoid", regular_type="L2",
                  regular_coef=0.01), use_ps=family == "ps",
             sync_frequency=2)
    batches = grid_batches(21, 1)
    state = tiny_state(4, 1)
    if family == "ps":
        got = two_packages(kw, jmodel.PSModel, tmodel.PSModel, batches,
                           ps=True, state=state)
    else:
        got = two_packages(kw, jmodel.LocalModel,
                           lambda c: tmodel.LocalModel(c, device=CPU),
                           batches, state=state)
    # The first batch leaves its untouched rows as loaded.
    untouched = np.flatnonzero(~batches[0][0].any(axis=0))
    same_bits(got[2][0][untouched], state[untouched], "untouched rows")


def test_dense_stages_flush_a_subnormal_update():
    """``dense_grad`` of a subnormal ``coef * w`` over a zero gradient sum
    is a zero (the fused product's result is flushed), and the
    LocalModel's fused update then leaves ``w`` as it is."""
    from multiverso_tpu_torch.kernels.flush import fma
    w = torch.tensor([[1.5e-38], [-1.5e-38], [2.0]], dtype=torch.float32)
    g = objective.dense_grad(torch.zeros(3, 1), torch.ones(1), w, 2, 0.01)
    same_bits(g, [[0.0], [-0.0], [np.float32(0.01) * np.float32(2.0)]],
              "grad")
    same_bits(fma(-g, torch.tensor(0.3), w)[:2], w[:2], "w")


@pytest.mark.parametrize("objective_type,classes", [
    ("sigmoid", 1), ("softmax", 3), ("softmax", 10), ("default", 1),
    ("default", 3)])
def test_sample_loss_as_reference(objective_type, classes):
    """The per-sample loss times its weight, as the reference's program
    forms it from ``pred`` (XLA's log, each class's product fused into
    the sum over classes, the mean a product by ``1/C``): bit for bit."""
    import jax
    import jax.numpy as jnp
    from multiverso_tpu.models.logreg import objective as jobjective
    rng = np.random.default_rng(classes)
    n = 4000
    z = (rng.standard_normal((n, classes)) * 4).astype(np.float32)
    labels = rng.integers(0, max(classes, 2), n).astype(np.int32)
    weights = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), n)
    act, loss_fn = jobjective._activation_and_loss(objective_type)

    def ref_fn(z, labels, weights):
        pred = act(z)
        y = jobjective._onehot(labels, classes)
        return pred, loss_fn(pred, y) * weights

    pred, loss = jax.jit(ref_fn)(*map(jnp.asarray, (z, labels, weights)))
    got = lrk.dense_lr_forward(
        torch.from_numpy(z), torch.from_numpy(labels),
        torch.from_numpy(weights), objective._act_code(objective_type))
    same_bits(got[0], pred, "pred")
    same_bits(got[2], loss, "loss * weight")
