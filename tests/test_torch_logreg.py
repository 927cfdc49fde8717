"""The port's LogisticRegression app against the JAX package's.

The same inputs, made with numpy from a seed, go through
``multiverso_tpu.models.logreg`` (reference) and
``multiverso_tpu_torch.models.logreg`` (port, ``device="cpu"``: CPU
tensors, so the kernels K11/K12 run their plain versions):

- the sparse step (K11 + K12) against ``make_sparse_step`` and the
  models' updates built on it, in every objective and regularizer, with
  duplicate keys, padding, zero-weight samples, explicit zero values and
  the index edge cases (keys at input_size, input_size + 1, -1 and past
  -R); FTRL's step against ``FTRLModel``'s fused update;
- every model family over several batches: loss per batch, predictions
  and correct counts, final weights (rtol 1e-5 / atol 1e-7: the sums run
  in another order);
- the CLI config flow, batches, and model files across the packages.

The app has no RNG and its weights start at zero, so both packages
compute from the same state batch by batch.
"""

import io
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models.logreg import Configure as JConfigure
from multiverso_tpu.models.logreg import model as jmodel
from multiverso_tpu.models.logreg import objective as jobjective
from multiverso_tpu.models.logreg import iter_samples as j_iter_samples
from multiverso_tpu.models.logreg import make_batches as j_make_batches
from multiverso_tpu.models.logreg.main import LogReg as JLogReg
from multiverso_tpu_torch.kernels import logreg as lrk
from multiverso_tpu_torch.models.logreg import Configure, convert
from multiverso_tpu_torch.models.logreg import iter_samples, make_batches
from multiverso_tpu_torch.models.logreg import model as tmodel
from multiverso_tpu_torch.models.logreg import objective
from multiverso_tpu_torch.models.logreg.main import LogReg, main

RTOL, ATOL = 1e-5, 1e-7
CPU = "cpu"


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


def write_dense_data(path, n=120, d=8, classes=3, seed=0):
    """tests/test_logreg.py's separable set."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(42).standard_normal((classes, d)) * 3
    lines = []
    for _ in range(n):
        label = rng.integers(0, classes)
        x = centers[label] + rng.standard_normal(d) * 0.3
        lines.append(str(label) + " " + " ".join(f"{v:.5f}" for v in x))
    path.write_text("\n".join(lines))


def write_sparse_data(path, n=96, d=40, seed=0, classes=2):
    """tests/test_logreg.py's libsvm set (``classes`` > 2: the label is
    the class of the largest planted score)."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((d, max(classes - 1, 1)))
    lines = []
    for _ in range(n):
        nnz = rng.integers(3, 8)
        keys = np.sort(rng.choice(d, nnz, replace=False))
        vals = rng.standard_normal(nnz)
        score = vals @ w_true[keys]
        label = int(score[0] > 0) if classes == 2 else int(
            np.argmax(np.concatenate([[0.0], score])))
        lines.append(f"{label} " + " ".join(
            f"{k}:{v:.5f}" for k, v in zip(keys, vals)))
    path.write_text("\n".join(lines))


def close(got, ref, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


# -- the sparse step: K11 + K12 plain versions vs make_sparse_step --

I_SIZE, B, K = 30, 12, 8


def _sparse_batch(rng, classes):
    """Keys with duplicates within and across samples, padding (key
    I_SIZE with value 0), an explicit zero value, two zero-weight
    samples and the index edge cases."""
    R = I_SIZE + 1
    keys = rng.integers(0, I_SIZE, (B, K))
    keys[:, 6:] = I_SIZE
    keys[0, :5] = [I_SIZE + 1, -1, I_SIZE, -R, -R - 1]
    keys[1, 1] = keys[1, 0]
    keys[3, :3] = keys[2, :3]
    values = rng.standard_normal((B, K)).astype(np.float32)
    values[:, 6:] = 0.0
    values[2, 0] = 0.0
    labels = rng.integers(0, max(classes, 2), B).astype(np.int32)
    labels[4] = -1                      # a label no class has
    weights = np.ones(B, np.float32)
    weights[-2:] = 0.0
    weights[5] = 0.5
    return keys, values, labels, weights


def _tensors(keys, values, labels, weights):
    return (torch.from_numpy(keys.astype(np.int32)),
            torch.from_numpy(values), torch.from_numpy(labels),
            torch.from_numpy(weights))


OBJECTIVES = [("sigmoid", 1), ("softmax", 4), ("default", 1),
              ("default", 3), ("ftrl", 1)]


@pytest.mark.parametrize("regular", ["default", "L1", "L2"])
@pytest.mark.parametrize("objective_type,classes", OBJECTIVES)
def test_sparse_step_matches_reference(objective_type, classes, regular):
    rng = np.random.default_rng(
        sum(map(ord, f"{objective_type}{classes}{regular}")))
    kw = dict(input_size=I_SIZE, output_size=classes, sparse=True,
              objective_type=objective_type, regular_type=regular,
              regular_coef=0.01)
    w = (rng.standard_normal((I_SIZE + 1, classes)) * 0.5).astype(
        np.float32)
    w[rng.random(w.shape) < 0.2] = 0.0       # sign(0) for L1
    batch = _sparse_batch(rng, classes)
    loss, correct, grad = jobjective.make_sparse_step(JConfigure(**kw))(
        jnp.asarray(w), *map(jnp.asarray, batch))
    lr = 0.3
    table = torch.from_numpy(w.copy())
    got = objective.make_sparse_step(Configure(**kw))(
        table, *_tensors(*batch), scale=lr, delta_rows=True)
    close(got[0], loss, "loss")
    assert int(got[1]) == int(correct)
    expected = np.asarray(jnp.asarray(w) - grad * jnp.float32(lr))
    close(table.numpy(), expected, "updated weights")
    # The touched rows and their deltas: JAX's grad rows at the rows
    # .at[keys].add touches (wrapped, out-of-range dropped).
    touched = np.nonzero(np.asarray(jnp.zeros(I_SIZE + 1).at[
        jnp.asarray(batch[0])].set(1.0, mode="drop")))[0]
    np.testing.assert_array_equal(got[2].numpy(), touched)
    close(got[3].numpy(), np.asarray(grad)[touched] * np.float32(lr),
          "delta rows")


@pytest.mark.parametrize("objective_type,classes", OBJECTIVES)
def test_sparse_predict_matches_reference(objective_type, classes):
    rng = np.random.default_rng(7)
    kw = dict(input_size=I_SIZE, output_size=classes, sparse=True,
              objective_type=objective_type)
    w = rng.standard_normal((I_SIZE + 1, classes)).astype(np.float32)
    keys, values, _, _ = _sparse_batch(rng, classes)
    ref = jobjective.make_predict(JConfigure(**kw))(
        jnp.asarray(w), jnp.asarray(keys), jnp.asarray(values))
    got = objective.make_predict(Configure(**kw))(
        torch.from_numpy(w), torch.from_numpy(keys.astype(np.int32)),
        torch.from_numpy(values))
    close(got.numpy(), ref)


@pytest.mark.parametrize("regular", ["default", "L1", "L2"])
@pytest.mark.parametrize("objective_type", ["sigmoid", "ftrl"])
def test_ftrl_step_matches_reference(objective_type, regular):
    rng = np.random.default_rng(11)
    kw = dict(input_size=I_SIZE, output_size=1, sparse=True,
              objective_type=objective_type, updater_type="ftrl",
              regular_type=regular, alpha=0.1, beta=1.0, lambda1=0.3,
              lambda2=0.01)
    z = rng.standard_normal((I_SIZE + 1, 1)).astype(np.float32)
    n = np.abs(rng.standard_normal((I_SIZE + 1, 1))).astype(np.float32)
    n[::5] = 0.0
    batch = _sparse_batch(rng, 1)
    ref = jmodel.FTRLModel(JConfigure(**kw))._fused(
        jnp.asarray(z), jnp.asarray(n), *map(jnp.asarray, batch))
    config = Configure(**kw)
    tz, tn = torch.from_numpy(z.copy()), torch.from_numpy(n.copy())
    push = (torch.zeros_like(tz), torch.zeros_like(tn))
    got = objective.make_sparse_step(config, objective.ftrl_params(config))(
        (tz, tn), *_tensors(*batch), push=push)
    close(got[0], ref[2], "loss")
    assert int(got[1]) == int(ref[3])
    close(tz.numpy(), ref[0], "z")
    close(tn.numpy(), ref[1], "n")
    close(push[0].numpy(), np.asarray(ref[4] - ref[5]), "delta z")
    close(push[1].numpy(), np.asarray(ref[4] * ref[4]), "delta n")


def test_forward_plain_gathers_as_jax():
    """K11's plain version reads the rows JAX's w[keys] reads: [-R, -1]
    wrap, everything else clamps; K12's touched rows drop them."""
    R = 6
    w = torch.arange(R, dtype=torch.float32).reshape(R, 1) * 10 + 1
    keys = torch.tensor([[5, 6, 7, -1, -6, -7, -100]], dtype=torch.int32)
    pred = lrk.sparse_lr_forward(w, keys, torch.ones(1, 7),
                                 act=lrk.ACT_LINEAR)
    ref = jnp.asarray(w.numpy())[jnp.asarray(keys.numpy())]
    assert float(pred) == float(ref.sum())
    assert lrk.touched_rows(keys, R).rows.tolist() == [0, 5]
    assert lrk.touched_rows(keys, R).counts.tolist() == [1, 2]


def test_wrappers_launch_or_raise_on_other_devices():
    w = torch.zeros(4, 1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lrk.sparse_lr_forward(w, torch.zeros(1, 2, dtype=torch.int32),
                              torch.zeros(1, 2))


def test_dense_step_matches_reference():
    rng = np.random.default_rng(3)
    for obj, classes, reg in (("softmax", 3, "L2"), ("sigmoid", 1, "L1"),
                              ("default", 2, "default")):
        kw = dict(input_size=9, output_size=classes, objective_type=obj,
                  regular_type=reg, regular_coef=0.02)
        w = rng.standard_normal((9, classes)).astype(np.float32)
        x = rng.standard_normal((10, 9)).astype(np.float32)
        labels = rng.integers(0, max(classes, 2), 10).astype(np.int32)
        weights = np.ones(10, np.float32)
        weights[-3:] = 0
        ref = jobjective.make_dense_step(JConfigure(**kw))(
            *map(jnp.asarray, (w, x, labels, weights)))
        got = objective.make_dense_step(Configure(**kw))(
            *map(torch.from_numpy, (w, x, labels, weights)))
        close(got[0], ref[0], f"{obj} loss")
        assert int(got[1]) == int(ref[1])
        close(got[2].numpy(), ref[2], f"{obj} grad")


def test_learning_rate_is_the_reference_schedule():
    config = Configure(learning_rate=0.8, learning_rate_coef=10.0,
                       minibatch_size=4)
    for count in (0, 1, 17, 10_000):
        assert objective.learning_rate(config, count) == \
            jobjective.learning_rate(JConfigure(
                learning_rate=0.8, learning_rate_coef=10.0,
                minibatch_size=4), count)


# -- the models over several batches --

def _batches(config_kw, path, jax_side: bool):
    make, it, C = (j_make_batches, j_iter_samples, JConfigure) if jax_side \
        else (make_batches, iter_samples, Configure)
    config = C(**config_kw)
    return list(make(config, it(config, str(path))))


def _run(model, batches):
    """(losses, predictions, correct counts, weights) over ``batches``."""
    losses = [model.update(b) for b in batches]
    preds, correct = [], []
    for b in batches:
        pred = model.predict(b)[:b.count]
        preds.append(pred)
        guess = (pred[:, 0] >= 0.5).astype(np.int32) if pred.shape[1] == 1 \
            else pred.argmax(axis=1).astype(np.int32)
        correct.append(int((guess == b.labels[:b.count]).sum()))
    return losses, preds, correct, np.asarray(model.weights)


def _compare(got, ref):
    close(got[0], ref[0], "losses")
    for g, r in zip(got[1], ref[1]):
        close(g, r, "predictions")
    assert got[2] == ref[2]
    close(got[3], ref[3], "weights")


def _two_packages(config_kw, path, make_ref, make_port, epochs=2,
                  ps=False):
    ref_batches = _batches(config_kw, path, True) * epochs
    port_batches = _batches(config_kw, path, False) * epochs
    if ps:
        jmv.init([])
    try:
        ref = _run(make_ref(JConfigure(**config_kw)), ref_batches)
    finally:
        if ps:
            jmv.shutdown()
    if ps:
        tmv.init([], device=CPU)
    try:
        got = _run(make_port(Configure(**config_kw)), port_batches)
    finally:
        if ps:
            tmv.shutdown()
    _compare(got, ref)
    return got


SPARSE_LOCAL = [
    dict(objective_type="sigmoid", updater_type="sgd", regular_type="L2",
         learning_rate=0.5),
    dict(objective_type="sigmoid", updater_type="default",
         regular_type="L1", regular_coef=0.001, learning_rate=0.5),
    dict(objective_type="softmax", output_size=3, updater_type="sgd",
         regular_type="L2", learning_rate=0.5),
    dict(objective_type="default", updater_type="sgd", learning_rate=0.1),
]


@pytest.mark.parametrize("extra", SPARSE_LOCAL)
def test_local_sparse_model_matches_reference(tmp_path, extra):
    path = tmp_path / "train.txt"
    write_sparse_data(path, n=96, d=40,
                      classes=3 if extra.get("output_size") == 3 else 2)
    kw = dict(dict(input_size=40, output_size=1, sparse=True,
                   minibatch_size=16), **extra)
    _two_packages(kw, path, jmodel.LocalModel,
                  lambda c: tmodel.LocalModel(c, device=CPU))


@pytest.mark.parametrize("objective_type,classes", [("softmax", 3),
                                                    ("sigmoid", 1)])
def test_local_dense_model_matches_reference(tmp_path, objective_type,
                                             classes):
    path = tmp_path / "train.txt"
    write_dense_data(path, n=100, d=8, classes=max(classes, 2))
    kw = dict(input_size=8, output_size=classes,
              objective_type=objective_type, updater_type="sgd",
              regular_type="L2", regular_coef=1e-3, learning_rate=0.5,
              minibatch_size=20)
    _two_packages(kw, path, jmodel.LocalModel,
                  lambda c: tmodel.LocalModel(c, device=CPU))


@pytest.mark.parametrize("sync_frequency,pipeline", [(1, True), (3, False)])
def test_ps_sparse_model_matches_reference(tmp_path, sync_frequency,
                                           pipeline):
    path = tmp_path / "train.txt"
    write_sparse_data(path, n=96, d=40)
    kw = dict(input_size=40, output_size=1, use_ps=True, sparse=True,
              objective_type="sigmoid", updater_type="sgd",
              regular_type="L2", learning_rate=0.5, minibatch_size=16,
              sync_frequency=sync_frequency, pipeline=pipeline)
    _two_packages(kw, path, jmodel.PSModel, tmodel.PSModel, ps=True)


def test_ps_dense_model_matches_reference(tmp_path):
    path = tmp_path / "train.txt"
    write_dense_data(path, n=100, d=8, classes=3)
    kw = dict(input_size=8, output_size=3, use_ps=True,
              objective_type="softmax", updater_type="sgd",
              learning_rate=0.5, minibatch_size=20, sync_frequency=2)
    _two_packages(kw, path, jmodel.PSModel, tmodel.PSModel, ps=True)


@pytest.mark.parametrize("use_ps", [False, True])
@pytest.mark.parametrize("objective_type", ["sigmoid", "ftrl"])
def test_ftrl_model_matches_reference(tmp_path, use_ps, objective_type):
    path = tmp_path / "train.txt"
    write_sparse_data(path, n=96, d=40)
    kw = dict(input_size=40, output_size=1, sparse=True, use_ps=use_ps,
              objective_type=objective_type, updater_type="ftrl",
              alpha=0.1, beta=1.0, lambda1=0.01, lambda2=0.01,
              minibatch_size=16, sync_frequency=2)
    _two_packages(kw, path,
                  lambda c: jmodel.FTRLModel(c, use_ps=use_ps),
                  lambda c: tmodel.FTRLModel(c, use_ps=use_ps, device=CPU),
                  ps=use_ps)


def test_ftrl_dense_model_matches_reference(tmp_path):
    path = tmp_path / "train.txt"
    write_dense_data(path, n=100, d=8, classes=2)
    kw = dict(input_size=8, output_size=1, objective_type="sigmoid",
              updater_type="ftrl", alpha=0.1, lambda1=0.01, lambda2=0.01,
              minibatch_size=20)
    _two_packages(kw, path, jmodel.FTRLModel,
                  lambda c: tmodel.FTRLModel(c, device=CPU))


def test_sparse_ps_pull_receives_server_rows():
    """Another worker's update dirties rows for worker 0; the pull
    brings them into the local replica (tests/test_logreg.py's
    regression, in the port)."""
    tmv.init([], device=CPU)
    try:
        config = Configure(input_size=10, output_size=1, use_ps=True,
                           sparse=True, objective_type="sigmoid",
                           updater_type="sgd")
        model = tmodel.PSModel(config)
        model._table.add_rows(np.array([4], np.int32),
                              np.full((1, 1), -3.0, np.float32),
                              option=tmv.AddOption(worker_id=1))
        model._pull()
        assert model.weights[4, 0] == pytest.approx(3.0)  # sgd: -=
    finally:
        tmv.shutdown()


def test_models_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    config = Configure(input_size=4, output_size=1, sparse=True)
    for make in (tmodel.LocalModel, tmodel.FTRLModel,
                 tmodel.create_model):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(config)


# -- batches, the CLI and model files across the packages --

def test_batches_are_the_references(tmp_path):
    for sparse, writer in ((True, write_sparse_data),
                           (False, write_dense_data)):
        path = tmp_path / f"d{sparse}.txt"
        writer(path)
        kw = dict(input_size=40 if sparse else 8, output_size=1,
                  sparse=sparse, minibatch_size=7)
        for got, ref in zip(_batches(kw, path, False),
                            _batches(kw, path, True)):
            assert got.count == ref.count
            for name in ("labels", "weights", "x", "keys", "values"):
                g, r = getattr(got, name), getattr(ref, name)
                assert (g is None) == (r is None)
                if g is not None:
                    assert g.dtype == r.dtype
                    np.testing.assert_array_equal(g, r)


def _config_text(tmp_path, tag, train, test, body):
    return f"""{body}
train_file={train}
test_file={test}
output_file={tmp_path}/{tag}.out
output_model_file={tmp_path}/{tag}.model
"""


@pytest.mark.parametrize("body,writer", [
    ("""input_size=8
output_size=3
objective_type=softmax
regular_type=L2
updater_type=sgd
train_epoch=3
sparse=false
minibatch_size=20
learning_rate=0.5
regular_coef=0.0007""", write_dense_data),
    ("""input_size=40
output_size=1
objective_type=ftrl
alpha=0.1
lambda1=0.01
train_epoch=2
minibatch_size=16""", write_sparse_data),
    ("""input_size=40
output_size=1
sparse=true
use_ps=true
objective_type=sigmoid
regular_type=L2
updater_type=sgd
train_epoch=2
minibatch_size=16
learning_rate=0.5""", write_sparse_data),
])
def test_cli_config_flow_matches_reference(tmp_path, body, writer):
    train, test = tmp_path / "train.data", tmp_path / "test.data"
    writer(train, seed=1)
    writer(test, seed=2)
    for tag in ("ref", "port"):
        (tmp_path / f"{tag}.config").write_text(
            _config_text(tmp_path, tag, train, test, body))
    app = JLogReg(str(tmp_path / "ref.config"))
    ref_loss, ref_acc = app.train(), app.test()
    app.close()
    port = LogReg(str(tmp_path / "port.config"), device=CPU)
    try:
        loss, acc = port.train(), port.test()
    finally:
        port.close()
    close(loss, ref_loss, "train loss")
    assert acc == ref_acc
    got = np.fromfile(tmp_path / "port.model", np.float32)
    ref = np.fromfile(tmp_path / "ref.model", np.float32)
    close(got, ref, "model file")
    out = np.loadtxt(tmp_path / "port.out", ndmin=2)
    close(out, np.loadtxt(tmp_path / "ref.out", ndmin=2), "predictions")


def test_cli_entry_point(tmp_path, capsys):
    assert main([], device=CPU) == 2
    assert "usage" in capsys.readouterr().err
    train = tmp_path / "train.data"
    write_dense_data(train, n=40, d=8, classes=3)
    (tmp_path / "c.config").write_text(_config_text(
        tmp_path, "cli", train, train,
        "input_size=8\noutput_size=3\nobjective_type=softmax\n"
        "updater_type=sgd\nminibatch_size=20"))
    assert main([str(tmp_path / "c.config")], device=CPU) == 0
    assert (tmp_path / "cli.model").stat().st_size == 8 * 3 * 4
    assert len((tmp_path / "cli.out").read_text().split("\n")) == 41


def test_model_files_cross_the_packages(tmp_path):
    """A model the JAX app stores loads into the port, and the other way
    round: local, PS and FTRL (z then n)."""
    path = tmp_path / "train.txt"
    write_sparse_data(path, n=48, d=40)
    kw = dict(input_size=40, output_size=1, sparse=True,
              objective_type="sigmoid", updater_type="sgd",
              minibatch_size=16)
    files = {}
    for ftrl in (False, True):
        extra = dict(updater_type="ftrl", alpha=0.1) if ftrl else {}
        jcls = jmodel.FTRLModel if ftrl else jmodel.LocalModel
        ref = jcls(JConfigure(**dict(kw, **extra)))
        for b in _batches(dict(kw, **extra), path, True):
            ref.update(b)
        buf = io.BytesIO()
        ref.store(buf)
        files[ftrl] = buf.getvalue()
        port = tmodel.create_model(Configure(**dict(kw, **extra)),
                                   device=CPU)
        port.load(io.BytesIO(files[ftrl]))
        close(port.weights, np.asarray(ref.weights))
        back = io.BytesIO()
        port.store(back)
        assert back.getvalue() == files[ftrl]
        again = jcls(JConfigure(**dict(kw, **extra)))
        again.load(io.BytesIO(back.getvalue()))
        np.testing.assert_array_equal(np.asarray(again.weights),
                                      np.asarray(ref.weights))
    assert len(files[True]) == 2 * len(files[False])   # z, then n
    # Through the parameter server: the negate-add upload. The servers'
    # rows take the file's values; a sparse model's own pull then brings
    # no row back (the adder's flags stay clean), so its replica keeps
    # its values — in both packages.
    loaded = np.frombuffer(files[False], np.float32).reshape(41, 1)
    for sparse in (True, False):
        shape = (41, 1) if sparse else (40, 1)
        data = files[False] if sparse else files[False][:40 * 4]
        ps_kw = dict(kw, use_ps=True, sparse=sparse)
        jmv.init([])
        try:
            ref = jmodel.PSModel(JConfigure(**ps_kw))
            ref.load(io.BytesIO(data))
            ref_w = np.asarray(ref.weights)
        finally:
            jmv.shutdown()
        tmv.init([], device=CPU)
        try:
            ps = tmodel.PSModel(Configure(**ps_kw))
            ps.load(io.BytesIO(data))
            close(ps.weights, ref_w)
            if sparse:
                close(ps._table.get_rows(np.arange(41, dtype=np.int32)),
                      loaded)
            else:
                close(ps.weights, loaded[:40])
                close(ps._table.get().reshape(shape), loaded[:40])
        finally:
            tmv.shutdown()


def test_convert_carries_reference_state(tmp_path):
    """convert.load_reference_weights / load_reference_ftrl: after
    carrying the JAX models' state, one more batch agrees."""
    path = tmp_path / "train.txt"
    write_sparse_data(path, n=64, d=40)
    kw = dict(input_size=40, output_size=1, sparse=True,
              objective_type="sigmoid", updater_type="sgd",
              learning_rate=0.5, minibatch_size=16, regular_type="L2")
    jb, tb = _batches(kw, path, True), _batches(kw, path, False)
    ref = jmodel.LocalModel(JConfigure(**kw))
    for b in jb[:3]:
        ref.update(b)
    jmv.init([])
    try:
        ref_ps = jmodel.PSModel(JConfigure(**dict(kw, use_ps=True)))
        for b in jb[:3]:
            ref_ps.update(b)
        ps_w = np.asarray(ref_ps.weights)
        ps_loss = ref_ps.update(jb[3])
        ps_after = np.asarray(ref_ps.weights)
    finally:
        jmv.shutdown()
    ftrl_kw = dict(kw, updater_type="ftrl", alpha=0.1, use_ps=True)
    jmv.init([])
    try:
        ref_f = jmodel.FTRLModel(JConfigure(**ftrl_kw), use_ps=True)
        for b in jb[:3]:
            ref_f.update(b)
        f_state = (np.asarray(ref_f._z), np.asarray(ref_f._n))
        f_loss = ref_f.update(jb[3])
        f_after = np.asarray(ref_f.weights)
    finally:
        jmv.shutdown()
    port = tmodel.LocalModel(Configure(**kw), device=CPU)
    convert.load_reference_weights(port, np.asarray(ref.weights))
    close(port.update(tb[3]), ref.update(jb[3]), "local loss")
    close(port.weights, ref.weights, "local weights")
    tmv.init([], device=CPU)
    try:
        port_ps = tmodel.PSModel(Configure(**dict(kw, use_ps=True)))
        convert.load_reference_weights(port_ps, ps_w)
        close(port_ps.update(tb[3]), ps_loss, "PS loss")
        close(port_ps.weights, ps_after, "PS weights")
        port_f = tmodel.FTRLModel(Configure(**ftrl_kw), use_ps=True)
        convert.load_reference_ftrl(port_f, *f_state)
        close(port_f.update(tb[3]), f_loss, "FTRL loss")
        close(port_f.weights, f_after, "FTRL weights")
    finally:
        tmv.shutdown()
