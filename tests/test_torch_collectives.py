"""The port's mesh collectives (B16) against the JAX package's.

- ``allreduce_mesh``, ``pmean_mesh`` and ``psum_scalar`` on
  ``local_mesh(8, device="cpu")`` (8 replica slots) against the
  reference's functions on its 8-device CPU mesh (tests/conftest.py),
  with the same seeded inputs: bit for bit — the reference's psum there
  is a sequential sum in device order, which is the order K19 and its
  plain version take.
- K19 ``mesh_allreduce``'s plain version (the wrapper on a CPU tensor)
  in both forms, the mean to one copy and the sum to n copies, against
  a numpy slot-order sum: bit for bit.
- ``MASGDStep`` against the reference's on the same 60 batches of the
  reference test's linear regression (y = 2x): w within 1e-6 of the
  reference's after every step (float32 gradients formed by two
  autodiff systems) and the loss within rtol 1e-5 (float32 means of
  the same 16 terms taken by two frameworks), and the reference test's
  own bars, |w - 2| < 1e-2
  and a loss below 1e-3; the update by hand (the slots' gradients
  summed in slot order, as the reference's step applies them) on two
  parameters, bit for bit.
- A mesh over two devices raises (ROADMAP B16-multi); the default mesh
  asks for the card and raises without one.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.parallel import MASGDStep as JMASGDStep
from multiverso_tpu.parallel import allreduce_mesh as jallreduce_mesh
from multiverso_tpu.parallel import pmean_mesh as jpmean_mesh
from multiverso_tpu.parallel import psum_scalar as jpsum_scalar
from multiverso_tpu_torch.kernels import mesh_allreduce
from multiverso_tpu_torch.kernels.mesh import mesh_allreduce_plain
from multiverso_tpu_torch.parallel import (MASGDStep, allreduce_mesh,
                                           pmean_mesh, psum_scalar)
from multiverso_tpu_torch.sharding import mesh as meshlib

N_DEV = 8


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the PORT's role-thread count to its baseline
    and leaves the port's flag registry at its defaults."""
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


def _mesh():
    return meshlib.local_mesh(N_DEV, device="cpu")


def _inputs(shape, seed):
    """Seeded float32 values over several binades, so that the order of
    the sum shows in the last bits."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-8, 8, shape))).astype(np.float32)


def test_reference_mesh_has_eight_devices():
    assert len(jax.devices()) == N_DEV


@pytest.mark.parametrize("shape", [(8,), (8, 5), (16, 3), (24, 2, 3),
                                   (8, 130)])
def test_allreduce_mesh_matches_reference_bitwise(shape):
    x = _inputs(shape, sum(shape))
    want = np.asarray(jallreduce_mesh(x))
    got = allreduce_mesh(x, _mesh())
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # Every slot's shard holds the total.
    k = shape[0] // N_DEV
    for s in range(1, N_DEV):
        np.testing.assert_array_equal(got.numpy()[s * k:(s + 1) * k],
                                      got.numpy()[:k])


@pytest.mark.parametrize("shape", [(8,), (8, 5), (16, 3), (8, 130)])
def test_pmean_mesh_matches_reference_bitwise(shape):
    x = _inputs(shape, 100 + sum(shape))
    want = np.asarray(jpmean_mesh(x))
    got = pmean_mesh(torch.from_numpy(x), _mesh())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("value", [1.0, 0.1, -3.7, 1e-7, 12345.678])
def test_psum_scalar_matches_reference(value):
    want = jpsum_scalar(value)
    got = psum_scalar(value, _mesh())
    assert got == want
    assert isinstance(got, float)


def test_reference_tests_on_the_port():
    # tests/test_collectives.py TestMeshCollectives, on the port's mesh.
    mesh = _mesh()
    x = np.tile(np.arange(4, dtype=np.float32), (N_DEV, 1))
    np.testing.assert_array_equal(allreduce_mesh(x, mesh)[0].numpy(),
                                  N_DEV * np.arange(4))
    assert psum_scalar(1.0, mesh) == N_DEV
    x = np.stack([np.full(3, float(i)) for i in range(N_DEV)]).astype(
        np.float32)
    np.testing.assert_allclose(pmean_mesh(x, mesh)[0].numpy(),
                               np.full(3, (N_DEV - 1) / 2))


def _numpy_slot_sum(x, mean):
    acc = x[0].copy()
    for r in range(1, x.shape[0]):
        acc = acc + x[r]
    if mean:
        acc = acc / np.float32(x.shape[0])
    return acc


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 64])
@pytest.mark.parametrize("mean", [False, True])
def test_mesh_allreduce_plain_is_the_slot_order_sum(n, mean):
    m = 4 * 9 + 3                          # a float4 body and a tail
    x = _inputs((n, m), n)
    copies = n if not mean else 1
    got = mesh_allreduce(torch.from_numpy(x), mean=mean, copies=copies)
    assert tuple(got.shape) == (copies, m) and got.dtype == torch.float32
    want = _numpy_slot_sum(x, mean)
    for c in range(copies):
        np.testing.assert_array_equal(got[c].numpy(), want)
    # The other form on the same input.
    other = mesh_allreduce_plain(torch.from_numpy(x), mean=not mean,
                                 copies=n)
    for c in range(n):
        np.testing.assert_array_equal(other[c].numpy(),
                                      _numpy_slot_sum(x, not mean))


def test_mesh_allreduce_checks_its_arguments():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="copies"):
        mesh_allreduce(x, copies=5)
    with pytest.raises(ValueError, match="copies"):
        mesh_allreduce(x, copies=0)
    with pytest.raises(ValueError, match="split"):
        allreduce_mesh(np.zeros((9, 2), np.float32), _mesh())


def _jax_loss(params, batch):
    x, y = batch[..., 0], batch[..., 1]
    return jnp.mean((params["w"] * x - y) ** 2)


def _torch_loss(params, batch):
    x, y = batch[..., 0], batch[..., 1]
    return torch.mean((params["w"] * x - y) ** 2)


def test_ma_sgd_step_matches_reference():
    # The reference test's linear regression (tests/test_collectives.py
    # test_ma_sgd_step_trains): y = 2x, 16 samples a slot, 60 steps.
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(60):
        x = rng.standard_normal((N_DEV * 16,)).astype(np.float32)
        batches.append(np.stack([x, 2 * x], axis=-1))
    jstep = JMASGDStep(_jax_loss, lr=0.1)
    jparams = {"w": jnp.zeros(())}
    step = MASGDStep(_torch_loss, _mesh(), lr=0.1)
    params = {"w": torch.zeros(())}
    for batch in batches:
        jparams, jloss = jstep(jparams, batch)
        params, loss = step(params, batch)
        assert abs(float(params["w"]) - float(jparams["w"])) < 1e-6
        assert abs(loss - jloss) <= 1e-5 * abs(jloss) + 1e-9
    assert abs(float(params["w"]) - 2.0) < 1e-2
    assert loss < 1e-3
    assert params["w"].dtype == torch.float32 and params["w"].dim() == 0


def test_ma_sgd_step_several_params_and_uneven_batch():
    mesh = meshlib.local_mesh(4, device="cpu")

    def loss_fn(p, batch):
        return torch.mean((batch @ p["a"] + p["b"]) ** 2)

    step = MASGDStep(loss_fn, mesh, lr=0.05)
    params = {"a": torch.ones(3), "b": torch.zeros(())}
    batch = torch.from_numpy(_inputs((8, 3), 5))
    new, loss = step(params, batch)
    # By hand: each slot's gradient, their slot-order mean, one step.
    grads = []
    for s in range(4):
        leaves = {k: v.clone().requires_grad_(True) for k, v in
                  params.items()}
        grads.append(torch.autograd.grad(
            loss_fn(leaves, batch[2 * s:2 * s + 2]),
            [leaves["a"], leaves["b"]]))
    for i, k in enumerate(("a", "b")):
        g = grads[0][i].clone()
        for s in range(1, 4):
            g = g + grads[s][i]
        torch.testing.assert_close(new[k], params[k] - 0.05 * g, rtol=0,
                                   atol=0)
    assert np.isfinite(loss)
    with pytest.raises(ValueError, match="split"):
        step(params, batch[:6])


def test_mesh_over_distinct_devices_raises():
    with pytest.raises(NotImplementedError, match="B16-multi"):
        meshlib.Mesh((torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(NotImplementedError, match="B16-multi"):
        meshlib.Mesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    mesh = meshlib.local_mesh(3, device="cpu")
    assert meshlib.device_count(mesh) == 3 and mesh.shape == {"shard": 3}
    assert meshlib.device_count(meshlib.local_mesh(device="cpu")) == 1


def test_default_mesh_asks_for_the_card():
    if torch.cuda.is_available():
        assert meshlib.local_mesh(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        meshlib.local_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psum_scalar(1.0)
