"""The reference's elementwise math as XLA's CPU backend compiles it,
against the port's plain versions (ROADMAP C13).

- ``jax.nn.sigmoid``: XLA inlines its own exp (a Cephes-style
  polynomial: the input clamped, 2^k split off, a degree-5 polynomial)
  and fuses its products into the adds that follow, the scaling by 2^k
  into the sigmoid's ``+ 1``. ``kernels.logreg.sigmoid`` (and K11's
  ``xla_sigmoid`` on the card) forms the same operations: bit for bit.
- FTRL's ``weights_of``: the division by the constant ``alpha`` becomes
  a multiplication by its float32 reciprocal, fused with the add of
  ``lambda2``: ``kernels.logreg.ftrl_weights``, bit for bit.
- ``jax.lax.rsqrt`` (AdaGrad's step): XLA's CPU code starts from the
  approximate ``vrsqrtss``/``vrsqrtps`` instruction and refines it with
  two Newton steps, so it is not the correctly rounded root, and its
  bits follow the host's approximation table. The port keeps ``1 /
  sqrt`` in two correctly rounded operations (``kernels.rules.
  inv_sqrt``, ROADMAP C10): within 2 ulps of the reference, and not
  equal to it everywhere — which is why AdaGrad's table is held within
  4 ulps of its steps elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu_torch.kernels import logreg as lrk
from multiverso_tpu_torch.kernels import rules as krules


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _spread(seed: int, n: int = 20000) -> np.ndarray:
    """Normal values over 12 binades, the clamp edges, zeros of both
    signs, subnormals and values near the exp's clamps."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 2.0 ** rng.integers(-8, 5, n))
    edges = [0.0, -0.0, 1e-40, -1e-40, 87.8, -87.8, 88.8, -88.8, 87.79,
             88.81, 100.0, -100.0, 103.0, -104.0, 6.0, -6.0]
    return np.concatenate([x, edges]).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_sigmoid_as_reference(seed):
    x = _spread(seed)
    want = np.asarray(jax.jit(jax.nn.sigmoid)(jnp.asarray(x)))
    got = lrk.sigmoid(torch.from_numpy(x)).numpy()
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, (bad.size, x[bad[:4]], got[bad[:4]],
                           want[bad[:4]])


@pytest.mark.parametrize("params", [(0.1, 1.0, 0.01, 0.01),
                                    (0.005, 1.0, 5.0, 0.002)])
def test_ftrl_weights_as_reference(params):
    alpha, beta, l1, l2 = params
    rng = np.random.default_rng(int(alpha * 1000))
    z = (rng.standard_normal(5000) * 2.0 * max(l1, 1.0)).astype(np.float32)
    n = (rng.random(5000) * 4.0).astype(np.float32)

    def weights_of(z, n):  # multiverso_tpu/models/logreg/model.py:211-213
        shrunk = jnp.sign(z) * jnp.maximum(jnp.abs(z) - l1, 0.0)
        return -shrunk / ((beta + jnp.sqrt(n)) / alpha + l2)

    want = np.asarray(jax.jit(weights_of)(jnp.asarray(z), jnp.asarray(n)))
    got = lrk.ftrl_weights(torch.from_numpy(z), torch.from_numpy(n),
                           lrk.Ftrl(alpha, beta, l1, l2)).numpy()
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, (bad.size, got[bad[:4]], want[bad[:4]])


def test_adagrad_rsqrt_is_an_approximation():
    rng = np.random.default_rng(5)
    x = (rng.random(1 << 16) * 2.0 ** rng.integers(-20, 20, 1 << 16)
         + 1e-6).astype(np.float32)
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    port = krules.inv_sqrt(torch.from_numpy(x)).numpy()
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    ulps = lambda a, b: np.abs(_bits(a).astype(np.int64)  # noqa: E731
                               - _bits(b).astype(np.int64))
    # The port's two correctly rounded operations: within an ulp of the
    # correctly rounded root; the reference within 2 ulps of the port.
    assert ulps(port, exact).max() <= 1
    assert ulps(ref, port).max() <= 2
    # The reference is not the correctly rounded root everywhere.
    assert (ulps(ref, exact) > 0).any()
