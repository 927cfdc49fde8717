"""K12 ``sparse_lr_apply`` on K20 ``key_sort``'s id preparation, against
the reference's ``make_sparse_step``; the key sort's plain version.

The same seeded numpy batches go through
``multiverso_tpu.models.logreg.objective.make_sparse_step`` (jitted on
the CPU) and the port's ``SparseStep`` / ``sparse_lr_apply`` on CPU
tensors (the kernels' plain versions). Keys are Zipf-distributed over
the features, with the padding key (the row ``input_size``) in 25 of
every 64 slots as at criteo's widths, ids repeated within a sample,
wrapped negative ids and ids past both ends of the table; also a batch
whose ids are all dropped (no touched row), a batch of one key, and
softmax over three classes. Tolerance: rtol 1e-5 / atol 1e-7 (the
gradient sums run in another order than XLA's scatter).

The key sort: ``key_sort_plain`` is ``torch.sort(stable=True)`` of the
wrapped keys; held here against numpy's stable argsort, with its key
rule (wrap, then every other id to R), at a table of 2^31 - 1 rows
(31 key bits) and at the bits each table height takes. On the CPU no
kernel launches: the wrappers' counts stay 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models.logreg import Configure as JConfigure
from multiverso_tpu.models.logreg import objective as jobjective
from multiverso_tpu_torch.kernels import keysort
from multiverso_tpu_torch.kernels import logreg as lrk
from multiverso_tpu_torch.kernels import rows as rows_k
from multiverso_tpu_torch.models.logreg import Configure, objective

RTOL, ATOL = 1e-5, 1e-7
I_SIZE = 200


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _zipf_batch(rng, B: int, K: int, classes: int, kind: str):
    """Zipf keys with the padding key in 25 of 64 slots, repeats within
    a sample, wrapped and dropped ids (``kind`` "zipf"); every id
    dropped ("dropped"); values, labels and weights."""
    R = I_SIZE + 1
    keys = np.minimum(rng.zipf(1.3, (B, K)) - 1, I_SIZE - 1)
    keys[rng.random((B, K)) < 25 / 64] = I_SIZE
    if kind == "zipf" and B * K > 1:
        keys[::3, 1] = keys[::3, 0]                  # a repeat in a sample
        flat = keys.reshape(-1)
        flat[2::17] = -rng.integers(1, R + 1, flat[2::17].size)  # wrap
        flat[5::23] = R + rng.integers(0, 50, flat[5::23].size)  # past R
        flat[7::29] = -R - 1 - rng.integers(0, 50, flat[7::29].size)
    elif kind == "dropped":
        keys[:] = R + 7
        keys[::2] = -R - 3
    values = rng.standard_normal((B, K)).astype(np.float32)
    values[keys == I_SIZE] = 0.0
    labels = rng.integers(0, max(classes, 2), B).astype(np.int32)
    weights = np.ones(B, np.float32)
    if B > 2:
        weights[-1] = 0.0
        weights[1] = 0.5
    return keys, values, labels, weights


CASES = [("sigmoid", 1, 64, 16, "zipf"), ("softmax", 3, 48, 8, "zipf"),
         ("default", 1, 40, 12, "zipf"), ("sigmoid", 1, 16, 8, "dropped"),
         ("sigmoid", 1, 1, 1, "zipf"), ("softmax", 3, 1, 1, "zipf"),
         ("sigmoid", 1, 600, 39, "zipf")]


@pytest.mark.parametrize("regular", ["default", "L1", "L2"])
@pytest.mark.parametrize("objective_type,classes,B,K,kind", CASES)
def test_sparse_lr_apply_matches_reference(objective_type, classes, B, K,
                                           kind, regular):
    rng = np.random.default_rng(B * 31 + K + classes)
    kw = dict(input_size=I_SIZE, output_size=classes, sparse=True,
              objective_type=objective_type, regular_type=regular,
              regular_coef=0.01)
    w = (rng.standard_normal((I_SIZE + 1, classes)) * 0.5).astype(
        np.float32)
    w[rng.random(w.shape) < 0.2] = 0.0
    keys, values, labels, weights = _zipf_batch(rng, B, K, classes, kind)
    loss, correct, grad = jobjective.make_sparse_step(JConfigure(**kw))(
        jnp.asarray(w), jnp.asarray(keys), jnp.asarray(values),
        jnp.asarray(labels), jnp.asarray(weights))
    lr = 0.3
    table = torch.from_numpy(w.copy())
    got = objective.make_sparse_step(Configure(**kw))(
        table, torch.from_numpy(keys.astype(np.int32)),
        torch.from_numpy(values), torch.from_numpy(labels),
        torch.from_numpy(weights), scale=lr, delta_rows=True)
    _close(got[0], loss, "loss")
    assert int(got[1]) == int(correct)
    _close(table.numpy(), np.asarray(jnp.asarray(w) - grad * jnp.float32(lr)),
           "updated weights")
    touched = np.nonzero(np.asarray(jnp.zeros(I_SIZE + 1).at[
        jnp.asarray(keys)].set(1.0, mode="drop")))[0]
    np.testing.assert_array_equal(got[2].numpy(), touched)
    _close(got[3].numpy(), np.asarray(grad)[touched] * np.float32(lr),
           "delta rows")
    if kind == "dropped":
        assert touched.size == 0
        np.testing.assert_array_equal(table.numpy(), w)


def test_sparse_lr_apply_padded_rows_and_no_launch():
    """The wrapper's own form: the touched rows ascending, then R to the
    end of B*K; their delta rows first; (None, None) without
    ``delta_rows``; nothing launched on the CPU."""
    rng = np.random.default_rng(5)
    keys, values, labels, weights = _zipf_batch(rng, 32, 8, 1, "zipf")
    R = I_SIZE + 1
    w = torch.from_numpy((rng.standard_normal((R, 1)) * 0.5).astype(
        np.float32))
    k, v = torch.from_numpy(keys.astype(np.int32)), torch.from_numpy(values)
    _, diff, _, _ = lrk.sparse_lr_forward(
        w, k, v, torch.from_numpy(labels), torch.from_numpy(weights))
    count = torch.ones(1)
    before = (lrk.sparse_lr_apply.launches, keysort.key_sort.launches)
    rows, delta = lrk.sparse_lr_apply(w.clone(), k, v, diff, count,
                                      scale=0.5, delta_rows=True)
    want = lrk.touched_rows(k, R).rows
    U = want.numel()
    assert rows.shape == (keys.size,) and delta.shape == (keys.size, 1)
    assert torch.equal(rows[:U], want) and bool((rows[U:] == R).all())
    assert bool((delta[U:] == 0).all())
    assert lrk.sparse_lr_apply(w.clone(), k, v, diff, count) == (None, None)
    assert (lrk.sparse_lr_apply.launches,
            keysort.key_sort.launches) == before
    assert rows_k.scatter_levels(262144, lrk.SPAN) == [262144, 2048, 16]
    assert rows_k.scatter_levels(256, lrk.SPAN) == [256]
    assert rows_k.scatter_levels(257, lrk.SPAN) == [257, 4]


def _want_sort(ids: np.ndarray, rows: int):
    keys = ids.astype(np.int64)
    keys = np.where(keys < 0, keys + rows, keys)
    keys = np.where((keys >= 0) & (keys < rows), keys, rows)
    order = np.argsort(keys, kind="stable")
    return keys[order], order


@pytest.mark.parametrize("rows", [1, 2, 1000, 1_000_001, 2 ** 31 - 1])
def test_key_sort_plain_is_stable_with_the_key_rule(rows):
    rng = np.random.default_rng(rows % 1000)
    n = 5000
    ids = rng.integers(-min(rows, 2 ** 30) - 40, min(rows, 2 ** 30) + 40,
                       n).astype(np.int64)
    if rows == 2 ** 31 - 1:
        ids[::7] = 2 ** 31 - 2
        ids[1::7] = -(2 ** 31 - 1)          # wraps to row 0
        ids[2::7] = -(2 ** 31)              # dropped
    ids[::11] = ids[0]                      # a long run of one key
    ids = ids.astype(np.int32)
    keys, order = keysort.key_sort(torch.from_numpy(ids), rows)
    want_keys, want_order = _want_sort(ids, rows)
    assert keys.dtype == torch.int32 and order.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    np.testing.assert_array_equal(order.numpy(), want_order)
    assert keysort.key_bits(rows) == max(rows.bit_length(), 1)


@pytest.mark.parametrize("ids", [[], [5], [3, 3, 3, 3], [-1, -1, 7, 7, 2]])
def test_key_sort_plain_edges(ids):
    t = torch.tensor(ids, dtype=torch.int32).reshape(-1)
    keys, order = keysort.key_sort(t.reshape(1, -1) if ids else t, 6)
    want_keys, want_order = _want_sort(np.asarray(ids, np.int64), 6)
    assert keys.tolist() == want_keys.tolist()
    assert order.tolist() == want_order.tolist()
