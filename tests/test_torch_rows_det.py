"""The deterministic row scatter (K3, K16) and the narrow row gather
(K2) on the CPU, against the JAX programs they replace.

The CUDA scatter sums each row's duplicates in an order fixed by the
data: the ids are mapped to keys and sorted stably (``scatter_plan``),
and the sorted positions are cut into tasks of ``CHUNK``; a run inside
a task is summed in position order onto its row, a run crossing a cut
as a tree of such sums (``scatter_levels``). ``row_scatter_add_ordered``
sums in exactly that order, in torch; the card holds the kernel to it
bit for bit (chip_smoke.py). Here it is held against
``UpdateEngine.apply_rows`` (the jitted ``.at[ids].add(mode="drop")``)
within ``2 L 2^-24 (|x0| + sum |delta|)`` an element, L the row's
occurrences: twice the first-order error bound of a float32 sum of
L + 1 terms, which covers both the tree and XLA's sequential order.
"""

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.tables.matrix_table import MatrixServer
from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu_torch import kernels
from multiverso_tpu_torch.kernels import rows
from multiverso_tpu_torch.updater import engine as tengine
from multiverso_tpu_torch.updater import rules as trules


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


R = 97


def _zipf_ids(seed: int, n: int):
    """Zipf ids over [0, R) with a head run longer than a task, wrapped
    negatives, the pad sentinel and ids past the table."""
    rng = np.random.default_rng(seed)
    ids = (np.minimum(rng.zipf(1.3, n), R) - 1).astype(np.int32)
    ids[:3 * rows.CHUNK + 5] = 4                    # a run of 101
    ids[200:210] = -rng.integers(1, R + 1, 10)      # wrap
    ids[210:215] = R                                # the pad sentinel
    ids[215:218] = [R + 3, -R - 1, 10 ** 6]         # dropped
    rng.shuffle(ids)
    return ids


def _wrapped_np(ids):
    w = np.where(ids < 0, ids + R, ids).astype(np.int64)
    return w, (w >= 0) & (w < R)


def _bound(data, ids, delta):
    """2 L 2^-24 (|x0| + sum |delta|) for every element of the table."""
    k, d = delta.shape
    w, ok = _wrapped_np(ids[:k])
    mass = np.abs(data[:, :d]).astype(np.float64)
    count = np.zeros(R)
    np.add.at(mass, w[ok], np.abs(delta[ok]).astype(np.float64))
    np.add.at(count, w[ok], 1)
    return 2.0 * np.maximum(count, 1)[:, None] * 2.0 ** -24 * mass


@pytest.mark.parametrize("n,k", [(700, 700), (700, 650), (300, 31)])
def test_scatter_plan_sorts_stably_and_cuts(n, k):
    ids = _zipf_ids(n, n)
    plan = rows.scatter_plan(torch.from_numpy(ids), k, R)
    keys, order = plan.keys.numpy(), plan.order.numpy()
    assert keys.dtype == np.int32 and keys.size == k
    assert np.all(np.diff(keys) >= 0)
    assert sorted(order.tolist()) == list(range(k))
    w = np.where(ids[:k] < 0, ids[:k] + R, ids[:k])
    np.testing.assert_array_equal(keys, w[order])
    # Stable: each run of equal keys keeps position order.
    same = keys[1:] == keys[:-1]
    assert np.all(order[1:][same] > order[:-1][same])
    heads = rows.run_heads(plan.keys).numpy()
    valid = (keys >= 0) & (keys < R)
    assert heads[valid].sum() == np.unique(w[(w >= 0) & (w < R)]).size
    sizes = rows.scatter_levels(k)
    assert sizes[0] == k and sizes[-1] <= rows.CHUNK
    for a, b in zip(sizes, sizes[1:]):
        assert b == 2 * -(-a // rows.CHUNK) and b < a
    # The preparation is the same bits on every run.
    again = rows.scatter_plan(torch.from_numpy(ids), k, R)
    assert torch.equal(plan.keys, again.keys)
    assert torch.equal(plan.order, again.order)


@pytest.mark.parametrize("width", [1, 3, 50, 128])
@pytest.mark.parametrize("rule", ["default", "sgd"])
def test_ordered_scatter_matches_apply_rows(width, rule):
    rng = np.random.default_rng(width)
    n = 700
    ids = _zipf_ids(width + 1, n)
    data = rng.standard_normal((R, width + 2)).astype(np.float32)
    delta = rng.standard_normal((n - 9, width)).astype(np.float32)
    j = jengine.UpdateEngine(jrules.create_rule(rule), (R, width + 2),
                             np.float32, 1)
    want = np.asarray(j.apply_rows(jnp.asarray(data), jnp.asarray(ids),
                                   jnp.asarray(delta)))
    sign = -1.0 if rule == "sgd" else 1.0
    plan = rows.scatter_plan(torch.from_numpy(ids), delta.shape[0], R)
    got = torch.from_numpy(data.copy())
    rows.row_scatter_add_ordered(got, plan, torch.from_numpy(delta), sign)
    err = np.abs(got.numpy()[:, :width] - want[:, :width])
    assert np.all(err <= _bound(data, ids, delta))
    np.testing.assert_array_equal(got.numpy()[:, width:], data[:, width:])
    # Bit for bit the same on a second run.
    again = torch.from_numpy(data.copy())
    rows.row_scatter_add_ordered(again, plan, torch.from_numpy(delta), sign)
    assert torch.equal(got, again)


@pytest.mark.parametrize("width", [1, 50])
def test_ordered_scatter_is_sequential_within_one_task(width):
    # Every run lies inside the one task: the sums are the plain
    # version's sequential ones, bit for bit.
    rng = np.random.default_rng(5)
    ids = np.array([3, 9, 3, 3, R, 0, 9, -1, 3, 7, 96], np.int32)
    data = rng.standard_normal((R, width)).astype(np.float32)
    delta = rng.standard_normal((ids.size, width)).astype(np.float32)
    want = torch.from_numpy(data.copy())
    rows.row_scatter_add_plain(want, torch.from_numpy(ids),
                               torch.from_numpy(delta), -1.0)
    got = torch.from_numpy(data.copy())
    rows.row_scatter_add_ordered(
        got, rows.scatter_plan(torch.from_numpy(ids), ids.size, R),
        torch.from_numpy(delta), -1.0)
    assert torch.equal(got, want)


def test_ordered_bounded_scatter_matches_bounded_plain():
    # K16's keys: the window's local rows, every other id dropped, no
    # wrap; the same summation order as K3.
    rng = np.random.default_rng(6)
    ids = rng.integers(-20, 2 * R, 900).astype(np.int32)
    ids[:300] = R + 5
    ofs, n = R, R - 10
    data = rng.standard_normal((R, 4)).astype(np.float32)
    delta = rng.standard_normal((900, 4)).astype(np.float32)
    want = torch.from_numpy(data.copy())
    rows.row_scatter_add_bounded_plain(want, torch.from_numpy(ids),
                                       torch.from_numpy(delta), ofs, n)
    got = torch.from_numpy(data.copy())
    rows.row_scatter_add_ordered(
        got, rows.scatter_plan(torch.from_numpy(ids), 900, R, (ofs, n)),
        torch.from_numpy(delta))
    local = ids.astype(np.int64) - ofs
    ok = (local >= 0) & (local < n)
    mass = np.abs(data).astype(np.float64)
    np.add.at(mass, local[ok], np.abs(delta[ok]).astype(np.float64))
    assert np.all(np.abs((got - want).numpy()) <= 2 * 300 * 2.0 ** -24
                  * mass)
    np.testing.assert_array_equal(got.numpy()[n:], data[n:])


@pytest.mark.parametrize("ids,ok", [
    ([0, 1, 5, R, R, R], True),           # the pad sentinel repeats
    ([2, R + 4, 3, 90], True),            # dropped ids do not count
    ([1, -R + 3], True),                  # wrapped: 1 < 3
    ([4, 4, 9], False),                   # repeats
    ([5, 2], False),                      # goes down
    ([0, -1, 3], False),                  # -1 wraps to R - 1, then 3
])
def test_distinct_claim_is_checked(ids, ok):
    ids = torch.tensor(ids, dtype=torch.int32)
    delta = torch.ones(ids.numel(), 2)
    table = torch.zeros(R, 2)
    if ok:
        rows.row_scatter_add(table, ids, delta, distinct=True)
        want = torch.zeros(R, 2)
        rows.row_scatter_add_plain(want, ids, delta)
        assert torch.equal(table, want)
    else:
        with pytest.raises(ValueError, match="repeat or go down"):
            rows.row_scatter_add(table, ids, delta, distinct=True)
    # Ids past the delta's rows are not claimed.
    rows.row_scatter_add_plain(torch.zeros(R, 2), torch.tensor(
        [1, 2, 2, 1], dtype=torch.int32), torch.ones(2, 2), distinct=True)


@pytest.mark.parametrize("host,claim", [
    (np.array([0, 3, 10, R - 1]), True),
    (np.array([], np.int32), True),
    (np.array([3, 3, 10]), False),        # repeats
    (np.array([5, 1]), False),            # goes down
    (np.array([-1, 2]), False),           # a negative id wraps
    (np.array([2, R]), False),            # past the table
])
def test_engine_claims_only_ascending_host_ids(host, claim, monkeypatch):
    assert tengine.ascending(host, R) is claim
    seen = []
    real = trules.row_scatter_add

    def spy(*args, **kw):
        seen.append(kw["distinct"])
        return real(*args, **kw)

    monkeypatch.setattr(trules, "row_scatter_add", spy)
    rng = np.random.default_rng(7)
    data = rng.standard_normal((R, 8)).astype(np.float32)
    delta = rng.standard_normal((host.size, 8)).astype(np.float32)
    ids = host.astype(np.int32)
    t = tengine.UpdateEngine(trules.create_rule("default"), (R, 8),
                             np.float32, 1)
    got = t.apply_rows(torch.from_numpy(data.copy()), ids, delta)
    assert seen == [claim]
    if ids.size:
        j = jengine.UpdateEngine(jrules.create_rule("default"), (R, 8),
                                 np.float32, 1)
        want = np.asarray(j.apply_rows(jnp.asarray(data), ids, delta))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_col", [1, 3])
@pytest.mark.parametrize("ascending", [True, False])
def test_narrow_gather_matches_jax_gather(n_col, ascending):
    # lr_sparse_ps's whole-table dirty Get: every row in order, padded
    # with the sentinel; and Zipf ids with wraps and drops.
    rng = np.random.default_rng(8)
    data = rng.standard_normal((R, 4)).astype(np.float32)
    ids = np.concatenate([np.arange(R), np.full(31, R)]).astype(np.int32) \
        if ascending else _zipf_ids(9, 300)
    fn = MatrixServer.__dict__["_gather"].func(
        types.SimpleNamespace(num_col=n_col))
    want = np.asarray(fn(jnp.asarray(data), jnp.asarray(ids)))
    got = rows.row_gather(torch.from_numpy(data), torch.from_numpy(ids),
                          n_col).numpy()
    assert got.shape == (ids.size, n_col)
    np.testing.assert_array_equal(got, want)


def test_row_wrappers_launch_nothing_on_cpu():
    before = kernels.launch_counts()
    ids = torch.tensor([1, 1, 5, R], dtype=torch.int32)
    table, delta = torch.zeros(R, 2), torch.ones(4, 2)
    rows.row_scatter_add(table, ids, delta)
    rows.row_scatter_add(table, torch.tensor([1, 5, R, R],
                                             dtype=torch.int32),
                         delta, distinct=True)
    rows.row_scatter_add_bounded(table, ids, delta, 0, R)
    rows.row_scatter_add_ordered(table, rows.scatter_plan(ids, 4, R), delta)
    rows.row_gather(table, ids, 1)
    assert kernels.launch_counts() == before
