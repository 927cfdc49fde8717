"""K14 ``rows_apply_gather``'s stateless arm on the CPU, against the JAX
program it replaces (``UpdateEngine.apply_rows_gather`` under the
default and sgd rules).

On the card the fused add-then-gather sums repeated ids in K3's fixed
order: the first ``k`` ids are sorted stably (``rows.scatter_plan``),
the sorted positions cut into tasks of ``rows.CHUNK`` and summed level
by level (``rows.scatter_levels``) inside the one cooperative launch,
then the updated rows are gathered. Its plain form is therefore
``rows.row_scatter_add_ordered`` followed by ``rows.row_gather_plain``,
which chip_smoke.py holds the kernel to bit for bit. Here that form is
held against JAX within ``2 L 2^-24 (|x0| + sum |delta|)`` an element,
L the row's occurrences (the bound of tests/test_torch_rows_det.py: a
float32 sum of L + 1 terms in either order), and bit for bit against
the sequential plain version where no run crosses a cut. Ids that the
engine finds strictly ascending on the host take K3's one-writer form
(``distinct=True``, no sort); a device mirror of the ids is never
inspected, so it never makes the claim.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.updater import engine as jengine
from multiverso_tpu.updater import rules as jrules
from multiverso_tpu_torch import kernels
from multiverso_tpu_torch.kernels import rows, rules
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
HOT = 4096          # one row at this many positions (chip_smoke phase 10)


def _ids(seed: int, n: int, hot: int = 0):
    """Zipf ids over [0, R) with a head run of ``hot`` positions, wrapped
    negatives, the pad sentinel and ids past the table, shuffled."""
    rng = np.random.default_rng(seed)
    ids = (np.minimum(rng.zipf(1.3, n), R) - 1).astype(np.int32)
    ids[:hot] = 11
    ids[hot:hot + 10] = -rng.integers(1, R + 1, 10)     # wrap
    ids[hot + 10:hot + 15] = R                           # the sentinel
    ids[hot + 15:hot + 18] = [R + 3, -R - 1, 10 ** 6]    # dropped
    rng.shuffle(ids)
    return ids


def _bound(data, ids, delta):
    """2 L 2^-24 (|x0| + sum |delta|) for every element of the table."""
    k, d = delta.shape
    w = np.where(ids[:k] < 0, ids[:k] + R, ids[:k]).astype(np.int64)
    ok = (w >= 0) & (w < R)
    mass = np.abs(data[:, :d]).astype(np.float64)
    count = np.zeros(R)
    np.add.at(mass, w[ok], np.abs(delta[ok]).astype(np.float64))
    np.add.at(count, w[ok], 1)
    return 2.0 * np.maximum(count, 1)[:, None] * 2.0 ** -24 * mass


def _ordered_fused(rule, data, ids, delta, get_ids, n_col):
    """The card's K14 on raw deltas, in torch: K3's order, then the
    gather of the updated table."""
    sign = -1.0 if rule == "sgd" else 1.0
    rows.row_scatter_add_ordered(
        data, rows.scatter_plan(ids, delta.shape[0], R), delta, sign)
    return rows.row_gather_plain(data, get_ids, n_col)


@pytest.mark.parametrize("width", [1, 3, 50])
@pytest.mark.parametrize("rule", ["default", "sgd"])
@pytest.mark.parametrize("hot", [0, HOT], ids=["zipf", "hot4096"])
def test_ordered_fused_matches_apply_rows_gather(rule, width, hot):
    rng = np.random.default_rng(width + hot)
    n = 8192 if hot else 1024               # bucket-padded, as required
    ids = _ids(width + 1, n, hot)
    k = n - 9                                # ids past k add zero
    data = rng.standard_normal((R, width + 2)).astype(np.float32)
    delta = rng.standard_normal((k, width)).astype(np.float32)
    if hot:   # both signs at the hot row: its steps cancel
        delta[ids[:k] == 11] *= np.where(
            rng.random((int((ids[:k] == 11).sum()), 1)) < 0.5, 1, -1)
    get_ids = jengine.pad_ids(np.array([11, 0, -1, 5, R, R + 9, 96],
                                       np.int32), R)
    j = jengine.UpdateEngine(jrules.create_rule(rule), (R, width + 2),
                             np.float32, 1)
    jdata, jvals = j.apply_rows_gather(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(delta), None,
        jnp.asarray(get_ids), width)
    got = torch.from_numpy(data.copy())
    vals = _ordered_fused(rule, got, torch.from_numpy(ids),
                          torch.from_numpy(delta),
                          torch.from_numpy(get_ids), width)
    bound = _bound(data, ids, delta)
    err = np.abs(got.numpy() - np.asarray(jdata))
    assert (err[:, :width] <= bound).all(), float(
        (err[:, :width] / np.maximum(bound, 1e-30)).max())
    assert not err[:, width:].any()          # columns past the delta
    w = np.where(get_ids < 0, get_ids + R, get_ids)
    ok = (w >= 0) & (w < R)
    np.testing.assert_array_equal(vals.numpy()[ok],
                                  got.numpy()[w[ok], :width])
    assert not vals.numpy()[~ok].any()       # the sentinel, past the table
    verr = np.abs(vals.numpy() - np.asarray(jvals))
    assert (verr[ok] <= bound[w[ok]]).all()
    # The same bits on every run.
    again = torch.from_numpy(data.copy())
    vals2 = _ordered_fused(rule, again, torch.from_numpy(ids),
                           torch.from_numpy(delta),
                           torch.from_numpy(get_ids), width)
    assert torch.equal(got, again) and torch.equal(vals, vals2)


@pytest.mark.parametrize("rule", ["default", "sgd"])
@pytest.mark.parametrize("runs", ["short", "one_task"])
def test_ordered_fused_is_sequential_within_a_task(rule, runs):
    # Every run inside one task: the kernel's order IS position order,
    # so the fused form equals K14's sequential plain version bit for
    # bit (no tolerance), wraps, sentinels and drops included.
    rng = np.random.default_rng(3)
    n = 256
    if runs == "short":
        # Runs of 4 (so none crosses a cut of 32): 60 rows, row R - 1
        # and row 0 reached by wrapped ids, and ids out of range (which
        # sort last and are skipped).
        ids = np.concatenate([np.repeat(rng.permutation(
            np.arange(1, R - 1))[:60], 4), [-1] * 4, [-R] * 4,
            [R, R + 7] * 4]).astype(np.int32)
        rng.shuffle(ids)
    else:                        # one run filling exactly one task
        ids = np.concatenate([np.full(rows.CHUNK, 7), rng.permutation(
            np.arange(8, R))]).astype(np.int32)
        n = ids.size
    data = rng.standard_normal((R, 6)).astype(np.float32)
    delta = rng.standard_normal((n, 6)).astype(np.float32)
    get_ids = torch.arange(-3, R + 3, dtype=torch.int32)
    got = torch.from_numpy(data.copy())
    vals = _ordered_fused(rule, got, torch.from_numpy(ids),
                          torch.from_numpy(delta), get_ids, 6)
    want = torch.from_numpy(data.copy())
    wvals = rules.rows_apply_gather_plain(
        rule, want, None, torch.from_numpy(ids), torch.from_numpy(delta),
        (0, 0, 0, 0), 0, get_ids, 6)
    assert torch.equal(got, want) and torch.equal(vals, wvals)


@pytest.mark.parametrize("host,claim", [
    (np.array([0, 3, 10, R - 1]), True),
    (np.array([0, 3, 10, R - 1, R, R, R, R]), True),   # bucket padding
    (np.array([R, R]), True),                          # only padding
    (np.array([3, 3, 10, R]), False),                  # repeats
    (np.array([5, 1, R, R]), False),                   # goes down
    (np.array([-1, 2]), False),                        # wraps
    (np.array([2, R, 5, R]), False),                   # the sentinel inside
])
@pytest.mark.parametrize("rule", ["default", "sgd", "adagrad"])
def test_engine_claims_distinct_only_for_ascending_host_ids(host, claim,
                                                            rule,
                                                            monkeypatch):
    seen = []
    real = trules.rows_apply_gather

    def spy(*args, **kw):
        seen.append(kw["distinct"])
        return real(*args, **kw)

    monkeypatch.setattr(trules, "rows_apply_gather", spy)
    rng = np.random.default_rng(9)
    data = rng.standard_normal((R, 8)).astype(np.float32)
    ids = jengine.pad_ids(host.astype(np.int32), R)   # bucket-padded
    delta = rng.standard_normal((host.size, 8)).astype(np.float32)
    get_ids = jengine.pad_ids(np.array([0, 3, 10, 96], np.int32), R)
    t = tengine.UpdateEngine(trules.create_rule(rule), (R, 8), np.float32,
                             1)
    _, vals = t.apply_rows_gather(torch.from_numpy(data.copy()), ids,
                                  delta, None, get_ids, 8)
    # A device mirror of the same ids is not inspected: never a claim.
    t.apply_rows_gather(torch.from_numpy(data.copy()), torch.from_numpy(
        ids), torch.from_numpy(delta), None, torch.from_numpy(get_ids), 8)
    assert seen == [claim, False]
    j = jengine.UpdateEngine(jrules.create_rule(rule), (R, 8), np.float32,
                             1)
    _, jvals = j.apply_rows_gather(jnp.asarray(data), jnp.asarray(ids),
                                   jnp.asarray(delta), None,
                                   jnp.asarray(get_ids), 8)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("ids", [[4, 4, 9, R], [5, 2, R, R], [0, -1, 3, R]])
def test_plain_form_raises_on_a_false_claim(ids):
    ids = torch.tensor(ids, dtype=torch.int32)
    with pytest.raises(ValueError, match="repeat or go down"):
        rules.rows_apply_gather("default", torch.zeros(R, 2), None, ids,
                                torch.ones(4, 2), (0, 0, 0, 0), 0, ids, 2,
                                distinct=True)
    # A stateful rule's distinct form checks the claim too.
    with pytest.raises(ValueError, match="repeat or go down"):
        rules.rows_apply_gather("adagrad", torch.zeros(R, 2),
                                torch.zeros(1, R, 2), ids, torch.ones(4, 2),
                                (0, 0.1, 0.1, 0), 0, ids, 2, distinct=True)


@pytest.mark.parametrize("host,kept", [
    ([3, 5, R, R], [3, 5]), ([R, R], []), ([3, 5], [3, 5]),
    ([R, 4, R], [R, 4]), ([], [])])
def test_unpadded_drops_only_the_trailing_sentinels(host, kept):
    got = tengine.unpadded(np.array(host, np.int32), R)
    np.testing.assert_array_equal(got, np.array(kept, np.int32))


@pytest.mark.parametrize("n,d", [(0, 4), (1, 4), (32, 50), (33, 50),
                                 (131072, 50), (4096, 1)])
def test_level_slots_hold_every_level(n, d):
    slot_keys, slot_vals, cap_a = rows.level_slots(n, d, "cpu")
    sizes = rows.scatter_levels(n)
    # Levels 1, 3, ... in the first cap_a slots, 2, 4, ... after them.
    assert cap_a == (sizes[1] if len(sizes) > 1 else 0)
    odd = max([s for i, s in enumerate(sizes) if i % 2 == 1], default=0)
    even = max([s for i, s in enumerate(sizes) if i and i % 2 == 0],
               default=0)
    assert cap_a >= odd and slot_keys.numel() - cap_a >= even
    assert slot_keys.dtype == torch.int32
    assert slot_vals.numel() == slot_keys.numel() * d


def test_fused_wrapper_launches_nothing_on_cpu():
    before = kernels.launch_counts()
    ids = torch.tensor([1, 1, 5, R], dtype=torch.int32)
    for rule in ("default", "sgd"):
        for distinct in (False, True):
            use = torch.tensor([1, 5, R, R], dtype=torch.int32) \
                if distinct else ids
            rules.rows_apply_gather(rule, torch.zeros(R, 2), None, use,
                                    torch.ones(4, 2), (0, 0, 0, 0), 0, use,
                                    2, distinct=distinct)
    assert kernels.launch_counts() == before
