"""The sparse tables' device protocols and the stateful rules through the
table API: the port against the JAX package, in-process.

The same calls go through ``multiverso_tpu`` (reference) and
``multiverso_tpu_torch`` (port, ``device="cpu"``, so the kernels' plain
versions run), one package after the other, each with its own zoo shut
down before the next starts:

- the ``-2`` device-reply dirty Get (``get_dirty_device``) and the
  ``-4`` fused add + dirty Get (``add_get_dirty_device``) in the
  sequence of ``tests/test_tables.py``'s dirty-device tests — initial
  sync, an add by another worker, a clean re-read, fused rounds, the
  device mirror of the add ids, the composed pair after the fused —
  under every rule, on a table with one consumer and on a pipelined
  table with two (the adder worker 0, the dirty set read for consumer
  1), with duplicate ids; the dirty-set cache; every CHECK's message;
- ``get_device`` on dense matrix tables;
- array tables under each stateful rule, workers in and past the slots.

The returned ids are compared exactly; values, whole tables and the
rules' state within rtol 1e-5 / atol 1e-7 (bit for bit under default
and sgd, whose values here are sums of grid-exact floats).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.updater import AddOption as JAddOption
from multiverso_tpu.updater.engine import pad_ids as jpad_ids
from multiverso_tpu_torch.updater import AddOption as TAddOption
from multiverso_tpu_torch.updater.engine import pad_ids

R, C = 64, 5
TOL = dict(rtol=1e-5, atol=1e-7)
HYP = dict(momentum=0.9, learning_rate=0.01, rho=0.1, lambda_=0.1)


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Leaves the port's flag registry at its defaults and its role
    threads at their baseline (tests/conftest.py guards only the
    reference's)."""
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


class _Api:
    """What a script needs of one package."""

    def __init__(self, mv, as_device, add_option, argv=()):
        self.mv, self.as_device, self.AddOption = mv, as_device, add_option
        self.argv = list(argv)

    def server(self, table):
        return self.mv.current_zoo().server_tables[table.table_id]


def _in_both(script, argv=()):
    jmv.init(list(argv))
    try:
        ref = script(_Api(jmv, jnp.asarray, JAddOption))
    finally:
        jmv.shutdown()
    tmv.init(list(argv), device="cpu")
    try:
        got = script(_Api(tmv, torch.from_numpy, TAddOption))
    finally:
        tmv.shutdown()
    return got, ref


def _compare(got, ref, exact: bool):
    assert got.keys() == ref.keys()
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape, key
        if key.startswith("ids") or exact:
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, err_msg=key, **TOL)


def _snapshot(api, table, out, tag):
    server = api.server(table)
    out[f"table_{tag}"] = np.asarray(server.raw)[:R, :C].copy()
    state = server._engine.state
    if state is not None:
        # A copy: the reference donates the state buffer to its next
        # update.
        out[f"state_{tag}"] = np.asarray(state)[..., :R, :C].copy()


def _dirty_script(updater_type, pipeline: bool):
    """The dirty-device sequence. With one consumer the adds come from
    worker 1 and worker 0 reads (the reference bench's options); on a
    pipelined table worker 0 adds, the fused Get reads consumer 1 and
    the composed rounds add as worker -1 (no adder: every consumer's
    flags go dirty, the rule takes worker 0's state)."""
    stateless = updater_type in ("default", "sgd")

    def script(api):
        out = {}
        t = api.mv.create_matrix_table(R, C, is_sparse=True,
                                       is_pipeline=pipeline,
                                       updater_type=updater_type)
        rng = np.random.default_rng(7)
        ids, vals = t.get_dirty_device()  # initial: every row is dirty
        out["ids_init"], out["vals_init"] = ids, vals
        adder = 0 if pipeline else 1
        reader = 1 if pipeline else 0
        composed = -1 if pipeline else 1
        rows = np.array([2, 9, 40, 9, 63, 2], np.int32)  # duplicates

        def delta(k):
            # Multiples of 1/64 below 1: every sum is exact in float32.
            return api.as_device(np.round(rng.standard_normal(
                (k, C)) * 16).astype(np.float32) / 64)

        opt = api.AddOption(worker_id=composed, **HYP)
        t.add_rows(rows, delta(rows.size), option=opt)
        out["ids_add"], out["vals_add"] = t.get_dirty_device()
        out["ids_clean"], out["vals_clean"] = t.get_dirty_device()
        _snapshot(api, t, out, "composed")
        fused = api.AddOption(worker_id=adder, **HYP)
        for i in range(3):
            sub = rows[:4] if i == 1 else rows
            out[f"ids_fused{i}"], out[f"vals_fused{i}"] = \
                t.add_get_dirty_device(sub, delta(sub.size), option=fused,
                                       get_worker=reader)
        if stateless:
            mirror = api.as_device(pad_ids(rows, R))
            out["ids_mirror"], out["vals_mirror"] = t.add_get_dirty_device(
                rows, delta(rows.size), option=fused, get_worker=reader,
                row_ids_device=mirror)
        _snapshot(api, t, out, "fused")
        t.add_rows(rows[::2], delta(3), option=opt)
        out["ids_after"], out["vals_after"] = t.get_dirty_device()
        _snapshot(api, t, out, "after")
        return out
    return script


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("updater_type",
                         ["default", "sgd", "momentum_sgd", "adagrad",
                          "dcasgd"])
def test_dirty_device_protocols_match_reference(updater_type, pipeline):
    got, ref = _in_both(_dirty_script(updater_type, pipeline))
    _compare(got, ref, exact=updater_type in ("default", "sgd"))
    # The protocol itself, not only agreement.
    assert ref["ids_init"].size == R
    assert got["ids_add"].tolist() == [2, 9, 40, 63]
    assert got["ids_clean"].size == 0
    assert got["vals_clean"].shape == (0, C)
    assert isinstance(got["vals_fused0"], torch.Tensor)
    # Consumer 1 of a pipelined table reads every row the first time.
    assert got["ids_fused0"].tolist() == (
        list(range(R)) if pipeline else [2, 9, 40, 63])
    assert got["ids_fused1"].tolist() == [2, 9, 40]


def test_the_flag_selects_the_rule():
    # -updater_type reaches the server when the table names no rule.
    got, ref = _in_both(_dirty_script(None, True),
                        argv=["-updater_type=adagrad"])
    _compare(got, ref, exact=False)
    assert "state_after" in got


def test_fused_dirty_get_reuses_the_dirty_set_on_the_card():
    tmv.init([], device="cpu")
    try:
        t = tmv.create_matrix_table(R, C, is_sparse=True)
        server = tmv.current_zoo().server_tables[t.table_id]
        t.get_dirty_device()
        rows = np.array([1, 5], np.int32)
        opt = TAddOption(worker_id=1)
        t.add_get_dirty_device(rows, torch.ones(2, C), option=opt)
        first = server._dirty_dev_cache[1]
        _, vals = t.add_get_dirty_device(rows, torch.ones(2, C),
                                         option=opt)
        assert server._dirty_dev_cache[1] is first
        assert vals.tolist() == [[2.0] * C] * 2
        _, vals = t.add_get_dirty_device(np.array([5], np.int32),
                                         torch.ones(1, C), option=opt)
        assert server._dirty_dev_cache[1] is not first
        assert vals.tolist() == [[3.0] * C]
    finally:
        tmv.shutdown()


def _check_messages(api):
    """Each CHECK of the device protocols; the message the caller sees."""
    sparse = api.mv.create_matrix_table(R, C, is_sparse=True)
    stateful = api.mv.create_matrix_table(R, C, is_sparse=True,
                                          updater_type="momentum")
    dense = api.mv.create_matrix_table(R, C)
    rows = np.array([1, 2], np.int32)
    dev = api.as_device(np.ones((2, C), np.float32))
    mirror = api.as_device(pad_ids(rows, R))
    seen = []
    cases = [
        (lambda: dense.get_dirty_device(), "dirty gets are for sparse"),
        (lambda: dense.add_get_dirty_device(rows, dev), "sparse tables"),
        (lambda: sparse.get_device(), "device get is for dense tables"),
        (lambda: sparse.add_get_dirty_device(rows, np.ones((2, C),
                                                           np.float32)),
         "fused add needs a device delta"),
        (lambda: sparse.add_get_dirty_device(
            rows, api.as_device(np.ones((3, C), np.float32))),
         "bad delta shape"),
        (lambda: sparse.add_get_dirty_device(rows, dev, get_worker=1),
         "consumer-slot range"),
        (lambda: sparse.add_get_dirty_device(rows, dev, row_ids_device=rows),
         "row_ids_device must be a device"),
        (lambda: sparse.add_get_dirty_device(
            rows, dev, row_ids_device=api.as_device(rows)),
         "padded to the host bucket"),
        (lambda: stateful.add_get_dirty_device(rows, dev,
                                               row_ids_device=mirror),
         "stateless updater"),
        (lambda: sparse.add_get_dirty_device(np.array([1, R], np.int32),
                                             dev), "out of range"),
    ]
    for call, text in cases:
        with pytest.raises(Exception, match=text):
            call()
        seen.append(text)
    return {"seen": np.array(len(seen))}


def test_device_protocol_checks_match_reference():
    got, ref = _in_both(_check_messages)
    assert int(got["seen"]) == int(ref["seen"]) == 10


def _verify_script(api):
    t = api.mv.create_matrix_table(R, C, is_sparse=True)
    rows = np.array([1, 2, 3], np.int32)
    dev = api.as_device(np.ones((3, C), np.float32))
    wrong = pad_ids(rows, R)
    wrong[0] = 7
    with pytest.raises(Exception, match="disagrees with the host row ids"):
        t.add_get_dirty_device(rows, dev, row_ids_device=api.as_device(
            wrong))
    live_pad = pad_ids(rows, R)
    live_pad[5] = 0
    with pytest.raises(Exception, match="padding ids must be"):
        t.add_get_dirty_device(rows, dev, row_ids_device=api.as_device(
            live_pad))
    ids, vals = t.add_get_dirty_device(
        rows, dev, option=api.AddOption(worker_id=1),
        row_ids_device=api.as_device(pad_ids(rows, R)))
    return {"ids": ids, "vals": np.asarray(vals)}


def test_verify_device_ids_reads_the_mirror_back():
    got, ref = _in_both(_verify_script, argv=["-verify_device_ids=true"])
    _compare(got, ref, exact=True)
    assert np.array_equal(jpad_ids(np.array([1], np.int32), R),
                          pad_ids(np.array([1], np.int32), R))


@pytest.mark.parametrize("updater_type", [None, "sgd", "adagrad"])
def test_dense_get_device_matches_reference(updater_type):
    def script(api):
        out = {}
        t = api.mv.create_matrix_table(R, C, random_init=(-0.5, 0.5),
                                       seed=3, updater_type=updater_type)
        out["init"] = np.asarray(t.get_device())
        rng = np.random.default_rng(1)
        for i in range(2):
            t.add(api.as_device(rng.standard_normal((R, C)).astype(
                np.float32) * 0.01), api.AddOption(worker_id=0, **HYP))
        got = t.get_device()
        out["after"] = np.asarray(got)
        out["host"] = t.get()
        t.add(np.ones((R, C), np.float32))
        out["snapshot_kept"] = np.asarray(got)  # a clone, not the storage
        return out
    got, ref = _in_both(script)
    _compare(got, ref, exact=updater_type != "adagrad")
    np.testing.assert_array_equal(got["after"], got["host"])
    np.testing.assert_array_equal(got["after"], got["snapshot_kept"])


@pytest.mark.parametrize("updater_type", ["momentum_sgd", "adagrad",
                                          "dcasgd"])
def test_array_tables_under_stateful_rules(updater_type):
    size = 37

    def script(api):
        out = {}
        t = api.mv.create_array_table(size, updater_type=updater_type)
        rng = np.random.default_rng(2)
        # Worker 0, then worker 5: past the one slot, the dense rule reads
        # the last slot and drops its state write.
        for i, worker in enumerate((0, 0, 5, 0)):
            delta = (rng.standard_normal(size) * 0.01).astype(np.float32)
            arg = api.as_device(delta) if i % 2 else delta
            t.add(arg, api.AddOption(worker_id=worker, **HYP))
            out[f"get{i}"] = t.get().copy()
        out["device"] = np.asarray(t.get_device())
        state = api.server(t)._engine.state
        out["state"] = np.asarray(state)[..., :size].copy()
        return out
    got, ref = _in_both(script)
    _compare(got, ref, exact=False)
