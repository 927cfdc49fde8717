"""The port's array tables and sparse matrix tables against the JAX
package's, in-process.

The same calls go through ``multiverso_tpu`` (reference) and
``multiverso_tpu_torch`` (port, ``device="cpu"``), one package after the
other, each with its own zoo shut down before the next starts:

- array tables with the default (``+=``) and sgd (``-=``) rules: host and
  tensor deltas, ``get``, ``get_device``, ``store``/``load`` across the
  packages, fused adds on the server;
- sparse matrix tables' dirty-row protocol: the first whole-table Get
  returns every row, later ones only the rows another worker's Add
  dirtied, the adder's own flags kept, row Gets marking rows clean, the
  second consumer slot of a pipelined table.

Every value is a single float add or a copy, so the results are
compared bit for bit.
"""

import io
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv

SIZE = 37


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


def _in_both(script):
    """``script(mv, as_device)`` run by the reference, then by the port;
    returns both results."""
    jmv.init([])
    try:
        ref = script(jmv, jnp.asarray)
    finally:
        jmv.shutdown()
    tmv.init([], device="cpu")
    try:
        got = script(tmv, torch.from_numpy)
    finally:
        tmv.shutdown()
    return got, ref


def _same(got, ref):
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("updater_type", [None, "default", "sgd"])
def test_array_table_matches_reference(updater_type):
    def script(mv, as_device):
        rng = np.random.default_rng(0)
        out = {}
        t = mv.create_array_table(SIZE, updater_type=updater_type)
        out["zero"] = t.get().copy()
        t.add(rng.standard_normal(SIZE).astype(np.float32))
        out["host_add"] = t.get().copy()
        t.add(as_device(rng.standard_normal(SIZE).astype(np.float32)))
        out["device_add"] = np.asarray(t.get_device())
        t.add(rng.standard_normal(SIZE).astype(np.float32),
              option=mv.AddOption(worker_id=0, learning_rate=0.5))
        buf = np.full(SIZE, 9.0, np.float32)
        t.get(out=buf)
        out["into_buffer"] = buf
        t2 = mv.create_table(mv.ArrayTableOption(
            size=5, updater_type=updater_type))
        t2.add(np.ones(5, np.float32))
        out["option_table"] = t2.get().copy()
        return out

    _same(*_in_both(script))


def test_array_store_and_load_cross_the_packages():
    values = np.random.default_rng(1).standard_normal(SIZE).astype(
        np.float32)
    jmv.init([])
    try:
        t = jmv.create_array_table(SIZE)
        t.add(values)
        ref_bytes = io.BytesIO()
        jmv.current_zoo().server_tables[t.table_id].store(ref_bytes)
    finally:
        jmv.shutdown()
    tmv.init([], device="cpu")
    try:
        t = tmv.create_array_table(SIZE)
        server = tmv.current_zoo().server_tables[t.table_id]
        server.load(io.BytesIO(ref_bytes.getvalue()))
        np.testing.assert_array_equal(t.get(), values)
        back = io.BytesIO()
        server.store(back)
        assert back.getvalue() == ref_bytes.getvalue()
    finally:
        tmv.shutdown()


def test_array_replies_never_alias_live_storage():
    tmv.init([], device="cpu")
    try:
        t = tmv.create_array_table(SIZE)
        before = t.get_device()
        t.add(np.ones(SIZE, np.float32))
        assert not before.any()
        assert bool((t.get_device() == 1).all())
    finally:
        tmv.shutdown()


def test_array_fused_adds_equal_serial_adds():
    """The server folds fused host deltas before one apply — the same
    sums as the serial loop (the reference's contract)."""
    from multiverso_tpu_torch.core.blob import Blob
    rng = np.random.default_rng(2)
    deltas = [rng.standard_normal(SIZE).astype(np.float32)
              for _ in range(3)]
    key = Blob(np.array([-1], np.int32).view(np.uint8))
    tmv.init([], device="cpu")
    try:
        fused = tmv.create_array_table(SIZE, updater_type="sgd")
        serial = tmv.create_array_table(SIZE, updater_type="sgd")
        servers = tmv.current_zoo().server_tables
        assert servers[fused.table_id].fuse_eligible([key, Blob(deltas[0])],
                                                     is_get=False)
        servers[fused.table_id].process_fused_add(
            [[key, Blob(d)] for d in deltas])
        for d in deltas:
            serial.add(d)
        acc = deltas[0] + deltas[1] + deltas[2]
        np.testing.assert_array_equal(fused.get(), -acc)
        np.testing.assert_allclose(serial.get(), -acc, rtol=1e-6)
        replies = servers[fused.table_id].process_fused_get([[key], [key]])
        assert replies[0][1].data is replies[1][1].data
    finally:
        tmv.shutdown()


# -- sparse matrix tables --

R, C = 12, 3


def _dirty_script(is_pipeline, updater_type):
    def script(mv, as_device):
        rng = np.random.default_rng(3)
        out = {}
        t = mv.create_matrix_table(R, C, is_sparse=True,
                                   is_pipeline=is_pipeline,
                                   updater_type=updater_type)
        t.add_rows(np.array([2, 5], np.int32),
                   rng.standard_normal((2, C)).astype(np.float32))
        # First Get: every row (all flags start False); fresh buffer.
        out["first"] = t.get().copy()

        def get_into(tag):
            buf = np.full((R, C), 7.0, np.float32)
            t.get(out=buf)
            out[tag] = buf

        # Worker 0's own Add keeps its flags: nothing comes back.
        t.add_rows(np.array([1, 3, 3], np.int32),
                   rng.standard_normal((3, C)).astype(np.float32))
        get_into("after_own_add")
        # Another worker's Add dirties its rows for worker 0.
        t.add_rows(np.array([4, 9], np.int32),
                   rng.standard_normal((2, C)).astype(np.float32),
                   option=mv.AddOption(worker_id=1))
        get_into("after_other_add")
        get_into("nothing_left")
        # A row Get marks its rows clean for the asker.
        t.add_rows(np.array([0, 6, 11], np.int32),
                   rng.standard_normal((3, C)).astype(np.float32),
                   option=mv.AddOption(worker_id=1))
        out["row_get"] = t.get_rows(np.array([6, 6, 0], np.int32)).copy()
        get_into("after_row_get")
        # A whole-table Add by another worker dirties every row.
        t.add(rng.standard_normal((R, C)).astype(np.float32),
              option=mv.AddOption(worker_id=1))
        get_into("after_whole_add")
        if is_pipeline:
            # The pipelined table's second consumer slot (worker id 1)
            # still has every row dirty.
            from multiverso_tpu.core.blob import Blob as JBlob
            from multiverso_tpu_torch.core.blob import Blob as TBlob
            blob = JBlob if mv is jmv else TBlob
            buf = np.full((R, C), 7.0, np.float32)
            t._dest, t._dest_rows, t._device_shards = buf, None, None
            t.wait(t.get_async_raw(
                blob(np.array([-1], np.int32).view(np.uint8)),
                [mv.GetOption(1).to_blob()]))
            out["consumer_1"] = buf
        return out
    return script


@pytest.mark.parametrize("is_pipeline", [False, True])
@pytest.mark.parametrize("updater_type", ["default", "sgd"])
def test_sparse_table_dirty_rows_match_reference(is_pipeline, updater_type):
    got, ref = _in_both(_dirty_script(is_pipeline, updater_type))
    _same(got, ref)
    # The protocol itself, not only agreement.
    assert (ref["after_own_add"] == 7.0).all()
    assert (ref["nothing_left"] == 7.0).all()
    changed = np.nonzero((ref["after_other_add"] != 7.0).any(axis=1))[0]
    assert changed.tolist() == [4, 9]
    assert ((got["after_row_get"] != 7.0).any(axis=1)).nonzero()[0] \
        .tolist() == [11]
    assert not (got["after_whole_add"] == 7.0).any()


def test_sparse_table_device_requests_and_dirty_protocols_raise():
    tmv.init([], device="cpu")
    try:
        t = tmv.create_matrix_table(R, C, is_sparse=True)
        with pytest.raises(Exception, match="dense tables"):
            t.add_rows(torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, C))
        with pytest.raises(Exception, match="dense tables"):
            t.get_rows_device(torch.zeros(2, dtype=torch.int32))
        with pytest.raises(NotImplementedError, match="A6"):
            t.get_dirty_device()
        with pytest.raises(NotImplementedError, match="B3"):
            t.add_get_dirty_device(np.array([1], np.int32),
                                   torch.zeros(1, C))
    finally:
        tmv.shutdown()
