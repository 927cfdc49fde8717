"""The port's parameter server against the JAX package's, in-process.

The same calls go through ``multiverso_tpu`` (reference) and
``multiverso_tpu_torch`` (port, ``device="cpu"``: CPU tensors, so the
kernels' plain versions run), one package after the other — each with
its own zoo, shut down before the next starts. Dense matrix tables with
``random_init``, host and device-key Gets and Adds, the whole-table
paths, ``store``/``load`` across the packages and the word-count KV
table. Gets are bit-exact; Adds whose ids repeat are compared with
rtol=1e-6, atol=1e-7, because duplicate rows sum in another order.
Only logical rows are compared (the reference pads its storage to the
test mesh's 8 virtual devices).
"""

import io
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv

R, COLS = 50, 40          # 40 columns: storage pads to 128 (n_col < width)


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


def _script(mv, as_ids, as_rows):
    """Drive one package through the table API; returns the observed
    results in order."""
    out = {}
    rng = np.random.default_rng(0)
    t = mv.create_matrix_table(R, COLS, random_init=(-0.5, 0.5), seed=3)
    out["init"] = t.get().copy()
    ids = np.array([3, 3, 0, 49, 17, 17, 17, 8], np.int32)
    out["rows"] = t.get_rows(ids).copy()
    dev_ids = np.array([[5, 5, 49], [0, 12, 5]], np.int32)
    out["dev_rows"] = np.asarray(t.get_rows_device(as_ids(dev_ids)))
    # Unique ids: every element takes one float add -> still bit-exact.
    uniq = np.array([1, 4, 9, 30, 31], np.int32)
    t.add_rows(uniq, rng.standard_normal((5, COLS)).astype(np.float32))
    out["after_unique_add"] = t.get().copy()
    # Duplicates, host keys and device keys.
    t.add_rows(ids, rng.standard_normal((ids.size, COLS)).astype(
        np.float32))
    t.add_rows(as_ids(dev_ids), as_rows(rng.standard_normal(
        dev_ids.shape + (COLS,)).astype(np.float32)))
    out["after_dup_add"] = t.get().copy()
    t.add(np.full((R, COLS), 0.25, np.float32))
    out["after_dense_add"] = t.get().copy()
    kv = mv.create_kv_table()
    kv.add([0, 7], [3.0, 4.0])
    kv.add([0], [2.5])
    out["kv"] = dict(kv.get([0, 7]))
    return out


def _run_reference():
    jmv.init([])
    try:
        out = _script(jmv, jnp.asarray, jnp.asarray)
        buf = io.BytesIO()
        zoo = jmv.current_zoo()
        zoo.server_tables[0].store(buf)
        out["stored"] = buf.getvalue()
    finally:
        jmv.shutdown()
    return out


def _run_port():
    tmv.init([], device="cpu")
    try:
        return _script(tmv, torch.from_numpy, torch.from_numpy)
    finally:
        tmv.shutdown()


def test_tables_match_reference():
    want = _run_reference()
    got = _run_port()
    for name in ("init", "rows", "dev_rows", "after_unique_add"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("after_dup_add", "after_dense_add"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert got["kv"] == want["kv"]


def test_reference_store_loads_into_port():
    want = _run_reference()
    tmv.init([], device="cpu")
    try:
        t = tmv.create_matrix_table(R, COLS)
        server = tmv.current_zoo().server_tables[t.table_id]
        server.load(io.BytesIO(want["stored"]))
        np.testing.assert_array_equal(t.get(), want["after_dense_add"])
        buf = io.BytesIO()
        server.store(buf)
        assert buf.getvalue() == want["stored"]
    finally:
        tmv.shutdown()


def test_replies_never_alias_live_storage():
    tmv.init([], device="cpu")
    try:
        t = tmv.create_matrix_table(8, 4)
        server = tmv.current_zoo().server_tables[t.table_id]
        snap = server.raw
        t.add(np.ones((8, 4), np.float32))
        assert float(snap.abs().sum()) == 0.0
        assert float(server.raw.sum()) == 32.0
    finally:
        tmv.shutdown()


def test_host_requests_fuse_on_the_server():
    # Pipelined async adds and gets to one table: the server drains them
    # in batches (runtime/fusion.py) — the sums and the gets must equal
    # the serial answer.
    tmv.init([], device="cpu")
    try:
        t = tmv.create_matrix_table(16, 8)
        mids = [t.add_rows_async(np.array([i % 16, 3], np.int32),
                                 np.ones((2, 8), np.float32))
                for i in range(64)]
        for mid in mids:
            t.wait(mid)
        want = np.zeros((16, 8), np.float32)
        for i in range(64):
            want[i % 16] += 1
            want[3] += 1
        np.testing.assert_array_equal(t.get(), want)
        np.testing.assert_array_equal(t.get_rows([3, 0, 3]),
                                      want[[3, 0, 3]])
    finally:
        tmv.shutdown()


@pytest.mark.parametrize("argv", [["-serving_port=1"], ["-machine_file=m.txt"],
                                  ["-snapshot_interval_s=1"],
                                  ["-ps_role=worker"],
                                  ["-autotune_interval_s=1"]])
def test_unported_flags_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmv.init(argv, device="cpu")


def test_metrics_port_names_its_roadmap_item():
    # -metrics_interval_s is ported (runtime/metrics.py); the scrape
    # endpoint behind -metrics_port is ROADMAP A12.
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        tmv.init(["-metrics_port=1"], device="cpu")
