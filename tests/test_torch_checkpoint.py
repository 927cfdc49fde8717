"""Checkpoints: the port's ``io/stream.py`` checkpoint functions against
the JAX package's.

The reference's checkpoint tests (``tests/test_io.py:110-159``) run on
the port: array, matrix and KV tables round trip; atomic writes leave no
temporary file; a torn table file, a torn manifest, a manifest covering
fewer tables than are registered, and one marked incomplete all raise
``CheckpointError`` with nothing restored; a checkpoint without a
manifest loads through the legacy path. A checkpoint written by either
package loads in the other bit for bit (the same file names, manifest
and table bytes).
"""

import json
import os
import time

import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu import io as jio
from multiverso_tpu_torch import io as tio
from multiverso_tpu_torch.io import (CheckpointError, load_checkpoint,
                                     save_checkpoint, write_bytes_atomic)


@pytest.fixture(autouse=True)
def _port_teardown_guard():
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


@pytest.fixture
def env():
    tmv.init([], device="cpu")
    yield
    tmv.shutdown()


def test_array_matrix_kv_roundtrip(env, tmp_path):
    # tests/test_io.py:80-99
    prefix = str(tmp_path / "ckpt")
    arr = tmv.create_array_table(50)
    mat = tmv.create_matrix_table(12, 4)
    kv = tmv.create_kv_table()
    arr.add(np.arange(50, dtype=np.float32))
    mat.add_rows(np.array([3], np.int32), np.ones((1, 4), np.float32))
    kv.add([9], [4.5])
    assert save_checkpoint(prefix) == 3
    arr.add(-2 * np.arange(50, dtype=np.float32))
    assert load_checkpoint(prefix) == 3
    np.testing.assert_array_equal(arr.get(), np.arange(50, dtype=np.float32))
    np.testing.assert_array_equal(mat.get_rows(np.array([3], np.int32)),
                                  np.ones((1, 4), np.float32))
    assert kv.get([9])[9] == pytest.approx(4.5)


def test_atomic_write_leaves_no_temp_debris(tmp_path):
    # tests/test_io.py:101-105
    path = tmp_path / "nested" / "obj.bin"
    write_bytes_atomic(str(path), b"payload", fsync=True)
    assert path.read_bytes() == b"payload"
    assert [p.name for p in path.parent.iterdir()] == ["obj.bin"]


def test_torn_table_file_rejected_before_any_restore(env, tmp_path):
    # tests/test_io.py:107-123
    prefix = str(tmp_path / "ckpt")
    arr = tmv.create_array_table(32)
    arr.add(np.arange(32, dtype=np.float32))
    assert save_checkpoint(prefix) == 1
    table_file = tmp_path / "ckpt.table0.rank0"
    table_file.write_bytes(table_file.read_bytes()[:-4])
    arr.add(np.ones(32, np.float32))  # post-save state to preserve
    with pytest.raises(CheckpointError, match="torn"):
        load_checkpoint(prefix)
    assert arr.get()[1] == pytest.approx(2.0)


def test_torn_manifest_rejected(env, tmp_path):
    # tests/test_io.py:125-132
    prefix = str(tmp_path / "ckpt")
    tmv.create_array_table(8).add(np.ones(8, np.float32))
    assert save_checkpoint(prefix) == 1
    manifest = tmp_path / "ckpt.manifest.rank0.json"
    manifest.write_bytes(manifest.read_bytes()[:-10])
    with pytest.raises(CheckpointError, match="torn"):
        load_checkpoint(prefix)


def test_partial_manifest_table_count_mismatch_rejected(env, tmp_path):
    # tests/test_io.py:134-144
    prefix = str(tmp_path / "ckpt")
    tmv.create_array_table(8).add(np.ones(8, np.float32))
    assert save_checkpoint(prefix) == 1
    tmv.create_kv_table()  # registered after the save
    with pytest.raises(CheckpointError, match="covers 1 tables"):
        load_checkpoint(prefix)


def test_incomplete_flag_rejected(env, tmp_path):
    # tests/test_io.py:146-155
    prefix = str(tmp_path / "ckpt")
    tmv.create_array_table(8)
    assert save_checkpoint(prefix) == 1
    manifest = tmp_path / "ckpt.manifest.rank0.json"
    doc = json.loads(manifest.read_text())
    doc["complete"] = False
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CheckpointError, match="partial"):
        load_checkpoint(prefix)


def test_legacy_checkpoint_without_manifest_still_loads(env, tmp_path):
    # tests/test_io.py:157-168
    prefix = str(tmp_path / "ckpt")
    arr = tmv.create_array_table(16)
    arr.add(np.full(16, 3.0, np.float32))
    assert save_checkpoint(prefix) == 1
    os.unlink(tmp_path / "ckpt.manifest.rank0.json")
    arr.add(np.ones(16, np.float32))
    assert load_checkpoint(prefix) == 1
    assert arr.get()[0] == pytest.approx(3.0)


def test_missing_table_file_rejected(env, tmp_path):
    prefix = str(tmp_path / "ckpt")
    tmv.create_array_table(8).add(np.ones(8, np.float32))
    assert save_checkpoint(prefix) == 1
    os.unlink(tmp_path / "ckpt.table0.rank0")
    with pytest.raises(CheckpointError, match="missing"):
        load_checkpoint(prefix)


def test_read_bytes_or_none_matches_reference(tmp_path):
    path = tmp_path / "obj.bin"
    path.write_bytes(b"abc")
    for uri in (str(path), f"file://{path}", str(tmp_path / "absent")):
        assert tio.read_bytes_or_none(uri) == jio.read_bytes_or_none(uri)


# -- cross-loading between the packages --

def _make_tables(mv, rng_seed):
    """An array, a dense and a sparse matrix and a KV table with seeded
    contents; returns the tables."""
    rng = np.random.default_rng(rng_seed)
    arr = mv.create_array_table(37)
    dense = mv.create_matrix_table(21, 5)
    sparse = mv.create_matrix_table(16, 3, is_sparse=True)
    kv = mv.create_kv_table()
    arr.add(rng.standard_normal(37).astype(np.float32))
    dense.add(rng.standard_normal((21, 5)).astype(np.float32))
    sparse.add_rows(np.array([1, 7, 15], np.int32),
                    rng.standard_normal((3, 3)).astype(np.float32))
    kv.add([3, 11], [0.25, -1.5])
    return arr, dense, sparse, kv


def _read(tables):
    arr, dense, sparse, kv = tables
    return (arr.get().copy(), dense.get().copy(),
            sparse.get_rows(np.arange(16, dtype=np.int32)).copy(),
            {int(k): float(v) for k, v in kv.get([3, 11]).items()})


def _init(mv):
    if mv is tmv:
        mv.init([], device="cpu")
    else:
        mv.init([])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_load_bit_for_bit(tmp_path, writer):
    save_pkg, load_pkg = (jmv, tmv) if writer == "reference" else (tmv, jmv)
    save_io = jio if save_pkg is jmv else tio
    load_io = tio if load_pkg is tmv else jio
    prefix = str(tmp_path / "ckpt")
    _init(save_pkg)
    try:
        saved = _read(_make_tables(save_pkg, 5))
        assert save_io.save_checkpoint(prefix) == 4
        versions = [t.version for t in save_pkg.current_zoo().server_tables]
    finally:
        save_pkg.shutdown()
    _init(load_pkg)
    try:
        tables = _make_tables(load_pkg, 6)  # other contents, overwritten
        assert load_io.load_checkpoint(prefix) == 4
        loaded = _read(tables)
        assert [t.version for t in load_pkg.current_zoo().server_tables] \
            == versions
    finally:
        load_pkg.shutdown()
    for got, want in zip(loaded[:3], saved[:3]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    assert loaded[3] == saved[3]
