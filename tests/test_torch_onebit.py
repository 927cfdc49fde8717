"""``-one_bit_push``: 1-bit quantized matrix Adds with worker-side error
feedback, the port against the JAX package.

The reference's ``tests/test_tables.py`` ``TestOneBitPush`` cases run on
both packages on the CPU with the same call sequence: the partitioned
wire blobs, every Get and the worker's residual (the table-shaped error
feedback buffer) must be the same bytes. Row pushes, two servers (the
whole-table arm slices the residual per server, the row arm gathers it
per row), the caller's unique-ids CHECK, device deltas (full precision,
never quantized) and the tables the flag leaves alone (sparse, not
float32) run too, and the host-buffer arm of ``PSWord2Vec`` trains
through 1-bit pushes.
"""

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.core.blob import Blob as JBlob
from multiverso_tpu.core.message import MsgType as JMsgType
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu.tables import matrix_table as jmt
from multiverso_tpu.util import configure as jconfigure
from multiverso_tpu_torch.core.blob import Blob as TBlob
from multiverso_tpu_torch.core.message import MsgType as TMsgType
from multiverso_tpu_torch.runtime.cluster import LocalCluster
from multiverso_tpu_torch.tables import matrix_table as tmt
from multiverso_tpu_torch.util import configure as tconfigure

TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _reset_port_flags():
    yield
    tconfigure.reset_flags()


def _pkgs():
    return ((jmv, jconfigure, JBlob, JMsgType),
            (tmv, tconfigure, TBlob, TMsgType))


def run_both(body, argv=("-one_bit_push=true",)):
    """``body(mv, Blob, MsgType)`` under each package's own zoo."""
    out = []
    for mv, configure, blob, msg_type in _pkgs():
        if mv is jmv:
            mv.init(list(argv))
        else:
            mv.init(list(argv), device="cpu")
        try:
            out.append(body(mv, blob, msg_type))
        finally:
            mv.shutdown()
            configure.reset_flags()
    return out


def assert_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _ramp(rows, cols):
    return np.linspace(-1.0, 1.0, rows * cols,
                       dtype=np.float32).reshape(rows, cols)


def test_wire_shrinks():
    """tests/test_tables.py:684: the whole-table partition of a 16 x 64
    delta is sign bits plus a small meta blob, the same bytes in both
    packages."""
    delta = _ramp(16, 64)

    def body(mv, Blob, MsgType):
        table = mv.create_matrix_table(16, 64)
        shards = table.partition(
            [Blob(np.array([-1], np.int32).view(np.uint8)),
             Blob(delta.reshape(-1))], MsgType.Request_Add)
        return [[b.as_array(np.uint8).copy() for b in shard[1:]]
                for _, shard in sorted(shards.items())], \
            table._residual.copy()

    (want, want_res), (got, got_res) = run_both(body)
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):
        assert_bits(g, w, "wire blob")
    assert sum(b.size for b in got[0]) < delta.nbytes / 8
    assert_bits(got_res, want_res, "residual")


def test_error_feedback_bounds_drift():
    """tests/test_tables.py:700: 40 whole-table pushes of one delta; the
    Gets after 1, 10 and 40 pushes and the residual are the same bits,
    one push is lossy and the feedback keeps the error bounded."""
    delta = _ramp(16, 64)

    def body(mv, Blob, MsgType):
        table = mv.create_matrix_table(16, 64)
        gets = []
        for step in range(40):
            table.add(delta)
            if step in (0, 9, 39):
                gets.append(table.get().copy())
        return gets, table._residual.copy()

    (want, want_res), (got, got_res) = run_both(body)
    for g, w in zip(got, want):
        assert_bits(g, w, "get")
    assert_bits(got_res, want_res, "residual")
    assert not np.allclose(got[0], delta, atol=1e-3)
    err10 = np.abs(got[1] - 10 * delta).max()
    err40 = np.abs(got[2] - 40 * delta).max()
    assert err40 < 2.5 * err10 and err40 / 40 < err10 / 10


def test_row_pushes_match_reference():
    """Row pushes of unique random rows (the row arm gathers and writes
    back the residual by row): every Get and the residual."""
    def body(mv, Blob, MsgType):
        rng = np.random.default_rng(5)
        table = mv.create_matrix_table(40, 12)
        gets = []
        for _ in range(12):
            rows = np.unique(rng.integers(0, 40, size=9)).astype(np.int32)
            table.add_rows(rows, rng.normal(size=(rows.size, 12))
                           .astype(np.float32))
            gets.append(table.get_rows(np.arange(40, dtype=np.int32))
                        .copy())
        return gets, table._residual.copy()

    (want, want_res), (got, got_res) = run_both(body)
    for g, w in zip(got, want):
        assert_bits(g, w, "get")
    assert_bits(got_res, want_res, "residual")
    assert np.abs(got_res).max() > 0


def test_repeated_row_ids_refused():
    def body(mv, Blob, MsgType):
        table = mv.create_matrix_table(8, 4)
        try:
            table.add_rows(np.array([1, 1], np.int32),
                           np.ones((2, 4), np.float32))
        except Exception as exc:  # noqa: BLE001 - the CHECK's text
            return "unique row ids" in str(exc)
        return False

    assert run_both(body) == [True, True]


def test_onebit_codec_matches_reference():
    rng = np.random.default_rng(3)
    chunk = rng.normal(size=777).astype(np.float32)
    chunk[::7] = 0.0
    jb, jres = jmt._onebit_blobs(chunk)
    tb, tres = tmt._onebit_blobs(chunk)
    for g, w in zip(tb, jb):
        assert_bits(g.as_array(np.uint8), w.as_array(np.uint8), "blob")
    assert_bits(tres, jres, "residual")
    assert_bits(tmt._onebit_decode(*tb), jmt._onebit_decode(*jb),
                "decode")


@pytest.mark.parametrize("whole", [True, False])
def test_two_servers_match_reference(whole):
    """Two ranks, each a worker and a server: the whole-table arm cuts
    the delta and the residual per server's row range, the row arm
    buckets rows by server. Every rank's Gets and residual."""
    def body(mv, rank):
        rng = np.random.default_rng(11 + rank)
        table = mv.create_matrix_table(10, 6)
        zoo = mv.current_zoo()
        gets = []
        for _ in range(4):
            for turn in range(2):  # one rank's adds at a time: the
                if rank == turn:  # servers' sums keep one order
                    if whole:
                        table.add(rng.normal(size=(10, 6))
                                  .astype(np.float32))
                    else:
                        rows = np.unique(rng.integers(0, 10, size=5)) \
                            .astype(np.int32)
                        table.add_rows(rows, rng.normal(
                            size=(rows.size, 6)).astype(np.float32))
                zoo.barrier()
            gets.append(table.get().copy())
            zoo.barrier()
        return gets, table._residual.copy()

    argv = ["-one_bit_push=true", "-server_fuse_max=1"]
    cluster = JCluster(2, argv=argv)
    cluster.timeout = TIMEOUT
    try:
        want = cluster.run(lambda r: body(jmv, r))
    finally:
        jconfigure.reset_flags()
    cluster = LocalCluster(2, argv=argv, device="cpu")
    cluster.timeout = TIMEOUT
    got = cluster.run(lambda r: body(tmv, r))
    for (g_gets, g_res), (w_gets, w_res) in zip(got, want):
        for g, w in zip(g_gets, w_gets):
            assert_bits(g, w, "get")
        assert_bits(g_res, w_res, "residual")


def test_device_deltas_stay_full_precision():
    """A device delta takes the 3-blob layout: applied exactly, no
    residual made."""
    delta = _ramp(8, 16)
    tmv.init(["-one_bit_push=true"], device="cpu")
    try:
        table = tmv.create_matrix_table(8, 16)
        table.add(torch.from_numpy(delta))
        table.add_rows(np.array([2, 5], np.int32),
                       torch.from_numpy(delta[:2].copy()))
        want = delta.copy()
        want[[2, 5]] += delta[:2]
        np.testing.assert_array_equal(table.get(), want)
        assert table._residual is None
    finally:
        tmv.shutdown()


def test_flag_leaves_other_tables_alone():
    def body(mv, Blob, MsgType):
        sparse = mv.create_matrix_table(8, 4, is_sparse=True)
        wide = mv.create_matrix_table(8, 4, dtype=np.float64)
        dense = mv.create_matrix_table(8, 4)
        return sparse._one_bit, wide._one_bit, dense._one_bit

    assert run_both(body) == [(False, False, True)] * 2


def test_host_buffer_arm_trains_through_onebit_pushes(tmp_path):
    """``PSWord2Vec``'s host-buffer arm under ``-one_bit_push``: both
    tables' pushes quantize, the loss is finite, the output table moves
    and each table's residual holds the last pushes' error."""
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSWord2Vec, Word2VecConfig, iter_pair_batches)
    from test_torch_hostbatch import write_topic_corpus
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=120)
    d = Dictionary.build(str(path), min_count=1)
    tmv.init(["-one_bit_push=true"], device="cpu")
    try:
        model = PSWord2Vec(Word2VecConfig(
            embedding_size=8, window=2, epochs=1, negative=2, sample=0,
            batch_size=256, min_count=1), d)
        model._device_path = False
        loss, pairs = model.train_batches(iter_pair_batches(
            d, str(path), batch_size=256, window=2, subsample=0))
        assert np.isfinite(loss) and pairs > 0
        for table in (model._in_table, model._out_table):
            assert table._one_bit and table._residual is not None
            assert np.isfinite(table._residual).all()
            assert np.abs(table._residual).max() > 0
        assert np.abs(model._out_table.get()).max() > 0
    finally:
        tmv.shutdown()
