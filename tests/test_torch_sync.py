"""The BSP sync server (``-sync``) and backup workers: the port against
the JAX package.

Both packages' ``_VectorClock`` step through the same random sequences
of ``update`` and ``finish_train`` (hypothesis), and
``backup_worker_count`` reads ``-backup_worker_ratio`` alike. The same
rank bodies run on both packages' ``LocalCluster`` under ``-sync=true``:
the BSP contract (``tests/test_tables.py:619``: the i-th Get sees
exactly every worker's i-th Add), the clock tick of a failed Add on the
server and of a failed partition on the worker (``:446``, both
rounds), a KV Add that reaches one of two servers (the empty clock-tick
shard), request fusion kept off, and three workers under
``-backup_worker_ratio=34`` of which one retires early. The PS device
pipeline under ``-sync`` (``tests/test_wordembedding.py:585``) runs in
both packages with the reference's draws replayed: every block's loss
and the tables bit for bit, over the reference test's whole run and at
5 blocks an epoch. Every cluster's timeout is 30 s, so
that a gate that never opens fails instead of hanging.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.runtime import server as jserver
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu.util import configure as jconfigure
from multiverso_tpu.util import dashboard as jdashboard
from multiverso_tpu_torch.runtime import server as tserver
from multiverso_tpu_torch.runtime.cluster import LocalCluster
from multiverso_tpu_torch.util import configure as tconfigure
from multiverso_tpu_torch.util import dashboard as tdashboard

TIMEOUT = 30.0
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the PORT's role-thread count to its baseline
    and leaves both packages' flag registries at their defaults (``-sync``
    is process-wide)."""
    from multiverso_tpu_torch.runtime import thread_roles
    before = sum(thread_roles.roles_alive().values())
    yield
    tconfigure.reset_flags()
    jconfigure.reset_flags()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if sum(thread_roles.roles_alive().values()) <= before:
            break
        time.sleep(0.05)
    alive = thread_roles.roles_alive()
    assert sum(alive.values()) <= before, f"port threads leaked: {alive}"


def run_both(n, body, argv=("-sync=true",), roles=None):
    """``body(mv, rank)`` on n ranks of each package's cluster under
    ``argv``, each cluster's timeout TIMEOUT: (the reference's results,
    the port's)."""
    want_cluster = JCluster(n, argv=list(argv), roles=roles)
    want_cluster.timeout = TIMEOUT
    want = want_cluster.run(lambda r: body(jmv, r))
    jconfigure.reset_flags()
    got_cluster = LocalCluster(n, argv=list(argv), roles=roles,
                               device="cpu")
    got_cluster.timeout = TIMEOUT
    got = got_cluster.run(lambda r: body(tmv, r))
    tconfigure.reset_flags()
    return want, got


# -- the vector clock --

@st.composite
def clock_runs(draw):
    n = draw(st.integers(1, 6))
    backup = draw(st.integers(0, n - 1))
    ops = draw(st.lists(st.tuples(st.sampled_from(("update", "finish")),
                                  st.integers(0, n - 1)), max_size=60))
    return n, backup, ops


@settings(max_examples=200, deadline=None)
@given(clock_runs())
def test_vector_clocks_step_for_step(run):
    n, backup, ops = run
    want = jserver._VectorClock(n, backup)
    got = tserver._VectorClock(n, backup)
    assert got.num_backup == want.num_backup
    for kind, i in ops:
        if kind == "update":
            assert got.update(i) == want.update(i)
        else:
            assert got.finish_train(i) == want.finish_train(i)
        assert got.global_clock == want.global_clock
        assert [got.local_clock(j) for j in range(n)] \
            == [want.local_clock(j) for j in range(n)]


@pytest.mark.parametrize("n", [1, 2, 5, 10])
@pytest.mark.parametrize("ratio", [0, 0.2, 20, 50, 100, 150])
def test_backup_worker_count_matches_reference(ratio, n):
    jconfigure.set_flag("backup_worker_ratio", ratio)
    tconfigure.set_flag("backup_worker_ratio", ratio)
    assert tserver.backup_worker_count(n) == jserver.backup_worker_count(n)


def test_flags_parse():
    rest = tconfigure.parse_cmd_flags(
        ["-sync=true", "-backup_worker_ratio=20", "-metrics_interval_s=0.5",
         "-other=1"])
    assert rest == ["-other=1"]
    assert tconfigure.get_flag("sync") is True
    assert tconfigure.get_flag("backup_worker_ratio") == 20.0
    assert tconfigure.get_flag("metrics_interval_s") == 0.5


# -- BSP behaviour on both clusters --

def _bsp_contract(mv, rank):
    # tests/test_tables.py:619-633
    table = mv.create_array_table(4)
    seen = []
    for _ in range(3):
        table.add(np.full(4, 1.0, np.float32))
        out = table.get()
        seen.append(float(out[0]))
    return seen


def test_bsp_contract_matches_reference():
    want, got = run_both(2, _bsp_contract)
    assert got == want == [[2.0, 4.0, 6.0]] * 2


def _error_ticks(mv, rank):
    # tests/test_tables.py:446-485, both rounds
    from importlib import import_module
    errors = import_module(mv.__name__ + ".tables.table_interface")
    blob = import_module(mv.__name__ + ".core.blob").Blob
    table = mv.create_matrix_table(8, 2)
    failed = None
    if rank == 0:  # a wrong-sized whole-table delta fails on the server
        mid = table.add_async_raw(
            blob(np.array([-1], np.int32).view(np.uint8)),
            blob(np.ones(3, np.float32)))
        failed = False
        try:
            table.wait(mid)
        except errors.TableRequestError:
            failed = True
    else:
        table.add(np.ones((8, 2), np.float32))
    got = table.get()  # would hang without the clock tick
    if rank == 0:  # the worker's partition raises before any shard
        mid = table.add_async_raw(
            blob(np.array([-9], np.int32).view(np.uint8)),
            blob(np.ones(2, np.float32)))
        try:
            table.wait(mid)
            failed = False
        except errors.TableRequestError as exc:
            failed = failed and "partition" in str(exc)
    else:
        table.add(np.ones((8, 2), np.float32))
    got2 = table.get()  # would hang without the tick shards
    mv.current_zoo().barrier()
    return failed, float(got[0, 0]), float(got2[0, 0])


def test_sync_server_ticks_clock_on_error_matches_reference():
    want, got = run_both(2, _error_ticks)
    assert got == want
    assert got[0] == (True, 1.0, 2.0) and got[1] == (None, 1.0, 2.0)


def _kv_one_server(mv, rank):
    # Key 0 lives on one of the two servers: the other gets an empty
    # clock-tick shard, or the Get over both keys would wait forever.
    table = mv.create_kv_table()
    seen = []
    for _ in range(3):
        table.add([0], [1.0])
        got = table.get([0, 1])
        seen.append((float(got[0]), float(got.get(1, 0.0))))
    return seen, mv.current_zoo().num_servers


def test_kv_add_to_one_of_two_servers_ticks_the_other():
    want, got = run_both(2, _kv_one_server)
    assert got == want
    assert got[0] == ([(2.0, 0.0), (4.0, 0.0), (6.0, 0.0)], 2)


def _pipelined_adds(mv, rank):
    table = mv.create_matrix_table(16, 8)
    mids = [table.add_rows_async(np.array([i % 16, 3], np.int32),
                                 np.ones((2, 8), np.float32))
            for i in range(32)]
    for mid in mids:
        table.wait(mid)
    out = table.get()
    mv.current_zoo().barrier()
    return out.tolist()


def test_sync_server_never_fuses():
    jdashboard.reset_samples()
    tdashboard.reset_samples()
    want, got = run_both(2, _pipelined_adds)
    assert got == want
    expect = np.zeros((16, 8), np.float32)
    for i in range(32):
        expect[i % 16] += 2
        expect[3] += 2
    np.testing.assert_array_equal(got[0], expect)
    assert tdashboard.samples("SERVER_FUSE_BATCH").snapshot()["count"] == 0
    assert jdashboard.samples("SERVER_FUSE_BATCH").snapshot()["count"] == 0


def _backup_retires(mv, rank):
    # Worker 2 stops after 2 rounds and retires; under
    # -backup_worker_ratio=34 (one backup of three) the others finish.
    # A retired worker's clock is past every other, so it sends no more
    # table requests (the server would hold them for good).
    table = mv.create_array_table(4)
    zoo = mv.current_zoo()
    rounds = 2 if rank == 2 else 5
    for _ in range(rounds):
        table.add(np.full(4, float(rank + 1), np.float32))
        table.get()
    if rank == 2:
        zoo.finish_train()
    zoo.barrier()
    final = None if rank == 2 else float(table.get()[0])
    zoo.barrier()
    return rounds, final


def test_backup_worker_retires_early_matches_reference():
    want, got = run_both(3, _backup_retires,
                         argv=("-sync=true", "-backup_worker_ratio=34"))
    assert got == want
    total = 5 * 1.0 + 5 * 2.0 + 2 * 3.0
    assert got == [(5, total), (5, total), (2, None)]


def test_fused_add_get_dirty_refused_under_sync():
    def body(mv, rank):
        table = mv.create_matrix_table(16, 4, is_sparse=True)
        delta = np.ones((2, 4), np.float32)
        delta = torch.from_numpy(delta) if mv is tmv else jnp.asarray(delta)
        try:
            table.add_get_dirty_device(np.array([1, 2], np.int32), delta)
        except Exception as exc:  # noqa: BLE001 - the CHECK's text
            return "async-only" in str(exc)
        return False

    want, got = run_both(1, body)
    assert got == want == [True]


# -- the PS device pipeline under -sync --

from test_torch_ps_modes import JaxGroupDraws, write_topic_corpus  # noqa: E402


def _bsp_pipeline(pkg, path, max_steps=None):
    """tests/test_wordembedding.py:585-613 on ``pkg``'s cluster: two
    workers train the same corpus with the same seeds through one
    server, 2 epochs (of ``max_steps`` blocks, or whole); (per-epoch
    mean losses, per-block losses, final tables) of each worker."""
    if pkg is jmv:
        from multiverso_tpu.models.wordembedding import (
            Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
            Word2VecConfig)
        cluster = JCluster(2, argv=["-sync=true"], roles=["all", "worker"])
    else:
        from multiverso_tpu_torch.models.wordembedding import (
            Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
            Word2VecConfig)
        cluster = LocalCluster(2, argv=["-sync=true"],
                               roles=["all", "worker"], device="cpu")
    cluster.timeout = TIMEOUT
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))

    def body(rank):
        config = Word2VecConfig(embedding_size=8, window=3, epochs=2,
                                init_learning_rate=0.02, batch_size=256,
                                sample=0)
        model = PSWord2Vec(config, d)
        extra = dict(draws=JaxGroupDraws()) if pkg is tmv else {}
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=128,
                                        **extra)
        losses, blocks = [], []
        for epoch in range(2):
            loss, examples = trainer.train_epoch(
                seed=epoch, max_steps=max_steps,
                block_hook=lambda _w: blocks.append(
                    float(trainer.last_loss)))
            losses.append(loss / max(examples, 1))
        model._drain_pushes()
        pkg.current_zoo().barrier()
        tables = (model._in_table.get().copy(),
                  model._out_table.get().copy())
        pkg.current_zoo().barrier()
        return losses, blocks, tables

    try:
        return cluster.run(body)
    finally:
        (jconfigure if pkg is jmv else tconfigure).reset_flags()


def test_ps_device_pipeline_bsp_sync_matches_reference(tmp_path):
    """The reference test's whole run (2 epochs, 29 blocks each): every
    block's loss and both tables bit for bit the reference's (K4's plain
    version forms its loss and gradients in the order of the
    reference's compiled block step, ROADMAP C2), each epoch's mean at
    rtol 1e-5 / atol 1e-7, both workers converging and reading the same
    tables."""
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=300)
    want = _bsp_pipeline(jmv, path)
    got = _bsp_pipeline(tmv, path)
    for (g_losses, g_blocks, g_tables), (w_losses, w_blocks, w_tables) \
            in zip(got, want):
        assert len(g_blocks) == len(w_blocks) == 58
        assert g_blocks == w_blocks
        np.testing.assert_allclose(g_losses, w_losses, rtol=RTOL, atol=ATOL)
        assert g_losses[-1] < g_losses[0], g_losses
        for g, w in zip(g_tables, w_tables):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    for g, w in zip(got[0][2], got[1][2]):
        np.testing.assert_array_equal(g, w)


def test_ps_device_pipeline_bsp_sync_tables_match_reference(tmp_path):
    """The same two workers under -sync for 5 blocks an epoch: every
    block's loss and both tables bit for bit, the epochs' means at rtol
    1e-5 / atol 1e-7."""
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=300)
    want = _bsp_pipeline(jmv, path, max_steps=5)
    got = _bsp_pipeline(tmv, path, max_steps=5)
    for (g_losses, g_blocks, g_tables), (w_losses, w_blocks, w_tables) \
            in zip(got, want):
        assert g_blocks == w_blocks
        np.testing.assert_allclose(g_losses, w_losses, rtol=RTOL, atol=ATOL)
        for g, w in zip(g_tables, w_tables):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        assert np.abs(g_tables[1]).max() > 0
