"""Tables of several servers in one process: the port against the JAX
package at 2 and 4 servers.

The reference's two-rank device-key cases (``tests/test_tables.py:
514-577``: device keys broadcast to every server, host-key device rows,
the array table's device Get; ``:635-662``: the sparse ``-2`` dirty Get
across servers) run on n ranks of each package's ``LocalCluster`` and
give the same results. K15's and K16's plain versions
(``row_gather_bounded``, ``row_scatter_add_bounded`` through
``UpdateEngine.apply_rows(..., bounds=)``) are held against the
reference's ``MatrixServer._gather_bounded`` and
``UpdateEngine._bounded_rows_fn`` on every server's window, on seeded
ids with duplicates and every edge of the window rule: gathers bit for
bit, sums at rtol 1e-5 / atol 1e-7 (the order of duplicate adds). The
broadcast form of the PS device pipeline runs over two servers in every
mode, with the reference's draws replayed, at the tolerance of the
single-server parity tests.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu.tables.matrix_table import MatrixServer as JServer
from multiverso_tpu.updater import AddOption as JAddOption
from multiverso_tpu.updater.engine import UpdateEngine as JEngine
from multiverso_tpu.updater.rules import create_rule as jcreate_rule
from multiverso_tpu_torch.kernels import rows as krows
from multiverso_tpu_torch.runtime.cluster import LocalCluster
from multiverso_tpu_torch.tables.matrix_table import row_offsets
from multiverso_tpu_torch.updater import AddOption
from multiverso_tpu_torch.updater.engine import UpdateEngine
from multiverso_tpu_torch.updater.rules import create_rule

RTOL, ATOL = 1e-5, 1e-7


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


def dev(mv, a):
    """``a`` as the package's device array (CPU tensor for the port)."""
    return jnp.asarray(a) if mv is jmv else torch.from_numpy(np.asarray(a))


def host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def run_both(n, body, roles=None):
    """``body(mv, rank)`` on n ranks of each package's cluster: (the
    reference's results, the port's)."""
    want = JCluster(n, roles=roles).run(lambda r: body(jmv, r))
    got = LocalCluster(n, roles=roles, device="cpu").run(
        lambda r: body(tmv, r))
    return want, got


def _device_keys_roundtrip(mv, rank):
    # tests/test_tables.py:514-541: device keys broadcast to every
    # server; each masks foreign rows (gather fills 0, scatter drops) and
    # the worker SUMS the replies, duplicates included.
    table = mv.create_matrix_table(10, 3)
    base = np.arange(30, dtype=np.float32).reshape(10, 3)
    if rank == 0:
        table.add(base)
    mv.current_zoo().barrier()
    ids_np = np.array([[7, 1], [1, 9]], np.int32)
    ids = dev(mv, ids_np)
    got = host(table.get_rows_device(ids))
    # Every rank's Get lands before rank 0's Add (the reference test has
    # no barrier here, so a slow rank's Get could see the Add).
    mv.current_zoo().barrier()
    if rank == 0:
        table.add_rows(ids, dev(mv, np.ones((2, 2, 3), np.float32)))
    mv.current_zoo().barrier()
    after = table.get_rows(np.array([7, 1, 9, 0], np.int32))
    mv.current_zoo().barrier()
    return (got.tolist(), after.tolist(),
            bool(np.array_equal(got, base[ids_np])),
            bool(np.array_equal(host(ids), ids_np)))


def _device_rows_host_keys(mv, rank):
    # tests/test_tables.py:543-558: sorted host ids spanning the servers
    # reassemble in order.
    table = mv.create_matrix_table(10, 3)
    if rank == 0:
        table.add_rows(np.array([1, 4, 8], np.int32),
                       dev(mv, np.ones((3, 3), np.float32) * 2.0))
    mv.current_zoo().barrier()
    rows = np.array([1, 4, 8], np.int32)
    out = host(table.get_rows_device(rows))
    got = table.get_rows(rows)
    mv.current_zoo().barrier()
    return out.tolist(), got.tolist()


def _array_device_get(mv, rank):
    # tests/test_tables.py:560-573
    table = mv.create_array_table(32)
    if rank == 0:
        table.add(dev(mv, np.ones(32, np.float32)))
    mv.current_zoo().barrier()
    out = host(table.get_device())
    mv.current_zoo().barrier()
    return out.tolist()


def _sparse_dirty_device(mv, rank):
    # tests/test_tables.py:635-662: per-server dirty sets concatenate
    # globally sorted; a server with zero dirty rows contributes an empty
    # segment, attributed by the server-id blob.
    option = JAddOption if mv is jmv else AddOption
    table = mv.create_matrix_table(16, 4, is_sparse=True)
    zoo = mv.current_zoo()
    ids0, vals0 = table.get_dirty_device()
    ok0 = ids0.size == 16 and tuple(vals0.shape) == (16, 4)
    zoo.barrier()
    rows = np.array([2, 9, 13], np.int32)
    if rank == 0:
        table.add_rows(rows, dev(mv, np.ones((3, 4), np.float32)),
                       option=option(worker_id=0))
    zoo.barrier()
    ids, vals = table.get_dirty_device()
    zoo.barrier()
    return ok0, ids.tolist(), float(host(vals).sum())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("body", [_device_keys_roundtrip,
                                  _device_rows_host_keys,
                                  _array_device_get, _sparse_dirty_device])
def test_multi_server_tables_match_reference(n, body):
    want, got = run_both(n, body)
    assert got == want
    if body is _device_keys_roundtrip:
        assert all(r[2] and r[3] for r in got)   # exact, ids untouched
    if body is _sparse_dirty_device:
        # The adder's own flags stay clean; every other worker sees the
        # dirty rows of every server, in global order.
        assert got[0] == (True, [], 0.0)
        assert got[1:] == [(True, [2, 9, 13], 12.0)] * (n - 1)


# -- K15 and K16 against the reference's bounded programs --

R_TOTAL, S_STORE, N_COL = 37, 8, 5


def _windows(n_servers):
    offs = row_offsets(R_TOTAL, n_servers)
    return [(offs[s], offs[s + 1] - offs[s]) for s in range(len(offs) - 1)]


def _edge_ids(seed, ofs, n):
    """Seeded ids over the whole table and past it (duplicates among
    them), with every edge of the window rule of server ``[ofs, ofs+n)``:
    ofs-1, ofs, ofs+n-1, ofs+n, -1, -R, the pad sentinel R, ids past it
    and the int32 extremes. Shape [7, 9]."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-R_TOTAL - 3, R_TOTAL + 6, 63).astype(np.int32)
    ids[10:20] = ids[0]   # a duplicated id
    ids[20:32] = [ofs - 1, ofs, ofs + n - 1, ofs + n, -1, -R_TOTAL,
                  R_TOTAL, R_TOTAL + 1, 2 ** 30, -2 ** 31, 2 ** 31 - 1,
                  ofs]
    return ids.reshape(7, 9)


@pytest.mark.parametrize("n_servers", [2, 4])
def test_bounded_gather_matches_reference(n_servers):
    rng = np.random.default_rng(5)
    for sid, (ofs, n) in enumerate(_windows(n_servers)):
        padded = n + 3
        data = rng.standard_normal((padded, S_STORE)).astype(np.float32)
        ids = _edge_ids(sid, ofs, n)
        ref = object.__new__(JServer)
        ref.row_offset, ref.my_rows, ref.num_col = ofs, n, N_COL
        ref._data = jnp.asarray(data)
        want = np.asarray(ref._gather_bounded(ref._data, jnp.asarray(ids)))
        ids_t = torch.from_numpy(ids.copy())
        got = krows.row_gather_bounded(torch.from_numpy(data), ids_t, ofs,
                                       n, N_COL)
        assert got.shape == ids.shape + (N_COL,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ids_t.numpy(), ids)   # not written


@pytest.mark.parametrize("rule", ["default", "sgd"])
@pytest.mark.parametrize("n_servers", [2, 4])
def test_bounded_scatter_matches_reference(n_servers, rule):
    rng = np.random.default_rng(6)
    option = dict(worker_id=0, learning_rate=0.1)
    for sid, (ofs, n) in enumerate(_windows(n_servers)):
        padded = n + 3
        data = rng.standard_normal((padded, S_STORE)).astype(np.float32)
        ids = _edge_ids(10 + sid, ofs, n)
        delta = rng.standard_normal(ids.shape + (N_COL,)).astype(np.float32)
        jeng = JEngine(jcreate_rule(rule, np.float32), data.shape,
                       np.float32, 1)
        want = np.asarray(jeng.apply_rows(
            jnp.asarray(data), jnp.asarray(ids), jnp.asarray(delta),
            JAddOption(**option), bounds=(ofs, n)))
        teng = UpdateEngine(create_rule(rule, np.float32), data.shape,
                            np.float32, 1, torch.device("cpu"))
        ids_t, delta_t = torch.from_numpy(ids.copy()), \
            torch.from_numpy(delta.copy())
        got = teng.apply_rows(torch.from_numpy(data.copy()), ids_t, delta_t,
                              AddOption(**option), bounds=(ofs, n))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        # Broadcast by reference: the shared ids and deltas stay as sent.
        np.testing.assert_array_equal(ids_t.numpy(), ids)
        np.testing.assert_array_equal(delta_t.numpy(), delta)
        # Rows outside the window's reach and the padding stay as they
        # were.
        np.testing.assert_array_equal(got.numpy()[n:], data[n:])


def test_bounded_add_needs_a_stateless_rule():
    eng = UpdateEngine(create_rule("adagrad", np.float32), (8, 4),
                       np.float32, 1, torch.device("cpu"))
    with pytest.raises(Exception, match="stateless"):
        eng.apply_rows(torch.zeros(8, 4), torch.zeros(3, dtype=torch.int32),
                       torch.ones(3, 4), AddOption(worker_id=0),
                       bounds=(0, 8))


# -- the broadcast PS device pipeline over two servers, every mode --

from test_torch_ps_modes import JaxGroupDraws  # noqa: E402
from test_torch_ps_modes import _config, write_topic_corpus  # noqa: E402

# mode: (config flags, centers a block, blocks a dispatch, blocks run)
MODES = {
    "sgns": (dict(neg_block=8), 128, 1, 3),
    "cbow": (dict(cbow=True, neg_block=8), 128, 1, 3),
    "hs_sg": (dict(hs=True, negative=0), 128, 1, 3),
    "hs_cbow": (dict(hs=True, cbow=True, negative=0), 128, 1, 3),
    "per_pair": (dict(per_pair=True), 64, 1, 3),
    "sgns_g2": (dict(neg_block=8), 128, 2, 4),
}


def ps_cluster_run(pkg, path, flags, C, G, blocks, seed, segment=False):
    """The PS device pipeline on ``LocalCluster(2, roles=["all",
    "server"])`` of package ``pkg`` (the port replays the reference's
    draws): (initial tables, per-dispatch losses, loss, examples, final
    tables, words) from rank 0."""
    if pkg is jmv:
        from multiverso_tpu.models.wordembedding import (
            Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
            Word2VecConfig)
        cluster, extra = JCluster(2, roles=["all", "server"]), {}
    else:
        from multiverso_tpu_torch.models.wordembedding import (
            Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
            Word2VecConfig)
        cluster = LocalCluster(2, roles=["all", "server"], device="cpu")
        extra = dict(draws=JaxGroupDraws())
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))

    def body(rank):
        model = PSWord2Vec(_config(Word2VecConfig, flags), d)
        if rank == 1:   # the server-only rank mirrors the epoch barrier
            pkg.current_zoo().barrier()
            return None
        assert model._in_table._num_server == 2
        init = (model._in_table.get().copy(), model._out_table.get().copy())
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=C,
                                        blocks_per_dispatch=G,
                                        segment_keys=segment, **extra)
        losses = []
        loss, examples = trainer.train_epoch(
            seed=seed, max_steps=blocks,
            block_hook=lambda _w: losses.append(float(trainer.last_loss)))
        model._drain_pushes()
        assert (trainer._seg_ids is not None) == segment
        return (init, losses, loss, examples,
                (model._in_table.get().copy(),
                 model._out_table.get().copy()), model.trained_words)

    return cluster.run(body)[0]


def assert_runs_match(got, want, rtol=RTOL, atol=ATOL):
    (g_init, g_losses, g_loss, g_ex, g_tables, g_words) = got
    (w_init, w_losses, w_loss, w_ex, w_tables, w_words) = want
    for g, w in zip(g_init, w_init):
        np.testing.assert_array_equal(g, w)   # the same random init
    assert len(g_losses) == len(w_losses)
    np.testing.assert_allclose(g_losses, w_losses, rtol=rtol, atol=atol)
    np.testing.assert_allclose(g_loss, w_loss, rtol=rtol)
    assert g_ex == w_ex > 0
    assert g_words == w_words
    for g, w in zip(g_tables, w_tables):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    assert np.abs(g_tables[1]).max() > 0   # the blocks really trained


@pytest.mark.parametrize("mode", list(MODES))
def test_broadcast_ps_pipeline_two_servers_matches_reference(tmp_path,
                                                             mode):
    flags, C, G, blocks = MODES[mode]
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    want = ps_cluster_run(jmv, path, flags, C, G, blocks, seed=3)
    got = ps_cluster_run(tmv, path, flags, C, G, blocks, seed=3)
    assert_runs_match(got, want)
