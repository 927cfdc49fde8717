"""The client cache (``-max_get_staleness``, ``-client_cache_rows``): the
port against the JAX package.

Every case of the reference's ``tests/test_client_cache.py`` runs the
same call sequence on both packages on the CPU, each under its own
``init`` (or ``LocalCluster``): the Gets' bytes, the tables, the caches'
hit and miss counts, the bound property ``latest - version <= bound``
of every served row (the caches' ``on_hit`` hook) and the dashboard's
``CLIENT_CACHE_*`` and ``SERVER_PROCESS_GET`` counts must be the same.
Where a count depends on whether a prefetch's reply landed before the
Get that joins it, the race-free sums are compared instead (a Get hits
or joins: ``HIT + JOIN`` and ``MISS - JOIN`` do not depend on it). The
BSP force-disable and the two-rank cases run too.

``PSWord2Vec``'s host-buffer arm (``_device_path = False``, the arm of
a worker whose servers are in another process): with the cache off its
tables equal the device arm's bit for bit (the same pulls, steps and
adds, only through host buffers), and its loss and tables match the
reference's forced host arm at rtol 1e-5 / atol 1e-7, the tolerance of
the host-batch PS tests (``tests/test_torch_hostbatch.py``: float32
sums in another order); with the cache and prefetch on, both packages
prefetch and their losses agree within rtol 1e-4 (timing decides
which batch's push a joined Get's remaining rows see; the case's
docstring).
"""

import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.core.blob import Blob as JBlob
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu.tables import client_cache as jcc
from multiverso_tpu.tables import table_interface as jti
from multiverso_tpu.util import configure as jconfigure
from multiverso_tpu.util import dashboard as jdashboard
from multiverso_tpu_torch.core.blob import Blob as TBlob
from multiverso_tpu_torch.runtime.cluster import LocalCluster
from multiverso_tpu_torch.tables import client_cache as tcc
from multiverso_tpu_torch.tables import table_interface as tti
from multiverso_tpu_torch.util import configure as tconfigure
from multiverso_tpu_torch.util import dashboard as tdashboard

RTOL, ATOL = 1e-5, 1e-7
TIMEOUT = 30.0
COUNTERS = ("CLIENT_CACHE_HIT", "CLIENT_CACHE_MISS", "CLIENT_CACHE_JOIN",
            "CLIENT_CACHE_PREFETCH", "SERVER_PROCESS_GET")


class Pkg:
    """One package's handles, so a scenario body is written once."""

    def __init__(self, mv, configure, dashboard, cc, ti, blob):
        self.mv, self.configure, self.dashboard = mv, configure, dashboard
        self.cc, self.ti, self.Blob = cc, ti, blob

    def init(self, argv=()):
        if self.mv is jmv:
            self.mv.init(list(argv))
        else:
            self.mv.init(list(argv), device="cpu")

    def counts(self):
        return {n: self.dashboard.Dashboard.get(n).count for n in COUNTERS}


JAX = Pkg(jmv, jconfigure, jdashboard, jcc, jti, JBlob)
PORT = Pkg(tmv, tconfigure, tdashboard, tcc, tti, TBlob)


@pytest.fixture(autouse=True)
def _reset_port_flags():
    yield
    tconfigure.reset_flags()


def _delta(before, after):
    return {n: after[n] - before[n] for n in COUNTERS}


def run_one(pkg, body, argv=(), bound=None):
    """``body(pkg)`` under ``pkg``'s own zoo (``-max_get_staleness`` set
    to ``bound`` after init, as the reference's ``cache_env`` does):
    (its result, the dashboard counts it moved)."""
    before = pkg.counts()
    pkg.init(argv)
    try:
        if bound is not None:
            pkg.configure.set_flag("max_get_staleness", bound)
        out = body(pkg)
    finally:
        pkg.mv.shutdown()
        pkg.configure.reset_flags()
    return out, _delta(before, pkg.counts())


def run_both(body, argv=(), bound=None):
    return run_one(JAX, body, argv, bound), run_one(PORT, body, argv, bound)


def cluster_both(n, body, argv):
    """``body(pkg, rank)`` on n ranks of each package's cluster, server
    request fusion off (a fused group of Gets counts once, and which
    Gets meet in a group is a matter of timing)."""
    argv = list(argv) + ["-server_fuse_max=1"]
    out = []
    for pkg in (JAX, PORT):
        before = pkg.counts()
        if pkg is JAX:
            cluster = JCluster(n, argv=list(argv))
        else:
            cluster = LocalCluster(n, argv=list(argv), device="cpu")
        cluster.timeout = TIMEOUT
        try:
            res = cluster.run(lambda r, pkg=pkg: body(pkg, r))
        finally:
            pkg.configure.reset_flags()
        out.append((res, _delta(before, pkg.counts())))
    return out


def assert_same(got, want, path="result"):
    """Equal structure; arrays equal bit for bit (dtype and shape too)."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def check_both(body, argv=(), bound=None):
    (want, wc), (got, gc) = run_both(body, argv, bound)
    assert_same(got, want)
    assert gc == wc, (gc, wc)
    return got, gc


def _stats(table):
    cache = table._row_cache
    return (cache.hits, cache.misses, cache.rows_hit, cache.rows_missed)


# -- disabled by default --

def test_no_cache_objects_without_flag():
    def body(pkg):
        matrix = pkg.mv.create_matrix_table(16, 4)
        array = pkg.mv.create_array_table(16)
        kv = pkg.mv.create_kv_table()
        return (matrix._row_cache is not None, matrix._row_cache.active,
                matrix._live_cache() is None, array._blob_cache is None,
                kv._snap_cache is None)

    got, _ = check_both(body)
    assert got == (True, False, True, True, True)


def test_every_get_takes_the_wire():
    def body(pkg):
        table = pkg.mv.create_matrix_table(16, 4)
        table.add(np.ones((16, 4), np.float32))
        ids = np.array([1, 2], np.int32)
        return [table.get_rows(ids).copy(), table.get_rows(ids).copy()]

    _, counts = check_both(body)
    assert counts["SERVER_PROCESS_GET"] == 2


def test_prefetch_is_a_noop_when_disabled():
    def body(pkg):
        table = pkg.mv.create_matrix_table(16, 4)
        mid = table.prefetch_rows_async(np.array([1, 2], np.int32))
        return table.wait(mid, timeout=10)

    got, counts = check_both(body)
    assert got is True and counts["SERVER_PROCESS_GET"] == 0


def test_sync_mode_force_disables():
    def body(pkg):
        table = pkg.mv.create_matrix_table(8, 2)
        table.add(np.ones((8, 2), np.float32))
        return (table._row_cache is None,
                table.get_rows(np.array([3], np.int32)).copy(),
                table.prefetch_rows_async(np.array([3], np.int32)) > 0)

    got, counts = check_both(body, argv=["-sync=true",
                                         "-max_get_staleness=8"])
    assert got[0] is True
    np.testing.assert_array_equal(got[1], np.ones((1, 2)))
    assert counts["CLIENT_CACHE_PREFETCH"] == 0


# -- the row cache --

def test_repeat_get_hits_locally():
    def body(pkg):
        table = pkg.mv.create_matrix_table(32, 4)
        base = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
        table.add(base)
        ids = np.array([1, 5, 5, 31], np.int32)
        return [table.get_rows(ids).copy(), table.get_rows(ids).copy(),
                _stats(table), table._row_cache.stats]

    got, counts = check_both(body, bound=4)
    assert counts["SERVER_PROCESS_GET"] == 1 and got[2][0] == 1


def test_versions_ride_replies():
    def body(pkg):
        table = pkg.mv.create_matrix_table(8, 2)
        for _ in range(3):
            table.add(np.ones((8, 2), np.float32))
        acked = table._version_tracker.latest(0)
        table.get_rows(np.array([0], np.int32))
        return (acked, table._version_tracker.latest(0),
                table.observed_versions(), table.add_floor(0),
                table.cache_generation())

    got, _ = check_both(body, bound=4)
    assert got[:2] == (3, 3)


def test_read_your_writes():
    def body(pkg):
        table = pkg.mv.create_matrix_table(16, 4)
        base = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
        table.add(base)
        ids = np.array([2, 7], np.int32)
        first = table.get_rows(ids).copy()
        table.add_rows(np.array([7], np.int32), np.ones((1, 4), np.float32))
        return [first, table.get_rows(ids).copy(), _stats(table)]

    got, _ = check_both(body, bound=4)
    base = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    np.testing.assert_array_equal(got[1][1], base[7] + 1.0)


def test_whole_table_add_invalidates():
    def body(pkg):
        table = pkg.mv.create_matrix_table(8, 2)
        ids = np.array([1, 3], np.int32)
        first = table.get_rows(ids).copy()
        table.add(np.full((8, 2), 5.0, np.float32))
        return [first, table.get_rows(ids).copy(), _stats(table)]

    got, _ = check_both(body, bound=4)
    np.testing.assert_array_equal(got[1], np.full((2, 2), 5.0))


def test_staleness_bound_property():
    """The reference's randomized add/get interleaving against a shadow
    model: every Get, every served row's (row, version, latest, bound)
    and the cache's counts are the same in both packages, and every
    served row keeps ``version >= latest - bound``."""
    def body(pkg):
        rng = np.random.default_rng(17)
        table = pkg.mv.create_matrix_table(24, 3)
        served = []
        table._row_cache.on_hit = \
            lambda *hit: served.append(tuple(int(v) for v in hit))
        shadow = np.zeros((24, 3), np.float32)
        gets = []
        for _ in range(80):
            if rng.random() < 0.4:
                rows = np.unique(rng.integers(0, 24, size=3)) \
                    .astype(np.int32)
                delta = rng.normal(size=(rows.size, 3)).astype(np.float32)
                table.add_rows(rows, delta)
                shadow[rows] += delta
            else:
                rows = np.unique(rng.integers(0, 24, size=4)) \
                    .astype(np.int32)
                gets.append(table.get_rows(rows).copy())
        return [gets, served, _stats(table), table._row_cache.bound]

    got, _ = check_both(body, bound=4)
    gets, served, stats, bound = got
    assert served and stats[0] > 0
    assert all(v >= latest - k for _, v, latest, k in served)
    assert bound == 4


def test_capacity_eviction():
    def body(pkg):
        table = pkg.mv.create_matrix_table(64, 2)
        table._row_cache = pkg.cc.RowCache(
            4, table._row_cache._server_of, 1,
            table._version_tracker, capacity=8)
        table.add(np.ones((64, 2), np.float32))
        gets = [table.get_rows(np.arange(lo, lo + 8, dtype=np.int32)).copy()
                for lo in range(0, 64, 8)]
        return [gets, table._row_cache.versions_of(np.arange(64))]

    got, _ = check_both(body, bound=4)
    assert len(got[1]) <= 8


def test_client_cache_rows_flag_sets_the_capacity():
    """``-client_cache_rows`` (defined beside the cache, as in the
    reference) caps a table's row cache from the command line."""
    def body(pkg):
        table = pkg.mv.create_matrix_table(64, 2)
        table.add(np.ones((64, 2), np.float32))
        for lo in range(0, 64, 8):
            table.get_rows(np.arange(lo, lo + 8, dtype=np.int32))
        return [table._row_cache._capacity,
                table._row_cache.versions_of(np.arange(64))]

    got, _ = check_both(body, argv=["-max_get_staleness=4",
                                    "-client_cache_rows=16"])
    assert got[0] == 16 and len(got[1]) == 16


# -- prefetch and in-flight dedup --

def test_prefetch_then_get_is_local():
    def body(pkg):
        table = pkg.mv.create_matrix_table(32, 4)
        base = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
        table.add(base)
        ids = np.array([3, 9], np.int32)
        ok = table.wait(table.prefetch_rows_async(ids), timeout=10)
        return [ok, table.get_rows(ids).copy(), _stats(table)]

    got, counts = check_both(body, bound=4)
    assert counts["SERVER_PROCESS_GET"] == 1
    assert counts["CLIENT_CACHE_PREFETCH"] == 1


def _racy_counts(counts):
    """The counts of a Get issued while its prefetch may be in flight,
    in the form that does not depend on whether the reply landed first
    (a Get either hits, or misses and joins)."""
    return (counts["CLIENT_CACHE_HIT"] + counts["CLIENT_CACHE_JOIN"],
            counts["CLIENT_CACHE_MISS"] - counts["CLIENT_CACHE_JOIN"],
            counts["CLIENT_CACHE_PREFETCH"], counts["SERVER_PROCESS_GET"])


def test_inflight_dedup_single_wire_get():
    def body(pkg):
        table = pkg.mv.create_matrix_table(32, 4)
        base = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
        table.add(base)
        ids = np.array([4, 11], np.int32)
        table.prefetch_rows_async(ids)  # not waited: maybe in flight
        return table.get_rows(ids).copy()

    (want, wc), (got, gc) = run_both(body, bound=4)
    assert_same(got, want)
    assert _racy_counts(gc) == _racy_counts(wc) == (1, 0, 1, 1)


def test_duplicate_prefetches_dedup():
    def body(pkg):
        table = pkg.mv.create_matrix_table(32, 4)
        table.add(np.ones((32, 4), np.float32))
        ids = np.array([6, 13], np.int32)
        mids = {table.prefetch_rows_async(ids) for _ in range(4)}
        return all(table.wait(mid, timeout=10) for mid in mids)

    got, counts = check_both(body, bound=4)
    assert got is True
    assert counts["SERVER_PROCESS_GET"] == 1
    assert counts["CLIENT_CACHE_PREFETCH"] == 1


def test_joined_get_falls_back_after_invalidation():
    """A Get joined onto a prefetch whose rows an own add invalidates
    before completion is forwarded to the server (never hangs, never
    serves the pre-add row)."""
    def body(pkg):
        table = pkg.mv.create_matrix_table(16, 2)
        table.add(np.ones((16, 2), np.float32))
        ids = np.array([5], np.int32)
        table.wait(table.prefetch_rows_async(ids), timeout=10)
        out = np.empty((1, 2), np.float32)
        mid = table._new_request()
        table._dest, table._dest_rows = out, ids
        table._device_shards = None
        table._pf_rows[99] = ids
        table._pf_joined[99] = [(mid, ids, out)]
        tok = table._row_cache.begin_add(ids)
        table._on_prefetch_done(99)
        table._row_cache.finish_add(tok)
        return [table.wait(mid, timeout=10), out.copy(), _stats(table)]

    got, _ = check_both(body, bound=4)
    assert got[0] is True
    np.testing.assert_array_equal(got[1], np.ones((1, 2)))


# -- the array and KV caches --

def test_array_blob_cache_roundtrip():
    def body(pkg):
        table = pkg.mv.create_array_table(64)
        table.add(np.ones(64, np.float32))
        first = table.get().copy()
        hit = table.get().copy()
        table.add(np.ones(64, np.float32))
        return [first, hit, table.get().copy(),
                (table._blob_cache.hits, table._blob_cache.misses)]

    got, counts = check_both(body, bound=4)
    np.testing.assert_array_equal(got[2], 2 * np.ones(64, np.float32))
    assert counts["SERVER_PROCESS_GET"] == 2


def test_array_prefetch():
    def body(pkg):
        table = pkg.mv.create_array_table(32)
        table.add(np.full(32, 3.0, np.float32))
        ok = table.wait(table.prefetch_async(), timeout=10)
        return [ok, table.get().copy(),
                (table._blob_cache.hits, table._blob_cache.misses)]

    got, counts = check_both(body, bound=4)
    assert got[0] is True and counts["SERVER_PROCESS_GET"] == 1


def test_kv_snapshot_cache():
    def body(pkg):
        table = pkg.mv.create_kv_table()
        table.add([1, 9], [1.0, 2.0])
        first = dict(table.get([1, 9]))
        second = dict(table.get([1, 9]))
        table.add([1], [10.0])
        third = dict(table.get([1, 9]))
        return [first, second, third,
                (table._snap_cache.hits, table._snap_cache.misses)]

    got, counts = check_both(body, bound=4)
    assert got[2][1] == pytest.approx(11.0)
    assert counts["SERVER_PROCESS_GET"] == 2


# -- two ranks --

def test_two_servers_cache_correctness():
    def body(pkg, rank):
        mv = pkg.mv
        table = mv.create_matrix_table(10, 3)
        zoo = mv.current_zoo()
        base = np.arange(30, dtype=np.float32).reshape(10, 3)
        if rank == 0:
            table.add(base)
        zoo.barrier()
        ids = np.array([1, 8], np.int32)  # one row a server
        first = table.get_rows(ids).copy()
        hit = table.get_rows(ids).copy()
        zoo.barrier()
        own = None
        if rank == 1:
            table.add_rows(ids, np.ones((2, 3), np.float32))
            own = table.get_rows(ids).copy()
        zoo.barrier()
        return [first, hit, own, _stats(table)]

    (want, wc), (got, gc) = cluster_both(2, body, ["-max_get_staleness=4"])
    assert_same(got, want)
    assert gc == wc
    base = np.arange(30, dtype=np.float32).reshape(10, 3)
    np.testing.assert_array_equal(got[1][2], base[[1, 8]] + 1.0)
    assert all(r[3][0] >= 1 for r in got)


def test_bounded_staleness_under_peer_writes():
    def body(pkg, rank):
        mv = pkg.mv
        table = mv.create_matrix_table(8, 2)
        zoo = mv.current_zoo()
        ids = np.array([2], np.int32)
        if rank == 0:
            table.get_rows(ids)  # cached at version 0
        zoo.barrier()
        if rank == 1:
            for _ in range(2):
                table.add_rows(ids, np.ones((1, 2), np.float32))
        zoo.barrier()
        if rank == 0:
            # The newer version observed through another row of the
            # same shard: the entry, 2 versions behind bound 1, refetches.
            table.get_rows(np.array([3], np.int32))
            return [table.get_rows(ids).copy(), _stats(table)]
        return None

    (want, wc), (got, gc) = cluster_both(2, body, ["-max_get_staleness=1"])
    assert_same(got, want)
    assert gc == wc
    np.testing.assert_array_equal(got[0][0], [[2.0, 2.0]])


# -- error reaping --

def test_fire_and_forget_failures_bounded():
    def body(pkg):
        table = pkg.mv.create_matrix_table(8, 2)
        cap = pkg.ti._MAX_RETAINED_ERRORS
        for _ in range(cap + 60):
            table.get_async_raw(
                pkg.Blob(np.array([-9], np.int32).view(np.uint8)))
        table.add(np.ones((8, 2), np.float32))
        bounded = len(table._errors) <= cap + 1
        mid = table.get_async_raw(
            pkg.Blob(np.array([-9], np.int32).view(np.uint8)))
        with pytest.raises(pkg.ti.TableRequestError):
            table.wait(mid)
        return bounded

    got, _ = check_both(body)
    assert got is True


# -- PSWord2Vec's host-buffer arm --

from test_torch_hostbatch import (  # noqa: E402
    JConfig, JDictionary, JPSWord2Vec, j_iter_pair_batches,
    write_topic_corpus)
from multiverso_tpu_torch.models.wordembedding import (  # noqa: E402
    Dictionary, PSWord2Vec, Word2VecConfig, iter_pair_batches)
from multiverso_tpu_torch.models.wordembedding.data import \
    TokenizedCorpus  # noqa: E402


def _config(cls, mode):
    return cls(embedding_size=8, window=2, epochs=1, negative=2, sample=0,
               batch_size=256, min_count=1, cbow=mode == "cbow")


def _port_arm(path, mode, device_path, argv=()):
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    PORT.init(argv)
    try:
        model = PSWord2Vec(_config(Word2VecConfig, mode), d)
        model._device_path = device_path
        model._use_prefetch = tcc.cache_enabled() and not device_path
        before = tdashboard.Dashboard.get("CLIENT_CACHE_PREFETCH").count
        loss, pairs = model.train_batches(iter_pair_batches(
            d, tok, batch_size=256, window=2, subsample=0,
            cbow=mode == "cbow"))
        prefetches = tdashboard.Dashboard.get(
            "CLIENT_CACHE_PREFETCH").count - before
        return (loss, pairs, model._in_table.get().copy(),
                model._out_table.get().copy(), prefetches)
    finally:
        tmv.shutdown()
        tconfigure.reset_flags()


@pytest.mark.parametrize("mode", ["sg", "cbow"])
def test_host_buffer_arm_equals_the_device_arm(tmp_path, mode):
    """Cache off: the host-buffer arm pulls the unique rows into host
    buffers and pushes the real rows' deltas; the device arm pulls and
    pushes the padded sets on the device. Same tables, bit for bit."""
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=120)
    dev = _port_arm(path, mode, True)
    host = _port_arm(path, mode, False)
    assert host[1] == dev[1] > 0
    assert host[0] == dev[0]
    for h, d in zip(host[2:4], dev[2:4]):
        np.testing.assert_array_equal(h.view(np.int32), d.view(np.int32))
    assert host[4] == dev[4] == 0


def _reference_arm(path, mode, argv=()):
    """The reference's forced host-buffer arm
    (``tests/test_client_cache.py:342``): (loss, pairs, input rows,
    output rows, prefetches)."""
    from multiverso_tpu.models.wordembedding.data import \
        TokenizedCorpus as JTok
    jd = JDictionary.build(str(path), min_count=1)
    jtok = JTok.build(jd, str(path))
    jmv.init(list(argv))
    try:
        model = JPSWord2Vec(_config(JConfig, mode), jd)
        model._device_path = False
        model._use_prefetch = jcc.cache_enabled()
        before = jdashboard.Dashboard.get("CLIENT_CACHE_PREFETCH").count
        loss, pairs = model.train_batches(j_iter_pair_batches(
            jd, jtok, batch_size=256, window=2, subsample=0,
            cbow=mode == "cbow"))
        prefetches = jdashboard.Dashboard.get(
            "CLIENT_CACHE_PREFETCH").count - before
        return (loss, pairs, model._in_table.get().copy(),
                model._out_table.get().copy(), prefetches)
    finally:
        jmv.shutdown()
        jconfigure.reset_flags()


@pytest.mark.parametrize("mode", ["sg", "cbow"])
def test_host_path_trainer_matches_reference(tmp_path, mode):
    """Cache off: the port's host-buffer arm against the reference's
    forced one, loss and both tables at rtol 1e-5 / atol 1e-7."""
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=120)
    want = _reference_arm(path, mode)
    got = _port_arm(path, mode, False)
    assert got[1] == want[1] > 0
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL, atol=ATOL)
    assert np.abs(got[3]).max() > 0


@pytest.mark.parametrize("mode", ["sg", "cbow"])
def test_host_path_trainer_prefetches_and_trains(tmp_path, mode):
    """The reference's case (``test_client_cache.py:342``) on both
    packages, cache on (bound 8) and prefetch forced on the host-buffer
    arm: both prefetch and train, the losses within rtol 1e-4. Not
    tighter: a Get that joins a prefetch in flight requests its rows
    still missing when the prefetch completes, and whether that request
    passes the previous batch's push depends on timing, in both
    packages (the reference's own runs of this case differ by up to
    6e-6 in the loss and 9e-4 in the tables)."""
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=120)
    want = _reference_arm(path, mode, ["-max_get_staleness=8"])
    got = _port_arm(path, mode, False, argv=["-max_get_staleness=8"])
    assert got[1] == want[1] > 0
    assert got[4] > 0 and want[4] > 0
    assert np.isfinite(got[0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert np.abs(got[3]).max() > 0
