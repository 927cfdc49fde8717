"""The port's model-average host tier against the JAX package's.

The reference's ``TestAggregate``, ``TestModelAverageAsync`` and
``TestMAShardedAverager`` cases (tests/test_collectives.py), each run on
the reference's ``LocalCluster(n, argv=["-ma=true"])`` and on the port's
``LocalCluster(n, argv=["-ma=true"], device="cpu")`` with the same
inputs: every result of the port equals the reference's bit for bit
(host numpy in both, the fabric's sum in rank order), and meets the
reference test's own assertion. Also: table creation under ``-ma``
raises with the reference's hint, ``mv.aggregate`` on a zoo without
``-ma`` behaves as the reference's (the in-process fabric sums; an
endpoint whose recv stream the actors own refuses), and the collective
FIFO serves reserved slots in reservation order.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu.parallel as jpar
import multiverso_tpu_torch as tmv
import multiverso_tpu_torch.parallel as tpar
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu.util.dashboard import Dashboard as JDashboard
from multiverso_tpu_torch.runtime.cluster import LocalCluster as TCluster
from multiverso_tpu_torch.runtime.net import LocalFabric, NetInterface
from multiverso_tpu_torch.util.dashboard import Dashboard as TDashboard

MA = ["-ma=true"]


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the PORT's role-thread count to its baseline
    and leaves the port's flag registry at its defaults (``-ma`` persists
    across init/shutdown, as the reference's statics do)."""
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


def _api(mv, par):
    return SimpleNamespace(
        aggregate=mv.aggregate, model_average=par.model_average,
        model_average_async=par.model_average_async,
        MAAverager=par.MAAverager, MAShardedAverager=par.MAShardedAverager,
        sharded_model_average=par.sharded_model_average,
        sharded_model_average_async=par.sharded_model_average_async)


JAPI, TAPI = _api(jmv, jpar), _api(tmv, tpar)


def both(n, body):
    """``body(rank, api)`` on n ranks of the reference's cluster and of
    the port's; asserts the results equal bit for bit and returns the
    port's."""
    want = JCluster(n, argv=MA).run(lambda r: body(r, JAPI))
    got = TCluster(n, argv=MA, device="cpu").run(lambda r: body(r, TAPI))
    _assert_same(got, want)
    return got


def _assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _data(rank, size, seed=0):
    """Seeded float32 values of several binades: a rank-order sum of
    them rounds, so a different order would show."""
    rng = np.random.default_rng(1000 * seed + rank)
    return (rng.standard_normal(size)
            * np.exp2(rng.integers(-10, 10, size))).astype(np.float32)


# -- TestAggregate --

def test_ma_mode_aggregate_counts_world():
    def body(rank, api):
        return float(api.aggregate(np.array([1.0], np.float32))[0])

    assert both(4, body) == [4.0] * 4


def test_aggregate_sums_vectors():
    def body(rank, api):
        return api.aggregate(np.full(10, rank + 1.0))

    for result in both(3, body):
        assert result.tolist() == [6.0] * 10


def test_model_average():
    def body(rank, api):
        return api.model_average(np.full(4, float(rank)))[0]

    assert both(2, body) == [0.5, 0.5]


def test_aggregate_and_average_random_data():
    def body(rank, api):
        return (api.aggregate(_data(rank, 777)),
                api.model_average(_data(rank, 777, seed=1)))

    got = both(4, body)
    want = _data(0, 777)
    for r in range(1, 4):
        want = want + _data(r, 777)
    np.testing.assert_array_equal(got[0][0], want)


# -- TestModelAverageAsync --

def test_async_matches_sync_bit_identical():
    def body(rank, api):
        data = _data(rank, 4096)
        sync = api.model_average(data)
        out = api.model_average_async(data).result(timeout=60)
        np.testing.assert_array_equal(out, sync)
        return out

    both(3, body)


def test_future_snapshots_input():
    def body(rank, api):
        data = np.full(2048, float(rank), np.float32)
        fut = api.model_average_async(data)
        data += 100.0  # must not leak into the collective
        return float(fut.result(timeout=60)[0])

    assert both(2, body) == [0.5, 0.5]


def test_averager_double_buffer_and_delta():
    def body(rank, api):
        avg = api.MAAverager()
        params = _data(rank, 1024)
        avg.submit(params)
        params += 2.0  # "training" while the average streams
        merged = avg.collect(current=params, timeout=60)
        with pytest.raises(RuntimeError):
            avg.collect()  # nothing in flight anymore
        return merged

    got = both(2, body)
    want = (_data(0, 1024) + _data(1, 1024)) / 2
    np.testing.assert_allclose(got[0], want + 2.0, rtol=1e-6, atol=1e-6)


def test_back_to_back_async_run_in_call_order():
    def body(rank, api):
        a = api.model_average_async(np.full(2048, float(rank), np.float32))
        b = api.model_average_async(
            np.full(2048, float(rank * 10), np.float32))
        c = api.model_average(np.full(2048, float(rank * 100), np.float32))
        return (float(a.result(timeout=60)[0]),
                float(b.result(timeout=60)[0]), float(c[0]))

    assert both(2, body) == [(0.5, 5.0, 50.0)] * 2


def test_submit_twice_refused():
    def body(rank, api):
        avg = api.MAAverager()
        avg.submit(np.ones(8, np.float32))
        try:
            avg.submit(np.ones(8, np.float32))
            return "missing-check"
        except RuntimeError:
            pass
        avg.collect(timeout=60)
        return "ok"

    assert both(2, body) == ["ok"] * 2


def test_comm_stall_monitor_records():
    jmon, tmon = JDashboard.get("MA_COMM_STALL"), TDashboard.get(
        "MA_COMM_STALL")
    before = (jmon.count, tmon.count)

    def body(rank, api):
        api.model_average(np.ones(64, np.float32))
        api.model_average_async(np.ones(64, np.float32)).result(timeout=60)
        return True

    both(2, body)
    # Every sync call + every blocked result() lands one sample.
    assert jmon.count >= before[0] + 2
    assert tmon.count >= before[1] + 2


# -- TestMAShardedAverager --

def test_first_round_is_exact_mean_despite_divergence():
    def body(rank, api):
        av = api.MAShardedAverager()
        av.submit(np.full(6000, float(rank + 1), np.float32))
        out = av.collect()
        np.testing.assert_array_equal(out, np.full(6000, 1.5, np.float32))
        return out

    both(2, body)


def test_reference_advances_and_bmuf_correction():
    def body(rank, api):
        av = api.MAShardedAverager()
        av.submit(_data(rank, 5000))
        ref1 = av.collect()
        p2 = ref1 + (1.0 if rank == 0 else 3.0)
        av.submit(p2)
        out = av.collect(current=p2 + 0.25)
        with pytest.raises(RuntimeError):
            av.collect()
        return ref1, out

    got = both(2, body)
    np.testing.assert_allclose(got[0][1], got[0][0] + 2.25, rtol=1e-5,
                               atol=1e-5)


def test_sharded_model_average_matches_dense():
    def body(rank, api):
        data = _data(rank, 4096)
        dense = api.model_average(data)
        np.testing.assert_array_equal(api.sharded_model_average(data),
                                      dense)
        fut = api.sharded_model_average_async(data)
        np.testing.assert_array_equal(fut.result(timeout=60), dense)
        return dense

    both(3, body)


def test_submit_while_busy_raises():
    def body(rank, api):
        av = api.MAShardedAverager()
        av.submit(np.zeros(2048, np.float32))
        try:
            with pytest.raises(RuntimeError):
                av.submit(np.zeros(2048, np.float32))
        finally:
            av.collect(timeout=60)
        return True

    assert both(2, body) == [True] * 2


# -- the zoo and the transport --

def test_table_creation_under_ma_raises_with_hint():
    def body(rank):
        with pytest.raises(RuntimeError, match="-ma=true skips the "
                           "parameter server"):
            tmv.create_matrix_table(4, 2)
        with pytest.raises(RuntimeError, match="no parameter server"):
            tmv.create_array_table(4)
        return tmv.current_zoo().num_workers

    assert TCluster(2, argv=MA, device="cpu").run(body) == [0, 0]


def test_aggregate_without_ma_as_reference():
    # The in-process fabric's endpoint sums without -ma in both packages
    # (its allreduce is the fabric's, not the actors' recv stream).
    data = _data(0, 33)
    jmv.init([])
    try:
        want = jmv.aggregate(data)
    finally:
        jmv.shutdown()
    tmv.init([], device="cpu")
    try:
        got = tmv.aggregate(data)
    finally:
        tmv.shutdown()
    np.testing.assert_array_equal(got, want)

    def body(rank):
        return tmv.aggregate(np.full(3, rank + 1.0, np.float32))

    for out in TCluster(2, device="cpu").run(body):
        assert out.tolist() == [3.0] * 3


class _Endpoint(NetInterface):
    """A transport that is not the in-process fabric."""

    rank, size = 0, 2


def test_default_allreduce_refuses():
    net = _Endpoint()
    net.acquire_recv_owner()   # the PS actors drain this endpoint
    with pytest.raises(RuntimeError, match="requires ma mode"):
        net.allreduce(np.ones(2))
    with pytest.raises(RuntimeError, match="requires ma mode"):
        net.sharded_average(np.ones(2))
    net.release_recv_owner()   # -ma: no actors; the engine is A9's
    with pytest.raises(NotImplementedError, match="A9"):
        net.allreduce(np.ones(2))
    with pytest.raises(NotImplementedError, match="A9"):
        net.sharded_average(np.ones(2))


def test_collective_fifo_serves_reserved_slots_in_order():
    fabric = LocalFabric(2)
    nets = [fabric.endpoint(r) for r in range(2)]
    out = [[None, None], [None, None]]

    def rank_main(r):
        first = nets[r].reserve_collective_slot()
        second = nets[r].reserve_collective_slot()

        def run(slot, i, value):
            out[r][i] = nets[r].allreduce(
                np.full(4, value * (r + 1), np.float32), slot=slot)

        # The later slot's thread starts first; it must wait its turn.
        threads = [threading.Thread(target=run, args=(second, 1, 10.0)),
                   threading.Thread(target=run, args=(first, 0, 1.0))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)

    ranks = [threading.Thread(target=rank_main, args=(r,)) for r in (0, 1)]
    for t in ranks:
        t.start()
    for t in ranks:
        t.join(timeout=60)
    for r in range(2):
        assert out[r][0].tolist() == [3.0] * 4
        assert out[r][1].tolist() == [30.0] * 4
