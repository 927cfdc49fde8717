"""Several ranks in one process: the port's ``LocalCluster`` against the
JAX package's.

The same rank body runs in both packages' ``LocalCluster`` (each rank a
thread with its own zoo over one in-process fabric): mixed roles
(``["all", "server"]``, ``["all", "worker"]``), the reference's
``TestMultiRank`` cases for array, matrix and KV tables
(``tests/test_tables.py:590-617,664-675``), and a rank that fails — its
siblings' blocked barriers raise ``ClusterAborted``, the failing rank's
own error is the one reported and nothing hangs. The port's ranks keep
their tables on the CPU (``device="cpu"``); without ``device`` they ask
for the card, as ``mv.init`` does.
"""

import threading
import time

import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu_torch.runtime.cluster import LocalCluster
from multiverso_tpu_torch.runtime.zoo import ClusterAborted


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


def run_both(n, body, roles=None):
    """``body(mv, rank)`` on n ranks of each package's cluster: (the
    reference's results, the port's)."""
    want = JCluster(n, roles=roles).run(lambda r: body(jmv, r))
    got = LocalCluster(n, roles=roles, device="cpu").run(
        lambda r: body(tmv, r))
    return want, got


def _matrix_partition(mv, rank):
    # tests/test_tables.py:600-611, with a role-aware add: the rank of
    # worker 0 adds.
    table = mv.create_matrix_table(10, 3)
    if table is not None and mv.current_zoo().worker_id == 0:
        table.add_rows(np.array([0, 7], np.int32),
                       np.ones((2, 3), np.float32))
    mv.current_zoo().barrier()
    out = None if table is None else table.get()
    mv.current_zoo().barrier()
    zoo = mv.current_zoo()
    return (None if out is None else out.tolist(), zoo.num_workers,
            zoo.num_servers, zoo.worker_id, zoo.server_id)


@pytest.mark.parametrize("roles", [["all", "server"], ["all", "worker"],
                                   ["server", "all", "worker", "all"]])
def test_mixed_roles_match_reference(roles):
    want, got = run_both(len(roles), _matrix_partition, roles)
    assert got == want
    # The controller numbers workers and servers densely in rank order.
    assert [g[3] for g in got] == [w[3] for w in want]
    assert any(g[0] is not None and np.sum(g[0]) == 6.0 for g in got)


def _array_two_ranks(mv, rank):
    # tests/test_tables.py:590-602
    table = mv.create_array_table(10)
    table.add(np.full(10, rank + 1, np.float32))
    zoo = mv.current_zoo()
    zoo.barrier()
    out = table.get()
    zoo.barrier()
    return out.tolist()


def _kv_two_servers(mv, rank):
    # tests/test_tables.py:664-675
    table = mv.create_kv_table()
    table.add([rank, 100 + rank], [1.0, 2.0])
    mv.current_zoo().barrier()
    got = table.get([0, 1, 100, 101])
    mv.current_zoo().barrier()
    return {int(k): float(v) for k, v in got.items()}


@pytest.mark.parametrize("body", [_array_two_ranks, _matrix_partition,
                                  _kv_two_servers])
def test_multi_rank_tables_match_reference(body):
    want, got = run_both(2, body)
    assert got == want
    if body is _array_two_ranks:
        assert got[0] == [3.0] * 10
    if body is _kv_two_servers:
        assert got[0] == {0: 1.0, 1: 1.0, 100: 2.0, 101: 2.0}


def test_failing_rank_aborts_its_siblings():
    aborted = []
    lock = threading.Lock()

    def body(rank):
        if rank == 1:
            time.sleep(0.2)   # the others are blocked in the barrier
            raise ValueError("rank 1 failed")
        try:
            tmv.current_zoo().barrier()
        except ClusterAborted:
            with lock:
                aborted.append(rank)
            raise
        return rank

    cluster = LocalCluster(3, device="cpu")
    cluster.timeout = 5.0
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 failed"):
        cluster.run(body)
    assert time.monotonic() - t0 < cluster.timeout
    assert sorted(aborted) == [0, 2]


def test_aborted_table_requests_raise():
    # A sibling's failure reaches the tables too: a table request after
    # the abort raises ClusterAborted instead of waiting on a server that
    # is gone.
    seen = []
    created = threading.Event()

    def body(rank):
        table = tmv.create_matrix_table(8, 2)
        if rank == 1:
            created.wait(5.0)   # rank 0 is past the creation barrier
            raise RuntimeError("server rank gone")
        created.set()
        # Zoo.abort marks the zoo, then releases its tables: wait for
        # the second.
        deadline = time.monotonic() + 5.0
        while table._abort_reason is None \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        try:
            table.get()
        except ClusterAborted as exc:
            seen.append(str(exc))
            raise

    with pytest.raises(RuntimeError, match="server rank gone"):
        LocalCluster(2, device="cpu").run(body)
    assert seen and "aborted" in seen[0]


def test_cluster_without_device_asks_for_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalCluster(2).run(lambda rank: rank)


def test_split_role_flag_still_refused():
    # One role per PROCESS (-ps_role) needs the multi-process runtime;
    # a role per virtual rank comes from LocalCluster(roles=...).
    with pytest.raises(NotImplementedError, match="A9"):
        tmv.init(["-ps_role=server"], device="cpu")
