"""Metrics export: the port's ``runtime/metrics.py`` against the JAX
package's.

The same reports go through both packages' ``ClusterMetrics`` and give
the same ``cluster_view``, ``prometheus_text`` and Chrome-trace JSON
(the cases of ``tests/test_observability.py:304-372``, plus reports
that arrive out of order or from a superseded incarnation). Then two
ranks of each package's ``LocalCluster`` run with
``-metrics_interval_s``: after ``metrics_flush`` and a barrier the
controller's view holds both ranks' ``SERVER_PROCESS_ADD`` counts in
both packages.
"""

import json
import re
import time

import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.core.blob import Blob as JBlob
from multiverso_tpu.core.message import Message as JMessage
from multiverso_tpu.core.message import MsgType as JMsgType
from multiverso_tpu.runtime import metrics as jmetrics
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu.util import configure as jconfigure
from multiverso_tpu.util import dashboard as jdashboard
from multiverso_tpu.util import tracing as jtracing
from multiverso_tpu_torch.core.blob import Blob
from multiverso_tpu_torch.core.message import Message, MsgType
from multiverso_tpu_torch.runtime import metrics as tmetrics
from multiverso_tpu_torch.runtime.cluster import LocalCluster
from multiverso_tpu_torch.util import configure as tconfigure
from multiverso_tpu_torch.util import dashboard as tdashboard
from multiverso_tpu_torch.util import tracing as ttracing

PROM_LINE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z0-9_]+=\"[^\"]*\""
    r"(,[a-zA-Z0-9_]+=\"[^\"]*\")*\})?"
    r" -?[0-9.eE+-]+(inf)?$")


@pytest.fixture(autouse=True)
def _clean_registries():
    """Both packages' dashboards, samples and trace rings start empty;
    the port's threads and flags are back at their baseline after."""
    from multiverso_tpu_torch.runtime import thread_roles
    before = sum(thread_roles.roles_alive().values())
    for dash, trace in ((jdashboard, jtracing), (tdashboard, ttracing)):
        trace.reset()
        dash.Dashboard.reset()
        dash.reset_samples()
    yield
    for dash, trace in ((jdashboard, jtracing), (tdashboard, ttracing)):
        trace.reset()
        dash.Dashboard.reset()
        dash.reset_samples()
    tconfigure.reset_flags()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if sum(thread_roles.roles_alive().values()) <= before:
            break
        time.sleep(0.05)
    alive = thread_roles.roles_alive()
    assert sum(alive.values()) <= before, f"port threads leaked: {alive}"


def validate_prometheus(text):
    """Line-level validation of the text exposition format
    (tests/test_observability.py:253); {(metric, labels): value}."""
    series = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ",
                            line), line
            continue
        assert PROM_LINE_RE.match(line), f"bad exposition line: {line}"
        name_labels, value = line.rsplit(" ", 1)
        name, _, labels = name_labels.partition("{")
        labels = labels.rstrip("}")
        key = (name, frozenset(labels.split(",")) if labels
               else frozenset())
        series[key] = float(value)
    return series


def _fake_report(rank, gets, window, inc=None, seq=None):
    # tests/test_observability.py:292-300
    report = {"v": 1, "rank": rank,
              "monitors": {"SERVER_PROCESS_GET":
                           {"count": gets, "elapsed_ms": gets * 1.5}},
              "samples": {"DISPATCH_MS[d1]":
                          {"count": len(window), "recent": window}},
              "trace_events": [
                  {"trace": 5, "name": "server_process_get", "ph": "X",
                   "rank": rank, "ts": 1000, "dur": 10, "seq": rank}]}
    if inc is not None:
        report.update(inc=inc, seq=seq)
    return report


def both(reports):
    """The same reports into each package's ClusterMetrics: (reference,
    port)."""
    want, got = jmetrics.ClusterMetrics(), tmetrics.ClusterMetrics()
    for report in reports:
        want.ingest(json.loads(json.dumps(report)))
        got.ingest(json.loads(json.dumps(report)))
    return want, got


def test_snapshot_is_versioned_and_complete():
    # tests/test_observability.py:304-310, on both registries
    snaps = []
    for dash in (jdashboard, tdashboard):
        dash.Dashboard.get("SERVER_PROCESS_GET").add(2.0)
        dash.samples("DISPATCH_MS[d0]").add(1.25)
        snaps.append(dash.metrics_snapshot())
    want, got = snaps
    assert got["v"] == want["v"] == tdashboard.METRICS_SNAPSHOT_VERSION
    assert got["monitors"]["SERVER_PROCESS_GET"] \
        == want["monitors"]["SERVER_PROCESS_GET"]
    assert got["samples"]["DISPATCH_MS[d0]"] \
        == want["samples"]["DISPATCH_MS[d0]"]
    assert got["samples"]["DISPATCH_MS[d0]"]["recent"] == [1.25]


@pytest.mark.parametrize("payload", [b'{"v": 99, "rank": 1}', b"not json",
                                     b'{"v": 1, "rank": 1}', None])
def test_parse_report_matches_reference(payload):
    # tests/test_observability.py:312-321
    results = []
    for mod, msg_cls, blob_cls, types in (
            (jmetrics, JMessage, JBlob, JMsgType),
            (tmetrics, Message, Blob, MsgType)):
        msg = msg_cls(src=1, dst=0, msg_type=types.Control_Metrics)
        if payload is not None:
            msg.push(blob_cls(np.frombuffer(payload, np.uint8).copy()))
        results.append(mod.parse_report(msg))
    assert results[1] == results[0]
    assert (results[1] is None) == (payload != b'{"v": 1, "rank": 1}')


def test_cluster_sum_and_merged_percentiles():
    # tests/test_observability.py:323-337
    want, got = both([_fake_report(1, 30, [1.0, 2.0]),
                      _fake_report(2, 12, [100.0, 200.0]),
                      _fake_report(1, 31, [1.0, 2.0])])
    view = got.cluster_view()
    assert view == want.cluster_view()
    assert view["monitors_sum"]["SERVER_PROCESS_GET"]["count"] == 31 + 12
    merged = view["samples_merged"]["DISPATCH_MS[d1]"]
    assert (merged["count"], merged["max"], merged["p50"]) == (4, 200.0,
                                                               2.0)


def test_prometheus_text_matches_reference():
    # tests/test_observability.py:339-357
    want, got = both([_fake_report(1, 30, [1.0]),
                      _fake_report(2, 12, [3.0])])
    text = got.prometheus_text()
    assert text == want.prometheus_text()
    series = validate_prometheus(text)
    name = 'name="SERVER_PROCESS_GET"'
    per_rank = [v for (metric, labels), v in series.items()
                if metric == "mv_monitor_count_total" and name in labels]
    assert sorted(per_rank) == [12.0, 30.0]
    assert series[("mv_cluster_monitor_count_total",
                   frozenset([name]))] == 42.0
    assert series[("mv_cluster_samples",
                   frozenset(['name="DISPATCH_MS"', 'key="d1"',
                              'quantile="0.99"']))] == 3.0


@pytest.mark.parametrize("name", ["DISPATCH_MS[d1]", "SERVER_PROCESS_GET",
                                  "A[b][c]", "X[", "MAILBOX_DEPTH[server]"])
def test_split_family_matches_reference(name):
    # tests/test_observability.py:359-362
    assert tmetrics.split_family(name) == jmetrics.split_family(name)


def test_merged_trace_feeds_chrome_export():
    # tests/test_observability.py:364-369
    want, got = both([_fake_report(1, 1, []), _fake_report(2, 1, [])])
    doc = got.chrome_trace_json()
    assert doc == want.chrome_trace_json()
    assert {e["pid"] for e in doc["traceEvents"]} == {1, 2}


def test_stale_reports_dropped_as_the_reference_drops_them():
    # Same incarnation with a seq that does not advance, then a new
    # incarnation, then a frame of the superseded one.
    reports = [_fake_report(1, 5, [1.0], inc="a", seq=2),
               _fake_report(1, 4, [1.0], inc="a", seq=1),
               _fake_report(1, 7, [1.0], inc="b", seq=1),
               _fake_report(1, 9, [1.0], inc="a", seq=3)]
    want, got = both(reports)
    view = got.cluster_view()
    assert view == want.cluster_view()
    assert view["dropped_reports"] == 2
    assert view["ranks"][1]["monitors"]["SERVER_PROCESS_GET"]["count"] == 7


def _two_ranks(mv, rank):
    """Adds and Gets from both ranks, a flush of each rank's report and
    a barrier, then rank 0 reads its controller's view."""
    table = mv.create_array_table(8)
    for _ in range(3):
        table.add(np.ones(8, np.float32))
        table.get()
    zoo = mv.current_zoo()
    zoo.barrier()
    zoo.metrics_flush()
    zoo.barrier()
    if rank != 0:
        return None
    controller = zoo._actors["controller"]
    view = controller.metrics.cluster_view()
    adds = {r: view["ranks"][r]["monitors"]["SERVER_PROCESS_ADD"]["count"]
            for r in view["ranks"]}
    text = controller.metrics.prometheus_text()
    return (adds, view["monitors_sum"]["SERVER_PROCESS_ADD"]["count"],
            "mv_cluster_monitor_count_total" in text)


def test_two_rank_reporters_match_reference():
    # No request fusion: a fused group of adds counts once.
    argv = ["-metrics_interval_s=0.2", "-server_fuse_max=1"]
    want = JCluster(2, argv=argv)
    want.timeout = 30.0
    want = want.run(lambda r: _two_ranks(jmv, r))[0]
    jconfigure.reset_flags()
    jdashboard.Dashboard.reset()
    tdashboard.Dashboard.reset()
    got = LocalCluster(2, argv=argv, device="cpu")
    got.timeout = 30.0
    got = got.run(lambda r: _two_ranks(tmv, r))[0]
    # The dashboard is the process's: each rank's report counts the
    # two servers' adds of both workers' three rounds.
    assert got == want == ({0: 12, 1: 12}, 24, True)
