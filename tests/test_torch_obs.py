"""The port's observability (``repro_torch.obs``) on the CPU.

Modelled on ``tests/test_obs.py`` (the registry, merge and render, the
naming lint, tracing, structured logging, the trace tree and the alias
contract, ``test_every_canonical_name_exists_on_live_surfaces`` on the
port's ``StoreServer``, ``ShardedBackend``, ``GatewayServer`` and
``ServeMetrics``) and on the four cases of ``tests/test_obs_integration.py``
(one stitched trace across gateway, scheduler and three store shards, with
the reuse rollup and the cluster-merged ``GET /metrics``; the lease-wait
span; the optional ``tp`` field; pre-metrics peers).  Every client takes
``device="cpu"``.

Beyond them, held against the reference package: ``ALIASES`` key for key,
the package's ``__all__``, and ``build_trace``, ``critical_path``,
``reuse_rollup`` and ``render_trace`` on the same NDJSON span files; and
the trace CLI (``python -m repro_torch.obs.trace``) listing and rendering a
gateway run's trace.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.api import Client, WorkflowSpec
from repro_torch.core import MemoryBackend
from repro_torch.gateway import GatewayServer, TokenAuthenticator
from repro_torch.gateway.serve import register_demo_modules
from repro_torch.net import RemoteBackend, ShardedBackend, StoreServer
from repro_torch.net.protocol import recv_frame, send_frame
from repro_torch.obs import tracing
from repro_torch.obs.logging import configure_logging, get_logger
from repro_torch.obs.metrics import (
    ALLOWED_LABELS,
    DEFAULT_BUCKETS,
    MetricsRegistry,
    lint_doc,
    lint_registry,
    merge_docs,
    render_prometheus,
)
from repro_torch.obs.naming import ALIASES, SURFACES
from repro_torch.obs.trace import build_trace, critical_path, render_trace, reuse_rollup
from repro_torch.obs.tracing import (
    NOOP_SPAN,
    TraceContext,
    configure_tracing,
    current_traceparent,
    iter_spans,
    span,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def traced(tmp_path):
    """Enable span recording into a temp dir; always disable afterwards."""
    d = str(tmp_path / "traces")
    configure_tracing(d, "test")
    yield d
    configure_tracing(None)


@pytest.fixture(autouse=True)
def _tracing_off_by_default():
    yield
    configure_tracing(None)


# -- registry -----------------------------------------------------------------

class TestRegistry:
    def test_counter_inc_and_value(self):
        reg = MetricsRegistry()
        c = reg.counter("repro_x_things_total", "things")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5

    def test_labeled_children_are_distinct(self):
        reg = MetricsRegistry()
        fam = reg.counter("repro_x_ops_total", "ops", ("op",))
        fam.labels(op="get").inc(3)
        fam.labels(op="put").inc()
        got = {s["labels"]["op"]: s["value"] for s in fam.series()}
        assert got == {"get": 3, "put": 1}

    def test_reregistration_is_idempotent_but_mismatch_raises(self):
        reg = MetricsRegistry()
        a = reg.counter("repro_x_n_total", "n")
        assert reg.counter("repro_x_n_total", "n") is a
        with pytest.raises(ValueError):
            reg.gauge("repro_x_n_total", "n")
        with pytest.raises(ValueError):
            reg.counter("repro_x_n_total", "n", ("op",))

    def test_gauge_set_function_is_sampled_live(self):
        reg = MetricsRegistry()
        box = {"v": 1.0}
        reg.gauge("repro_x_depth", "d").unlabeled.set_function(lambda: box["v"])
        assert reg.gauge("repro_x_depth").value == 1
        box["v"] = 7.0
        assert reg.gauge("repro_x_depth").value == 7

    def test_gauge_dead_callback_reads_nan_not_raise(self):
        reg = MetricsRegistry()
        reg.gauge("repro_x_bad", "d").unlabeled.set_function(
            lambda: 1 / 0
        )
        doc = reg.to_doc()
        assert doc["repro_x_bad"]["series"][0]["value"] is None

    def test_histogram_buckets_and_snapshot(self):
        reg = MetricsRegistry()
        h = reg.histogram("repro_x_wait_seconds", "w", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        snap = h.unlabeled.snapshot()
        assert snap["counts"] == [1, 1, 1] and snap["count"] == 3
        assert snap["sum"] == pytest.approx(5.55)

    def test_thread_safety_under_contention(self):
        reg = MetricsRegistry()
        c = reg.counter("repro_x_hits_total", "h")

        def work():
            for _ in range(2000):
                c.inc()

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value == 16000


class TestMergeAndRender:
    def test_merge_adds_counters_and_histograms_elementwise(self):
        a, b = MetricsRegistry(), MetricsRegistry()
        for reg, n in ((a, 2), (b, 5)):
            reg.counter("repro_x_n_total", "n").inc(n)
            h = reg.histogram("repro_x_t_seconds", "t")
            h.observe(0.01)
        doc = merge_docs([a.to_doc(), b.to_doc()])
        assert doc["repro_x_n_total"]["series"][0]["value"] == 7
        assert doc["repro_x_t_seconds"]["series"][0]["hist"]["count"] == 2

    def test_extra_labels_keep_per_process_gauges_apart(self):
        a, b = MetricsRegistry(), MetricsRegistry()
        a.gauge("repro_x_uptime_seconds", "u").unlabeled.set(10)
        b.gauge("repro_x_uptime_seconds", "u").unlabeled.set(20)
        doc = merge_docs(
            [a.to_doc(), b.to_doc()],
            [{"shard": "h:1"}, {"shard": "h:2"}],
        )
        series = {
            s["labels"]["shard"]: s["value"]
            for s in doc["repro_x_uptime_seconds"]["series"]
        }
        assert series == {"h:1": 10, "h:2": 20}

    def test_merge_skips_none_docs(self):
        reg = MetricsRegistry()
        reg.counter("repro_x_n_total", "n").inc()
        doc = merge_docs([None, reg.to_doc(), {}], [None, {"shard": "s"}, None])
        assert doc["repro_x_n_total"]["series"][0]["value"] == 1

    def test_render_prometheus_text_shape(self):
        reg = MetricsRegistry()
        reg.counter("repro_x_ops_total", "ops", ("op",)).labels(op="get").inc(4)
        reg.histogram("repro_x_t_seconds", "t", buckets=(1.0,)).observe(0.5)
        text = render_prometheus(reg.to_doc())
        assert "# TYPE repro_x_ops_total counter" in text
        assert 'repro_x_ops_total{op="get"} 4' in text
        assert 'repro_x_t_seconds_bucket{le="1"} 1' in text
        assert 'repro_x_t_seconds_bucket{le="+Inf"} 1' in text
        assert "repro_x_t_seconds_count 1" in text


class TestLint:
    def test_clean_registry_passes(self):
        reg = MetricsRegistry()
        reg.counter("repro_store_puts_total", "puts")
        reg.gauge("repro_store_disk_bytes", "bytes", ("shard",))
        reg.histogram("repro_run_seconds", "wall")
        assert lint_registry(reg) == []

    def test_violations_are_reported(self):
        doc = {
            "bad_name": {"type": "counter", "help": "h", "labels": [], "series": []},
            "repro_x_hits": {"type": "counter", "help": "h", "labels": [], "series": []},
            "repro_x_t_ms": {"type": "histogram", "help": "h", "labels": [], "series": []},
            "repro_x_ok_total": {
                "type": "counter", "help": "", "labels": ["weird"], "series": [],
            },
        }
        problems = "\n".join(lint_doc(doc))
        assert "bad_name" in problems
        assert "must end in _total" in problems
        assert "_seconds/_bytes" in problems
        assert "weird" in problems and "missing help" in problems


# -- tracing ------------------------------------------------------------------

class TestTracing:
    def test_traceparent_roundtrip(self):
        ctx = TraceContext.new()
        back = TraceContext.from_traceparent(ctx.to_traceparent())
        assert back is not None
        assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)

    @pytest.mark.parametrize(
        "header",
        [
            None, "", "garbage", "00-short-short",
            "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
            "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
            "00-" + "z" * 32 + "-" + "1" * 16 + "-01",
        ],
    )
    def test_from_traceparent_rejects_malformed(self, header):
        assert TraceContext.from_traceparent(header) is None

    def test_disabled_tracing_is_noop_and_wire_silent(self):
        configure_tracing(None)
        sp = span("x")
        assert sp is NOOP_SPAN
        with sp:
            sp.set(a=1)
            sp.rename("y")
            assert current_traceparent() is None

    def test_spans_record_ndjson_and_stitch(self, traced):
        with span("outer", kind="run", workflow="wf") as outer:
            with span("inner", op="get") as inner:
                assert current_traceparent() == (
                    f"00-{inner.trace_id}-{inner.span_id}-01"
                )
        recs = list(iter_spans(traced))
        by_name = {r["name"]: r for r in recs}
        assert by_name["inner"]["parent"] == by_name["outer"]["span"]
        assert by_name["inner"]["trace"] == by_name["outer"]["trace"]
        assert by_name["outer"]["attrs"]["workflow"] == "wf"
        assert by_name["outer"]["svc"] == "test"

    def test_svc_override_per_span(self, traced):
        with span("a", svc="shard1"):
            pass
        recs = list(iter_spans(traced))
        assert recs[0]["svc"] == "shard1"

    def test_adopting_an_inbound_context(self, traced):
        ctx = TraceContext.new()
        with span("server-side", parent=ctx):
            pass
        rec = next(iter(iter_spans(traced)))
        assert rec["trace"] == ctx.trace_id and rec["parent"] == ctx.span_id

    def test_exception_marks_error(self, traced):
        with pytest.raises(RuntimeError):
            with span("boom"):
                raise RuntimeError("x")
        rec = next(iter(iter_spans(traced)))
        assert rec["attrs"]["error"] == "RuntimeError"

    def test_activate_carries_context_across_threads(self, traced):
        with span("parent") as parent:
            ctx = TraceContext(parent.trace_id, parent.span_id)

        def worker():
            with tracing.activate(ctx):
                with span("child"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        by_name = {r["name"]: r for r in iter_spans(traced)}
        assert by_name["child"]["parent"] == by_name["parent"]["span"]


# -- logging ------------------------------------------------------------------

class TestLogging:
    def test_human_format_stamps_trace_and_baggage(self, traced):
        buf = io.StringIO()
        configure_logging("info", stream=buf)
        log = get_logger("unit")
        with span("s") as sp:
            with tracing.bind(run_id="r-1", tenant="alice"):
                log.info("hello")
        line = buf.getvalue()
        assert sp.trace_id in line and "r-1" in line and "alice" in line
        assert "repro.unit" in line  # the logger tree keeps its name

    def test_json_lines_parse(self):
        buf = io.StringIO()
        configure_logging("info", json_lines=True, stream=buf)
        with tracing.bind(run_id="r-2"):
            get_logger("unit").warning("w %d", 7)
        doc = json.loads(buf.getvalue())
        assert doc["msg"] == "w 7" and doc["run_id"] == "r-2"
        assert doc["level"] == "warning" and doc["trace_id"] == "-"

    def test_reconfigure_replaces_handler_not_stacks(self):
        b1, b2 = io.StringIO(), io.StringIO()
        configure_logging("info", stream=b1)
        configure_logging("info", stream=b2)
        get_logger("unit").info("once")
        assert b1.getvalue() == "" and b2.getvalue().count("once") == 1

    def test_bad_level_raises(self):
        with pytest.raises(ValueError):
            configure_logging("loud")


# -- trace CLI ----------------------------------------------------------------

def _mk_span(trace, sid, parent, name, start, dur, svc="svc", **attrs):
    return {
        "trace": trace, "span": sid, "parent": parent, "name": name,
        "kind": "x", "svc": svc, "pid": 1, "start": start, "dur": dur,
        "attrs": attrs,
    }


class TestTraceCLI:
    def test_build_critical_path_and_rollup(self):
        spans = [
            _mk_span("t1", "a", None, "run", 0.0, 1.0),
            _mk_span("t1", "b", "a", "fast", 0.0, 0.2, saved_s=0.15),
            _mk_span("t1", "c", "a", "slow", 0.1, 0.9),
            _mk_span("t1", "d", "c", "leaf", 0.2, 0.7),
            _mk_span("t2", "e", None, "other", 0.0, 0.1),
        ]
        tree = build_trace(spans, "t1")
        assert set(tree["spans"]) == {"a", "b", "c", "d"}
        assert critical_path(tree) == ["a", "c", "d"]
        text = render_trace(tree)
        assert "4 spans" in text and "* run" in text and "saved" in text
        assert "0.150s saved" in text

    def test_orphans_become_roots(self):
        tree = build_trace(
            [_mk_span("t", "x", "lost-parent", "orphan", 0.0, 0.1)], "t"
        )
        assert [s["name"] for s in tree["roots"]] == ["orphan"]


# -- naming / alias contracts --------------------------------------------------

def _canonical_names(aliases=ALIASES):
    return {v.split("{", 1)[0] for v in aliases.values()}


class TestAliasContract:
    def test_stats_alias_mapping_pinned(self):
        # the mapping itself is API: a drift in either column is a break
        assert ALIASES["store_server:requests"] == "repro_store_server_requests_total"
        assert (
            ALIASES["store_server:streaming.chunks_in"]
            == "repro_store_server_stream_chunks_total{dir=in}"
        )
        assert ALIASES["store_server:uptime_s"] == "repro_store_server_uptime_seconds"
        assert ALIASES["cluster:failover_reads"] == "repro_cluster_failover_reads_total"
        assert (
            ALIASES["gateway:fabric.singleflight_waits"]
            == "repro_singleflight_waits_total"
        )
        assert ALIASES["gateway:gateway.*"] == "repro_gateway_requests_total{op=*}"
        assert (
            ALIASES["gateway:tenant.bytes_stored"]
            == "repro_tenant_stored_bytes{tenant=*}"
        )
        assert ALIASES["serve:runs"] == "repro_serve_requests_total"
        assert ALIASES["serve:units_skipped"] == "repro_serve_chunks_skipped_total"
        assert ALIASES["serve:snapshot_bytes"] == "repro_serve_snapshot_stored_bytes"

    def test_every_canonical_name_exists_on_live_surfaces(self):
        """Stand up the whole fabric (server + cluster client + gateway +
        serve surfaces) and prove each canonical metric in the alias map is
        actually registered somewhere — a silent rename breaks the map and
        fails here."""
        from repro_torch.serve.engine import ServeMetrics
        from repro_torch.serve.snapshots import MemorySnapshotStore

        servers = [StoreServer(MemoryBackend()).start() for _ in range(2)]
        urls = ",".join(f"127.0.0.1:{s.port}" for s in servers)
        client = Client(store_url=urls, device="cpu")
        register_demo_modules(client.registry)
        gw = GatewayServer(client, TokenAuthenticator({"t": "alice"}))
        # serve metrics live on whichever registry the engine mounts; bind
        # them to the client registry the way Client.serve_engine() does
        ServeMetrics(client.metrics)
        MemorySnapshotStore(registry=client.metrics)
        try:
            registered = set(client.metrics.to_doc())
            for s in servers:
                registered |= set(s.metrics.to_doc())
            missing = _canonical_names() - registered
            assert not missing, f"alias map points at unregistered metrics: {missing}"
        finally:
            client.close()
            for s in servers:
                s.stop()

    def test_store_server_stats_dict_keys_survive(self):
        server = StoreServer(MemoryBackend()).start()
        try:
            rb = RemoteBackend(f"127.0.0.1:{server.port}")
            rb.write_blob("k", "data", b"x" * 10)
            assert rb.read_blob("k", "data") == b"x" * 10
            rb.close()
            stats = server.stats()
            assert stats["requests"] >= 2
            assert "ops" in stats and stats["ops"].get("read_blob", 0) >= 1
            for key in (
                "streaming", "active_leases", "connections",
                "subscribers", "catalog_records", "uptime_s",
            ):
                assert key in stats, key
        finally:
            server.stop()

    def test_gateway_counts_dict_reconstructs_from_registry(self):
        client = Client(device="cpu")
        gw = GatewayServer(client, TokenAuthenticator({"t": "alice"}))
        try:
            gw._count("accepted")
            gw._count("accepted")
            gw._count("http_202")
            counts = gw.counts()
            assert counts["accepted"] == 2 and counts["http_202"] == 1
            reqs = {
                s["labels"]["op"]: s["value"]
                for s in gw._m_requests.series()
            }
            assert reqs["accepted"] == 2
        finally:
            client.close()

    def test_metric_naming_lint_on_live_registries(self):
        """Every registry the fabric creates must satisfy the naming scheme
        (repro_ prefix, _total counters, unit-suffixed histograms, label
        vocabulary) — the lint that keeps 'one naming scheme' true."""
        server = StoreServer(MemoryBackend()).start()
        client = Client(store_url=f"127.0.0.1:{server.port}", device="cpu")
        register_demo_modules(client.registry)
        try:
            spec = WorkflowSpec.from_steps("nums", ["normalize", "stats"])
            client.run(spec, [1.0, 2.0, 3.0])
            for reg in (client.metrics, server.metrics):
                assert lint_registry(reg) == []
            # the merged fabric doc lints clean too (merge adds only
            # vocabulary labels such as shard)
            assert lint_doc(client.metrics_doc()) == []
        finally:
            client.close()
            server.stop()

    def test_allowed_labels_vocabulary_pinned(self):
        assert ALLOWED_LABELS == {
            "op", "shard", "tenant", "namespace", "dir",
            "status", "source", "event", "policy",
        }
        assert len(DEFAULT_BUCKETS) == 14


# -- end to end: one trace across gateway, scheduler and shards ----------------

TOKEN = "tok-alice"
SLOW_S = 0.4


def _register_slow(registry):
    @registry.module("slow", seconds=SLOW_S)
    def slow(xs, seconds=SLOW_S):
        time.sleep(seconds)
        return [x * 2 for x in xs]


def _http(base, method, path, body=None, headers=None, timeout=60):
    req = urllib.request.Request(base + path, method=method)
    req.add_header("Authorization", f"Bearer {TOKEN}")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    data = json.dumps(body).encode() if body is not None else None
    with urllib.request.urlopen(req, data=data, timeout=timeout) as resp:
        raw = resp.read()
        ctype = resp.headers.get("Content-Type", "")
        return resp.status, (
            json.loads(raw) if "json" in ctype else raw.decode()
        )


@pytest.fixture()
def fabric(tmp_path):
    trace_dir = str(tmp_path / "traces")
    configure_tracing(trace_dir, "gw")
    servers = [
        StoreServer(MemoryBackend(), trace_service=f"shard{i}").start()
        for i in range(3)
    ]
    urls = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    client = Client(store_url=urls, replication=2, max_pending=16, device="cpu")
    register_demo_modules(client.registry)
    _register_slow(client.registry)
    gw = GatewayServer(client, TokenAuthenticator({TOKEN: "alice"}))
    gw.start()
    try:
        yield gw, client, servers, urls, trace_dir
    finally:
        gw.close()
        client.close()
        for s in servers:
            s.stop()
        configure_tracing(None)


def test_gateway_run_produces_stitched_trace_and_cluster_metrics(fabric):
    gw, client, servers, urls, trace_dir = fabric
    spec = WorkflowSpec.from_steps(
        "nums", [("slow", {"seconds": SLOW_S}), "scale"]
    ).to_dict()
    ctx = TraceContext.new()

    # -- cold run, trace context propagated via the traceparent header ------
    st, doc = _http(
        gw.url, "POST", "/v1/workflows",
        {"spec": spec, "data": [1.0, 2.0], "wait": True},
        headers={"traceparent": ctx.to_traceparent()},
    )
    assert st == 200 and doc["status"] == "done", doc
    assert doc["trace_id"] == ctx.trace_id
    assert doc["result"]["n_computed"] == 2

    # -- warm runs: the policy mines history for a couple of runs, then the
    # stored prefix replaces the slow recompute ------------------------------
    doc2 = None
    for _ in range(4):
        st2, doc2 = _http(
            gw.url, "POST", "/v1/workflows",
            {"spec": spec, "data": [1.0, 2.0], "wait": True},
            headers={"traceparent": TraceContext.new().to_traceparent()},
        )
        assert st2 == 200 and doc2["status"] == "done", doc2
        if doc2["result"]["n_skipped"] >= 1:
            break
    assert doc2["result"]["n_skipped"] >= 1
    assert doc2["result"]["total_seconds"] < SLOW_S / 2

    # -- one stitched trace: gateway -> run -> nodes -> rpcs -> shard ops ---
    spans = list(iter_spans(trace_dir))
    mine = [s for s in spans if s["trace"] == ctx.trace_id]
    names = {s["name"] for s in mine}
    assert "gateway.submit" in names and "run" in names
    assert "node" in names and any(n.startswith("rpc") for n in names)
    gw_span = next(s for s in mine if s["name"] == "gateway.submit")
    assert gw_span["parent"] == ctx.span_id  # adopted the HTTP caller's ctx
    run_span = next(s for s in mine if s["name"] == "run")
    assert run_span["parent"] == gw_span["span"]
    # server-side spans from at least two shards joined the same trace
    shard_svcs = {
        s["svc"] for s in mine if s["name"].startswith("store.")
    }
    assert len(shard_svcs) >= 2, shard_svcs
    processes = {(s["svc"], s["pid"]) for s in mine}
    assert len(processes) >= 3, processes

    # the CLI stitches the same trace into a renderable tree w/ critical path
    tree = build_trace(spans, ctx.trace_id)
    assert tree["roots"] and critical_path(tree)
    rendered = render_trace(tree)
    assert "gateway.submit" in rendered and "critical path" in rendered

    # the WARM trace carries the reuse rollup (saved_s on the store.get span)
    warm_tree = build_trace(spans, doc2["trace_id"])
    roll = reuse_rollup(warm_tree)
    assert roll["reuse_hits"] >= 1
    assert roll["seconds_saved"] > 0.0

    # -- GET /metrics: the whole fabric in one Prometheus page --------------
    st3, text = _http(gw.url, "GET", "/metrics")
    assert st3 == 200
    assert "# TYPE repro_store_server_requests_total counter" in text

    def metric_value(name, **labels):
        for line in text.splitlines():
            if not line.startswith(name + "{") and line.split(" ")[0] != name:
                continue
            if all(f'{k}="{v}"' in line for k, v in labels.items()):
                return float(line.rsplit(" ", 1)[1])
        return None

    assert metric_value("repro_reuse_hits_total") >= 1
    assert metric_value("repro_reuse_seconds_saved_total") > 0.0
    assert metric_value("repro_gateway_requests_total", op="accepted") >= 2
    assert metric_value("repro_runs_total", status="ok") >= 2
    # server-side series arrive shard-stamped, from >= 2 distinct shards
    shards = set(
        re.findall(r'repro_store_server_requests_total\{[^}]*shard="([^"]+)"', text)
    )
    assert len(shards) >= 2, shards
    # non-additive per-shard gauges stayed apart (one uptime series per shard)
    uptimes = re.findall(r'repro_store_server_uptime_seconds\{[^}]*shard="([^"]+)"', text)
    assert len(set(uptimes)) == len(servers)


def test_cross_process_lease_wait_span_on_non_leader(fabric):
    gw, client, servers, urls, trace_dir = fabric
    # a SECOND client process-equivalent (own DistributedSingleFlight, own
    # lease identity) racing the first on the same uncomputed prefix
    client2 = Client(store_url=urls, replication=2, device="cpu")
    _register_slow(client2.registry)
    spec = WorkflowSpec.from_steps("lease-ds", [("slow", {"seconds": SLOW_S})])
    try:
        fut1 = client.submit(spec, [1.0])
        time.sleep(SLOW_S / 3)  # let the leader take the lease
        fut2 = client2.submit(spec, [1.0])
        r1 = fut1.result(timeout=30)
        r2 = fut2.result(timeout=30)
        assert r1.output == r2.output == [2.0]
    finally:
        client2.close()
    waits = [s for s in iter_spans(trace_dir) if s["name"] == "lease.wait"]
    assert waits, "non-leader never recorded a lease.wait span"
    assert any(s["dur"] > 0.0 for s in waits)


def test_tp_field_is_ignored_by_servers_and_optional_for_peers(fabric):
    """Forward/backward compat of the optional ``tp`` request field: a server
    answers one-shot ops carrying ``tp`` (and unknown future fields) exactly
    as without them, and a peer that predates the ``metrics`` op degrades to
    ``metrics_doc() -> None`` instead of erroring."""
    gw, client, servers, urls, trace_dir = fabric
    ctx = TraceContext.new()
    sock = socket.create_connection(("127.0.0.1", servers[0].port))
    try:
        send_frame(
            sock,
            {
                "op": "write_meta", "name": "obs-compat",
                "tp": ctx.to_traceparent(), "some_future_field": [1, 2],
            },
            b"1",
        )
        resp, _ = recv_frame(sock)
        assert resp["ok"] is True
        send_frame(sock, {"op": "read_meta", "name": "obs-compat", "tp": "garbage"})
        resp, payload = recv_frame(sock)
        assert resp["ok"] is True and payload == b"1"
    finally:
        sock.close()
    # the tp-stamped op joined the caller's trace on the server side
    adopted = [s for s in iter_spans(trace_dir) if s["trace"] == ctx.trace_id]
    assert any(s["name"] == "store.write_meta" for s in adopted)


class _V1Server(StoreServer):
    """A store server from before the ``metrics`` op existed."""
    _op_metrics = None


def test_pre_metrics_peers_are_skipped_in_cluster_merge(tmp_path):
    old = _V1Server(MemoryBackend()).start()
    new = StoreServer(MemoryBackend()).start()
    sb = ShardedBackend(
        f"127.0.0.1:{old.port},127.0.0.1:{new.port}", replication=1
    )
    try:
        rb_old = RemoteBackend(f"127.0.0.1:{old.port}")
        assert rb_old.metrics_doc() is None  # bad_op -> graceful None
        rb_old.close()
        doc = sb.metrics_doc()
        shards = {
            s["labels"].get("shard")
            for s in doc["repro_store_server_requests_total"]["series"]
        }
        assert shards == {f"127.0.0.1:{new.port}"}
    finally:
        sb.close()
        old.stop()
        new.stop()


# -- against the reference package ---------------------------------------------

def _reference():
    pytest.importorskip("jax")
    import repro.gateway as jgateway
    import repro.obs as jobs
    from repro.obs import naming as jnaming
    from repro.obs import trace as jtrace
    from repro.obs import tracing as jtracing

    return jobs, jnaming, jtrace, jtracing, jgateway


def test_aliases_equal_the_reference_key_for_key():
    _, jnaming, _, _, _ = _reference()
    assert ALIASES == jnaming.ALIASES
    assert list(ALIASES) == list(jnaming.ALIASES)
    assert set(SURFACES) == set(jnaming.SURFACES)


def test_surfaces_name_the_ports_accessors():
    """Each ``SURFACES`` entry is a method of a class of the port."""
    for surface, accessor in SURFACES.items():
        assert accessor.startswith("repro_torch."), (surface, accessor)
        dotted = accessor.removesuffix("()")
        mod_name, cls_name, meth = dotted.rsplit(".", 2)
        cls = getattr(importlib.import_module(mod_name), cls_name)
        assert callable(getattr(cls, meth)), accessor


def test_package_exports_equal_the_reference():
    import repro_torch.gateway as gateway
    import repro_torch.obs as obs

    jobs, _, _, _, jgateway = _reference()
    assert obs.__all__ == jobs.__all__
    assert all(hasattr(obs, name) for name in obs.__all__)
    assert gateway.__all__ == jgateway.__all__
    from repro_torch.obs import span as port_span

    assert port_span is tracing.span


def _same_trace_results(spans, trace_id, jtrace):
    mine, theirs = build_trace(spans, trace_id), jtrace.build_trace(spans, trace_id)
    assert mine == theirs
    assert critical_path(mine) == jtrace.critical_path(theirs)
    assert reuse_rollup(mine) == jtrace.reuse_rollup(theirs)
    assert render_trace(mine) == jtrace.render_trace(theirs)
    return mine


def test_trace_tree_equal_in_both_packages(tmp_path):
    """A gateway run over a store server, recorded as NDJSON span files by
    the port: both packages read the same files into equal trees, critical
    paths, reuse rollups and renderings; so do the hand-made spans of
    ``TestTraceCLI``."""
    _, _, jtrace, jtracing, _ = _reference()
    spans = [
        _mk_span("t1", "a", None, "run", 0.0, 1.0),
        _mk_span("t1", "b", "a", "fast", 0.0, 0.2, saved_s=0.15),
        _mk_span("t1", "c", "a", "slow", 0.1, 0.9),
        _mk_span("t1", "d", "c", "leaf", 0.2, 0.7),
        _mk_span("t1", "x", "lost-parent", "orphan", 0.3, 0.1),
    ]
    _same_trace_results(spans, "t1", jtrace)

    trace_dir = str(tmp_path / "traces")
    configure_tracing(trace_dir, "gw")
    server = StoreServer(MemoryBackend(), trace_service="shard0").start()
    client = Client(store_url=f"127.0.0.1:{server.port}", device="cpu")
    register_demo_modules(client.registry)
    _register_slow(client.registry)
    gw = GatewayServer(client, TokenAuthenticator({TOKEN: "alice"}))
    gw.start()
    try:
        spec = WorkflowSpec.from_steps("nums", [("slow", {"seconds": 0.05}), "scale"]).to_dict()
        ids = []
        for _ in range(4):
            st, doc = _http(gw.url, "POST", "/v1/workflows",
                            {"spec": spec, "data": [1.0, 2.0], "wait": True})
            assert st == 200 and doc["status"] == "done", doc
            ids.append(doc["trace_id"])
    finally:
        gw.close()
        client.close()
        server.stop()
        configure_tracing(None)
    spans = list(iter_spans(trace_dir))
    assert spans == list(jtracing.iter_spans(trace_dir))
    rolled = []
    for trace_id in ids:
        tree = _same_trace_results(spans, trace_id, jtrace)
        assert {"gw", "shard0"} <= set(tree["services"])
        rolled.append(reuse_rollup(tree)["reuse_hits"])
    assert rolled[0] == 0 and rolled[-1] >= 1  # the last run loaded a stored prefix


def test_trace_cli_lists_and_renders(tmp_path):
    """``python -m repro_torch.obs.trace --dir D --list`` names each trace;
    with a trace id it prints the tree, its critical path and the reuse
    line; both print what the reference's CLI prints on the same files."""
    _, _, jtrace, _, _ = _reference()
    d = tmp_path / "traces"
    d.mkdir()
    spans = [
        _mk_span("t1", "a", None, "run", 0.0, 1.0),
        _mk_span("t1", "b", "a", "store.get", 0.0, 0.2, saved_s=0.15),
        _mk_span("t2", "e", None, "other", 2.0, 0.1),
    ]
    (d / "spans-test-1.ndjson").write_text("".join(json.dumps(s) + "\n" for s in spans))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    outs = {}
    for args in (["--list"], ["t1"]):
        got = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.trace", "--dir", str(d), *args],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=60,
        )
        assert got.returncode == 0, got.stderr
        outs[args[0]] = got.stdout
    assert outs["--list"].split()[0] == "t1" and "t2" in outs["--list"]
    assert "* run" in outs["t1"] and "critical path" in outs["t1"]
    assert "1 hits, 0.150s saved" in outs["t1"]
    for args in (["--list"], ["t1"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jtrace.main(["--dir", str(d), *args]) == 0
        assert buf.getvalue() == outs[args[0]]
    missing = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.trace", "--dir", str(d), "nope"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=60,
    )
    assert missing.returncode == 1 and "not found" in missing.stderr
