"""The port's observability layer held against the JAX package's on the
same inputs (CPU): the metrics registry and its exposition (fault C13: the
port's ``/metrics`` text is byte-equal to the JAX package's), tracing,
exemplars, the SLO engine, the phase waterfall on a live query server,
both servers' observability routes and trace ids, the metrics contract
(the families the JAX servers register, less a written exemption list),
and the result cache driven through both query servers by one scripted
sequence."""

from __future__ import annotations

import concurrent.futures
import json
import logging
import math
import re
import threading
import time

import pytest

import predictionio_tpu.obs.metrics as jax_metrics
import predictionio_tpu.obs.slo as jax_slo
import predictionio_tpu.obs.tracing as jax_tracing
import predictionio_tpu_torch.obs.metrics as port_metrics
import predictionio_tpu_torch.obs.slo as port_slo
import predictionio_tpu_torch.obs.tracing as port_tracing
from predictionio_tpu.tools.top import parse_prometheus
from tests.torch_serving_helpers import (
    PACKAGES,
    Client,
    JsonQuery,
    call,
    event_server,
    query_server,
)

METRICS = {"jax": jax_metrics, "port": port_metrics}
SLO = {"jax": jax_slo, "port": port_slo}
EVENT = {"event": "rate", "entityType": "user", "entityId": "u1"}
PHASE_NAMES = ("ingress_parse", "cache", "queue_wait", "batch_assembly", "dispatch",
               "device_compute", "fetch", "serve", "respond")


def _both(fn):
    """``fn(module of the package)`` for each package; both must agree."""
    out = {pkg: fn(METRICS[pkg]) for pkg in PACKAGES}
    assert out["jax"] == out["port"], out
    return out["port"]


# ---------------------------------------------------------------------------
# fault C13: the exposition is byte-equal
# ---------------------------------------------------------------------------


def _c13_ops(M):
    """The operations of the C13 report plus every instrument method the
    exposition renders: a labelled counter inc(3), a gauge at inf, a
    histogram that observed 0.003 and 2.0, set_total, gauge inc/dec and a
    callback, remove/prune, escaping, exemplars."""
    r = M.MetricsRegistry()
    r.counter("pio_x_total", "labelled counter", labelnames=("k",)).inc(3, k="a")
    r.gauge("pio_g", "a gauge").set(math.inf)
    r.gauge("pio_neg", "").set(-math.inf)
    h = r.histogram("pio_h_seconds", "latency\nwith a newline", labelnames=("phase",))
    h.observe(0.003, exemplar="cafef00d12345678", phase="a")
    h.observe(2.0, phase="a")
    h.observe(42.0, exemplar="00000000deadbeef", phase="b")
    c = r.counter("pio_mirror_total", "mirrored")
    c.set_total(7)
    c.set_total(5)  # clamps monotonic
    g = r.gauge("pio_depth", "depth", labelnames=("q",))
    g.inc(2.5, q="x")
    g.dec(1, q="x")
    g.set_function(lambda: 12.0, q="fn")
    live = r.gauge("pio_live", "live set", labelnames=("replica",))
    for rep in ("r0", "r1", "r2"):
        live.set(1, replica=rep)
    live.remove(replica="r0")
    live.prune("replica", ["r2"])
    r.counter("pio_esc_total", 'back\\slash "quote"', labelnames=("v",)).inc(v='a"b\\c\nd')
    r.histogram("pio_custom", "custom ladder", buckets=(0.5, 1, 2)).observe(1.0)
    return r


@pytest.mark.parametrize("exemplars", [False, True], ids=["prometheus", "openmetrics"])
def test_c13_exposition_is_byte_equal_to_the_jax_package(exemplars):
    """Fault C13: the port rendered ``le="1.0"``, ``3.0`` and ``inf`` where
    the JAX package renders ``le="1"``, ``3`` and ``+Inf``; Prometheus
    reads them as different series. The same operations now give the same
    bytes."""
    texts = {pkg: _c13_ops(METRICS[pkg]).render_prometheus(exemplars=exemplars) for pkg in PACKAGES}
    assert texts["port"] == texts["jax"]
    assert 'le="1"' in texts["port"] and 'pio_x_total{k="a"} 3\n' in texts["port"]
    assert "pio_g +Inf" in texts["port"]
    assert ("# EOF" in texts["port"]) is exemplars


def test_c13_snapshot_and_format_value_equal():
    assert _both(lambda M: _c13_ops(M).snapshot()) is not None
    for v in (0.0, 3.0, -2.0, 1e15, 1e16, 0.1, 2.5e-7, math.inf, -math.inf):
        assert port_metrics.format_value(v) == jax_metrics.format_value(v)


# ---------------------------------------------------------------------------
# TestCounterGauge / TestHistogram / TestPrometheusExposition counterparts
# ---------------------------------------------------------------------------


class TestCounterGauge:
    def test_counter_labels_and_totals(self):
        def run(M):
            r = M.MetricsRegistry()
            c = r.counter("pio_req_total", "reqs", labelnames=("endpoint", "status"))
            c.inc(endpoint="/q", status="200")
            c.inc(2, endpoint="/q", status="200")
            c.inc(endpoint="/q", status="503")
            return c.value(endpoint="/q", status="200"), c.total(), c.collect()

        assert _both(run)[:2] == (3.0, 4.0)

    def test_counter_is_monotonic(self):
        def run(M):
            c = M.MetricsRegistry().counter("pio_c_total")
            with pytest.raises(ValueError):
                c.inc(-1)
            with pytest.raises(ValueError):
                c.inc(1, extra="x")
            return c.value()

        assert _both(run) == 0.0

    def test_gauge_set_and_callback(self):
        def run(M):
            r = M.MetricsRegistry()
            g = r.gauge("pio_g")
            g.set(4)
            depth = [7]
            cb = r.gauge("pio_cb")
            cb.set_function(lambda: depth[0])
            first = cb.value()
            depth[0] = 9
            return g.value(), first, cb.value()

        assert _both(run) == (4.0, 7.0, 9.0)

    def test_get_or_create_and_conflicts(self):
        def run(M):
            r = M.MetricsRegistry()
            a = r.counter("pio_x_total", labelnames=("k",))
            assert r.counter("pio_x_total", labelnames=("k",)) is a
            assert r.get("pio_x_total") is a and r.get("pio_nope") is None
            errors = []
            for make in (lambda: r.gauge("pio_x_total", labelnames=("k",)),
                         lambda: r.counter("pio_x_total", labelnames=("j",))):
                with pytest.raises(ValueError) as info:
                    make()
                errors.append(str(info.value))
            return errors

        _both(run)

    def test_invalid_names_rejected(self):
        def run(M):
            r = M.MetricsRegistry()
            for bad in ("1bad", "has-dash", "sp ace"):
                with pytest.raises(ValueError):
                    r.counter(bad)
            with pytest.raises(ValueError):
                r.counter("pio_ok_total", labelnames=("bad-label",))
            return True

        _both(run)


class TestHistogram:
    def test_percentiles_interpolate_in_bucket(self):
        def run(M):
            h = M.MetricsRegistry().histogram("pio_h", buckets=(1, 2, 4, 8))
            for v in (0.5, 1.5, 1.5, 3, 3, 3, 7, 9):
                h.observe(v)
            return h.summary(), h.percentile(0.5), h.bucket_counts(), h.percentile_from_counts([0, 2, 0, 1, 1], 0.5)

        summary, p50, counts, windowed = _both(run)
        assert summary["count"] == 8 and counts == [1, 2, 3, 1, 1]
        assert 2.0 <= p50 <= 4.0 and windowed > 0

    def test_empty_summary(self):
        assert _both(lambda M: M.MetricsRegistry().histogram("pio_h").summary()) == {"count": 0}

    def test_bucket_math_under_concurrent_writers(self):
        def run(M):
            h = M.MetricsRegistry().histogram("pio_h", labelnames=("w",))
            values = [0.0001 * (i % 50 + 1) for i in range(2000)]

            def write(w):
                for v in values:
                    h.observe(v, w=str(w % 2))

            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                list(pool.map(write, range(8)))
            # the sum's float order follows the threads' interleaving: 9 digits
            return ([(s["count"], round(s["sum"], 9), s["p50"], s["max"])
                     for s in (h.summary(w=str(w)) for w in (0, 1))],
                    [h.bucket_counts(w=str(w)) for w in (0, 1)])

        summaries, counts = _both(run)
        assert [s[0] for s in summaries] == [8000, 8000]
        assert all(sum(c) == 8000 for c in counts)


class TestPrometheusExposition:
    def test_render_and_parse_round_trip(self):
        def run(M):
            r = M.MetricsRegistry()
            r.counter("pio_requests_total", "reqs", labelnames=("endpoint", "status")).inc(
                3, endpoint="/queries.json", status="200")
            r.histogram("pio_request_seconds", "lat", labelnames=("endpoint",)).observe(
                0.02, endpoint="/queries.json")
            r.gauge("pio_queue_depth", "depth").set(2)
            return r.render_prometheus()

        text = _both(run)
        parsed = parse_prometheus(text)
        assert ({"endpoint": "/queries.json", "status": "200"}, 3.0) in parsed["pio_requests_total"]
        assert parsed["pio_queue_depth"] == [({}, 2.0)]
        assert any(lab.get("le") == "+Inf" and v == 1.0 for lab, v in parsed["pio_request_seconds_bucket"])

    def test_label_escaping(self):
        def run(M):
            r = M.MetricsRegistry()
            r.counter("pio_e_total", labelnames=("v",)).inc(v='say "hi"\\\n')
            return r.render_prometheus()

        assert '\\"hi\\"' in _both(run)

    def test_collectors_run_at_scrape(self):
        def run(M):
            r = M.MetricsRegistry()
            g = r.gauge("pio_live")
            ticks = []
            r.register_collector(lambda: (ticks.append(1), g.set(len(ticks))))
            r.register_collector(lambda: 1 / 0)  # a broken collector never fails the scrape
            r.render_prometheus()
            r.snapshot()
            return len(ticks), g.value()

        assert _both(run) == (2, 2.0)


# ---------------------------------------------------------------------------
# TestTracing / TestExemplars
# ---------------------------------------------------------------------------

TRACING = {"jax": jax_tracing, "port": port_tracing}


class TestTracing:
    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_span_records_ring_and_log(self, pkg, caplog):
        T = TRACING[pkg]
        tracer = T.Tracer(ring_size=8)
        with caplog.at_level(logging.INFO, logger="pio.trace"):
            with tracer.span("op", kind="internal", trace_id="abc", k=1) as sp:
                sp.tags["late"] = True
        (span,) = tracer.recent()
        assert (span["traceId"], span["name"], span["status"], span["tags"]) == (
            "abc", "op", "ok", {"k": 1, "late": True})
        assert any(json.loads(r.getMessage())["traceId"] == "abc" for r in caplog.records)

    def test_span_marks_error_status_and_reraises(self):
        statuses = []
        for T in TRACING.values():
            tracer = T.Tracer()
            with pytest.raises(KeyError):
                with tracer.span("boom", trace_id="t"):
                    raise KeyError("x")
            statuses.append(tracer.recent()[0]["status"])
        assert statuses == ["KeyError", "KeyError"]

    def test_ring_is_bounded_newest_first(self):
        def run(T):
            tracer = T.Tracer(ring_size=3)
            for i in range(5):
                tracer.record_span(f"s{i}", "internal", 0.001, trace_id=f"t{i}")
            return [s["name"] for s in tracer.recent()], [s["name"] for s in tracer.recent(2)], tracer.spans_recorded

        assert run(jax_tracing) == run(port_tracing) == (["s4", "s3", "s2"], ["s4", "s3"], 5)

    def test_contextvar_isolation(self):
        T = port_tracing
        seen = {}

        def worker(name, tid):
            token = T.set_trace_id(tid)
            time.sleep(0.01)
            seen[name] = T.current_trace_id()
            T.reset_trace_id(token)

        threads = [threading.Thread(target=worker, args=(n, f"id-{n}")) for n in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert seen == {"a": "id-a", "b": "id-b"} and T.current_trace_id() is None

    def test_mint_is_unique(self):
        ids = {port_tracing.mint_trace_id() for _ in range(1000)}
        assert len(ids) == 1000 and all(len(i) == 16 for i in ids)
        assert port_tracing.TRACE_HEADER == jax_tracing.TRACE_HEADER


class TestExemplars:
    def test_observe_with_exemplar_and_accessor(self):
        def run(M):
            h = M.MetricsRegistry().histogram("pio_h", labelnames=("phase",))
            h.observe(0.003, exemplar="aaaa", phase="p")
            h.observe(20.0, exemplar="bbbb", phase="p")
            return h.exemplars(phase="p")

        assert _both(run) == {"0.005": {"exemplar": "aaaa", "value": 0.003},
                              "+Inf": {"exemplar": "bbbb", "value": 20.0}}

    def test_last_writer_wins_per_bucket(self):
        def run(M):
            h = M.MetricsRegistry().histogram("pio_h")
            h.observe(0.002, exemplar="first")
            h.observe(0.0021, exemplar="second")
            return h.exemplars()

        assert _both(run)["0.0025"]["exemplar"] == "second"

    def test_render_plain_vs_openmetrics(self):
        def run(M):
            r = M.MetricsRegistry()
            r.histogram("pio_h").observe(0.002, exemplar="cafe")
            return r.render_prometheus(), r.render_prometheus(exemplars=True)

        plain, om = _both(run)
        assert "trace_id" not in plain and '# {trace_id="cafe"} 0.002' in om and om.endswith("# EOF\n")


# ---------------------------------------------------------------------------
# TestSLOEngine counterparts
# ---------------------------------------------------------------------------


def _slo_run(pkg, feed, objective=0.99, windows=((10.0, 2.0), (60.0, 1.5))):
    """One objective over a (total, bad) counter pair fed by ``feed``
    [(t, total, bad)]; returns the reports at each t."""
    M, S = METRICS[pkg], SLO[pkg]
    r = M.MetricsRegistry()
    total, bad = r.counter("pio_t_total"), r.counter("pio_b_total")
    eng = S.SLOEngine(r)
    eng.add("errors", "bad share", objective, lambda: (total.value(), bad.value()), windows=windows)
    out = []
    for t, n, b in feed:
        total.inc(n)
        bad.inc(b)
        out.append(eng.report(now=t))
    text = r.render_prometheus()
    return out, text


class TestSLOEngine:
    def test_burn_rate_math_multi_window(self):
        feed = [(0.0, 0, 0), (5.0, 100, 5), (9.0, 100, 5), (30.0, 100, 10)]
        out = {pkg: _slo_run(pkg, feed) for pkg in PACKAGES}
        assert out["jax"] == out["port"]
        last = out["port"][0][-1]["slos"][0]
        assert last["windows"][1]["burn_rate"] > 0 and last["name"] == "errors"

    def test_healthy_traffic_not_alerting(self):
        feed = [(float(t), 100, 0) for t in range(0, 60, 5)]
        out = {pkg: _slo_run(pkg, feed)[0] for pkg in PACKAGES}
        assert out["jax"] == out["port"] and not out["port"][-1]["slos"][0]["alerting"]

    def test_single_sample_is_no_data_not_alert(self):
        out = {pkg: _slo_run(pkg, [(0.0, 100, 100)])[0] for pkg in PACKAGES}
        assert out["jax"] == out["port"] and not out["port"][0]["slos"][0]["alerting"]

    def test_histogram_threshold_source_counts_over_threshold(self):
        def run(M, S):
            h = M.MetricsRegistry().histogram("pio_l", labelnames=("endpoint",))
            for v in (0.001, 0.009, 0.01, 0.011, 0.5):
                h.observe(v, endpoint="/q")
            return S.histogram_threshold_source(h, 0.010, endpoint="/q")()

        assert run(jax_metrics, jax_slo) == run(port_metrics, port_slo) == (5.0, 2.0)

    def test_loose_objective_can_still_alert(self):
        feed = [(0.0, 0, 0), (5.0, 100, 100), (9.0, 100, 100)]
        out = {pkg: _slo_run(pkg, feed, objective=0.5)[0] for pkg in PACKAGES}
        assert out["jax"] == out["port"] and out["port"][-1]["slos"][0]["alerting"]

    def test_duplicate_and_invalid_objectives_rejected(self):
        for pkg in PACKAGES:
            eng = SLO[pkg].SLOEngine(METRICS[pkg].MetricsRegistry())
            eng.add("a", "", 0.9, lambda: (0.0, 0.0))
            with pytest.raises(ValueError):
                eng.add("a", "", 0.9, lambda: (0.0, 0.0))
            with pytest.raises(ValueError):
                eng.add("b", "", 1.0, lambda: (0.0, 0.0))

    def test_slo_endpoint_on_live_servers(self, tmp_path):
        out = {}
        for pkg in PACKAGES:
            with query_server(pkg, profile_dir=str(tmp_path / pkg)) as (port, server, _):
                for i in range(3):
                    call(port, "POST", "/queries.json", {"qid": i})
                status, _, body = call(port, "GET", "/slo")
                out[pkg] = (status, [(s["name"], s["objective"], s["description"]) for s in body["slos"]],
                            sorted(body["phases"]))
        assert out["jax"] == out["port"]
        assert [n for n, *_ in out["port"][1]] == ["latency", "availability", "shed"]

    def test_event_server_slo_endpoint_rates_collection_routes_only(self):
        out = {}
        for pkg in PACKAGES:
            with event_server(pkg) as (port, server, injector, key):
                call(port, "GET", "/healthz")
                call(port, "GET", "/metrics")
                call(port, "POST", f"/events.json?accessKey={key}", EVENT)
                call(port, "GET", "/slo")
                time.sleep(0.6)  # one more sample past the coalescing interval
                call(port, "POST", f"/events.json?accessKey={key}", EVENT)
                status, _, body = call(port, "GET", "/slo")
                out[pkg] = status, [(s["name"], s["windows"][0]["total"]) for s in body["slos"]]
        # the /metrics scrape took the window's base sample before either
        # POST; /healthz, /metrics and /slo themselves are not counted
        assert out["jax"] == out["port"] == (200, [("availability", 2.0)])


# ---------------------------------------------------------------------------
# the query server: TestQueryServerObs, TestWaterfallE2E
# ---------------------------------------------------------------------------


def _metrics(port, exemplars=False):
    client = Client(port)
    try:
        path = "/metrics?exemplars=1" if exemplars else "/metrics"
        client.conn.request("GET", path)
        resp = client.conn.getresponse()
        return resp.getheader("Content-Type"), resp.read().decode()
    finally:
        client.close()


class TestQueryServerObs:
    def test_metrics_endpoint_is_prometheus_parseable(self, tmp_path):
        out = {}
        for pkg in PACKAGES:
            with query_server(pkg, profile_dir=str(tmp_path / pkg)) as (port, server, _):
                for qid in range(3):
                    assert call(port, "POST", "/queries.json", {"qid": qid})[0] == 200
                ctype, text = _metrics(port)
                parsed = parse_prometheus(text)
                out[pkg] = (
                    ctype.split(";")[0],
                    ({"endpoint": "/queries.json", "status": "200"}, 3.0) in parsed["pio_requests_total"],
                    [v for lab, v in parsed["pio_request_seconds_bucket"] if lab.get("le") == "+Inf"],
                    parsed["pio_queue_depth"],
                    ({"breaker": "dispatch"}, 0.0) in parsed["pio_breaker_state"],
                    parsed["pio_cache_misses_total"],
                    "pio_load_shed_total" in parsed and "pio_deadline_exceeded_total" in parsed,
                )
        assert out["jax"] == out["port"]
        assert out["port"][1] and out["port"][2] == [3.0]

    def test_trace_id_spans_ingress_batch_and_storage(self, tmp_path, monkeypatch):
        """One trace id across the ingress, batch and storage spans, in
        the ring, /traces/recent and the pio.trace log, through the port's
        dispatch thread hop."""
        from predictionio_tpu_torch.data.storage.registry import Storage
        from predictionio_tpu_torch.data.storage.traced import trace_dao
        from tests.torch_sample_engine import Serving0
        from tests.torch_serving_helpers import MEMORY_ENV

        traced_apps = trace_dao(Storage(env=MEMORY_ENV).get_meta_data_apps(), "apps")
        monkeypatch.setattr(Serving0, "supplement", lambda self, q: (traced_apps.get_all(), q)[1])
        tid = port_tracing.mint_trace_id()
        records: list[str] = []

        class Capture(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        trace_logger = logging.getLogger("pio.trace")
        handler, old = Capture(level=logging.INFO), trace_logger.level
        trace_logger.setLevel(logging.INFO)
        trace_logger.addHandler(handler)
        try:
            with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
                client = Client(port)
                client.conn.request("POST", "/queries.json", body=json.dumps({"qid": 5}),
                                    headers={port_tracing.TRACE_HEADER: tid})
                resp = client.conn.getresponse()
                resp.read()
                assert resp.status == 200 and resp.getheader(port_tracing.TRACE_HEADER) == tid
                client.close()
                spans = server.tracer.find(tid)
                _, _, recent = call(port, "GET", "/traces/recent?limit=50")
        finally:
            trace_logger.removeHandler(handler)
            trace_logger.setLevel(old)
        assert {"ingress", "batch", "storage"} <= {s["kind"] for s in spans}, spans
        assert next(s for s in spans if s["kind"] == "storage")["name"] == "storage.apps.get_all"
        batch = next(s for s in spans if s["kind"] == "batch")
        assert {"queue_ms", "dispatch_ms", "fetch_ms", "version"} <= set(batch["tags"])
        assert {s["kind"] for s in recent["spans"] if s["traceId"] == tid} >= {"ingress", "batch", "storage"}
        logged = {json.loads(r)["kind"] for r in records if json.loads(r)["traceId"] == tid}
        assert {"ingress", "batch", "storage"} <= logged

    def test_shed_and_deadline_counters_move_under_chaos(self, tmp_path, monkeypatch):
        from tests.torch_serving_helpers import patch_both

        def slow(orig):
            def predict_batch_dispatch(self, model, queries):
                time.sleep(0.4)
                return orig(self, model, queries)
            return predict_batch_dispatch

        patch_both(monkeypatch, "predict_batch_dispatch", slow)
        out = {}
        for pkg in PACKAGES:
            with query_server(pkg, request_timeout_s=0.2, profile_dir=str(tmp_path / pkg)) as (port, server, _):
                status, retry, _ = call(port, "POST", "/queries.json", {"qid": 1})
                time.sleep(0.5)
                parsed = parse_prometheus(_metrics(port)[1])
                out[pkg] = (status, retry, parsed["pio_deadline_exceeded_total"],
                            parsed["pio_watchdog_trips_total"],
                            ({"endpoint": "/queries.json", "status": "503"}, 1.0) in parsed["pio_requests_total"])
        assert out["jax"] == out["port"]
        assert out["port"][0] == 503 and out["port"][2] == [({}, 1.0)]

    def test_breaker_transitions_counted(self, tmp_path):
        out = {}
        for pkg in PACKAGES:
            with query_server(pkg, profile_dir=str(tmp_path / pkg), breaker_threshold=1) as (port, server, _):
                server.dispatch_breaker.record_failure()
                parsed = parse_prometheus(_metrics(port)[1])
                out[pkg] = (parsed["pio_breaker_transitions_total"],
                            ({"breaker": "dispatch"}, 2.0) in parsed["pio_breaker_state"])
        assert out["jax"] == out["port"]


class TestWaterfallE2E:
    def test_phases_tile_e2e_latency_within_tolerance(self, tmp_path):
        """The per-phase means of 40 queries sum to within 10 % of the mean
        of pio_request_seconds (the JAX server's contract)."""
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            client = Client(port)
            for i in range(40):
                assert client.call("POST", "/queries.json", {"qid": i})[0] == 200
            client.close()
            hist = server.waterfall.hist
            counts = {p: hist.summary(phase=p).get("count") for p in PHASE_NAMES}
            phase_sum = sum(hist.summary(phase=p)["mean"] for p in PHASE_NAMES)
            e2e = server._m_latency.summary(endpoint="/queries.json")["mean"]
        assert all(c == 40 for c in counts.values()), counts
        assert phase_sum == pytest.approx(e2e, rel=0.10)

    def test_phase_exemplar_resolves_to_trace(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            for i in range(5):
                call(port, "POST", "/queries.json", {"qid": i})
            ctype, text = _metrics(port, exemplars=True)
            _, _, recent = call(port, "GET", "/traces/recent?limit=500")
        assert ctype.startswith("application/openmetrics-text")
        by_phase: dict[str, set] = {}
        for m in re.finditer(r'pio_phase_seconds_bucket\{phase="([a-z_]+)"[^}]*\} \d+ # '
                             r'\{trace_id="([0-9a-f]+)"\}', text):
            by_phase.setdefault(m.group(1), set()).add(m.group(2))
        assert set(by_phase) == set(PHASE_NAMES)
        ring = {s["traceId"] for s in recent["spans"]}
        assert all(tids & ring for tids in by_phase.values())

    def test_batch_and_ingress_spans_carry_phase_tags(self, tmp_path):
        tid = port_tracing.mint_trace_id()
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            call(port, "POST", "/queries.json", {"qid": 1}, headers={port_tracing.TRACE_HEADER: tid})
            spans = server.tracer.find(tid)
        batch = next(s for s in spans if s["kind"] == "batch")
        assert {"queue_ms", "dispatch_ms", "fetch_ms", "device_compute_ms", "serve_ms",
                "fetch_residual_ms"} <= set(batch["tags"])
        ingress = next(s for s in spans if s["kind"] == "ingress")
        assert {"ingress_parse_ms", "respond_ms", "status"} <= set(ingress["tags"])

    def test_default_metrics_scrape_stays_plain_v004(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            call(port, "POST", "/queries.json", {"qid": 1})
            ctype, text = _metrics(port)
        assert ctype.startswith("text/plain") and "trace_id" not in text and "# EOF" not in text


# ---------------------------------------------------------------------------
# the event server: TestEventServerObs
# ---------------------------------------------------------------------------


class TestEventServerObs:
    def test_metrics_and_trace_header(self):
        out = {}
        for pkg in PACKAGES:
            with event_server(pkg) as (port, server, injector, key):
                tid = port_tracing.mint_trace_id()
                client = Client(port)
                client.conn.request("POST", f"/events.json?accessKey={key}", body=json.dumps(EVENT),
                                    headers={port_tracing.TRACE_HEADER: tid, "Content-Type": "application/json"})
                resp = client.conn.getresponse()
                resp.read()
                client.close()
                spans = server.tracer.find(tid)
                parsed = parse_prometheus(_metrics(port)[1])
                out[pkg] = (
                    resp.status, resp.getheader(port_tracing.TRACE_HEADER) == tid,
                    {"ingress", "storage"} <= {s["kind"] for s in spans},
                    "storage.l_events.insert" in {s["name"] for s in spans},
                    ({"endpoint": "/events.json", "status": "201"}, 1.0) in parsed["pio_requests_total"],
                    [v for lab, v in parsed["pio_events_ingested_total"] if lab["status"] == "201"],
                    ({"breaker": "eventdata"}, 0.0) in parsed["pio_breaker_state"],
                )
        assert out["jax"] == out["port"] == (201, True, True, True, True, [1.0], True)

    def test_route_labels_are_patterns_not_paths(self):
        out = {}
        for pkg in PACKAGES:
            with event_server(pkg) as (port, server, injector, key):
                for eid in ("a1", "b2"):
                    call(port, "GET", f"/events/{eid}.json?accessKey={key}")
                call(port, "GET", "/no/such/route")
                parsed = parse_prometheus(_metrics(port)[1])
                out[pkg] = sorted((lab["endpoint"], lab["status"], v) for lab, v in parsed["pio_requests_total"])
        assert out["jax"] == out["port"]
        assert ("/events/{event_id}.json", "404", 2.0) in out["port"]

    def test_retry_and_breaker_counters_move_under_chaos(self):
        out = {}
        for pkg in PACKAGES:
            with event_server(pkg) as (port, server, injector, key):
                injector.inject("insert", fail_count=1)
                first = call(port, "POST", f"/events.json?accessKey={key}", EVENT)[0]
                injector.inject("insert", fail_count=100)
                statuses = [call(port, "POST", f"/events.json?accessKey={key}", EVENT)[0] for _ in range(3)]
                parsed = parse_prometheus(_metrics(port)[1])
                out[pkg] = (first, statuses, parsed["pio_storage_retries_total"],
                            sorted(lab["to"] for lab, _ in parsed["pio_breaker_transitions_total"]))
        assert out["jax"] == out["port"]

    def test_stats_json_still_backward_compatible(self):
        out = {}
        for pkg in PACKAGES:
            with event_server(pkg, stats=True) as (port, server, injector, key):
                call(port, "POST", f"/events.json?accessKey={key}", EVENT)
                status, _, body = call(port, "GET", f"/stats.json?accessKey={key}")
                out[pkg] = status, sorted(body), body["longLive"]["basic"]
        assert out["jax"] == out["port"]


# ---------------------------------------------------------------------------
# the metrics contract
# ---------------------------------------------------------------------------

# families the JAX servers register that the port does not, each with why
EXEMPT = {
    **{name: "no jit cache in eager PyTorch: the port's one compile is the first-use nvcc "
             "build, counted by pio_kernel_builds_total"
       for name in ("pio_jit_cache_misses_total", "pio_jit_cache_size", "pio_jit_recompile_storm",
                    "pio_xla_compile_events_total", "pio_xla_compile_seconds_total")},
}


@pytest.mark.parametrize("which", ["query", "event"])
def test_metrics_contract(which, tmp_path):
    """The port's server registers every family its JAX counterpart
    registers (``tests/test_resilience.py``'s factories), less EXEMPT."""
    from predictionio_tpu_torch.obs.torchprof import JIT_FAMILIES_NOT_PORTED
    from tests.test_resilience import _make_event_server, _make_query_server

    if which == "query":
        jax_families = set(_make_query_server().metrics._metrics)
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            port_families = set(server.metrics._metrics)
            scraped = set(parse_prometheus(_metrics(port)[1]))
    else:
        jax_families = set(_make_event_server()[0].metrics._metrics)
        with event_server("port") as (port, server, *_):
            port_families = set(server.metrics._metrics)
            scraped = set(parse_prometheus(_metrics(port)[1]))
    missing = jax_families - port_families
    assert missing == (set(EXEMPT) & jax_families), sorted(missing)
    if which == "query":  # the list the card smoke scrapes for
        import chip_smoke

        assert set(chip_smoke.CONTRACT_FAMILIES) == jax_families - set(EXEMPT)
    assert set(JIT_FAMILIES_NOT_PORTED) <= set(EXEMPT)
    assert len(jax_families) == (74 if which == "query" else 19)
    # a family with zero series scrapes as HELP/TYPE only; unlabelled ones scrape a sample
    for name in port_families:
        metric = server.metrics.get(name)
        if not metric.labelnames and metric.kind != "histogram":
            assert name in scraped, name


# ---------------------------------------------------------------------------
# the result cache: one scripted sequence through both query servers
# ---------------------------------------------------------------------------


class _TagModel:
    def __init__(self, tag):
        self.tag = tag


class _TagAlgo:
    def predict(self, model, q):
        return model.tag

    def predict_batch(self, model, qs):
        return [model.tag for _ in qs]

    def predict_batch_dispatch(self, model, qs):
        return lambda: self.predict_batch(model, qs)

    def warmup_serving(self, model, max_batch):
        pass


class _TagServing:
    def __init__(self, tag):
        self.tag = tag

    def supplement(self, q):
        return q

    def serve(self, q, preds):
        return {"model": preds[0], "serving": self.tag, "qid": q.qid}


def _lane(pkg, tag):
    if pkg == "jax":
        from predictionio_tpu.registry.router import Lane
    else:
        from predictionio_tpu_torch.registry.router import Lane
    return Lane([_TagAlgo()], _TagServing(tag), [_TagModel(tag)], tag, f"inst-{tag}")


def _cache_script(pkg, port, server, run):
    """Repeats (one canonical key for two key orders), a TTL expiry, a
    stable swap (stage + promote), an active rollout (bypassed), and a
    rollback; returns every answer and the cache's counters after each
    step."""

    def on_loop(fn, *args):
        if run is None:
            return fn(*args)

        async def call_it():
            return fn(*args)

        return run(call_it())

    cache = server._result_cache
    trail = []

    def q(payload, raw=None):
        status, _, body = call(port, "POST", "/queries.json", None if raw else payload, raw=raw,
                               headers={"Content-Type": "application/json"} if raw else None)
        trail.append((status, body))

    def mark(step):
        s = cache.stats()
        trail.append((step, s["hits"], s["misses"], s["evictions"], s["invalidations"], s["entries"]))

    on_loop(setattr, server, "_active", _lane(pkg, "v1"))
    q({"qid": 1, "user": "u1"})
    q(None, raw=b'{"user": "u1", "qid": 1}')  # the same canonical key
    q({"qid": 2, "user": "u2"})
    mark("repeats")
    time.sleep(0.45)  # past the TTL
    q({"qid": 1, "user": "u1"})
    q({"qid": 1, "user": "u1"})
    mark("ttl")
    on_loop(server.stage_candidate_lane, _lane(pkg, "v2"), "canary", 0.0, False)
    on_loop(server._promote_candidate, False)
    q({"qid": 1, "user": "u1"})
    q({"qid": 1, "user": "u1"})
    mark("swap")
    on_loop(server.stage_candidate_lane, _lane(pkg, "v3"), "canary", 0.5, False)
    for user in ("u1", "u3", "u4"):
        q({"qid": 1, "user": user})
    mark("rollout")
    on_loop(server._rollback_candidate, "manual")
    q({"qid": 1, "user": "u1"})
    mark("rollback")
    return trail


def test_result_cache_scripted_sequence_matches_the_jax_server(tmp_path):
    out = {}
    for pkg in PACKAGES:
        with query_server(pkg, result_cache_size=4, result_cache_ttl_s=0.3, bake_check_interval_s=30.0,
                          profile_dir=str(tmp_path / pkg)) as (port, server, run):
            out[pkg] = _cache_script(pkg, port, server, run)
    assert out["jax"] == out["port"]
    marks = {row[0]: row[1:] for row in out["port"] if isinstance(row[0], str)}
    assert marks["repeats"] == (1.0, 2.0, 0.0, 0.0, 2.0)
    assert marks["ttl"] == (2.0, 3.0, 1.0, 0.0, 2.0)  # the expired entry counted as an eviction
    assert marks["swap"][3] >= 2.0  # the retired stable's entries flushed
    assert marks["rollout"][:2] == marks["swap"][:2]  # no lookup while a rollout is active
    assert marks["rollback"][0] == marks["swap"][0] + 1  # stable entries survive a rollback


def test_result_cache_hit_answers_before_admission_and_while_the_breaker_is_open(tmp_path):
    with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
        first = call(port, "POST", "/queries.json", {"qid": 7})
        dispatched = server.batcher.queries_dispatched
        server.dispatch_breaker.record_failure()
        for _ in range(5):
            server.dispatch_breaker.record_failure()
        assert server.dispatch_breaker.state == "open"
        hit = call(port, "POST", "/queries.json", {"qid": 7})
        miss = call(port, "POST", "/queries.json", {"qid": 8})
        text = _metrics(port)[1]
    assert hit[0] == 200 and hit[2] == first[2]
    assert server.batcher.queries_dispatched == dispatched
    assert miss[0] == 503  # a miss meets the open breaker
    assert "pio_cache_hits_total 1\n" in text and 'pio_phase_seconds_count{phase="cache"} 3' in text
