"""The port's profiling plane held against the JAX package's (CPU): the
content-addressed profile store, single-flight ``torch.profiler`` captures
(a CPU trace here; the card's capture is in ``tests/test_torch_gpu.py``),
the host sampler with the port's thread roles, the query server's
``/profile/*`` routes and profile-on-alert, the ``pio profile``,
``pio incidents`` and ``pio doctor`` verbs, the capacity planner (equal to
the JAX numbers), the telemetry ring and incident recorder (their bundles
read by the JAX package's readers), the stream pipeline's drift signal, and
the analytic cost model against XLA's ``cost_analysis``."""

from __future__ import annotations

import json
import math
import os
import threading
import time

import pytest
import torch

from predictionio_tpu_torch.obs import costmodel, xray
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.profiler import (
    ProfileBusyError,
    ProfileCaptureError,
    ProfileSession,
    ProfileStore,
    kernel_launches,
    maybe_profile_train,
    trace_kernels,
)
from predictionio_tpu_torch.obs.sampler import HostSampler
from predictionio_tpu_torch.tools import cli
from tests.torch_serving_helpers import PACKAGES, call, query_server


def _store(tmp_path, **kw):
    return ProfileStore(str(tmp_path / "profiles"), **kw)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as fh:
        return json.load(fh)


def _busy_thread(name: str):
    stop = threading.Event()

    def body():
        while not stop.is_set():
            sum(i * i for i in range(500))

    t = threading.Thread(target=body, name=name, daemon=True)
    t.start()
    return stop, t


# ---------------------------------------------------------------------------
# ProfileStore: the bundle grammar, equal to the JAX store's
# ---------------------------------------------------------------------------


class TestProfileStore:
    def test_construction_writes_nothing(self, tmp_path):
        assert not os.path.exists(_store(tmp_path).dir)

    def test_publish_writes_the_jax_layout(self, tmp_path):
        from predictionio_tpu.obs.profiler import ProfileStore as JStore

        out = {}
        for pkg, cls in (("jax", JStore), ("port", ProfileStore)):
            store = cls(str(tmp_path / pkg))
            trace = tmp_path / f"raw-{pkg}" / "plugins"
            trace.mkdir(parents=True)
            (trace / "trace.json").write_bytes(b'{"traceEvents": []}')
            path = store.publish("manual", context={"engine": "e1"}, parts={"waterfall": {"p50": 1.5}},
                                 texts={"stacks_folded": "dispatch;main 3\n"},
                                 trace_dir=str(tmp_path / f"raw-{pkg}"))
            manifest = _manifest(path)
            out[pkg] = (sorted(manifest), manifest["trigger"], manifest["context"], manifest["parts"],
                        manifest["texts"], manifest["trace"], sorted(os.listdir(path)),
                        os.path.basename(path).endswith(manifest["sha256"][:12]))
        assert out["jax"] == out["port"]

    def test_no_tmp_leftovers_and_gc_keeps_newest(self, tmp_path):
        store = _store(tmp_path, max_bundles=3)
        for i in range(5):
            store.publish("manual", context={"n": i})
        assert not [e for e in os.listdir(store.dir) if e.startswith(".tmp-")]
        assert [_manifest(r.path)["context"]["n"] for r in store.list()] == [2, 3, 4]

    def test_list_load_export_roundtrip_and_the_jax_readers(self, tmp_path):
        from predictionio_tpu.obs.incidents import list_bundles as jlist, load_bundle as jload

        store = _store(tmp_path)
        path = store.publish("manual", parts={"p": [1, 2]})
        bundle_id = os.path.basename(path)
        assert store.load(bundle_id[:10])["parts"]["p"] == [1, 2]
        assert jload(store.dir, bundle_id[:10]) == store.load(bundle_id)
        assert [r.bundle_id for r in jlist(store.dir)] == [bundle_id]
        dest = store.export(bundle_id, str(tmp_path / "out"))
        assert os.path.exists(os.path.join(dest, "manifest.json"))


# ---------------------------------------------------------------------------
# ProfileSession
# ---------------------------------------------------------------------------


class TestProfileSession:
    def test_clamp_ms_rails(self, tmp_path):
        from predictionio_tpu.obs.profiler import ProfileSession as JSession

        for cls in (JSession, ProfileSession):
            s = cls(_store(tmp_path), default_ms=500, max_ms=2000)
            assert [s.clamp_ms(v) for v in (None, -5, 99999, 30)] == [500, 0, 2000, 30]

    def test_capture_host_only_bundle(self, tmp_path):
        path = ProfileSession(_store(tmp_path), device="cpu").capture(ms=0, parts={"stacks": {"roles": {}}})
        manifest = _manifest(path)
        assert manifest["context"]["durationMs"] == 0 and manifest["trace"] == []
        assert not os.path.isdir(os.path.join(path, "trace"))

    def test_capture_bounded_duration_in_manifest(self, tmp_path):
        path = ProfileSession(_store(tmp_path), device="cpu", max_ms=0).capture(ms=10_000)
        assert _manifest(path)["context"]["durationMs"] == 0

    def test_single_flight_is_process_wide(self, tmp_path):
        """Kineto keeps one profiler per process: a capture in flight on
        one session makes every session of the process busy."""
        a = ProfileSession(_store(tmp_path), device="cpu")
        b = ProfileSession(_store(tmp_path / "b"), device="cpu")
        assert a._flight.acquire(blocking=False)
        try:
            for s in (a, b):
                with pytest.raises(ProfileBusyError):
                    s.capture(ms=0)
        finally:
            a._flight.release()
        assert b.capture(ms=0)

    def test_context_fn_merged_and_guarded(self, tmp_path):
        s = ProfileSession(_store(tmp_path), device="cpu", context_fn=lambda: {"engine": "e9"})
        ctx = _manifest(s.capture(ms=0, context={"extra": 1}))["context"]
        assert ctx["engine"] == "e9" and ctx["extra"] == 1

        def boom():
            raise RuntimeError("no context for you")

        bad = ProfileSession(_store(tmp_path / "b"), device="cpu", context_fn=boom)
        assert "no context for you" in _manifest(bad.capture(ms=0))["context"]["contextError"]

    def test_capture_metrics_equal_the_jax_session(self, tmp_path):
        from predictionio_tpu.obs.metrics import MetricsRegistry as JRegistry
        from predictionio_tpu.obs.profiler import ProfileSession as JSession
        from predictionio_tpu.obs.profiler import ProfileStore as JStore

        texts = {}
        for pkg, reg_cls, sess_cls, store_cls in (("jax", JRegistry, JSession, JStore),
                                                  ("port", MetricsRegistry, ProfileSession, ProfileStore)):
            m = reg_cls()
            s = sess_cls(store_cls(str(tmp_path / pkg)), metrics=m)
            s.capture(ms=0)
            with s._flight:
                with pytest.raises(Exception) as info:
                    s.capture(ms=0)
                assert type(info.value).__name__ == "ProfileBusyError"
            texts[pkg] = m.render_prometheus()
        assert texts["jax"] == texts["port"]
        assert 'pio_profile_captures_total{trigger="manual"} 1' in texts["port"]
        assert "pio_profile_capture_busy_total 1" in texts["port"]

    def test_capture_alert_rate_limited_per_trigger(self, tmp_path):
        clock = [100.0]
        s = ProfileSession(_store(tmp_path), device="cpu", alert_min_interval_s=60.0, clock=lambda: clock[0])
        assert s.capture_alert("slo-alert", context={"n": 1}) is not None
        clock[0] += 10.0
        assert s.capture_alert("slo-alert", context={"n": 2}) is None
        assert s.capture_alert("breaker-trip", context={"n": 3}) is not None
        clock[0] += 60.0
        assert s.capture_alert("slo-alert", context={"n": 4}) is not None
        assert len(s.store.list()) == 3

    def test_capture_alert_never_raises(self, tmp_path, monkeypatch):
        s = ProfileSession(_store(tmp_path), device="cpu")
        monkeypatch.setattr(s.store, "publish", lambda *a, **k: (_ for _ in ()).throw(OSError("disk gone")))
        assert s.capture_alert("slo-alert") is None
        s2 = ProfileSession(_store(tmp_path / "b"), device="cpu")
        with s2._flight:
            assert s2.capture_alert("slo-alert") is None

    def test_cpu_capture_writes_a_chrome_trace(self, tmp_path):
        s = ProfileSession(_store(tmp_path), device="cpu")
        x = torch.randn(64, 64)
        box = {}

        def work():
            while "path" not in box:
                x @ x

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            path = s.capture(ms=100)
        finally:
            box["path"] = True
            t.join(5)
        manifest = _manifest(path)
        assert [e["name"] for e in manifest["trace"]] == ["trace.json"]
        assert manifest["context"]["activities"] == ["cpu"] and manifest["context"]["durationMs"] == 100
        with open(os.path.join(path, "trace", "trace.json")) as fh:
            assert "traceEvents" in json.load(fh)
        assert trace_kernels(os.path.join(path, "trace")) == {}

    def test_a_card_capture_without_a_card_is_an_error_not_a_bundle(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        s = ProfileSession(_store(tmp_path), device="cuda", metrics=MetricsRegistry())
        with pytest.raises(ProfileCaptureError):
            s.capture(ms=10)
        assert s.store.list() == [] and s._m_errors.value() == 1.0

    def test_warm_up_pays_the_set_up_ahead_and_never_raises(self, tmp_path, monkeypatch):
        import predictionio_tpu_torch.obs.profiler as prof

        assert ProfileSession(_store(tmp_path), device="cpu").ready
        monkeypatch.setattr(prof, "_CUDA_READY", threading.Event())
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        card = ProfileSession(_store(tmp_path / "c"), device="cuda")
        assert not card.ready
        card.warm_up()  # no card: logged, not raised, the lock released
        assert not card.ready and not card._flight.locked()
        monkeypatch.setattr("predictionio_tpu_torch.obs.profiler._DeviceTrace",
                            type("T", (), {"__init__": lambda self, d, dev: setattr(self, "timings", {}),
                                           "start": lambda self: None, "stop": lambda self: None}))
        card.warm_up()
        assert card.ready and not card._flight.locked() and card.store.list() == []
        # once per process: every session on a card is ready from then on
        assert ProfileSession(_store(tmp_path / "d"), device="cuda").ready

    def test_launches_are_counted_inside_the_open_window(self, tmp_path):
        """``launchesCounted`` covers exactly the time ``capturing`` is
        true, between the trace's start and its stop."""
        counts = {"spd_cg": 0}
        seen_outside, stop = [], threading.Event()
        s = ProfileSession(_store(tmp_path), device="cpu", counters_fn=lambda: dict(counts))

        def launcher():
            while not stop.is_set():
                if s.capturing:
                    counts["spd_cg"] += 1
                else:
                    seen_outside.append(1)
                time.sleep(0.001)

        t = threading.Thread(target=launcher, daemon=True)
        t.start()
        try:
            path = s.capture(ms=100)
        finally:
            stop.set()
            t.join(5)
        counted = _manifest(path)["context"]["launchesCounted"]["spd_cg"]
        assert 0 < counted <= counts["spd_cg"] and not s.capturing
        assert counts["spd_cg"] - counted <= 1  # a launch at the window's far edge

    def test_kernel_launches_match_demangled_symbols(self, tmp_path):
        trace = tmp_path / "trace.json"
        name = ("void (anonymous namespace)::spd_cg_registers<32, 8, true>(float const*, float const*, "
                "float*, long long, int, int, bool)")
        events = [{"cat": "kernel", "name": name}] * 3 + [
            {"cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>(int)"},
            {"cat": "cpu_op", "name": "aten::mm"}]
        trace.write_text(json.dumps({"traceEvents": events}))
        kernels = trace_kernels(str(trace))
        assert kernel_launches(kernels, "spd_cg_registers") == 3
        assert kernel_launches(kernels, "spd_cg_shared") == 0
        assert sum(kernels.values()) == 4

    def test_maybe_profile_train_gate(self, tmp_path, monkeypatch):
        monkeypatch.delenv("PIO_PROFILE_DIR", raising=False)
        with maybe_profile_train(device="cpu") as box:
            assert box is None
        monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
        with maybe_profile_train(context={"engine": "e1"}, parts_fn=lambda: {"xray": {"ok": 1}},
                                 device="cpu") as box:
            torch.randn(32, 32) @ torch.randn(32, 32)
        manifest = _manifest(box["path"])
        assert manifest["trigger"] == "train" and manifest["context"]["engine"] == "e1"
        assert "xray" in manifest["parts"] and manifest["trace"]


# ---------------------------------------------------------------------------
# HostSampler with the port's thread roles
# ---------------------------------------------------------------------------


class TestHostSampler:
    def test_role_attribution_names_the_ports_threads(self):
        s = HostSampler()
        assert [s.role_of(n) for n in ("pio-handler", "pio-collect", "pio-dispatch_0", "pio-fetch_3",
                                       "pio-finish_0", "pio-shadow_0", "pio-sniffer_0", "pio-bg-http_1",
                                       "pio-http", "pio-events", "pio-stream-x", "MainThread",
                                       "random-thread")] == [
            "http-handler", "collect", "dispatch", "fetch", "finish", "shadow", "sniffer", "feedback",
            "http-listener", "http-listener", "stream", "main", "other"]

    def test_planted_busy_thread_shows_in_folded_stacks(self):
        stop, t = _busy_thread("pio-fetch_0")
        try:
            s = HostSampler()
            for _ in range(10):
                s.sample_once()
        finally:
            stop.set()
            t.join(timeout=2.0)
        fetch = [ln for ln in s.folded().splitlines() if ln.startswith("fetch;")]
        assert fetch and "test_torch_profiler" in fetch[0].rsplit(" ", 1)[0]

    def test_snapshot_hotspots_and_bounds(self):
        stop1, t1 = _busy_thread("pio-fetch_a")
        stop2, t2 = _busy_thread("pio-dispatch_b")
        try:
            s = HostSampler(max_stacks=1)
            for _ in range(4):
                s.sample_once()
        finally:
            stop1.set(), stop2.set()
            t1.join(timeout=2.0), t2.join(timeout=2.0)
        snap = s.snapshot()
        assert snap["samples"] == 4 and snap["truncated"] >= 1
        assert any(k.endswith("<other>") for k in snap["stacks"])
        assert s.hotspots(top_n=2)

    def test_start_stop_idempotent_and_never_samples_itself(self):
        s = HostSampler(period_s=0.005)
        s.start()
        s.start()
        assert s.running
        time.sleep(0.1)
        s.stop()
        s.stop()
        assert not s.running
        assert not any(k.startswith("sampler;") for k in s._merged())

    def test_overhead_under_one_percent_at_default_period(self):
        stop, t = _busy_thread("pio-dispatch_load")
        s = HostSampler()
        s.start()
        try:
            time.sleep(2.0)
        finally:
            s.stop()
            stop.set()
            t.join(timeout=2.0)
        assert s.snapshot()["samples"] >= 10
        assert s.overhead_frac() < 0.01

    def test_period_stretches_to_keep_the_budget_with_many_threads(self):
        """A pass over many threads costs more: the port's sampler waits
        longer after it, so its share stays near the 1 % budget."""
        stop = threading.Event()

        def deep(n):  # a handler-like thread parked 30 frames down
            return deep(n - 1) if n else stop.wait()

        threads = [threading.Thread(target=deep, args=(30,), name=f"pio-handler-{k}", daemon=True)
                   for k in range(300)]
        for t in threads:
            t.start()
        s = HostSampler(period_s=0.001)  # a fixed 1 ms period would sample most of the time
        default = HostSampler()  # 20 Hz: a cheap pass keeps the period, a dear one stretches it
        assert default.next_wait(0.0001) == 0.05 and default.next_wait(0.02) == pytest.approx(1.98)
        s.start()
        try:
            time.sleep(2.5)
        finally:
            s.stop()
            stop.set()
            for t in threads:
                t.join(timeout=2.0)
        # a pass walks 16 of the 300 handler threads, rotating: passes stay
        # cheap, and the period stretches only when one was dear
        snap = s.snapshot()
        assert snap["samples"] >= 1 and snap["roles"]["http-handler"] <= 16 * snap["samples"]
        assert s.overhead_frac() < 0.05

    def test_metrics_registered(self):
        m = MetricsRegistry()
        HostSampler(metrics=m).sample_once()
        text = m.render_prometheus()
        assert "pio_profile_sampler_samples_total 1" in text
        assert "pio_profile_sampler_overhead_frac" in text and "pio_profile_sampler_stacks" in text


# ---------------------------------------------------------------------------
# the query server's /profile/* routes and profile-on-alert
# ---------------------------------------------------------------------------


class TestQueryServerProfileEndpoints:
    def test_capture_roundtrip_host_only_as_the_jax_server(self, tmp_path):
        out = {}
        for pkg in PACKAGES:
            with query_server(pkg, profile_dir=str(tmp_path / pkg)) as (port, server, _):
                status, _, body = call(port, "POST", "/profile/capture?ms=0")
                manifest = _manifest(body["path"])
                out[pkg] = (status, body["durationMs"], body["modelVersion"] == server.model_version,
                            {k: manifest["context"][k] for k in ("engine", "modelVersion", "instanceId")},
                            manifest["parts"], len(server.profiler.store.list()))
        assert out["jax"] == out["port"]
        assert out["port"][4] == ["stacks", "waterfall"]

    def test_bad_ms_is_400_and_busy_is_409(self, tmp_path):
        out = {}
        for pkg in PACKAGES:
            with query_server(pkg, profile_dir=str(tmp_path / pkg)) as (port, server, _):
                bad = call(port, "POST", "/profile/capture?ms=banana")[0]
                assert server.profiler._flight.acquire(blocking=False)
                try:
                    busy = call(port, "POST", "/profile/capture?ms=0")
                finally:
                    server.profiler._flight.release()
                out[pkg] = bad, busy[0], busy[2]
        assert out["jax"] == out["port"] == (400, 409, {"message": "a profile capture is already in flight"})

    def test_cpu_device_capture_over_http(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            status, _, body = call(port, "POST", "/profile/capture?ms=50")
        assert status == 200 and body["durationMs"] == 50 and body["kernels"] == {}
        assert [e["name"] for e in _manifest(body["path"])["trace"]] == ["trace.json"]

    def test_stacks_folded_and_json(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            stop, t = _busy_thread("pio-fetch_ep")
            try:
                for _ in range(3):
                    server.sampler.sample_once()
            finally:
                stop.set()
                t.join(timeout=2.0)
            status, _, text = call(port, "GET", "/profile/stacks")
            _, _, data = call(port, "GET", "/profile/stacks?format=json")
        assert status == 200 and ";" in text
        assert data["samples"] >= 3 and "hotspots" in data and "overheadFrac" in data

    def test_handler_threads_are_attributed(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path), sampler_period_s=0.005) as (port, server, _):
            for i in range(20):
                call(port, "POST", "/queries.json", {"qid": i})
            roles = server.sampler.snapshot()["roles"]
        assert roles.get("http-listener", 0) >= 1 and roles.get("collect", 0) >= 1

    def test_profile_on_alert_bundle_contains_offending_stacks(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            stop, t = _busy_thread("pio-fetch_hot")
            try:
                for _ in range(5):
                    server.sampler.sample_once()
                server._profile_on_alert("slo-alert", {"slo": "latency"})
                deadline = time.monotonic() + 5.0
                while not server.profiler.store.list() and time.monotonic() < deadline:
                    time.sleep(0.02)
            finally:
                stop.set()
                t.join(timeout=2.0)
            refs = server.profiler.store.list()
            bundle = server.profiler.store.load(refs[-1].bundle_id)
        assert bundle["manifest"]["trigger"] == "slo-alert" and bundle["manifest"]["context"]["slo"] == "latency"
        assert any(ln.startswith("fetch;") for ln in bundle["texts"]["stacks_folded"].splitlines())

    def test_slo_transition_fires_once_per_edge(self, tmp_path, monkeypatch):
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            fired = []
            monkeypatch.setattr(server, "_profile_on_alert", lambda trig, ctx: fired.append((trig, ctx["slo"])))
            reports = [{"name": "avail", "alerting": False}]
            monkeypatch.setattr(server.slo, "evaluate", lambda: reports)
            server._check_slo_alerts()
            reports[0] = {"name": "avail", "alerting": True}
            server._check_slo_alerts()
            server._check_slo_alerts()
            assert fired == [("slo-alert", "avail")]
            reports[0] = {"name": "avail", "alerting": False}
            server._check_slo_alerts()
            reports[0] = {"name": "avail", "alerting": True}
            server._check_slo_alerts()
            assert len(fired) == 2

    def test_candidate_breaker_trip_captures_a_bundle(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path), candidate_breaker_threshold=1) as (port, server, _):
            server.candidate_breaker.record_failure()
            deadline = time.monotonic() + 5.0
            while not server.profiler.store.list() and time.monotonic() < deadline:
                time.sleep(0.02)
            refs = server.profiler.store.list()
        assert [r.trigger for r in refs] == ["breaker-trip"]

    def test_profile_on_alert_disabled_by_config(self, tmp_path):
        with query_server("port", profile_dir=str(tmp_path), profile_on_alert=False) as (port, server, _):
            server._profile_on_alert("slo-alert", {"slo": "x"})
            time.sleep(0.1)
            assert server.profiler.store.list() == []


# ---------------------------------------------------------------------------
# the CLI: profile, incidents, doctor
# ---------------------------------------------------------------------------


class TestProfileCLI:
    def test_profile_list_empty(self, tmp_path, capsys):
        assert cli.main(["profile", "list", "--profile-dir", str(tmp_path / "none")]) == 0
        assert "No profile bundles" in capsys.readouterr().out

    def test_profile_list_show_export(self, tmp_path, capsys):
        store = _store(tmp_path)
        raw = tmp_path / "raw"
        raw.mkdir()
        (raw / "trace.json").write_text(json.dumps({"traceEvents": [
            {"cat": "kernel", "name": "void (anonymous namespace)::flash_attention_kernel<1>(float const*)"}] * 2}))
        path = store.publish("manual", context={"modelVersion": "v7"}, parts={"stacks": {"roles": {"fetch": 3}}},
                             texts={"stacks_folded": "fetch;f 3\n"}, trace_dir=str(raw))
        bundle_id = os.path.basename(path)
        assert cli.main(["profile", "list", "--profile-dir", store.dir]) == 0
        out = capsys.readouterr().out
        assert bundle_id in out and "manual" in out
        assert cli.main(["profile", "show", bundle_id[:12], "--profile-dir", store.dir]) == 0
        out = capsys.readouterr().out
        for needle in ("trigger   manual", "v7", "stacks.json", "stacks_folded.txt", "trace     trace.json",
                       "flash_attention_kernel"):
            assert needle in out
        dest = str(tmp_path / "exported")
        assert cli.main(["profile", "export", bundle_id, dest, "--profile-dir", store.dir]) == 0
        assert os.path.exists(os.path.join(dest, bundle_id, "manifest.json"))

    def test_profile_show_json_and_missing(self, tmp_path, capsys):
        store = _store(tmp_path)
        path = store.publish("manual", parts={"p": 1})
        assert cli.main(["profile", "show", os.path.basename(path), "--profile-dir", store.dir, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["manifest"]["trigger"] == "manual"
        assert cli.main(["profile", "show", "zzz-nope", "--profile-dir", store.dir]) == 1

    def test_profile_serve_unreachable_is_one_line_error(self, capsys):
        assert cli.main(["profile", "serve", "--url", "http://127.0.0.1:1", "--timeout", "0.2"]) == 1
        assert "unreachable" in capsys.readouterr().err

    def test_profile_serve_against_a_live_server(self, tmp_path, capsys):
        with query_server("port", profile_dir=str(tmp_path)) as (port, server, _):
            assert cli.main(["profile", "serve", "--url", f"http://127.0.0.1:{port}", "--ms", "0"]) == 0
        assert json.loads(capsys.readouterr().out)["durationMs"] == 0

    def test_profile_dir_env_fallback(self, tmp_path, monkeypatch, capsys):
        store = _store(tmp_path)
        store.publish("train", context={})
        monkeypatch.setenv("PIO_PROFILE_DIR", store.dir)
        assert cli.main(["profile", "list"]) == 0
        assert "train" in capsys.readouterr().out

    def test_profile_train_wraps_the_train_verb(self, tmp_path, capsys, monkeypatch):
        from tests.test_torch_train_options import _rate_events
        from tests.torch_template_helpers import REPO, write_events

        monkeypatch.delenv("PIO_PROFILE_DIR", raising=False)
        home, engine_dir = tmp_path / "home", tmp_path / "engine"
        engine_dir.mkdir()
        variant = json.loads((REPO / "predictionio_tpu_torch/models/recommendation/engine.json").read_text())
        variant["datasource"]["params"]["appName"] = "profapp"
        variant["algorithms"][0]["params"].update(rank=4, numIterations=2)
        (engine_dir / "engine.json").write_text(json.dumps(variant))
        events = write_events(tmp_path / "ev.jsonl", _rate_events())
        assert cli.main(["--home", str(home), "app", "new", "profapp"]) == 0
        assert cli.main(["--home", str(home), "import", "--appname", "profapp", "--input", str(events)]) == 0
        prof = str(tmp_path / "prof")
        assert cli.main(["--home", str(home), "profile", "train", "--profile-dir", prof, "--",
                         "--engine-dir", str(engine_dir), "--device", "cpu"]) == 0
        assert "Training completed" in capsys.readouterr().out
        (ref,) = ProfileStore(prof).list()
        manifest = _manifest(ref.path)
        assert manifest["trigger"] == "train" and manifest["context"]["instanceId"]
        assert manifest["context"]["engine"] and manifest["trace"]
        assert manifest["context"]["activities"] == ["cpu"]

    def test_incidents_verbs(self, tmp_path, capsys):
        from predictionio_tpu_torch.obs.incidents import IncidentRecorder

        obs = tmp_path / "obs"
        assert cli.main(["incidents", "list", "--obs-dir", str(obs)]) == 0
        assert "No incident bundles" in capsys.readouterr().out
        rec = IncidentRecorder(str(obs / "incidents"))
        path = rec.trigger("stream-drift", context={"engine": "e"}, texts={"log": "a\nb\nc\n"})
        bundle_id = os.path.basename(path)
        assert cli.main(["incidents", "list", "--obs-dir", str(obs)]) == 0
        assert "stream-drift" in capsys.readouterr().out
        assert cli.main(["incidents", "show", bundle_id[:10], "--obs-dir", str(obs), "--tail-lines", "2"]) == 0
        out = capsys.readouterr().out
        assert "  | b" in out and "  | c" in out and "  | a" not in out
        assert cli.main(["incidents", "export", bundle_id, str(tmp_path / "x"), "--obs-dir", str(obs)]) == 0

    def test_doctor_inventory_on_the_cpu_and_without_a_card(self, capsys):
        assert cli.main(["doctor", "--device", "cpu"]) == 0
        assert "device: cpu" in capsys.readouterr().out
        if not torch.cuda.is_available():
            assert cli.main(["doctor"]) == 1  # the default device is the card

    def test_doctor_roofline_prints_the_kernel_tables_bounds(self, capsys):
        assert cli.main(["doctor", "--roofline"]) == 0
        out = capsys.readouterr().out
        report = json.loads(out[: out.index("\nbound ")])
        assert set(report["families"]) == {"topk", "ann", "als", "twotower", "kernels"}
        assert all(math.isfinite(f["arithmeticIntensity"]) for f in report["families"].values())
        bounds = [ln for ln in out.splitlines() if ln.startswith("bound ")]
        # PERF.md's kernel table: B1 at n = 138,001, f = 32 and B3 at [64, 1, 1024, 32]
        assert any("spd_cg" in ln and '"n": 138001' in ln and "0.182573 ms, operations" in ln for ln in bounds)
        assert any("flash_attention" in ln and "0.0086121 ms, operations" in ln for ln in bounds)
        assert cli.main(["doctor", "--roofline", "--families", "nope"]) == 1


# ---------------------------------------------------------------------------
# TestCapacityPlanner counterparts: equal to the JAX numbers
# ---------------------------------------------------------------------------


class TestCapacityPlanner:
    @pytest.mark.parametrize("args", [(138_000, 27_000, 32, "f32", None), (6_040, 3_706, 160, "bf16", 1_000_209),
                                      (10, 10, 4, "f32", 5), (0, 7, 1, "f32", None)])
    def test_estimate_factors_equals_the_jax_planner(self, args):
        from predictionio_tpu.obs import xray as jxray

        users, items, k, dtype, nnz = args
        for gather in ("f32", "bf16"):
            assert (xray.estimate_factors(users, items, k, dtype, nnz=nnz, gather_dtype=gather).to_json_dict()
                    == jxray.estimate_factors(users, items, k, dtype, nnz=nnz, gather_dtype=gather).to_json_dict())

    @pytest.mark.parametrize("args", [(27_000, 32, 2048, 16, False), (27_000, 32, 0, 0, True),
                                      (100_000, 32, 0, 0, False), (50, 8, 4, 2, True)])
    def test_estimate_ann_equals_the_jax_planner(self, args):
        from predictionio_tpu.obs import xray as jxray

        items, dim, clusters, nprobe, q8 = args
        assert (xray.estimate_ann(items, dim, clusters, nprobe, quantize_int8=q8)
                == jxray.estimate_ann(items, dim, clusters, nprobe, quantize_int8=q8))

    def test_sharding_divides_and_the_gather_transient_adds(self):
        one = xray.estimate_factors(10_000, 5_000, 32)
        eight = xray.estimate_factors(10_000, 5_000, 32, mesh=8)
        assert eight.per_device_bytes < one.per_device_bytes and eight.n_devices == 8
        with pytest.raises(ValueError):
            xray.estimate_factors(-1, 10, 4)

    def test_doctor_capacity_equals_the_jax_doctor(self, capsys):
        from predictionio_tpu.tools import cli as jax_cli

        argv = ["doctor", "--capacity", "138000", "27000", "32", "--ann", "2048,16", "--nnz", "20000000"]
        outs = []
        for main in (jax_cli.main, cli.main):
            assert main(argv) == 0
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1]
        assert cli.main([*argv, "--hbm-bytes", "100MB"]) == 1
        capsys.readouterr()
        assert cli.main([*argv, "--hbm-bytes", "80GB"]) == 0
        assert "fits:" in capsys.readouterr().out

    def test_estimate_within_15pct_of_the_tables_torch_allocates(self):
        """The factor-table term against the bytes of the tables the port's
        ALS holds (CPU tensors of the same shapes)."""
        users, items, k = 3_000, 1_500, 16
        est = xray.estimate_factors(users, items, k)
        tables = [torch.zeros(users + 1, k), torch.zeros(items + 1, k)]
        measured = sum(t.numel() * t.element_size() for t in tables)
        assert abs(est.factor_bytes - measured) <= 0.15 * measured

    def test_device_memory_readings_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        assert xray.device_memory_stats() is None
        assert xray.live_bytes_per_device() == {} and xray.live_array_bytes() == 0


# ---------------------------------------------------------------------------
# telemetry ring and incident recorder, read by the JAX package
# ---------------------------------------------------------------------------


class TestTelemetryRingAndIncidents:
    def test_ring_matches_the_jax_ring(self, tmp_path):
        from predictionio_tpu.obs.tsring import TelemetryRing as JRing
        from predictionio_tpu_torch.obs.tsring import TelemetryRing

        out = {}
        for pkg, cls in (("jax", JRing), ("port", TelemetryRing)):
            ring = cls(str(tmp_path / pkg), segment_records=4, segments=3, writer_id="stream")
            for i in range(11):
                ring.append({"t": 100.0 + i, "i": i})
            ring.close()
            reopened = cls(str(tmp_path / pkg), segment_records=4, segments=3, writer_id="stream")
            seq = reopened.append({"t": 200.0, "i": 11})
            out[pkg] = (seq, [(r["seq"], r["i"]) for r in reopened.records()],
                        [r["i"] for r in reopened.window(seconds=5, now=110.5)], reopened.approx_count,
                        sorted(os.listdir(tmp_path / pkg)))
        assert out["jax"] == out["port"]
        # each package reads the other's ring
        assert [r["i"] for r in JRing(str(tmp_path / "port"), segment_records=4, segments=3).records()] == \
            [r["i"] for r in TelemetryRing(str(tmp_path / "jax"), segment_records=4, segments=3).records()]

    def test_incident_bundles_match_and_cross_read(self, tmp_path):
        from predictionio_tpu.obs.incidents import IncidentRecorder as JRecorder
        from predictionio_tpu.obs.incidents import load_bundle as jload
        from predictionio_tpu.obs.metrics import MetricsRegistry as JRegistry
        from predictionio_tpu_torch.obs.incidents import IncidentRecorder, load_bundle

        out = {}
        for pkg, cls, reg in (("jax", JRecorder, JRegistry()), ("port", IncidentRecorder, MetricsRegistry())):
            clock = [0.0]
            rec = cls(str(tmp_path / pkg), metrics=reg, min_interval_s=10.0, max_bundles=2,
                      clock=lambda: clock[0])
            rec.add_source("ring", lambda: [{"kind": "drift"}])
            rec.add_source("boom", lambda: 1 / 0)
            fired = [rec.trigger("stream-drift", context={"n": 0}) is not None,
                     rec.trigger("stream-drift", context={"n": 1}) is not None,
                     rec.trigger("breaker-trip", context={"n": 2}) is not None]
            clock[0] = 11.0
            fired.append(rec.trigger("stream-drift", context={"n": 3}, texts={"tail": "x\n"}) is not None)
            refs = sorted(os.listdir(tmp_path / pkg))
            bundles = sorted((load_bundle(str(tmp_path / pkg), r) for r in refs),
                             key=lambda b: b["manifest"]["context"]["n"])
            out[pkg] = (fired, [(b["manifest"]["trigger"], b["manifest"]["context"], b["parts"], b["texts"])
                                for b in bundles], reg.render_prometheus())
            for r in refs:  # the JAX reader reads the port's bundles
                assert jload(str(tmp_path / pkg), r) == load_bundle(str(tmp_path / pkg), r)
        assert out["jax"][:2] == out["port"][:2]
        assert out["jax"][2] == out["port"][2]

    def test_stream_drift_breach_signals_ring_and_incident_as_the_jax_pipeline(self, tmp_path):
        """A breached drift guard: one kind="drift" record on the ring and
        one stream-drift incident, in both packages' pipelines."""
        from predictionio_tpu.obs.tsring import TelemetryRing as JRing
        from predictionio_tpu_torch.obs.incidents import IncidentRecorder
        from predictionio_tpu_torch.obs.tsring import TelemetryRing
        from predictionio_tpu_torch.stream import CursorStore, EventTailer, StreamConfig, StreamPipeline
        from tests import test_stream as jt
        from tests import test_torch_stream as pt

        class Incidents:
            def __init__(self):
                self.calls = []

            def trigger(self, kind, context=None, texts=None):
                self.calls.append((kind, context))

        # JAX
        jl = jt._levents()
        jl.init(jt.APP)
        for i in range(4):
            jl.insert(jt.rate_event(f"u{i}", "i0", 3.0, i), jt.APP)
        jtrainer = jt.RecordingTrainer()
        jtrainer.ok = False
        jring, jinc = JRing(str(tmp_path / "jax"), writer_id="stream"), Incidents()
        jpipe, _, _ = jt._pipeline(tmp_path / "j", jl, jtrainer, ring=jring, incidents=jinc)
        jsum = jpipe.run_once()
        # port
        pl = pt._filled(4)
        ptrainer = pt.RecordingTrainer()
        ptrainer.ok = False
        pring = TelemetryRing(str(tmp_path / "port"), writer_id="stream")
        pinc = Incidents()
        ppipe_args = pt._pipeline(tmp_path / "p", pl, ptrainer)
        store = ppipe_args[1]
        ppipe = StreamPipeline(EventTailer(pl, pt.APP, batch_limit=5), ptrainer,
                               CursorStore(str(tmp_path / "pc")), store,
                               StreamConfig(engine_id="streameng", publish_min_events=1), ring=pring,
                               incidents=pinc)
        psum = ppipe.run_once()
        assert jsum["driftSuppressed"] is psum["driftSuppressed"] is True

        def strip(r):
            return {k: v for k, v in r.items() if k != "t"}

        assert [strip(r) for r in pring.records()] == [strip(r) for r in jring.records()]
        assert pinc.calls == jinc.calls and len(pinc.calls) == 1
        spans = [s for s in ppipe.tracer.recent(50) if s["name"] in ("stream.foldin", "stream.publish")]
        assert {"stream.foldin", "stream.publish"} <= {s["name"] for s in spans}
        assert next(s for s in spans if s["name"] == "stream.publish")["status"] == "drift-suppressed"
        # and a real recorder writes the bundle `pio incidents` reads
        from predictionio_tpu_torch.obs.incidents import list_bundles

        rec = IncidentRecorder(str(tmp_path / "obs" / "incidents"))
        ppipe.incidents = rec
        ppipe._signal_drift(ptrainer.drift())
        assert [r.trigger for r in list_bundles(rec.dir)] == ["stream-drift"]


# ---------------------------------------------------------------------------
# the analytic cost model against XLA's cost_analysis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xla_costs():
    from predictionio_tpu.obs import costmodel as jcm

    return {fam: {c["kernel"]: c for c in jcm.FAMILY_BUILDERS[fam]()[0]} for fam in ("topk", "als")}


class TestCostModel:
    def test_topk_operations_and_bytes_against_xla(self, xla_costs):
        """Operations within 512 of XLA's: XLA adds a few hundred for
        top-k's compares and index bookkeeping (319 at these shapes), which
        the analytic count leaves out. Bytes: the analytic count is each input
        read once and each output written once, exactly the JAX model's
        argBytes + outBytes (XLA's own "bytes accessed" also counts the
        [b, n] score matrix it materialises, so it is not compared)."""
        port = {c["kernel"]: c for c in costmodel.topk_costs()[0]}
        assert set(port) == set(xla_costs["topk"])
        for name, x in xla_costs["topk"].items():
            assert abs(port[name]["flops"] - x["flops"]) <= 512, name
            assert port[name]["argBytes"] + port[name]["outBytes"] == x["argBytes"] + x["outBytes"], name

    def test_als_counts_against_xla(self, xla_costs):
        """XLA's cost analysis counts a while loop's body once; the CG
        solve runs f + 4 steps of it. So XLA's operations are a floor of
        the analytic count and at most f + 4 steps below it. The solve's
        bytes (A and b read, x written) equal the JAX model's."""
        port = {c["kernel"]: c for c in costmodel.als_costs()[0]}
        solve, xsolve = port["spd_solve_cg"], xla_costs["als"]["spd_solve_cg"]
        f = 16
        assert xsolve["flops"] <= solve["flops"] <= (f + 4) * xsolve["flops"]
        assert solve["argBytes"] + solve["outBytes"] == xsolve["argBytes"] + xsolve["outBytes"]
        step, xstep = port["als_step"], xla_costs["als"]["als_step"]
        assert xstep["flops"] <= step["flops"] <= (f + 4) * xstep["flops"]

    @pytest.mark.parametrize("family", sorted(costmodel.FAMILY_BUILDERS))
    def test_family_finite(self, family):
        entry = costmodel.analyze(families=[family])["families"][family]
        assert entry["totalFlops"] > 0 and math.isfinite(entry["arithmeticIntensity"])
        for k in entry["kernels"]:
            assert k["bound"] in ("compute", "memory") and k["modelTimeS"] > 0

    def test_bench_fields_flat_and_finite(self):
        fields = costmodel.bench_fields()
        assert fields["roofline_device"] == "h100-sxm"
        assert all(math.isfinite(v) for k, v in fields.items() if k != "roofline_device")

    def test_kernel_bounds_are_the_tables(self):
        """PERF.md's kernel table: B1 at the ML-20M users, B2 at two-tower
        training (bytes) and the sequential context 200 (bytes, one tensor
        as q, k and v), B3 at context 1024 (exponentials)."""
        ms, what, _ = costmodel.bound_ms(costmodel.spd_cg_cost(138_001, 32))
        assert (round(ms, 3), what) == (0.183, "operations")
        ms, what, _ = costmodel.bound_ms(costmodel.attention_cost(4096, 2, 256, 256, 32, False))
        assert (round(ms, 3), what) == (0.321, "bytes")
        ms, what, _ = costmodel.bound_ms(costmodel.attention_cost(64, 1, 200, 200, 32, True, shared_qkv=True))
        assert (round(ms, 5), what) == (0.00098, "bytes")
        ms, what, terms = costmodel.bound_ms(costmodel.attention_cost(64, 1, 1024, 1024, 32, True, shared_qkv=True))
        assert (round(ms, 4), what) == (0.0086, "operations") and max(terms, key=terms.get) == "exponentials"

    def test_kernel_build_watcher_and_timed_fetch(self):
        from predictionio_tpu_torch.obs.torchprof import KernelBuildWatcher, timed_fetch
        from predictionio_tpu_torch.ops import _build

        m = MetricsRegistry()
        watcher = KernelBuildWatcher(m)
        m.register_collector(watcher.sample)
        saved = dict(_build.build_counts)
        try:
            _build.build_counts["spd_cg"] = (1, 12.5)
            text = m.render_prometheus()
        finally:
            _build.build_counts.clear()
            _build.build_counts.update(saved)
        assert 'pio_kernel_builds_total{kernel="spd_cg"} 1' in text
        assert "pio_kernel_build_seconds_total 12.5" in text
        out = timed_fetch([torch.ones(3), torch.zeros(2)], m, where="test")
        assert [t.tolist() for t in out] == [[1.0, 1.0, 1.0], [0.0, 0.0]]
        assert m.get("pio_device_fetch_seconds").summary()["count"] == 1
