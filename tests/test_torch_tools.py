"""The port's operator tools held to the JAX package's: ``pio top``'s parser,
digest and renderers (``tools/top.py``) on ``/metrics`` text scraped from
both query servers after one scripted bandit rollout and on the same
status files and ring records, ``pio top --once --json`` against both
servers, the admin API (``tools/admin_api.py``, a standard-library server)
against the aiohttp one on the same requests, and the dashboard's page and
result routes (``tools/dashboard.py``)."""

from __future__ import annotations

import datetime as dt
import json
import os
import shutil
import socket
import time

import pytest

from tests.test_torch_bandit import (
    APP_NAME,
    ENGINE,
    V2,
    _jax_event,
    _jax_server,
    _port_event,
    _port_server,
    _registry_template,
    _storage,
)
from tests.torch_serving_helpers import MEMORY_ENV, aiohttp_served, call

UTC = dt.timezone.utc


def _top(which: str):
    if which == "jax":
        import predictionio_tpu.tools.top as top
    else:
        import predictionio_tpu_torch.tools.top as top
    return top


@pytest.fixture(autouse=True)
def _frozen_clock(monkeypatch):
    """The renderers stamp the wall clock; both read time.strftime."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")


def _drive(server, port, tick, levents, app_id, mk_event, n_queries=40):
    """Queries with trace ids, a reward for every other candidate answer,
    one bake tick: the bandit engaged and exploring, every family live."""
    n = 0
    for i in range(n_queries):
        trace = f"{i:016x}"
        call(port, "POST", "/queries.json", {"qid": i, "user": f"u{i}"}, headers={"X-Pio-Trace-Id": trace})
        hit = server.bandit.impressions.peek(trace)
        if hit is not None and i % 2 == 0:
            n += 1
            levents.insert(mk_event("reward", trace, n), app_id)
    call(port, "POST", "/queries.json", {"user": "bad"})  # a 400: a non-2xx status series
    tick()


@pytest.fixture(scope="module")
def scraped(tmp_path_factory):
    """(first, second) /metrics texts of each package's query server: the
    scripted rollout between them; plus `pio top --once --json` of both
    CLIs against each server at the second scrape's state."""
    import contextlib
    import io

    from predictionio_tpu.tools.cli import main as jax_main
    from predictionio_tpu_torch.tools.cli import main as port_main

    tmp = tmp_path_factory.mktemp("scraped")
    out = {}
    for pkg in ("jax", "port"):
        reg = str(tmp / f"registry-{pkg}")
        shutil.copytree(_registry_template(tmp), reg)
        storage = _storage(pkg)
        app_id = storage.get_meta_data_apps().get_by_name(APP_NAME).id
        make, mk_event = (_jax_server, _jax_event) if pkg == "jax" else (_port_server, _port_event)
        server, tag_lane = make(storage, reg, bandit_min_pulls=50, bandit_epsilon=0.3, sampler_period_s=0)
        server.stage_candidate_lane(tag_lane(V2), fraction=0.5)

        def scrape_and_top(port):
            texts = [call(port, "GET", "/metrics")[2]]
            _drive(server, port, tick, storage.get_l_events(), app_id, mk_event)
            texts.append(call(port, "GET", "/metrics")[2])
            tops = {}
            for cli, main in (("jax", jax_main), ("port", port_main)):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert main(["top", "--once", "--json", "--url", f"http://127.0.0.1:{port}"]) == 0
                tops[cli] = json.loads(buf.getvalue())
            return texts, tops

        if pkg == "jax":
            with aiohttp_served(server.make_app()) as (port, run, _):
                tick = lambda: run(server._rollout_tick())  # noqa: E731
                out[pkg] = scrape_and_top(port)
        else:
            port = server.start()
            tick = server._rollout_tick
            try:
                out[pkg] = scrape_and_top(port)
            finally:
                server.shutdown()
    return out


@pytest.mark.parametrize("server", ["jax", "port"])
def test_parse_summarize_and_render_equal_the_reference(server, scraped):
    """Each server's scrape through both packages' parser, digest (with
    rates against the first scrape) and screen."""
    (first, second), _ = scraped[server]
    got = {}
    for which in ("jax", "port"):
        top = _top(which)
        prev, cur = top.parse_prometheus(first), top.parse_prometheus(second)
        summary = top.summarize(cur, prev=prev, interval_s=2.0, now=1_700_000_000.0)
        got[which] = (prev, cur, summary, top.render(summary, "http://replica:8000"),
                      top.render_hotspots({"roles": {}, "overheadFrac": 0.0}),
                      top.format_number(1234.5678), top.format_bytes(3 * 2**30))
    assert got["port"] == got["jax"]
    summary = got["port"][2]
    assert summary["bandit"]["active"] is True
    assert summary["bandit"]["pulls"]["stable"] + summary["bandit"]["pulls"]["candidate"] == 40
    assert summary["bandit"]["matched_total"] > 0
    assert "bandit" in got["port"][3]


@pytest.mark.parametrize("server", ["jax", "port"])
def test_top_once_json_equal_against_both_servers(server, scraped):
    _, tops = scraped[server]
    assert {k: v for k, v in tops["port"].items() if k != "time"} == \
        {k: v for k, v in tops["jax"].items() if k != "time"}
    assert tops["port"]["bandit"]["active"] is True and tops["port"]["requests_total"] == 41


def test_the_two_servers_export_the_same_bandit_families(scraped):
    """The pio_bandit_* series of both servers after the same rollout."""
    top = _top("port")
    series = {}
    for pkg in ("jax", "port"):
        parsed = top.parse_prometheus(scraped[pkg][0][1])
        series[pkg] = {k: sorted((tuple(sorted(lab.items())), v) for lab, v in parsed[k])
                       for k in parsed if k.startswith("pio_bandit_")}
    assert series["port"] == series["jax"]
    assert len(series["port"]) == 12


STATUSES = {
    "lifecycle": [
        {"engine": "eng", "paused": True, "grid": {"state": "running", "stagedVersion": "", "error": ""},
         "policy": {"state": "tuning", "triggerReason": "cadence", "lastOutcome": "promoted"},
         "lastDecision": {"action": "hold", "reason": "tuning"}},
        {"engine": "eng", "paused": False, "grid": {"state": "failed", "error": "boom"},
         "policy": {"state": "tuning", "triggerReason": "drift"}},
        {"engine": "eng", "policy": {"state": "baking", "stagedVersion": "v000007", "triggerReason": "manual"}},
        {},
    ],
    "evalgrid": [
        {"state": "running", "metric": "PrecisionAtK", "pid": 7, "cellsDone": 3, "cellsTotal": 12,
         "cellsSkipped": 1, "cellsFailed": 0, "bestScore": 0.4321, "bestParams": 2, "etaS": 95.5,
         "folds": 3, "running": 2, "workers": 2},
        {"state": "done", "metric": "Accuracy", "cellsDone": 12, "cellsTotal": 12, "bestScore": None},
        {},
    ],
    "batchpredict": [
        {"state": "running", "engineId": "e", "source": "events", "pid": 9, "qps": 1234.5, "queries": 5000,
         "ok": 4990, "errors": 10, "batches": 10, "batchSize": 512,
         "phaseP50Ms": {"parse": 0.1, "supplement": 0.2, "dispatch": 1.5, "fetch": 3.25, "write": 0.5}},
        {"state": "done", "queries": 0},
        {},
    ],
}


@pytest.mark.parametrize("kind", sorted(STATUSES))
def test_status_renderers_and_loops_equal_the_reference(kind, tmp_path):
    got = {}
    for which in ("jax", "port"):
        top = _top(which)
        render = getattr(top, f"render_{kind}")
        run = getattr(top, f"run_{kind}_top")
        lines = [render(status) for status in STATUSES[kind]]
        path = str(tmp_path / "status.json")
        if os.path.exists(path):
            os.remove(path)
        for json_mode in (True, False):
            out: list[str] = []
            lines.append(run(path, iterations=1, json_mode=json_mode, out=out.append, sleep=lambda s: None))
            lines.extend(out)
        with open(path, "w") as fh:
            json.dump(STATUSES[kind][0], fh)
        for json_mode in (True, False):
            out = []
            lines.append(run(path, iterations=2, json_mode=json_mode, out=out.append, sleep=lambda s: None))
            lines.extend(out)
        got[which] = lines
    assert got["port"] == got["jax"]


def _history_records():
    t0 = 1_700_000_000.0
    recs = []
    for i in range(30):
        recs.append({"kind": "fleet", "t": t0 + i, "seq": i,
                     "gauges": {"queue_depth": float(i % 7), "inflight": float(i % 3)},
                     "counters": {"no_replica": float(i // 10)},
                     "replicas": {"r0": {"healthy": True}, "r1": {"healthy": i % 5 != 0}},
                     "slo": {"latency": {"burn": {"300": 0.5 * i, "3600": 0.1 * i}, "alerting": i > 25}}})
    recs.append({"kind": "scaling", "t": t0 + 12, "seq": 31, "action": "scale_up", "reason": "queue"})
    recs.append({"kind": "drift", "t": t0 + 20, "seq": 32, "guard": "holdout_rmse"})
    return recs


def test_history_renders_and_reads_the_ring_alike(tmp_path):
    from predictionio_tpu_torch.obs.tsring import TelemetryRing

    obs = tmp_path / "obs"
    ring = TelemetryRing(str(obs / "telemetry"), writer_id="fleet")
    for rec in _history_records():
        ring.append({k: v for k, v in rec.items() if k not in ("t", "seq")})
    got = {}
    for which in ("jax", "port"):
        top = _top(which)
        lines = [top.render_history(_history_records(), 600.0), top.render_history([], 600.0),
                 top.sparkline([1.0, 5.0, 2.0, 0.0, 9.0], width=4), top.sparkline([])]
        for kw in ({"obs_dir": str(obs)}, {"obs_dir": str(tmp_path / "nope")}, {}):
            out: list[str] = []
            lines.append(top.run_history(window_s=3600.0, out=out.append, **kw))
            lines.extend(out)
        got[which] = lines
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the admin API
# ---------------------------------------------------------------------------

_ADMIN_SCRIPT = [
    ("GET", "/", None),
    ("GET", "/cmd/app", None),
    ("POST", "/cmd/app", {"name": "a1"}),
    ("POST", "/cmd/app", {"name": "a1"}),
    ("POST", "/cmd/app", {}),
    ("POST", "/cmd/app", {"name": "a2", "id": 7, "description": "second"}),
    ("POST", "/cmd/app", {"name": "a3", "id": "x"}),
    ("POST", "/cmd/app", b"not json"),
    ("GET", "/cmd/app", None),
    ("DELETE", "/cmd/app/a1/data", None),
    ("DELETE", "/cmd/app/a1", None),
    ("DELETE", "/cmd/app/a1", None),
    ("DELETE", "/cmd/app/nope/data", None),
    ("GET", "/cmd/app", None),
    ("GET", "/cmd/models", None),
    ("GET", "/cmd/models/{key}", None),
    ("GET", "/cmd/models/nope", None),
    ("GET", "/nope", None),
    ("PUT", "/cmd/app", None),
    ("GET", "/cmd/app/a2", None),
]


def _mask_keys(body):
    """Access keys are random: keep their shape, not their value."""
    if isinstance(body, list):
        return [_mask_keys(b) for b in body]
    if isinstance(body, dict):
        out = {}
        for k, v in body.items():
            if k == "accessKey":
                out[k] = len(v)
            elif k == "accessKeys":
                out[k] = [len(x) for x in v]
            elif k == "registryDir":
                out[k] = os.path.basename(v)
            else:
                out[k] = _mask_keys(v)
        return out
    return body


def _admin_script(port, key):
    out = []
    for method, path, body in _ADMIN_SCRIPT:
        path = path.replace("{key}", key)
        if isinstance(body, bytes):
            status, _, answer = call(port, method, path, raw=body, headers={"Content-Type": "application/json"})
        else:
            status, _, answer = call(port, method, path, body)
        out.append((method, path, status, _mask_keys(answer)))
    return out


def test_admin_api_answers_as_the_aiohttp_one(tmp_path):
    """The same requests on the same registry and equal storages: equal
    statuses and JSON bodies (routes, 400/404/405/409, the registry
    inventory with the promoted version listed)."""
    from predictionio_tpu.registry import ArtifactStore
    from predictionio_tpu.tools.admin_api import AdminServer as JaxAdmin
    from predictionio_tpu_torch.tools.admin_api import AdminServer as PortAdmin

    registry = _registry_template(tmp_path)
    store = ArtifactStore(registry)
    store.stage_candidate(ENGINE, V2, fraction=0.5)
    store.promote(ENGINE)
    key = store.engine_key(ENGINE)
    got = {}
    jax = JaxAdmin(storage=_storage("jax", with_app=False), registry_dir=registry)
    with aiohttp_served(jax.make_app()) as (port, _, _):
        got["jax"] = _admin_script(port, key)
    admin = PortAdmin(storage=_storage("port", with_app=False), registry_dir=registry)
    port = admin.start("127.0.0.1", 0)
    try:
        got["port"] = _admin_script(port, key)
    finally:
        admin.shutdown()
    assert got["port"] == got["jax"]
    statuses = [s for _, _, s, _ in got["port"]]
    assert statuses == [200, 200, 201, 409, 400, 201, 400, 400, 200, 200, 200, 404, 404, 200, 200, 200,
                        404, 404, 405, 405]
    models = got["port"][15][3]
    assert models["state"]["stable"] == V2 and [v["version"] for v in models["versions"]] == ["v000001", V2]


# ---------------------------------------------------------------------------
# the dashboard
# ---------------------------------------------------------------------------


def _evaluation(pkg, storage):
    if pkg == "jax":
        from predictionio_tpu.data.storage.base import EvaluationInstance, EvaluationInstanceStatus
    else:
        from predictionio_tpu_torch.data.storage.base import EvaluationInstance, EvaluationInstanceStatus
    return storage.get_meta_data_evaluation_instances().insert(EvaluationInstance(
        id="evalinst1",
        status=EvaluationInstanceStatus.EVALCOMPLETED,
        start_time=dt.datetime(2024, 1, 1, tzinfo=UTC),
        end_time=dt.datetime(2024, 1, 2, tzinfo=UTC),
        evaluation_class="my.Evaluation",
        evaluator_results="[Metric] best: 0.9 <b>",
        evaluator_results_html="<h2>results</h2>",
        evaluator_results_json='{"bestScore": 0.9}',
    ))


def _dead_url() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def test_dashboard_lists_the_same_evaluations_and_an_unreachable_panel(tmp_path, scraped):
    """The page, the result routes and the 404s of both dashboards on
    equal storages; a server that does not answer renders as
    unreachable, and a panel renders alike from the same scrape."""
    from predictionio_tpu.tools.dashboard import Dashboard as JaxDashboard
    from predictionio_tpu.tools.dashboard import render_metrics_panel as jax_panel
    from predictionio_tpu_torch.tools.dashboard import Dashboard as PortDashboard
    from predictionio_tpu_torch.tools.dashboard import render_metrics_panel as port_panel

    dead = _dead_url()
    paths = ["/", "/engine_instances/{iid}/evaluator_results.html", "/engine_instances/{iid}/evaluator_results.json",
             "/engine_instances/nope/evaluator_results.html", "/engine_instances/nope/evaluator_results.json",
             "/nope"]
    got = {}
    for pkg, cls in (("jax", JaxDashboard), ("port", PortDashboard)):
        storage = _storage(pkg, with_app=False)
        iid = _evaluation(pkg, storage)
        dash = cls(storage=storage, metrics_urls=[dead])
        if pkg == "jax":
            with aiohttp_served(dash.make_app()) as (port, _, _):
                got[pkg] = [call(port, "GET", p.replace("{iid}", iid)) for p in paths]
        else:
            port = dash.start("127.0.0.1", 0)
            try:
                got[pkg] = [call(port, "GET", p.replace("{iid}", iid)) for p in paths]
            finally:
                dash.shutdown()
    assert got["port"] == got["jax"]
    page = got["port"][0][2]
    assert "my.Evaluation" in page and f"{dead}</h3>" in page and "unreachable" in page
    assert [s for s, _, _ in got["port"]] == [200, 200, 200, 404, 404, 404]
    text = scraped["port"][0][1]
    assert port_panel("http://replica:8000", text) == jax_panel("http://replica:8000", text)
    assert port_panel("http://x", None) == jax_panel("http://x", None)


def test_dashboard_without_sources_says_how_to_add_them():
    from predictionio_tpu.tools.dashboard import Dashboard as JaxDashboard  # noqa: F401
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.tools.dashboard import Dashboard

    page = Dashboard(storage=Storage(env=MEMORY_ENV)).index_html()
    assert "pio dashboard --metrics-url" in page and "<h2>Evaluations</h2>" in page


def test_cli_adminserver_and_dashboard_serve_until_sigterm(tmp_path):
    """`pio adminserver` and `pio dashboard` as processes of the port's CLI
    on one --home store: both answer, and SIGTERM stops each with exit 0."""
    import signal
    import subprocess
    import sys
    import urllib.request

    from predictionio_tpu_torch.registry import ArtifactStore, ModelManifest
    from predictionio_tpu_torch.tools import cli

    home, registry = tmp_path / "home", str(tmp_path / "registry")
    assert cli.main(["--home", str(home), "app", "new", "toolsapp"]) == 0
    ArtifactStore(registry).publish(ModelManifest(version="", engine_id="tools-engine", engine_version="1",
                                                  engine_variant="engine.json"), b"blob")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("PIO_")}, "PYTHONPATH": repo}
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    base = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(home)]
    procs = [subprocess.Popen([*base, "adminserver", "--port", str(ports[0]), "--registry-dir", registry], env=env),
             subprocess.Popen([*base, "dashboard", "--port", str(ports[1]), "--metrics-url", _dead_url()], env=env)]
    try:
        def get(port, path):
            deadline = time.monotonic() + 60
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
                        return resp.read().decode()
                except OSError:
                    assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
                    time.sleep(0.1)

        assert [a["name"] for a in json.loads(get(ports[0], "/cmd/app"))] == ["toolsapp"]
        engines = json.loads(get(ports[0], "/cmd/models"))["engines"]
        assert [(e["engineId"], e["stable"]) for e in engines] == [("tools-engine", "v000001")]
        page = get(ports[1], "/")
        assert "<h2>Serving</h2>" in page and 'class="unreachable"' in page
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=20) for p in procs]
    assert codes == [0, 0]
