"""The query server's serving contract, the port against the JAX package
on the CPU.

The same scenario runs against the JAX package's aiohttp server and the
port's ``ThreadingHTTPServer`` (the sample engine, real sockets), and the
tests compare statuses, ``Retry-After``, bodies and what reached a
collector: the feedback event each package POSTs, field by field; the
remote-log body; the access key; TLS; output blockers and sniffers with
``/plugins.json``; the drain. Then the faults this slice closes:

- C10: a query that fails in serving answers 400 ``{"message": str(exc)}``
  as in the JAX package (the port answered 500, or 400 ``"bad query:
  KeyError('qid')"``);
- C11: a query past its deadline answers 503 with ``Retry-After``, within
  the deadline (the port answered 503 without it, after a fixed 10 s);
- C12: a TCP client that never starts its TLS handshake does not delay
  anybody else's HTTPS request, on the query server and on the event
  server (whose handshake ran inside the serve thread's ``accept()``).

Last, the deploy flags of both CLIs, and one ``pio deploy`` process with
TLS, an access key, feedback into a ``pio eventserver`` and a remote log,
drained by SIGTERM. Timeouts stay at or under 2 s, except the process's
start.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from tests.torch_serving_helpers import (  # noqa: E402
    PACKAGES,
    Client,
    Collector,
    call,
    event_server,
    patch_both,
    query_server,
    silent_client,
    tls_cert,  # noqa: F401 - a fixture
    wait_until,
)
from tests.torch_template_helpers import REPO, _free_port, write_events  # noqa: E402


def _both(scenario, plugins=None, **cfg):
    """``scenario(port, server, run)`` on each package's query server (the
    plugin context from ``plugins(pkg)``); both must observe the same."""
    out = {}
    for pkg in PACKAGES:
        ctx = plugins(pkg) if plugins is not None else None
        with query_server(pkg, plugin_context=ctx, **cfg) as (port, server, run):
            out[pkg] = scenario(port, server, run)
    assert out["jax"] == out["port"], out
    return out["port"]


# ---------------------------------------------------------------------------
# feedback and the remote log
# ---------------------------------------------------------------------------


def test_feedback_event_is_the_jax_packages_field_by_field():
    collector = Collector()
    try:
        def scenario(port, server, run):
            collector.received.clear()
            answers = [call(port, "POST", "/queries.json", {"qid": q, "user": f"u{q}"}) for q in (4, 5)]
            wait_until(lambda: len(collector.received) == 2, 5, "two feedback events")
            events = sorted((json.loads(b) for _, _, b in collector.received),
                            key=lambda e: e["properties"]["query"]["qid"])
            return answers, sorted({(path, ctype) for path, ctype, _ in collector.received}), events

        answers, targets, events = _both(scenario, feedback=True, event_server_url=collector.url,
                                         feedback_access_key="FBKEY")
    finally:
        collector.close()
    assert [a[0] for a in answers] == [200, 200]
    assert targets == [("/events.json?accessKey=FBKEY", "application/json")]
    for (_, _, body), event in zip(answers, events):
        assert event == {"event": "predict", "entityType": "pio_pr", "entityId": "resil",
                         "properties": {"query": {"qid": body["qid"], "user": f"u{body['qid']}"},
                                        "prediction": body}}


def test_no_feedback_without_a_url_and_key():
    collector = Collector()
    try:
        def scenario(port, server, run):
            status = call(port, "POST", "/queries.json", {"qid": 1})[0]
            time.sleep(0.2)
            return status, len(collector.received)

        assert _both(scenario, feedback=True, event_server_url=collector.url) == (200, 0)
    finally:
        collector.close()


def test_remote_log_body_is_the_jax_packages():
    collector = Collector()
    try:
        def scenario(port, server, run):
            collector.received.clear()
            status, retry_after, body = call(port, "POST", "/queries.json", {"bogus": 1})
            wait_until(lambda: collector.received, 5, "the remote log")
            (path, ctype, raw), = collector.received
            text = raw.decode()
            assert text.startswith("PFX")
            log = json.loads(text.removeprefix("PFX"))
            head, _, trace = log["message"].partition("Stack Trace:\n")
            return (status, retry_after, body, path, ctype, sorted(log), log["engineInstance"], head,
                    trace.rstrip("\n").splitlines()[-1], log["message"].endswith("\n\n"))

        out = _both(scenario, log_url=collector.url + "/log", log_prefix="PFX")
    finally:
        collector.close()
    assert out == (400, None, {"message": "'qid'"}, "/log", "text/plain; charset=utf-8",
                           ["engineInstance", "message"], "inst-resil",
                           "Query:\n{'bogus': 1}\n\n", "KeyError: 'qid'", True)


# ---------------------------------------------------------------------------
# access key and TLS
# ---------------------------------------------------------------------------


def test_access_key_by_parameter_or_bearer_else_401():
    def scenario(port, server, run):
        return [
            call(port, "POST", "/queries.json", {"qid": 1}),
            call(port, "POST", "/queries.json?accessKey=WRONG", {"qid": 1}),
            call(port, "POST", "/queries.json", {"qid": 1}, headers={"Authorization": "Bearer WRONG"}),
            call(port, "POST", "/queries.json?accessKey=SECRET", {"qid": 2}),
            call(port, "POST", "/queries.json", {"qid": 3}, headers={"Authorization": "Bearer SECRET"}),
            call(port, "GET", "/healthz")[0],  # only /queries.json takes the key
        ]

    out = _both(scenario, accesskey="SECRET")
    assert out[:3] == [(401, None, {"message": "Invalid accessKey."})] * 3
    assert [(s, b["qid"]) for s, _, b in out[3:5]] == [(200, 2), (200, 3)]
    assert out[5] == 200


def test_tls_serves_https_and_refuses_half_a_pair(tls_cert):
    from predictionio_tpu.workflow.create_server import ServerConfig as JaxConfig
    from predictionio_tpu_torch.workflow.create_server import ServerConfig

    cert, key = tls_cert
    for cfg in (JaxConfig, ServerConfig):
        with pytest.raises(ValueError, match="TLS misconfigured"):
            cfg(ssl_certfile=cert).ssl_context()

    def scenario(port, server, run):
        answer = call(port, "POST", "/queries.json", {"qid": 9}, cafile=cert)
        with pytest.raises(OSError):  # plain HTTP on the TLS port gets no answer
            call(port, "GET", "/", timeout=2)
        return answer

    assert _both(scenario, ssl_certfile=cert, ssl_keyfile=key)[:2] == (200, None)


# ---------------------------------------------------------------------------
# engine-server plugins
# ---------------------------------------------------------------------------


def _plugins(pkg, seen):
    if pkg == "jax":
        from predictionio_tpu.workflow import server_plugins as sp
    else:
        from predictionio_tpu_torch.workflow import server_plugins as sp

    class Shift(sp.EngineServerPlugin):
        plugin_name = "shift"
        plugin_description = "adds 1000 to qid; vetoes qid 13"
        plugin_type = sp.OUTPUT_BLOCKER

        def process(self, variant, query, prediction, context):
            if prediction.qid == 13:
                raise ValueError("qid 13 is vetoed")
            return dataclasses.replace(prediction, qid=prediction.qid + 1000)

    class Spy(sp.EngineServerPlugin):
        plugin_name = "spy"
        plugin_description = "records what was answered"

        def process(self, variant, query, prediction, context):
            seen[pkg].append((variant, query.qid, prediction.qid))

    return sp.EngineServerPluginContext([Shift(), Spy()])


def test_output_blocker_rewrites_and_vetoes_sniffer_sees_and_plugins_json():
    seen = {"jax": [], "port": []}

    def scenario(port, server, run):
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            answers = list(pool.map(lambda q: call(port, "POST", "/queries.json", {"qid": q}), range(8)))
        vetoed = call(port, "POST", "/queries.json", {"qid": 13})
        pkg = "jax" if run is not None else "port"
        wait_until(lambda: len(seen[pkg]) == 8, 5, "the sniffer")
        inventory = call(port, "GET", "/plugins.json")[2]
        for kind in inventory["plugins"].values():
            for desc in kind.values():
                assert desc.pop("class").endswith(("Shift", "Spy"))
        return [(s, b["qid"]) for s, _, b in answers], vetoed, sorted(seen[pkg]), inventory

    answers, vetoed, sniffed, inventory = _both(scenario, plugins=lambda pkg: _plugins(pkg, seen))
    assert answers == [(200, 1000 + q) for q in range(8)]
    assert vetoed == (400, None, {"message": "qid 13 is vetoed"})
    assert sniffed == [("engine.json", q, 1000 + q) for q in range(8)]
    assert inventory == {"plugins": {
        "outputblockers": {"shift": {"name": "shift", "description": "adds 1000 to qid; vetoes qid 13"}},
        "outputsniffers": {"spy": {"name": "spy", "description": "records what was answered"}}}}


def test_registered_plugins_are_picked_up_and_cleared():
    from predictionio_tpu_torch.workflow import server_plugins as sp

    class Tag(sp.EngineServerPlugin):
        plugin_name = "tag"

        def process(self, variant, query, prediction, context):
            return prediction

    sp.register_plugin(Tag())
    try:
        assert list(sp.EngineServerPluginContext().output_sniffers) == ["tag"]
    finally:
        sp.clear_plugins()
    assert sp.EngineServerPluginContext().to_json_dict() == {
        "plugins": {"outputblockers": {}, "outputsniffers": {}}}


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------


def test_drain_answers_what_was_accepted_then_refuses(monkeypatch):
    def make(real):
        def predict(self, model, query):
            if query.qid == 1:
                time.sleep(0.5)
            return real(self, model, query)
        return predict

    patch_both(monkeypatch, "predict", make)

    def scenario(port, server, run):
        keep = Client(port)
        before = keep.call("GET", "/healthz")[0]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            slow = pool.submit(call, port, "POST", "/queries.json", {"qid": 1})
            wait_until(lambda: server._inflight_requests == 1, 2, "the query in flight")
            drained = pool.submit(server.drain if run is None else lambda: run(server.drain()))
            wait_until(lambda: server._draining, 2, "draining")
            during = keep.call("GET", "/healthz")
            answer = slow.result(timeout=5)
            drained.result(timeout=5)
        keep.close()
        with pytest.raises(ConnectionRefusedError):
            call(port, "GET", "/", timeout=2)
        return before, during[0], during[2]["ready"], during[2]["draining"], answer

    out = _both(scenario, request_timeout_s=2.0)
    assert out[:4] == (200, 503, False, True)
    assert out[4][0] == 200 and out[4][2]["qid"] == 1


# ---------------------------------------------------------------------------
# C10, C11, C12
# ---------------------------------------------------------------------------


def test_c10_a_failing_query_answers_400_with_the_jax_message(monkeypatch):
    def make(real):
        def predict(self, model, query):
            if query.qid == 666:
                raise ValueError("model cannot score 666")
            return real(self, model, query)
        return predict

    patch_both(monkeypatch, "predict", make)

    def scenario(port, server, run):
        return [call(port, "POST", "/queries.json", body) for body in
                ({"bogus": 1}, {"qid": 666}, [1, 2], None, {"qid": "x"})] + [
            call(port, "POST", "/queries.json", raw=b"not json")[0],
            call(port, "POST", "/queries.json", {"qid": 7})[0]]

    out = _both(scenario)
    assert out == [
        (400, None, {"message": "'qid'"}),
        (400, None, {"message": "model cannot score 666"}),
        (400, None, {"message": "list indices must be integers or slices, not str"}),
        (400, None, {"message": "Expecting value: line 1 column 1 (char 0)"}),  # no body
        (400, None, {"message": "invalid literal for int() with base 10: 'x'"}),
        400, 200,
    ]


def test_c11_a_query_past_its_deadline_answers_503_with_retry_after_in_time(monkeypatch):
    def make(real):
        def dispatch(self, model, queries):
            if any(q.qid == 1 for q in queries):
                time.sleep(1.0)
            return None
        return dispatch

    patch_both(monkeypatch, "predict_batch_dispatch", make)

    def scenario(port, server, run):
        t0 = time.perf_counter()
        answer = call(port, "POST", "/queries.json", {"qid": 1})
        in_time = time.perf_counter() - t0 < 0.3 + 0.5
        return answer, in_time, server._m_deadline.value()

    assert _both(scenario, request_timeout_s=0.3, breaker_threshold=100) == (
        (503, "1", {"message": "micro-batch dispatch: deadline exceeded"}), True, 1.0)


@pytest.mark.parametrize("kind", ["query_jax", "query_port", "event_port"])
def test_c12_a_silent_tls_client_does_not_delay_another(kind, tls_cert):
    cert, key = tls_cert
    tls = {"ssl_certfile": cert, "ssl_keyfile": key}
    if kind == "event_port":
        served = event_server("port", **tls)
        path = "/"
    else:
        served = query_server(kind.removeprefix("query_"), **tls)
        path = "/healthz"
    with served as (port, *_):
        with silent_client(port):
            t0 = time.perf_counter()
            status = call(port, "GET", path, cafile=cert, timeout=2)[0]
            assert status == 200
            assert time.perf_counter() - t0 < 1.0


def test_event_server_healthz_and_the_breaker_flags(tmp_path):
    with event_server("port", breaker_threshold=7, breaker_recovery_s=1.5, storage_retries=2) as (
            port, server, _, _):
        status, _, body = call(port, "GET", "/healthz")
    assert status == 200
    assert body["ready"] is True and body["breaker"]["name"] == "eventdata"
    assert server.storage_policy.breaker.failure_threshold == 7
    assert server.storage_policy.breaker.recovery_timeout_s == 1.5
    assert server.storage_policy.retry.max_attempts == 2


# ---------------------------------------------------------------------------
# the CLI: flags, and one deploy process
# ---------------------------------------------------------------------------


def _flag_defaults(parser, verb: str, dests: list[str]) -> dict:
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    actions = {a.dest: a for a in sub.choices[verb]._actions}
    return {d: (actions[d].option_strings, actions[d].default) for d in dests}


DEPLOY_FLAGS = ["accesskey", "feedback", "event_server_url", "feedback_access_key", "ssl_certfile",
                "ssl_keyfile", "log_url", "log_prefix", "request_timeout", "queue_high_water",
                "breaker_threshold", "breaker_recovery", "drain_grace"]
EVENTSERVER_FLAGS = ["storage_retries", "breaker_threshold", "breaker_recovery", "ssl_certfile", "ssl_keyfile"]


def test_deploy_and_eventserver_flags_are_the_jax_clis():
    from predictionio_tpu.tools import cli as jax_cli
    from predictionio_tpu_torch.tools import cli

    for verb, dests in (("deploy", DEPLOY_FLAGS), ("eventserver", EVENTSERVER_FLAGS)):
        assert _flag_defaults(cli.build_parser(), verb, dests) == _flag_defaults(
            jax_cli.build_parser(), verb, dests)


def test_undeploy_ssl_reaches_a_tls_deploy(tls_cert, capsys):
    from predictionio_tpu_torch.tools import cli

    cert, key = tls_cert
    with query_server("port", ssl_certfile=cert, ssl_keyfile=key) as (port, server, _):
        assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port", str(port), "--ssl"]) == 0
        assert json.loads(capsys.readouterr().out) == {"message": "Stopping."}
        assert server.stop_requested.wait(2)


def test_deploy_process_with_tls_key_feedback_remote_log_and_sigterm_drain(tmp_path, tls_cert):
    """train in-process, then ``pio deploy`` with every serving flag: 200
    over HTTPS with the key, 401 without, a failing query's 400 and its
    remote log, one predict event per answered query in the event
    server's store, then SIGTERM amid a burst: every query the server
    accepted answers 200 and the process exits 0."""
    from predictionio_tpu_torch.data.api.event_server import EventServer, EventServerConfig
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.tools import cli

    cert, key = tls_cert
    home, engine_dir = tmp_path / "home", tmp_path / "engine"
    engine_dir.mkdir()
    variant = json.loads((REPO / "predictionio_tpu_torch/models/recommendation/engine.json").read_text())
    variant["datasource"]["params"]["appName"] = "deployapp"
    variant["algorithms"][0]["params"].update(rank=4, numIterations=2)
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    events = [{"event": "rate", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
               "targetEntityId": f"i{i}", "properties": {"rating": float(1 + (u * i) % 5)},
               "eventTime": f"2024-03-01T00:00:{(u * 7 + i) % 60:02d}.000Z"}
              for u in range(10) for i in range(6) if (u + i) % 3]
    ev_path = write_events(tmp_path / "ev.jsonl", events)
    base = ["--home", str(home)]
    assert cli.main([*base, "app", "new", "deployapp"]) == 0
    assert cli.main([*base, "app", "new", "feedbackapp", "--access-key", "FBKEY"]) == 0
    assert cli.main([*base, "import", "--appname", "deployapp", "--input", str(ev_path)]) == 0
    assert cli.main([*base, "train", "--engine-dir", str(engine_dir), "--device", "cpu"]) == 0

    storage = Storage(env={**os.environ, "PIO_FS_BASEDIR": str(home)})
    es = EventServer(storage=storage, config=EventServerConfig(ip="127.0.0.1", port=0))
    es_port = es.start()
    collector = Collector()
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *base, "deploy",
         "--engine-dir", str(engine_dir), "--device", "cpu", "--ip", "127.0.0.1", "--port", str(port),
         "--accesskey", "QKEY", "--feedback", "--event-server-url", f"http://127.0.0.1:{es_port}",
         "--feedback-access-key", "FBKEY", "--ssl-certfile", cert, "--ssl-keyfile", key,
         "--log-url", collector.url + "/log", "--log-prefix", "PFX", "--request-timeout", "2",
         "--queue-high-water", "32", "--drain-grace", "5"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                if call(port, "GET", "/healthz", cafile=cert, timeout=2)[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "deploy never answered"
            time.sleep(0.2)
        q = "/queries.json?accessKey=QKEY"
        assert call(port, "POST", "/queries.json", {"user": "u1"}, cafile=cert)[:2] == (401, None)
        answers = [call(port, "POST", q, {"user": f"u{u}", "num": 3}, cafile=cert) for u in range(5)]
        assert [a[0] for a in answers] == [200] * 5
        assert call(port, "POST", q, {"num": 3}, cafile=cert)[0] == 400
        wait_until(lambda: collector.received, 5, "the remote log")
        assert collector.received[0][2].startswith(b"PFX")
        app = storage.get_meta_data_apps().get_by_name("feedbackapp")
        wait_until(lambda: len(list(storage.get_l_events().find(app.id, entity_type="pio_pr"))) == 5, 5,
                   "five predict events")
        landed = {json.dumps(e.properties["query"], sort_keys=True): e.properties["prediction"]
                  for e in storage.get_l_events().find(app.id, entity_type="pio_pr")}
        assert landed == {json.dumps({"num": 3, "user": f"u{u}"}, sort_keys=True): a[2]
                          for u, a in enumerate(answers)}

        def one(u):
            try:
                client = Client(port, cafile=cert, timeout=5)
                client.conn.connect()
            except OSError:
                return "refused"
            try:
                return client.call("POST", q, {"user": f"u{u % 10}", "num": 3})[0]
            finally:
                client.close()

        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            burst = [pool.submit(one, u) for u in range(32)]
            time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            outcomes = [f.result(timeout=10) for f in burst]
        assert set(outcomes) <= {200, "refused"}, outcomes
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        collector.close()
        es.shutdown()


# ---------------------------------------------------------------------------
# SIGTERM with feedback still in flight
# ---------------------------------------------------------------------------

_SIGTERM_CHILD = """
import sys
from predictionio_tpu_torch.utils.platform import wait_for_signal
from tests.torch_serving_helpers import query_server

with query_server("port", feedback=True, event_server_url=sys.argv[1], feedback_access_key="k",
                  drain_grace_s=float(sys.argv[2]), request_timeout_s=5.0) as (port, server, _):
    print(port, flush=True)
    if wait_for_signal(server.stop_requested) is not None:  # run_query_server's exit path
        server.drain()
"""


@pytest.mark.parametrize("target_delay_s", [0.15, 60.0], ids=["slow_event_server", "silent_event_server"])
def test_sigterm_exit_stays_within_the_grace_with_feedback_in_flight(target_delay_s):
    """A server process with feedback into an event server that answers
    each POST 0.15 s late, or never: SIGTERM amid a burst of 32 queries
    must end the process with 0 within its 4 s drain grace, and against
    the slow event server every answered query's predict event lands
    (the 4 POST threads need 1.2 s for 32). Executor threads used to hold
    the exit for each running POST's 10 s timeout and drop the queued
    ones."""
    grace = 4.0
    target = Collector(delay_s=target_delay_s)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_CHILD, target.url, str(grace)], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline())

        def one(qid):
            try:
                return qid, call(port, "POST", "/queries.json", {"qid": qid}, timeout=10)[0]
            except OSError:
                return qid, "refused"

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            burst = [pool.submit(one, qid) for qid in range(32)]
            wait_until(lambda: sum(f.done() for f in burst) >= 16, 30, "half the burst answered")
            t_term = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            outcomes = dict(f.result(timeout=30) for f in burst)
        code = proc.wait(timeout=30)
        exit_s = time.monotonic() - t_term
        assert code == 0, proc.stderr.read()
        assert set(outcomes.values()) <= {200, "refused"}, outcomes
        assert exit_s <= grace, f"exited {exit_s:.2f} s after SIGTERM (grace {grace} s)"
        if target_delay_s < grace:
            answered = {q for q, status in outcomes.items() if status == 200}
            landed = {json.loads(body)["properties"]["query"]["qid"] for _, _, body in target.received}
            assert landed == answered
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        target.close()
