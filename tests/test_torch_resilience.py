"""The port's resilience layer against the JAX package's, on the CPU.

The fault injector, the new ``Deadline`` methods, the policy's DAO wrap,
and the chaos cases of ``tests/test_resilience.py`` for both servers: each
scenario runs against the JAX package's aiohttp server and against the
port's ``ThreadingHTTPServer`` over real sockets, and the two must give
the same statuses, ``Retry-After`` headers, messages and counters
(timings aside: a bound on latency is checked, not a value). Timeouts stay
at or under 2 s.
"""

from __future__ import annotations

import concurrent.futures
import time

import pytest

pytest.importorskip("torch")

import predictionio_tpu.resilience as jax_resilience  # noqa: E402
import predictionio_tpu_torch.resilience as port_resilience  # noqa: E402
from tests.torch_serving_helpers import (  # noqa: E402
    PACKAGES,
    batcher,
    call,
    event_server,
    patch_both,
    query_server,
)

MODULES = {"jax": jax_resilience, "port": port_resilience}
EVENT = {"event": "rate", "entityType": "user", "entityId": "u1"}


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


class _Dummy:
    def __init__(self):
        self.hits = 0
        self.attr = "plain"

    def work(self, x):
        self.hits += 1
        return x * 2

    def other(self):
        return "other"


def _both(fn):
    """Run ``fn(module)`` with each package's resilience module; both must
    return the same observation."""
    out = {pkg: fn(mod) for pkg, mod in MODULES.items()}
    assert out["jax"] == out["port"]
    return out["port"]


# ---------------------------------------------------------------------------
# the fault injector (tests/test_resilience.py TestFaultInjector)
# ---------------------------------------------------------------------------


class TestFaultInjector:
    def test_fail_count_then_passthrough(self):
        def run(r):
            inj = r.FaultInjector(_Dummy())
            inj.inject("work", fail_count=2)
            raised = []
            for _ in range(2):
                with pytest.raises(r.InjectedFault) as exc:
                    inj.work(1)
                raised.append(str(exc.value))
            return raised, inj.work(3), inj.faults, inj.calls, inj.hits

        assert _both(run) == (["injected fault in work"] * 2, 6, 2, 3, 1)

    def test_method_filter_and_plain_attrs(self):
        def run(r):
            inj = r.FaultInjector(_Dummy())
            inj.inject("work", fail_count=10)
            return inj.other(), inj.attr, inj.faults

        assert _both(run) == ("other", "plain", 0)

    def test_custom_exception_and_clear(self):
        def run(r):
            inj = r.FaultInjector(_Dummy())
            inj.inject(exception=lambda m: RuntimeError(f"boom:{m}"), fail_count=1)
            with pytest.raises(RuntimeError, match="boom:work"):
                inj.work(1)
            inj.clear()
            return inj.work(2)

        assert _both(run) == 4

    def test_latency_injection(self):
        def run(r):
            inj = r.FaultInjector(_Dummy())
            inj.inject("work", latency_s=0.05)
            t0 = time.perf_counter()
            out = inj.work(1)
            return out, time.perf_counter() - t0 >= 0.045

        assert _both(run) == (2, True)

    def test_fail_rate_and_hang(self):
        def run(r):
            inj = r.FaultInjector(_Dummy(), rng=lambda: 0.0)  # 0 < rate: always
            inj.inject("work", fail_rate=0.5, hang_s=0.05)
            t0 = time.perf_counter()
            with pytest.raises(r.InjectedFault):
                inj.work(1)
            return time.perf_counter() - t0 >= 0.045, r.is_transient(r.InjectedFault("x"))

        assert _both(run) == (True, True)

    def test_setattr_reaches_the_target(self):
        def run(r):
            target = _Dummy()
            inj = r.FaultInjector(target)
            inj.attr = "changed"
            return target.attr, repr(inj).startswith("FaultInjector(")

        assert _both(run) == ("changed", True)


# ---------------------------------------------------------------------------
# the Deadline methods the query server's batcher needs
# ---------------------------------------------------------------------------


class TestDeadline:
    def test_never_and_bounded(self):
        def run(r):
            d = r.Deadline.never()
            bounded = r.Deadline(1.0, clock=FakeClock())
            return (d.bounded, d.remaining(), d.expired, d.clamp(2.0), d.clamp(None),
                    bounded.bounded, r.Deadline.after(0).bounded, repr(d))

        assert _both(run) == (False, None, False, 2.0, None, True, False,
                              "Deadline(remaining=inf)")

    def test_clamp_fits_a_layer_timeout_inside(self):
        def run(r):
            clock = FakeClock()
            d = r.Deadline(1.0, clock=clock)
            out = [d.clamp(5.0), d.clamp(0.25), d.clamp(None)]
            clock.advance(0.75)
            out += [d.clamp(5.0), d.clamp(None), repr(d)]
            clock.advance(1.0)
            out += [d.clamp(5.0), d.expired]
            return out

        assert _both(run) == [1.0, 0.25, 1.0, 0.25, 0.25, "Deadline(remaining=0.250s)", 0.0, True]

    def test_min_of_picks_the_tightest_bounded_deadline(self):
        def run(r):
            clock = FakeClock()
            ds = [r.Deadline(3.0, clock), r.Deadline.never(), r.Deadline(1.5, clock), r.Deadline(2.0, clock)]
            best = r.Deadline.min_of(ds)
            return (best is ds[2], best.remaining(), r.Deadline.min_of([r.Deadline.never()]).bounded,
                    r.Deadline.min_of([]).bounded)

        assert _both(run) == (True, 1.5, False, False)


# ---------------------------------------------------------------------------
# the policy around a DAO
# ---------------------------------------------------------------------------


class TestWrapDao:
    def test_wrap_dao_applies_policy_and_exempts_close(self):
        def run(r):
            target = _Dummy()
            target.close = lambda: (_ for _ in ()).throw(r.InjectedFault("x"))
            inj = r.FaultInjector(target)
            inj.inject("work", fail_count=1)
            dao = r.wrap_dao(inj, r.ResiliencePolicy(retry=r.RetryPolicy(max_attempts=3, sleep=lambda s: None)))
            out = dao.work(2)  # one injected failure, then the retry lands
            with pytest.raises(r.InjectedFault):
                dao.close()  # exempt: no retry wrapper
            return out, inj.faults, dao.attr, repr(dao).startswith("ResilientProxy(")

        assert _both(run) == (4, 1, "plain", True)

    def test_an_open_breaker_stops_a_wrapped_dao_without_calling_it(self):
        def run(r):
            inj = r.FaultInjector(_Dummy())
            inj.inject("work", fail_count=100)
            breaker = r.CircuitBreaker(name="dao", failure_threshold=2, clock=FakeClock())
            dao = r.wrap_dao(inj, r.ResiliencePolicy(
                retry=r.RetryPolicy(max_attempts=5, sleep=lambda s: None), breaker=breaker))
            with pytest.raises(r.CircuitOpenError):
                dao.work(1)
            calls = inj.calls
            with pytest.raises(r.CircuitOpenError):
                dao.work(1)
            return calls, inj.calls, breaker.state

        assert _both(run) == (2, 2, "open")

    def test_breaker_listener_sees_each_transition(self):
        def run(r):
            clock = FakeClock()
            seen = []
            b = r.CircuitBreaker(name="t", failure_threshold=1, recovery_timeout_s=1.0, clock=clock)
            b.chain_listener(lambda *a: seen.append(a))
            b.chain_listener(lambda *a: seen.append(("second",) + a))
            b.record_failure()
            clock.advance(1.5)
            b.allow()
            b.record_success()
            b.record_failure()
            b.reset()
            return seen

        _both(run)


# ---------------------------------------------------------------------------
# event server chaos: fault-injected storage (TestEventServerChaos)
# ---------------------------------------------------------------------------


def _event_both(scenario):
    """Run ``scenario(port, server, injector, key)`` on each package's
    event server; both must observe the same."""
    out = {}
    for pkg in PACKAGES:
        with event_server(pkg) as (port, server, injector, key):
            out[pkg] = scenario(port, server, injector, key)
    assert out["jax"] == out["port"]
    return out["port"]


def _msg(body):
    return body["message"] if isinstance(body, dict) else body


class TestEventServerChaos:
    def test_transient_insert_fault_retries_then_succeeds(self):
        def scenario(port, server, injector, key):
            injector.inject("insert", fail_count=1)
            status, _, body = call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            return status, sorted(body), injector.faults

        assert _event_both(scenario) == (201, ["eventId"], 1)

    def test_persistent_faults_trip_breaker_to_503_with_retry_after(self):
        def scenario(port, server, injector, key):
            injector.inject("insert", fail_count=1000)
            first = call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            state = server.storage_policy.breaker.state
            shed = call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            faults = injector.faults
            again = call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            hz_status, _, hz = call(port, "GET", "/healthz")
            return (first[0], state, shed[0], shed[1], _msg(shed[2]).split(":")[0], again[0],
                    injector.faults == faults, hz_status, hz["ready"], hz["breaker"]["state"],
                    hz["breaker"]["trips"], sorted(hz))

        out = _event_both(scenario)
        # 3 in-request attempts = breaker_threshold: the circuit opened on
        # the first request (its third attempt failed: a 500)
        assert out[:8] == (500, "open", 503, "1", "storage unavailable", 503, True, 503)
        assert out[8:11] == (False, "open", 1)

    def test_breaker_recovers_half_open_to_closed_when_faults_stop(self):
        def scenario(port, server, injector, key):
            injector.inject("insert", fail_count=1000)
            call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            opened = server.storage_policy.breaker.state
            injector.clear()
            time.sleep(0.25)  # > breaker_recovery_s
            ok = call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            hz = call(port, "GET", "/healthz")
            return opened, ok[0], server.storage_policy.breaker.state, hz[0], hz[2]["ready"]

        assert _event_both(scenario) == ("open", 201, "closed", 200, True)

    def test_batch_path_reports_storage_unavailable(self):
        def scenario(port, server, injector, key):
            injector.inject("insert", fail_count=1000)
            call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            status, retry_after, body = call(port, "POST", f"/batch/events.json?accessKey={key}", [EVENT, EVENT])
            return server.storage_policy.breaker.state, status, retry_after, _msg(body).split(":")[0]

        assert _event_both(scenario) == ("open", 503, "1", "storage unavailable")

    def test_reads_survive_transient_faults(self):
        def scenario(port, server, injector, key):
            assert call(port, "POST", f"/events.json?accessKey={key}", EVENT)[0] == 201
            injector.inject("find", fail_count=1)
            status, _, body = call(port, "GET", f"/events.json?accessKey={key}")
            return status, len(body), injector.faults

        assert _event_both(scenario) == (200, 1, 1)

    def test_storage_failure_on_reads_is_500_not_400(self):
        def scenario(port, server, injector, key):
            injector.inject("find", fail_count=3)
            status, _, body = call(port, "GET", f"/events.json?accessKey={key}")
            server.storage_policy.breaker.reset()
            return status, _msg(body)

        assert _event_both(scenario) == (500, "injected fault in find")

    def test_storage_failure_on_a_single_event_read_is_500(self):
        def scenario(port, server, injector, key):
            _, _, body = call(port, "POST", f"/events.json?accessKey={key}", EVENT)
            injector.inject("get", fail_count=1000)
            return call(port, "GET", f"/events/{body['eventId']}.json?accessKey={key}")[0]

        assert _event_both(scenario) == 500


# ---------------------------------------------------------------------------
# query server chaos: deadlines, watchdog, shedding, breaker
# (TestQueryServerChaos)
# ---------------------------------------------------------------------------


def _query_both(scenario, **cfg):
    """Run ``scenario(port, server)`` on each package's query server; both
    must observe the same."""
    out = {}
    for pkg in PACKAGES:
        with query_server(pkg, **cfg) as (port, server, _):
            out[pkg] = scenario(port, server)
    assert out["jax"] == out["port"], out
    return out["port"]


async def _call(fn, *args):
    return fn(*args)


def _on_loop(run, fn, *args):
    """``fn(*args)`` on the JAX server's event loop (``run`` is None for the
    port: called here)."""
    return fn(*args) if run is None else run(_call(fn, *args))


def _submit(run, b, payload, deadline=None):
    """One query through a batcher's ``submit``, its outcome awaited."""
    if run is not None:
        return run(b.submit(payload, deadline))
    return b.submit(payload, deadline).result(timeout=5)


def _query_both_with_loop(scenario, **cfg):
    out = {}
    for pkg in PACKAGES:
        with query_server(pkg, **cfg) as (port, server, run):
            out[pkg] = scenario(port, server, run)
    assert out["jax"] == out["port"], out
    return out["port"]


class TestQueryServerChaos:
    def test_healthy_query_roundtrip(self):
        def scenario(port, server):
            status, _, body = call(port, "POST", "/queries.json", {"qid": 7})
            hz_status, _, hz = call(port, "GET", "/healthz")
            return status, body, hz_status, hz

        status, body, hz_status, hz = _query_both(scenario)
        assert (status, body["qid"], hz_status) == (200, 7, 200)
        assert hz == {"ready": True, "draining": False, "queueDepth": 0, "queueHighWater": 256,
                      "watchdogTrips": 0, "loadShedCount": 0,
                      "breakers": {"dispatch": {"name": "dispatch", "state": "closed",
                                                "consecutiveFailures": 0, "trips": 0}}}

    def test_hanging_predict_fails_with_bounded_latency(self, monkeypatch):
        """A predict that hangs past the deadline answers 503 within about
        the deadline, and the next request is served (the watchdog walked
        away from the stuck fetch thread)."""
        state = {"hang": True}

        def make(real):
            def predict(self, model, query):
                if state["hang"]:
                    time.sleep(1.5)  # far past the 0.5 s request deadline
                return real(self, model, query)
            return predict

        patch_both(monkeypatch, "predict", make)

        def scenario(port, server):
            state["hang"] = True
            t0 = time.perf_counter()
            status, retry_after, body = call(port, "POST", "/queries.json", {"qid": 1})
            bounded = time.perf_counter() - t0 < 1.2
            trips = batcher(server).watchdog_trips
            state["hang"] = False
            ok = call(port, "POST", "/queries.json", {"qid": 2})
            return status, retry_after, body, bounded, trips, ok[0], ok[2]["qid"]

        # a solo query on an idle server dispatches and fetches in one hop,
        # so its hang trips the dispatch watchdog
        assert _query_both(scenario, breaker_threshold=100) == (
            503, "1", {"message": "micro-batch dispatch: deadline exceeded"}, True, 1, 200, 2)

    def test_hanging_dispatch_fails_with_bounded_latency(self, monkeypatch):
        state = {"hang": True}

        def make(real):
            def dispatch(self, model, queries):
                if state["hang"]:
                    time.sleep(1.5)
                return None  # the synchronous predict_batch path
            return dispatch

        patch_both(monkeypatch, "predict_batch_dispatch", make)

        def scenario(port, server):
            state["hang"] = True
            t0 = time.perf_counter()
            status, retry_after, body = call(port, "POST", "/queries.json", {"qid": 1})
            bounded = time.perf_counter() - t0 < 1.2
            state["hang"] = False
            return status, retry_after, body, bounded, call(port, "POST", "/queries.json", {"qid": 2})[0]

        assert _query_both(scenario, breaker_threshold=100) == (
            503, "1", {"message": "micro-batch dispatch: deadline exceeded"}, True, 200)

    def test_watchdog_trips_open_dispatch_breaker_then_recover(self, monkeypatch):
        state = {"hang": True}

        def make(real):
            def predict(self, model, query):
                if state["hang"]:
                    time.sleep(1.0)
                return real(self, model, query)
            return predict

        patch_both(monkeypatch, "predict", make)

        def scenario(port, server):
            state["hang"] = True
            first = call(port, "POST", "/queries.json", {"qid": 1})
            opened = server.dispatch_breaker.state
            dispatched = batcher(server).batches_dispatched
            shed = call(port, "POST", "/queries.json", {"qid": 2})
            unchanged = batcher(server).batches_dispatched == dispatched
            hz = call(port, "GET", "/healthz")
            state["hang"] = False
            time.sleep(0.35)
            ok = call(port, "POST", "/queries.json", {"qid": 3})
            return (first[0], opened, shed[0], shed[1], shed[2]["message"], unchanged, hz[0],
                    hz[2]["breakers"]["dispatch"]["state"], ok[0], server.dispatch_breaker.state,
                    call(port, "GET", "/healthz")[0], server._m_breaker_rejected.value(),
                    server._m_watchdog.value())

        assert _query_both(scenario, request_timeout_s=0.3, breaker_threshold=1, breaker_recovery_s=0.3) == (
            503, "open", 503, "1", "serving temporarily unavailable (dispatch circuit open)", True,
            503, "open", 200, "closed", 200, 1.0, 1.0)

    def test_burst_over_high_water_sheds_with_retry_after(self, monkeypatch):
        def make(real):
            def predict(self, model, query):
                time.sleep(0.1)
                return real(self, model, query)
            return predict

        patch_both(monkeypatch, "predict", make)

        def scenario(port, server):
            with concurrent.futures.ThreadPoolExecutor(16) as pool:
                outs = list(pool.map(lambda i: call(port, "POST", "/queries.json", {"qid": i}), range(16)))
            shed = [o for o in outs if o[0] == 503]
            answered = [o for o in outs if o[0] == 200]
            assert shed, f"the burst was not shed: {[o[0] for o in outs]}"
            assert all(o[2]["qid"] == i for i, o in enumerate(outs) if o[0] == 200)
            b = batcher(server)
            return (len(shed) + len(answered) == 16, {o[1] for o in shed},
                    {o[2]["message"] for o in shed}, b.shed_count == len(shed) == server._m_shed.value(),
                    call(port, "POST", "/queries.json", {"qid": 99})[0])

        assert _query_both(scenario, queue_high_water=2, request_timeout_s=2.0) == (
            True, {"1"}, {"admission queue over high water (2/2)"}, True, 200)

    def test_oversized_payload_413(self):
        def scenario(port, server):
            return call(port, "POST", "/queries.json",
                        raw=b'{"qid": 1, "pad": "' + b"x" * 300 + b'"}',
                        headers={"Content-Type": "application/json"})

        assert _query_both(scenario, max_payload_bytes=100) == (
            413, None, {"message": "query payload too large (321 > 100 bytes)"})

    def test_submit_after_close_fails_fast(self):
        def scenario(port, server, run):
            b = batcher(server)
            _on_loop(run, b.close)
            with pytest.raises(RuntimeError, match="shutting down"):
                _submit(run, b, {"qid": 1})
            return call(port, "POST", "/queries.json", {"qid": 1})

        assert _query_both_with_loop(scenario) == (503, "1", {"message": "query server is shutting down"})

    def test_expired_in_queue_rejected_without_dispatch(self, monkeypatch):
        calls = []

        def make(real):
            def predict(self, model, query):
                calls.append(query.qid)
                return real(self, model, query)
            return predict

        patch_both(monkeypatch, "predict", make)
        for pkg in PACKAGES:
            clock = FakeClock()
            dead = MODULES[pkg].Deadline(0.0, clock=clock)
            clock.advance(1.0)
            with query_server(pkg) as (port, server, run):
                with pytest.raises(MODULES[pkg].DeadlineExceeded, match="expired in admission queue"):
                    _submit(run, batcher(server), {"qid": 1}, dead)
                assert batcher(server).batches_dispatched == 0
        assert calls == []

    def test_status_page_carries_batching_and_resilience(self):
        def scenario(port, server):
            call(port, "POST", "/queries.json", {"qid": 1})
            body = call(port, "GET", "/")[2]
            return body["batching"], body["resilience"]

        batching, resilience = _query_both(scenario)
        assert batching == {"batches": 1, "queries": 1, "avgBatchSize": 1.0}
        assert resilience["breakers"]["dispatch"]["state"] == "closed"

    def test_shutdown_leaves_no_server_thread_behind(self):
        import threading

        before = set(threading.enumerate())
        with query_server("port", feedback=True, event_server_url="http://127.0.0.1:9",
                          feedback_access_key="k") as (port, server, _):
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                outs = list(pool.map(lambda i: call(port, "POST", "/queries.json", {"qid": i}), range(32)))
            assert {o[0] for o in outs} == {200}
        left = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
        assert not [n for n in left if n.startswith("pio-")], left
