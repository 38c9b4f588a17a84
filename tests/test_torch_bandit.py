"""The port's bandit lanes (``predictionio_tpu_torch/bandit/`` and the query
server's bandit half) held to the JAX package's on the same inputs: the
policies' fractions, verdicts and ``p_better`` on one seed, the impression
log and reward tailer over memory and sqlite stores, ``bandit.json`` across
packages, and both query servers through one scripted rollout (same pulls
per arm, rewards, verdict sequence and final registry state, zero 5xx)."""

from __future__ import annotations

import datetime as dt
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from tests.torch_serving_helpers import MEMORY_ENV, aiohttp_served, call, wait_until
from tests.torch_template_helpers import port_storage

UTC = dt.timezone.utc
APP_NAME = "banditapp"
ENGINE = "bandittest"
V1, V2 = "v000001", "v000002"


def _jax():
    import predictionio_tpu.bandit as b

    return b


def _port():
    import predictionio_tpu_torch.bandit as b

    return b


def _arm_sequences(seed: int, n: int = 24):
    """Arm states along a rollout: pulls grow, rewards drawn per arm."""
    rng = np.random.default_rng(seed)
    out = []
    sp = cp = sr = cr = 0.0
    for _ in range(n):
        ds, dc = rng.integers(0, 12, 2)
        sp, cp = sp + ds, cp + dc
        sr += rng.binomial(int(ds), 0.3)
        cr += rng.binomial(int(dc), rng.choice([0.05, 0.3, 0.6]))
        out.append((float(sp), float(sr), float(cp), float(cr)))
    return out


@pytest.mark.parametrize("policy", ["epsilon", "thompson"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_policies_decide_bit_for_bit_as_the_reference(policy, seed):
    """The same arm states and seed give the same fraction, verdict and
    p_better in both packages (numpy draws on one explicit generator)."""
    got = {}
    for name, mod in (("jax", _jax()), ("port", _port())):
        rng = np.random.default_rng(seed)
        pol = mod.make_policy(policy, epsilon=0.15)
        crit = mod.BanditCriteria(min_pulls=10, samples=256)
        trace = []
        for sp, sr, cp, cr in _arm_sequences(seed):
            stable = mod.ArmState(V1, mod.ARM_STABLE, pulls=sp, rewards=sr)
            cand = mod.ArmState(V2, mod.ARM_CANDIDATE, pulls=cp, rewards=cr)
            frac = pol.fraction(stable, cand, crit, rng)
            d = mod.decide(stable, cand, crit, frac, rng)
            trace.append((frac, d.verdict, d.p_better, d.reason, mod.regret_proxy(stable, cand),
                          mod.p_candidate_better(stable, cand, rng, 64), stable.mean, cand.mean))
        got[name] = trace
    assert got["jax"] == got["port"]


def _jax_event(name, trace, n, reward=None):
    from predictionio_tpu.data.datamap import DataMap
    from predictionio_tpu.data.event import Event

    props = {} if trace is None else {"traceId": trace}
    if reward is not None:
        props["reward"] = reward
    t = dt.datetime(2024, 7, 1, tzinfo=UTC) + dt.timedelta(seconds=n)
    return Event(event=name, entity_type="user", entity_id=f"fb{n}", properties=DataMap(props),
                 event_time=t, creation_time=t)


def _port_event(name, trace, n, reward=None):
    from predictionio_tpu_torch.data.event import Event

    props = {} if trace is None else {"traceId": trace}
    if reward is not None:
        props["reward"] = reward
    t = dt.datetime(2024, 7, 1, tzinfo=UTC) + dt.timedelta(seconds=n)
    return Event(event=name, entity_type="user", entity_id=f"fb{n}", properties=props,
                 event_time=t, creation_time=t)


# (event name, trace id, reward property) in insertion order: history, then
# conversions of live, unknown and consumed impressions, garbage rewards
_FEED = [
    [("reward", "tr-old", None)],
    [("reward", "tr-old", None), ("reward", "tr-a", 0.25), ("reward", "tr-b", 7.5),
     ("reward", "tr-zz", None), ("reward", None, None), ("view", "tr-c", None),
     ("reward", "tr-c", "not-a-number"), ("purchase", "tr-d", -3)],
    [("reward", "tr-a", None)] + [("reward", f"tr-{i}", 0.5) for i in range(20)],
    [],
]


def _tail(pkg: str, backend: str, tmp_path):
    """Drive one tailer through _FEED; returns each poll's result and the
    impression log's length after it."""
    if pkg == "jax":
        from predictionio_tpu.data.storage.memory import MemoryStorageClient

        levents, app, mk, mod = MemoryStorageClient().l_events(), 3, _jax_event, _jax()
    else:
        storage = port_storage(tmp_path, backend)
        levents, app, mk, mod = storage.get_l_events(), 3, _port_event, _port()
    levents.init(app)
    name, trace, reward = _FEED[0][0]
    levents.insert(mk(name, trace, 1, reward), app)  # history before the bandit engaged
    tailer = mod.RewardTailer(levents, app, event_names=("reward", "purchase"), page=4, max_pages=2)
    log = mod.ImpressionLog(capacity=16)
    for trace, arm, version in [("tr-old", "candidate", V2), ("tr-a", "candidate", V2),
                                ("tr-b", "stable", V1), ("tr-c", "candidate", V2),
                                ("tr-d", "stable", V1)] + [(f"tr-{i}", "candidate", V2) for i in range(20)]:
        log.record(trace, arm, version)
    log.record("", "stable", V1)  # no trace id: nothing to match
    out = []
    n = 100
    for batch in _FEED[1:]:
        for name, trace, reward in batch:
            n += 1
            levents.insert(mk(name, trace, n, reward), app)
        for _ in range(3):
            out.append((tailer.poll(log), len(log), log.evicted))
    return out


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_impression_log_and_reward_tailer_match_as_the_reference(backend, tmp_path):
    """Cursor at the head (history never credits), one credit per
    impression, the name/trace/reward rules, the clamp, bounded pages and
    FIFO eviction: every poll equal to the JAX tailer's on a memory store."""
    assert _tail("port", backend, tmp_path) == _tail("jax", "memory", tmp_path)


def _loop_with_state(mod, store_dir):
    from importlib import import_module

    store_mod = import_module(mod.__name__.replace("bandit", "registry"))
    store = store_mod.ArtifactStore(store_dir)
    loop = mod.BanditLoop("thompson", store=store, engine_id=ENGINE, seed=0)

    class Tailer:
        def poll(self, impressions):
            return [], 0

    loop.begin(V1, V2, Tailer())
    return loop, store, Tailer


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bandit_json_of_one_package_resumes_in_the_other(writer, tmp_path):
    """A posterior persisted by either package's loop (the registry
    artifact grammar) resumes in the other's; an ended one never does."""
    reader = "port" if writer == "jax" else "jax"
    mods = {"jax": _jax(), "port": _port()}
    reg = str(tmp_path / "registry")
    loop, store, Tailer = _loop_with_state(mods[writer], reg)
    for i in range(9):
        loop.record_impression(f"s{i}", "stable", V1)
    for i in range(4):
        loop.record_impression(f"c{i}", "candidate", V2)
    loop.tick()
    other, _, _ = _loop_with_state(mods[reader], reg)
    assert other.snapshot()["stable"]["pulls"] == 9.0
    assert other.snapshot()["candidate"]["pulls"] == 4.0
    assert {k: v for k, v in other.snapshot().items() if k != "impressions_pending"} == \
        {k: v for k, v in loop.snapshot().items() if k != "impressions_pending"}
    other.end("promote")
    assert store.load_bandit_state(ENGINE)["ended"] == "promote"
    again = mods[writer].BanditLoop("thompson", store=store, engine_id=ENGINE, seed=0)
    again.begin(V1, V2, Tailer())
    assert again.snapshot()["candidate"]["pulls"] == 0.0


# ---------------------------------------------------------------------------
# both query servers through one scripted rollout
# ---------------------------------------------------------------------------


def _registry_template(tmp_path) -> str:
    """A registry with v000001 stable and v000002 published (the JAX store
    writes it; the port's reads the same grammar)."""
    from predictionio_tpu.registry import ArtifactStore, ModelManifest

    path = str(tmp_path / "registry-template")
    if os.path.exists(path):
        return path
    store = ArtifactStore(path)
    for blob in (b"one", b"two"):
        store.publish(ModelManifest(version="", engine_id=ENGINE, engine_version="1",
                                    engine_variant="engine.json"), blob)
    return path


def _jax_server(storage, registry_dir, **cfg):
    from tests.test_bandit import _bandit_server
    from tests.test_registry import _tag_lane

    server = _bandit_server(storage, Path(registry_dir), registry_dir=registry_dir, **cfg)
    server._active = _tag_lane(V1)
    return server, _tag_lane


def _port_server(storage, registry_dir, **cfg):
    from predictionio_tpu_torch.controller.engine import Engine
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest
    from tests.test_torch_registry import _tag_lane
    from tests.torch_sample_engine import Algo0, DataSource0, Preparator0, Serving0

    for k, v in (("bake_check_interval_s", 30.0), ("bandit_policy", "thompson"), ("bandit_app_name", APP_NAME),
                 ("bandit_min_pulls", 4), ("bake_window_s", 0.01), ("bake_min_requests", 4),
                 ("max_p95_ratio", 1000.0), ("max_error_ratio", 1000.0)):
        cfg.setdefault(k, v)
    engine = Engine({"": DataSource0}, {"": Preparator0}, {"": Algo0}, {"": Serving0})
    ctx = WorkflowContext(device="cpu", _storage=storage)
    server = QueryServer(
        engine, engine.engine_params_from_variant({}), [None], ctx,
        ServerConfig(ip="127.0.0.1", port=0, registry_dir=registry_dir, **cfg), f"inst-{V1}",
        manifest=EngineManifest(ENGINE, "1", "engine.json", "tests.test_engine.make_engine"),
        model_version=V1,
    )
    server._active = _tag_lane(V1)
    return server, _tag_lane


def _storage(pkg, with_app=True):
    if pkg == "jax":
        from predictionio_tpu.data.storage.base import App
        from predictionio_tpu.data.storage.registry import Storage
    else:
        from predictionio_tpu_torch.data.storage.base import App
        from predictionio_tpu_torch.data.storage.registry import Storage
    storage = Storage(env=MEMORY_ENV)
    if with_app:
        storage.get_meta_data_apps().insert(App(0, APP_NAME))
    return storage


def _untimed_state(store):
    st = store.get_state(ENGINE).to_json_dict()
    for entry in st["history"]:
        entry.pop("at")
    return {k: v for k, v in st.items() if k not in ("staged_at", "updated_at")}


def _scripted_rollout(pkg: str, tmp_path, winner: str, **cfg):
    """Stage v000002 at 0.5, then rounds of 8 queries (each with its own
    trace id), reward events for three in four answers of the arm
    ``winner`` names and one in three of the other's, one bake tick a
    round until the bandit resolves (explore ticks steer the fraction
    first). Returns everything the two packages must agree on."""
    cfg.setdefault("bandit_min_pulls", 8)
    cfg.setdefault("bandit_epsilon", 0.3)
    reg = str(tmp_path / f"registry-{pkg}")
    shutil.copytree(_registry_template(tmp_path), reg)
    storage = _storage(pkg)
    app_id = storage.get_meta_data_apps().get_by_name(APP_NAME).id
    levents = storage.get_l_events()
    make, mk_event = (_jax_server, _jax_event) if pkg == "jax" else (_port_server, _port_event)
    server, tag_lane = make(storage, reg, **cfg)
    server.stage_candidate_lane(tag_lane(V2), fraction=0.5)
    verdicts = []
    orig_tick = server.bandit.tick

    def recording_tick():
        d = orig_tick()
        verdicts.append(None if d is None else (d.verdict, d.fraction, d.p_better, d.reason))
        return d

    server.bandit.tick = recording_tick
    statuses, answers, n_event = [], [], 0

    def drive(port, tick):
        nonlocal n_event
        for rnd in range(30):
            traces = []
            for i in range(rnd * 8, rnd * 8 + 8):
                trace = f"{i:016x}"
                status, _, body = call(port, "POST", "/queries.json", {"qid": i, "user": f"u{i}"},
                                       headers={"X-Pio-Trace-Id": trace})
                statuses.append(status)
                answers.append(body)
                traces.append((i, trace))
            for i, trace in traces:
                hit = server.bandit.impressions.peek(trace) if server.bandit.active else None
                if hit is not None and (i % 4 != 0 if hit[0] == winner else i % 3 == 0):
                    n_event += 1
                    levents.insert(mk_event("reward", trace, n_event), app_id)
            tick()
            if server._candidate is None:
                return

    if pkg == "jax":
        with aiohttp_served(server.make_app()) as (port, run, _):
            drive(port, lambda: run(server._rollout_tick()))
    else:
        port = server.start()
        try:
            drive(port, server._rollout_tick)
        finally:
            server.shutdown()
    ins = server.bandit_instruments
    saved = server.registry_store.load_bandit_state(ENGINE)
    return {
        "statuses": statuses,
        "answers": answers,
        "verdicts": verdicts,
        "stable": server.model_version,
        "candidate": None if server._candidate is None else server._candidate.version,
        "bandit_json": saved,
        "registry": _untimed_state(server.registry_store),
        "counters": {
            "pulls": {arm: ins.pulls.value(arm=arm) for arm in ("stable", "candidate")},
            "rewards": {arm: ins.rewards.value(arm=arm) for arm in ("stable", "candidate")},
            "matched": ins.matched.value(),
            "unmatched": ins.unmatched.value(),
            "promoted": ins.promoted.value(),
            "retired": ins.retired.value(),
            "active": ins.active.value(),
        },
    }


@pytest.mark.parametrize("winner,outcome", [("candidate", "promote"), ("stable", "retire")])
def test_both_query_servers_run_one_scripted_rollout_alike(winner, outcome, tmp_path):
    got = {pkg: _scripted_rollout(pkg, tmp_path, winner) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert set(port["statuses"]) == {200}  # zero 5xx
    assert port["verdicts"][-1][0] == outcome
    assert port["bandit_json"]["ended"] == outcome
    assert port["stable"] == (V2 if outcome == "promote" else V1)
    assert port["counters"]["active"] == 0.0
    assert port["counters"]["matched"] == port["bandit_json"]["stable"]["rewards"] + \
        port["bandit_json"]["candidate"]["rewards"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_tailer_that_cannot_be_built_degrades_to_the_plain_gate(pkg, tmp_path):
    """No reward app: the engage fails, the stage survives, and the plain
    bake gate promotes on time and health."""
    reg = str(tmp_path / "registry")
    shutil.copytree(_registry_template(tmp_path), reg)
    make = _jax_server if pkg == "jax" else _port_server
    server, tag_lane = make(_storage(pkg, with_app=False), reg)
    server.stage_candidate_lane(tag_lane(V2), fraction=1.0)
    assert not server.bandit.active and server._candidate is not None
    if pkg == "jax":
        with aiohttp_served(server.make_app()) as (port, run, _):
            for i in range(6):
                assert call(port, "POST", "/queries.json", {"qid": i, "user": f"u{i}"})[0] == 200
            run(server._rollout_tick())
    else:
        port = server.start()
        try:
            for i in range(6):
                assert call(port, "POST", "/queries.json", {"qid": i, "user": f"u{i}"})[0] == 200
            server._rollout_tick()
        finally:
            server.shutdown()
    assert server.model_version == V2
    assert server.bandit_instruments.active.value() == 0.0
    assert server.bandit_instruments.promoted.value() == 0.0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_no_policy_configured_means_no_bandit(pkg, tmp_path):
    make = _jax_server if pkg == "jax" else _port_server
    server, _ = make(_storage(pkg), str(tmp_path / "registry"), bandit_policy=None)
    assert server.bandit is None
    assert server.bandit_instruments.active.value() == 0.0
    if pkg == "port":
        assert server.status()["bandit"] is None


def test_status_carries_the_live_posterior(tmp_path):
    """``GET /`` of the port's server shows the bandit block as the JAX
    server's does."""
    out = {}
    for pkg in ("jax", "port"):
        make = _jax_server if pkg == "jax" else _port_server
        server, tag_lane = make(_storage(pkg), str(tmp_path / f"registry-{pkg}"))
        server.stage_candidate_lane(tag_lane(V2), fraction=0.5, persist=False)
        if pkg == "jax":
            with aiohttp_served(server.make_app()) as (port, run, _):
                for i in range(10):
                    call(port, "POST", "/queries.json", {"qid": i, "user": f"u{i}"},
                         headers={"X-Pio-Trace-Id": f"{i:016x}"})
                out[pkg] = call(port, "GET", "/")[2]["bandit"]
        else:
            port = server.start()
            try:
                for i in range(10):
                    call(port, "POST", "/queries.json", {"qid": i, "user": f"u{i}"},
                         headers={"X-Pio-Trace-Id": f"{i:016x}"})
                out[pkg] = call(port, "GET", "/")[2]["bandit"]
            finally:
                server.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"]["active"] is True and out["port"]["impressions_pending"] == 10
    assert json.dumps(out["port"])  # JSON-ready


def test_keep_alive_clients_hold_neither_a_retired_lane_nor_a_shut_down_server(tmp_path):
    """Four clients keep their connections open across a bandit retire
    and the shutdown: the retired candidate's model is freed while they
    stay open, and so is the shut-down server with its stable lane."""
    import concurrent.futures
    import gc
    import http.client
    import weakref

    reg = str(tmp_path / "registry")
    shutil.copytree(_registry_template(tmp_path), reg)
    storage = _storage("port")
    app_id = storage.get_meta_data_apps().get_by_name(APP_NAME).id
    levents = storage.get_l_events()
    server, tag_lane = _port_server(storage, reg)
    cand = tag_lane(V2)
    cand_model, stable_model = weakref.ref(cand.models[0]), weakref.ref(server._active.models[0])
    server.stage_candidate_lane(cand, fraction=0.5)
    del cand
    assert server.bandit.active
    port = server.start()
    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=10) for _ in range(4)]

    def ask(k: int, rnd: int) -> list[tuple[str, int]]:
        out = []
        for i in range(rnd * 16 + k * 4, rnd * 16 + k * 4 + 4):
            trace = f"{i:016x}"
            conns[k].request("POST", "/queries.json", body=json.dumps({"qid": i, "user": f"u{i}"}),
                             headers={"Content-Type": "application/json", "X-Pio-Trace-Id": trace})
            resp = conns[k].getresponse()
            resp.read()
            out.append((trace, resp.status))
        return out

    n_event = 0
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            for rnd in range(30):
                answered = [a for part in pool.map(ask, range(4), [rnd] * 4) for a in part]
                assert {status for _, status in answered} == {200}
                for trace, _ in answered:
                    hit = server.bandit.impressions.peek(trace) if server.bandit.active else None
                    if hit is not None and hit[0] == "stable":  # only the stable converts
                        n_event += 1
                        levents.insert(_port_event("reward", trace, n_event), app_id)
                server._rollout_tick()
                if server._candidate is None:
                    break
        assert server.bandit_instruments.retired.value() == 1.0 and server.model_version == V1
        gc.collect()
        assert cand_model() is None, "the retired candidate outlived its last batch"
    finally:
        server.shutdown()
    del server

    def freed() -> bool:
        gc.collect()
        return stable_model() is None

    # the hung-up handler threads return on their own schedule
    wait_until(freed, 5.0, "the shut-down server freed under open keep-alive connections")
    for conn in conns:
        conn.close()
