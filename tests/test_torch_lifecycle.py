"""The port's lifecycle controller (``predictionio_tpu_torch/lifecycle/``)
held to the JAX package's: the scripted inputs of
``tests/test_lifecycle.py``'s policy and controller tests run through both
packages (decisions, ring records and ``lifecycle.json`` equal), a state
file of one package resumes in the other, ``pio lifecycle
trigger|pause|resume|status`` write and print alike, the in-process grid's
device, and a CPU end-to-end through the port's CLI processes: drift line →
retune → canary → scripted rewards → bandit promote → cache warm."""

from __future__ import annotations

import http.client
import inspect
import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest

import tests.test_lifecycle as ref
from tests.torch_template_helpers import write_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names tests/test_lifecycle.py's scripted tests take from the package
_PKG_NAMES = ("LifecycleConfig", "LifecycleController", "LifecycleInputs", "LifecyclePolicy",
              "read_json_file", "register_lifecycle_metrics", "replay_queries", "write_control")


def _pkg(which: str):
    if which == "jax":
        import predictionio_tpu.lifecycle as lc
        import predictionio_tpu.lifecycle.policy as policy
        import predictionio_tpu.registry as registry
    else:
        import predictionio_tpu_torch.lifecycle as lc
        import predictionio_tpu_torch.lifecycle.policy as policy
        import predictionio_tpu_torch.registry as registry
    return lc, policy, registry


def _patch(monkeypatch, which: str, trace: list, rings: list, incidents: list) -> None:
    """Point tests/test_lifecycle.py at one package and record what its
    scripted tests feed the policy and what the controller writes."""
    import predictionio_tpu.registry

    lc, policy, registry = _pkg(which)
    for name in _PKG_NAMES:
        monkeypatch.setattr(ref, name, getattr(lc, name))
    for name in dir(policy):
        if name.isupper() and hasattr(ref, name):
            monkeypatch.setattr(ref, name, getattr(policy, name))
    monkeypatch.setattr(ref, "ArtifactStore", registry.ArtifactStore)
    monkeypatch.setattr(ref, "ModelManifest", registry.ModelManifest)
    # the controller tests import the probe inside their bodies
    monkeypatch.setattr(predictionio_tpu.registry, "registry_rollout_probe", registry.registry_rollout_probe)

    class RecordingPolicy(lc.LifecyclePolicy):
        def decide(self, inp, now):
            d = super().decide(inp, now)
            trace.append((now, d.to_json_dict(), self.to_json_dict()))
            return d

    monkeypatch.setattr(ref, "LifecyclePolicy", RecordingPolicy)

    class RecordingRing(ref.FakeRing):
        def __init__(self, clock):
            super().__init__(clock)
            rings.append(self)

    class RecordingIncidents(ref.FakeIncidents):
        def __init__(self):
            super().__init__()
            incidents.append(self)

    monkeypatch.setattr(ref, "FakeRing", RecordingRing)
    monkeypatch.setattr(ref, "FakeIncidents", RecordingIncidents)


def _run_reference_test(monkeypatch, which, cls_name, test_name, tmp_path):
    trace, rings, incidents = [], [], []
    with monkeypatch.context() as m:
        _patch(m, which, trace, rings, incidents)
        method = getattr(getattr(ref, cls_name)(), test_name)
        base = tmp_path / which
        base.mkdir()
        if "tmp_path" in inspect.signature(method).parameters:
            method(base)
        else:
            method()
    states = {}
    for root, _, files in os.walk(tmp_path / which):
        if "lifecycle.json" in files:
            states[os.path.relpath(root, tmp_path / which)] = ref.read_json_file(
                os.path.join(root, "lifecycle.json"))
    return {
        "decisions": trace,
        "ring": [r.records_list for r in rings],
        "incidents": [i.triggers for i in incidents],
        "states": states,
    }


def _tests_of(prefix: str, only=None):
    out = []
    for cls_name in sorted(n for n in dir(ref) if n.startswith(prefix)):
        for test_name in sorted(n for n in dir(getattr(ref, cls_name)) if n.startswith("test_")):
            if only is None or test_name in only:
                out.append((cls_name, test_name))
    return out


@pytest.mark.parametrize("cls_name,test_name", _tests_of("TestPolicy"))
def test_policy_decisions_equal_the_reference(cls_name, test_name, monkeypatch, tmp_path):
    """Every scripted input of the reference's TestPolicy* classes (fake
    clock): the same decision and policy state after each decide, and the
    reference's assertions hold for the port too."""
    got = {w: _run_reference_test(monkeypatch, w, cls_name, test_name, tmp_path) for w in ("jax", "port")}
    assert got["port"] == got["jax"]


CONTROLLER_TESTS = (
    "test_full_promote_loop", "test_defer_mid_bake_never_concurrent",
    "test_rollback_closes_episode_with_incident", "test_grid_failure_aborts_with_incident_context",
    "test_no_candidate_aborts", "test_tune_timeout_abandons_grid", "test_bake_timeout_unstages_candidate",
    "test_warm_failure_never_rolls_back_promote", "test_manual_trigger_and_pause_via_control_file",
    "test_sigkill_resume_relaunches_grid_with_resume", "test_triggered_and_baking_states_survive_restart",
)


@pytest.mark.parametrize("cls_name,test_name", _tests_of("TestLifecycleController", CONTROLLER_TESTS))
def test_controller_runs_the_reference_scripts_alike(cls_name, test_name, monkeypatch, tmp_path):
    """The reference's controller scripts (fake ring, fake incidents, fake
    tune, a real registry): the same decisions, ring records, incident
    triggers and lifecycle.json in both packages (promote, rollback, grid
    failure, tune and bake timeouts, a SIGKILL resume)."""
    got = {w: _run_reference_test(monkeypatch, w, cls_name, test_name, tmp_path) for w in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert got["port"]["ring"] and got["port"]["states"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("stop_in", ["tuning", "baking"])
def test_a_state_file_of_one_package_resumes_in_the_other(writer, stop_in, tmp_path):
    """Controller 1 (one package) runs to TUNING or BAKING and is dropped;
    controller 2 (the other package) restores the episode from
    lifecycle.json: a TUNING grid relaunches with resume=True, a BAKING
    candidate resolves on the registry's promote."""
    reader = "port" if writer == "jax" else "jax"
    lcw, _, regw = _pkg(writer)
    lcr, _, regr = _pkg(reader)
    registry_dir, state_dir = str(tmp_path / "registry"), str(tmp_path / "state")
    store = regw.ArtifactStore(registry_dir)
    def manifest():
        return regw.ModelManifest(version="", engine_id="e", engine_version="1", engine_variant="v")

    store.publish(manifest(), b"one")
    clock = ref.Clock()
    ring = ref.FakeRing(clock)
    calls: list[tuple[str, bool]] = []

    def tune_for(who):
        def tune(resume):
            calls.append((who, resume))
            if who == writer and stop_in == "tuning":
                return ""  # controller 1 is dropped before this lands
            m = store.publish(manifest(), b"winner")
            store.stage_candidate("e", m.version, fraction=0.5)
            return m.version
        return tune

    def build(lc, reg, who):
        return lc.LifecycleController(
            lc.LifecyclePolicy(lc.LifecycleConfig(drift_window_s=600.0, cooldown_s=600.0)),
            state_dir=state_dir, engine_id="e", registry_dir=registry_dir, tune=tune_for(who),
            rollout_probe=reg.registry_rollout_probe(registry_dir), ring=ring, clock=clock,
        )

    c1 = build(lcw, regw, writer)
    ring.append({"kind": "drift", "t": clock(), "seq": 0, "engine": "e"})
    c1.tick(), c1.tick()  # TRIGGER, START_TUNE
    ref._join_grid(c1)
    if stop_in == "baking":
        assert c1.tick().action == "bake"
    state = ref.read_json_file(os.path.join(state_dir, "lifecycle.json"))
    assert state["policy"]["state"] == stop_in
    c2 = build(lcr, regr, reader)
    assert c2.policy.state == stop_in
    if stop_in == "tuning":
        ref._join_grid(c2)
        assert calls[-1] == (reader, True)
        assert c2.tick().action == "bake"
    assert c2.policy.staged_version == "v000002"
    store.promote("e")
    d = c2.tick()
    assert d.action == "warm" and d.outcome == "promoted"
    assert ref.read_json_file(os.path.join(state_dir, "lifecycle.json"))["policy"]["lastOutcome"] == "promoted"


def _cli(which: str, capsys, *argv):
    if which == "jax":
        from predictionio_tpu.tools.cli import main
    else:
        from predictionio_tpu_torch.tools.cli import main
    code = main(list(argv))
    out = capsys.readouterr()
    return code, out.out, out.err


def test_trigger_pause_resume_and_status_write_and_print_alike(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")
    status = {
        "engine": "myengine",
        "policy": {"state": "baking", "stagedVersion": "v000007", "triggerReason": "drift", "lastOutcome": ""},
        "grid": {"state": "", "stagedVersion": "", "error": ""},
        "paused": False,
        "lastDecision": {"action": "hold", "reason": "baking"},
    }
    got = {}
    for which in ("jax", "port"):
        obs = str(tmp_path / which / "obs")
        steps = [_cli(which, capsys, "lifecycle", "status", "--obs-dir", obs)[:2]]
        for verb in ("trigger", "pause", "trigger", "resume"):
            steps.append(_cli(which, capsys, "lifecycle", verb, "--obs-dir", obs)[:2])
            with open(os.path.join(obs, "lifecycle", "lifecycle-control.json")) as fh:
                steps.append(fh.read())
        with open(os.path.join(obs, "lifecycle", "lifecycle.json"), "w") as fh:
            json.dump(status, fh)
        steps.append(_cli(which, capsys, "lifecycle", "status", "--obs-dir", obs)[:2])
        steps.append(_cli(which, capsys, "lifecycle", "status", "--obs-dir", obs, "--json")[:2])
        steps.append(_cli(which, capsys, "lifecycle", "status", "--state-dir",
                          os.path.join(obs, "lifecycle"), "--json")[:2])
        got[which] = steps
    assert got["port"] == got["jax"]
    assert got["port"][0][0] != 0 and "v000007" in got["port"][-3][1]


@pytest.mark.parametrize("flag", [[], ["--device", "cuda"]])
def test_the_in_process_grid_of_the_cpu_fallback_class_runs_on_the_cpu(flag, tmp_path, monkeypatch):
    """With worker_class="cpu-fallback" and workers=0 the port's cells get
    device="cpu" (the JAX package pins only its worker processes), and
    their metric equals the JAX grid's on the same events."""
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.eval import Evaluation as JaxEvaluation
    from predictionio_tpu.eval import metric as jax_metric
    from predictionio_tpu.models.classification import engine as jax_cl
    from predictionio_tpu.tuning import run_grid as jax_run_grid
    from predictionio_tpu_torch.eval import Evaluation
    from predictionio_tpu_torch.eval import metric as pt_metric
    from predictionio_tpu_torch.models.classification import engine as pt_cl
    from predictionio_tpu_torch.tuning import WORKER_CLASS_CPU_FALLBACK, runner
    from predictionio_tpu_torch.tuning import run_grid
    from tests.test_torch_classification import _events
    from tests.test_torch_tuning import _jax_classification_params, _nb_variant
    from tests.torch_template_helpers import jax_store, port_store

    def accuracy(mod):
        return type("Accuracy", (mod.AverageMetric,), {
            "calculate_score": lambda self, ei, q, p, a: float(p.label == a.label)})()

    events = write_events(tmp_path / "cls.jsonl", _events(n=60, seed=5))
    jax_storage = JaxStorage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEM" for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    })
    jctx = jax_store(jax_storage, "clsapp", events)
    monkeypatch.setattr(JaxStorage, "_singleton", jax_storage)
    lams = (0.5, 2.0)
    jrep = jax_run_grid(
        JaxEvaluation(engine=jax_cl.engine_factory(), metric=accuracy(jax_metric),
                      engine_params_generator=[_jax_classification_params(x) for x in lams]),
        workdir=str(tmp_path / "jax"), workers=0, ctx=jctx, worker_class="cpu-fallback",
    )
    devices = []
    original = runner.CellScorer.from_evaluation

    def recording(evaluation, ctx=None, batch_size=0):
        devices.append(str(ctx.device))
        return original(evaluation, ctx=ctx, batch_size=batch_size)

    monkeypatch.setattr(runner.CellScorer, "from_evaluation", staticmethod(recording))
    pctx = port_store(tmp_path, "clsapp", events, mode="evaluation")
    asked = types.SimpleNamespace(device="cuda", _storage=pctx._storage, batch="") if flag else pctx
    peng = pt_cl.engine_factory()
    prep = run_grid(
        Evaluation(engine=peng, metric=accuracy(pt_metric),
                   engine_params_generator=[peng.engine_params_from_variant(_nb_variant(x)) for x in lams]),
        workdir=str(tmp_path / "port"), workers=0, ctx=asked, worker_class=WORKER_CLASS_CPU_FALLBACK,
    )
    assert devices == ["cpu"]
    assert [s["foldScores"] for s in prep.scores] == [s["foldScores"] for s in jrep.scores]
    assert prep.best_params_index == jrep.best_params_index


# ---------------------------------------------------------------------------
# the CPU end-to-end through the port's CLI processes
# ---------------------------------------------------------------------------

E2E_APP = "lifecycleapp"
E2E_ENGINE = "lifecycle-e2e"

_GRID_MODULE = """
from predictionio_tpu_torch.eval import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import engine_factory
from predictionio_tpu_torch.tuning.metrics import PrecisionAtK

VARIANT = {variant!r}


def make_evaluation():
    engine = engine_factory()
    params = [engine.engine_params_from_variant({{**VARIANT, "algorithms": [{{"name": "als", "params": {{
        **VARIANT["algorithms"][0]["params"], "rank": rank}}}}]}}) for rank in (3, 5)]
    return Evaluation(engine=engine, metric=PrecisionAtK(k=3), engine_params_generator=params)
"""


def _rate_lines(n_users=16, n_items=10):
    out, k = [], 0
    for u in range(n_users):
        for i in range(n_items):
            if (u * 7 + i * 3) % 4 == 0:
                continue
            out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "properties": {"rating": float(1 + (u + i) % 5)},
                        "eventTime": f"2024-03-01T00:{k // 60:02d}:{k % 60:02d}.000Z"})
            k += 1
    return out


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.getheader("X-Pio-Model-Version"), json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _requests_total(port) -> float:
    from predictionio_tpu_torch.tools.top import parse_prometheus

    parsed = parse_prometheus(_get(port, "/metrics")[1])
    return sum(v for lab, v in parsed.get("pio_requests_total", []) if lab.get("endpoint") == "/queries.json")


def _cache_hits(port) -> float:
    from predictionio_tpu_torch.tools.top import parse_prometheus

    return sum(v for _, v in parse_prometheus(_get(port, "/metrics")[1]).get("pio_cache_hits_total", []))


def _until(pred, timeout, what, procs=()):
    deadline = time.monotonic() + timeout
    while True:
        value = pred()
        if value:
            return value
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(f"{what}: a process exited {p.returncode}:\n{p.stdout.read()[-3000:]}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.05)


# ``deploy`` through the CLI with the latency gate's ServerConfig field
# (``max_p95_ratio``, a JAX field with no CLI flag) set to 1000, as
# tests/test_bandit.py's server helper sets it: sub-millisecond CPU predicts
# make a scheduler hiccup many times a lane's p95, so the gate would judge
# the host's load
_DEPLOY_WITHOUT_LATENCY_GATE = (
    "import dataclasses, sys\n"
    "from predictionio_tpu_torch.tools import cli\n"
    "from predictionio_tpu_torch.workflow import create_server\n"
    "create_server.ServerConfig = dataclasses.make_dataclass(\n"
    "    'ServerConfig', [('max_p95_ratio', float, 1000.0)], bases=(create_server.ServerConfig,))\n"
    "sys.exit(cli.main(sys.argv[1:]))\n"
)


def test_cpu_cli_drift_retune_bandit_promote_warm(tmp_path):
    """Every step a process of the port's CLI on the CPU: app new, import,
    train --registry-dir (v000001), deploy --registry-dir --bandit thompson,
    lifecycle run (grid in-process on the CPU) — a drift line on the ring
    starts the episode, the grid's winner lands as the canary, rewards for
    the candidate's answers (matched by trace id) promote it through the
    bandit, and the controller warms at most 8 queries, which are cache
    hits afterwards. Zero 5xx."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.lifecycle import read_json_file
    from predictionio_tpu_torch.obs.tsring import TelemetryRing
    from predictionio_tpu_torch.registry import ArtifactStore
    from predictionio_tpu_torch.workflow.batch_predict import iter_event_users

    home, project, registry = tmp_path / "home", tmp_path / "project", str(tmp_path / "registry")
    project.mkdir()
    obs = str(tmp_path / "obs")
    variant = json.loads(open(os.path.join(REPO, "predictionio_tpu_torch/models/recommendation/engine.json")).read())
    variant["id"] = E2E_ENGINE
    variant["datasource"]["params"]["appName"] = E2E_APP
    variant["algorithms"][0]["params"].update(rank=4, numIterations=2)
    (project / "engine.json").write_text(json.dumps(variant))
    (project / "grid_eval.py").write_text(_GRID_MODULE.format(variant={**variant, "datasource": {"params": {
        **variant["datasource"]["params"], "evalParams": {"kFold": 2, "queryNum": 3}}}}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_")}
    env["PYTHONPATH"] = REPO
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(home)]

    def run(*args):
        out = subprocess.run([*cli, *args], env=env, cwd=str(project), capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, f"{args[:2]}: {out.stderr[-3000:]}"
        return out.stdout

    run("app", "new", E2E_APP)
    run("import", "--appname", E2E_APP, "--input", str(write_events(tmp_path / "ev.jsonl", _rate_lines())))
    ed = ["--engine-dir", str(project), "--device", "cpu"]
    run("train", *ed, "--registry-dir", registry)
    s = __import__("socket").socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DEPLOY_WITHOUT_LATENCY_GATE, "--home", str(home), "deploy", *ed,
             "--ip", "127.0.0.1", "--port", str(port), "--registry-dir", registry,
             "--registry-sync-interval", "0.1", "--bake-window", "0.2", "--bake-min-requests", "4",
             "--bandit", "thompson", "--bandit-app-name", E2E_APP, "--bandit-min-pulls", "4",
             "--bandit-epsilon", "0.3", "--profile-dir", str(tmp_path / "profiles")],
            env=env, cwd=str(project), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

        def up():
            try:
                return _get(port, "/")[0] == 200
            except OSError:
                return False

        _until(up, 60, "deploy answering GET /", procs)
        assert json.loads(_get(port, "/models")[1])["controller"]["criteria"]["max_p95_ratio"] == 1000.0
        procs.append(subprocess.Popen(
            [*cli, "lifecycle", "run", "grid_eval.make_evaluation", "--engine-dir", str(project),
             "--registry-dir", registry, "--obs-dir", obs, "--workers", "0", "--tick-interval", "0.1",
             "--cooldown", "9999", "--stage-fraction", "0.3", "--serve-url", f"http://127.0.0.1:{port}",
             "--app-name", E2E_APP, "--warm-limit", "8"],
            env=env, cwd=str(project), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        # the drift line pio stream --obs-dir appends on a breached guard
        TelemetryRing(os.path.join(obs, "telemetry"), writer_id="stream").append({
            "kind": "drift", "engine": E2E_ENGINE, "trainer": "als", "guard": "holdout_rmse",
            "measured": 9.9, "threshold": 0.5, "reason": "a breach"})
        store = ArtifactStore(registry)
        state_path = os.path.join(obs, "lifecycle", "lifecycle.json")
        _until(lambda: (read_json_file(state_path) or {}).get("policy", {}).get("state") == "baking",
               60, "the grid's winner baking", procs)
        winner = store.get_state(E2E_ENGINE).candidate
        assert winner == "v000002"
        _until(lambda: json.loads(_get(port, "/")[1])["bandit"]["active"], 20, "the bandit engaging", procs)
        storage = Storage(env={"PIO_FS_BASEDIR": str(home)})  # the store the CLI's --home names
        app_id = storage.get_meta_data_apps().get_by_name(E2E_APP).id
        levents = storage.get_l_events()
        statuses, n = [], 0
        while store.get_state(E2E_ENGINE).stable != winner:
            assert n < 400, f"no bandit promote after {n} queries: {store.get_state(E2E_ENGINE).history}"
            trace = f"{n:016x}"
            status, version, _ = _post(port, "/queries.json", {"user": f"u{n % 16}", "num": 3},
                                       {"X-Pio-Trace-Id": trace})
            statuses.append(status)
            if version == winner:
                levents.insert(Event(event="reward", entity_type="user", entity_id=f"u{n % 16}",
                                     properties={"traceId": trace}), app_id)
            n += 1
            time.sleep(0.01)
        before_warm = _requests_total(port)
        done = _until(lambda: (s := read_json_file(state_path)) and s["policy"]["state"] == "idle" and s,
                      30, "the episode closing", procs)
        assert done["policy"]["lastOutcome"] == "promoted" and done["lastDecision"]["action"] == "warm"
        warmed = _requests_total(port) - before_warm
        assert 0 < warmed <= 8
        bandit_json = store.load_bandit_state(E2E_ENGINE)
        assert bandit_json["ended"] == "promote" and bandit_json["candidate"]["version"] == winner
        assert set(statuses) == {200}
        hits = _cache_hits(port)
        queries = [q for _, q in iter_event_users(levents, app_id, limit=8)]
        for q in queries:
            assert _post(port, "/queries.json", q)[0] == 200
        assert _cache_hits(port) - hits == len(queries) == warmed
        events = [r.get("event") for r in TelemetryRing(os.path.join(obs, "telemetry")).records()
                  if r.get("kind") == "lifecycle"]
        assert events == ["triggered", "tuning", "baking", "finished"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
