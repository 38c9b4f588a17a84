"""The port's model registry and rollout lanes on the CPU
(``predictionio_tpu_torch/registry/``, the query server's rollout half,
the ``models`` verbs, ``train --registry-dir``, ``deploy --registry-dir``,
``eval --publish``), held to the JAX package on the same inputs: blobs
(PIOTPU01 and 02), manifests, a registry either package wrote read by the
other, sticky buckets and lanes for 10,000 keys, the rollout controller's
verdicts on the same fake-clock metric sequences, and the server's canary,
shadow, promote, rollback and ``/reload`` on ``device="cpu"``."""

from __future__ import annotations

import concurrent.futures
import gc
import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request
import weakref
import zlib

import numpy as np
import pytest

from predictionio_tpu_torch import convert
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.registry import (
    ArtifactIntegrityError,
    ArtifactStore,
    Lane,
    ModelManifest,
    PromotionCriteria,
    RolloutController,
    RolloutInstruments,
    params_hash_of,
    sticky_bucket,
)
from predictionio_tpu_torch.registry.router import LANE_CANDIDATE, LANE_STABLE, RolloutPlan, choose_lane, routing_key
from predictionio_tpu_torch.resilience.breaker import CLOSED
from predictionio_tpu_torch.workflow import model_io
from tests.torch_template_helpers import REPO, port_storage, write_events


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


# ---------------------------------------------------------------------------
# model blobs: PIOTPU01 (C6) and PIOTPU02
# ---------------------------------------------------------------------------


class TestModelBlobs:
    @pytest.mark.parametrize("payload", [[1, 2, 3], [{"w": [1.0, 2.0]}, "second"], [None]])
    def test_v01_blob_reads_the_same_in_both_packages(self, payload):
        from predictionio_tpu.workflow import model_io as jax_model_io

        legacy = jax_model_io.MAGIC_V1 + zlib.compress(pickle.dumps(payload))
        assert model_io.MAGIC_V1 == jax_model_io.MAGIC_V1
        assert model_io.deserialize_models(legacy) == jax_model_io.deserialize_models(legacy) == payload

    @pytest.mark.parametrize("cut", [1, 4, 20])
    def test_truncated_v01_blob_is_an_integrity_error_in_both(self, cut):
        from predictionio_tpu.workflow import model_io as jax_model_io

        legacy = model_io.MAGIC_V1 + zlib.compress(pickle.dumps(list(range(100))))
        with pytest.raises(jax_model_io.ModelIntegrityError):
            jax_model_io.deserialize_models(legacy[:-cut])
        with pytest.raises(model_io.ModelIntegrityError):
            model_io.deserialize_models(legacy[:-cut])

    def test_jax_v01_als_blob_serves_in_the_port(self):
        from predictionio_tpu.models.recommendation.engine import ALSModel as JALSModel

        rng = np.random.default_rng(0)
        jm = JALSModel(rng.normal(size=(3, 2)).astype(np.float32), rng.normal(size=(4, 2)).astype(np.float32),
                       ["a", "b", "c"], list("wxyz"))
        (m,) = model_io.deserialize_models(model_io.MAGIC_V1 + zlib.compress(pickle.dumps([jm])))
        assert type(m).__module__ == "predictionio_tpu_torch.models.recommendation.engine"
        np.testing.assert_array_equal(m.user_factors, jm.user_factors)

    def test_v02_bitflip_and_bad_magic(self):
        blob = bytearray(model_io.serialize_models([list(range(100))]))
        blob[len(blob) // 2] ^= 0xFF
        with pytest.raises(model_io.ModelIntegrityError, match="sha256"):
            model_io.deserialize_models(bytes(blob))
        with pytest.raises(model_io.ModelIntegrityError):
            model_io.deserialize_models(b"NOTPIO00" + b"x" * 64)


# ---------------------------------------------------------------------------
# manifests and the store, across packages
# ---------------------------------------------------------------------------


def _random_params(seed):
    rng = np.random.default_rng(seed)
    return {
        f"k{int(rng.integers(0, 9))}": [float(rng.normal()), {"b": int(rng.integers(0, 5)), "a": "x"}]
        for _ in range(4)
    }


@pytest.mark.parametrize("seed", range(6))
def test_params_hash_equals_the_reference(seed):
    from predictionio_tpu.registry import params_hash_of as jhash

    params = _random_params(seed)
    shuffled = dict(reversed(list(params.items())))
    assert params_hash_of(params) == params_hash_of(shuffled) == jhash(params)


def _manifest(cls=ModelManifest, engine_id="store-test", **kw):
    defaults = dict(version="", engine_id=engine_id, engine_version="1", engine_variant="engine.json",
                    engine_factory="pkg.mod.engine")
    defaults.update(kw)
    return cls(**defaults)


def _drive(store, manifest_cls, engine_id):
    """The same registry history through either package's store."""
    store.publish(_manifest(manifest_cls, engine_id, instance_id="i1", params_hash="p1"), b"blob-one")
    store.publish(_manifest(manifest_cls, engine_id, instance_id="i2", metrics={"ndcg": 0.4}), b"blob-two")
    store.publish(_manifest(manifest_cls, engine_id, instance_id="i3"), b"blob-one")  # deduplicated
    store.stage_candidate(engine_id, "v000002", mode="canary", fraction=0.25)
    store.promote(engine_id)
    store.publish(_manifest(manifest_cls, engine_id, instance_id="i4"), b"blob-four")
    store.stage_candidate(engine_id, "v000004", mode="shadow")
    store.attach_eval_evidence(engine_id, "v000004", {"metric": "p@10", "bestScore": 0.5})
    store.unstage(engine_id, reason="manual")
    store.gc(engine_id, keep_last=3)


def _tree(base):
    out = {}
    for root, _, names in os.walk(base):
        for name in names:
            path = os.path.join(root, name)
            out[os.path.relpath(path, base)] = open(path, "rb").read()
    return out


_TIMES = {"created_at", "at", "updated_at", "evaluatedAt", "staged_at"}


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_registry_either_package_writes_is_the_others(tmp_path, writer):
    """The same operations through both stores give the same files (names,
    blob bytes, JSON without its timestamps); each store reads the other's
    states, manifests and blobs."""
    from predictionio_tpu.registry import ArtifactStore as JStore
    from predictionio_tpu.registry import ModelManifest as JManifest

    engine_id = "/abs/engine dir"  # ids may be paths: the key is a digest
    _drive(JStore(str(tmp_path / "jax")), JManifest, engine_id)
    _drive(ArtifactStore(str(tmp_path / "port")), ModelManifest, engine_id)
    jtree, ptree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(jtree) == sorted(ptree)
    for name in jtree:
        if name.endswith(".lease"):  # owner, pid and times of the writer
            assert json.loads(jtree[name]).keys() == json.loads(ptree[name]).keys(), name
        elif name.endswith(".json"):
            assert _untimed(json.loads(jtree[name])) == _untimed(json.loads(ptree[name])), name
        else:
            assert jtree[name] == ptree[name], name
    written = tmp_path / writer
    readers = (JStore(str(written)), ArtifactStore(str(written)))
    states = [r.get_state(engine_id).to_json_dict() for r in readers]
    assert states[0] == states[1]
    assert states[0]["stable"] == "v000002" and states[0]["candidate"] == ""
    versions = [[m.to_json_dict() for m in r.list_versions(engine_id)] for r in readers]
    assert versions[0] == versions[1] and len(versions[0]) == 4  # gc keeps the newest 3 and the stable
    for m in versions[0]:
        assert readers[0].load_blob(engine_id, m["version"]) == readers[1].load_blob(engine_id, m["version"])
    assert readers[1].engine_key(engine_id) == readers[0].engine_key(engine_id)
    assert readers[1].state_generation(engine_id) == readers[0].state_generation(engine_id)


class TestArtifactStore:
    def test_publish_assigns_versions_and_auto_stable(self, tmp_path):
        store = ArtifactStore(str(tmp_path))
        m1 = store.publish(_manifest(instance_id="i1"), b"blob-one")
        m2 = store.publish(_manifest(instance_id="i2"), b"blob-two")
        assert (m1.version, m2.version, m2.parent_version) == ("v000001", "v000002", "v000001")
        state = store.get_state("store-test")
        assert state.stable == "v000001"
        assert [h["action"] for h in state.history][:2] == ["publish", "auto-stable"]

    def test_load_blob_verifies_sha256_and_length(self, tmp_path):
        store = ArtifactStore(str(tmp_path))
        m = store.publish(_manifest(), b"precious bytes")
        assert store.load_blob("store-test", m.version) == b"precious bytes"
        path = store._blob_path("store-test", m.blob_sha256)
        open(path, "wb").write(b"precious bytez")
        with pytest.raises(ArtifactIntegrityError, match="checksum"):
            store.load_blob("store-test", m.version)
        open(path, "wb").write(b"short")
        with pytest.raises(ArtifactIntegrityError, match="length"):
            store.load_blob("store-test", m.version)
        with pytest.raises(ArtifactIntegrityError):
            store.load_blob("store-test", "v999999")

    def test_gc_keeps_last_n_and_pinned(self, tmp_path):
        store = ArtifactStore(str(tmp_path))
        for i in range(5):
            store.publish(_manifest(instance_id=f"i{i}"), f"blob{i}".encode())
        removed = store.gc("store-test", keep_last=2)
        left = [m.version for m in store.list_versions("store-test")]
        assert "v000001" in left and "v000005" in left and len(left) <= 3
        for version in removed:
            with pytest.raises(ArtifactIntegrityError):
                store.load_blob("store-test", version)

    def test_state_machine_stage_promote_rollback(self, tmp_path):
        store = ArtifactStore(str(tmp_path))
        store.publish(_manifest(), b"one")
        store.publish(_manifest(), b"two")
        with pytest.raises(ValueError):
            store.stage_candidate("store-test", "v000404")
        with pytest.raises(ValueError):
            store.stage_candidate("store-test", "v000001")
        with pytest.raises(ValueError):
            store.promote("store-test")
        state = store.stage_candidate("store-test", "v000002", mode="canary", fraction=0.25)
        assert (state.candidate, state.mode, state.fraction) == ("v000002", "canary", 0.25)
        state = store.promote("store-test")
        assert (state.stable, state.previous_stable, state.candidate, state.mode) == ("v000002", "v000001", "", "off")
        assert store.rollback("store-test", reason="regret").stable == "v000001"
        with pytest.raises(ValueError):
            store.rollback("store-test")

    def test_no_tmp_litter_and_default_dir_is_the_ports(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.registry import default_registry_dir

        store = ArtifactStore(str(tmp_path))
        store.publish(_manifest(), b"x" * 1000)
        assert [n for _, _, names in os.walk(tmp_path) for n in names if n.startswith(".tmp-")] == []
        monkeypatch.delenv("PIO_REGISTRY_DIR", raising=False)
        monkeypatch.delenv("PIO_FS_BASEDIR", raising=False)
        monkeypatch.setenv("PIO_TORCH_HOME", str(tmp_path / "home"))
        assert default_registry_dir() == str(tmp_path / "home" / "registry")
        monkeypatch.setenv("PIO_REGISTRY_DIR", str(tmp_path / "r"))
        assert default_registry_dir() == str(tmp_path / "r")

    def test_a_jax_lease_excludes_a_port_writer(self, tmp_path):
        """The lease files are the reference's: a lease the JAX package
        holds keeps the port's writer out until it is released."""
        from predictionio_tpu.registry.lease import LeaseMutex as JLease

        from predictionio_tpu_torch.registry.lease import LeaseMutex, LeaseTimeoutError

        path = str(tmp_path / "state.lease")
        held = JLease(path, ttl_s=30.0)
        held.acquire(timeout_s=1.0)
        try:
            with pytest.raises(LeaseTimeoutError):
                LeaseMutex(path, ttl_s=30.0).acquire(timeout_s=0.2)
        finally:
            held.release()
        port = LeaseMutex(path, ttl_s=30.0)
        port.acquire(timeout_s=1.0)
        port.release()


# ---------------------------------------------------------------------------
# sticky routing and the controller against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("salt", ["v000002", "v000017"])
def test_sticky_buckets_and_lanes_equal_the_reference(salt):
    from predictionio_tpu.registry import sticky_bucket as jbucket
    from predictionio_tpu.registry.router import RolloutPlan as JPlan
    from predictionio_tpu.registry.router import choose_lane as jchoose

    keys = [f"user{i}" for i in range(10_000)]
    ours = [sticky_bucket(k, salt) for k in keys]
    assert ours == [jbucket(k, salt) for k in keys]
    for mode, fraction in (("canary", 0.1), ("canary", 0.37), ("shadow", 0.5), ("off", 1.0)):
        plan, jplan = RolloutPlan(mode, fraction, salt), JPlan(mode, fraction, salt)
        assert [choose_lane(plan, k) for k in keys] == [jchoose(jplan, k) for k in keys]
    share = sum(b < 0.1 for b in ours) / len(ours)
    assert 0.09 < share < 0.11


def test_routing_key_equals_the_reference():
    from predictionio_tpu.registry.router import routing_key as jkey

    for payload in ({"user": "u7", "num": 3}, {"num": 3, "q": "x"}, {"user": 12}, [1, 2], "s"):
        assert routing_key(payload, "user") == jkey(payload, "user")


# (op, *args): "req"/"err" version lane n, "pred" version seconds n,
# "scored"/"div" version n, "adv" seconds, "begin" mode, "eval"
_SCENARIOS = {
    "waits_for_window_and_sample": (
        {}, [("begin", "canary"), ("req", "v2", LANE_CANDIDATE, 50), ("eval",), ("adv", 11), ("eval",)]),
    "sample_too_small": ({}, [("begin", "canary"), ("adv", 11), ("req", "v2", LANE_CANDIDATE, 3), ("eval",)]),
    "promotes_clean_candidate": ({}, [
        ("begin", "canary"), ("req", "v1", LANE_STABLE, 100), ("err", "v1", LANE_STABLE, 2),
        ("req", "v2", LANE_CANDIDATE, 30), ("adv", 11), ("eval",)]),
    "error_rate_gate": ({}, [
        ("begin", "canary"), ("req", "v1", LANE_STABLE, 100), ("req", "v2", LANE_CANDIDATE, 30),
        ("err", "v2", LANE_CANDIDATE, 10), ("adv", 11), ("eval",)]),
    "error_rate_deltas": ({}, [
        ("err", "v2", LANE_CANDIDATE, 50), ("req", "v2", LANE_CANDIDATE, 50), ("begin", "canary"),
        ("req", "v2", LANE_CANDIDATE, 30), ("req", "v1", LANE_STABLE, 30), ("adv", 11), ("eval",)]),
    "latency_gate": ({"max_p95_ratio": 1.5}, [
        ("begin", "canary"), ("req", "v2", LANE_CANDIDATE, 30), ("req", "v1", LANE_STABLE, 30),
        ("pred", "v1", 0.010, 50), ("pred", "v2", 0.200, 50), ("adv", 11), ("eval",)]),
    "latency_windowed": ({"max_p95_ratio": 1.5}, [
        ("pred", "v1", 0.010, 50), ("pred", "v2", 0.500, 50), ("begin", "canary"),
        ("req", "v2", LANE_CANDIDATE, 30), ("req", "v1", LANE_STABLE, 30),
        ("pred", "v1", 0.010, 50), ("pred", "v2", 0.010, 50), ("adv", 11), ("eval",)]),
    "shadow_divergence": ({"max_divergence_rate": 0.25}, [
        ("begin", "shadow"), ("scored", "v2", 40), ("div", "v2", 20), ("adv", 11), ("eval",)]),
    "shadow_clean": ({}, [("begin", "shadow"), ("scored", "v2", 40), ("div", "v2", 2), ("adv", 11), ("eval",)]),
    "ready_without_auto_promote": ({"auto_promote": False}, [
        ("begin", "canary"), ("req", "v2", LANE_CANDIDATE, 30), ("adv", 11), ("eval",)]),
    "idle": ({}, [("eval",)]),
}


def _run_scenario(pkg, criteria_kw, ops):
    if pkg == "jax":
        from predictionio_tpu.obs.metrics import MetricsRegistry as Reg
        from predictionio_tpu.registry import PromotionCriteria as Crit
        from predictionio_tpu.registry import RolloutController as Ctrl
        from predictionio_tpu.registry import RolloutInstruments as Inst
    else:
        Reg, Crit, Ctrl, Inst = MetricsRegistry, PromotionCriteria, RolloutController, RolloutInstruments
    inst = Inst(Reg())
    clock = FakeClock()
    ctrl = Ctrl(inst, Crit(**{"bake_window_s": 10.0, "min_requests": 10, **criteria_kw}), clock=clock)
    out = []
    for op, *a in ops:
        if op == "begin":
            ctrl.begin("v1", "v2", a[0])
        elif op == "req":
            inst.requests.inc(a[2], version=a[0], lane=a[1])
        elif op == "err":
            inst.errors.inc(a[2], version=a[0], lane=a[1])
        elif op == "pred":
            # one-row batches: the port's gate compares the lanes at equal
            # rows, which one-row samples already are
            for _ in range(a[2]):
                if pkg == "jax":
                    inst.predict_seconds.observe(a[1], version=a[0])
                else:
                    inst.observe_predict(a[1], 1, version=a[0])
        elif op == "scored":
            inst.shadow_scored.inc(a[1], version=a[0])
        elif op == "div":
            inst.divergence.inc(a[1], version=a[0])
        elif op == "adv":
            clock.advance(a[0])
        else:
            out.append(ctrl.evaluate())
    return out, ctrl.snapshot()


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_controller_verdicts_equal_the_reference(name):
    criteria_kw, ops = _SCENARIOS[name]
    ours, ours_snap = _run_scenario("port", criteria_kw, ops)
    theirs, their_snap = _run_scenario("jax", criteria_kw, ops)
    assert ours == theirs
    assert ours_snap == their_snap


# ---------------------------------------------------------------------------
# the query server's rollout half (device="cpu")
# ---------------------------------------------------------------------------


def _als_model(seed, n_users=60, n_items=25, rank=4):
    rng = np.random.default_rng(seed)
    return convert.als_model_from_numpy(
        rng.normal(size=(n_users, rank)), rng.normal(size=(n_items, rank)),
        [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)],
    )


def _post(url, payload=None, method="POST"):
    data = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(url, data=data if method == "POST" else None, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers.get("X-Pio-Model-Version")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), None


@pytest.fixture()
def rollout(tmp_path):
    """A registry with two ALS versions (v1 stable) and a started server on
    the CPU that serves v1 from it."""
    from predictionio_tpu_torch.models.recommendation import engine as pt_rec
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

    store = ArtifactStore(str(tmp_path / "registry"))
    for seed in (1, 2, 3):
        store.publish(_manifest(engine_id="rec"), model_io.serialize_models([_als_model(seed)]))
    ctx = WorkflowContext(device="cpu", _storage=port_storage(tmp_path))
    engine = pt_rec.engine_factory()
    ep = engine.engine_params_from_variant({"algorithms": [{"name": "als", "params": {}}]})
    models = engine.prepare_deploy(ctx, ep, model_io.deserialize_models(store.load_blob("rec", "v000001")))
    server = QueryServer(
        engine, ep, models, ctx,
        ServerConfig(ip="127.0.0.1", port=0, max_batch=16, bake_check_interval_s=30.0),
        "inst-1", manifest=EngineManifest("rec", "1", "engine.json", ""), registry_store=store,
        model_version="v000001",
    )
    port = server.start()
    yield server, f"http://127.0.0.1:{port}", store
    server.shutdown()


def _expected(server, version, user):
    """What ``serve_batch`` of that version's own model answers."""
    lane = server._active if server._active.version == version else server._candidate
    model = lane.models[0]
    scores, items = model.serving_index().serve_batch(np.asarray([model.user_index(user)]), 4)
    return [model.item_vocab[int(i)] for i in items[0]], scores[0]


class TestServerRollout:
    def test_canary_routes_by_sticky_bucket_and_answers_from_the_lane(self, rollout):
        server, url, store = rollout
        assert _post(f"{url}/models/candidate", {"version": "v000002", "fraction": 0.3})[0] == 200
        assert store.get_state("rec").candidate == "v000002"
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda u: _post(f"{url}/queries.json", {"user": f"u{u}", "num": 4}), range(60)))
        for u, (code, body, version) in enumerate(outs):
            assert code == 200
            want = "v000002" if sticky_bucket(f"u{u}", "v000002") < 0.3 else "v000001"
            assert version == want
            items, scores = _expected(server, version, f"u{u}")
            assert [s["item"] for s in body["itemScores"]] == items
            np.testing.assert_allclose([s["score"] for s in body["itemScores"]], scores, rtol=1e-5)
        counters = _post(f"{url}/models", method="GET")[1]
        n_cand = sum(sticky_bucket(f"u{u}", "v000002") < 0.3 for u in range(60))
        assert counters["candidate"]["counters"]["requests"] == n_cand
        assert counters["stable"]["counters"]["requests"] == 60 - n_cand

    def test_promote_then_rollback_then_reload(self, rollout, tmp_path):
        server, url, store = rollout
        assert _post(f"{url}/models/promote")[0] == 404  # nothing staged
        _post(f"{url}/models/candidate", {"version": "v000002", "fraction": 0.1})
        assert _post(f"{url}/models/promote", {"version": "v000003"})[0] == 409  # guard
        code, body, _ = _post(f"{url}/models/promote", {"version": "v000002"})
        assert code == 200 and body["version"] == "v000002"
        assert store.get_state("rec").stable == "v000002" and server.model_version == "v000002"
        assert {_post(f"{url}/queries.json", {"user": f"u{u}"})[2] for u in range(20)} == {"v000002"}
        _post(f"{url}/models/candidate", {"version": "v000003", "fraction": 1.0})
        assert _post(f"{url}/queries.json", {"user": "u1"})[2] == "v000003"
        code, body, _ = _post(f"{url}/models/rollback")
        assert code == 200 and body["version"] == "v000003"
        state = store.get_state("rec")
        assert state.stable == "v000002" and state.candidate == ""
        assert {_post(f"{url}/queries.json", {"user": f"u{u}"})[2] for u in range(10)} == {"v000002"}
        assert _post(f"{url}/models/rollback")[0] == 404
        # /reload: no COMPLETED instance in this metadata store -> 404, and
        # the GET spelling answers the same
        assert _post(f"{url}/reload")[0] == 404
        assert _post(f"{url}/reload", method="GET")[0] == 404
        assert server.model_version == "v000002"

    def test_shadow_answers_from_stable_and_records_divergence(self, rollout):
        server, url, _ = rollout
        _post(f"{url}/models/candidate", {"version": "v000002", "mode": "shadow"})
        for u in range(12):
            code, body, version = _post(f"{url}/queries.json", {"user": f"u{u}", "num": 4})
            assert code == 200 and version == "v000001"
            assert [s["item"] for s in body["itemScores"]] == _expected(server, "v000001", f"u{u}")[0]
        inst = server._rollout_instruments
        deadline = time.monotonic() + 10
        while inst.shadow_scored.value(version="v000002") < 12:
            assert time.monotonic() < deadline, "shadow scoring never ran"
            time.sleep(0.01)
        assert inst.divergence.value(version="v000002") > 0  # another model answers otherwise
        assert inst.predict_seconds.summary(version="v000002")["count"] >= 12

    def test_bake_gate_auto_promotes(self, rollout):
        server, url, store = rollout
        server.rollout_controller.criteria = PromotionCriteria(bake_window_s=0.0, min_requests=5)
        _post(f"{url}/models/candidate", {"version": "v000002", "fraction": 1.0})
        for u in range(8):
            assert _post(f"{url}/queries.json", {"user": f"u{u}"})[0] == 200
        server._rollout_tick()
        assert server.model_version == "v000002" and store.get_state("rec").stable == "v000002"
        assert server._rollout_instruments.promotions.value() == 1

    def test_registry_sync_adopts_other_processes_moves(self, rollout):
        server, url, store = rollout
        store.stage_candidate("rec", "v000003", mode="canary", fraction=0.5)
        server._registry_sync_tick()
        assert server._candidate.version == "v000003" and server._plan.fraction == 0.5
        store.promote("rec")
        server._registry_sync_tick()
        assert server.model_version == "v000003" and server._candidate is None
        store.stage_candidate("rec", "v000002", mode="shadow")
        server._registry_sync_tick()
        store.unstage("rec", reason="elsewhere")
        server._registry_sync_tick()
        assert server._candidate is None and server.model_version == "v000003"

    def test_retired_lanes_are_freed(self, rollout):
        """A promoted-away or rolled-back lane is referenced by nothing once
        its batches are done: its models (and their device tables) go."""
        server, url, store = rollout
        refs = []
        for cycle in range(3):
            _post(f"{url}/models/candidate", {"version": "v000002" if cycle % 2 == 0 else "v000003", "fraction": 0.5})
            refs.append(weakref.ref(server._candidate.models[0]))
            for u in range(6):
                _post(f"{url}/queries.json", {"user": f"u{u}"})
            if cycle < 2:
                _post(f"{url}/models/promote")
            else:
                _post(f"{url}/models/rollback")
        gc.collect()
        live = [r() is not None for r in refs]
        assert live == [False, True, False]  # only the stable's models live


class _TagModel:
    def __init__(self, tag):
        self.tag = tag


class _TagAlgo:
    def __init__(self, fail=False, delay_s=0.0):
        self.fail, self.delay_s = fail, delay_s

    def predict(self, model, q):
        if self.fail:
            raise RuntimeError(f"{model.tag} exploded")
        if self.delay_s:
            time.sleep(self.delay_s)
        return model.tag

    def predict_batch(self, model, qs):
        return [self.predict(model, q) for q in qs]

    def predict_batch_dispatch(self, model, qs):
        return lambda: self.predict_batch(model, qs)

    def warmup_serving(self, model, max_batch):
        pass


class _TagServing:
    def __init__(self, tag, shift=0):
        self.tag, self.shift = tag, shift

    def supplement(self, q):
        return q

    def serve(self, q, preds):
        return {"model": preds[0], "serving": self.tag, "qid": q["qid"] + self.shift}


def _tag_lane(tag, **kw):
    return Lane([_TagAlgo(**kw)], _TagServing(tag), [_TagModel(tag)], tag, f"inst-{tag}")


@pytest.fixture()
def tag_server(tmp_path):
    from predictionio_tpu_torch.controller.engine import Engine
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig
    from tests.torch_sample_engine import Algo0, DataSource0, Preparator0, Serving0

    def make(**cfg):
        engine = Engine({"": DataSource0}, {"": Preparator0}, {"": Algo0}, {"": Serving0})
        ep = engine.engine_params_from_variant({})
        ctx = WorkflowContext(device="cpu", _storage=port_storage(tmp_path))
        server = QueryServer(engine, ep, [None], ctx,
                             ServerConfig(ip="127.0.0.1", port=0, bake_check_interval_s=30.0, **cfg), "inst-v1")
        server._active = _tag_lane("v1")
        return server

    return make


class TestRolloutThreads:
    def test_shadow_failures_feed_the_candidate_breaker(self, tag_server):
        server = tag_server(candidate_breaker_threshold=3)
        port = server.start()
        try:
            server.stage_candidate_lane(_tag_lane("v2", fail=True), mode="shadow", persist=False)
            for i in range(6):
                code, body, version = _post(f"http://127.0.0.1:{port}/queries.json", {"qid": i, "user": f"u{i}"})
                assert code == 200 and body["model"] == "v1" and version == "v1"
            deadline = time.monotonic() + 5
            while server._candidate is not None:
                assert time.monotonic() < deadline, "shadow breaker trip never rolled back"
                time.sleep(0.01)
            assert server.model_version == "v1"
            assert server._rollout_instruments.rollbacks.value(reason="breaker-trip") == 1
        finally:
            server.shutdown()

    def test_canary_failures_answer_from_stable_and_trip_the_breaker(self, tag_server):
        server = tag_server(candidate_breaker_threshold=2)
        port = server.start()
        try:
            server.stage_candidate_lane(_tag_lane("v2", fail=True), fraction=1.0, persist=False)
            for i in range(4):
                code, body, version = _post(f"http://127.0.0.1:{port}/queries.json", {"qid": i, "user": f"u{i}"})
                assert code == 200 and body["model"] == "v1" and version == "v1"
            assert server._candidate is None
        finally:
            server.shutdown()

    def test_stale_generation_work_cannot_touch_the_next_rollout(self, tag_server):
        server = tag_server(candidate_breaker_threshold=1)
        server.stage_candidate_lane(_tag_lane("v2", fail=True), mode="shadow", persist=False)
        stale_gen = server._rollout_gen
        server._rollback_candidate("manual")
        inst = server._rollout_instruments
        server._record_candidate_failure("v2", stale_gen)
        assert server.candidate_breaker.snapshot()["state"] == CLOSED
        assert inst.errors.value(version="v2", lane=LANE_CANDIDATE) == 0
        with server._shadow_lock:
            server._shadow_pending += 1
        server._shadow_score(_tag_lane("v2", fail=True), [({"qid": 1}, {"qid": 1})], stale_gen)
        assert inst.shadow_scored.value(version="v2") == 0
        assert server.candidate_breaker.snapshot()["state"] == CLOSED
        assert server._shadow_pending == 0
        server.shutdown()

    def test_serving_rollback_never_reverts_registry_stable(self, tag_server, tmp_path):
        store = ArtifactStore(str(tmp_path / "registry"))
        store.publish(_manifest(engine_id="gentest"), b"one")
        store.publish(_manifest(engine_id="gentest"), b"two")
        store.promote("gentest", "v000002")
        server = tag_server()
        server.registry_store = store
        server.manifest.engine_id = "gentest"
        server.stage_candidate_lane(_tag_lane("v3"), persist=False)
        assert server._rollback_candidate("breaker-trip") == "v3"
        state = store.get_state("gentest")
        assert (state.stable, state.previous_stable) == ("v000002", "v000001")
        server.shutdown()

    def test_shadow_backlog_is_bounded(self, tag_server):
        server = tag_server(shadow_max_backlog=2)
        server.stage_candidate_lane(_tag_lane("v2"), mode="shadow", persist=False)
        with server._shadow_lock:
            server._shadow_pending = 2
        server._submit_shadow(server._candidate, [({"qid": 1}, {"qid": 1})] * 3, server._rollout_gen)
        assert server._rollout_instruments.shadow_dropped.value(version="v2") == 3
        with server._shadow_lock:
            server._shadow_pending = 0
        server.shutdown()

    def test_concurrent_promotes_never_mix_lanes(self, tag_server):
        """Queries in flight while the lanes swap each see one lane: the
        model, the serving and the version header all agree."""
        server = tag_server()
        lanes = {"v1": _tag_lane("v1", delay_s=0.002), "v2": _tag_lane("v2", delay_s=0.002)}
        server._active = lanes["v1"]
        port = server.start()
        stop = threading.Event()

        def churn():
            while not stop.is_set():
                nxt = "v2" if server.model_version == "v1" else "v1"
                server.stage_candidate_lane(lanes[nxt], fraction=0.0, persist=False)
                assert server._promote_candidate() == nxt
                time.sleep(0.001)

        churner = threading.Thread(target=churn)
        churner.start()
        try:
            with concurrent.futures.ThreadPoolExecutor(16) as pool:
                outs = list(pool.map(
                    lambda i: _post(f"http://127.0.0.1:{port}/queries.json", {"qid": i}), range(120)))
        finally:
            stop.set()
            churner.join()
            server.shutdown()
        for i, (code, body, version) in enumerate(outs):
            assert code == 200 and body["model"] == body["serving"] == version and body["qid"] == i
        assert {v for _, _, v in outs} <= {"v1", "v2"}


# ---------------------------------------------------------------------------
# CLI: train --registry-dir, models, deploy --registry-dir, eval --publish
# ---------------------------------------------------------------------------


def _rate_events(n_users=14, n_items=9):
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


@pytest.fixture(scope="module")
def trained_registry(tmp_path_factory):
    from predictionio_tpu_torch.tools import cli

    base = tmp_path_factory.mktemp("registry_cli")
    home, engine_dir, registry = base / "home", base / "engine", base / "registry"
    engine_dir.mkdir()
    variant = json.loads((REPO / "predictionio_tpu_torch/models/recommendation/engine.json").read_text())
    variant["id"] = "regrec"
    variant["datasource"]["params"]["appName"] = "regapp"
    variant["datasource"]["params"]["evalParams"] = {"kFold": 2}
    variant["algorithms"][0]["params"].update(rank=4, numIterations=3)
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    assert cli.main(["--home", str(home), "app", "new", "regapp"]) == 0
    assert cli.main(["--home", str(home), "import", "--appname", "regapp", "--input",
                     str(write_events(base / "ev.jsonl", _rate_events()))]) == 0
    for _ in range(2):
        assert cli.main(["--home", str(home), "train", "--engine-dir", str(engine_dir), "--device", "cpu",
                         "--registry-dir", str(registry)]) == 0
    return home, engine_dir, registry


def test_cli_models_list_show_promote_rollback_diff(trained_registry, capsys):
    from predictionio_tpu_torch.tools import cli

    home, engine_dir, registry = trained_registry
    base = ["--home", str(home), "models"]
    where = ["--engine-dir", str(engine_dir), "--registry-dir", str(registry)]
    assert cli.main([*base, "list", *where]) == 0
    rows = {line.split("|")[0].strip(): line.split("|")[1].strip()
            for line in capsys.readouterr().out.splitlines() if line.startswith("v0")}
    assert rows == {"v000001": "stable", "v000002": ""}
    assert cli.main([*base, "show", *where, "v000002"]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["manifest"]["parent_version"] == "v000001" and shown["rollout"]["stable"] == "v000001"
    assert shown["manifest"]["data_span"]["batch"] == ""
    assert cli.main([*base, "diff", *where, "v000001", "v000002"]) == 0
    assert "instance_id" in capsys.readouterr().out
    assert cli.main([*base, "promote", *where, "v000002"]) == 0
    assert "Promoted v000002" in capsys.readouterr().out
    assert cli.main([*base, "rollback", *where]) == 0
    assert "stable is v000001" in capsys.readouterr().out
    assert cli.main([*base, "show", *where, "v000404"]) == 1
    # the JAX package reads what the port's CLI wrote
    from predictionio_tpu.registry import ArtifactStore as JStore

    jstate = JStore(str(registry)).get_state("regrec")
    assert jstate.stable == "v000001" and [h["action"] for h in jstate.history][-2:] == ["promote", "rollback"]


def test_cli_deploy_from_the_registry_with_sync(trained_registry):
    import subprocess
    import sys

    from predictionio_tpu_torch.tools import cli
    from tests.torch_template_helpers import _free_port

    home, engine_dir, registry = trained_registry
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(home), "deploy",
         "--engine-dir", str(engine_dir), "--device", "cpu", "--ip", "127.0.0.1", "--port", str(port),
         "--registry-dir", str(registry), "--registry-sync-interval", "0.2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                status = _post(f"{url}/", method="GET")[1]
                break
            except OSError:
                assert time.monotonic() < deadline, "deploy never answered"
                time.sleep(0.2)
        stable = ArtifactStore(str(registry)).get_state("regrec").stable
        assert status["modelVersion"] == stable
        other = "v000002" if stable == "v000001" else "v000001"
        # staged through the CLI on the registry; the server adopts it
        ArtifactStore(str(registry)).stage_candidate("regrec", other, mode="canary", fraction=1.0)
        deadline = time.monotonic() + 30
        while _post(f"{url}/queries.json", {"user": "u1", "num": 3})[2] != other:
            assert time.monotonic() < deadline, "registry sync never adopted the candidate"
            time.sleep(0.1)
        assert cli.main(["models", "promote", "--url", url]) == 0
        assert ArtifactStore(str(registry)).get_state("regrec").stable == other
        assert _post(f"{url}/models", method="GET")[1]["stable"]["version"] == other
        assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port", str(port)]) == 0
        assert proc.wait(timeout=15) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


EVAL_MODULE = '''
from predictionio_tpu_torch.eval import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import engine_factory
from predictionio_tpu_torch.tuning.metrics import PrecisionAtK


def make_evaluation():
    engine = engine_factory()
    return Evaluation(
        engine=engine,
        metric=PrecisionAtK(k=3),
        engine_params_generator=[
            engine.engine_params_from_variant({
                "datasource": {"params": {"appName": "regapp", "evalParams": {"kFold": 2}}},
                "algorithms": [{"name": "als", "params": {"rank": r, "numIterations": 3}}],
            })
            for r in (2, 4)
        ],
    )
'''


def test_cli_eval_publish_lands_the_winner_as_a_candidate(trained_registry, tmp_path, capsys, monkeypatch):
    import sys

    from predictionio_tpu_torch.tools import cli

    home, engine_dir, registry = trained_registry
    (tmp_path / "reg_eval_mod.py").write_text(EVAL_MODULE)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))
    store = ArtifactStore(str(registry))
    before = [m.version for m in store.list_versions("regrec")]
    assert cli.main(["--home", str(home), "eval", "reg_eval_mod.make_evaluation", "--device", "cpu",
                     "--workdir", str(tmp_path / "grid"), "--engine-dir", str(engine_dir),
                     "--registry-dir", str(registry), "--publish", "--stage-fraction", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "Winner published to registry as candidate" in out
    (new,) = [m for m in store.list_versions("regrec") if m.version not in before]
    state = store.get_state("regrec")
    assert state.candidate == new.version and state.mode == "canary" and state.fraction == 0.5
    evidence = new.eval_evidence
    assert evidence["folds"] == 2 and len(evidence["cells"]) == 4 and len(evidence["scoresTable"]) == 2
    assert new.data_span["batch"] == "evalgrid"
