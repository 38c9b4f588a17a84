"""The port's recommendation template end to end, against the JAX package's,
on the CPU: event import and the columnar read, train from shared initial
factors, predict, model blobs carried across, the CLI in a subprocess, and
the rule that the port imports no JAX.

Tolerances: serving the same factors agrees to rtol 1e-5 (one matmul, other
sum order); trained factors differ at float rounding through every scatter
and solve, so predictions from two trains agree to rtol 1e-3.
"""

import json
import os
import pickle
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from crowding the other workers' tests
torch.set_num_threads(1)

from predictionio_tpu.data.storage.base import App  # noqa: E402
from predictionio_tpu.models.recommendation import engine as jax_rec  # noqa: E402
from predictionio_tpu.ops import als as jax_als  # noqa: E402
from predictionio_tpu.tools.import_export import import_events  # noqa: E402
from predictionio_tpu.workflow import model_io as jax_model_io  # noqa: E402
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.controller.params import params_from_dict  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.store import LocalStore  # noqa: E402
from predictionio_tpu_torch.models.recommendation import engine as pt_rec  # noqa: E402
from predictionio_tpu_torch.ops import als as pt_als  # noqa: E402
from predictionio_tpu_torch.workflow import model_io  # noqa: E402
from predictionio_tpu_torch.workflow.context import WorkflowContext  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_PKG = REPO / "predictionio_tpu_torch"
APP = "recapp"


def _write_events(path, n_users=40, n_items=30, n=600, seed=0):
    """rate and buy events (distinct event times, so both stacks see one
    row order), plus events the template must skip."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 3))
    V = rng.normal(size=(n_items, 3))
    lines = []
    for k in range(n):
        u, i = int(rng.integers(n_users)), int(rng.integers(n_items))
        t = f"2024-03-01T{k // 3600:02d}:{k // 60 % 60:02d}:{k % 60:02d}.000Z"
        ev = {"entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
              "targetEntityId": f"i{i}", "eventTime": t}
        if k % 10 == 9:
            ev.update(event="buy")
        else:
            r = float(np.clip(np.round((U[u] @ V[i] + 3) * 2) / 2, 1, 5))
            ev.update(event="rate", properties={"rating": r})
        lines.append(ev)
    lines.append({"event": "view", "entityType": "user", "entityId": "u1",
                  "targetEntityType": "item", "targetEntityId": "i1",
                  "eventTime": "2024-03-02T00:00:00.000Z"})
    lines.append({"event": "$set", "entityType": "user", "entityId": "u9",
                  "properties": {"age": 3}, "eventTime": "2024-03-02T00:00:01.000Z"})
    with open(path, "w") as fh:
        for ev in lines:
            fh.write(json.dumps(ev) + "\n")
    return path


def _jax_training_data(memory_storage, events):
    memory_storage.get_meta_data_apps().insert(App(0, APP))
    import_events(str(events), APP, storage=memory_storage)
    ds = jax_rec.DataSource(jax_rec.DataSourceParams(app_name=APP))
    return ds.read_training(JaxContext(_storage=memory_storage))


def _port_training_data(tmp_path, events):
    store = LocalStore(tmp_path / "home")
    store.create_app(APP)
    store.import_file(APP, str(events))
    ctx = WorkflowContext(device="cpu", store=store, app_name=APP)
    return ctx, pt_rec.DataSource(pt_rec.DataSourceParams(app_name=APP)).read_training(ctx)


def _shared_init(monkeypatch):
    def init(*, n_users, n_items, rank, seed, device):
        uf, vf = jax_als._als_init(n_users=n_users, n_items=n_items, rank=rank, seed=seed)
        return torch.tensor(np.asarray(uf), device=device), torch.tensor(np.asarray(vf), device=device)

    monkeypatch.setattr(pt_als, "_als_init", init)


def _assert_same_results(pt_results, jax_results, score_of, rtol):
    """Scores agree; an id may differ only where the port scores JAX's id
    the same (ties), which ``score_of(query_index, item)`` checks."""
    assert len(pt_results) == len(jax_results)
    for q, (p, j) in enumerate(zip(pt_results, jax_results)):
        ps = [s.score for s in p.item_scores]
        js = [s.score for s in j.item_scores]
        assert len(ps) == len(js)
        np.testing.assert_allclose(ps, js, rtol=rtol, atol=1e-6)
        for a, b in zip(p.item_scores, j.item_scores):
            if a.item != b.item:
                np.testing.assert_allclose(score_of(q, b.item), b.score, rtol=rtol, atol=1e-6)


def test_columnar_read_matches_jax(memory_storage, tmp_path):
    events = _write_events(tmp_path / "ev.jsonl")
    jtd = _jax_training_data(memory_storage, events)
    _, ptd = _port_training_data(tmp_path, events)
    assert ptd.user_vocab == jtd.user_vocab
    assert ptd.item_vocab == jtd.item_vocab
    np.testing.assert_array_equal(ptd.user_idx, jtd.user_idx)
    np.testing.assert_array_equal(ptd.item_idx, jtd.item_idx)
    np.testing.assert_array_equal(ptd.ratings, jtd.ratings)
    assert len(ptd.user_idx) == 600  # view and $set skipped, buy mapped to 4.0
    assert (ptd.ratings == 4.0).sum() >= 60


def test_whole_slice_matches_jax(memory_storage, tmp_path, monkeypatch):
    """import -> DataSource -> train (shared init) -> predict on 20 users."""
    _shared_init(monkeypatch)
    events = _write_events(tmp_path / "ev.jsonl", seed=1)
    jtd = _jax_training_data(memory_storage, events)
    ctx, ptd = _port_training_data(tmp_path, events)
    params = {"rank": 6, "numIterations": 8, "lambda": 0.05, "seed": 3}
    jalgo = jax_rec.ALSAlgorithm(params_from_dict(jax_rec.ALSAlgorithmParams, params))
    palgo = pt_rec.ALSAlgorithm(params_from_dict(pt_rec.ALSAlgorithmParams, params))
    jmodel = jalgo.train(JaxContext(_storage=memory_storage), jtd)
    pmodel = palgo.train(ctx, ptd)
    np.testing.assert_allclose(pmodel.item_factors, jmodel.item_factors, rtol=0, atol=1e-3)
    users = [f"u{u}" for u in range(20)]
    jq = [jax_rec.Query(user=u, num=5) for u in users]
    pq = [pt_rec.Query(user=u, num=5) for u in users]
    full = pmodel.user_factors @ pmodel.item_factors.T

    def score_of(q, item):
        return full[pmodel.user_index(users[q]), pmodel.item_index(item)]

    _assert_same_results(palgo.predict_batch(pmodel, pq), jalgo.predict_batch(jmodel, jq), score_of, 1e-3)


@pytest.mark.parametrize(
    "extra",
    [{"algorithm": {"distributed": False}}, {"algorithm": {"distributed": True}},
     {"datasource": {"evalParams": {"kFold": 2, "queryNum": 10}}}],
    ids=["distributed_false", "distributed_true", "eval_params"],
)
def test_jax_engine_json_keys_train_the_same(tmp_path, extra):
    """A JAX engine.json with ``distributed`` (one device: the same train)
    or ``evalParams`` (kept for the eval folds) parses in both packages and
    trains exactly as the same JSON without the key."""
    events = _write_events(tmp_path / "ev.jsonl", seed=4)
    ctx, ptd = _port_training_data(tmp_path, events)
    base = {"datasource": {"params": {"appName": APP}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3, "seed": 3}}]}
    variant = json.loads(json.dumps(base))
    variant["datasource"]["params"].update(extra.get("datasource", {}))
    variant["algorithms"][0]["params"].update(extra.get("algorithm", {}))
    jax_rec.engine_factory().engine_params_from_variant(variant)  # the JAX package takes it
    engine = pt_rec.engine_factory()
    with_key, without = (engine.engine_params_from_variant(v) for v in (variant, base))
    if "datasource" in extra:
        assert with_key.data_source[1].eval_params == pt_rec.EvalParams(k_fold=2, query_num=10)
    (m1,), (m2,) = (engine.train(ctx, ep) for ep in (with_key, without))
    np.testing.assert_array_equal(m1.user_factors, m2.user_factors)
    np.testing.assert_array_equal(m1.item_factors, m2.item_factors)


def test_custom_preparator_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    u = rng.integers(0, 10, 200).astype(np.int32)
    i = rng.integers(0, 12, 200).astype(np.int32)
    r = rng.random(200).astype(np.float32)
    users, items = [f"u{k}" for k in range(10)], [f"i{k}" for k in range(12)]
    excluded = tmp_path / "exclude.txt"
    excluded.write_text("i3\n\ni7\nnot-an-item\n")
    jtd = jax_rec.CustomPreparator(jax_rec.CustomPreparatorParams(filepath=str(excluded))).prepare(
        None, jax_rec.TrainingData(u, i, r, users, items))
    ptd = pt_rec.CustomPreparator(pt_rec.CustomPreparatorParams(filepath=str(excluded))).prepare(
        None, pt_rec.TrainingData(u, i, r, users, items))
    assert ptd.item_vocab == jtd.item_vocab and "i3" not in ptd.item_vocab
    for name in ("user_idx", "item_idx", "ratings"):
        got, want = getattr(ptd, name), getattr(jtd, name)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    td = pt_rec.TrainingData(u, i, r, users, items)
    assert pt_rec.CustomPreparator(pt_rec.CustomPreparatorParams(filepath=str(empty))).prepare(None, td) is td


def test_filter_serving_matches_jax_and_rereads_its_file(tmp_path):
    disabled = tmp_path / "disabled.txt"
    disabled.write_text("i2\n")
    scores = [("i1", 0.9), ("i2", 0.8), ("i3", 0.5)]
    jserve = jax_rec.FilterServing(jax_rec.ServingParams(filepath=str(disabled)))
    pserve = pt_rec.FilterServing(pt_rec.ServingParams(filepath=str(disabled)))

    def run(mod, serve):
        pred = mod.PredictedResult(tuple(mod.ItemScore(a, b) for a, b in scores))
        return serve.serve(mod.Query(user="u"), [pred]).to_json_dict()

    assert run(pt_rec, pserve) == run(jax_rec, jserve)
    assert [s["item"] for s in run(pt_rec, pserve)["itemScores"]] == ["i1", "i3"]
    disabled.write_text("i1\ni3\n")  # edited live: the next request sees it
    assert run(pt_rec, pserve) == run(jax_rec, jserve) == {"itemScores": [{"item": "i2", "score": 0.8}]}


def test_custom_and_filter_variants_resolve_by_name(tmp_path):
    excluded = tmp_path / "x.txt"
    excluded.write_text("i1\n")
    variant = {"datasource": {"params": {"appName": APP}},
               "preparator": {"name": "custom", "params": {"filepath": str(excluded)}},
               "algorithms": [{"name": "als", "params": {"rank": 3}}],
               "serving": {"name": "filter", "params": {"filepath": str(excluded)}}}
    engine = pt_rec.engine_factory()
    ep = engine.engine_params_from_variant(variant)
    _, prep, _, serving = engine.make_components(ep)
    assert isinstance(prep, pt_rec.CustomPreparator) and isinstance(serving, pt_rec.FilterServing)
    jax_ep = jax_rec.engine_factory().engine_params_from_variant(variant)
    assert jax_ep.preparator[0] == ep.preparator[0] == "custom"


@pytest.fixture
def jax_trained(memory_storage, tmp_path):
    events = _write_events(tmp_path / "ev.jsonl", seed=2)
    jtd = _jax_training_data(memory_storage, events)
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=5, num_iterations=6, lambda_=0.05))
    model = algo.train(JaxContext(_storage=memory_storage), jtd)
    return algo, model, jax_model_io.serialize_models([model])


def _queries(mod, model):
    return [
        mod.Query(user="u3", num=4),
        mod.Query(user="u7", num=30),
        mod.Query(user="nobody", num=3),
        mod.Query(user="u11", num=6, black_list=frozenset(model.item_vocab[:5])),
    ]


def test_jax_blob_loaded_and_served_by_port(jax_trained):
    jalgo, jmodel, blob = jax_trained
    (pmodel,) = model_io.deserialize_models(blob)
    assert type(pmodel) is pt_rec.ALSModel
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=5))
    pmodel = palgo.prepare_model(WorkflowContext(device="cpu"), pmodel)
    full = jmodel.user_factors @ jmodel.item_factors.T
    jq, pq = _queries(jax_rec, jmodel), _queries(pt_rec, jmodel)

    def score_of(q, item):
        return full[jmodel.user_index(jq[q].user), jmodel.item_index(item)]

    _assert_same_results(palgo.predict_batch(pmodel, pq), jalgo.predict_batch(jmodel, jq), score_of, 1e-5)
    _assert_same_results(
        [palgo.predict(pmodel, q) for q in pq], [jalgo.predict(jmodel, q) for q in jq], score_of, 1e-5
    )
    assert pq[3].black_list.isdisjoint(s.item for s in palgo.predict(pmodel, pq[3]).item_scores)


def test_als_model_from_numpy_serves_like_the_blob(jax_trained):
    jalgo, jmodel, _ = jax_trained
    pmodel = convert.als_model_from_numpy(
        jmodel.user_factors, jmodel.item_factors, jmodel.user_vocab, jmodel.item_vocab
    )
    pmodel.device = "cpu"
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams())
    got = palgo.predict(pmodel, pt_rec.Query(user="u5", num=8)).to_json_dict()
    want = jalgo.predict(jmodel, jax_rec.Query(user="u5", num=8)).to_json_dict()
    np.testing.assert_allclose(
        [s["score"] for s in got["itemScores"]], [s["score"] for s in want["itemScores"]], rtol=1e-5
    )
    with pytest.raises(ValueError):
        convert.als_model_from_numpy(jmodel.user_factors, jmodel.item_factors[:, :2], [], [])


def test_jax_blob_loads_in_a_process_without_jax(jax_trained, tmp_path):
    _, jmodel, blob = jax_trained
    (tmp_path / "model.bin").write_bytes(blob)
    code = f"""
import sys
from predictionio_tpu_torch.workflow import model_io
(m,) = model_io.deserialize_models(open({str(tmp_path / "model.bin")!r}, "rb").read())
m.device = "cpu"
s, i = m.serving_index().serve(m.user_index("u3"), 4)
assert "jax" not in sys.modules
assert not [k for k in sys.modules if k == "predictionio_tpu" or k.startswith("predictionio_tpu.")]
print(type(m).__module__, list(map(int, i)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    module, ids = out.stdout.split(" ", 1)
    assert module == "predictionio_tpu_torch.models.recommendation.engine"
    full = jmodel.user_factors[jmodel.user_index("u3")] @ jmodel.item_factors.T
    assert sorted(json.loads(ids)) == sorted(np.argsort(-full)[:4].tolist())


def test_unpickler_refuses_jax_classes_without_counterpart():
    from predictionio_tpu.controller.params import EmptyParams

    blob = model_io.MAGIC + b"x"  # any framing error is a ModelIntegrityError
    with pytest.raises(model_io.ModelIntegrityError):
        model_io.deserialize_models(blob)
    payload = pickle.dumps([EmptyParams()])
    import io

    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        convert.ModelUnpickler(io.BytesIO(payload)).load()


def test_port_blob_roundtrip_and_integrity():
    m = convert.als_model_from_numpy(np.ones((2, 3)), np.zeros((4, 3)), ["a", "b"], list("wxyz"))
    blob = model_io.serialize_models([m])
    assert blob == jax_model_io.serialize_models([m])[:8] + blob[8:]  # same magic
    (back,) = model_io.deserialize_models(blob)
    np.testing.assert_array_equal(back.user_factors, m.user_factors)
    assert back.item_vocab == list("wxyz") and back.device == "cuda"
    with pytest.raises(model_io.ModelIntegrityError, match="corrupt"):
        model_io.deserialize_models(blob[:-41] + bytes([blob[-41] ^ 1]) + blob[-40:])
    with pytest.raises(model_io.ModelIntegrityError, match="truncated"):
        model_io.deserialize_models(blob[:20])


@pytest.mark.parametrize(
    "wire",
    [
        {"event": "rate", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
         "targetEntityId": "i1", "properties": {"rating": 4.5}, "eventTime": "2024-01-01T00:00:00.123Z"},
        {"event": "$set", "entityType": "user", "entityId": "u1", "properties": {"a": [1, 2]},
         "eventTime": "2024-01-01T05:00:00+02:00", "eventId": "abc", "prId": "p"},
        {"event": "rate", "entityType": "user", "entityId": "u1", "targetEntityType": "item"},
        {"event": "$unset", "entityType": "user", "entityId": "u1"},
        {"event": "pio_x", "entityType": "user", "entityId": "u1"},
        {"event": "rate", "entityType": "pio_user", "entityId": "u1"},
        {"event": "rate", "entityType": "user", "entityId": "u1", "properties": {"pio_a": 1}},
        {"event": "rate", "entityType": "user", "entityId": 7},
        {"event": "rate", "entityType": "user", "entityId": "u1", "eventTime": "2024-01-01T00:00:00"},
        {"event": "$delete", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
         "targetEntityId": "i"},
    ],
)
def test_event_codec_accepts_and_rejects_like_jax(wire):
    from predictionio_tpu.data.event import Event as JaxEvent

    try:
        want = JaxEvent.from_json_dict(wire).to_json_dict()
    except (ValueError, KeyError):
        with pytest.raises(ValueError):
            Event.from_json_dict(wire)
        return
    assert Event.from_json_dict(wire).to_json_dict() == want


def test_import_reports_the_bad_line(tmp_path):
    store = LocalStore(tmp_path)
    store.create_app("a")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"event": "rate", "entityType": "user", "entityId": "u"}\n{"event": 3}\n')
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        store.import_file("a", str(bad))
    assert list(store.scan("a")) == []  # nothing written from a bad file
    with pytest.raises(Exception, match="already exists"):
        store.create_app("a")


def test_engine_json_params_map_camel_case():
    manifest = json.loads((PORT_PKG / "models/recommendation/engine.json").read_text())
    engine = pt_rec.engine_factory()
    ep = engine.engine_params_from_variant(manifest)
    name, p = ep.algorithms[0]
    assert name == "als" and p.num_iterations == 10 and p.lambda_ == 0.01 and p.rank == 10
    assert ep.data_source[1].app_name == "MyApp1"
    with pytest.raises(ValueError, match="unknown fields"):
        params_from_dict(pt_rec.ALSAlgorithmParams, {"numIteration": 3})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_cli_import_train_deploy_on_cpu(tmp_path):
    events = _write_events(tmp_path / "ev.jsonl", seed=3)
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "cli-test",
        "engineFactory": "predictionio_tpu_torch.models.recommendation.engine.engine_factory",
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 4, "lambda": 0.05}}],
    }))
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(tmp_path / "h")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}

    def run(*args):
        out = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        return out.stdout

    run("app", "new", APP)
    assert "Imported 602 events" in run("import", "--appname", APP, "--input", str(events))
    assert "Training completed" in run("train", "--engine-dir", str(engine_dir), "--device", "cpu")
    port = _free_port()
    err_path = tmp_path / "deploy.err"
    with open(err_path, "w") as err:  # the child keeps its own copy
        server = subprocess.Popen(
            [*cli, "deploy", "--engine-dir", str(engine_dir), "--device", "cpu",
             "--ip", "127.0.0.1", "--port", str(port)],
            env=env, stdout=subprocess.DEVNULL, stderr=err,
        )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert server.poll() is None, err_path.read_text()
            try:
                with urllib.request.urlopen(base + "/", timeout=2) as r:
                    status = json.loads(r.read())
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "deploy never answered"
                time.sleep(0.2)
        assert status["status"] == "alive" and status["device"] == "cpu"
        code, body = _post(base + "/queries.json", {"user": "u2", "num": 3})
        assert code == 200 and len(body["itemScores"]) == 3
        code, body = _post(base + "/queries.json", {"user": "nobody"})
        assert code == 200 and body == {"itemScores": []}
        banned = [s["item"] for s in _post(base + "/queries.json", {"user": "u2", "num": 3})[1]["itemScores"]]
        code, body = _post(base + "/queries.json", {"user": "u2", "num": 3, "blackList": banned})
        assert code == 200 and not set(banned) & {s["item"] for s in body["itemScores"]}
        assert _post(base + "/queries.json", {"num": 3})[0] == 400
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    assert server.returncode == 0


def test_query_server_batches_concurrent_queries(tmp_path):
    import concurrent.futures

    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig

    rng = np.random.default_rng(0)
    model = convert.als_model_from_numpy(
        rng.normal(size=(50, 4)), rng.normal(size=(20, 4)),
        [f"u{i}" for i in range(50)], [f"i{i}" for i in range(20)],
    )
    ctx = WorkflowContext(device="cpu", store=LocalStore(tmp_path))
    engine = pt_rec.engine_factory()
    ep = engine.engine_params_from_variant({"algorithms": [{"name": "als", "params": {}}]})
    models = engine.prepare_deploy(ctx, ep, [model])
    server = QueryServer(engine, ep, models, ctx, ServerConfig(ip="127.0.0.1", port=0, max_batch=16))
    port = server.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            outs = list(pool.map(
                lambda u: _post(f"http://127.0.0.1:{port}/queries.json", {"user": f"u{u}", "num": 4}),
                range(50),
            ))
        algo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams())
        for u, (code, body) in enumerate(outs):
            assert code == 200
            want = algo.predict(models[0], pt_rec.Query(user=f"u{u}", num=4)).to_json_dict()
            # batched matmul vs one matvec: scores agree to rounding
            assert [s["item"] for s in body["itemScores"]] == [s["item"] for s in want["itemScores"]]
            np.testing.assert_allclose(
                [s["score"] for s in body["itemScores"]],
                [s["score"] for s in want["itemScores"]],
                rtol=1e-5,
            )
        assert server.batcher.queries_dispatched == 50
    finally:
        server.shutdown()


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|flax|optax|predictionio_tpu)\b(?!_torch)"
    r"|import_module\(\s*['\"](?:jax|flax|optax|predictionio_tpu)\b(?!_torch)",
    re.M,
)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'optax', 'predictionio_tpu')]\n"
        "print(len(bad), bad[:5])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
    assert len(modules) >= 29
    assert {"predictionio_tpu_torch.models.twotower.model",
            "predictionio_tpu_torch.models.twotower.engine"} <= set(modules)
    for path in [*PORT_PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        hits = _IMPORT.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


@pytest.mark.parametrize(
    "call",
    [
        lambda: pt_als.als_train(np.zeros(1, np.int32), np.zeros(1, np.int32),
                                 np.ones(1, np.float32), 1, 1, pt_als.ALSConfig(rank=2)),
        lambda: pt_als.ServingIndex(np.ones((2, 2)), np.ones((3, 2))),
        lambda: WorkflowContext(),
    ],
    ids=["als_train", "ServingIndex", "WorkflowContext"],
)
def test_entry_points_default_to_cuda_and_raise_without_it(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_cli_defaults_to_cuda_and_fails_without_it(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from predictionio_tpu_torch.tools import cli

    rc = cli.main(["--home", str(tmp_path), "train", "--engine-dir",
                   str(PORT_PKG / "models/recommendation")])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err
