"""The port's offline batch prediction (``predictionio_tpu_torch/workflow/
batch_predict.py``) on the CPU: streaming sources, the double-buffered
pipeline and its tiling contract, the atomic and event-store sinks, the
line-aligned error semantics, the offline answers against the online
server, and parity with the JAX package's ``run_batch_predict_on``.
The behaviour cases are those of ``tests/test_batch_predict.py``."""

import json
import os

import numpy as np
import pytest

from predictionio_tpu_torch.controller.base import BaseAlgorithm
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    Serving,
    engine_factory,
)
from predictionio_tpu_torch.workflow.batch_predict import (
    BatchPredictInstruments,
    EventStoreSink,
    FileSink,
    MemorySink,
    OutRow,
    StatusFile,
    iter_event_users,
    iter_query_file,
    run_batch_predict,
    run_batch_predict_on,
    run_pipeline,
)
from tests.torch_template_helpers import port_storage

APP_NAME = "MyApp1"  # the port's recommendation engine.json appName
ENGINE_DIR = "predictionio_tpu_torch/models/recommendation"


@pytest.fixture
def storage(tmp_path):
    return port_storage(tmp_path, "memory")


def make_model(n_users=30, n_items=12, rank=6, seed=0):
    rng = np.random.default_rng(seed)
    model = ALSModel(
        rng.normal(size=(n_users, rank)).astype(np.float32),
        rng.normal(size=(n_items, rank)).astype(np.float32),
        [f"u{i}" for i in range(n_users)],
        [f"i{i}" for i in range(n_items)],
    )
    model.device = "cpu"
    return model


def make_components(rank=6):
    return (None, None, [ALSAlgorithm(ALSAlgorithmParams(rank=rank))], Serving())


def query_source(n, num=5):
    for i in range(n):
        yield i + 1, {"user": f"u{i % 30}", "num": num}


def seed_app(storage, n_users=12, n_items=8):
    app_id = storage.get_meta_data_apps().insert(App(0, APP_NAME))
    rng = np.random.default_rng(0)
    events = [
        Event(
            event="rate",
            entity_type="user",
            entity_id=f"u{u}",
            target_entity_type="item",
            target_entity_id=f"i{i}",
            properties={"rating": 5.0 if (u + i) % 3 == 0 else 1.0},
        )
        for u in range(n_users)
        for i in range(n_items)
        if rng.random() >= 0.25
    ]
    storage.get_l_events().insert_batch(events, app_id)
    return app_id


def train_template(storage):
    """Train the recommendation template on the CPU as ``train`` would."""
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    manifest, engine = load_engine(ENGINE_DIR)
    ep = engine.engine_params_from_variant(manifest.variant_json)
    ctx = WorkflowContext(device="cpu", _storage=storage)
    return engine, ep, run_train(engine, manifest, ep, ctx)


class TestSources:
    def test_file_source_streams_lazily_and_skips_blanks(self, tmp_path):
        p = tmp_path / "q.json"
        p.write_text('{"user": "u1"}\n\n{"user": "u2"}\n   \n{"user": "u3"}\n')
        src = iter_query_file(str(p))
        assert hasattr(src, "__next__")
        assert [ln for ln, _ in src] == [1, 3, 5]  # file line numbers

    def test_event_source_dedupes_and_pages_bounded(self, storage):
        app_id = seed_app(storage, n_users=7)
        levents = storage.get_l_events()
        limits: list[int] = []
        real = levents.find_after

        def spy(app_id, channel_id=None, cursor=None, limit=100):
            limits.append(limit)
            return real(app_id, channel_id=channel_id, cursor=cursor, limit=limit)

        levents.find_after = spy
        out = list(iter_event_users(levents, app_id, num=4, page=10))
        assert len(out) == 7
        assert {q["user"] for _, q in out} == {f"u{i}" for i in range(7)}
        assert all(q["num"] == 4 for _, q in out)
        assert limits and all(lim == 10 for lim in limits)

    def test_event_source_bounded_at_run_start_head(self, storage):
        app_id = seed_app(storage, n_users=3)
        levents = storage.get_l_events()
        src = iter_event_users(levents, app_id, num=2)
        first = next(src)
        levents.insert(
            Event(event="rate", entity_type="user", entity_id="u99",
                  target_entity_type="item", target_entity_id="i0"),
            app_id,
        )
        assert {q["user"] for _, q in [first, *src]} == {"u0", "u1", "u2"}

    def test_event_source_limit_caps_distinct_users(self, storage):
        app_id = seed_app(storage, n_users=7)
        assert len(list(iter_event_users(storage.get_l_events(), app_id, num=3, limit=4))) == 4


def _rows(n, start=1):
    return [OutRow(start + i, {"user": f"u{i}"}, {"itemScores": []}, ok=True) for i in range(n)]


def _tmp_files(path):
    return [p for p in os.listdir(path) if p.startswith(".tmp-")]


class TestFileSink:
    def test_atomic_publish_on_success(self, tmp_path):
        target = tmp_path / "out.json"
        sink = FileSink(str(target))
        sink.write_batch(_rows(3))
        assert not target.exists()
        sink.close(True)
        assert len(target.read_text().splitlines()) == 3

    def test_killed_run_leaves_nothing(self, tmp_path):
        target = tmp_path / "out.json"
        sink = FileSink(str(target))
        sink.write_batch(_rows(2))
        sink.close(False)
        assert not target.exists() and not _tmp_files(tmp_path)

    def test_failed_flush_never_publishes(self, tmp_path):
        target = tmp_path / "out.json"
        target.write_text("old\n")
        sink = FileSink(str(target))
        sink.write_batch(_rows(2))
        sink._fh.flush = lambda: (_ for _ in ()).throw(OSError("disk full"))
        with pytest.raises(OSError, match="disk full"):
            sink.close(True)
        assert target.read_text() == "old\n" and not _tmp_files(tmp_path)

    def test_overwrite_is_atomic(self, tmp_path):
        target = tmp_path / "out.json"
        target.write_text("old\n")
        sink = FileSink(str(target))
        sink.write_batch(_rows(1))
        assert target.read_text() == "old\n"
        sink.close(True)
        assert "old" not in target.read_text()


class TestEventStoreSink:
    def test_writes_ok_rows_only_with_lineage(self, storage):
        app_id = storage.get_meta_data_apps().insert(App(0, "sinkapp"))
        levents = storage.get_l_events()
        sink = EventStoreSink(levents, app_id, model_version="inst42", event_name="bp.result")
        sink.write_batch(_rows(2) + [OutRow(3, None, {"error": "nope", "line": 3}, ok=False)])
        written = list(levents.find(app_id=app_id, event_names=["bp.result"]))
        assert len(written) == 2
        props = dict(written[0].properties)
        assert props["modelVersion"] == "inst42" and "prediction" in props and "line" in props

    def test_transient_failure_retried_behind_policy(self, storage):
        app_id = storage.get_meta_data_apps().insert(App(0, "sinkapp2"))
        levents = storage.get_l_events()
        calls = {"n": 0}
        real = levents.insert_batch

        def flaky(events, app_id, channel_id=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ConnectionError("transient blip")
            return real(events, app_id, channel_id)

        levents.insert_batch = flaky
        retried = {"n": 0}
        sink = EventStoreSink(
            levents, app_id, on_retry=lambda: retried.__setitem__("n", retried["n"] + 1)
        )
        sink._retry.sleep = lambda s: None
        sink.write_batch(_rows(2))
        assert calls["n"] == 2 and retried["n"] == 1
        assert len(list(levents.find(app_id=app_id))) == 2


class TestPipeline:
    def test_results_line_aligned_in_source_order(self):
        sink = MemorySink()
        report = run_pipeline(
            engine_factory(), make_components(), [make_model()], query_source(23), [sink],
            batch_size=8, warmup=False,
        )
        assert report.queries == 23 and report.ok == 23 and report.errors == 0
        assert report.batches == 3
        assert [r.lineno for r in sink.rows] == list(range(1, 24))
        assert all(len(r.result["itemScores"]) == 5 for r in sink.rows)

    def test_malformed_line_becomes_error_row_not_abort(self):
        sink = MemorySink()
        instruments = BatchPredictInstruments()
        source = [
            (1, '{"user": "u1", "num": 3}'),
            (2, "NOT JSON {{{"),
            (3, '{"wrong_field": 1}'),  # decodes to Query -> KeyError
            (4, '{"user": "u2", "num": 2}'),
        ]
        report = run_pipeline(
            engine_factory(), make_components(), [make_model()], source, [sink],
            batch_size=2, instruments=instruments, warmup=False,
        )
        assert report.queries == 4 and report.ok == 2 and report.errors == 2
        assert not report.all_failed
        errs = [r for r in sink.rows if not r.ok]
        assert [r.result["line"] for r in errs] == [2, 3]
        snap = instruments.registry.snapshot()
        assert snap["pio_batchpredict_errors_total"]["samples"][0]["value"] == 2
        assert snap["pio_batchpredict_queries_total"]["samples"][0]["value"] == 4

    def test_all_failed_flag(self):
        report = run_pipeline(
            engine_factory(), make_components(), [make_model()], [(1, "junk"), (2, "junk2")],
            [MemorySink()], batch_size=4, warmup=False,
        )
        assert report.all_failed

    def test_batch_failure_errors_batch_but_run_survives(self):
        class BoomAlgo(BaseAlgorithm):
            def predict_batch_dispatch(self, model, queries):
                def finalize():
                    raise RuntimeError("device fell over")

                return finalize

        sink = MemorySink()
        report = run_pipeline(
            engine_factory(), (None, None, [BoomAlgo()], Serving()), [object()],
            query_source(5), [sink], batch_size=2, warmup=False,
        )
        assert report.queries == 5 and report.errors == 5
        assert [r.lineno for r in sink.rows] == [1, 2, 3, 4, 5]
        assert all("device fell over" in r.result["error"] for r in sink.rows)

    def test_sync_fallback_uses_indexed_batch_predict(self):
        calls = {"batch": 0, "single": 0}

        class IndexedOnlyAlgo(BaseAlgorithm):
            def predict(self, model, query):
                calls["single"] += 1
                return {"echo": query["user"]}

            def batch_predict(self, model, queries):
                calls["batch"] += 1
                return [(i, {"echo": q["user"]}) for i, q in queries]

        engine = engine_factory()
        engine.query_class = None  # raw dict queries
        sink = MemorySink()
        report = run_pipeline(
            engine, (None, None, [IndexedOnlyAlgo()], Serving()), [object()],
            ((i + 1, {"user": f"u{i}"}) for i in range(12)), [sink], batch_size=4, warmup=False,
        )
        assert report.ok == 12
        assert calls["batch"] == 3 and calls["single"] == 0
        assert sink.rows[0].result == {"echo": "u0"}

    def test_distinct_users_drive_users_per_s(self):
        report = run_pipeline(
            engine_factory(), make_components(), [make_model()],
            ((i + 1, {"user": f"u{i % 5}", "num": 3}) for i in range(20)), [MemorySink()],
            batch_size=8, warmup=False,
        )
        assert report.queries == 20 and report.distinct_users == 5
        assert report.users_per_s == pytest.approx(report.qps / 4.0, rel=0.01)

    def test_phase_timeline_tiles_wall_clock(self):
        """read, assemble, dispatch, fetch and write cover the run's wall
        clock within 10 %."""
        report = run_pipeline(
            engine_factory(), make_components(), [make_model()], query_source(600),
            [MemorySink()], batch_size=64, warmup=True,
        )
        assert set(report.phase_p50_ms) == {"read", "assemble", "dispatch", "fetch", "write"}
        assert 0.9 <= report.tiling_ratio <= 1.001, report.tiling_ratio
        assert "phases" in report.profile and report.qps > 0

    def test_status_file_progress_and_final_state(self, tmp_path):
        status_path = tmp_path / "bp.status.json"
        run_pipeline(
            engine_factory(), make_components(), [make_model()], query_source(20),
            [MemorySink()], batch_size=8, status=StatusFile(str(status_path), interval_s=0.0),
            warmup=False,
        )
        final = json.loads(status_path.read_text())
        assert final["state"] == "done"
        assert final["queries"] == 20 and final["ok"] == 20
        assert final["phaseP50Ms"]["dispatch"] >= 0


class TestRunBatchPredict:
    def test_from_events_matches_online_answers(self, storage, tmp_path):
        """``--from-events --to-events`` rows equal what the deployed query
        server answers for the same users."""
        from tests.torch_template_helpers import post
        from predictionio_tpu_torch.workflow.context import WorkflowContext
        from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server

        seed_app(storage)
        _, _, instance_id = train_template(storage)
        out = tmp_path / "preds.jsonl"
        report = run_batch_predict(
            ENGINE_DIR, None, str(out), storage=storage, device="cpu",
            from_events=True, to_events=True, query_num=4, batch_size=8,
        )
        assert report.queries == 12 and report.errors == 0
        assert len(out.read_text().splitlines()) == 12
        app_id = storage.get_meta_data_apps().get_by_name(APP_NAME).id
        events = list(storage.get_l_events().find(app_id=app_id, event_names=["batchpredict.result"]))
        assert len(events) == 12
        by_user = {e.entity_id: dict(e.properties)["prediction"] for e in events}
        assert all(dict(e.properties)["modelVersion"] == instance_id for e in events)

        ctx = WorkflowContext(mode="serving", device="cpu", _storage=storage)
        server = create_query_server(ENGINE_DIR, ctx, ServerConfig(ip="127.0.0.1", port=0))
        port = server.start()
        try:
            for u in ["u0", "u3", "u7", "u11"]:
                status, online = post(f"http://127.0.0.1:{port}/queries.json", {"user": u, "num": 4})
                assert status == 200
                off = by_user[u]["itemScores"]
                assert [s["item"] for s in off] == [s["item"] for s in online["itemScores"]]
                # the same kernels on the same factors: scores within 1e-5
                np.testing.assert_allclose(
                    [s["score"] for s in off], [s["score"] for s in online["itemScores"]], rtol=1e-5
                )
        finally:
            server.shutdown()

    def test_file_input_compat_and_error_exit_semantics(self, storage, tmp_path):
        seed_app(storage)
        train_template(storage)
        qf = tmp_path / "q.json"
        qf.write_text('{"user": "u1", "num": 3}\nBROKEN\n')
        out = tmp_path / "out.json"
        report = run_batch_predict(ENGINE_DIR, str(qf), str(out), storage=storage, device="cpu",
                                   batch_size=4)
        rows = [json.loads(line) for line in out.read_text().splitlines()]
        assert len(rows) == 2 and len(rows[0]["itemScores"]) == 3
        assert rows[1]["line"] == 2 and "error" in rows[1]
        assert not report.all_failed
        qf.write_text("BROKEN1\nBROKEN2\n")
        report = run_batch_predict(ENGINE_DIR, str(qf), str(out), storage=storage, device="cpu")
        assert report.all_failed  # the CLI turns this into a nonzero exit

    def test_setup_errors_raise(self, storage, tmp_path):
        seed_app(storage)
        train_template(storage)
        with pytest.raises(RuntimeError, match="--input.*--from-events"):
            run_batch_predict(ENGINE_DIR, None, str(tmp_path / "o.json"), storage=storage,
                              device="cpu")
        with pytest.raises(RuntimeError, match="app not found"):
            run_batch_predict(ENGINE_DIR, None, str(tmp_path / "o.json"), storage=storage,
                              device="cpu", from_events=True, app_name="ghost-app")
        with pytest.raises(RuntimeError, match="query file not found"):
            run_batch_predict(ENGINE_DIR, str(tmp_path / "none.json"), str(tmp_path / "o.json"),
                              storage=storage, device="cpu")

    def test_entry_point_defaults_to_the_card(self, storage, tmp_path):
        """Without a card the default device raises; the CPU runs only
        when asked for."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        seed_app(storage)
        train_template(storage)
        qf = tmp_path / "q.json"
        qf.write_text('{"user": "u1", "num": 3}\n')
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_batch_predict(ENGINE_DIR, str(qf), str(tmp_path / "o.json"), storage=storage)

    def test_pure_core_compat(self, storage):
        from predictionio_tpu_torch.workflow.context import WorkflowContext
        from predictionio_tpu_torch.workflow.core_workflow import load_models_for_instance

        seed_app(storage)
        engine, ep, instance_id = train_template(storage)
        ctx = WorkflowContext(mode="serving", device="cpu", _storage=storage)
        models = load_models_for_instance(engine, ep, instance_id, ctx)
        lines = run_batch_predict_on(
            engine, ep, models, ['{"user": "u1", "num": 3}', "", '{"user": "u2", "num": 2}']
        )
        assert len(lines) == 2
        assert len(json.loads(lines[0])["itemScores"]) == 3
        assert len(json.loads(lines[1])["itemScores"]) == 2


def _assert_same_topk(got: list[dict], want: list[dict], rtol: float, score_of) -> None:
    """Scores within ``rtol``; ids equal as sets within each run of tied
    scores (``lax.top_k`` and ``torch.topk`` order ties differently). A run
    cut by the list's end may hold other members of the tie: each id there
    must score the run's value (``score_of(item)``)."""
    assert len(got) == len(want)
    np.testing.assert_allclose([g["score"] for g in got], [w["score"] for w in want], rtol=rtol)
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and abs(want[j]["score"] - want[i]["score"]) <= rtol * abs(want[i]["score"]):
            j += 1
        if j < len(want):
            assert {g["item"] for g in got[i:j]} == {w["item"] for w in want[i:j]}
        else:
            for g in got[i:j]:
                np.testing.assert_allclose(score_of(g["item"]), want[i]["score"], rtol=rtol)
        i = j


def test_run_batch_predict_on_parity_with_jax_package():
    """One set of factors in both packages: ``run_batch_predict_on`` gives
    the same lines, scores within 1e-5 relative, ids as sets within ties.
    The factors are quantised to quarters so that ties occur."""
    from predictionio_tpu.models.recommendation import engine as jax_rec
    from predictionio_tpu.workflow.batch_predict import run_batch_predict_on as jax_run_on
    from predictionio_tpu_torch.controller import EngineParams

    rng = np.random.default_rng(7)
    uf = (np.round(rng.normal(size=(40, 6)) * 4) / 4).astype(np.float32)
    vf = (np.round(rng.normal(size=(25, 6)) * 4) / 4).astype(np.float32)
    users = [f"u{i}" for i in range(40)]
    items = [f"i{i}" for i in range(25)]
    lines = [json.dumps({"user": f"u{int(u)}", "num": int(n)})
             for u, n in zip(rng.integers(0, 45, 60), rng.integers(1, 12, 60))]
    lines.insert(5, "BROKEN")

    jax_engine = jax_rec.engine_factory()
    jax_ep = jax_engine.engine_params_from_variant({"algorithms": [{"name": "als", "params": {}}]})
    jax_lines = jax_run_on(jax_engine, jax_ep, [jax_rec.ALSModel(uf, vf, users, items)], lines)

    model = ALSModel(uf, vf, users, items)
    model.device = "cpu"
    ep = engine_factory().engine_params_from_variant({"algorithms": [{"name": "als", "params": {}}]})
    assert isinstance(ep, EngineParams)
    port_lines = run_batch_predict_on(engine_factory(), ep, [model], lines)

    assert len(port_lines) == len(jax_lines) == 61
    n_ties = 0
    for line, got, want in zip(lines, port_lines, jax_lines):
        g, w = json.loads(got), json.loads(want)
        if "error" in w:
            assert g["line"] == w["line"] and "error" in g
            continue
        user = users.index(json.loads(line)["user"]) if json.loads(line)["user"] in users else None
        scores = [x["score"] for x in w["itemScores"]]
        n_ties += len(scores) - len(set(scores))
        _assert_same_topk(
            g["itemScores"], w["itemScores"], 1e-5,
            lambda item, u=user: float(uf[u] @ vf[items.index(item)]),
        )
    assert n_ties > 0  # the quantised factors did produce ties


class TestUploadDecoupling:
    """``torch.from_numpy`` aliases host memory. The scratch-buffer reuse of
    the double-buffered pipeline is sound only because ``ops.als.upload``
    copies: otherwise batch N-1's in-flight launch could read batch N's
    users (a torn read of the overwritten staging buffer)."""

    def test_upload_decouples_host_buffer(self):
        from predictionio_tpu_torch.ops.als import upload

        buf = np.arange(8, dtype=np.int32)
        d = upload(buf, np.int32, "cpu")
        buf[:] = 99  # the next batch's assembly
        np.testing.assert_array_equal(d.numpy(), np.arange(8, dtype=np.int32))

    def test_upload_passes_device_tensors_through(self):
        import torch

        from predictionio_tpu_torch.ops.als import upload

        d = torch.arange(4)
        assert upload(d) is d

    def test_dispatch_immune_to_post_dispatch_mutation(self):
        from predictionio_tpu_torch.ops import topk
        from predictionio_tpu_torch.ops.als import ServingIndex

        rng = np.random.default_rng(0)
        index = ServingIndex(
            rng.normal(size=(12, 6)).astype(np.float32),
            rng.normal(size=(8, 6)).astype(np.float32),
            "cpu",
        )
        expect = index.serve_batch(np.arange(8, dtype=np.int32), 4)[1]
        buf = np.arange(8, dtype=np.int32)
        handle = index.serve_batch_async(buf, 4)
        buf[:] = 0  # overwrite the staging buffer mid-flight
        _, idx = topk.fetch_topk(handle)
        np.testing.assert_array_equal(idx, expect)


def test_profile_phases_nest_and_the_barrier_accounts_to_the_current_phase():
    """The port's TrainProfile: exclusive-time nesting (a nested phase is
    never counted twice), and ``device_barrier`` (torch.cuda.synchronize on
    a card, no wait on the CPU) accounts its wait to the open phase."""
    from predictionio_tpu_torch.obs import xray

    now = [0.0]
    profile = xray.TrainProfile("t", clock=lambda: now[0])
    with xray.use_profile(profile), profile.measure():
        with xray.phase("outer"):
            now[0] += 1.0
            with xray.phase("inner"):
                now[0] += 2.0
                profile.device_barrier("cpu")
            now[0] += 0.5
    profile.finish()
    assert profile.wall_s == 3.5 and profile.attributed_s == 3.5
    assert profile.phases["outer"].wall_s == 1.5 and profile.phases["inner"].wall_s == 2.0
    assert profile.phases["inner"].device_s == 0.0 and "inner" in profile.to_json_dict()["phases"]
    assert xray.current_profile() is None


def test_writeback_guards_retry_only_transient_errors_and_open_the_breaker():
    """The event-store writeback's guards: a non-transient error fails at
    once, transient ones retry within the budget, and the breaker opens
    after ``failure_threshold`` consecutive failures, refusing calls until
    its recovery window has passed, when one probe closes it again."""
    from predictionio_tpu_torch.resilience import (
        CircuitBreaker, CircuitOpenError, RetryBudget, RetryPolicy)

    calls = []

    def fail(exc):
        calls.append(exc)
        raise exc

    policy = RetryPolicy(max_attempts=4, sleep=lambda s: None, rng=lambda: 0.0)
    with pytest.raises(ValueError):
        policy.call(fail, ValueError("bad payload"))
    assert len(calls) == 1
    with pytest.raises(ConnectionError):
        policy.call(fail, ConnectionError("blip"))
    assert len(calls) == 5 and policy.retries_attempted == 3
    starved = RetryPolicy(max_attempts=4, sleep=lambda s: None,
                          budget=RetryBudget(ratio=0.0, min_tokens=1.0))
    with pytest.raises(ConnectionError):
        starved.call(fail, ConnectionError("blip"))
    assert len(calls) == 7  # one retry, then the budget is empty

    now = [0.0]
    breaker = CircuitBreaker("wb", failure_threshold=2, recovery_timeout_s=5.0, clock=lambda: now[0])
    for _ in range(2):
        with pytest.raises(ConnectionError):
            breaker.call(fail, ConnectionError("down"))
    with pytest.raises(CircuitOpenError):
        breaker.call(lambda: "never called")
    now[0] = 6.0
    assert breaker.call(lambda: "probe") == "probe"  # half-open probe closes it
    assert breaker.call(lambda: "ok") == "ok" and breaker.trips == 1
