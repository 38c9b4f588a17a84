"""The port's evaluation grid (``predictionio_tpu_torch/tuning/``) on the
CPU: the behaviour cases of ``tests/test_tuning.py`` (content-addressed
cells, the event-store splitter, the durable ledger, prefix-cached cell
scoring through ``Engine.dispatch_batch``, the scheduler with resume, the
spawn pool and the cpu-fallback worker class), and parity with the JAX
package: fold assignment, cell ids, ledger interchange and naive-Bayes
per-params scores. Every process pool runs under its own deadline."""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal

import pytest

from predictionio_tpu_torch.controller import EmptyParams, Engine, EngineParams
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.eval import Evaluation, MetricEvaluator
from predictionio_tpu_torch.tuning import (
    EvalGridInstruments,
    EventStoreSplitter,
    GridSpec,
    TrialLedger,
    build_cells,
    cell_id_of,
)
from predictionio_tpu_torch.tuning import run_grid as _run_grid
from predictionio_tpu_torch.tuning.cells import CellScorer, dispatch_scores
from predictionio_tpu_torch.tuning.grid import CellKey
from predictionio_tpu_torch.tuning.runner import aggregate_params, pick_best
from tests.torch_sample_engine import (
    Algo0,
    AlgoParams,
    DataSource0,
    DSParams,
    Preparator0,
    Serving0,
)
from tests.torch_sample_evaluation import AlgoIdMetric, make_evaluation, sample_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_DEADLINE_S = 120  # every process pool of this file runs under it


def run_grid(*args, **kwargs):
    """The port's run_grid on the CPU unless a test asks otherwise."""
    kwargs.setdefault("device", "cpu")
    return _run_grid(*args, **kwargs)


def cpu_ctx(**kw):
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    return WorkflowContext(mode="evaluation", device="cpu", **kw)


@contextlib.contextmanager
def deadline(seconds: int = POOL_DEADLINE_S):
    """Fail a test (instead of hanging the suite) when a process pool does
    not finish in time."""
    def expired(signum, frame):
        raise TimeoutError(f"process pool ran past {seconds}s")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _cell_ids(report):
    return sorted(json.loads(line)["cellId"] for line in open(report.ledger_path))


@pytest.fixture
def memory_storage(tmp_path):
    from tests.torch_template_helpers import port_storage

    return port_storage(tmp_path, "memory")


def make_eval(params_sets=(3, 9, 5)):
    return Evaluation(
        engine=Engine(
            {"ds": DataSource0},
            {"prep": Preparator0},
            {"a": Algo0},
            {"s": Serving0},
        ),
        metric=AlgoIdMetric(),
        engine_params_generator=[sample_params(i) for i in params_sets],
    )


# ---------------------------------------------------------------------------
# grid construction
# ---------------------------------------------------------------------------


class TestGridConstruction:
    def test_cell_ids_content_addressed(self):
        import dataclasses

        ep_a, ep_b = sample_params(1), sample_params(2)
        span = {"app": "x"}
        a = cell_id_of(ep_a, 0, 2, span)
        # identical inputs -> identical id (across processes/runs)
        assert a == cell_id_of(ep_a, 0, 2, span)
        # any identity input re-keys the cell
        assert a != cell_id_of(ep_b, 0, 2, span)  # params
        assert a != cell_id_of(ep_a, 1, 2, span)  # fold
        assert a != cell_id_of(ep_a, 0, 3, span)  # fold layout
        assert a != cell_id_of(ep_a, 0, 2, {"app": "y"})  # data span
        # component NAMES are identity too: the flat params JSON carries
        # only algorithm names, so two params sets differing in e.g. the
        # serving component would otherwise collide and share ledger
        # records
        for field in ("data_source", "preparator", "serving"):
            renamed = dataclasses.replace(
                ep_a, **{field: ("other", getattr(ep_a, field)[1])}
            )
            assert a != cell_id_of(renamed, 0, 2, span), field

    def test_build_cells_params_major(self):
        spec = GridSpec([sample_params(1), sample_params(2)])
        cells = build_cells(spec, 3)
        assert [(c.params_index, c.fold) for c in cells] == [
            (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2),
        ]
        assert len({c.cell_id for c in cells}) == 6

    def test_spec_validation(self):
        with pytest.raises(ValueError):
            GridSpec([])
        with pytest.raises(ValueError):
            GridSpec([sample_params(1)], folds=0)


# ---------------------------------------------------------------------------
# event-store splitter
# ---------------------------------------------------------------------------


def _seed_events(storage, n_users=10, n_items=6, app_name="splitapp"):
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    events = []
    for u in range(n_users):
        for i in range(n_items):
            if (u + i) % 2:
                continue
            events.append(
                Event(
                    event="rate",
                    entity_type="user",
                    entity_id=f"u{u}",
                    target_entity_type="item",
                    target_entity_id=f"i{i}",
                    properties={"rating": 4.0},
                )
            )
    storage.get_l_events().insert_batch(events, app_id)
    return app_id


class TestEventStoreSplitter:
    def test_sticky_assignment_deterministic_and_complete(self, memory_storage):
        app_id = _seed_events(memory_storage)
        sp = EventStoreSplitter(memory_storage.get_l_events(), app_id, k=3)
        # assignment is a pure function of (user, salt, k): two splitter
        # instances (two processes, a resumed run) agree with no state
        sp2 = EventStoreSplitter(memory_storage.get_l_events(), app_id, k=3)
        for u in range(10):
            assert sp.fold_of(f"u{u}") == sp2.fold_of(f"u{u}")
            assert 0 <= sp.fold_of(f"u{u}") < 3
        # every user lands in exactly one fold; held-out sets partition
        all_users = {f"u{u}" for u in range(10)}
        heldout_users: set[str] = set()
        for fold in range(3):
            qs, _ = sp.heldout_fold(fold)
            users = {q["user"] for q in qs}
            assert not users & heldout_users  # disjoint across folds
            heldout_users |= users
            pred = sp.keep_for_training(fold)
            # training predicate is the exact complement of held-out
            assert {u for u in all_users if not pred(u)} == users
        assert heldout_users == all_users
        assert sum(sp.fold_sizes()) == 10

    def test_heldout_actuals_stream_off_find_after(self, memory_storage):
        app_id = _seed_events(memory_storage, n_users=6, n_items=4)
        levents = memory_storage.get_l_events()
        sp = EventStoreSplitter(levents, app_id, k=2, num=7, page=3)
        for fold in range(2):
            for q, actual in sp.iter_heldout(fold):
                u = int(q["user"][1:])
                expected = {f"i{i}" for i in range(4) if (u + i) % 2 == 0}
                assert actual == expected
                assert q["num"] == 7

    def test_event_name_filter_and_bounds(self, memory_storage):
        app_id = _seed_events(memory_storage, n_users=4, n_items=3)
        levents = memory_storage.get_l_events()
        # a non-matching event filter holds out nothing
        sp = EventStoreSplitter(
            levents, app_id, k=2, event_names=("buy",)
        )
        assert sum(sp.fold_sizes()) == 0
        with pytest.raises(ValueError):
            EventStoreSplitter(levents, app_id, k=0)
        sp = EventStoreSplitter(levents, app_id, k=2)
        with pytest.raises(ValueError):
            list(sp.iter_heldout(2))

    def test_empty_store(self, memory_storage):
        app_id = memory_storage.get_meta_data_apps().insert(App(0, "emptyapp"))
        sp = EventStoreSplitter(memory_storage.get_l_events(), app_id, k=2)
        assert sp.fold_sizes() == [0, 0]
        assert sp.heldout_fold(0) == ([], [])


# ---------------------------------------------------------------------------
# trial ledger
# ---------------------------------------------------------------------------


class TestTrialLedger:
    def test_append_load_roundtrip(self, tmp_path):
        ledger = TrialLedger(str(tmp_path / "ledger.jsonl"))
        with ledger:
            ledger.append({"cellId": "a", "score": 1.0})
            ledger.append({"cellId": "b", "score": 2.0})
        loaded = ledger.load()
        assert set(loaded) == {"a", "b"}
        assert loaded["b"]["score"] == 2.0

    def test_torn_tail_skipped(self, tmp_path):
        path = tmp_path / "ledger.jsonl"
        path.write_text(
            json.dumps({"cellId": "a", "score": 1.0})
            + "\n"
            + '{"cellId": "b", "sco'  # SIGKILL mid-append
        )
        loaded = TrialLedger(str(path)).load()
        assert set(loaded) == {"a"}

    def test_missing_cell_id_rejected(self, tmp_path):
        ledger = TrialLedger(str(tmp_path / "l.jsonl"))
        with pytest.raises(ValueError):
            ledger.append({"score": 1.0})

    def test_sha_tracks_content(self, tmp_path):
        ledger = TrialLedger(str(tmp_path / "l.jsonl"))
        empty = ledger.sha256()
        with ledger:
            ledger.append({"cellId": "a"})
        assert ledger.sha256() != empty
        assert ledger.sha256() == TrialLedger(str(tmp_path / "l.jsonl")).sha256()


# ---------------------------------------------------------------------------
# cell scoring
# ---------------------------------------------------------------------------


class TestCellScorer:
    def test_matches_sequential_metric_evaluator(self):
        """The grid's mega-batch scoring path agrees exactly with the
        sequential MetricEvaluator."""
        ev = make_eval()
        seq = MetricEvaluator(AlgoIdMetric()).evaluate_base(
            cpu_ctx(),
            make_eval().engine,
            list(ev.params_list()),
        )
        scorer = CellScorer.from_evaluation(make_eval(), ctx=cpu_ctx())
        for pi in range(3):
            for fold in range(2):
                rec = scorer.score_cell(CellKey(f"c{pi}{fold}", pi, fold))
                assert not rec.get("error"), rec
                assert rec["score"] == seq.engine_params_scores[pi].score
                assert rec["queries"] == 3
                assert rec["trainProfile"]["wallClockS"] >= 0

    def test_prefix_cache_hits_and_group_clear(self):
        """Cells sharing a data_source/preparator prefix read+prepare once
        per worker; the model cache is cleared between params groups to
        bound memory (data caches survive)."""
        scorer = CellScorer.from_evaluation(make_eval(), ctx=cpu_ctx())
        cells = build_cells(GridSpec(scorer.params_list), 2)
        for c in cells:
            rec = scorer.score_cell(c)
            assert not rec.get("error"), rec
        stats = scorer.engine.cache_stats
        assert stats["read_misses"] == 1  # one ds params across the grid
        assert stats["read_hits"] >= 5
        assert stats["prepare_misses"] == 1  # one (ds, prep) pair
        # every params group has distinct algo params -> model cache
        # cleared on each group boundary (2 boundaries for 3 groups)
        assert stats["model_clears"] == 2
        # each (params, fold) trained exactly once: 3 params x 2 folds
        assert stats["train_misses"] == 6

    def test_adjacent_shared_algo_params_reuse_models(self):
        """Two params sets differing only in non-algo params share trained
        models (the FastEvalEngine prefix contract) when adjacent."""
        a = sample_params(3)
        b = EngineParams(  # same ds/prep/algo, different serving params
            data_source=a.data_source,
            preparator=a.preparator,
            algorithms=a.algorithms,
            serving=("s", EmptyParams()),
        )
        ev = make_eval()
        ev.engine_params_generator = [a, b]
        scorer = CellScorer.from_evaluation(ev, ctx=cpu_ctx())
        for c in build_cells(GridSpec(scorer.params_list), 2):
            scorer.score_cell(c)
        stats = scorer.engine.cache_stats
        assert stats["train_misses"] == 2  # folds, not params x folds
        assert stats["train_hits"] == 2
        assert stats["model_clears"] == 0

    def test_failed_cell_is_a_record(self):
        class BoomMetric(AlgoIdMetric):
            def calculate(self, data):
                raise RuntimeError("boom")

        ev = make_eval()
        ev.metric = BoomMetric()
        scorer = CellScorer.from_evaluation(ev, ctx=cpu_ctx())
        rec = scorer.score_cell(CellKey("x", 0, 0))
        assert "boom" in rec["error"]
        assert math.isnan(rec["score"])

    def test_dispatch_scores_chunks_preserve_order(self):
        """Mega-batch chunking at any batch size returns query-aligned
        results (the two-slot overlap must not reorder)."""
        ev = make_eval()
        scorer = CellScorer.from_evaluation(ev, ctx=cpu_ctx(), batch_size=2)
        engine = scorer.engine
        ep = scorer.params_list[0]
        folds = engine._eval_folds(scorer.ctx, ep)
        td, ei, qa = folds[0]
        from predictionio_tpu_torch.controller.base import Doer

        algo = Algo0(AlgoParams(id=3))
        model = algo.train(scorer.ctx, Preparator0(DSParams(id=2)).prepare(scorer.ctx, td))
        serving = Serving0()
        queries = [q for q, _ in qa]
        for bs in (1, 2, 7):
            served = dispatch_scores(
                engine, [algo], serving, [model], queries, batch_size=bs
            )
            assert [p.qid for p in served] == [q.qid for q in queries]


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


class TestAggregation:
    def _cells(self):
        return [CellKey(f"c{p}{f}", p, f) for p in range(2) for f in range(2)]

    def test_query_weighted_mean(self):
        records = {
            "c00": {"cellId": "c00", "paramsIndex": 0, "fold": 0, "score": 1.0, "queries": 30, "otherScores": []},
            "c01": {"cellId": "c01", "paramsIndex": 0, "fold": 1, "score": 4.0, "queries": 10, "otherScores": []},
            "c10": {"cellId": "c10", "paramsIndex": 1, "fold": 0, "score": 2.0, "queries": 1, "otherScores": []},
            "c11": {"cellId": "c11", "paramsIndex": 1, "fold": 1, "score": 2.0, "queries": 1, "otherScores": []},
        }
        agg = aggregate_params(records, self._cells(), 2)
        assert agg[0].score == pytest.approx((1.0 * 30 + 4.0 * 10) / 40)
        assert agg[1].score == 2.0
        assert agg[0].fold_scores == [1.0, 4.0]

    def test_nan_cells_excluded_but_counted(self):
        nan = float("nan")
        records = {
            "c00": {"cellId": "c00", "paramsIndex": 0, "fold": 0, "score": nan, "queries": 10, "otherScores": [], "error": "x"},
            "c01": {"cellId": "c01", "paramsIndex": 0, "fold": 1, "score": 3.0, "queries": 10, "otherScores": []},
            "c10": {"cellId": "c10", "paramsIndex": 1, "fold": 0, "score": nan, "queries": 10, "otherScores": [], "error": "x"},
            "c11": {"cellId": "c11", "paramsIndex": 1, "fold": 1, "score": nan, "queries": 10, "otherScores": [], "error": "x"},
        }
        agg = aggregate_params(records, self._cells(), 2)
        assert agg[0].score == 3.0 and agg[0].failed_cells == 1
        assert math.isnan(agg[1].score) and agg[1].failed_cells == 2
        # NaN params can never win; finite first-seen wins ties
        assert pick_best(agg, AlgoIdMetric()) == 0

    def test_tie_break_first_seen(self):
        records = {
            "c00": {"cellId": "c00", "paramsIndex": 0, "fold": 0, "score": 5.0, "queries": 1, "otherScores": []},
            "c01": {"cellId": "c01", "paramsIndex": 0, "fold": 1, "score": 5.0, "queries": 1, "otherScores": []},
            "c10": {"cellId": "c10", "paramsIndex": 1, "fold": 0, "score": 5.0, "queries": 1, "otherScores": []},
            "c11": {"cellId": "c11", "paramsIndex": 1, "fold": 1, "score": 5.0, "queries": 1, "otherScores": []},
        }
        agg = aggregate_params(records, self._cells(), 2)
        assert pick_best(agg, AlgoIdMetric()) == 0


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


class TestGridRunner:
    def test_full_run_and_resume_zero_retrains(self, tmp_path):
        ev = make_eval()
        r = run_grid(ev, workdir=str(tmp_path), workers=0)
        assert r.best_score == 9.0 and r.best_params_index == 1
        assert r.cells_total == 6 and r.cells_run == 6
        assert r.folds == 2 and r.cells_per_hour > 0
        assert len(r.scores) == 3
        assert r.ledger_sha256
        # resume over a complete ledger: zero cells retrained
        trains = {"n": 0}

        class CountingAlgo(Algo0):
            def train(self, ctx, pd):
                trains["n"] += 1
                return super().train(ctx, pd)

        ev2 = make_eval()
        ev2.engine = Engine(
            {"ds": DataSource0},
            {"prep": Preparator0},
            {"a": CountingAlgo},
            {"s": Serving0},
        )
        r2 = run_grid(ev2, workdir=str(tmp_path), workers=0, resume=True)
        assert r2.cells_run == 0 and r2.cells_skipped == 6
        assert trains["n"] == 0
        assert r2.best_score == 9.0
        assert r2.ledger_sha256 == r.ledger_sha256

    def test_partial_ledger_resumes_only_missing(self, tmp_path):
        ev = make_eval()
        r = run_grid(ev, workdir=str(tmp_path / "a"), workers=0)
        # copy 4 of 6 ledger lines into a fresh workdir = a killed run
        lines = open(r.ledger_path).read().strip().splitlines()
        os.makedirs(tmp_path / "b")
        with open(tmp_path / "b" / "ledger.jsonl", "w") as fh:
            fh.write("\n".join(lines[:4]) + "\n")
        r2 = run_grid(make_eval(), workdir=str(tmp_path / "b"), workers=0, resume=True)
        assert r2.cells_skipped == 4 and r2.cells_run == 2
        assert r2.best_score == r.best_score

    def test_existing_ledger_without_resume_rejected(self, tmp_path):
        run_grid(make_eval(), workdir=str(tmp_path), workers=0)
        with pytest.raises(ValueError, match="resume"):
            run_grid(make_eval(), workdir=str(tmp_path), workers=0)

    def test_foreign_ledger_entries_ignored(self, tmp_path):
        """Content addressing: a ledger from a DIFFERENT grid shares the
        workdir without being trusted — its cells don't match."""
        run_grid(make_eval(params_sets=(1, 2)), workdir=str(tmp_path), workers=0)
        r = run_grid(make_eval(), workdir=str(tmp_path), workers=0, resume=True)
        assert r.cells_skipped == 0 and r.cells_run == 6

    def test_status_file_and_instruments(self, tmp_path):
        inst = EvalGridInstruments()
        status_path = str(tmp_path / "status.json")
        r = run_grid(
            make_eval(),
            workdir=str(tmp_path),
            workers=0,
            status_path=status_path,
            instruments=inst,
        )
        status = json.load(open(status_path))
        assert status["state"] == "done"
        assert status["cellsDone"] == 6 and status["cellsTotal"] == 6
        assert status["bestScore"] == 9.0 and status["metric"] == "AlgoIdMetric"
        assert inst.cells.value() == 6
        assert inst.queries.value() == 18  # 3 queries x 6 cells
        assert inst.active.value() == 0.0  # reset after the run
        assert inst.best_score.value() == 9.0
        assert r.evaluator_result is not None
        assert r.evaluator_result.best_index == 1

    def test_failed_cells_dont_kill_the_grid(self, tmp_path):
        class FoldBombDS(DataSource0):
            def read_eval(self, ctx):
                for fold, (td, ei, qa) in enumerate(super().read_eval(ctx)):
                    if fold == 1:
                        yield td, ei, [("not", "a", "query")]  # breaks scoring
                    else:
                        yield td, ei, qa

        ev = make_eval()
        ev.engine = Engine(
            {"ds": FoldBombDS},
            {"prep": Preparator0},
            {"a": Algo0},
            {"s": Serving0},
        )
        r = run_grid(ev, workdir=str(tmp_path), workers=0)
        assert r.cells_failed == 3  # fold 1 of each params set
        assert r.best_score == 9.0  # fold 0 still decides

    def test_live_instance_rejected_for_process_workers(self, tmp_path):
        with pytest.raises(ValueError, match="dotted path"):
            run_grid(make_eval(), workdir=str(tmp_path), workers=2)

    def test_publish_raises_until_the_registry_is_ported(self, tmp_path, monkeypatch):
        # the registry is ported: publish is refused (as in the JAX package)
        # only without the engine identity or a registry dir, before any cell
        from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

        monkeypatch.delenv("PIO_REGISTRY_DIR", raising=False)
        with pytest.raises(ValueError, match="engine identity"):
            run_grid(make_eval(), workdir=str(tmp_path), workers=0, publish=True)
        with pytest.raises(ValueError, match="registry dir"):
            run_grid(make_eval(), workdir=str(tmp_path), workers=0, publish=True,
                     engine_manifest=EngineManifest("e", "1", "engine.json", ""))
        assert not os.path.exists(tmp_path / "ledger.jsonl")  # refused before any cell

    def test_output_path_written(self, tmp_path):
        """Reference parity (MetricEvaluator.scala outputPath): an
        Evaluation carrying output_path gets its best-params JSON from
        the grid path too."""
        ev = make_eval()
        ev.output_path = str(tmp_path / "out" / "best.json")
        run_grid(ev, workdir=str(tmp_path / "grid"), workers=0)
        best = json.load(open(ev.output_path))
        assert best["score"] == 9.0
        assert (
            best["engineParams"]["algorithms_params"][0]["params"]["id"] == 9
        )

    def test_oversized_folds_fail_the_run_not_the_ledger(self, tmp_path):
        """`--folds 5` against a 2-fold read_eval is a CONFIG error: the
        run aborts at the first out-of-range cell instead of durably
        ledgering never-retried failed cells. In-range cells finished
        before the abort stay in the ledger for a corrected resume."""
        from predictionio_tpu_torch.tuning.cells import FoldRangeError

        with pytest.raises(FoldRangeError, match="out of range"):
            run_grid(make_eval(), workdir=str(tmp_path), workers=0, folds=5)
        lines = open(tmp_path / "ledger.jsonl").read().strip().splitlines()
        assert len(lines) == 2  # folds 0-1 of params 0 finished; fold 2 aborted
        # a corrected fold count CHANGES the fold layout, so content
        # addressing re-keys every cell: the bad run's lines are ignored
        # (not trusted for a different membership), the grid runs clean
        r = run_grid(
            make_eval(), workdir=str(tmp_path), workers=0, folds=2, resume=True
        )
        assert r.cells_skipped == 0 and r.cells_run == 6
        assert r.best_score == 9.0

    def test_failed_validation_leaves_no_evaluation_row(
        self, tmp_path, memory_storage
    ):
        """A flag typo (ledger-exists-without-resume) must not pollute the
        metadata store with a forever-EVALUATING row."""
        from predictionio_tpu_torch.workflow.core_workflow import run_grid_evaluation

        run_grid(make_eval(), workdir=str(tmp_path), workers=0)
        with pytest.raises(ValueError, match="resume"):
            run_grid_evaluation(
                make_eval(),
                cpu_ctx(_storage=memory_storage),
                workdir=str(tmp_path),
                workers=0,
            )
        # no row at all — not even an INIT/EVALUATING zombie
        instances = memory_storage.get_meta_data_evaluation_instances()
        assert instances.get_all() == []

    def test_fakerun_style_evaluation_rejected_cleanly(self, tmp_path):
        """An Evaluation-shaped object without engine/metric (FakeRun)
        must get the clean ValueError the CLI routes on, never an
        AttributeError (cmd_eval keeps FakeRun on the sequential path)."""
        from predictionio_tpu_torch.workflow.fake_workflow import FakeRun

        with pytest.raises(ValueError, match="engine and metric"):
            run_grid(FakeRun(lambda ctx: 42), workdir=str(tmp_path), workers=0)


class TestWorkerClassKnobs:
    """The background-citizen contract: grid workers of the cpu-fallback
    class see no card (``CUDA_VISIBLE_DEVICES=""``), run on the CPU, and are
    at most four; `--nice` re-nices every pool worker."""

    def test_cpu_fallback_hides_the_cards(self):
        from predictionio_tpu_torch.tuning import (
            WORKER_CLASS_CPU_FALLBACK,
            grid_worker_env,
            worker_device,
        )

        env = grid_worker_env(WORKER_CLASS_CPU_FALLBACK, {"PIO_X": "1"})
        assert env == {"PIO_X": "1", "CUDA_VISIBLE_DEVICES": ""}
        # an explicit caller override wins (setdefault, not clobber)
        env = grid_worker_env(WORKER_CLASS_CPU_FALLBACK, {"CUDA_VISIBLE_DEVICES": "1"})
        assert env["CUDA_VISIBLE_DEVICES"] == "1"
        # the default class leaves the env alone
        assert grid_worker_env("", {"A": "b"}) == {"A": "b"}
        assert grid_worker_env("") == {}
        # the device is asked for by name, never a fallback of the code's own
        assert worker_device(WORKER_CLASS_CPU_FALLBACK, "cuda") == "cpu"
        assert worker_device("", "cuda") == "cuda"
        assert worker_device("", "cpu") == "cpu"

    def test_default_class_needs_the_card(self, tmp_path):
        """Without a card the default device raises at once; nothing runs
        on the CPU unless asked for."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run_grid(make_eval(), workdir=str(tmp_path), workers=0)

    def test_worker_class_matches_fleet_replica_class(self):
        """One vocabulary with the JAX package: the class name its fleet
        supervisor uses for cpu-fallback serving replicas."""
        from predictionio_tpu.fleet.supervisor import REPLICA_CLASS_CPU
        from predictionio_tpu_torch.tuning import WORKER_CLASS_CPU_FALLBACK

        assert WORKER_CLASS_CPU_FALLBACK == REPLICA_CLASS_CPU == "cpu-fallback"

    def test_cpu_fallback_clamps_worker_count(self, tmp_path):
        from predictionio_tpu_torch.tuning import (
            CPU_FALLBACK_MAX_WORKERS,
            WORKER_CLASS_CPU_FALLBACK,
        )

        # workers=0 (in-process) stays in-process; the clamp only caps a
        # pool bigger than the fallback budget, so run the cheap path and
        # assert through the report's worker count
        r = _run_grid(  # the default device: the class alone sends it to the CPU
            make_eval(params_sets=(1,)),
            workdir=str(tmp_path),
            workers=0,
            worker_class=WORKER_CLASS_CPU_FALLBACK,
        )
        assert r.cells_total == 2
        assert CPU_FALLBACK_MAX_WORKERS >= 1

    def test_negative_nice_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="nice"):
            run_grid(
                make_eval(), workdir=str(tmp_path), workers=0, nice=-5
            )

    def test_init_worker_renices_before_env_and_scorer(self, monkeypatch):
        from predictionio_tpu_torch.tuning import cells

        order: list = []
        monkeypatch.setattr(os, "nice", lambda n: order.append(("nice", n)))
        monkeypatch.setattr(
            cells, "resolve_evaluation", lambda src: order.append(("resolve", src))
        )

        class FakeScorer:
            @staticmethod
            def from_evaluation(ev, ctx=None, batch_size=0):
                order.append(("scorer", batch_size))
                return object()

        monkeypatch.setattr(cells, "CellScorer", FakeScorer)
        job = cells.GridJob(source="x.make_eval", nice=10, batch_size=7, device="cpu")
        cells.init_worker(job)
        assert order[0] == ("nice", 10)  # priority drops FIRST
        assert ("scorer", 7) in order

    def test_init_worker_nice_zero_inherits(self, monkeypatch):
        from predictionio_tpu_torch.tuning import cells

        called = []
        monkeypatch.setattr(os, "nice", lambda n: called.append(n))
        monkeypatch.setattr(cells, "resolve_evaluation", lambda src: None)

        class FakeScorer:
            @staticmethod
            def from_evaluation(ev, ctx=None, batch_size=0):
                return object()

        monkeypatch.setattr(cells, "CellScorer", FakeScorer)
        cells.init_worker(cells.GridJob(source="x", device="cpu"))
        assert called == []

    def test_pool_workers_inherit_cpu_pin_and_nice(self, tmp_path):
        """Spawn-pool workers of the cpu-fallback class boot with no card
        visible, on the CPU, at a dropped priority: asserted from inside
        the workers (the probe algorithm records its env, device and
        os.nice(0) per trained cell)."""
        from predictionio_tpu_torch.tuning import WORKER_CLASS_CPU_FALLBACK

        base_nice = os.nice(0)
        probe = str(tmp_path / "workers.jsonl")
        with deadline():
            r = _run_grid(
                "tests.torch_sample_evaluation.make_probe_evaluation",
                workdir=str(tmp_path / "grid"),
                workers=2,
                cwd=REPO,
                env={"GRID_WORKER_PROBE": probe},
                nice=5,
                worker_class=WORKER_CLASS_CPU_FALLBACK,
            )
        assert r.cells_run == 4
        records = [
            json.loads(line) for line in open(probe).read().splitlines()
        ]
        assert len(records) == 4
        assert all(rec["cuda_visible_devices"] == "" for rec in records)
        assert all(rec["device"] == "cpu" for rec in records)
        assert all(rec["nice"] == base_nice + 5 for rec in records)
        assert all(rec["pid"] != os.getpid() for rec in records)

    def test_run_grid_builds_niced_cpu_job(self, tmp_path, monkeypatch):
        """The seam run_grid hands the pool: GridJob carries the nice
        level, the card-hiding env and the CPU device (what init_worker
        applies)."""
        from predictionio_tpu_torch.tuning import WORKER_CLASS_CPU_FALLBACK
        from predictionio_tpu_torch.tuning import runner as runner_mod

        captured = {}

        class FakePool:
            def __init__(self, max_workers, mp_context=None,
                         initializer=None, initargs=()):
                captured["job"] = initargs[0]
                raise RuntimeError("stop before real workers spawn")

        monkeypatch.setattr(runner_mod, "ProcessPoolExecutor", FakePool)
        with pytest.raises(RuntimeError, match="stop before"):
            run_grid(
                "tests.torch_sample_evaluation.make_evaluation",
                workdir=str(tmp_path),
                workers=2,
                nice=12,
                worker_class=WORKER_CLASS_CPU_FALLBACK,
                env={"PIO_FS_BASEDIR": "/x"},
            )
        job = captured["job"]
        assert job.nice == 12
        assert job.env["CUDA_VISIBLE_DEVICES"] == ""
        assert job.device == "cpu"
        assert job.env["PIO_FS_BASEDIR"] == "/x"


class TestProcessPool:
    def test_pool_workers_match_sequential(self, tmp_path):
        with deadline():
            r = run_grid(
                "tests.torch_sample_evaluation.make_evaluation",
                workdir=str(tmp_path),
                workers=2,
                cwd=REPO,
            )
        assert r.best_score == 9.0 and r.cells_run == 6
        seq = run_grid(make_eval(), workdir=str(tmp_path / "seq"), workers=0)
        assert _cell_ids(r) == _cell_ids(seq)
        # a second pool run resumes everything
        with deadline():
            r2 = run_grid(
                "tests.torch_sample_evaluation.make_evaluation",
                workdir=str(tmp_path),
                workers=2,
                cwd=REPO,
                resume=True,
            )
        assert r2.cells_run == 0 and r2.cells_skipped == 6


# ---------------------------------------------------------------------------
# winner publication
# ---------------------------------------------------------------------------



class TestGridEvaluationWorkflow:
    def test_persists_evaluation_instance(self, tmp_path, memory_storage):
        from predictionio_tpu_torch.workflow.core_workflow import run_grid_evaluation

        iid, report = run_grid_evaluation(
            make_eval(),
            cpu_ctx(_storage=memory_storage),
            workdir=str(tmp_path),
            workers=0,
        )
        inst = memory_storage.get_meta_data_evaluation_instances().get(iid)
        assert inst.status == "EVALCOMPLETED"
        assert "best: 9.0" in inst.evaluator_results
        assert json.loads(inst.evaluator_results_json)["bestScore"] == 9.0
        assert inst.evaluator_results_html.startswith("<h2>")
        assert report.best_score == 9.0




# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def test_fold_assignment_equals_the_jax_packages(tmp_path):
    """``sticky_bucket`` and ``EventStoreSplitter`` give every user the JAX
    package's fold, and the held-out folds read off equal stores match."""
    from predictionio_tpu.data.datamap import DataMap
    from predictionio_tpu.data.event import Event as JaxEvent
    from predictionio_tpu.data.storage.base import App as JaxApp
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.registry.router import sticky_bucket as jax_bucket
    from predictionio_tpu.tuning.grid import EventStoreSplitter as JaxSplitter
    from predictionio_tpu_torch.tuning.grid import sticky_bucket

    for key in ("u0", "user-17", "ü", ""):
        for salt in ("", "pio-eval", "x"):
            assert sticky_bucket(key, salt) == jax_bucket(key, salt)
    jax_storage = JaxStorage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEM" for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    })
    jax_app = jax_storage.get_meta_data_apps().insert(JaxApp(0, "splitapp"))
    jax_storage.get_l_events().insert_batch([
        JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                 target_entity_id=f"i{i}", properties=DataMap({"rating": 4.0}))
        for u in range(40) for i in range(6) if (u + i) % 2 == 0
    ], jax_app)
    from tests.torch_template_helpers import port_storage

    storage = port_storage(tmp_path, "memory")
    app_id = _seed_events(storage, n_users=40)
    for k in (2, 3, 5):
        jsp = JaxSplitter(jax_storage.get_l_events(), jax_app, k=k, num=4, page=7)
        psp = EventStoreSplitter(storage.get_l_events(), app_id, k=k, num=4, page=7)
        assert [psp.fold_of(f"u{u}") for u in range(40)] == [jsp.fold_of(f"u{u}") for u in range(40)]
        assert psp.fold_sizes() == jsp.fold_sizes()
        for fold in range(k):
            assert psp.heldout_fold(fold) == jsp.heldout_fold(fold)


def _jax_classification_params(lam):
    from predictionio_tpu.models.classification import engine as jax_cl

    return jax_cl.engine_factory().engine_params_from_variant(_nb_variant(lam))


def _nb_variant(lam):
    return {"datasource": {"params": {"appName": "clsapp", "evalK": 3}},
            "algorithms": [{"name": "naive", "params": {"lambda": lam}}]}


def test_cell_ids_equal_the_jax_packages():
    """The same GridSpec names the same cells in both packages (sample
    engine and naive-Bayes classification)."""
    from predictionio_tpu.tuning.grid import GridSpec as JaxSpec
    from predictionio_tpu.tuning.grid import build_cells as jax_build
    from predictionio_tpu_torch.models.classification import engine as pt_cl
    from tests.sample_evaluation import sample_params as jax_sample_params

    span = {"app": "clsapp", "events": 90}
    for n_folds in (1, 3):
        ours = build_cells(GridSpec([sample_params(i) for i in (3, 9, 5)], data_span=span), n_folds)
        theirs = jax_build(JaxSpec([jax_sample_params(i) for i in (3, 9, 5)], data_span=span), n_folds)
        assert ours == [type(ours[0])(c.cell_id, c.params_index, c.fold) for c in theirs]
        pe = pt_cl.engine_factory()
        ours = build_cells(GridSpec([pe.engine_params_from_variant(_nb_variant(lam))
                                     for lam in (0.5, 1.0)], data_span=span), n_folds)
        theirs = jax_build(JaxSpec([_jax_classification_params(lam) for lam in (0.5, 1.0)],
                                   data_span=span), n_folds)
        assert [c.cell_id for c in ours] == [c.cell_id for c in theirs]


def test_ledger_written_by_one_package_resumes_in_the_other(tmp_path):
    """A ledger the JAX package wrote resumes in the port with zero cells
    retrained, and the port's resumes in the JAX package the same way."""
    from predictionio_tpu.tuning import run_grid as jax_run_grid
    from tests.sample_evaluation import make_evaluation as jax_make_evaluation

    jax_report = jax_run_grid(jax_make_evaluation(), workdir=str(tmp_path / "a"), workers=0)
    resumed = run_grid(make_evaluation(), workdir=str(tmp_path / "a"), resume=True)
    assert resumed.cells_run == 0 and resumed.cells_skipped == 6
    assert resumed.scores == jax_report.scores

    ours = run_grid(make_evaluation(), workdir=str(tmp_path / "b"))
    assert TrialLedger(ours.ledger_path).load().keys() == TrialLedger(jax_report.ledger_path).load().keys()
    theirs = jax_run_grid(jax_make_evaluation(), workdir=str(tmp_path / "b"), workers=0, resume=True)
    assert theirs.cells_run == 0 and theirs.cells_skipped == 6
    assert theirs.best_params_index == ours.best_params_index == 1


def test_naive_bayes_grid_scores_equal_the_jax_packages(memory_storage, tmp_path, monkeypatch):
    """Naive Bayes is deterministic: the grid's per-params fold scores over
    lambda ∈ {0.5, 1.0, 4.0} and 3 folds equal the JAX package's exactly."""
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.eval import Evaluation as JaxEvaluation
    from predictionio_tpu.eval import metric as jax_metric
    from predictionio_tpu.models.classification import engine as jax_cl
    from predictionio_tpu.tuning import run_grid as jax_run_grid
    from predictionio_tpu_torch.eval import metric as pt_metric
    from predictionio_tpu_torch.models.classification import engine as pt_cl
    from tests.test_torch_classification import _events
    from tests.torch_template_helpers import jax_store, port_store, write_events

    def accuracy(mod):
        return type("Accuracy", (mod.AverageMetric,), {
            "calculate_score": lambda self, ei, q, p, a: float(p.label == a.label)})()

    events = write_events(tmp_path / "cls.jsonl", _events(n=90, seed=4))
    jax_storage = JaxStorage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEM" for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    })
    jctx = jax_store(jax_storage, "clsapp", events)
    monkeypatch.setattr(JaxStorage, "_singleton", jax_storage)
    lams = (0.5, 1.0, 4.0)
    jeng = jax_cl.engine_factory()
    jrep = jax_run_grid(
        JaxEvaluation(engine=jeng, metric=accuracy(jax_metric),
                      engine_params_generator=[_jax_classification_params(x) for x in lams]),
        workdir=str(tmp_path / "jax"), workers=0, ctx=jctx,
    )
    peng = pt_cl.engine_factory()
    prep = run_grid(
        Evaluation(engine=peng, metric=accuracy(pt_metric),
                   engine_params_generator=[peng.engine_params_from_variant(_nb_variant(x))
                                            for x in lams]),
        workdir=str(tmp_path / "port"), ctx=port_store(tmp_path, "clsapp", events, mode="evaluation"),
    )
    assert [s["foldScores"] for s in prep.scores] == [s["foldScores"] for s in jrep.scores]
    assert [s["score"] for s in prep.scores] == [s["score"] for s in jrep.scores]
    assert prep.best_params_index == jrep.best_params_index
    assert _cell_ids(prep) == _cell_ids(jrep)
