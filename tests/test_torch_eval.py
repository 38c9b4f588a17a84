"""The port's evaluation stack (``predictionio_tpu_torch/eval/``,
``Engine.eval``, ``run_evaluation``) on the CPU: the behaviour cases of
``tests/test_eval.py`` on the port's sample engine, and parity with the JAX
package: every metric on the same data, the templates' ``read_eval`` folds,
naive-Bayes ``Engine.eval`` scores, and recommendation precision@10."""

import json

import pytest

from predictionio_tpu_torch.controller import EmptyParams, EngineParams
from predictionio_tpu_torch.eval import (
    AverageMetric,
    Evaluation,
    FastEvalEngine,
    MetricEvaluator,
    OptionAverageMetric,
    OptionStdevMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
    grid_search,
)
from predictionio_tpu_torch.eval.generator import EngineParamsGenerator
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
from tests.torch_sample_engine import (
    Algo0,
    AlgoParams,
    DataSource0,
    DSParams,
    Preparator0,
    Serving0,
)

CTX = WorkflowContext(mode="evaluation", device="cpu")


class QidMetric(AverageMetric):
    """Score = prediction's algo id (deterministic, param-sensitive)."""

    def calculate_score(self, ei, q, p, a) -> float:
        return float(p.algo_id)


class MatchMetric(AverageMetric):
    def calculate_score(self, ei, q, p, a) -> float:
        return 1.0 if p.qid == a.qid else 0.0


def make_engine(cls=None):
    from predictionio_tpu_torch.controller import Engine

    cls = cls or Engine
    return cls({"ds": DataSource0}, {"prep": Preparator0}, {"a": Algo0}, {"s": Serving0})


def params(algo_id):
    return EngineParams(
        data_source=("ds", DSParams(id=1)),
        preparator=("prep", DSParams(id=2)),
        algorithms=[("a", AlgoParams(id=algo_id))],
        serving=("s", EmptyParams()),
    )


class TestMetrics:
    DATA = [
        ("ei0", [("q", type("P", (), {"v": 1.0})(), "a")]),
    ]

    def test_average_pools_folds(self):
        class M(AverageMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        data = [(None, [(0, 1.0, 0), (0, 2.0, 0)]), (None, [(0, 6.0, 0)])]
        assert M().calculate(data) == 3.0

    def test_option_average_skips_none(self):
        class M(OptionAverageMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        data = [(None, [(0, 1.0, 0), (0, None, 0), (0, 3.0, 0)])]
        assert M().calculate(data) == 2.0

    def test_stdev(self):
        class M(StdevMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        data = [(None, [(0, 2.0, 0), (0, 4.0, 0)])]
        assert M().calculate(data) == 1.0

    def test_sum_and_zero(self):
        class M(SumMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        data = [(None, [(0, 2.0, 0), (0, 4.0, 0)])]
        assert M().calculate(data) == 6.0
        assert ZeroMetric().calculate(data) == 0.0


class TestMetricContracts:
    """Comparator direction on every shipped metric, None-score filtering,
    and NaN semantics."""

    def _data(self, values):
        return [(None, [(0, v, 0) for v in values])]

    def test_compare_direction_all_shipped_metrics(self):
        """Default ordering is bigger-is-better on every shipped metric
        (ref Metric.scala:56-66) — including the ranking metrics the
        grid search optimizes. A metric wanting smaller-is-better must
        override compare; none of the shipped ones do."""
        from predictionio_tpu_torch.eval.metric import (
            AverageMetric,
            Metric,
            OptionAverageMetric,
            OptionStdevMetric,
            StdevMetric,
            SumMetric,
            ZeroMetric,
        )
        from predictionio_tpu_torch.tuning.metrics import (
            NDCGAtK,
            PrecisionAtK,
            RecallAtK,
        )

        shipped = [
            Metric(),
            AverageMetric(),
            OptionAverageMetric(),
            StdevMetric(),
            OptionStdevMetric(),
            SumMetric(),
            ZeroMetric(),
            PrecisionAtK(5),
            RecallAtK(5),
            NDCGAtK(5),
        ]
        for m in shipped:
            name = type(m).__name__
            assert m.compare(2.0, 1.0) > 0, name
            assert m.compare(1.0, 2.0) < 0, name
            assert m.compare(1.5, 1.5) == 0, name

    def test_option_metrics_filter_none(self):
        class Avg(OptionAverageMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        class Std(OptionStdevMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        data = self._data([1.0, None, 3.0, None])
        assert Avg().calculate(data) == 2.0
        assert Std().calculate(data) == 1.0
        # all-None pools to NaN (not a crash, not 0.0)
        all_none = self._data([None, None])
        assert Avg().calculate(all_none) != Avg().calculate(all_none)
        assert Std().calculate(all_none) != Std().calculate(all_none)

    def test_empty_set_semantics(self):
        class Avg(AverageMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        class Sum(SumMetric):
            def calculate_score(self, ei, q, p, a):
                return p

        empty = [(None, [])]
        assert Avg().calculate(empty) != Avg().calculate(empty)  # NaN
        assert Sum().calculate(empty) == 0.0  # sum of nothing is zero
        assert ZeroMetric().calculate(empty) == 0.0


class TestMetricEvaluator:
    def test_tracks_best(self, tmp_path):
        evaluator = MetricEvaluator(
            QidMetric(), [MatchMetric()], output_path=str(tmp_path / "best.json")
        )
        result = evaluator.evaluate_base(
            CTX, make_engine(), [params(3), params(9), params(5)]
        )
        assert result.best_index == 1
        assert result.best_score == 9.0
        assert result.best_engine_params.algorithms[0][1].id == 9
        # all candidates scored, secondary metric present
        assert [s.score for s in result.engine_params_scores] == [3.0, 9.0, 5.0]
        assert all(s.other_scores == [1.0] for s in result.engine_params_scores)
        # best.json written
        best = json.loads((tmp_path / "best.json").read_text())
        assert best["score"] == 9.0
        # renderings
        assert "best: 9.0" in result.one_liner()
        assert result.to_json_dict()["bestIndex"] == 1
        assert "<table" in result.to_html()

    def test_empty_params_list_rejected(self):
        with pytest.raises(ValueError):
            MetricEvaluator(QidMetric()).evaluate_base(CTX, make_engine(), [])

    def test_tie_break_first_seen_wins_stable(self):
        """Equal best scores keep the FIRST-seen params set (compare must
        be strictly positive to displace) — and the pick is stable across
        repeated runs, so a grid resume or re-run can never flip the
        winner between tied candidates."""

        class TiedMetric(AverageMetric):
            def calculate_score(self, ei, q, p, a) -> float:
                return 7.0 if p.algo_id in (9, 5) else float(p.algo_id)

        grid = [params(3), params(9), params(5)]
        picks = [
            MetricEvaluator(TiedMetric())
            .evaluate_base(CTX, make_engine(), grid)
            .best_index
            for _ in range(3)
        ]
        assert picks == [1, 1, 1]  # params(9) seen first among the tie

    def test_nan_score_never_wins(self):
        """A NaN score in slot 0 must be displaced by any finite score:
        compare() uses ordering operators, which NaN answers False both
        ways."""

        class NanFirstMetric(AverageMetric):
            def calculate_score(self, ei, q, p, a) -> float:
                return float("nan") if p.algo_id == 3 else float(p.algo_id)

        result = MetricEvaluator(NanFirstMetric()).evaluate_base(
            CTX, make_engine(), [params(3), params(9), params(5)]
        )
        assert result.best_index == 1
        assert result.best_score == 9.0


class TestGridSearch:
    def test_cartesian(self):
        gen = grid_search(params(1), {"id": [10, 20, 30]})
        assert [ep.algorithms[0][1].id for ep in gen.engine_params_list] == [10, 20, 30]

    def test_multi_field(self):
        import dataclasses

        from predictionio_tpu_torch.controller import Params

        @dataclasses.dataclass(frozen=True)
        class P2(Params):
            a: int = 0
            b: str = "x"

        base = EngineParams(
            data_source=("ds", DSParams(id=1)),
            preparator=("prep", DSParams(id=2)),
            algorithms=[("a", P2())],
            serving=("s", EmptyParams()),
        )
        gen = grid_search(base, {"a": [1, 2], "b": ["p", "q"]})
        combos = {(ep.algorithms[0][1].a, ep.algorithms[0][1].b) for ep in gen.engine_params_list}
        assert combos == {(1, "p"), (1, "q"), (2, "p"), (2, "q")}


class TestEvaluationRun:
    def test_run_evaluation_persists_instance(self, tmp_path):
        from tests.torch_template_helpers import port_storage

        memory_storage = port_storage(tmp_path, "memory")
        evaluation = Evaluation(
            engine=make_engine(),
            metric=QidMetric(),
            engine_params_generator=EngineParamsGenerator([params(4), params(2)]),
        )
        ctx = WorkflowContext(mode="evaluation", device="cpu", _storage=memory_storage)
        iid, result = run_evaluation(evaluation, ctx)
        assert result.best_score == 4.0
        inst = memory_storage.get_meta_data_evaluation_instances().get(iid)
        assert inst.status == "EVALCOMPLETED"
        assert "best: 4.0" in inst.evaluator_results
        assert json.loads(inst.evaluator_results_json)["bestScore"] == 4.0
        assert inst.evaluator_results_html.startswith("<h2>")
        assert [i.id for i in
                memory_storage.get_meta_data_evaluation_instances().get_completed()] == [iid]


class TestFastEval:
    def test_memoizes_shared_prefixes(self):
        calls = {"read": 0, "prepare": 0, "train": 0}

        class CountingDS(DataSource0):
            def read_eval(self, ctx):
                calls["read"] += 1
                return super().read_eval(ctx)

        class CountingPrep(Preparator0):
            def prepare(self, ctx, td):
                calls["prepare"] += 1
                return super().prepare(ctx, td)

        class CountingAlgo(Algo0):
            def train(self, ctx, pd):
                calls["train"] += 1
                return super().train(ctx, pd)

        engine = FastEvalEngine(
            {"ds": CountingDS}, {"prep": CountingPrep}, {"a": CountingAlgo}, {"s": Serving0}
        )
        grid = [params(1), params(2), params(1)]  # params(1) repeated
        evaluator = MetricEvaluator(QidMetric())
        result = evaluator.evaluate_base(CTX, engine, grid)
        assert result.best_score == 2.0
        assert calls["read"] == 1  # same datasource params across grid
        assert calls["prepare"] == 2  # 2 folds, once each
        # 2 folds x 2 distinct algo params = 4 trains (not 6)
        assert calls["train"] == 4

    def test_results_match_plain_engine(self):
        plain = make_engine()
        fast = make_engine(FastEvalEngine)
        ep = params(7)
        plain_result = QidMetric().calculate(plain.eval(CTX, ep))
        fast_result = QidMetric().calculate(fast.eval(CTX, ep))
        assert plain_result == fast_result

    def test_cache_stats_and_models_only_clear(self):
        """The hit/miss counters the grid workers assert on, and the
        ``keep_data`` clear the scheduler uses between params groups:
        models drop (memory bound), data caches survive (prefix
        sharing)."""
        engine = make_engine(FastEvalEngine)
        engine.eval(CTX, params(1))
        engine.eval(CTX, params(1))  # full prefix reuse
        stats = engine.cache_stats
        assert stats["read_misses"] == 1 and stats["read_hits"] >= 1
        assert stats["prepare_misses"] == 1 and stats["prepare_hits"] >= 1
        assert stats["train_misses"] == 2  # 2 folds, once each
        assert stats["train_hits"] == 2  # second eval reused both
        engine.clear_caches(keep_data=True)
        assert stats["model_clears"] == 1
        assert not engine._model_cache
        assert engine._eval_data_cache and engine._prepared_cache
        engine.eval(CTX, params(1))
        assert stats["read_misses"] == 1  # data cache survived the clear
        assert stats["train_misses"] == 4  # models had to retrain
        engine.clear_caches()
        assert not engine._eval_data_cache and not engine._prepared_cache


class TestFakeRun:
    def test_fakerun_runs_and_is_not_saved(self, tmp_path):
        from predictionio_tpu_torch.workflow.fake_workflow import FakeRun
        from tests.torch_template_helpers import port_storage

        storage = port_storage(tmp_path, "memory")
        seen = []

        class HelloWorld(FakeRun):
            def func(ctx):
                seen.append(ctx.mode)
                return 42

        ctx = WorkflowContext(mode="evaluation", device="cpu", _storage=storage)
        iid, result = run_evaluation(HelloWorld(), ctx)
        assert seen == ["evaluation"] and result.value == 42 and result.no_save
        inst = storage.get_meta_data_evaluation_instances().get(iid)
        assert inst.status == "EVALUATING"  # never completed: not persisted
        assert storage.get_meta_data_evaluation_instances().get_completed() == []


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _numeric_metrics(pkg_metric):
    """Every eval/metric.py metric of one package, scoring ``p``."""
    def sub(base):
        return type(f"P{base.__name__}", (base,), {"calculate_score": lambda self, ei, q, p, a: p})

    return [
        sub(pkg_metric.AverageMetric)(),
        sub(pkg_metric.OptionAverageMetric)(),
        sub(pkg_metric.StdevMetric)(),
        sub(pkg_metric.OptionStdevMetric)(),
        sub(pkg_metric.SumMetric)(),
        pkg_metric.ZeroMetric(),
    ]


def test_every_metric_equals_the_jax_packages_on_the_same_data():
    """eval/metric.py and tuning/metrics.py on one seeded data set: equal
    to the last bit (both compute in float64 on the host)."""
    import numpy as np

    from predictionio_tpu.eval import metric as jax_metric
    from predictionio_tpu.tuning import metrics as jax_rank
    from predictionio_tpu_torch.eval import metric as pt_metric
    from predictionio_tpu_torch.tuning import metrics as pt_rank

    rng = np.random.default_rng(11)
    numeric = [
        (f"fold{f}", [(i, None if rng.random() < 0.2 else float(rng.normal()), 0)
                      for i in range(int(rng.integers(5, 40)))])
        for f in range(3)
    ]
    # the option metrics skip None; the others see only the scored rows
    dense = [(ei, [(q, p, a) for q, p, a in qpas if p is not None]) for ei, qpas in numeric]
    for jm, pm in zip(_numeric_metrics(jax_metric), _numeric_metrics(pt_metric)):
        data = numeric if "Option" in type(jm).__name__ else dense
        assert pm.calculate(data) == jm.calculate(data), type(pm).__name__
        assert pm.header() == jm.header()
    items = [f"i{k}" for k in range(30)]
    ranked = [
        (None, [(None,
                 {"itemScores": [{"item": it, "score": 1.0} for it in
                                 rng.choice(items, int(rng.integers(0, 12)), replace=False)]},
                 {"items": list(rng.choice(items, int(rng.integers(0, 6)), replace=False))})
                for _ in range(50)])
        for _ in range(2)
    ]
    for name in ("PrecisionAtK", "RecallAtK", "NDCGAtK"):
        for k in (1, 5, 10):
            jm, pm = getattr(jax_rank, name)(k), getattr(pt_rank, name)(k)
            assert pm.calculate(ranked) == jm.calculate(ranked), (name, k)
            assert pm.header() == jm.header()


def _rating_events(n_users, n_items, seed, density=0.3):
    import numpy as np

    from tests.torch_template_helpers import event_time

    rng = np.random.default_rng(seed)
    out, k = [], 0
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < density:
                out.append({
                    "event": "rate", "entityType": "user", "entityId": f"u{u}",
                    "targetEntityType": "item", "targetEntityId": f"i{i}",
                    "properties": {"rating": float(rng.integers(1, 6))},
                    "eventTime": event_time(k), "eventId": f"e{k:06d}",
                })
                k += 1
    return out


def test_recommendation_read_eval_folds_equal_the_jax_packages(memory_storage, tmp_path):
    """The same events in both stores: identical folds (training ratings,
    vocabularies, one query per held-out user, the held-out ratings)."""
    import numpy as np

    from predictionio_tpu.models.recommendation import engine as jax_rec
    from predictionio_tpu_torch.models.recommendation import engine as pt_rec
    from tests.torch_template_helpers import jax_store, port_store, write_events

    events = write_events(tmp_path / "ev.jsonl", _rating_events(25, 15, seed=3))
    ep = {"k_fold": 3, "query_num": 7}
    jfolds = jax_rec.DataSource(jax_rec.DataSourceParams(
        app_name="recapp", eval_params=jax_rec.EvalParams(**ep))).read_eval(
        jax_store(memory_storage, "recapp", events))
    folds = pt_rec.DataSource(pt_rec.DataSourceParams(
        app_name="recapp", eval_params=pt_rec.EvalParams(**ep))).read_eval(
        port_store(tmp_path, "recapp", events))
    assert len(folds) == len(jfolds) == 3
    for (td, ei, qa), (jtd, jei, jqa) in zip(folds, jfolds):
        for f in ("user_idx", "item_idx", "ratings"):
            np.testing.assert_array_equal(getattr(td, f), getattr(jtd, f))
        assert td.user_vocab == jtd.user_vocab and td.item_vocab == jtd.item_vocab
        assert [(q.user, q.num, [(r.user, r.item, r.rating) for r in a.ratings]) for q, a in qa] == [
            (q.user, q.num, [(r.user, r.item, r.rating) for r in a.ratings]) for q, a in jqa]
    with pytest.raises(ValueError, match="evalParams"):
        pt_rec.DataSource(pt_rec.DataSourceParams(app_name="recapp")).read_eval(
            port_store(tmp_path / "b", "recapp", events))


class _Accuracy:
    """Accuracy of a classification prediction, for either package."""

    @staticmethod
    def make(metric_mod):
        return type("Accuracy", (metric_mod.AverageMetric,), {
            "calculate_score": lambda self, ei, q, p, a: float(p.label == a.label)})()


def test_naive_bayes_engine_eval_equals_the_jax_packages(memory_storage, tmp_path):
    """Naive Bayes is deterministic: ``Engine.eval`` gives the same
    (query, prediction, actual) triples and the same accuracy."""
    from predictionio_tpu.eval import metric as jax_metric
    from predictionio_tpu.models.classification import engine as jax_cl
    from predictionio_tpu_torch.eval import metric as pt_metric
    from predictionio_tpu_torch.models.classification import engine as pt_cl
    from tests.test_torch_classification import _events
    from tests.torch_template_helpers import jax_store, port_store, write_events

    events = write_events(tmp_path / "cls.jsonl", _events(n=90, seed=4))
    variant = {"datasource": {"params": {"appName": "clsapp", "evalK": 3}},
               "algorithms": [{"name": "naive", "params": {"lambda": 0.5}}]}
    jeng, peng = jax_cl.engine_factory(), pt_cl.engine_factory()
    jout = jeng.eval(jax_store(memory_storage, "clsapp", events),
                     jeng.engine_params_from_variant(variant))
    pctx = port_store(tmp_path, "clsapp", events, mode="evaluation")
    pout = peng.eval(pctx, peng.engine_params_from_variant(variant))
    assert len(pout) == len(jout) == 3
    for (_, triples), (_, jtriples) in zip(pout, jout):
        assert [(q.to_array().tolist(), p.label, a.label) for q, p, a in triples] == [
            (q.to_array().tolist(), p.label, a.label) for q, p, a in jtriples]
    assert _Accuracy.make(pt_metric).calculate(pout) == _Accuracy.make(jax_metric).calculate(jout)


def test_recommendation_precision_at_10_matches_the_jax_package(memory_storage, tmp_path,
                                                                 monkeypatch):
    """200 users × 100 items, 2 folds, rank 8: with the JAX package's
    initial factors in both, precision@10 through ``Engine.eval`` is the
    same to 1e-12 (the f32 solves differ at rounding only, and no top-10
    boundary falls inside that rounding on this seed)."""
    from predictionio_tpu.models.recommendation import engine as jax_rec
    from predictionio_tpu.tuning.metrics import PrecisionAtK as JaxPrecision
    from predictionio_tpu_torch.models.recommendation import engine as pt_rec
    from predictionio_tpu_torch.tuning.metrics import PrecisionAtK
    from tests.torch_template_helpers import jax_store, port_store, shared_init, write_events

    shared_init(monkeypatch)
    events = write_events(tmp_path / "ev.jsonl", _rating_events(200, 100, seed=5, density=0.1))
    variant = {"datasource": {"params": {"appName": "recapp",
                                         "evalParams": {"kFold": 2, "queryNum": 10}}},
               "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 5,
                                                         "lambda": 0.1, "seed": 3}}]}
    jeng, peng = jax_rec.engine_factory(), pt_rec.engine_factory()
    jscore = JaxPrecision(10).calculate(jeng.eval(
        jax_store(memory_storage, "recapp", events), jeng.engine_params_from_variant(variant)))
    pscore = PrecisionAtK(10).calculate(peng.eval(
        port_store(tmp_path, "recapp", events, mode="evaluation"),
        peng.engine_params_from_variant(variant)))
    assert 0.0 < jscore < 1.0
    assert abs(pscore - jscore) <= 1e-12, (pscore, jscore)
