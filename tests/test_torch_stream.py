"""The port's speed layer on the CPU (``predictionio_tpu_torch/stream/``),
held to the JAX package's on the same inputs: cursors, the tailer, the
four incremental trainers (the ALS fold-in through B1's plain version on
``device="cpu"``, naive Bayes, cooccurrence, sequential), the pipeline
(lineage, ``publish_min_events``, drift suppression, crash/restart with
no skip and no double publish, span dedup, the breaker pause, the metrics
endpoint) and the CLI (``stream --cycles 1``, ``train --follow``).

Tolerances: the fold-in's factors are held to the JAX trainer's at
row-relative 1e-4 at ranks 4 and 8, and every solved row to a float64
``np.linalg.solve`` of its normal equations at rtol 1e-3 / atol 1e-4 (the
reference's own test tolerance, ``tests/test_stream.py``). At rank 16 the
two packages' f32 CGs (f + 4 steps, their sums in another order) differ
by up to a few 1e-4 on the same systems, and either can be 2e-3 of a row
from float64 there: that is the algorithm's f32 accuracy, not a port
difference, and no test here holds rank 16.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.memory import MemoryStorageClient
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.registry import ArtifactStore, ModelManifest
from predictionio_tpu_torch.resilience import CircuitBreaker, CircuitOpenError, ResiliencePolicy, RetryPolicy
from predictionio_tpu_torch.stream import (
    CursorStore,
    EventTailer,
    FoldInALSTrainer,
    SequentialStreamTrainer,
    StreamConfig,
    StreamInstruments,
    StreamPipeline,
    StreamingCooccurrenceTrainer,
    StreamingNaiveBayesTrainer,
    serve_metrics,
    span_id_of,
    trainer_for_models,
)
from predictionio_tpu_torch.stream.trainers import DriftReport
from predictionio_tpu_torch.workflow import model_io

UTC = dt.timezone.utc
APP = 1


def t(n: int) -> dt.datetime:
    return dt.datetime(2024, 3, 1, tzinfo=UTC) + dt.timedelta(microseconds=n)


def rate_event(user: str, item: str, rating: float, n: int, event_cls=Event, datamap=dict):
    return event_cls(
        event="rate",
        entity_type="user",
        entity_id=user,
        target_entity_type="item",
        target_entity_id=item,
        properties=datamap({"rating": rating}),
        event_time=t(n),
        creation_time=t(n),
    )


def jax_rate_event(user, item, rating, n):
    from predictionio_tpu.data.datamap import DataMap as JDataMap
    from predictionio_tpu.data.event import Event as JEvent

    return rate_event(user, item, rating, n, JEvent, JDataMap)


def _levents():
    return MemoryStorageClient().l_events()


class Flaky:
    """A DAO whose ``find_after`` fails ``fail_count`` times with a
    transient ConnectionError (the JAX package's FaultInjector role)."""

    def __init__(self, target):
        self._target = target
        self.fail_count = 0
        self.faults = 0

    def __getattr__(self, name):
        return getattr(self._target, name)

    def find_after(self, *args, **kwargs):
        if self.fail_count > 0:
            self.fail_count -= 1
            self.faults += 1
            raise ConnectionError("injected fault")
        return self._target.find_after(*args, **kwargs)


class RecordingTrainer:
    name = "recording"

    def __init__(self):
        self.ids: list[str] = []
        self.ok = True

    def absorb(self, events):
        self.ids.extend(e.event_id for e in events)
        return len(events)

    def snapshot(self):
        return [{"absorbed": len(self.ids)}]

    def drift(self):
        return DriftReport(self.ok, "test", reason="" if self.ok else "forced breach")


# ---------------------------------------------------------------------------
# cursors and tailer
# ---------------------------------------------------------------------------


class TestCursorStore:
    def test_roundtrip_resume_and_the_jax_package_reads_the_file(self, tmp_path):
        from predictionio_tpu.stream.cursor import CursorStore as JCursorStore

        cursors = CursorStore(str(tmp_path))
        c = cursors.load(APP)
        assert c.pos() is None and c.events_read == 0
        c.advance((1000, "ev1"), 10)
        c.record_publish("v000002", "start..1000:ev1", (1000, "ev1"))
        cursors.save(c)
        for again in (CursorStore(str(tmp_path)).load(APP), JCursorStore(str(tmp_path)).load(APP)):
            assert again.pos() == (1000, "ev1")
            assert again.published_pos() == (1000, "ev1")
            assert again.events_read == 10 and again.last_published_version == "v000002"
        assert cursors.path(APP, 7) == JCursorStore(str(tmp_path)).path(APP, 7)

    def test_unreadable_cursor_starts_fresh_and_no_tmp_litter(self, tmp_path):
        cursors = CursorStore(str(tmp_path))
        with open(cursors.path(APP), "w") as fh:
            fh.write("{half a json")
        c = cursors.load(APP)
        assert c.pos() is None
        for i in range(5):
            c.advance((i, f"e{i}"), 1)
            cursors.save(c)
        assert [f for f in os.listdir(tmp_path) if f.startswith(".tmp")] == []

    @pytest.mark.parametrize("frm,to", [(None, (5, "x")), ((1, "a"), (5, "x")), ((0, ""), (9, "z9"))])
    def test_span_id_equals_the_reference(self, frm, to):
        from predictionio_tpu.stream.cursor import span_id_of as jspan

        assert span_id_of(frm, to) == jspan(frm, to)


class TestEventTailer:
    def _seed(self, levents, n):
        for i in range(n):
            levents.insert(rate_event(f"u{i % 4}", f"i{i % 3}", 3.0, i), APP)

    def test_bounded_drains_walk_the_store(self):
        levents = _levents()
        levents.init(APP)
        self._seed(levents, 25)
        tailer = EventTailer(levents, APP, batch_limit=10)
        seen, sizes, pos = [], [], None
        while True:
            res = tailer.drain(pos)
            if not res.events:
                assert res.more is False
                break
            sizes.append(len(res.events))
            seen.extend(e.event_id for e in res.events)
            pos = res.position
        assert sizes == [10, 10, 5]
        assert len(seen) == len(set(seen)) == 25

    def test_retry_then_succeed_on_transient_fault(self):
        levents = _levents()
        levents.init(APP)
        self._seed(levents, 3)
        flaky = Flaky(levents)
        flaky.fail_count = 1
        res = EventTailer(flaky, APP, batch_limit=10).drain(None)
        assert len(res.events) == 3 and flaky.faults == 1

    def test_breaker_opens_after_persistent_failure(self):
        levents = _levents()
        levents.init(APP)
        broken = Flaky(levents)
        broken.fail_count = 10_000
        policy = ResiliencePolicy(
            retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0),
            breaker=CircuitBreaker(name="t", failure_threshold=3),
        )
        tailer = EventTailer(broken, APP, batch_limit=10, policy=policy)
        with pytest.raises(ConnectionError):
            tailer.drain(None)
        with pytest.raises((ConnectionError, CircuitOpenError)):
            tailer.drain(None)
        with pytest.raises(CircuitOpenError):
            tailer.drain(None)

    def test_safety_lag_holds_back_fresh_events(self):
        levents = _levents()
        levents.init(APP)
        now = dt.datetime.now(tz=UTC)
        levents.insert(dataclasses.replace(rate_event("u1", "i0", 3.0, 1), creation_time=now - dt.timedelta(seconds=60)), APP)
        levents.insert(dataclasses.replace(rate_event("u2", "i0", 3.0, 2), creation_time=now), APP)
        res = EventTailer(levents, APP, batch_limit=10, safety_lag_s=5.0).drain(None)
        assert [e.entity_id for e in res.events] == ["u1"] and res.more is False
        res2 = EventTailer(levents, APP, batch_limit=10).drain(res.position)
        assert [e.entity_id for e in res2.events] == ["u2"]

    def test_lag_and_head_position(self):
        levents = _levents()
        levents.init(APP)
        self._seed(levents, 12)
        tailer = EventTailer(levents, APP, batch_limit=5)
        n, secs = tailer.lag(None)
        assert n == 12 and secs > 0
        head = tailer.head_position()
        assert tailer.lag(head) == (0, 0.0)
        assert tailer.drain(head).events == []


# ---------------------------------------------------------------------------
# fold-in ALS against the JAX trainer
# ---------------------------------------------------------------------------


def _seed_tables(rank=4, n_users=40, n_items=30, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    uf = (rng.normal(size=(n_users, rank)) * scale).astype(np.float32)
    vf = (rng.normal(size=(n_items, rank)) * scale).astype(np.float32)
    return uf, vf, [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)]


def _rating_stream(uf, vf, n_events, seed):
    """Ratings around the seed model's own scores, with new users and items."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for n in range(n_events):
        u = int(rng.integers(0, len(uf) + 8))
        i = int(rng.integers(0, len(vf) + 4))
        base = float(uf[u] @ vf[i]) if u < len(uf) and i < len(vf) else 0.0
        out.append((f"u{u}", f"i{i}", float(np.clip(np.round(3 + base + rng.normal() * 0.5), 1, 5)), n))
    return out


def _pair(uf, vf, uv, iv, **kw):
    from predictionio_tpu.models.recommendation.engine import ALSModel as JALSModel
    from predictionio_tpu.stream.trainers import FoldInALSTrainer as JFoldIn

    from predictionio_tpu_torch.models.recommendation.engine import ALSModel

    jax_trainer = JFoldIn([JALSModel(uf.copy(), vf.copy(), list(uv), list(iv))], **kw)
    port = FoldInALSTrainer([ALSModel(uf.copy(), vf.copy(), list(uv), list(iv))], device="cpu", **kw)
    return jax_trainer, port


def _row_rel(a, b):
    return np.linalg.norm(a - b, axis=1) / np.maximum(np.linalg.norm(a, axis=1), 1e-12)


def _hold_to_float64(trainer, checked):
    """A solve hook: each solved row against a float64 solve of its normal
    equations, rebuilt from the trainer's buffer and the fixed table as it
    stands during the solve (rtol 1e-3 / atol 1e-4)."""

    def hook(side, order, A, b, x):
        buffers = trainer._user_ratings if side == "user" else trainer._item_ratings
        fixed = trainer.item_factors if side == "user" else trainer.user_factors
        f = fixed.shape[1]
        for k, idx in enumerate(order):
            pairs = buffers[idx]
            V = fixed[np.asarray([p[0] for p in pairs])].astype(np.float64)
            r = np.asarray([p[1] for p in pairs], np.float64)
            A64 = V.T @ V + trainer.reg * max(1.0, len(pairs)) * np.eye(f)
            np.testing.assert_allclose(x[k].numpy(), np.linalg.solve(A64, V.T @ r), rtol=1e-3, atol=1e-4)
            checked[side] += 1

    return hook


class TestFoldInALS:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("scale", [0.5, 1.0])
    def test_one_absorb_equals_the_jax_trainer(self, seed, scale):
        uf, vf, uv, iv = _seed_tables(seed=seed, scale=scale)
        jax_trainer, port = _pair(uf, vf, uv, iv)
        sides = []
        port.solve_hook = lambda side, order, A, b, x: sides.append(side)
        stream = _rating_stream(uf, vf, 300, seed)
        assert jax_trainer.absorb([jax_rate_event(*e) for e in stream]) == port.absorb(
            [rate_event(*e) for e in stream]
        )
        assert port.user_vocab == jax_trainer.user_vocab and port.item_vocab == jax_trainer.item_vocab
        assert _row_rel(jax_trainer.user_factors, port.user_factors).max() < 1e-4
        assert _row_rel(jax_trainer.item_factors, port.item_factors).max() < 1e-4
        assert set(port.last_absorb_stats) >= {"rows", "entities", "build_s", "upload_s", "b1_s", "fetch_s"}
        assert sides == ["user", "item"]  # one solve per side

    @pytest.mark.parametrize("rank", [4, 8])
    def test_every_absorb_from_the_same_state_equals_the_jax_trainer(self, rank):
        """Six micro-batches; before each, the port takes the JAX trainer's
        tables, so each absorb starts from the same state, and every solved
        row is held to a float64 solve of its own normal equations."""
        uf, vf, uv, iv = _seed_tables(rank=rank, seed=3)
        jax_trainer, port = _pair(uf, vf, uv, iv, max_ratings_per_entity=16)
        checked = {"user": 0, "item": 0}
        port.solve_hook = _hold_to_float64(port, checked)
        stream = _rating_stream(uf, vf, 600, 3)
        for s in range(0, 600, 100):
            port.user_factors = jax_trainer.user_factors.copy()
            port.item_factors = jax_trainer.item_factors.copy()
            jax_trainer.absorb([jax_rate_event(*e) for e in stream[s:s + 100]])
            port.absorb([rate_event(*e) for e in stream[s:s + 100]])
            assert _row_rel(jax_trainer.user_factors, port.user_factors).max() < 1e-4
            assert _row_rel(jax_trainer.item_factors, port.item_factors).max() < 1e-4
        assert checked["user"] > 100 and checked["item"] > 100

    def test_foldin_matches_exact_normal_equation_solve(self):
        """The reference's own check (tests/test_stream.py), both packages."""
        uf, vf, uv, iv = _seed_tables(n_users=3, n_items=4)
        jax_trainer, port = _pair(uf, vf, uv, iv, reg=0.1, holdout_every=1_000_000)
        jax_trainer.absorb([jax_rate_event("u0", "i0", 4.0, 0), jax_rate_event("u0", "i2", 2.0, 1)])
        port.absorb([rate_event("u0", "i0", 4.0, 0), rate_event("u0", "i2", 2.0, 1)])
        V = vf[[0, 2]]
        A = V.T @ V + 0.1 * 2 * np.eye(4, dtype=np.float32)
        expected = np.linalg.solve(A.astype(np.float64), V.T.astype(np.float64) @ np.asarray([4.0, 2.0]))
        for trainer in (jax_trainer, port):
            np.testing.assert_allclose(trainer.user_factors[0], expected, rtol=1e-3, atol=1e-4)

    def test_new_user_folds_in_and_aligns_with_rated_item(self):
        uf, vf, uv, iv = _seed_tables(n_users=3, n_items=4)
        vf[1] = -vf[0]
        _, port = _pair(uf, vf, uv, iv, holdout_every=1_000_000)
        assert port.absorb([rate_event("newu", "i0", 5.0, n) for n in range(6)]) == 6
        u = port.user_factors[port.user_vocab.index("newu")]
        assert np.all(np.isfinite(u)) and np.linalg.norm(u) > 0
        assert float(u @ port.item_factors[0]) > 0 > float(u @ port.item_factors[1])

    def test_no_system_is_empty_and_an_empty_one_solves_as_the_reference(self):
        """An entity is folded only once a rating is in its buffer, so every
        system has a positive diagonal. An all-zero system would come back
        as NaN from both packages' plain CG (1/0 on the Jacobi diagonal),
        not as zeros."""
        import torch

        from predictionio_tpu.ops.spd_solve import batched_spd_solve_auto as jax_solve

        from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_auto

        uf, vf, uv, iv = _seed_tables(seed=6)
        _, port = _pair(uf, vf, uv, iv, max_ratings_per_entity=8)
        diagonals = []
        port.solve_hook = lambda side, order, A, b, x: diagonals.append(torch.diagonal(A, dim1=1, dim2=2))
        port.absorb([rate_event(*e) for e in _rating_stream(uf, vf, 200, 6)])
        assert len(diagonals) == 2 and all(bool((d > 0).all()) for d in diagonals)
        ours = batched_spd_solve_auto(torch.zeros(3, 4, 4), torch.zeros(3, 4)).numpy()
        theirs = np.asarray(jax_solve(np.zeros((3, 4, 4), np.float32), np.zeros((3, 4), np.float32)))
        assert np.isnan(ours).all() and np.isnan(theirs).all()

    def test_snapshot_copies_and_never_aliases_the_tables(self):
        uf, vf, uv, iv = _seed_tables(n_users=3, n_items=4)
        _, port = _pair(uf, vf, uv, iv, holdout_every=1_000_000)
        port.absorb([rate_event("newu", "i0", 5.0, 0)])
        (snap,) = port.snapshot()
        assert "newu" in snap.user_vocab and snap.user_factors.shape[0] == 4
        frozen = snap.user_factors.copy(), snap.item_factors.copy()
        blob = model_io.serialize_models([snap])
        port.absorb([rate_event("newu", "i1", 1.0, 1), rate_event("u0", "i3", 5.0, 2)])
        assert not np.shares_memory(snap.user_factors, port.user_factors)
        np.testing.assert_array_equal(snap.user_factors, frozen[0])
        np.testing.assert_array_equal(snap.item_factors, frozen[1])
        (back,) = model_io.deserialize_models(blob)
        np.testing.assert_array_equal(back.user_factors, frozen[0])

    def test_drift_guard_catches_corrupt_ratings_as_the_reference(self):
        uf, vf, uv, iv = _seed_tables(n_users=3, n_items=4)
        jax_trainer, port = _pair(uf, vf, uv, iv, holdout_every=1_000_000)
        for trainer, mk in ((jax_trainer, jax_rate_event), (port, rate_event)):
            trainer.absorb([mk("u0", "i0", 4.0, 0)])
            assert trainer.drift().ok
            trainer.absorb([mk("u1", "i1", 1e9, n) for n in range(3)])
        # rank-1 item systems at 1e18 are singular in f32: each package's CG
        # lands on its own garbage (huge or non-finite factors), and both
        # guards breach on factor health
        j, p = jax_trainer.drift(), port.drift()
        assert (p.ok, p.metric) == (j.ok, j.metric) == (False, "factor-health")

    def test_holdout_and_degree_buffers_as_the_reference(self):
        uf, vf, uv, iv = _seed_tables(n_users=3, n_items=4)
        _, port = _pair(uf, vf, uv, iv, holdout_every=2, max_ratings_per_entity=8)
        assert port.absorb([rate_event("u0", "i0", 3.0, n) for n in range(20)]) == 10
        assert len(port.holdout.held) == 10
        assert len(port._user_ratings[0]) == 8  # newest kept

    def test_drift_rmse_equals_the_jax_trainer(self):
        uf, vf, uv, iv = _seed_tables(seed=5)
        jax_trainer, port = _pair(uf, vf, uv, iv, holdout_every=3)
        stream = _rating_stream(uf, vf, 400, 5)
        jax_trainer.absorb([jax_rate_event(*e) for e in stream])
        port.absorb([rate_event(*e) for e in stream])
        j, p = jax_trainer.drift(), port.drift()
        assert (p.ok, p.metric) == (j.ok, j.metric) == (True, "rmse")
        assert p.baseline == pytest.approx(j.baseline, rel=1e-6)
        assert p.current == pytest.approx(j.current, rel=1e-4)


# ---------------------------------------------------------------------------
# the host trainers against the JAX package's
# ---------------------------------------------------------------------------


def _nb_event(label, features, n, jax=False):
    if jax:
        from predictionio_tpu.data.datamap import DataMap as DM
        from predictionio_tpu.data.event import Event as E
    else:
        DM, E = dict, Event
    return E(event="example", entity_type="sample", entity_id=f"s{n}",
             properties=DM({"label": label, "features": list(features)}),
             event_time=t(n), creation_time=t(n))


def _nb_stream(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in range(120):
        label = "ab"[int(rng.integers(0, 2))]
        feats = tuple(f"{label if rng.random() < 0.7 else 'z'}{int(rng.integers(0, 3))}" for _ in range(3))
        out.append((label, feats, n))
    return out


class TestHostTrainersEqualTheReference:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_naive_bayes(self, seed):
        from predictionio_tpu.stream.trainers import StreamingNaiveBayesTrainer as JNB

        events = _nb_stream(seed)
        j, p = JNB(holdout_every=5, drift_min_samples=4), StreamingNaiveBayesTrainer(holdout_every=5, drift_min_samples=4)
        for s in range(0, 120, 40):
            assert j.absorb([_nb_event(*e, jax=True) for e in events[s:s + 40]]) == p.absorb(
                [_nb_event(*e) for e in events[s:s + 40]]
            )
        (jm,), (pm,) = j.snapshot(), p.snapshot()
        assert pm.priors == jm.priors and pm.likelihoods == jm.likelihoods
        assert p.drift().to_json_dict() == j.drift().to_json_dict()

    def test_naive_bayes_seeded_from_a_jax_model_blob(self):
        from predictionio_tpu.e2.naive_bayes import LabeledPoint, train_categorical_naive_bayes
        from predictionio_tpu.workflow import model_io as jax_model_io

        stable = train_categorical_naive_bayes([LabeledPoint("a", ("x",))] * 5 + [LabeledPoint("b", ("y",))] * 5)
        (seed,) = model_io.deserialize_models(jax_model_io.serialize_models([stable]))
        trainer = trainer_for_models([seed], device="cpu", holdout_every=2, drift_min_samples=4)
        assert isinstance(trainer, StreamingNaiveBayesTrainer)
        trainer.absorb([_nb_event("a", ("x",), n) for n in range(3)])
        assert not trainer.drift().ok  # a from-scratch model without evidence
        trainer.absorb([_nb_event("a", ("x",), 10 + n) for n in range(10)]
                       + [_nb_event("b", ("y",), 30 + n) for n in range(10)])
        assert trainer.drift().ok

    def test_cooccurrence_seeded_from_a_similarproduct_model(self):
        from predictionio_tpu.models.similarproduct.engine import CooccurrenceModel as JCM
        from predictionio_tpu.stream.trainers import StreamingCooccurrenceTrainer as JCO

        from predictionio_tpu_torch.models.similarproduct.engine import CooccurrenceModel

        kw = dict(top_map={0: [(1, 3)], 1: [(0, 3)]}, item_vocab=["a", "b"], item_categories=[None, None])
        rng = np.random.default_rng(4)
        stream = [(f"u{int(rng.integers(0, 6))}", "abcdefg"[int(rng.integers(0, 7))], 1.0, n) for n in range(80)]
        j = JCO(JCM(**kw), top_n=3, holdout_every=6)
        p = trainer_for_models([CooccurrenceModel(**kw)], device="cpu", top_n=3, holdout_every=6)
        assert isinstance(p, StreamingCooccurrenceTrainer)
        assert j.absorb([jax_rate_event(*e) for e in stream]) == p.absorb([rate_event(*e) for e in stream])
        assert p.top_map() == j.top_map()
        (js,), (ps,) = j.snapshot(), p.snapshot()
        assert isinstance(ps, CooccurrenceModel)
        assert (ps.top_map, ps.item_vocab, ps.item_categories) == (js.top_map, js.item_vocab, js.item_categories)
        assert p.drift().to_json_dict() == j.drift().to_json_dict()

    def test_sequential(self):
        from predictionio_tpu.models.sequential.engine import SequentialModel as JSM
        from predictionio_tpu.models.sequential.engine import markov_from_counts as jmfc
        from predictionio_tpu.stream.trainers import SequentialStreamTrainer as JST

        from predictionio_tpu_torch.models.sequential.engine import SequentialModel, markov_from_counts

        counts = {(0, 1): 3.0, (1, 2): 2.0, (2, 0): 1.0}
        vocab = ["a", "b", "c"]
        j = JST(JSM(item_vocab=vocab, markov=jmfc(counts, 3, 2), pair_counts=dict(counts), user_last={"u0": 1}, top_n=2),
                holdout_every=5)
        p = trainer_for_models(
            [SequentialModel(item_vocab=vocab, markov=markov_from_counts(counts, 3, 2), pair_counts=dict(counts),
                             user_last={"u0": 1}, top_n=2)], device="cpu", holdout_every=5)
        assert isinstance(p, SequentialStreamTrainer)
        rng = np.random.default_rng(7)
        stream = [(f"u{int(rng.integers(0, 5))}", "abcde"[int(rng.integers(0, 5))], 1.0, n) for n in range(90)]
        assert j.absorb([jax_rate_event(*e) for e in stream]) == p.absorb([rate_event(*e) for e in stream])
        assert p.top_map() == j.top_map()
        (js,), (ps,) = j.snapshot(), p.snapshot()
        assert ps.item_vocab == js.item_vocab and ps.pair_counts == js.pair_counts
        assert ps.user_last == js.user_last and ps.markov.transitions == js.markov.transitions
        assert p.drift().to_json_dict() == j.drift().to_json_dict()

    def test_trainer_for_models_selects_by_type(self):
        from predictionio_tpu_torch.models.recommendation.engine import ALSModel

        uf, vf, uv, iv = _seed_tables(n_users=3, n_items=4)
        assert isinstance(trainer_for_models([ALSModel(uf, vf, uv, iv)], device="cpu"), FoldInALSTrainer)
        with pytest.raises(ValueError):
            trainer_for_models([{"opaque": 1}], device="cpu")


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def _pipeline(tmp_path, levents, trainer, *, registry=None, stable_blob=True, engine_id="streameng", **cfg_kw):
    store = ArtifactStore(str(tmp_path / "registry"))
    if stable_blob:
        store.publish(
            ModelManifest(version="", engine_id=engine_id, engine_version="1", engine_variant="engine.json"),
            model_io.serialize_models([{"seed": True}]),
        )
    batch_limit = cfg_kw.pop("batch_limit", 5)
    cfg_kw.setdefault("publish_min_events", 1)
    instruments = StreamInstruments(registry or MetricsRegistry())
    pipeline = StreamPipeline(
        EventTailer(levents, APP, batch_limit=batch_limit),
        trainer,
        CursorStore(str(tmp_path / "cursors")),
        store,
        StreamConfig(engine_id=engine_id, **cfg_kw),
        instruments=instruments,
    )
    return pipeline, store, instruments


def _filled(n, start=0):
    levents = _levents()
    levents.init(APP)
    for i in range(start, start + n):
        levents.insert(rate_event(f"u{i}", "i0", 3.0, i), APP)
    return levents


class TestStreamPipeline:
    def test_publish_candidate_with_lineage_and_span(self, tmp_path):
        pipeline, store, ins = _pipeline(tmp_path, _filled(7), RecordingTrainer())
        summary = pipeline.run_once()
        assert summary["drained"] == 7 and summary["published"] == "v000002"
        versions = store.list_versions("streameng")
        assert [m.version for m in versions] == ["v000001", "v000002"]
        m = versions[-1]
        assert m.parent_version == "v000001"
        span = m.data_span["stream"]
        assert span["events"] == 7 and span["trainer"] == "recording"
        assert span["spanId"].startswith("start..")
        assert span["profile"] == m.train_profile and "sweep" in m.train_profile["phases"]
        state = store.get_state("streameng")
        assert (state.stable, state.candidate) == ("v000001", "v000002")
        assert ins.publishes.value() == 1 and ins.events.value() == 7
        assert model_io.deserialize_models(store.load_blob("streameng", "v000002")) == [{"absorbed": 7}]
        (timing,) = pipeline.publish_seconds
        assert set(timing) == {"snapshot_s", "serialize_s", "sha256_s", "write_s", "bytes"}

    def test_the_jax_package_reads_the_published_candidate(self, tmp_path):
        from predictionio_tpu.registry import ArtifactStore as JStore
        from predictionio_tpu.workflow import model_io as jax_model_io

        pipeline, _, _ = _pipeline(tmp_path, _filled(4), RecordingTrainer())
        assert pipeline.run_once()["published"] == "v000002"
        jstore = JStore(str(tmp_path / "registry"))
        assert jstore.get_state("streameng").candidate == "v000002"
        assert jax_model_io.deserialize_models(jstore.load_blob("streameng", "v000002")) == [{"absorbed": 4}]

    def test_publish_min_events_batches_up(self, tmp_path):
        levents = _filled(3)
        pipeline, store, _ = _pipeline(tmp_path, levents, RecordingTrainer(), publish_min_events=5)
        assert pipeline.run_once()["published"] is None
        for i in range(3):
            levents.insert(rate_event(f"w{i}", "i0", 3.0, 10 + i), APP)
        assert pipeline.run_once()["published"] == "v000002"
        assert store.list_versions("streameng")[-1].data_span["stream"]["events"] == 6

    def test_drift_breach_suppresses_publish(self, tmp_path):
        trainer = RecordingTrainer()
        trainer.ok = False
        pipeline, store, ins = _pipeline(tmp_path, _filled(4), trainer)
        summary = pipeline.run_once()
        assert summary["published"] is None and summary["driftSuppressed"] is True
        assert ins.drift_suppressed.value() == 1
        assert [m.version for m in store.list_versions("streameng")] == ["v000001"]
        assert store.get_state("streameng").candidate == ""
        assert pipeline.cursor.events_read == 4
        trainer.ok = True
        assert pipeline.run_once()["published"] == "v000002"

    def test_crash_restart_resumes_without_skips_or_double_publish(self, tmp_path):
        levents = _levents()
        levents.init(APP)
        all_ids = [levents.insert(rate_event(f"u{i % 4}", f"i{i % 2}", 3.0, i), APP) for i in range(12)]
        flaky = Flaky(levents)
        trainer1 = RecordingTrainer()
        pipeline, _, _ = _pipeline(tmp_path, flaky, trainer1, publish_min_events=999, batch_limit=5)
        pipeline.config.max_batches_per_cycle = 1
        pipeline.run_once()
        flaky.fail_count = 10_000
        with pytest.raises(ConnectionError):
            pipeline.run_once()
        assert len(trainer1.ids) == 5
        trainer2 = RecordingTrainer()
        pipeline2, store2, _ = _pipeline(tmp_path, levents, trainer2, stable_blob=False, batch_limit=5)
        summary = pipeline2.run_once()
        assert sorted(set(trainer2.ids)) == sorted(all_ids)
        assert summary["published"] == "v000002"
        versions = store2.list_versions("streameng")
        assert [m.version for m in versions] == ["v000001", "v000002"]
        assert versions[-1].data_span["stream"]["events"] == 12

    def test_replayed_span_is_not_published_twice(self, tmp_path):
        levents = _filled(6)
        pipeline, _, _ = _pipeline(tmp_path, levents, RecordingTrainer())
        assert pipeline.run_once()["published"] == "v000002"
        cursors = CursorStore(str(tmp_path / "cursors"))
        fresh = cursors.load(APP)
        fresh.position = fresh.published_position = None
        fresh.last_published_version = fresh.last_published_span = ""
        cursors.save(fresh)
        trainer2 = RecordingTrainer()
        pipeline2, store2, _ = _pipeline(tmp_path, levents, trainer2, stable_blob=False)
        summary = pipeline2.run_once()
        assert len(trainer2.ids) == 6
        assert summary["published"] == "v000002"
        assert [m.version for m in store2.list_versions("streameng")] == ["v000001", "v000002"]
        assert pipeline2.cursor.last_published_version == "v000002"

    def test_run_forever_pauses_on_open_breaker(self, tmp_path):
        broken = Flaky(_filled(0))
        broken.fail_count = 10_000
        pipeline, _, ins = _pipeline(tmp_path, broken, RecordingTrainer())
        pipeline.tailer.policy = ResiliencePolicy(
            retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0),
            breaker=CircuitBreaker(name="t", failure_threshold=1),
        )
        sleeps = []
        pipeline.run_forever(max_cycles=3, sleep=sleeps.append)
        assert ins.errors.value(stage="cycle") + ins.errors.value(stage="drain") == 3
        assert pipeline.config.breaker_pause_s in sleeps

    def test_metrics_endpoint_serves_the_stream_family(self, tmp_path):
        registry = MetricsRegistry()
        pipeline, _, _ = _pipeline(tmp_path, _filled(4), RecordingTrainer(), registry=registry)
        pipeline.run_once()
        server = serve_metrics(registry, 0, host="127.0.0.1")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/metrics", timeout=5) as resp:
                text = resp.read().decode()
        finally:
            server.shutdown()
        # integral samples render as the JAX package's exposition does
        assert "\npio_stream_events_total 4\n" in text
        assert "\npio_stream_publishes_total 1\n" in text
        assert "\npio_stream_lag_events 0\n" in text

    def test_foldin_pipeline_equals_the_jax_pipeline(self, tmp_path):
        """The same ALS stable and the same events through both packages'
        pipelines: the same versions, spans and factors (rank 4)."""
        from predictionio_tpu.data.storage.memory import MemoryStorageClient as JMem
        from predictionio_tpu.models.recommendation.engine import ALSModel as JALSModel
        from predictionio_tpu.registry import ArtifactStore as JStore
        from predictionio_tpu.registry import ModelManifest as JManifest
        from predictionio_tpu.stream import CursorStore as JCursors
        from predictionio_tpu.stream import EventTailer as JTailer
        from predictionio_tpu.stream import StreamConfig as JConfig
        from predictionio_tpu.stream import StreamPipeline as JPipeline
        from predictionio_tpu.stream import trainer_for_models as jtrainer_for
        from predictionio_tpu.workflow import model_io as jax_model_io

        uf, vf, uv, iv = _seed_tables(seed=8)
        stream = _rating_stream(uf, vf, 60, 8)
        jl, pl = JMem().l_events(), _levents()
        jl.init(APP)
        pl.init(APP)
        for e in stream:
            jl.insert(dataclasses.replace(jax_rate_event(*e), event_id=f"e{e[3]:05d}"), APP)
            pl.insert(dataclasses.replace(rate_event(*e), event_id=f"e{e[3]:05d}"), APP)
        jstore = JStore(str(tmp_path / "jreg"))
        jstore.publish(JManifest(version="", engine_id="e", engine_version="1", engine_variant="v"),
                       jax_model_io.serialize_models([JALSModel(uf, vf, uv, iv)]))
        (seed,) = model_io.deserialize_models(jstore.load_blob("e", "v000001"))
        pstore = ArtifactStore(str(tmp_path / "preg"))
        pstore.publish(ModelManifest(version="", engine_id="e", engine_version="1", engine_variant="v"),
                       model_io.serialize_models([seed]))
        jp = JPipeline(JTailer(jl, APP, batch_limit=20), jtrainer_for([JALSModel(uf, vf, uv, iv)]),
                       JCursors(str(tmp_path / "jc")), jstore, JConfig(engine_id="e", publish_min_events=30))
        pp = StreamPipeline(EventTailer(pl, APP, batch_limit=20), trainer_for_models([seed], device="cpu"),
                            CursorStore(str(tmp_path / "pc")), pstore, StreamConfig(engine_id="e", publish_min_events=30))
        js, ps = jp.run_once(), pp.run_once()
        assert ps["published"] == js["published"] == "v000002"
        jm, pm = jstore.get_manifest("e", "v000002"), pstore.get_manifest("e", "v000002")
        for key in ("spanId", "from", "to", "events", "trainer"):
            assert pm.data_span["stream"][key] == jm.data_span["stream"][key]
        (jmodel,) = jax_model_io.deserialize_models(jstore.load_blob("e", "v000002"))
        (pmodel,) = model_io.deserialize_models(pstore.load_blob("e", "v000002"))
        assert pmodel.user_vocab == jmodel.user_vocab
        assert _row_rel(jmodel.user_factors, pmodel.user_factors).max() < 1e-4
        assert _row_rel(jmodel.item_factors, pmodel.item_factors).max() < 1e-4


# ---------------------------------------------------------------------------
# the CLI: pio stream, pio train --follow
# ---------------------------------------------------------------------------


def _rate_events(n_users=12, n_items=8):
    out, k = [], 0
    for u in range(n_users):
        for i in range(n_items):
            if (u * 5 + i * 3) % 4 == 0:
                continue
            out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "properties": {"rating": float(1 + (u + i) % 5)},
                        "eventTime": f"2024-03-01T00:{k // 60:02d}:{k % 60:02d}.000Z"})
            k += 1
    return out


@pytest.fixture()
def project(tmp_path):
    from predictionio_tpu_torch.tools import cli
    from tests.torch_template_helpers import REPO, write_events

    home, engine_dir = tmp_path / "home", tmp_path / "engine"
    engine_dir.mkdir()
    variant = json.loads((REPO / "predictionio_tpu_torch/models/recommendation/engine.json").read_text())
    variant["datasource"]["params"]["appName"] = "streamapp"
    variant["algorithms"][0]["params"].update(rank=4, numIterations=3)
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    assert cli.main(["--home", str(home), "app", "new", "streamapp"]) == 0
    assert cli.main(["--home", str(home), "import", "--appname", "streamapp", "--input",
                     str(write_events(tmp_path / "ev.jsonl", _rate_events()))]) == 0
    return home, engine_dir, tmp_path / "registry"


def _new_events(home, n, start=0):
    from predictionio_tpu_torch.data.storage.registry import Storage

    storage = Storage(env={**os.environ, "PIO_FS_BASEDIR": str(home)})
    app = storage.get_meta_data_apps().get_by_name("streamapp")
    levents = storage.get_l_events()
    for k in range(start, start + n):
        now = dt.datetime.now(tz=UTC)
        e = rate_event(f"nu{k % 3}", f"i{k % 8}", float(1 + k % 5), k)
        levents.insert(dataclasses.replace(e, event_time=now, creation_time=now), app.id)


def test_cli_stream_one_cycle_publishes_a_candidate(project, capsys):
    from predictionio_tpu_torch.registry.store import ArtifactStore as Store
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.engine_loader import load_manifest

    home, engine_dir, registry = project
    base = ["--home", str(home)]
    assert cli.main([*base, "train", "--engine-dir", str(engine_dir), "--device", "cpu",
                     "--registry-dir", str(registry)]) == 0
    # the cursor starts at the store head; these events come after it
    stream = [*base, "stream", "--engine-dir", str(engine_dir), "--device", "cpu", "--app-name", "streamapp",
              "--registry-dir", str(registry), "--cycles", "1", "--interval", "0", "--safety-lag", "0"]
    assert cli.main(stream) == 0  # seeds the cursor, nothing new yet
    _new_events(home, 9)
    assert cli.main(stream) == 0
    out = capsys.readouterr().out
    assert "als-foldin" in out and "1 published" in out
    store = Store(str(registry))
    engine_id = load_manifest(str(engine_dir)).engine_id
    state = store.get_state(engine_id)
    assert state.stable == "v000001" and state.candidate == "v000002" and state.mode == "canary"
    m = store.get_manifest(engine_id, "v000002")
    assert m.parent_version == "v000001" and m.data_span["stream"]["events"] == 9
    (model,) = model_io.deserialize_models(store.load_blob(engine_id, "v000002"))
    assert {"nu0", "nu1", "nu2"} <= set(model.user_vocab)
    # a registry without a stable model is refused
    assert cli.main([*base, "stream", "--engine-dir", str(engine_dir), "--device", "cpu",
                     "--app-name", "streamapp", "--registry-dir", str(registry.parent / "empty")]) == 1


def test_cli_train_follow_trains_then_streams(project, capsys):
    """``train --follow`` publishes the stable, then tails from the store
    head: with no new event its one cycle reads and publishes nothing."""
    from predictionio_tpu_torch.registry.store import ArtifactStore as Store
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.engine_loader import load_manifest

    home, engine_dir, registry = project
    assert cli.main(["--home", str(home), "train", "--engine-dir", str(engine_dir), "--device", "cpu",
                     "--follow"]) == 1  # --follow needs --app-name, refused before training
    assert cli.main(["--home", str(home), "train", "--engine-dir", str(engine_dir), "--device", "cpu",
                     "--registry-dir", str(registry), "--follow", "--app-name", "streamapp",
                     "--cycles", "1", "--interval", "0"]) == 0
    out = capsys.readouterr().out
    assert "Entering follow mode" in out and "0 events read, 0 published" in out
    store = Store(str(registry))
    engine_id = load_manifest(str(engine_dir)).engine_id
    assert [m.version for m in store.list_versions(engine_id)] == ["v000001"]
    assert store.get_state(engine_id).stable == "v000001"


@pytest.fixture(scope="module")
def trained_als():
    """A port ALS model trained on the CPU (4,000 users x 1,000 items,
    100 ratings a user, rank 32), shared by the drift-guard cases."""
    from predictionio_tpu_torch.models.recommendation.engine import ALSAlgorithm, ALSAlgorithmParams, TrainingData
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    rng = np.random.default_rng(0)
    n_users, n_items, n = 4_000, 1_000, 400_000
    users, items = rng.integers(0, n_users, n), rng.zipf(1.3, n) % n_items
    U, V = rng.normal(size=(n_users, 8)) / np.sqrt(8), rng.normal(size=(n_items, 8)) / np.sqrt(8)
    vals = np.clip(np.sum(U[users] * V[items], 1) + 3 + 0.3 * rng.normal(size=n), 1, 5).astype(np.float32)
    uv, iv = [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)]
    return ALSAlgorithm(ALSAlgorithmParams(rank=32, num_iterations=8, lambda_=0.05)).train(
        WorkflowContext(device="cpu"), TrainingData(users.astype(np.int32), items.astype(np.int32), vals, uv, iv))


@pytest.mark.parametrize("per_user, ok", [(1, False), (20, True)])
def test_the_drift_guard_judges_existing_users_as_the_reference(trained_als, per_user, ok):
    """A fold-in re-solves a touched user from the ratings of the stream
    alone. Spread one rating per existing user, that discards each user's
    history and both packages' guards suppress the publish; twenty stream
    ratings per active user fold in within the guard in both. (This is why
    the card smoke streams its existing-user events from active users.)"""
    from predictionio_tpu.models.recommendation.engine import ALSModel as JALSModel
    from predictionio_tpu.stream.trainers import FoldInALSTrainer as JFoldIn

    model = trained_als
    rng = np.random.default_rng(per_user)
    n_users, n_items = len(model.user_vocab), len(model.item_vocab)
    n_events = 3_000
    pool = rng.choice(n_users, n_events // per_user, replace=False)
    su, si = pool[rng.integers(0, len(pool), n_events)], rng.zipf(1.3, n_events) % n_items
    r = np.clip(np.round(2 * (np.sum(model.user_factors[su] * model.item_factors[si], 1)
                              + 0.3 * rng.normal(size=n_events))) / 2, 1, 5)
    stream = [(f"u{a}", f"i{b}", float(c), k) for k, (a, b, c) in enumerate(zip(su, si, r))]
    jax_trainer = JFoldIn([JALSModel(model.user_factors, model.item_factors, model.user_vocab, model.item_vocab)])
    port = FoldInALSTrainer([model], device="cpu")
    for s in range(0, n_events, 500):
        jax_trainer.absorb([jax_rate_event(*e) for e in stream[s:s + 500]])
        port.absorb([rate_event(*e) for e in stream[s:s + 500]])
    j, p = jax_trainer.drift(), port.drift()
    assert (p.ok, p.metric) == (j.ok, j.metric) == (ok, "rmse"), (j, p)
    assert p.baseline == pytest.approx(j.baseline, rel=1e-5)
    assert p.current == pytest.approx(j.current, rel=1e-3)
