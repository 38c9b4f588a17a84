"""Incremental trainers: fold new events into a servable model in-place.

The :class:`IncrementalTrainer` protocol is what the stream pipeline
drives: ``absorb(events)`` folds a drained micro-batch into the model
state, ``snapshot()`` returns the serializable models list (the same
shape ``workflow/model_io.serialize_models`` persists and serving
deserializes), and ``drift()`` reports the rolling held-out guard — a
breach makes the pipeline suppress the publish instead of shipping a
regressed model.

Three implementations:

- :class:`FoldInALSTrainer` — fold-in of touched users/items against
  fixed counterpart factors: per touched entity, the rank-f normal
  equations from that entity's buffered ratings against the FIXED
  counterpart factors, all systems solved in one call of
  ``ops/spd_solve.batched_spd_solve_auto`` (kernel B1,
  ``ops/csrc/spd_cg.cu``, on a CUDA tensor; the same Jacobi-CG as the
  batch trainer).
- :class:`StreamingNaiveBayesTrainer` — count updates; the categorical
  NB model is a pure function of (label counts, per-position value
  counts), so streaming increments rebuild it exactly.
- :class:`StreamingCooccurrenceTrainer` — incremental pair counts over
  distinct (user, item) interactions; new pairs add 2 counter bumps per
  existing item of the user instead of a full self-join.

Drift guards: every trainer routes a fixed fraction of incoming examples
into a rolling held-out window (never absorbed), and ``drift()`` compares
the CURRENT model against the SEED model on that window — fold-in can
only be published while it is not measurably worse than what is already
stable. The ALS guard additionally checks factor health (non-finite or
exploding norms), which catches corrupt-event poisoning that inflates
both models' held-out error symmetrically.

Port of ``predictionio_tpu/stream/trainers.py``. The three host trainers
are copies; the fold-in solves on ``device`` and keeps host numpy
tables, which snapshots and blobs hold, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import Counter, deque
from typing import Any, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One guard verdict: ``ok=False`` suppresses the publish."""

    ok: bool
    metric: str = ""
    baseline: float | None = None
    current: float | None = None
    reason: str = ""

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class RollingHoldout:
    """Route every ``every``-th offered example into a bounded held-out
    window. Held examples are NOT absorbed — they are the guard's probe
    set, fresh enough to reflect current traffic, old enough to predate
    a poisoning burst (the window spans multiple drains)."""

    def __init__(self, every: int = 8, window: int = 256):
        self.every = max(1, int(every))
        self._n = 0
        self.held: deque = deque(maxlen=max(1, int(window)))

    def offer(self, example: Any) -> bool:
        """True = held out; the caller must skip absorbing it."""
        self._n += 1
        if self._n % self.every == 0:
            self.held.append(example)
            return True
        return False


@runtime_checkable
class IncrementalTrainer(Protocol):
    name: str

    def absorb(self, events: Sequence[Event]) -> int:
        """Fold a micro-batch in; returns the number of examples absorbed
        (held-out and malformed events don't count).

        Implementations may also set ``last_absorb_stats`` — a
        ``{"rows": n, "entities": m}`` dict describing the batch just
        folded (rows = examples absorbed, entities = distinct model
        entities touched) — which the pipeline copies onto the
        ``stream.foldin`` span tags."""

    def snapshot(self) -> list[Any]:
        """The serializable models list (what model_io persists)."""

    def drift(self) -> DriftReport: ...


# ---------------------------------------------------------------------------
# fold-in ALS
# ---------------------------------------------------------------------------


def _rating_of(
    e: Event,
    rating_key: str,
    buy_rating: float,
    rating_map: dict[str, float] | None,
) -> float | None:
    """Per-event mirror of models/recommendation's columnar rating rules."""
    if rating_map is not None:
        if e.event in rating_map:
            return float(rating_map[e.event])
        return None
    if e.event == "buy":
        return buy_rating
    r = e.properties.get(rating_key, None)
    if isinstance(r, (int, float)) and math.isfinite(float(r)):
        return float(r)
    return None


FOLD_PARTS = ("build_s", "upload_s", "b1_s", "fetch_s")


class FoldInALSTrainer:
    """Fold-in ALS against fixed counterpart factors.

    Per touched user, the trainer buffers that user's stream-seen
    ``(item_idx, rating)`` pairs (bounded, newest kept) and re-solves the
    user's rank-f normal equations ``(V^T V + reg*max(1, n)*I) x = V^T r``
    against the FIXED item table — then symmetrically for touched items
    against the just-updated user table. Unknown users/items extend the
    vocab with zero-initialized rows and get real factors on their first
    fold. Degree-scaled regularization matches the batch trainer's ALS-WR
    scheme, so a fold-in of an entity's full rating set reproduces the
    batch half-solve for that entity.

    One fold is four parts, timed apart (``last_absorb_stats``, summed over
    the user and item folds of an absorb): ``build`` forms each touched
    entity's A and b on the host, one entity at a time with the
    reference's own f32 numpy arithmetic (so the CPU path sees the JAX
    trainer's systems bit for bit); ``upload`` copies A [n, f, f] and b
    [n, f] to ``device`` as contiguous f32; ``b1`` is the solve (kernel B1
    on a CUDA device, its plain version on the CPU, never a library
    solve); ``fetch`` copies x back into the host table. The tables stay
    host numpy, which snapshots and blobs hold. An entity is touched only
    once a rating is in its buffer, so every system it builds has a positive
    diagonal; an all-zero system would solve to NaN in both packages' plain
    CG (1/0 on the Jacobi diagonal), not to zeros. ``solve_hook(side,
    order, A, b, x)``, when set, sees every solve's device inputs and
    output before the fetch.
    """

    name = "als-foldin"

    def __init__(
        self,
        models: Sequence[Any],
        *,
        reg: float = 0.1,
        rating_key: str = "rating",
        buy_rating: float = 4.0,
        rating_map: dict[str, float] | None = None,
        max_ratings_per_entity: int = 512,
        holdout_every: int = 8,
        holdout_window: int = 256,
        drift_rmse_ratio: float = 1.5,
        drift_rmse_floor: float = 0.1,
        drift_norm_ratio: float = 10.0,
        drift_min_samples: int = 8,
        device: str | torch.device = "cuda",
    ):
        from predictionio_tpu_torch.models.recommendation.engine import ALSModel

        self.device = resolve_device(device)
        self.models = list(models)
        self._als_index = next(
            (i for i, m in enumerate(self.models) if isinstance(m, ALSModel)),
            None,
        )
        if self._als_index is None:
            raise ValueError("no ALSModel found in the models list")
        seed: ALSModel = self.models[self._als_index]
        self.user_factors = np.asarray(seed.user_factors, np.float32).copy()
        self.item_factors = np.asarray(seed.item_factors, np.float32).copy()
        self.user_vocab = list(seed.user_vocab)
        self.item_vocab = list(seed.item_vocab)
        self._user_index = {u: i for i, u in enumerate(self.user_vocab)}
        self._item_index = {it: i for i, it in enumerate(self.item_vocab)}
        # seed tables kept for the drift guard's side of the comparison
        self._seed_user = self.user_factors.copy()
        self._seed_item = self.item_factors.copy()
        self.reg = float(reg)
        self.rating_key = rating_key
        self.buy_rating = float(buy_rating)
        self.rating_map = dict(rating_map) if rating_map else None
        self.max_ratings_per_entity = max(8, int(max_ratings_per_entity))
        # per-entity stream rating buffers: idx -> deque[(opposite_idx, r)]
        self._user_ratings: dict[int, deque] = {}
        self._item_ratings: dict[int, deque] = {}
        self.holdout = RollingHoldout(holdout_every, holdout_window)
        self.drift_rmse_ratio = drift_rmse_ratio
        self.drift_rmse_floor = drift_rmse_floor
        self.drift_norm_ratio = drift_norm_ratio
        self.drift_min_samples = max(1, drift_min_samples)
        self.examples_absorbed = 0
        self.solve_hook = None
        self.last_absorb_stats: dict[str, Any] = {"rows": 0, "entities": 0}

    # ---------------------------------------------------------------- absorb
    @staticmethod
    def _entity_idx(vocab: list[str], index: dict[str, int], key: str) -> int:
        idx = index.get(key)
        if idx is None:
            idx = len(vocab)
            vocab.append(key)
            index[key] = idx
        return idx

    def _grow_tables(self) -> None:
        """One zero-row extension per side per absorb — a vstack per NEW
        entity would copy the whole table each time."""
        for table_attr, vocab in (
            ("user_factors", self.user_vocab),
            ("item_factors", self.item_vocab),
        ):
            table = getattr(self, table_attr)
            grow = len(vocab) - table.shape[0]
            if grow > 0:
                setattr(
                    self,
                    table_attr,
                    np.vstack([table, np.zeros((grow, table.shape[1]), np.float32)]),
                )

    def _buffer(self, buffers: dict[int, deque], idx: int) -> deque:
        buf = buffers.get(idx)
        if buf is None:
            buf = deque(maxlen=self.max_ratings_per_entity)
            buffers[idx] = buf
        return buf

    def absorb(self, events: Sequence[Event]) -> int:
        touched_users: set[int] = set()
        touched_items: set[int] = set()
        absorbed = 0
        for e in events:
            if e.target_entity_id is None:
                continue
            r = _rating_of(e, self.rating_key, self.buy_rating, self.rating_map)
            if r is None:
                continue
            if self.holdout.offer((e.entity_id, e.target_entity_id, r)):
                continue
            uidx = self._entity_idx(self.user_vocab, self._user_index, e.entity_id)
            iidx = self._entity_idx(
                self.item_vocab, self._item_index, e.target_entity_id
            )
            self._buffer(self._user_ratings, uidx).append((iidx, r))
            self._buffer(self._item_ratings, iidx).append((uidx, r))
            touched_users.add(uidx)
            touched_items.add(iidx)
            absorbed += 1
        self._grow_tables()
        parts = dict.fromkeys(FOLD_PARTS, 0.0)
        if touched_users:
            # users first against the fixed item table, then items against
            # the just-updated users — the classic fold-in ordering
            self._fold(touched_users, self._user_ratings, "user_factors", "item_factors", parts)
        if touched_items:
            self._fold(touched_items, self._item_ratings, "item_factors", "user_factors", parts)
        self.examples_absorbed += absorbed
        self.last_absorb_stats = {
            "rows": absorbed,
            "entities": len(touched_users) + len(touched_items),
            **parts,
        }
        return absorbed

    def _fold(
        self,
        touched: set[int],
        buffers: dict[int, deque],
        solve_attr: str,
        fixed_attr: str,
        parts: dict[str, float],
    ) -> None:
        """Batched rank-f normal-equation solves for the touched entities:
        the systems built on the host exactly as the reference builds them,
        then one solve for the whole set on ``device``."""
        from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_auto

        t0 = time.perf_counter()
        fixed = getattr(self, fixed_attr)
        f = fixed.shape[1]
        order = sorted(touched)
        A = np.zeros((len(order), f, f), np.float32)
        b = np.zeros((len(order), f), np.float32)
        eye = np.eye(f, dtype=np.float32)
        for k, idx in enumerate(order):
            pairs = buffers.get(idx)
            if not pairs:
                continue  # as the reference; never taken: a touched entity has ratings
            opp = np.fromiter((p[0] for p in pairs), np.int64, len(pairs))
            r = np.fromiter((p[1] for p in pairs), np.float32, len(pairs))
            V = fixed[opp]  # [n, f] gather against the FIXED side
            A[k] = V.T @ V + self.reg * max(1.0, len(pairs)) * eye
            b[k] = V.T @ r
        t1 = time.perf_counter()
        A_t = torch.from_numpy(A).to(self.device)
        b_t = torch.from_numpy(b).to(self.device)
        self._sync()
        t2 = time.perf_counter()
        x = batched_spd_solve_auto(A_t, b_t)
        self._sync()
        t3 = time.perf_counter()
        if self.solve_hook is not None:  # outside the timed parts
            self.solve_hook(solve_attr.split("_")[0], order, A_t, b_t, x)
        t4 = time.perf_counter()
        # pio-lint: disable=train-unaccounted-sync -- the absorb's one fetch, timed as its fetch_s part
        getattr(self, solve_attr)[order] = x.cpu().numpy()
        t5 = time.perf_counter()
        parts["build_s"] += t1 - t0
        parts["upload_s"] += t2 - t1
        parts["b1_s"] += t3 - t2
        parts["fetch_s"] += t5 - t4

    def _sync(self) -> None:
        if self.device.type == "cuda":
            # pio-lint: disable=train-unaccounted-sync -- the barrier that times an absorb's build, upload, B1 and fetch parts
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> list[Any]:
        """The servable models list; the tables are copied, so a published
        blob never shares memory with tables the next absorb writes."""
        from predictionio_tpu_torch.models.recommendation.engine import ALSModel

        out = list(self.models)
        out[self._als_index] = ALSModel(
            self.user_factors.copy(),
            self.item_factors.copy(),
            list(self.user_vocab),
            list(self.item_vocab),
        )
        self.models = list(out)
        return out

    # ----------------------------------------------------------------- drift
    def _rmse(self, users: np.ndarray, items: np.ndarray, ratings: np.ndarray,
              U: np.ndarray, V: np.ndarray) -> float:
        pred = np.sum(U[users] * V[items], axis=1)
        return float(np.sqrt(np.mean((pred - ratings) ** 2)))

    def drift(self) -> DriftReport:
        # factor-health gate first: corrupt ratings (a poisoned stream)
        # inflate BOTH models' held-out error, but only the folded factors
        # explode — seed-vs-current norms catch what rmse ratios cannot
        if not (
            np.all(np.isfinite(self.user_factors))
            and np.all(np.isfinite(self.item_factors))
        ):
            return DriftReport(False, "factor-health", reason="non-finite factors")
        seed_norm = max(
            1e-6,
            float(np.abs(self._seed_user).max(initial=0.0)),
            float(np.abs(self._seed_item).max(initial=0.0)),
        )
        cur_norm = max(
            float(np.abs(self.user_factors).max(initial=0.0)),
            float(np.abs(self.item_factors).max(initial=0.0)),
        )
        if cur_norm > seed_norm * self.drift_norm_ratio:
            return DriftReport(
                False,
                "factor-health",
                baseline=seed_norm,
                current=cur_norm,
                reason=(
                    f"factor magnitude {cur_norm:.3g} > "
                    f"{self.drift_norm_ratio:g}x seed {seed_norm:.3g}"
                ),
            )
        # held-out rmse gate, restricted to entities BOTH models know (a
        # new user can't regress against a seed that never saw them)
        held = [
            (self._user_index.get(u), self._item_index.get(i), r)
            for u, i, r in self.holdout.held
        ]
        n_seed_u, n_seed_i = self._seed_user.shape[0], self._seed_item.shape[0]
        known = [
            (u, i, r)
            for u, i, r in held
            if u is not None and i is not None and u < n_seed_u and i < n_seed_i
        ]
        if len(known) < self.drift_min_samples:
            return DriftReport(True, "rmse", reason="insufficient held-out samples")
        users = np.asarray([u for u, _, _ in known], np.int64)
        items = np.asarray([i for _, i, _ in known], np.int64)
        ratings = np.asarray([r for _, _, r in known], np.float32)
        baseline = self._rmse(users, items, ratings, self._seed_user, self._seed_item)
        current = self._rmse(users, items, ratings, self.user_factors, self.item_factors)
        ok = current <= baseline * self.drift_rmse_ratio + self.drift_rmse_floor
        return DriftReport(
            ok,
            "rmse",
            baseline=baseline,
            current=current,
            reason="" if ok else (
                f"held-out rmse {current:.4f} > "
                f"{self.drift_rmse_ratio:g}x seed {baseline:.4f} + "
                f"{self.drift_rmse_floor:g}"
            ),
        )


# ---------------------------------------------------------------------------
# streaming naive bayes
# ---------------------------------------------------------------------------


class StreamingNaiveBayesTrainer:
    """Streaming categorical naive Bayes via count updates.

    Events carry ``properties[label_key]`` (string) and
    ``properties[features_key]`` (list of strings). The model is rebuilt
    exactly from the running counts — identical math to
    ``e2.naive_bayes.train_categorical_naive_bayes``.
    """

    name = "naive-bayes-stream"

    def __init__(
        self,
        seed_model=None,
        *,
        label_key: str = "label",
        features_key: str = "features",
        holdout_every: int = 8,
        holdout_window: int = 256,
        drift_max_divergence: float = 0.5,
        drift_min_samples: int = 8,
    ):
        self.label_key = label_key
        self.features_key = features_key
        self._label_counts: Counter = Counter()
        self._value_counts: dict[str, list[Counter]] = {}
        self._n = 0
        self._n_features = 0
        self.holdout = RollingHoldout(holdout_every, holdout_window)
        self.drift_max_divergence = drift_max_divergence
        self.drift_min_samples = max(1, drift_min_samples)
        # NB counts are not recoverable from a log-prob model, so the
        # stream model rebuilds from stream counts — but the STABLE model
        # (when given) anchors the divergence guard: a stream model whose
        # predictions flip away from what is serving cannot publish. Its
        # absence falls back to the first-batch model as the anchor.
        self._seed_model = seed_model
        self._stable_seeded = seed_model is not None
        self.examples_absorbed = 0
        self.last_absorb_stats: dict[str, int] = {"rows": 0, "entities": 0}

    def _extract(self, e: Event):
        from predictionio_tpu_torch.e2.naive_bayes import LabeledPoint

        label = e.properties.get(self.label_key, None)
        features = e.properties.get(self.features_key, None)
        if not isinstance(label, str) or not isinstance(features, (list, tuple)):
            return None
        return LabeledPoint(label, tuple(str(v) for v in features))

    def absorb(self, events: Sequence[Event]) -> int:
        absorbed = 0
        touched_labels: set[str] = set()
        for e in events:
            p = self._extract(e)
            if p is None:
                continue
            if self.holdout.offer(p):
                continue
            self._label_counts[p.label] += 1
            self._n += 1
            self._n_features = max(self._n_features, len(p.features))
            per_pos = self._value_counts.setdefault(p.label, [])
            while len(per_pos) < self._n_features:
                per_pos.append(Counter())
            for pos, v in enumerate(p.features):
                per_pos[pos][v] += 1
            touched_labels.add(p.label)
            absorbed += 1
        self.last_absorb_stats = {
            "rows": absorbed,
            "entities": len(touched_labels),
        }
        self.examples_absorbed += absorbed
        if self._seed_model is None and self._n:
            # baseline = the model after the FIRST absorbed batch: later
            # batches must not make held-out accuracy collapse against it
            self._seed_model = self._build_model()
        return absorbed

    def _build_model(self):
        from predictionio_tpu_torch.e2.naive_bayes import CategoricalNaiveBayesModel

        if not self._n:
            raise ValueError("no examples absorbed yet")
        priors = {
            label: math.log(c / self._n) for label, c in self._label_counts.items()
        }
        likelihoods = {
            label: [
                {v: math.log(c / self._label_counts[label]) for v, c in counter.items()}
                for counter in per_pos
            ]
            for label, per_pos in self._value_counts.items()
        }
        return CategoricalNaiveBayesModel(priors, likelihoods)

    def snapshot(self) -> list[Any]:
        return [self._build_model()]

    def drift(self) -> DriftReport:
        """Seed-divergence guard (same idea as the shadow-divergence
        gate): the fraction of held-out examples where the folded model's
        prediction DISAGREES with the seed (first-batch) model's. A
        self-consistent poisoning burst fools any accuracy-on-recent-data
        metric (the poison validates itself), but it cannot avoid flipping
        predictions away from the seed."""
        if (
            len(self.holdout.held) < self.drift_min_samples
            or not self._n
            or self._seed_model is None
        ):
            # rebuilt-from-stream NB starts near-empty; with a STABLE
            # model to answer for, a snapshot without held-out evidence
            # must not publish (it would canary a from-scratch model)
            ok = not self._stable_seeded
            return DriftReport(
                ok,
                "divergence",
                reason=(
                    "insufficient held-out samples"
                    if ok
                    else "insufficient held-out evidence to vouch for a "
                    "from-scratch stream model against the stable"
                ),
            )
        current_model = self._build_model()
        held = list(self.holdout.held)
        diverged = sum(
            1
            for p in held
            if current_model.predict(p.features)
            != self._seed_model.predict(p.features)
        )
        rate = diverged / len(held)
        ok = rate <= self.drift_max_divergence
        return DriftReport(
            ok,
            "divergence",
            baseline=0.0,
            current=rate,
            reason="" if ok else (
                f"{rate:.3f} of held-out predictions diverged from the "
                f"seed model (> {self.drift_max_divergence:g})"
            ),
        )


# ---------------------------------------------------------------------------
# streaming cooccurrence
# ---------------------------------------------------------------------------


class StreamingCooccurrenceTrainer:
    """Incremental item-cooccurrence counts over distinct (user, item)
    interactions. A new distinct pair bumps 2 counters per existing item
    of that user (both directions) instead of re-running the self-join.

    Optionally seeded from the similarproduct engine's
    ``CooccurrenceModel``: the stable top-N map's counts merge with the
    stream counts at snapshot time (pairs the stable truncated away are
    gone — documented lossy merge), new items extend the vocab, and
    ``snapshot()`` returns an updated ``CooccurrenceModel``. Unseeded,
    ``snapshot()`` returns the raw string-keyed top-N map
    ``ops/cooccurrence.score_by_cooccurrence`` consumes."""

    name = "cooccurrence-stream"

    def __init__(
        self,
        seed_model=None,
        *,
        top_n: int = 10,
        max_items_per_user: int = 1024,
        holdout_every: int = 8,
        holdout_window: int = 256,
        drift_hit_drop: float = 0.5,
        drift_min_samples: int = 8,
    ):
        self.top_n = max(1, top_n)
        self.max_items_per_user = max(2, max_items_per_user)
        self._user_items: dict[str, set[str]] = {}
        self._pair_counts: Counter = Counter()  # (item_str, item_str) -> n
        self._seed_model = seed_model
        self._seed_counts: Counter = Counter()
        if seed_model is not None:
            vocab = seed_model.item_vocab
            for a, pairs in seed_model.top_map.items():
                for b, c in pairs:
                    self._seed_counts[(vocab[int(a)], vocab[int(b)])] = int(c)
        self.holdout = RollingHoldout(holdout_every, holdout_window)
        self.drift_hit_drop = drift_hit_drop
        self.drift_min_samples = max(1, drift_min_samples)
        self._baseline_hit_rate: float | None = None
        self._top_cache: dict[str, list[tuple[str, int]]] | None = None
        self.examples_absorbed = 0
        self.last_absorb_stats: dict[str, int] = {"rows": 0, "entities": 0}

    def absorb(self, events: Sequence[Event]) -> int:
        absorbed = 0
        touched: set[str] = set()
        for e in events:
            item = e.target_entity_id
            if item is None:
                continue
            user = e.entity_id
            if self.holdout.offer((user, item)):
                continue
            items = self._user_items.setdefault(user, set())
            if item in items or len(items) >= self.max_items_per_user:
                continue  # only DISTINCT interactions count (ref parity)
            for other in items:
                self._pair_counts[(item, other)] += 1
                self._pair_counts[(other, item)] += 1
            items.add(item)
            touched.add(item)
            self._top_cache = None  # counts changed; recompute on demand
            absorbed += 1
        self.last_absorb_stats = {"rows": absorbed, "entities": len(touched)}
        self.examples_absorbed += absorbed
        if self._baseline_hit_rate is None and (
            len(self.holdout.held) >= self.drift_min_samples
        ):
            self._baseline_hit_rate = self._hit_rate()
        return absorbed

    def top_map(self) -> dict[str, list[tuple[str, int]]]:
        """Merged (seed + stream) string-keyed top-N map. Cached until the
        next counted interaction — drift() and snapshot() both need it in
        the same publish attempt, and the merge+sort is O(total pairs)."""
        if self._top_cache is not None:
            return self._top_cache
        merged = self._seed_counts + self._pair_counts
        per_item: dict[str, list[tuple[str, int]]] = {}
        for (a, b), c in merged.items():
            per_item.setdefault(a, []).append((b, c))
        self._top_cache = {
            item: sorted(pairs, key=lambda p: (-p[1], p[0]))[: self.top_n]
            for item, pairs in per_item.items()
        }
        return self._top_cache

    def snapshot(self) -> list[Any]:
        top = self.top_map()
        if self._seed_model is None:
            return [top]
        # rebuild the engine-servable CooccurrenceModel: stream-only items
        # extend the vocab (no categories/properties known for them yet)
        seed = self._seed_model
        vocab = list(seed.item_vocab)
        index = {v: i for i, v in enumerate(vocab)}
        categories = list(seed.item_categories)
        properties = (
            list(seed.item_properties) if seed.item_properties is not None else None
        )

        def idx(item: str) -> int:
            i = index.get(item)
            if i is None:
                i = len(vocab)
                vocab.append(item)
                index[item] = i
                categories.append(None)
                if properties is not None:
                    properties.append(None)
            return i

        int_map = {
            idx(a): [(idx(b), c) for b, c in pairs] for a, pairs in top.items()
        }
        return [
            type(seed)(int_map, vocab, categories, properties)
        ]

    def _hit_rate(self) -> float:
        top = self.top_map()
        held = list(self.holdout.held)
        hits = 0
        for user, item in held:
            others = self._user_items.get(user, set())
            if any(
                item in {o for o, _ in top.get(other, [])} for other in others
            ):
                hits += 1
        return hits / len(held) if held else 0.0

    def drift(self) -> DriftReport:
        if len(self.holdout.held) < self.drift_min_samples:
            return DriftReport(True, "hit-rate", reason="insufficient held-out samples")
        current = self._hit_rate()
        baseline = (
            self._baseline_hit_rate if self._baseline_hit_rate is not None else current
        )
        ok = current >= baseline - self.drift_hit_drop
        return DriftReport(
            ok,
            "hit-rate",
            baseline=baseline,
            current=current,
            reason="" if ok else (
                f"held-out hit rate {current:.3f} dropped more than "
                f"{self.drift_hit_drop:g} below baseline {baseline:.3f}"
            ),
        )


# ---------------------------------------------------------------------------
# streaming sequential (session / next-item)
# ---------------------------------------------------------------------------


class SequentialStreamTrainer:
    """Incremental transition counts over per-user session streams.

    Seeded from the sequential engine's :class:`SequentialModel`: the
    seed's RAW pair counts (kept on the model precisely for this merge —
    ``train_markov_chain`` output alone is top-N-truncated) merge with
    stream counts at snapshot time, and the published model's transition
    matrix is rebuilt through the EXACT ``e2.markov_chain`` math. The
    attention factor tables, when present, ride through unchanged — they
    refresh only at batch retrain; the markov scorer is the live-foldable
    half.

    Events must arrive in session order (the pipeline's ``find_after``
    tail guarantees it); each event extends its user's session, bumping
    one (prev -> item) transition count."""

    name = "sequential-stream"

    def __init__(
        self,
        seed_model=None,
        *,
        top_n: int | None = None,
        max_users: int = 100_000,
        holdout_every: int = 8,
        holdout_window: int = 256,
        drift_hit_drop: float = 0.5,
        drift_min_samples: int = 8,
        instruments=None,
    ):
        self._seed_model = seed_model
        self.top_n = max(
            1, top_n if top_n is not None else getattr(seed_model, "top_n", 10)
        )
        self.max_users = max(16, max_users)
        self._pair_counts: Counter = Counter()  # (item_str, item_str) -> n
        self._user_last: dict[str, str] = {}
        if seed_model is not None:
            vocab = seed_model.item_vocab
            for (i, j), c in seed_model.pair_counts.items():
                self._pair_counts[(vocab[int(i)], vocab[int(j)])] = float(c)
            for u, i in seed_model.user_last.items():
                self._user_last[u] = vocab[int(i)]
        self.holdout = RollingHoldout(holdout_every, holdout_window)
        self.drift_hit_drop = drift_hit_drop
        self.drift_min_samples = max(1, drift_min_samples)
        self._baseline_hit_rate: float | None = None
        self._top_cache: dict[str, list[tuple[str, float]]] | None = None
        self.examples_absorbed = 0
        self.last_absorb_stats: dict[str, int] = {"rows": 0, "entities": 0}
        self._instruments = instruments

    def absorb(self, events: Sequence[Event]) -> int:
        absorbed = 0
        touched: set[str] = set()
        for e in events:
            item = e.target_entity_id
            if item is None or not e.entity_id:
                continue
            user = e.entity_id
            prev = self._user_last.get(user)
            if prev is not None and self.holdout.offer((prev, item)):
                # held-out transitions still advance the session cursor —
                # the NEXT transition's "from" state must stay truthful
                self._user_last[user] = item
                continue
            if prev is not None:
                self._pair_counts[(prev, item)] += 1
                self._top_cache = None
                absorbed += 1
                touched.add(item)
            elif len(self._user_last) >= self.max_users:
                continue  # bounded session-state map: drop NEW users, not counts
            self._user_last[user] = item
        self.last_absorb_stats = {"rows": absorbed, "entities": len(touched)}
        self.examples_absorbed += absorbed
        if self._instruments is not None and absorbed:
            self._instruments.on_absorb(absorbed, len(touched))
        if self._baseline_hit_rate is None and (
            len(self.holdout.held) >= self.drift_min_samples
        ):
            self._baseline_hit_rate = self._hit_rate()
        return absorbed

    def top_map(self) -> dict[str, list[tuple[str, float]]]:
        """Merged top-N transition PROBABILITIES keyed by item string —
        row-normalized and ranked with the identical tie-break the e2
        trainer uses, cached until the next counted transition."""
        if self._top_cache is not None:
            return self._top_cache
        per_item: dict[str, dict[str, float]] = {}
        for (a, b), c in self._pair_counts.items():
            per_item.setdefault(a, {})[b] = per_item.setdefault(a, {}).get(b, 0.0) + c
        out: dict[str, list[tuple[str, float]]] = {}
        for a, row in per_item.items():
            total = sum(row.values())
            if total <= 0:
                continue
            ranked = sorted(
                ((b, c / total) for b, c in row.items()),
                key=lambda t: (-t[1], t[0]),
            )
            out[a] = ranked[: self.top_n]
        self._top_cache = out
        return out

    def snapshot(self) -> list[Any]:
        from predictionio_tpu_torch.models.sequential.engine import (
            SequentialModel,
            markov_from_counts,
        )

        seed = self._seed_model
        vocab = list(seed.item_vocab) if seed is not None else []
        index = {v: i for i, v in enumerate(vocab)}

        def idx(item: str) -> int:
            i = index.get(item)
            if i is None:
                i = len(vocab)
                vocab.append(item)
                index[item] = i
            return i

        counts = {
            (idx(a), idx(b)): float(c) for (a, b), c in self._pair_counts.items()
        }
        model = SequentialModel(
            item_vocab=vocab,
            markov=markov_from_counts(counts, len(vocab), self.top_n),
            pair_counts=counts,
            user_last={u: index[i] for u, i in self._user_last.items()},
            top_n=self.top_n,
            # attention tables refresh only at batch retrain; stream-only
            # items score through the markov path until then
            item_in=getattr(seed, "item_in", None),
            item_out=getattr(seed, "item_out", None),
            context=getattr(seed, "context", 8),
        )
        if self._instruments is not None:
            self._instruments.on_snapshot(
                len(vocab), len(counts), len(self._user_last)
            )
        return [model]

    def _hit_rate(self) -> float:
        top = self.top_map()
        held = list(self.holdout.held)
        hits = 0
        for prev, nxt in held:
            if any(nxt == b for b, _ in top.get(prev, [])):
                hits += 1
        return hits / len(held) if held else 0.0

    def drift(self) -> DriftReport:
        if len(self.holdout.held) < self.drift_min_samples:
            return DriftReport(
                True, "hit-rate", reason="insufficient held-out samples"
            )
        current = self._hit_rate()
        baseline = (
            self._baseline_hit_rate
            if self._baseline_hit_rate is not None
            else current
        )
        ok = current >= baseline - self.drift_hit_drop
        return DriftReport(
            ok,
            "hit-rate",
            baseline=baseline,
            current=current,
            reason="" if ok else (
                f"held-out next-item hit rate {current:.3f} dropped more "
                f"than {self.drift_hit_drop:g} below baseline {baseline:.3f}"
            ),
        )
