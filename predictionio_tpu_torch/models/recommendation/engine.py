"""ALS recommendation engine (DASE components), port of
``predictionio_tpu/models/recommendation/engine.py``.

Query ``{"user", "num", "blackList"}`` -> ``{"itemScores": [{item, score}]}``.
The DataSource reads "rate" and "buy" events of user -> item (buy maps to
rating 4.0) from the columnar store; ALSAlgorithm trains with
``ops.als.als_train`` on the context's device (``ops.als_sharded.
als_train_sharded`` over the context's mesh with ``distributed``) and
serves from a
device-resident ``ServingIndex``, one batched top-k per micro-batch.
Variants: the ``custom`` preparator drops the items listed in a file, the
``filter`` serving drops those listed in a file it re-reads per request.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Engine,
    Params,
    SanityCheck,
    TorchAlgorithm,
)
from predictionio_tpu_torch.data.storage.base import ColumnarEvents
from predictionio_tpu_torch.obs import xray
from predictionio_tpu_torch.ops.als import ALSConfig, ServingIndex, als_train, next_pow2
from predictionio_tpu_torch.ops.als_sharded import als_train_sharded
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.workflow.context import WorkflowContext

DEFAULT_QUERY_NUM = 10


@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = DEFAULT_QUERY_NUM
    black_list: frozenset[str] | None = None

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Query":
        bl = d.get("blackList")
        return Query(
            user=str(d["user"]),
            num=int(d.get("num", DEFAULT_QUERY_NUM)),
            black_list=frozenset(str(x) for x in bl) if bl is not None else None,
        )


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...]

    def to_json_dict(self) -> dict[str, Any]:
        return {"itemScores": [{"item": s.item, "score": s.score} for s in self.item_scores]}


@dataclasses.dataclass(frozen=True)
class Rating:
    user: str
    item: str
    rating: float


@dataclasses.dataclass(frozen=True)
class ActualResult:
    ratings: tuple[Rating, ...]


# ---------------------------------------------------------------------------
# DataSource
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvalParams(Params):
    k_fold: int = 2
    query_num: int = 10


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    """``rating_map`` assigns a fixed rating to each listed event name,
    overriding any per-event "rating" property. ``eval_params`` shapes the
    evaluation folds of ``read_eval``; training ignores it."""

    app_name: str = ""
    event_names: tuple[str, ...] = ("rate", "buy")
    buy_rating: float = 4.0
    rating_map: dict[str, float] | None = None
    eval_params: EvalParams | None = None


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_idx: np.ndarray
    item_idx: np.ndarray
    ratings: np.ndarray
    user_vocab: list[str]
    item_vocab: list[str]

    def sanity_check(self) -> None:
        if len(self.user_idx) == 0:
            raise ValueError("no rating events found; check app data")
        if not np.all(np.isfinite(self.ratings)):
            raise ValueError("non-finite rating values present")


def _columnar_to_ratings(
    col: ColumnarEvents,
    buy_rating: float,
    rating_map: dict[str, float] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    ratings = col.ratings.copy()
    if rating_map:
        names = np.asarray(col.event_names)
        for event_name, value in rating_map.items():
            ratings[names == event_name] = float(value)
    else:
        buys = np.asarray([n == "buy" for n in col.event_names], dtype=bool)
        ratings[buys] = buy_rating
    valid = np.isfinite(ratings) & (col.entity_ids >= 0) & (col.target_ids >= 0)
    return col.entity_ids[valid], col.target_ids[valid], ratings[valid]


class DataSource(BaseDataSource):
    params_class = DataSourceParams
    params: DataSourceParams

    def _read_columnar(self, ctx: WorkflowContext) -> ColumnarEvents:
        return ctx.p_event_store().to_columnar_cached(
            app_name=self.params.app_name or ctx.app_name,
            channel_name=ctx.channel_name,
            event_names=list(self.params.event_names),
            entity_type="user",
            target_entity_type="item",
            rating_key="rating",
        )

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        col = self._read_columnar(ctx)
        u, i, r = _columnar_to_ratings(col, self.params.buy_rating, self.params.rating_map)
        return TrainingData(u, i, r, col.entity_vocab, col.target_vocab)

    def read_eval(self, ctx: WorkflowContext):
        """k folds by rating index (rating n is held out in fold n mod k),
        one query per held-out user whose actual is that user's held-out
        ratings (ref DataSource.scala:81-104)."""
        if self.params.eval_params is None:
            raise ValueError("Must specify evalParams for evaluation")
        ep = self.params.eval_params
        col = self._read_columnar(ctx)
        u, i, r = _columnar_to_ratings(col, self.params.buy_rating, self.params.rating_map)
        idx = np.arange(len(u))
        folds = []
        for fold in range(ep.k_fold):
            test = idx % ep.k_fold == fold
            td = TrainingData(u[~test], i[~test], r[~test], col.entity_vocab, col.target_vocab)
            test_u, test_i, test_r = u[test], i[test], r[test]
            qa: list[tuple[Query, ActualResult]] = []
            for user in np.unique(test_u):
                sel = test_u == user
                name = col.entity_vocab[int(user)]
                ratings = tuple(
                    Rating(name, col.target_vocab[int(ti)], float(tr))
                    for ti, tr in zip(test_i[sel], test_r[sel])
                )
                qa.append((Query(name, ep.query_num), ActualResult(ratings)))
            folds.append((td, {}, qa))
        return folds


class Preparator(BasePreparator):
    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        return td


@dataclasses.dataclass(frozen=True)
class CustomPreparatorParams(Params):
    filepath: str


class CustomPreparator(BasePreparator):
    """The customize-data-prep variant: drop the ratings of the items listed
    in a file (one item id per line), and those items from the vocabulary,
    so that they get no factors and are never served."""

    params_class = CustomPreparatorParams
    params: CustomPreparatorParams

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        with open(self.params.filepath) as fh:
            no_train_items = {line.strip() for line in fh if line.strip()}
        if not no_train_items:
            return td
        excluded = np.asarray([item in no_train_items for item in td.item_vocab], dtype=bool)
        new_of_old = np.cumsum(~excluded) - 1
        keep = ~excluded[td.item_idx]
        return TrainingData(
            td.user_idx[keep],
            new_of_old[td.item_idx[keep]].astype(td.item_idx.dtype),
            td.ratings[keep],
            td.user_vocab,
            [it for it, ex in zip(td.item_vocab, excluded) if not ex],
        )


# ---------------------------------------------------------------------------
# Algorithm
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.1
    seed: int | None = 3
    implicit_prefs: bool = False
    alpha: float = 1.0
    # the mesh-sharded solver (ops/als_sharded.py) across the ranks of a
    # joined job; without one, the single-device train
    distributed: bool = False
    gather_dtype: str = "f32"  # "f32" | "bf16": dtype of the gathered rows only
    solver: str = "cg"  # "cg" | "cg_fused" (both kernel B1 on CUDA) | "cholesky"
    chunk: int = 16384  # ratings per Gram chunk (ops.als.ALSConfig.chunk)


@dataclasses.dataclass
class ALSModel(SanityCheck):
    user_factors: np.ndarray  # [n_users, f] host numpy (checkpoint form)
    item_factors: np.ndarray  # [n_items, f]
    user_vocab: list[str]
    item_vocab: list[str]

    def __post_init__(self):
        self._reset()

    def _reset(self) -> None:
        self._user_index: dict[str, int] | None = None
        self._item_index: dict[str, int] | None = None
        self._serving_index: ServingIndex | None = None
        self.device: torch.device | str = "cuda"  # set by train and deploy

    def sanity_check(self) -> None:
        if not (np.all(np.isfinite(self.user_factors)) and np.all(np.isfinite(self.item_factors))):
            raise ValueError("ALS produced non-finite factors")

    def user_index(self, user: str) -> int | None:
        if self._user_index is None:
            self._user_index = {u: i for i, u in enumerate(self.user_vocab)}
        return self._user_index.get(user)

    def item_index(self, item: str) -> int | None:
        if self._item_index is None:
            self._item_index = {it: i for i, it in enumerate(self.item_vocab)}
        return self._item_index.get(item)

    def serving_index(self) -> ServingIndex:
        """Both factor tables resident on ``self.device``."""
        if self._serving_index is None:
            self._serving_index = ServingIndex(self.user_factors, self.item_factors, self.device)
        return self._serving_index

    def __getstate__(self):
        # the same state as the JAX package's ALSModel, so blobs interchange
        return {
            "user_factors": self.user_factors,
            "item_factors": self.item_factors,
            "user_vocab": self.user_vocab,
            "item_vocab": self.item_vocab,
        }

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._reset()


class ALSAlgorithm(TorchAlgorithm):
    params_class = ALSAlgorithmParams
    params: ALSAlgorithmParams
    # set to a dict to receive als_train's timings decomposition of the next train
    timings: dict | None = None

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> ALSModel:
        cfg = ALSConfig(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            reg=self.params.lambda_,
            implicit=self.params.implicit_prefs,
            alpha=self.params.alpha,
            seed=self.params.seed if self.params.seed is not None else 0,
            chunk=self.params.chunk,
            gather_dtype=self.params.gather_dtype,
            solver=self.params.solver,
        )
        args = (pd.user_idx, pd.item_idx, pd.ratings, len(pd.user_vocab), len(pd.item_vocab), cfg)
        if self.timings is not None:
            # the capacity planner's per-card prediction, over the ranks
            # the train spreads across (pio doctor --capacity answers it)
            self.timings["estimate"] = xray.estimate_factors(
                len(pd.user_vocab), len(pd.item_vocab), self.params.rank,
                mesh=ctx.mesh.size if self.params.distributed else 1,
                nnz=int(pd.user_idx.shape[0]), gather_dtype=self.params.gather_dtype,
            ).to_json_dict()
        if self.params.distributed and distributed.runtime() is not None:
            uf, vf = als_train_sharded(*args, mesh=ctx.mesh, timings=self.timings)
        else:
            uf, vf = (t.cpu().numpy() for t in als_train(*args, timings=self.timings, device=ctx.device))
        model = ALSModel(uf, vf, pd.user_vocab, pd.item_vocab)
        model.device = ctx.device
        return model

    def prepare_model(self, ctx: WorkflowContext, persisted: ALSModel) -> ALSModel:
        persisted.device = ctx.device
        persisted.serving_index()  # factor tables onto the serving device now
        return persisted

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        uidx = model.user_index(query.user)
        if uidx is None:
            return PredictedResult(())  # unknown user -> empty result
        mask = None
        if query.black_list:
            mask = np.ones(len(model.item_vocab), dtype=bool)
            for item in query.black_list:
                iidx = model.item_index(item)
                if iidx is not None:
                    mask[iidx] = False
        scores, idx = model.serving_index().serve(
            uidx, min(query.num, len(model.item_vocab)), mask=mask
        )
        return PredictedResult(
            tuple(
                ItemScore(model.item_vocab[int(i)], float(s))
                for s, i in zip(scores, idx)
                if np.isfinite(s)
            )
        )

    def warmup_serving(self, model: ALSModel, max_batch: int) -> None:
        index = model.serving_index()
        k = min(DEFAULT_QUERY_NUM, len(model.item_vocab))
        index.warmup(k)
        index.warmup_buckets(k, max_batch)

    def predict_batch(self, model: ALSModel, queries: Sequence[Query]) -> list[PredictedResult]:
        return self.predict_batch_dispatch(model, queries)()

    def predict_batch_dispatch(self, model: ALSModel, queries: Sequence[Query]):
        """Launch one batched top-k for every known user without a
        blacklist; unknown users answer empty, blacklist queries run the
        single-query path inside finalize. Batch and k round up to powers
        of two; pad rows serve user 0 and are dropped."""
        from predictionio_tpu_torch.ops import topk

        results: list[PredictedResult | None] = [None] * len(queries)
        batch_pos: list[int] = []
        batch_idx: list[int] = []
        masked_pos: list[int] = []
        for i, q in enumerate(queries):
            uidx = model.user_index(q.user)
            if uidx is None:
                results[i] = PredictedResult(())
            elif q.black_list:
                masked_pos.append(i)
            else:
                batch_pos.append(i)
                batch_idx.append(uidx)
        n_items = len(model.item_vocab)
        handle = None
        if batch_pos:
            k = min(max(queries[i].num for i in batch_pos), n_items)
            kk = min(next_pow2(k), n_items)
            idxs = topk.scratch().zeros("rec.uidx", (next_pow2(len(batch_pos)),), np.int32)
            idxs[: len(batch_pos)] = batch_idx
            handle = model.serving_index().serve_batch_async(idxs, kk)

        def finalize() -> list[PredictedResult]:
            for i in masked_pos:
                results[i] = self.predict(model, queries[i])
            if handle is not None:
                scores, idx = topk.fetch_topk(handle)
                for row, i in enumerate(batch_pos):
                    num = min(queries[i].num, n_items)
                    results[i] = PredictedResult(
                        tuple(
                            ItemScore(model.item_vocab[int(it)], float(s))
                            for s, it in zip(scores[row, :num], idx[row, :num])
                            if np.isfinite(s)
                        )
                    )
            return results  # type: ignore[return-value]

        return finalize


class Serving(BaseServing):
    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


@dataclasses.dataclass(frozen=True)
class ServingParams(Params):
    filepath: str


class FilterServing(BaseServing):
    """The customize-serving variant: re-read the disabled-items file on
    every request (it can change without a redeploy) and drop those items
    from the first algorithm's result."""

    params_class = ServingParams
    params: ServingParams

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        with open(self.params.filepath) as fh:
            disabled = {line.strip() for line in fh if line.strip()}
        return PredictedResult(
            tuple(s for s in predictions[0].item_scores if s.item not in disabled)
        )


def engine_factory() -> Engine:
    return Engine(
        DataSource,
        {"": Preparator, "custom": CustomPreparator},
        {"als": ALSAlgorithm},
        {"": Serving, "filter": FilterServing},
        query_class=Query,
    )
