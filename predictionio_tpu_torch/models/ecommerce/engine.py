"""E-commerce recommendation engine (DASE components), port of
``predictionio_tpu/models/ecommerce/engine.py``.

Query ``{user, num, categories?, whiteList?, blackList?}`` ->
``{"itemScores": [{item, score}]}``. Training: implicit ALS on ``rate``
events weighted by their rating (kernel B1 on the card), and buy counts per
item for the popularity fallback. Serving:

  - a known user scores every item by the dot with its factor;
  - a cold user scores by the summed similarity to its last 10
    ``similarEvents`` items, read live from the store; without any, by buy
    popularity on the host;
  - the candidates drop the user's live ``seenEvents`` items
    (``unseenOnly``), the live ``unavailableItems`` constraint, and the
    query's white/black lists and categories; the ``adjust-score`` variant
    multiplies scores by the live ``weightedItems`` constraint.

Live reads go to the store of the context the model was trained or deployed
with (``model.ctx``), through a TTL cache that ``cacheTtlS`` = 0 (the
default, the reference's semantics) turns off. A failed store read is
logged and the query is served without that filter, as in the reference; no
device call is wrapped. A micro-batch of known users is one device call
(``ops.topk.dot_top_k_async``) fetched once.
"""

from __future__ import annotations

import dataclasses
import logging
import uuid
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
from predictionio_tpu_torch.models.filters import CategoryIndex
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.ops.als import ALSConfig, als_train
from predictionio_tpu_torch.utils.ttl_cache import TTLCache
from predictionio_tpu_torch.workflow.context import WorkflowContext

logger = logging.getLogger(__name__)

DEFAULT_QUERY_NUM = 10


@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = DEFAULT_QUERY_NUM
    categories: frozenset[str] | None = None
    white_list: frozenset[str] | None = None
    black_list: frozenset[str] | None = None

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Query":
        def fset(key):
            v = d.get(key)
            return frozenset(v) if v is not None else None

        return Query(
            user=str(d["user"]),
            num=int(d.get("num", DEFAULT_QUERY_NUM)),
            categories=fset("categories"),
            white_list=fset("whiteList"),
            black_list=fset("blackList"),
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
class DataSourceParams(Params):
    app_name: str = ""


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_vocab: list[str]
    item_vocab: list[str]
    item_categories: list[frozenset[str] | None]
    rate_user_idx: np.ndarray
    rate_item_idx: np.ndarray
    rate_values: np.ndarray
    buy_user_idx: np.ndarray
    buy_item_idx: np.ndarray

    def sanity_check(self) -> None:
        if len(self.rate_user_idx) == 0:
            raise ValueError("no rate events found; check app data")


class DataSource(BaseDataSource):
    params_class = DataSourceParams
    params: DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        store = ctx.p_event_store()
        app_name = self.params.app_name or ctx.app_name
        col = store.to_columnar_cached(
            app_name=app_name, channel_name=ctx.channel_name, event_names=["rate", "buy"],
            entity_type="user", target_entity_type="item", rating_key="rating",
        )
        item_vocab = list(col.target_vocab)
        item_index = {v: i for i, v in enumerate(item_vocab)}
        categories: list[frozenset[str] | None] = [None] * len(item_vocab)
        item_props = store.aggregate_properties(
            app_name=app_name, entity_type="item", channel_name=ctx.channel_name
        )
        for entity_id, pm in item_props.items():
            idx = item_index.get(entity_id)
            cats = pm.get_opt("categories")
            if idx is not None and cats is not None:
                categories[idx] = frozenset(cats)
        names = np.asarray(col.event_names, dtype=object)
        valid = (col.entity_ids >= 0) & (col.target_ids >= 0)
        rate_mask = (names == "rate") & valid & np.isfinite(col.ratings)
        buy_mask = (names == "buy") & valid
        return TrainingData(
            user_vocab=col.entity_vocab,
            item_vocab=item_vocab,
            item_categories=categories,
            rate_user_idx=col.entity_ids[rate_mask],
            rate_item_idx=col.target_ids[rate_mask],
            rate_values=col.ratings[rate_mask],
            buy_user_idx=col.entity_ids[buy_mask],
            buy_item_idx=col.target_ids[buy_mask],
        )


class Preparator(BasePreparator):
    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        return td


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    app_name: str = ""
    unseen_only: bool = False
    seen_events: tuple[str, ...] = ("buy", "view")
    similar_events: tuple[str, ...] = ("view",)
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int | None = 3
    # "cg" | "cg_fused" (both kernel B1 on CUDA) | "cholesky"
    solver: str = "cg"
    # adjust-score variant: read the weightedItems constraint per query
    adjust_score: bool = False
    # seconds a serving-time store read is reused; 0 reads live every query
    cache_ttl_s: float = 0.0


@dataclasses.dataclass
class ECommModel(SanityCheck):
    user_factors: np.ndarray  # [n_users, f]
    item_factors: np.ndarray  # [n_items, f]
    popular_counts: np.ndarray  # [n_items] buy counts
    user_vocab: list[str]
    item_vocab: list[str]
    item_categories: list[frozenset[str] | None]

    def __post_init__(self):
        self._reset()

    def _reset(self) -> None:
        self._user_index: dict[str, int] | None = None
        self._item_index: dict[str, int] | None = None
        self._categories: CategoryIndex | None = None
        self._device_items: torch.Tensor | None = None
        # values derived from this model (indices, weight rows) are cached
        # under this token, so a hot-swapped model never gets them
        self._cache_token = uuid.uuid4().hex
        # the train or deploy context: its device, store and app serve the
        # live reads (set by train and prepare_model)
        self.ctx: WorkflowContext | None = None

    def sanity_check(self) -> None:
        if not (np.all(np.isfinite(self.user_factors)) and np.all(np.isfinite(self.item_factors))):
            raise ValueError("non-finite ALS factors")

    def user_index(self, user: str) -> int | None:
        if self._user_index is None:
            self._user_index = {u: i for i, u in enumerate(self.user_vocab)}
        return self._user_index.get(user)

    def item_index(self, item: str) -> int | None:
        if self._item_index is None:
            self._item_index = {v: i for i, v in enumerate(self.item_vocab)}
        return self._item_index.get(item)

    def category_index(self) -> CategoryIndex:
        if self._categories is None:
            self._categories = CategoryIndex(self.item_categories)
        return self._categories

    def context(self) -> WorkflowContext:
        if self.ctx is None:
            raise RuntimeError(
                "the e-commerce model has no serving context; deploy it through "
                "ECommAlgorithm.prepare_model (or train it) first"
            )
        return self.ctx

    def device_items(self) -> torch.Tensor:
        """The item table on the context's device, uploaded once."""
        if self._device_items is None:
            self._device_items = topk.upload(self.item_factors, np.float32, self.context().device)
        return self._device_items

    def __getstate__(self):
        # the JAX package's ECommModel state, so blobs interchange
        return {
            "user_factors": self.user_factors,
            "item_factors": self.item_factors,
            "popular_counts": self.popular_counts,
            "user_vocab": self.user_vocab,
            "item_vocab": self.item_vocab,
            "item_categories": self.item_categories,
        }

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._reset()


class ECommAlgorithm(TorchAlgorithm):
    params_class = ECommAlgorithmParams
    params: ECommAlgorithmParams
    # set to a dict to receive als_train's timings decomposition of the next train
    timings: dict | None = None

    @property
    def lookup_cache(self) -> TTLCache:
        """The serving-time store reads of this algorithm (keys are
        namespaced tuples)."""
        cache = getattr(self, "_lookup_cache", None)
        if cache is None:
            cache = self._lookup_cache = TTLCache(ttl_s=self.params.cache_ttl_s)
        return cache

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> ECommModel:
        cfg = ALSConfig(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            reg=self.params.lambda_,
            implicit=True,
            alpha=self.params.alpha,
            seed=self.params.seed if self.params.seed is not None else 0,
            solver=self.params.solver,
        )
        uf, vf = als_train(
            pd.rate_user_idx, pd.rate_item_idx, pd.rate_values,
            len(pd.user_vocab), len(pd.item_vocab), cfg,
            timings=self.timings, device=ctx.device,
        )
        popular = np.bincount(pd.buy_item_idx, minlength=len(pd.item_vocab)).astype(np.float32)
        model = ECommModel(
            uf.cpu().numpy(), vf.cpu().numpy(), popular,
            list(pd.user_vocab), list(pd.item_vocab), list(pd.item_categories),
        )
        model.ctx = ctx
        return model

    def prepare_model(self, ctx: WorkflowContext, persisted: ECommModel) -> ECommModel:
        persisted.ctx = ctx
        persisted.device_items()  # the item table onto the serving device now
        return persisted

    # -- live store reads (ref ECommAlgorithm.scala:252-300) -----------------
    # The loaders raise on a store error; the fallback is applied outside
    # the cache, so only successful reads are cached.
    def _app(self, ctx: WorkflowContext) -> str:
        return self.params.app_name or ctx.app_name

    def _seen_items(self, ctx: WorkflowContext, user: str) -> set[str]:
        try:
            return self.lookup_cache.get_or_load(
                ("seen", user), lambda: self._seen_items_live(ctx, user)
            )
        except Exception:
            logger.exception("seen-items lookup failed; serving without filter")
            return set()

    def _seen_items_live(self, ctx: WorkflowContext, user: str) -> set[str]:
        events = ctx.l_event_store().find_by_entity(
            app_name=self._app(ctx), entity_type="user", entity_id=user,
            channel_name=ctx.channel_name, event_names=list(self.params.seen_events),
            limit=None,
        )
        return {e.target_entity_id for e in events if e.target_entity_id is not None}

    def _unavailable_items(self, ctx: WorkflowContext) -> set[str]:
        try:
            return self.lookup_cache.get_or_load(
                ("unavailable",), lambda: self._unavailable_items_live(ctx)
            )
        except Exception:
            logger.exception("unavailable-items lookup failed; assuming none")
            return set()

    def _unavailable_items_live(self, ctx: WorkflowContext) -> set[str]:
        """The latest $set on (constraint, unavailableItems)."""
        events = list(ctx.l_event_store().find_by_entity(
            app_name=self._app(ctx), entity_type="constraint", entity_id="unavailableItems",
            channel_name=ctx.channel_name, event_names=["$set"], limit=1,
        ))
        if events:
            items = events[0].properties.get("items")
            return set(items if items is not None else [])
        return set()

    def _item_weights(self, ctx: WorkflowContext, model: ECommModel) -> np.ndarray | None:
        try:
            return self.lookup_cache.get_or_load(
                ("weights", model._cache_token), lambda: self._item_weights_live(ctx, model)
            )
        except Exception:
            logger.exception("weightedItems lookup failed; weights ignored")
            return None

    def _item_weights_live(self, ctx: WorkflowContext, model: ECommModel) -> np.ndarray | None:
        """adjust-score (ref adjust-score/ECommAlgorithm.scala:56-58,
        256-263, 400-430): the latest $set on (constraint, weightedItems)
        carries ``weights``: [{"items": [...], "weight": w}]; listed items'
        scores are multiplied by w, the rest by 1. None when no constraint
        is set."""
        events = list(ctx.l_event_store().find_by_entity(
            app_name=self._app(ctx), entity_type="constraint", entity_id="weightedItems",
            channel_name=ctx.channel_name, event_names=["$set"], limit=1,
        ))
        if not events:
            return None
        groups = events[0].properties.get("weights") or []
        if not groups:
            return None
        weights = np.ones(len(model.item_vocab), np.float64)
        for group in groups:
            w = float(group.get("weight", 1.0))
            for it in group.get("items", []):
                idx = model.item_index(str(it))
                if idx is not None:
                    weights[idx] = w
        return weights

    def _recent_item_indices(self, ctx: WorkflowContext, model: ECommModel, user: str) -> list[int]:
        try:
            return self.lookup_cache.get_or_load(
                ("recent", model._cache_token, user),
                lambda: self._recent_item_indices_live(ctx, model, user),
            )
        except Exception:
            logger.exception("recent-items lookup failed")
            return []

    def _recent_item_indices_live(self, ctx: WorkflowContext, model: ECommModel,
                                  user: str) -> list[int]:
        """The items of the user's last 10 ``similarEvents`` (ref :302-320)."""
        events = ctx.l_event_store().find_by_entity(
            app_name=self._app(ctx), entity_type="user", entity_id=user,
            channel_name=ctx.channel_name, event_names=list(self.params.similar_events),
            limit=10,
        )
        out = []
        for e in events:
            if e.target_entity_id is not None:
                idx = model.item_index(e.target_entity_id)
                if idx is not None:
                    out.append(idx)
        return out

    def _candidate_mask(self, ctx: WorkflowContext, model: ECommModel, query: Query,
                        out: np.ndarray) -> None:
        """Business rules and query filters written into a [n] mask row:
        seen items, the unavailable constraint, white/black lists,
        category overlap (ref ECommAlgorithm.scala:243-330)."""
        n = len(model.item_vocab)
        out[...] = True
        if self.params.unseen_only:
            for it in self._seen_items(ctx, query.user):
                idx = model.item_index(it)
                if idx is not None:
                    out[idx] = False
        for it in self._unavailable_items(ctx):
            idx = model.item_index(it)
            if idx is not None:
                out[idx] = False
        if query.white_list is not None:
            wl = np.zeros(n, bool)
            for it in query.white_list:
                idx = model.item_index(it)
                if idx is not None:
                    wl[idx] = True
            out &= wl
        if query.black_list is not None:
            for it in query.black_list:
                idx = model.item_index(it)
                if idx is not None:
                    out[idx] = False
        if query.categories is not None:
            out &= model.category_index().any_of(query.categories)

    def _weights(self, ctx: WorkflowContext, model: ECommModel) -> np.ndarray | None:
        if not self.params.adjust_score:
            return None
        return self._item_weights(ctx, model)

    @staticmethod
    def _result_rows(model: ECommModel, scores: np.ndarray, idx: np.ndarray,
                     num: int) -> PredictedResult:
        return PredictedResult(tuple(
            ItemScore(model.item_vocab[int(i)], float(s))
            for s, i in zip(scores[:num], idx[:num])
            if np.isfinite(s)
        ))

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        return self.predict_with_context(model.context(), model, query)

    def predict_with_context(self, ctx: WorkflowContext, model: ECommModel,
                             query: Query) -> PredictedResult:
        n = len(model.item_vocab)
        mask = topk.scratch().get("ecomm.mask1", (1, n), np.bool_)
        self._candidate_mask(ctx, model, query, mask[0])
        weights = self._weights(ctx, model)
        kk = min(topk.next_pow2(min(query.num, n)), n)
        uidx = model.user_index(query.user)
        if uidx is not None:
            handle = topk.dot_top_k_async(
                model.device_items(), model.user_factors[uidx][None], mask, kk, weights=weights
            )
        else:
            recent = self._recent_item_indices(ctx, model, query.user)
            if not recent:
                # popularity: host-born counts, the host ending
                scores = model.popular_counts.astype(np.float64)
                if weights is not None:
                    scores = scores * weights
                sk, si = topk.host_top_k(scores, mask[0], min(query.num, n))
                return self._result_rows(model, sk, si, len(si))
            handle = topk.gather_sum_top_k_async(
                model.device_items(), np.asarray(recent, np.int32)[None],
                np.ones((1, len(recent)), np.float32), mask, kk, weights=weights,
            )
        scores, idx = topk.fetch_topk(handle)
        return self._result_rows(model, scores[0], idx[0], min(query.num, kk))

    def predict_batch(self, model: ECommModel, queries: Sequence[Query]) -> list[PredictedResult]:
        return self.predict_batch_dispatch(model, queries)()

    def predict_batch_dispatch(self, model: ECommModel, queries: Sequence[Query]):
        """Every known user of the micro-batch rides one device call (user
        vectors and mask rows staged in reused buffers); cold users answer
        one by one in the finalize."""
        ctx = model.context()
        n = len(model.item_vocab)
        results: list[PredictedResult | None] = [None] * len(queries)
        rows: list[int] = []
        row_uidx: list[int] = []
        cold: list[int] = []
        max_num = 1
        for i, q in enumerate(queries):
            if q.num <= 0:
                results[i] = PredictedResult(())
                continue
            uidx = model.user_index(q.user)
            if uidx is None:
                cold.append(i)
                continue
            rows.append(i)
            row_uidx.append(uidx)
            max_num = max(max_num, q.num)
        handle = None
        kk = 0
        if rows:
            weights = self._weights(ctx, model)
            b = topk.next_pow2(len(rows))
            pool = topk.scratch()
            vec_buf = pool.zeros("ecomm.vecs", (b, model.user_factors.shape[1]), np.float32)
            np.take(model.user_factors, np.asarray(row_uidx, np.int64), axis=0,
                    out=vec_buf[: len(rows)])
            mask_buf = pool.get("ecomm.mask", (b, n), np.bool_)
            mask_buf[len(rows):] = True
            for row, i in enumerate(rows):
                self._candidate_mask(ctx, model, queries[i], mask_buf[row])
            kk = min(topk.next_pow2(max_num), n)
            handle = topk.dot_top_k_async(model.device_items(), vec_buf, mask_buf, kk,
                                          weights=weights)

        def finalize() -> list[PredictedResult]:
            for i in cold:
                results[i] = self.predict_with_context(ctx, model, queries[i])
            if handle is not None:
                scores, idx = topk.fetch_topk(handle)
                for row, i in enumerate(rows):
                    results[i] = self._result_rows(
                        model, scores[row], idx[row], min(queries[i].num, kk)
                    )
            return results  # type: ignore[return-value]

        return finalize

    def warmup_serving(self, model: ECommModel, max_batch: int) -> None:
        """One launch per power-of-two batch bucket at the default k, for
        both score endings when adjust-score may weigh them; one store read,
        so that the store's connection and the app lookup are warm at
        deploy and not on the first query."""
        ctx = model.context()
        list(ctx.l_event_store().find_by_entity(
            app_name=self._app(ctx), entity_type="constraint", entity_id="unavailableItems",
            channel_name=ctx.channel_name, limit=1,
        ))
        n = len(model.item_vocab)
        f = model.user_factors.shape[1]
        kk = min(topk.next_pow2(DEFAULT_QUERY_NUM), n)
        variants: list[np.ndarray | None] = [None]
        if self.params.adjust_score:
            variants.append(np.ones(n, np.float32))
        for weights in variants:
            topk.warmup_pow2_buckets(
                max_batch,
                lambda b, w=weights: topk.dot_top_k_async(
                    model.device_items(), np.zeros((b, f), np.float32),
                    np.ones((b, n), bool), kk, weights=w,
                ),
            )


class Serving(BaseServing):
    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


def engine_factory() -> Engine:
    return Engine(DataSource, Preparator, {"ecomm": ECommAlgorithm}, Serving, query_class=Query)
