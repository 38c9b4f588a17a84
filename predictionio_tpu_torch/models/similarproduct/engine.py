"""Similar-product engine (DASE components), port of
``predictionio_tpu/models/similarproduct/engine.py``.

Query ``{items, num, categories?, categoryBlackList?, whiteList?,
blackList?}`` -> ``{"itemScores": [{item, score, ...}]}``. The DataSource
reads user -> item ``view`` and ``like`` events (and a rate event for the
train-with-rate-event variant) and the items' ``$set`` properties
(``categories``, and the returned properties of return-item-properties).
Algorithms:

  - ``als`` (views) and ``likealgo`` (likes): implicit ALS on the
    interaction counts, kernel B1 on the card; the item factors are
    L2-normalised, so a query scores every item by its summed cosine to
    the query items;
  - ``rateals``: explicit ALS on the latest rating per (user, item);
  - ``cooccurrence``: top-N cooccurring items per item, on the host.

A served micro-batch of the ALS algorithms is one device call
(``ops.topk.gather_sum_top_k_async``: gather, summed cosine, candidate
mask, top-k) fetched once. Not ported: the ANN lane of the JAX path (the
ANN slice); without a pinned index the JAX path never takes it.
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
    LocalAlgorithm,
    Params,
    SanityCheck,
    TorchAlgorithm,
)
from predictionio_tpu_torch.models.filters import CategoryIndex
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.ops.als import ALSConfig, als_train
from predictionio_tpu_torch.ops.cooccurrence import cooccurrence_top_n, score_by_cooccurrence
from predictionio_tpu_torch.workflow.context import WorkflowContext

DEFAULT_QUERY_NUM = 10


@dataclasses.dataclass(frozen=True)
class Query:
    items: tuple[str, ...]
    num: int = DEFAULT_QUERY_NUM
    categories: frozenset[str] | None = None
    category_black_list: frozenset[str] | None = None
    white_list: frozenset[str] | None = None
    black_list: frozenset[str] | None = None

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Query":
        def fset(key):
            v = d.get(key)
            return frozenset(v) if v is not None else None

        return Query(
            items=tuple(d["items"]),
            num=int(d.get("num", DEFAULT_QUERY_NUM)),
            categories=fset("categories"),
            category_black_list=fset("categoryBlackList"),
            white_list=fset("whiteList"),
            black_list=fset("blackList"),
        )


@dataclasses.dataclass(frozen=True)
class ItemScore:
    """``properties`` carries returned item attributes (return-item-properties
    variant), flattened into the wire dict beside ``item`` and ``score``."""

    item: str
    score: float
    properties: dict[str, Any] | None = None

    def to_json_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = dict(self.properties or {})
        out["item"] = self.item
        out["score"] = self.score
        return out


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...]

    def to_json_dict(self) -> dict[str, Any]:
        return {"itemScores": [s.to_json_dict() for s in self.item_scores]}


# ---------------------------------------------------------------------------
# DataSource
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    """``item_property_names``: properties returned with each item
    (return-item-properties); ``rate_event``: an event name whose
    ``rating`` feeds the train-with-rate-event variant, latest rating per
    (user, item) winning."""

    app_name: str = ""
    item_property_names: tuple[str, ...] = ()
    rate_event: str | None = None


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_vocab: list[str]
    item_vocab: list[str]
    item_categories: list[frozenset[str] | None]  # aligned with item_vocab
    view_user_idx: np.ndarray
    view_item_idx: np.ndarray
    like_user_idx: np.ndarray
    like_item_idx: np.ndarray
    item_properties: list[dict[str, Any] | None] | None = None
    rate_user_idx: np.ndarray | None = None
    rate_item_idx: np.ndarray | None = None
    rate_values: np.ndarray | None = None

    def sanity_check(self) -> None:
        n_rates = 0 if self.rate_user_idx is None else len(self.rate_user_idx)
        if len(self.view_user_idx) == 0 and len(self.like_user_idx) == 0 and n_rates == 0:
            raise ValueError("no view/like/rate events found; check app data")


class DataSource(BaseDataSource):
    params_class = DataSourceParams
    params: DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        store = ctx.store
        app_name = self.params.app_name or ctx.app_name
        event_names = ["view", "like"]
        if self.params.rate_event:
            event_names.append(self.params.rate_event)
        col = store.to_columnar(
            app_name, event_names=event_names, entity_type="user",
            target_entity_type="item", rating_key="rating",
        )
        item_vocab = list(col.target_vocab)
        item_index = {v: i for i, v in enumerate(item_vocab)}
        item_props = store.aggregate_properties(app_name, entity_type="item")
        categories: list[frozenset[str] | None] = [None] * len(item_vocab)
        wanted = self.params.item_property_names
        properties: list[dict[str, Any] | None] | None = (
            [None] * len(item_vocab) if wanted else None
        )
        for entity_id, pm in item_props.items():
            idx = item_index.get(entity_id)
            if idx is None:  # an item with properties and no events yet
                idx = item_index[entity_id] = len(item_vocab)
                item_vocab.append(entity_id)
                categories.append(None)
                if properties is not None:
                    properties.append(None)
            cats = pm.get_opt("categories")
            if cats is not None:
                categories[idx] = frozenset(cats)
            if properties is not None:
                properties[idx] = {
                    name: pm.get_opt(name) for name in wanted if pm.get_opt(name) is not None
                }
        names = np.asarray(col.event_names, dtype=object)
        views, likes = names == "view", names == "like"
        valid = (col.entity_ids >= 0) & (col.target_ids >= 0)
        rate_u = rate_i = rate_v = None
        if self.params.rate_event:
            sel = (names == self.params.rate_event) & valid & np.isfinite(col.ratings)
            # latest rating per (user, item) wins
            order = np.argsort(col.timestamps[sel], kind="stable")
            u, i, v = col.entity_ids[sel][order], col.target_ids[sel][order], col.ratings[sel][order]
            pairs = np.stack([u, i], 1)
            # np.unique keeps the FIRST occurrence; reverse so first == latest
            _, first = np.unique(pairs[::-1], axis=0, return_index=True)
            keep = len(u) - 1 - first
            rate_u, rate_i, rate_v = u[keep], i[keep], v[keep].astype(np.float32)
        return TrainingData(
            user_vocab=col.entity_vocab,
            item_vocab=item_vocab,
            item_categories=categories,
            view_user_idx=col.entity_ids[views & valid],
            view_item_idx=col.target_ids[views & valid],
            like_user_idx=col.entity_ids[likes & valid],
            like_item_idx=col.target_ids[likes & valid],
            item_properties=properties,
            rate_user_idx=rate_u,
            rate_item_idx=rate_i,
            rate_values=rate_v,
        )


class Preparator(BasePreparator):
    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        return td


# ---------------------------------------------------------------------------
# Models and filters
# ---------------------------------------------------------------------------


class _ItemCatalog:
    """Vocabulary lookups, category index and returned properties shared by
    the ALS and cooccurrence models."""

    item_vocab: list[str]
    item_categories: list[frozenset[str] | None]
    item_properties: list[dict[str, Any] | None] | None

    def _reset_catalog(self) -> None:
        self._index: dict[str, int] | None = None
        self._categories: CategoryIndex | None = None

    def item_index(self, item: str) -> int | None:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.item_vocab)}
        return self._index.get(item)

    def category_index(self) -> CategoryIndex:
        if self._categories is None:
            self._categories = CategoryIndex(self.item_categories)
        return self._categories

    def properties_of(self, i: int) -> dict[str, Any] | None:
        if self.item_properties is None:
            return None
        return self.item_properties[i]


@dataclasses.dataclass
class SimilarModel(_ItemCatalog, SanityCheck):
    item_factors: np.ndarray  # [n_items, f], L2-normalised rows
    item_vocab: list[str]
    item_categories: list[frozenset[str] | None]
    item_properties: list[dict[str, Any] | None] | None = None

    def __post_init__(self):
        self._reset()

    def _reset(self) -> None:
        self._reset_catalog()
        self._device_factors: torch.Tensor | None = None
        self.device: torch.device | str = "cuda"  # set by train and deploy

    def sanity_check(self) -> None:
        if not np.all(np.isfinite(self.item_factors)):
            raise ValueError("non-finite item factors")

    def device_factors(self) -> torch.Tensor:
        """The factor table on ``self.device``, uploaded once."""
        if self._device_factors is None:
            self._device_factors = topk.upload(self.item_factors, np.float32, self.device)
        return self._device_factors

    def __getstate__(self):
        # the JAX package's SimilarModel state, so blobs interchange
        return {
            "item_factors": self.item_factors,
            "item_vocab": self.item_vocab,
            "item_categories": self.item_categories,
            "item_properties": self.item_properties,
        }

    def __setstate__(self, state):
        state.setdefault("item_properties", None)
        self.__dict__.update(state)
        self._reset()


def candidate_mask(model: _ItemCatalog, query: Query, query_idx: list[int],
                   out: np.ndarray | None = None) -> np.ndarray:
    """The candidates of a query (ref isCandidateItem, ALSAlgorithm.scala:
    236-260): not a query item, on the white list, off the black list,
    sharing a category with ``categories`` (items without categories are
    dropped then), none in ``categoryBlackList``. ``out`` is a row of the
    batch's staging buffer to write into."""
    n = len(model.item_vocab)
    mask = np.ones(n, bool) if out is None else out
    mask[...] = True
    mask[query_idx] = False
    if query.white_list is not None:
        wl = np.zeros(n, bool)
        for it in query.white_list:
            idx = model.item_index(it)
            if idx is not None:
                wl[idx] = True
        mask &= wl
    if query.black_list is not None:
        for it in query.black_list:
            idx = model.item_index(it)
            if idx is not None:
                mask[idx] = False
    if query.categories is not None:
        mask &= model.category_index().any_of(query.categories)
    if query.category_black_list is not None:
        mask &= ~model.category_index().any_of(query.category_black_list)
    return mask


# ---------------------------------------------------------------------------
# Algorithms
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int | None = 3
    # "cg" | "cg_fused" (both kernel B1 on CUDA) | "cholesky"
    solver: str = "cg"


class _ALSBase(TorchAlgorithm):
    params_class = ALSAlgorithmParams
    params: ALSAlgorithmParams
    event_kind = "view"
    # set to a dict to receive als_train's timings decomposition of the next train
    timings: dict | None = None

    def _interactions(self, pd: TrainingData) -> tuple[np.ndarray, np.ndarray]:
        if self.event_kind == "view":
            return pd.view_user_idx, pd.view_item_idx
        return pd.like_user_idx, pd.like_item_idx

    def _config(self, implicit: bool) -> ALSConfig:
        return ALSConfig(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            reg=self.params.lambda_,
            implicit=implicit,
            alpha=self.params.alpha,
            seed=self.params.seed if self.params.seed is not None else 0,
            solver=self.params.solver,
        )

    def _build_model(self, ctx: WorkflowContext, item_factors: torch.Tensor,
                     pd: TrainingData) -> SimilarModel:
        """L2-normalise the rows for cosine scoring (host, as the JAX
        package does) and package them with the catalog."""
        vf = item_factors.cpu().numpy()
        norms = np.linalg.norm(vf, axis=1, keepdims=True)
        vf = vf / np.where(norms == 0, 1.0, norms)
        model = SimilarModel(vf, list(pd.item_vocab), list(pd.item_categories), pd.item_properties)
        model.device = ctx.device
        return model

    def _train_als(self, ctx, users, items, values, pd: TrainingData, implicit: bool):
        _, item_factors = als_train(
            users, items, values, len(pd.user_vocab), len(pd.item_vocab),
            self._config(implicit), timings=self.timings, device=ctx.device,
        )
        return self._build_model(ctx, item_factors, pd)

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> SimilarModel:
        users, items = self._interactions(pd)
        if len(users) == 0:
            raise ValueError(f"no {self.event_kind} events to train on")
        # interaction counts are the implicit ratings (ref trainImplicit on
        # counts); np.unique's row order is the ALS input order
        pair, counts = np.unique(np.stack([users, items], 1), axis=0, return_counts=True)
        return self._train_als(ctx, pair[:, 0], pair[:, 1], counts.astype(np.float32), pd, True)

    def prepare_model(self, ctx: WorkflowContext, persisted: SimilarModel) -> SimilarModel:
        persisted.device = ctx.device
        persisted.device_factors()  # the table onto the serving device now
        return persisted

    def predict(self, model: SimilarModel, query: Query) -> PredictedResult:
        return self.predict_batch(model, [query])[0]

    def predict_batch(self, model: SimilarModel, queries: Sequence[Query]) -> list[PredictedResult]:
        return self.predict_batch_dispatch(model, queries)()

    def predict_batch_dispatch(self, model: SimilarModel, queries: Sequence[Query]):
        """One device call for the micro-batch: query-item indices (pad
        slots at row 0 with weight 0) and candidate masks are staged in
        reused buffers, gather -> summed cosine -> mask -> top-k runs on
        the model's device, and the finalize fetches [B, 2, k] once. Batch,
        query width and k round up to powers of two."""
        n = len(model.item_vocab)
        results: list[PredictedResult | None] = [None] * len(queries)
        rows: list[int] = []
        row_qidx: list[list[int]] = []
        max_q = max_num = 1
        for i, q in enumerate(queries):
            qidx = [j for it in q.items if (j := model.item_index(it)) is not None]
            if not qidx or q.num <= 0:
                results[i] = PredictedResult(())
                continue
            rows.append(i)
            row_qidx.append(qidx)
            max_q = max(max_q, len(qidx))
            max_num = max(max_num, q.num)
        handle = None
        kk = 0
        if rows:
            b = topk.next_pow2(len(rows))
            qcap = topk.next_pow2(max_q)
            pool = topk.scratch()
            qidx_buf = pool.zeros("similar.qidx", (b, qcap), np.int32)
            qw_buf = pool.zeros("similar.qw", (b, qcap), np.float32)
            mask_buf = pool.get("similar.mask", (b, n), np.bool_)
            mask_buf[len(rows):] = True  # pad rows: a harmless full mask
            for row, (i, qidx) in enumerate(zip(rows, row_qidx)):
                qidx_buf[row, : len(qidx)] = qidx
                qw_buf[row, : len(qidx)] = 1.0
                candidate_mask(model, queries[i], qidx, out=mask_buf[row])
            kk = min(topk.next_pow2(max_num), n)
            handle = topk.gather_sum_top_k_async(model.device_factors(), qidx_buf, qw_buf,
                                                 mask_buf, kk)

        def finalize() -> list[PredictedResult]:
            if handle is not None:
                scores, idx = topk.fetch_topk(handle)
                for row, i in enumerate(rows):
                    num = min(queries[i].num, kk)
                    results[i] = PredictedResult(tuple(
                        ItemScore(model.item_vocab[int(it)], float(s), model.properties_of(int(it)))
                        for s, it in zip(scores[row, :num], idx[row, :num])
                        if np.isfinite(s)
                    ))
            return results  # type: ignore[return-value]

        return finalize

    def warmup_serving(self, model: SimilarModel, max_batch: int) -> None:
        """One launch of the single-item query per power-of-two batch bucket
        at the default k."""
        n = len(model.item_vocab)
        kk = min(topk.next_pow2(DEFAULT_QUERY_NUM), n)
        topk.warmup_pow2_buckets(
            max_batch,
            lambda b: topk.gather_sum_top_k_async(
                model.device_factors(), np.zeros((b, 1), np.int32),
                np.zeros((b, 1), np.float32), np.ones((b, n), bool), kk,
            ),
        )


class ALSAlgorithm(_ALSBase):
    event_kind = "view"


class LikeAlgorithm(_ALSBase):
    """ref LikeAlgorithm.scala — the same scoring, trained on like events."""

    event_kind = "like"


class RateALSAlgorithm(_ALSBase):
    """train-with-rate-event variant (ref ``train-with-rate-event/
    ALSAlgorithm.scala:66-129``): explicit ALS on the latest rating per
    (user, item) instead of implicit ALS on view counts."""

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> SimilarModel:
        if pd.rate_user_idx is None or len(pd.rate_user_idx) == 0:
            raise ValueError("no rate events to train on; set DataSourceParams.rate_event")
        return self._train_als(ctx, pd.rate_user_idx, pd.rate_item_idx, pd.rate_values, pd, False)


@dataclasses.dataclass(frozen=True)
class CooccurrenceParams(Params):
    n: int = 20  # top-N cooccurring items kept per item


@dataclasses.dataclass
class CooccurrenceModel(_ItemCatalog):
    top_map: dict[int, list[tuple[int, int]]]
    item_vocab: list[str]
    item_categories: list[frozenset[str] | None]
    item_properties: list[dict[str, Any] | None] | None = None

    def __post_init__(self):
        self._reset_catalog()

    def __getstate__(self):
        return {
            "top_map": self.top_map,
            "item_vocab": self.item_vocab,
            "item_categories": self.item_categories,
            "item_properties": self.item_properties,
        }

    def __setstate__(self, state):
        state.setdefault("item_properties", None)
        self.__dict__.update(state)
        self._reset_catalog()


class CooccurrenceAlgorithm(LocalAlgorithm):
    params_class = CooccurrenceParams
    params: CooccurrenceParams

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> CooccurrenceModel:
        top_map = cooccurrence_top_n(
            pd.view_user_idx, pd.view_item_idx, len(pd.item_vocab), self.params.n
        )
        return CooccurrenceModel(
            top_map, list(pd.item_vocab), list(pd.item_categories), pd.item_properties
        )

    def predict(self, model: CooccurrenceModel, query: Query) -> PredictedResult:
        query_idx = [i for it in query.items if (i := model.item_index(it)) is not None]
        scores = np.full(len(model.item_vocab), -np.inf)
        for i, s in score_by_cooccurrence(model.top_map, query_idx).items():
            scores[i] = s
        # the scores are host-born counts: the host ending
        sk, si = topk.host_top_k(scores, candidate_mask(model, query, query_idx), query.num)
        return PredictedResult(tuple(
            ItemScore(model.item_vocab[int(i)], float(s), model.properties_of(int(i)))
            for s, i in zip(sk, si)
        ))


class Serving(BaseServing):
    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


def engine_factory() -> Engine:
    return Engine(
        DataSource,
        Preparator,
        {
            "als": ALSAlgorithm,
            "cooccurrence": CooccurrenceAlgorithm,
            "likealgo": LikeAlgorithm,
            "rateals": RateALSAlgorithm,
        },
        Serving,
        query_class=Query,
    )
