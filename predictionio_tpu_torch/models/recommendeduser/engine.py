"""Recommended-user engine: similar users from follow events (port of
``predictionio_tpu/models/recommendeduser/engine.py``).

Query ``{"users", "num", "whiteList"?, "blackList"?}`` ->
``{"similarUserScores": [{user, score}]}``. The DataSource reads ``follow``
events (user -> user); ALSAlgorithm trains implicit ALS on the (follower,
followed) counts (kernel B1 on the card) and L2-normalises the followed
users' factors. A query scores every followed user by its summed cosine to
the query users, never returning a query user. A served micro-batch is one
device call (``ops.topk.gather_sum_top_k_async``) fetched once.
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
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.ops.als import ALSConfig, als_train
from predictionio_tpu_torch.workflow.context import WorkflowContext

DEFAULT_QUERY_NUM = 10


@dataclasses.dataclass(frozen=True)
class Query:
    users: tuple[str, ...]
    num: int = DEFAULT_QUERY_NUM
    white_list: frozenset[str] | None = None
    black_list: frozenset[str] | None = None

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Query":
        def fset(key):
            v = d.get(key)
            return frozenset(str(x) for x in v) if v is not None else None

        return Query(
            users=tuple(str(u) for u in d["users"]),
            num=int(d.get("num", DEFAULT_QUERY_NUM)),
            white_list=fset("whiteList"),
            black_list=fset("blackList"),
        )


@dataclasses.dataclass(frozen=True)
class SimilarUserScore:
    user: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    similar_user_scores: tuple[SimilarUserScore, ...]

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "similarUserScores": [
                {"user": s.user, "score": s.score} for s in self.similar_user_scores
            ]
        }


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    follow_event: str = "follow"


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_vocab: list[str]  # followers
    followed_vocab: list[str]  # followed users (the scoring table)
    follower_idx: np.ndarray
    followed_idx: np.ndarray

    def sanity_check(self) -> None:
        if len(self.follower_idx) == 0:
            raise ValueError("no follow events found; check app data")


class DataSource(BaseDataSource):
    params_class = DataSourceParams
    params: DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        col = ctx.p_event_store().to_columnar_cached(
            app_name=self.params.app_name or ctx.app_name,
            channel_name=ctx.channel_name,
            event_names=[self.params.follow_event],
            entity_type="user",
            target_entity_type="user",
        )
        valid = (col.entity_ids >= 0) & (col.target_ids >= 0)
        return TrainingData(
            user_vocab=col.entity_vocab,
            followed_vocab=col.target_vocab,
            follower_idx=col.entity_ids[valid],
            followed_idx=col.target_ids[valid],
        )


class Preparator(BasePreparator):
    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        return td


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int | None = 3
    # "cg" | "cg_fused" (both kernel B1 on CUDA) | "cholesky"
    solver: str = "cg"


@dataclasses.dataclass
class SimilarUserModel(SanityCheck):
    followed_factors: np.ndarray  # [n_followed, f], L2-normalised rows
    followed_vocab: list[str]

    def __post_init__(self):
        self._reset()

    def _reset(self) -> None:
        self._index: dict[str, int] | None = None
        self._device_factors: torch.Tensor | None = None
        self.device: torch.device | str = "cuda"  # set by train and deploy

    def sanity_check(self) -> None:
        if not np.all(np.isfinite(self.followed_factors)):
            raise ValueError("non-finite followed-user factors")

    def user_index(self, user: str) -> int | None:
        if self._index is None:
            self._index = {u: i for i, u in enumerate(self.followed_vocab)}
        return self._index.get(user)

    def device_factors(self) -> torch.Tensor:
        """The factor table on ``self.device``, uploaded once."""
        if self._device_factors is None:
            self._device_factors = topk.upload(self.followed_factors, np.float32, self.device)
        return self._device_factors

    def __getstate__(self):
        # the JAX package's SimilarUserModel state, so blobs interchange
        return {"followed_factors": self.followed_factors, "followed_vocab": self.followed_vocab}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._reset()


class ALSAlgorithm(TorchAlgorithm):
    params_class = ALSAlgorithmParams
    params: ALSAlgorithmParams
    # set to a dict to receive als_train's timings decomposition of the next train
    timings: dict | None = None

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> SimilarUserModel:
        # follow counts are the implicit ratings; np.unique's row order is
        # the ALS input order
        pair, counts = np.unique(
            np.stack([pd.follower_idx, pd.followed_idx], 1), axis=0, return_counts=True
        )
        cfg = ALSConfig(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            reg=self.params.lambda_,
            implicit=True,
            alpha=self.params.alpha,
            seed=self.params.seed if self.params.seed is not None else 0,
            solver=self.params.solver,
        )
        _, followed_factors = als_train(
            pair[:, 0], pair[:, 1], counts.astype(np.float32),
            len(pd.user_vocab), len(pd.followed_vocab), cfg,
            timings=self.timings, device=ctx.device,
        )
        vf = followed_factors.cpu().numpy()
        norms = np.linalg.norm(vf, axis=1, keepdims=True)
        model = SimilarUserModel(vf / np.where(norms == 0, 1.0, norms), list(pd.followed_vocab))
        model.device = ctx.device
        return model

    def prepare_model(self, ctx: WorkflowContext, persisted: SimilarUserModel) -> SimilarUserModel:
        persisted.device = ctx.device
        persisted.device_factors()  # the table onto the serving device now
        return persisted

    @staticmethod
    def _candidate_mask(model: SimilarUserModel, query: Query, query_idx: list[int],
                        out: np.ndarray) -> None:
        """White list, black list and the query users themselves, written
        into a [n] row of the batch's staging buffer."""
        out[...] = True
        out[query_idx] = False  # never recommend the query users back
        if query.white_list is not None:
            wl = np.zeros(out.shape[0], bool)
            for u in query.white_list:
                idx = model.user_index(u)
                if idx is not None:
                    wl[idx] = True
            out &= wl
        if query.black_list is not None:
            for u in query.black_list:
                idx = model.user_index(u)
                if idx is not None:
                    out[idx] = False

    def predict(self, model: SimilarUserModel, query: Query) -> PredictedResult:
        return self.predict_batch(model, [query])[0]

    def predict_batch(self, model: SimilarUserModel, queries: Sequence[Query]) -> list[PredictedResult]:
        return self.predict_batch_dispatch(model, queries)()

    def predict_batch_dispatch(self, model: SimilarUserModel, queries: Sequence[Query]):
        """One device call per micro-batch: query-user indices (pad slots at
        row 0 with weight 0) and masks staged in reused buffers, the
        finalize fetches [B, 2, k] once."""
        n = len(model.followed_vocab)
        results: list[PredictedResult | None] = [None] * len(queries)
        rows: list[int] = []
        row_qidx: list[list[int]] = []
        max_q = max_num = 1
        for i, q in enumerate(queries):
            qidx = [j for u in q.users if (j := model.user_index(u)) is not None]
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
            qidx_buf = pool.zeros("recuser.qidx", (b, qcap), np.int32)
            qw_buf = pool.zeros("recuser.qw", (b, qcap), np.float32)
            mask_buf = pool.get("recuser.mask", (b, n), np.bool_)
            mask_buf[len(rows):] = True
            for row, (i, qidx) in enumerate(zip(rows, row_qidx)):
                qidx_buf[row, : len(qidx)] = qidx
                qw_buf[row, : len(qidx)] = 1.0
                self._candidate_mask(model, queries[i], qidx, mask_buf[row])
            kk = min(topk.next_pow2(max_num), n)
            handle = topk.gather_sum_top_k_async(model.device_factors(), qidx_buf, qw_buf,
                                                 mask_buf, kk)

        def finalize() -> list[PredictedResult]:
            if handle is not None:
                scores, idx = topk.fetch_topk(handle)
                for row, i in enumerate(rows):
                    num = min(queries[i].num, kk)
                    results[i] = PredictedResult(tuple(
                        SimilarUserScore(model.followed_vocab[int(u)], float(s))
                        for s, u in zip(scores[row, :num], idx[row, :num])
                        if np.isfinite(s)
                    ))
            return results  # type: ignore[return-value]

        return finalize

    def warmup_serving(self, model: SimilarUserModel, max_batch: int) -> None:
        n = len(model.followed_vocab)
        kk = min(topk.next_pow2(DEFAULT_QUERY_NUM), n)
        topk.warmup_pow2_buckets(
            max_batch,
            lambda b: topk.gather_sum_top_k_async(
                model.device_factors(), np.zeros((b, 1), np.int32),
                np.zeros((b, 1), np.float32), np.ones((b, n), bool), kk,
            ),
        )


class Serving(BaseServing):
    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


def engine_factory() -> Engine:
    return Engine(DataSource, Preparator, {"als": ALSAlgorithm}, Serving, query_class=Query)
