"""Two-tower retrieval engine (DASE components), port of
``predictionio_tpu/models/twotower/engine.py``.

Query ``{"user", "num"}`` -> ``{"itemScores": [{item, score}]}``, the
recommendation template's wire contract. The DataSource reads rate, buy and
view events of user -> item with their times; the algorithm trains
``model.train_two_tower`` on the context's device (with a history encoder
when ``historyLen > 0``) and serves one fused user tower -> u·itemsᵀ ->
``torch.topk`` per micro-batch, fetched once as a packed [B,2,k] tensor.

With an ANN index pinned on the model (``ann.lifecycle.ATTR``) the user
embedding feeds the clustered search instead of the corpus-wide product.

``mesh`` spreads the train over the job's ranks (``parallel.mesh``; its
size must be the number of ranks); without one, every rank of a job on
one ``data`` axis, and one device alone. A ``model`` axis of more than one
rank shards the user and item id tables over it, with or without
``contextParallel``, as the JAX template's mesh does; the persisted model
holds them whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.ann.lifecycle import ATTR as ANN_ATTR
from predictionio_tpu_torch.controller import (
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Engine,
    Params,
    SanityCheck,
    TorchAlgorithm,
)
from predictionio_tpu_torch.models.twotower.model import (
    TwoTower,
    TwoTowerConfig,
    build_history_matrix,
    train_two_tower,
)
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.parallel.mesh import make_mesh
from predictionio_tpu_torch.workflow.context import WorkflowContext


@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = 10

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Query":
        return Query(user=str(d["user"]), num=int(d.get("num", 10)))


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
    event_names: tuple[str, ...] = ("rate", "buy", "view")


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_idx: np.ndarray
    item_idx: np.ndarray
    user_vocab: list[str]
    item_vocab: list[str]
    timestamps: np.ndarray | None = None  # event times for history ordering

    def sanity_check(self) -> None:
        if len(self.user_idx) == 0:
            raise ValueError("no interaction events found; check app data")


class DataSource(BaseDataSource):
    params_class = DataSourceParams
    params: DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        col = ctx.p_event_store().to_columnar_cached(
            app_name=self.params.app_name or ctx.app_name,
            channel_name=ctx.channel_name,
            event_names=list(self.params.event_names),
            entity_type="user",
            target_entity_type="item",
        )
        valid = (col.entity_ids >= 0) & (col.target_ids >= 0)
        return TrainingData(
            col.entity_ids[valid],
            col.target_ids[valid],
            col.entity_vocab,
            col.target_vocab,
            timestamps=col.timestamps[valid],
        )


class Preparator(BasePreparator):
    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        return td


@dataclasses.dataclass(frozen=True)
class TwoTowerAlgorithmParams(Params):
    embed_dim: int = 64
    hidden: tuple[int, ...] = (128,)
    out_dim: int = 32
    temperature: float = 0.05
    learning_rate: float = 1e-3
    batch_size: int = 4096
    epochs: int = 5
    seed: int = 0
    # e.g. "data=-1,model=2" over the job's ranks (model > 1 shards the id
    # tables); empty = every rank on data
    mesh: str = ""
    # sequence encoder over each user's recent item history (kernel B2 on
    # the card, ops/attention.py); 0 disables
    history_len: int = 0
    n_heads: int = 2
    # sequence parallelism of the encoder over the mesh's model axis
    # (history_len % model == 0; ulysses also n_heads % model == 0)
    context_parallel: bool = False
    sp_impl: str = "ring"  # "ring" | "ulysses"


@dataclasses.dataclass
class TwoTowerModelState(SanityCheck):
    """The trained model: config, host parameters (the port's state_dict in
    numpy), the item-embedding table, vocabularies, losses and, with the
    encoder, the [n_users, T] history matrix. Blobs hold exactly these
    fields; a JAX-written blob's flax parameter tree converts on load."""

    config: TwoTowerConfig
    params: dict[str, np.ndarray]
    item_embeddings: np.ndarray
    user_vocab: list[str]
    item_vocab: list[str]
    losses: list[float]
    history: np.ndarray | None = None

    def __post_init__(self):
        self._reset()

    def _reset(self) -> None:
        self._user_index: dict[str, int] | None = None
        self._device_items: torch.Tensor | None = None
        self._module: TwoTower | None = None
        self.device: torch.device | str = "cuda"  # set by train and deploy

    def sanity_check(self) -> None:
        if not np.all(np.isfinite(self.item_embeddings)):
            raise ValueError("two-tower training produced non-finite embeddings")

    def user_index(self, user: str) -> int | None:
        if self._user_index is None:
            self._user_index = {u: i for i, u in enumerate(self.user_vocab)}
        return self._user_index.get(user)

    def module(self) -> TwoTower:
        """The network with the host parameters, on ``self.device`` once."""
        if self._module is None:
            model = TwoTower(self.config)
            # pio-lint: disable=serving-host-roundtrip -- host parameters of the model blob, copied to the card once per deploy
            model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in self.params.items()})
            self._module = model.to(self.device).eval()
        return self._module

    def device_items(self) -> torch.Tensor:
        if self._device_items is None:
            self._device_items = torch.tensor(
                np.asarray(self.item_embeddings, np.float32), device=self.device
            )
        return self._device_items

    @torch.no_grad()
    def embed_users_async(self, uidx, hist) -> torch.Tensor:
        """The user tower alone on a [B] batch of user indices ([B, T]
        histories with the encoder): the [B, out_dim] device tensor. The
        uploads copy, since the dispatcher reuses its staging buffers."""
        dev = torch.device(self.device)
        hist_d = topk.upload(hist, np.int64, dev) if hist is not None else None
        return self.module().embed_users(topk.upload(uidx, np.int64, dev), hist_d)

    @torch.no_grad()
    def serve_topk(self, uidx, hist, k: int) -> torch.Tensor:
        """User tower -> scores u·itemsᵀ -> top-k for a batch; returns the
        packed [B,2,k] handle (decode with ``ops.topk.fetch_topk``)."""
        u = self.embed_users_async(uidx, hist)
        s, i = torch.topk(u @ self.device_items().T, k, dim=1)
        return topk.pack_batch(s, i)

    def __getstate__(self):
        return {
            "config": self.config,
            "params": self.params,
            "item_embeddings": self.item_embeddings,
            "user_vocab": self.user_vocab,
            "item_vocab": self.item_vocab,
            "losses": self.losses,
            "history": self.history,
        }

    def __setstate__(self, state):
        from predictionio_tpu_torch.convert import is_flax_tree, twotower_params_from_numpy

        self.__dict__.update(state)
        self.__dict__.setdefault("history", None)  # pre-encoder blobs
        if is_flax_tree(self.params):  # written by the JAX package
            self.params = twotower_params_from_numpy(self.params)
        self._reset()


class TwoTowerAlgorithm(TorchAlgorithm):
    params_class = TwoTowerAlgorithmParams
    params: TwoTowerAlgorithmParams

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> TwoTowerModelState:
        mesh = make_mesh(self.params.mesh, ctx.device) if self.params.mesh else ctx.mesh
        config = TwoTowerConfig(
            n_users=max(len(pd.user_vocab), 1),
            n_items=max(len(pd.item_vocab), 1),
            embed_dim=self.params.embed_dim,
            hidden=tuple(self.params.hidden),
            out_dim=self.params.out_dim,
            temperature=self.params.temperature,
            learning_rate=self.params.learning_rate,
            batch_size=self.params.batch_size,
            epochs=self.params.epochs,
            seed=self.params.seed,
            history_len=self.params.history_len,
            n_heads=self.params.n_heads,
            context_parallel=self.params.context_parallel,
            sp_impl=self.params.sp_impl,
        )
        history = None
        if config.history_len > 0:
            history = build_history_matrix(
                pd.user_idx, pd.item_idx, pd.timestamps, config.n_users, config.history_len
            )
        result = train_two_tower(
            pd.user_idx, pd.item_idx, config, history=history, device=ctx.device,
            mesh=mesh if mesh.size > 1 else None,
        )
        model = TwoTowerModelState(
            config=config,
            params=result.params,
            item_embeddings=result.item_embeddings,
            user_vocab=pd.user_vocab,
            item_vocab=pd.item_vocab,
            losses=result.losses,
            history=history,
        )
        model.device = ctx.device
        return model

    def prepare_model(self, ctx: WorkflowContext, persisted: TwoTowerModelState) -> TwoTowerModelState:
        persisted.device = ctx.device
        persisted.module()  # weights and the item table onto the serving device now
        persisted.device_items()
        return persisted

    def predict(self, model: TwoTowerModelState, query: Query) -> PredictedResult:
        return self.predict_batch(model, [query])[0]

    def predict_batch(
        self, model: TwoTowerModelState, queries: Sequence[Query]
    ) -> list[PredictedResult]:
        return self.predict_batch_dispatch(model, queries)()

    def predict_batch_dispatch(self, model: TwoTowerModelState, queries: Sequence[Query]):
        """The micro-batch as one device program: user tower -> scores
        against the resident item table -> top-k, with user indices (and
        histories) staged in reused buffers and only [B, k] fetched in the
        finalize. Batch and k round up to powers of two; pad rows serve user
        0 and are dropped. Unknown users answer empty without the device.

        With an ANN index pinned, the user embedding (the tower, B2 in its
        history encoder) feeds the two-stage clustered search on the card
        instead of the product with every item. Exact stays the fallback
        (a k wider than the probe pool, counted) and the sampled shadow
        that measures live recall."""
        n = len(model.item_vocab)
        results: list[PredictedResult | None] = [None] * len(queries)
        rows: list[int] = []
        uidxs: list[int] = []
        max_num = 1
        for i, q in enumerate(queries):
            uidx = model.user_index(q.user)
            if uidx is None or q.num <= 0:
                results[i] = PredictedResult(())
                continue
            rows.append(i)
            uidxs.append(uidx)
            max_num = max(max_num, q.num)
        handle = ann = exact_handle = None
        kk = 0
        if rows:
            b = topk.next_pow2(len(rows))
            pool = topk.scratch()
            uidx_buf = pool.zeros("twotower.uidx", (b,), np.int32)
            uidx_buf[: len(rows)] = uidxs
            hist_buf = None
            if model.history is not None:
                hist_buf = pool.get(
                    "twotower.hist", (b, model.history.shape[1]), model.history.dtype
                )
                np.take(model.history, uidx_buf, axis=0, out=hist_buf)
            kk = min(topk.next_pow2(max_num), n)
            ann = getattr(model, ANN_ATTR, None)
            if ann is not None and not ann.supports(kk):
                ann.count_fallback(len(rows))
                ann = None
            if ann is not None:
                handle = ann.search_async(model.embed_users_async(uidx_buf, hist_buf), kk)
                if ann.take_recall_sample():
                    exact_handle = model.serve_topk(uidx_buf, hist_buf, kk)
            else:
                handle = model.serve_topk(uidx_buf, hist_buf, kk)

        def finalize() -> list[PredictedResult]:
            if handle is not None:
                if ann is not None:
                    scores, idx = ann.fetch(handle, rows=len(rows))
                    if exact_handle is not None:
                        _, exact_idx = topk.fetch_topk(exact_handle)
                        ann.record_recall(idx, exact_idx, rows=len(rows))
                else:
                    scores, idx = topk.fetch_topk(handle)
                for row, i in enumerate(rows):
                    num = min(queries[i].num, kk)
                    results[i] = PredictedResult(
                        tuple(
                            ItemScore(model.item_vocab[int(it)], float(s))
                            for s, it in zip(scores[row, :num], idx[row, :num])
                            if np.isfinite(s)
                        )
                    )
            return results  # type: ignore[return-value]

        return finalize

    def warmup_serving(self, model: TwoTowerModelState, max_batch: int) -> None:
        """One dispatch per power-of-two batch bucket at the default k; with
        an index pinned, the tower -> search composition as well (the exact
        path stays warm: it is the shadow and the fallback)."""
        kk = min(topk.next_pow2(10), len(model.item_vocab))
        ann = getattr(model, ANN_ATTR, None)

        def hist(b: int):
            if model.history is None:
                return None
            return np.zeros((b, model.history.shape[1]), model.history.dtype)

        topk.warmup_pow2_buckets(
            max_batch, lambda b: model.serve_topk(np.zeros(b, np.int32), hist(b), kk)
        )
        if ann is not None and ann.supports(kk):
            topk.warmup_pow2_buckets(
                max_batch,
                lambda b: ann.search_async(
                    model.embed_users_async(np.zeros(b, np.int32), hist(b)), kk)[0],
            )


class Serving(BaseServing):
    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


def engine_factory() -> Engine:
    return Engine(
        DataSource,
        Preparator,
        {"twotower": TwoTowerAlgorithm},
        Serving,
        query_class=Query,
    )
