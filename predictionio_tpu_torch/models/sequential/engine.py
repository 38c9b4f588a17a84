"""Session / next-item engine (DASE components), port of
``predictionio_tpu/models/sequential/engine.py``.

Query ``{"user", "recentItems", "num"}`` -> ``{"itemScores": [{item, score}]}``.
The DataSource reads ``view`` events of user -> item from the store in its
total order (``LocalStore.iter_ordered``), so a session is the ingest
order. Two algorithms:

  - ``markov``: the e2 transition matrix over consecutive pairs
    (``e2.markov_chain.train_markov_chain``), served on the host through
    ``ops.topk.host_top_k``;
  - ``attention``: implicit ALS over the transition pairs factorises them
    into an input table (session side) and an output table (scoring side).
    A served batch gathers the window's input embeddings, runs one causal
    single-head ``ops.attention.fused_attention`` (kernel B2, or B3 at a
    long window), takes the last position as the session vector and ends
    in ``ops.topk.dot_top_k_async``: one matmul, mask and top-k, fetched
    once as a packed [B,2,k] tensor.

Not ported yet: ``read_eval`` (the eval slice) and the ANN lane of the
attention scorer (the ANN slice); without a pinned index the JAX path
never takes it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Iterator, Sequence

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
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.e2.markov_chain import MarkovChainModel, train_markov_chain
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.ops.als import ALSConfig, als_train
from predictionio_tpu_torch.ops.attention import fused_attention
from predictionio_tpu_torch.workflow.context import WorkflowContext

# ---------------------------------------------------------------------------
# Query / result
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Query:
    """``recentItems`` is the caller's session tail (most recent LAST);
    when absent, the model's stored last item for ``user`` answers."""

    user: str | None = None
    recent_items: tuple[str, ...] = ()
    num: int = 10

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Query":
        return Query(
            user=d.get("user"),
            recent_items=tuple(d.get("recentItems") or ()),
            num=int(d.get("num", 10)),
        )


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float

    def to_json_dict(self) -> dict[str, Any]:
        return {"item": self.item, "score": self.score}


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...]

    def to_json_dict(self) -> dict[str, Any]:
        return {"itemScores": [s.to_json_dict() for s in self.item_scores]}


@dataclasses.dataclass(frozen=True)
class ActualResult:
    """The user's true continuation (ordered) for eval folds."""

    items: tuple[str, ...]


# ---------------------------------------------------------------------------
# DataSource
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvalParams(Params):
    k_fold: int = 3
    query_num: int = 10
    # trailing items of each held-out session that become the actual
    # continuation (the prefix becomes the query's recentItems)
    holdout_tail: int = 2


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str
    channel_name: str | None = None
    event_names: tuple[str, ...] = ("view",)
    entity_type: str = "user"
    target_entity_type: str = "item"
    # page size and total-event bound of one ordered training read
    page: int = 2048
    max_events: int = 500_000
    # kept for the evaluation folds (read_eval is not ported yet)
    eval_params: EvalParams | None = None


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Ordered per-user sessions, dictionary-encoded: ``sequences[i]`` is
    user ``users[i]``'s item-index sequence in event order."""

    users: list[str]
    sequences: list[np.ndarray]
    item_vocab: list[str]

    def sanity_check(self) -> None:
        if len(self.users) != len(self.sequences):
            raise ValueError("users/sequences length mismatch")
        if not any(len(s) >= 2 for s in self.sequences):
            raise ValueError(
                "no session with >= 2 events — nothing to learn transitions from"
            )


def transition_coordinates(
    sequences: Sequence[np.ndarray],
) -> list[tuple[int, int, float]]:
    """Consecutive-pair (from, to, 1.0) coordinates, the form
    ``train_markov_chain`` consumes (it sums the duplicates itself)."""
    coords: list[tuple[int, int, float]] = []
    for seq in sequences:
        for a, b in zip(seq[:-1], seq[1:]):
            coords.append((int(a), int(b), 1.0))
    return coords


def sequences_from_events(
    events: Iterator[Event],
    *,
    event_names: Sequence[str],
    entity_type: str,
    target_entity_type: str,
    vocab: dict[str, int] | None = None,
) -> tuple[dict[str, list[int]], list[str]]:
    """Fold an ORDERED event iterator into per-user item-index sequences.
    The iterator's order IS the session order."""
    names = set(event_names)
    index: dict[str, int] = dict(vocab) if vocab else {}
    item_vocab: list[str] = [None] * len(index)  # type: ignore[list-item]
    for item, i in index.items():
        item_vocab[i] = item
    per_user: dict[str, list[int]] = {}
    for e in events:
        if e.event not in names or e.entity_type != entity_type:
            continue
        if e.target_entity_type != target_entity_type or e.target_entity_id is None:
            continue
        idx = index.get(e.target_entity_id)
        if idx is None:
            idx = len(item_vocab)
            index[e.target_entity_id] = idx
            item_vocab.append(e.target_entity_id)
        per_user.setdefault(e.entity_id, []).append(idx)
    return per_user, item_vocab


class DataSource(BaseDataSource):
    params_class = DataSourceParams
    params: DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        if self.params.channel_name is not None:
            raise ValueError("the port's LocalStore has no channels; drop channelName")
        events = ctx.store.iter_ordered(
            self.params.app_name, self.params.page, self.params.max_events
        )
        per_user, vocab = sequences_from_events(
            events,
            event_names=self.params.event_names,
            entity_type=self.params.entity_type,
            target_entity_type=self.params.target_entity_type,
        )
        users = sorted(per_user)
        return TrainingData(users, [np.asarray(per_user[u], np.int32) for u in users], vocab)

    def read_eval(self, ctx: WorkflowContext):
        raise NotImplementedError(
            "sequential read_eval (k-fold by user) is not ported yet; it comes "
            "with the port's eval and tuning slice"
        )


class Preparator(BasePreparator):
    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        return td


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SequentialModel(SanityCheck):
    """One model type serves both scorers: the Markov fields are always
    present; the attention tables when the attention algorithm trained.
    The pickled state is the JAX package's, so blobs interchange; the
    device tables and the serving device are dropped from it."""

    item_vocab: list[str]
    markov: MarkovChainModel | None = None
    # raw summed pair counts; the markov model is always rebuilt from these
    pair_counts: dict[tuple[int, int], float] = dataclasses.field(default_factory=dict)
    user_last: dict[str, int] = dataclasses.field(default_factory=dict)
    top_n: int = 10
    # attention scorer state (None for markov-only models)
    item_in: np.ndarray | None = None  # [n, f] session-side embeddings
    item_out: np.ndarray | None = None  # [n, f] scoring table
    context: int = 8

    def __post_init__(self):
        self._reset()

    def _reset(self) -> None:
        self._lock = threading.Lock()
        self._dev_in: torch.Tensor | None = None
        self._dev_out: torch.Tensor | None = None
        self._index: dict[str, int] | None = None
        self.device: torch.device | str = "cuda"  # set by train and deploy

    @property
    def item_factors(self) -> np.ndarray | None:
        return self.item_out

    def item_index(self) -> dict[str, int]:
        idx = self._index
        if idx is None or len(idx) != len(self.item_vocab):
            idx = self._index = {v: i for i, v in enumerate(self.item_vocab)}
        return idx

    def _device_table(self, name: str, host: np.ndarray | None) -> torch.Tensor | None:
        """The table on ``self.device``, built once under the model's lock:
        the dispatch thread and the fetch threads share the model."""
        with self._lock:
            table = getattr(self, name)
            if table is None and host is not None:
                table = torch.tensor(np.asarray(host, np.float32), device=self.device)
                setattr(self, name, table)
            return table

    def device_in(self) -> torch.Tensor | None:
        return self._device_table("_dev_in", self.item_in)

    def device_out(self) -> torch.Tensor | None:
        return self._device_table("_dev_out", self.item_out)

    def __getstate__(self):
        state = dict(self.__dict__)
        for k in ("_lock", "_dev_in", "_dev_out", "_index", "device"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._reset()

    def sanity_check(self) -> None:
        if not self.item_vocab:
            raise ValueError("empty item vocab")

    def session_indices(self, query: Query) -> list[int]:
        """The query's session tail as item indices: explicit
        ``recentItems`` win; a bare ``user`` falls back to the stored last
        item of their history."""
        idx = self.item_index()
        session = [idx[i] for i in query.recent_items if i in idx]
        if not session and query.user is not None:
            last = self.user_last.get(query.user)
            if last is not None:
                session = [last]
        return session


def build_markov(
    sequences: Sequence[np.ndarray], n_states: int, top_n: int
) -> tuple[MarkovChainModel, dict[tuple[int, int], float]]:
    """The transition model through ``train_markov_chain``, and the summed
    pair counts (which ``train_markov_chain``'s top-N cut loses)."""
    coords = transition_coordinates(sequences)
    counts: dict[tuple[int, int], float] = {}
    for i, j, c in coords:
        counts[(i, j)] = counts.get((i, j), 0.0) + c
    return train_markov_chain(coords, n_states, top_n), counts


def markov_from_counts(
    counts: dict[tuple[int, int], float], n_states: int, top_n: int
) -> MarkovChainModel:
    return train_markov_chain([(i, j, c) for (i, j), c in counts.items()], n_states, top_n)


def last_items(sequences: Sequence[np.ndarray], users: Sequence[str]) -> dict[str, int]:
    return {u: int(seq[-1]) for u, seq in zip(users, sequences) if len(seq)}


# ---------------------------------------------------------------------------
# Markov algorithm (host-born sparse scores -> host ending)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MarkovAlgorithmParams(Params):
    top_n: int = 10


class MarkovAlgorithm(LocalAlgorithm):
    """Transition-matrix next-item scorer. Its scores are at most top_n
    host-born transition probabilities, so ``topk.host_top_k`` ends it."""

    params_class = MarkovAlgorithmParams
    params: MarkovAlgorithmParams

    def train(self, ctx: WorkflowContext, td: TrainingData) -> SequentialModel:
        markov, counts = build_markov(td.sequences, len(td.item_vocab), self.params.top_n)
        return SequentialModel(
            item_vocab=list(td.item_vocab),
            markov=markov,
            pair_counts=counts,
            user_last=last_items(td.sequences, td.users),
            top_n=self.params.top_n,
        )

    def predict(self, model: SequentialModel, query: Query) -> PredictedResult:
        session = model.session_indices(query)
        if not session or model.markov is None:
            return PredictedResult(())
        n = len(model.item_vocab)
        scores = np.zeros(n, np.float64)
        for j, p in model.markov.transition_probs(session[-1]):
            if j < n:
                scores[j] = p
        mask = np.ones(n, bool)
        mask[np.asarray(session, np.int64)] = False
        mask &= scores > 0.0
        s, idx = topk.host_top_k(scores, mask, query.num)
        return PredictedResult(
            tuple(ItemScore(model.item_vocab[int(i)], float(v)) for v, i in zip(s, idx))
        )


# ---------------------------------------------------------------------------
# Attention algorithm (fused_attention encode -> fused top-k)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionAlgorithmParams(Params):
    rank: int = 32
    num_iterations: int = 10
    lambda_: float = 0.1
    seed: int = 3
    # the session window the encoder attends over
    context: int = 8
    top_n: int = 10


class AttentionAlgorithm(TorchAlgorithm):
    """Attention next-item scorer.

    Train: implicit ALS over the transition-pair matrix (kernel B1 solves
    its systems on the card) gives an input table and an output table.
    Serve: gather -> causal single-head ``fused_attention`` -> last
    position = session vector -> ``topk.dot_top_k_async``. The packed
    [B,2,k] result is the only fetch."""

    params_class = AttentionAlgorithmParams
    params: AttentionAlgorithmParams
    # set to a dict to receive the next train's wall-clock split: markov_s,
    # als_s and als_train's own decomposition
    timings: dict | None = None

    def train(self, ctx: WorkflowContext, td: TrainingData) -> SequentialModel:
        n = len(td.item_vocab)
        t0 = time.perf_counter()
        markov, counts = build_markov(td.sequences, n, self.params.top_n)
        from_idx = np.fromiter((i for i, _ in counts), np.int32, len(counts))
        to_idx = np.fromiter((j for _, j in counts), np.int32, len(counts))
        weight = np.fromiter(counts.values(), np.float32, len(counts))
        t1 = time.perf_counter()
        cfg = ALSConfig(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            reg=self.params.lambda_,
            implicit=True,
            seed=self.params.seed,
        )
        item_in, item_out = als_train(
            from_idx, to_idx, weight, n, n, cfg, timings=self.timings, device=ctx.device
        )
        model = SequentialModel(
            item_vocab=list(td.item_vocab),
            markov=markov,
            pair_counts=counts,
            user_last=last_items(td.sequences, td.users),
            top_n=self.params.top_n,
            item_in=item_in.cpu().numpy(),
            item_out=item_out.cpu().numpy(),
            context=self.params.context,
        )
        model.device = ctx.device
        if self.timings is not None:
            self.timings["markov_s"] = t1 - t0
            self.timings["als_s"] = time.perf_counter() - t1
        return model

    def prepare_model(self, ctx: WorkflowContext, persisted: SequentialModel) -> SequentialModel:
        persisted.device = ctx.device
        persisted.device_in()  # both tables onto the serving device now
        persisted.device_out()
        return persisted

    # ------------------------------------------------------------- serving
    @staticmethod
    def _encode(table: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
        """Gather the window's input embeddings and run one causal
        single-head attention pass; the last position's output is the
        session vector [B, f]. Left-pad slots repeat the window's oldest
        item: ``fused_attention`` has no key mask."""
        x = table[hist].unsqueeze(1)  # [B, H=1, L, f], contiguous
        out = fused_attention(x, x, x, causal=True)
        return out[:, 0, -1, :]

    def _stage_batch(self, model: SequentialModel, queries: Sequence[Query]):
        """Host staging: resolve sessions, right-align them in a [B, L]
        window buffer (left-padded with each row's oldest in-window item),
        and build the candidate mask that excludes session items."""
        pool = topk.scratch()
        b = len(queries)
        bb = topk.next_pow2(b)
        L = max(1, self.params.context)
        n = len(model.item_vocab)
        hist = pool.zeros("seq_hist", (bb, L), np.int64)
        mask = pool.full("seq_mask", (bb, n), bool, True)
        mask[b:, :] = False
        sessions: list[list[int]] = []
        for q_i, q in enumerate(queries):
            session = model.session_indices(q)
            sessions.append(session)
            window = session[-L:] if session else []
            if window:
                hist[q_i, :] = window[0]
                hist[q_i, L - len(window):] = window
                mask[q_i, np.asarray(session, np.int64)] = False
            else:
                mask[q_i, :] = False
        return hist, mask, sessions, bb

    def predict_batch_dispatch(self, model: SequentialModel, queries: Sequence[Query]):
        table_in = model.device_in()
        table_out = model.device_out()
        if table_in is None or table_out is None:
            # a markov-only model on the attention lane: the host scorer
            alg = MarkovAlgorithm(MarkovAlgorithmParams(top_n=model.top_n))
            results = [alg.predict(model, q) for q in queries]
            return lambda: results
        hist, mask, sessions, _ = self._stage_batch(model, queries)
        n = len(model.item_vocab)
        kk = min(topk.next_pow2(max(1, max(q.num for q in queries))), n)
        ctx_vec = self._encode(table_in, topk.upload(hist, np.int64, table_in.device))
        handle = topk.dot_top_k_async(table_out, ctx_vec, mask, kk)

        def finalize() -> list[PredictedResult]:
            scores, idx = topk.fetch_topk(handle)
            out: list[PredictedResult] = []
            for q_i, q in enumerate(queries):
                banned = set(sessions[q_i])
                picks: list[ItemScore] = []
                for v, i in zip(scores[q_i], idx[q_i]):
                    i = int(i)
                    if not np.isfinite(v) or i < 0 or i in banned:
                        continue
                    picks.append(ItemScore(model.item_vocab[i], float(v)))
                    if len(picks) >= q.num:
                        break
                out.append(PredictedResult(tuple(picks)))
            return out

        return finalize

    def predict_batch(self, model: SequentialModel, queries: Sequence[Query]) -> list[PredictedResult]:
        return self.predict_batch_dispatch(model, queries)()

    def predict(self, model: SequentialModel, query: Query) -> PredictedResult:
        return self.predict_batch(model, [query])[0]

    def warmup_serving(self, model: SequentialModel, max_batch: int) -> None:
        """One dispatch per power-of-two batch bucket, so the first burst
        after deploy finds every shape launched once."""
        if model.device_in() is None or not model.item_vocab:
            return
        probe = Query(recent_items=(model.item_vocab[0],), num=min(10, len(model.item_vocab)))
        topk.warmup_pow2_buckets(
            max_batch, lambda b: self.predict_batch_dispatch(model, [probe] * b)()
        )


# ---------------------------------------------------------------------------
# Serving / factory
# ---------------------------------------------------------------------------


class Serving(BaseServing):
    def serve(self, query: Query, predictions: Sequence[PredictedResult]):
        return predictions[0]


def engine_factory() -> Engine:
    return Engine(
        DataSource,
        Preparator,
        {"markov": MarkovAlgorithm, "attention": AttentionAlgorithm},
        Serving,
        query_class=Query,
    )
