"""Grid construction: EngineParamsGenerator × k-fold splits → content-
addressed cells (port of ``predictionio_tpu/tuning/grid.py``).

A *cell* is one (engine-params, fold) pair: the unit of work the scheduler
trains and scores independently, and the unit of resume in the trial
ledger. Cell ids are sha256 over (canonical params JSON, fold index, fold
count, data-span identity), so the same grid over the same data always
names the same cells, and any change to params, fold layout or data span
re-keys them. The ids equal the JAX package's for the same grid, so a
ledger written by either package resumes in the other.

Fold sources:

- **Data-source parity** (default): the engine's own ``read_eval`` decides
  the folds (e.g. the recommendation template's ``EvalParams.k_fold``).
- **Event store**: :class:`EventStoreSplitter` folds *users* by a sticky
  sha256 bucket (:func:`sticky_bucket`) over the ``find_after`` order, so
  held-out queries stream off bounded pages: only the held-out fold's
  user→items map lives on the host.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from typing import Any, Callable, Iterator, Sequence

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.data.storage.base import event_seq_key

logger = logging.getLogger(__name__)

DEFAULT_FOLD_SALT = "pio-eval"


def sticky_bucket(key: str, salt: str = "") -> float:
    """Map a key to ``[0, 1)`` by sha256 (own copy of
    ``predictionio_tpu/registry/router.py:sticky_bucket``): stable across
    processes and restarts, unlike ``hash()``."""
    digest = hashlib.sha256(f"{salt}:{key}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


def clamp_folds(k: int, n_records: int, what: str = "records") -> int:
    """Clamp a requested fold count to the data size, warning when it
    moves: ``--folds 10`` over a 6-user corpus degrades loudly to 6 folds
    instead of scoring empty test folds as 0/NaN."""
    if k <= 0:
        raise ValueError(f"fold count must be positive, got {k}")
    if n_records <= 0:
        raise ValueError(f"cannot fold zero {what}")
    if k > n_records:
        logger.warning(
            "clamping k=%d folds to %d (only %d %s; empty test folds "
            "would score as degenerate cells)",
            k,
            n_records,
            n_records,
            what,
        )
        return n_records
    return k


def _canonical(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), default=str)


def params_json_of(ep: EngineParams) -> dict[str, str]:
    """The canonical flat params JSON (what :func:`params_hash_of` and the
    cell ids hash)."""
    return Engine.engine_params_to_json(ep)


def cell_id_of(
    ep: EngineParams, fold: int, n_folds: int, data_span: dict[str, Any] | None
) -> str:
    """Content-addressed cell id: params × fold × data span.

    The flat params JSON carries algorithm names but NOT the other three
    component names — two params sets differing only in, say, the serving
    component would otherwise collide to one id and silently share ledger
    records (one of them scored on the other's cells). The component
    names are part of the identity."""
    payload = _canonical(
        {
            "components": {
                "dataSource": ep.data_source[0],
                "preparator": ep.preparator[0],
                "serving": ep.serving[0],
            },
            "params": params_json_of(ep),
            "fold": fold,
            "folds": n_folds,
            "dataSpan": data_span or {},
        }
    )
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class CellKey:
    """One grid cell's identity."""

    cell_id: str
    params_index: int
    fold: int


@dataclasses.dataclass
class GridSpec:
    """The whole search: candidate params × folds × data identity.

    ``folds`` is the fold count the cells are enumerated against; ``None``
    means "discover from the data source's ``read_eval``" (the runner
    probes once). ``data_span`` is any JSON-able identity of the data the
    folds are cut from (app name, event span, snapshot id) — it only
    feeds the cell ids, so two grids over different spans never share
    ledger entries.
    """

    params_list: list[EngineParams]
    folds: int | None = None
    data_span: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.params_list:
            raise ValueError("grid needs at least one EngineParams")
        if self.folds is not None and self.folds <= 0:
            raise ValueError(f"folds must be positive, got {self.folds}")


def build_cells(spec: GridSpec, n_folds: int) -> list[CellKey]:
    """Enumerate the grid's cells, params-major (fold-minor) so cells that
    share an algorithm-params prefix run adjacently — the order the
    worker-side model cache is bounded around (cells.py clears the model
    cache between params groups)."""
    cells: list[CellKey] = []
    for pi, ep in enumerate(spec.params_list):
        for fold in range(n_folds):
            cells.append(
                CellKey(cell_id_of(ep, fold, n_folds, spec.data_span), pi, fold)
            )
    return cells


# ---------------------------------------------------------------------------
# event-store splitter
# ---------------------------------------------------------------------------


class EventStoreSplitter:
    """Fold users by sticky hash over the event store's ``find_after``
    ordering.

    Assignment is ``int(sticky_bucket(user, salt) * k)``: deterministic
    across processes, restarts and the two packages, so a resumed grid and
    every pool worker agree on fold membership without shared state. Training-side consumers get a user *predicate*
    (``keep_for_training(fold)``) to filter whatever representation they
    read; held-out (query, actual) pairs stream off bounded
    ``find_after`` pages — the only host-side materialization is the
    held-out fold's user→items map (~1/k of users).
    """

    def __init__(
        self,
        levents: Any,
        app_id: int,
        k: int,
        channel_id: int | None = None,
        *,
        num: int = 10,
        entity_type: str = "user",
        event_names: Sequence[str] | None = None,
        salt: str = DEFAULT_FOLD_SALT,
        page: int = 2048,
    ):
        if k <= 0:
            raise ValueError(f"fold count must be positive, got {k}")
        self.levents = levents
        self.app_id = app_id
        self.channel_id = channel_id
        self.k = k
        self.num = num
        self.entity_type = entity_type
        self.event_names = frozenset(event_names) if event_names else None
        self.salt = salt
        self.page = page

    def fold_of(self, user_id: str) -> int:
        return int(sticky_bucket(str(user_id), self.salt) * self.k)

    def keep_for_training(self, fold: int) -> Callable[[str], bool]:
        """Predicate over user ids: True when the user trains in ``fold``
        (i.e. is NOT held out there)."""
        return lambda user_id: self.fold_of(user_id) != fold

    def _iter_events(self) -> Iterator[Any]:
        head = self.levents.seq_head(self.app_id, self.channel_id)
        if head is None:
            return
        cursor: tuple[int, str] | None = None
        while True:
            events = self.levents.find_after(
                self.app_id,
                channel_id=self.channel_id,
                cursor=cursor,
                limit=self.page,
            )
            if not events:
                return
            cursor = event_seq_key(events[-1])
            for e in events:
                if event_seq_key(e) > head:
                    # bound at the head as of iteration start: a grid run
                    # next to a live ingest means "users known when the
                    # split was cut", not a moving target
                    return
                yield e

    def iter_ordered(self) -> Iterator[Any]:
        """Ordered pass over the split's event window, the same
        head-bounded pager the fold views use (the sequential template's
        ``read_eval`` needs ordered sessions, which :meth:`iter_heldout`
        discards)."""
        return self._iter_events()

    def iter_heldout(
        self, fold: int
    ) -> Iterator[tuple[dict[str, Any], set[str]]]:
        """Stream ``({"user", "num"}, actual_item_set)`` pairs for the
        held-out users of ``fold``. Pages are bounded; the accumulated
        state is the held-out fold's user→items map only."""
        if not 0 <= fold < self.k:
            raise ValueError(f"fold {fold} out of range [0, {self.k})")
        actuals: dict[str, set[str]] = {}
        for e in self._iter_events():
            if e.entity_type != self.entity_type or not e.entity_id:
                continue
            if self.event_names is not None and e.event not in self.event_names:
                continue
            if self.fold_of(e.entity_id) != fold:
                continue
            items = actuals.setdefault(e.entity_id, set())
            if e.target_entity_id:
                items.add(str(e.target_entity_id))
        for user_id in sorted(actuals):
            yield {"user": user_id, "num": self.num}, actuals[user_id]

    def heldout_fold(
        self, fold: int
    ) -> tuple[list[dict[str, Any]], list[set[str]]]:
        """Materialized convenience view of :meth:`iter_heldout`."""
        queries: list[dict[str, Any]] = []
        actual_sets: list[set[str]] = []
        for q, a in self.iter_heldout(fold):
            queries.append(q)
            actual_sets.append(a)
        return queries, actual_sets

    def fold_sizes(self) -> list[int]:
        """Distinct held-out users per fold (one streaming pass; only the
        dedup id set on the host)."""
        seen: set[str] = set()
        sizes = [0] * self.k
        for e in self._iter_events():
            if e.entity_type != self.entity_type or not e.entity_id:
                continue
            if self.event_names is not None and e.event not in self.event_names:
                continue
            if e.entity_id in seen:
                continue
            seen.add(e.entity_id)
            sizes[self.fold_of(e.entity_id)] += 1
        return sizes
