"""Entry-point declarations and reachability over the project call graph.

Rules no longer ask "does this file match a glob and this function match a
name list" — they ask "is this function *reachable* from a declared entry
point of category X". The LintConfig carries a tuple of ``EntryPoint``
declarations; everything a declared entry transitively calls inherits its
category, so a host sync three helpers below ``predict_batch_dispatch``
fires even though no glob names the helper's module.

Edge policy per category (see callgraph.py):

  - CALL edges always propagate.
  - NESTED edges (lexical containment) propagate for every category EXCEPT
    ``async-loop``: serving dispatch returns ``finalize`` closures that run
    on the serving path, so nested defs of a serving-reachable function are
    serving-reachable; but the fleet's executor-delegate pattern
    (``def _work(): blocking(); await loop.run_in_executor(None, _work)``)
    is precisely a nested def whose body is ALLOWED to block — async-loop
    reachability must not flow into it.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
from collections import deque
from typing import Iterable, Iterator

from .callgraph import FunctionNode, ProjectGraph

__all__ = [
    "EntryPoint",
    "Reachability",
    "CATEGORY_SERVING",
    "CATEGORY_PREDICT",
    "CATEGORY_TRAIN",
    "CATEGORY_EVAL",
    "CATEGORY_ASYNC",
    "glob_matches_path",
    "short_path",
]

CATEGORY_SERVING = "serving"
CATEGORY_PREDICT = "predict"
CATEGORY_TRAIN = "train"
CATEGORY_EVAL = "eval-scoring"
CATEGORY_ASYNC = "async-loop"

# categories whose reachability does NOT flow through lexical containment
_NO_NESTED = frozenset({CATEGORY_ASYNC})


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One declared root of a rule category.

    ``module_glob`` matches the file path (fnmatch, ``/``-normalized —
    ``*`` crosses separators, so ``*/tuning/*.py`` works for installed
    paths and fixture trees alike). ``function`` matches the function's
    bare name or qualname (``*`` = every def in the module).
    ``async_only`` restricts seeding to ``async def``s.
    """

    category: str
    module_glob: str
    function: str = "*"
    async_only: bool = False


def short_path(path: str) -> str:
    """Cwd-relative when that doesn't escape upward, else unchanged."""
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


def glob_matches_path(path: str, glob: str) -> bool:
    """Same semantics as core.matches_any_glob: fnmatch on the
    ``/``-normalized path (``*`` crosses separators, so ``*/api/*.py``
    matches any depth)."""
    return fnmatch.fnmatch(path.replace("\\", "/"), glob)


class Reachability:
    """Per-category reachable sets with origin-entry tracking."""

    def __init__(
        self,
        graph: ProjectGraph,
        entry_points: Iterable[EntryPoint],
    ) -> None:
        self.graph = graph
        self.entry_points = tuple(entry_points)
        # category -> {function key -> entry key it was first reached from}
        self._reach: dict[str, dict[str, str]] = {}
        for category in {ep.category for ep in self.entry_points}:
            self._reach[category] = self._compute(category)

    # ------------------------------------------------------------ seeding
    def _seeds(self, category: str) -> list[str]:
        eps = [ep for ep in self.entry_points if ep.category == category]
        path_eps: dict[str, list[EntryPoint]] = {}
        seeds = []
        for fn in self.graph.functions.values():
            matching = path_eps.get(fn.path)
            if matching is None:
                matching = [
                    ep
                    for ep in eps
                    if glob_matches_path(fn.path, ep.module_glob)
                ]
                path_eps[fn.path] = matching
            for ep in matching:
                if ep.async_only and not fn.is_async:
                    continue
                if not (
                    fnmatch.fnmatch(fn.name, ep.function)
                    or fnmatch.fnmatch(fn.qualname, ep.function)
                ):
                    continue
                seeds.append(fn.key)
                break
        return seeds

    def _compute(self, category: str) -> dict[str, str]:
        follow_nested = category not in _NO_NESTED
        reached: dict[str, str] = {}
        queue: deque[tuple[str, str]] = deque()
        for seed in self._seeds(category):
            if seed not in reached:
                reached[seed] = seed
                queue.append((seed, seed))
        while queue:
            key, origin = queue.popleft()
            nexts: set[str] = set(self.graph.callees(key))
            if follow_nested:
                nexts |= self.graph.nested.get(key, set())
            for nxt in nexts:
                if nxt not in reached and nxt in self.graph.functions:
                    reached[nxt] = origin
                    queue.append((nxt, origin))
        return reached

    # ------------------------------------------------------------ queries
    def categories(self, key: str) -> frozenset[str]:
        return frozenset(
            cat for cat, reached in self._reach.items() if key in reached
        )

    def is_reachable(self, key: str, category: str) -> bool:
        return key in self._reach.get(category, ())

    def origin(self, key: str, category: str) -> FunctionNode | None:
        """The declared entry this function was first reached from."""
        entry_key = self._reach.get(category, {}).get(key)
        if entry_key is None:
            return None
        return self.graph.functions.get(entry_key)

    def iter_reachable_in_file(
        self, path: str, category: str
    ) -> Iterator[tuple[FunctionNode, FunctionNode | None]]:
        """(function, origin-entry) pairs for reachable functions defined
        in ``path``; origin is None when the function IS a seed."""
        reached = self._reach.get(category, {})
        for fn in self.graph.functions_in(path):
            entry_key = reached.get(fn.key)
            if entry_key is None:
                continue
            if entry_key == fn.key:
                yield fn, None
            else:
                yield fn, self.graph.functions.get(entry_key)

    def reach_note(self, fn: FunctionNode, origin: FunctionNode | None) -> str:
        """Message suffix explaining WHY a function is in scope: empty for
        a declared entry itself, the originating entry otherwise."""
        if origin is None:
            return ""
        return (
            f"; reachable from entry point {origin.qualname!r} "
            f"({short_path(origin.path)}:{origin.lineno})"
        )

    def entry_module_globs(self, category: str) -> tuple[str, ...]:
        """The module globs declared for a category — used by rules that
        also scan module-level statements (reachability is def-scoped)."""
        return tuple(
            ep.module_glob
            for ep in self.entry_points
            if ep.category == category
        )
