"""Business-rule filters shared by the item templates (similar-product,
e-commerce): which items carry any of a set of categories.

The JAX package tests every item's category set in a Python loop per
query. Here a model keeps, per category, the indices of the items that
carry it, built once; a query's category filter is then one scatter per
named category. The result is the same boolean row.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class CategoryIndex:
    """Item indices by category over ``item_categories`` (aligned with the
    item vocabulary; None for an item without categories)."""

    def __init__(self, item_categories: Sequence[Iterable[str] | None]):
        self.n = len(item_categories)
        by_cat: dict[str, list[int]] = {}
        for i, cats in enumerate(item_categories):
            for c in cats or ():
                by_cat.setdefault(c, []).append(i)
        self._items = {c: np.asarray(v, np.int64) for c, v in by_cat.items()}

    def any_of(self, categories: Iterable[str]) -> np.ndarray:
        """[n] bool: items carrying at least one of ``categories``; items
        without categories never do."""
        hit = np.zeros(self.n, bool)
        for c in categories:
            idx = self._items.get(c)
            if idx is not None:
                hit[idx] = True
        return hit
