"""k-fold splitting helper (port of ``predictionio_tpu/e2/cross_validation.py``).

Reference parity: ``e2/.../evaluation/CrossValidation.scala:25-67``
(``CommonHelperFunctions.splitData``): fold membership by index modulo k,
yielding (training, testing) per fold.
"""

from __future__ import annotations

from typing import Sequence, TypeVar

T = TypeVar("T")


def k_fold_split(data: Sequence[T], k: int) -> list[tuple[list[T], list[T]]]:
    if k <= 0:
        raise ValueError("k must be positive")
    if k > len(data):
        # every fold past len(data) would have an EMPTY test split: its
        # metric scores 0/NaN and the degenerate cell can silently drag a
        # grid-search average (the evaluation grid clamps k with a warning
        # BEFORE calling this — predictionio_tpu_torch.tuning.grid.clamp_folds)
        raise ValueError(
            f"k={k} folds over {len(data)} records would yield empty test "
            f"folds; use k <= {len(data)} (tuning.grid.clamp_folds clamps)"
        )
    folds = []
    for fold in range(k):
        train = [x for i, x in enumerate(data) if i % k != fold]
        test = [x for i, x in enumerate(data) if i % k == fold]
        folds.append((train, test))
    return folds
