"""Global cleanup hooks, run at the end of every train and evaluation (own
copy of ``predictionio_tpu/workflow/cleanup.py``; ref
``core/.../workflow/CleanupFunctions.scala:1-65``).

``run_train`` runs them in its ``finally`` on the coordinator and on every
other rank; ``run_grid_evaluation`` and ``run_evaluation`` run them when
they end, failed or not; ``pio shell`` runs them on exit. A hook that
raises is logged and the others still run.
"""

from __future__ import annotations

import logging
from typing import Callable

logger = logging.getLogger(__name__)


class CleanupFunctions:
    _fns: list[Callable[[], None]] = []

    @classmethod
    def add(cls, fn: Callable[[], None]) -> None:
        cls._fns.append(fn)

    @classmethod
    def run(cls) -> None:
        for fn in cls._fns:
            try:
                fn()
            except Exception:
                logger.exception("cleanup function failed")

    @classmethod
    def clear(cls) -> None:
        cls._fns.clear()
