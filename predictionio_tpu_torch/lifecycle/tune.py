"""The controller's production ``tune`` seam: one retune episode = one
eval-grid run on background-priority cpu-fallback workers, winner
published as a registry CANDIDATE.

Each episode gets its own sub-workdir (``run-0001``, ``run-0002``, …)
under the tuner's root — minted when the episode starts, reused on a
crash resume — so the grid's ledger semantics line up with the
controller's: ``tune(resume=False)`` is a fresh grid in a fresh dir,
``tune(resume=True)`` re-enters the SAME dir and the grid ledger skips
every finished cell. The current episode number lives in
``episode.json`` (tmp+rename), which is how a SIGKILLed controller finds
its way back to the half-finished grid.

The cells run as the cpu-fallback class. In the port that class also pins
an in-process grid (``workers=0``) to ``device="cpu"``, where the JAX
package pins only its worker processes' environment: the card stays free
for serving, and the answers are the same.

The port's own copy of ``predictionio_tpu/lifecycle/tune.py``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable

from predictionio_tpu_torch.lifecycle.controller import (
    _atomic_write_json,
    read_json_file,
)

logger = logging.getLogger("predictionio_tpu_torch.lifecycle")

EPISODE_FILE = "episode.json"


def build_grid_tuner(
    source: Any,
    *,
    workdir: str,
    engine_manifest: Any,
    registry_dir: str,
    storage: Any = None,
    workers: int = 2,
    nice: int = 10,
    folds: int | None = None,
    batch_size: int = 0,
    stage_mode: str = "canary",
    stage_fraction: float = 0.1,
    cwd: str = "",
    env: dict[str, str] | None = None,
    instruments: Any = None,
) -> Callable[[bool], str]:
    """A ``tune(resume) -> staged_version`` callable for
    :class:`~predictionio_tpu_torch.lifecycle.controller.LifecycleController`.

    The grid always runs ``publish=True`` (the whole point is a staged
    candidate), always on the cpu-fallback worker class (JAX_PLATFORMS
    pinned to cpu, worker count bounded), and always ``os.nice``'d —
    the retune is a background citizen of a serving host. ``storage``,
    when given, is the store the cells read their training data from."""
    from predictionio_tpu_torch.tuning.runner import (
        DEFAULT_CELL_BATCH,
        WORKER_CLASS_CPU_FALLBACK,
        run_grid,
    )
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    ctx = (
        WorkflowContext(mode="evaluation", device="cpu", _storage=storage)
        if storage is not None else None
    )

    def tune(resume: bool) -> str:
        os.makedirs(workdir, exist_ok=True)
        ep_path = os.path.join(workdir, EPISODE_FILE)
        state = read_json_file(ep_path) or {"episode": 0}
        if not resume or int(state.get("episode", 0)) == 0:
            state["episode"] = int(state.get("episode", 0)) + 1
            _atomic_write_json(ep_path, state)
        episode = int(state["episode"])
        run_dir = os.path.join(workdir, f"run-{episode:04d}")
        report = run_grid(
            source,
            workdir=run_dir,
            workers=workers,
            folds=folds,
            # within the episode dir, resume iff a ledger exists — a
            # crash before the first cell landed is just a fresh start
            resume=os.path.exists(os.path.join(run_dir, "ledger.jsonl")),
            batch_size=batch_size or DEFAULT_CELL_BATCH,
            data_span={"lifecycle": {"episode": episode}},
            publish=True,
            registry_dir=registry_dir,
            engine_manifest=engine_manifest,
            ctx=ctx,
            stage_mode=stage_mode,
            stage_fraction=stage_fraction,
            status_path=os.path.join(run_dir, "status.json"),
            instruments=instruments,
            cwd=cwd,
            env=env,
            nice=nice,
            worker_class=WORKER_CLASS_CPU_FALLBACK,
        )
        logger.info(
            "lifecycle tune episode %d: %d cells (%d skipped), winner %s",
            episode,
            report.cells_total,
            report.cells_skipped,
            report.published_version or "<none>",
        )
        return report.published_version

    return tune


__all__ = ["build_grid_tuner"]
