"""The evaluation grid: parallel, resumable fold×params hyperparameter
search (port of ``predictionio_tpu/tuning/``).

The grid is an EngineParamsGenerator × k-fold splits
(:mod:`~predictionio_tpu_torch.tuning.grid`); each cell is trained and
scored through the offline mega-batch path (:meth:`Engine.dispatch_batch`,
:mod:`~predictionio_tpu_torch.tuning.cells`); finished cells land in a
durable JSONL trial ledger (:mod:`~predictionio_tpu_torch.tuning.ledger`),
so a killed run resumes retraining zero finished cells; the runner picks
the winner and can publish its refit to the model registry as a candidate
(:mod:`~predictionio_tpu_torch.tuning.runner`).
"""

from predictionio_tpu_torch.tuning.grid import (
    CellKey,
    EventStoreSplitter,
    GridSpec,
    build_cells,
    cell_id_of,
    clamp_folds,
)
from predictionio_tpu_torch.tuning.ledger import TrialLedger
from predictionio_tpu_torch.tuning.metrics import (
    NDCGAtK,
    PrecisionAtK,
    RecallAtK,
)
from predictionio_tpu_torch.tuning.runner import (
    CPU_FALLBACK_MAX_WORKERS,
    WORKER_CLASS_CPU_FALLBACK,
    EvalGridInstruments,
    GridReport,
    grid_evidence,
    grid_worker_env,
    register_eval_metrics,
    run_grid,
    worker_device,
)

__all__ = [
    "CPU_FALLBACK_MAX_WORKERS",
    "CellKey",
    "EvalGridInstruments",
    "EventStoreSplitter",
    "GridReport",
    "GridSpec",
    "NDCGAtK",
    "PrecisionAtK",
    "RecallAtK",
    "TrialLedger",
    "WORKER_CLASS_CPU_FALLBACK",
    "build_cells",
    "cell_id_of",
    "clamp_folds",
    "grid_evidence",
    "grid_worker_env",
    "register_eval_metrics",
    "run_grid",
    "worker_device",
]
