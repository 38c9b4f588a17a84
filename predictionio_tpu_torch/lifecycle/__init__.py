"""The model lifecycle control plane: drift → retune → bake → promote →
warm, zero human commands (docs/lifecycle.md).

Layered like the autoscaler: :mod:`.policy` is the pure decision
engine (fake-clock testable, no I/O), :mod:`.controller` is the controller
that wires it to the telemetry ring, the eval grid, the registry, and
the incident recorder, and :mod:`.warm` replays bounded queries into the
result cache after a promote.

The port's own copy of ``predictionio_tpu/lifecycle/``.
"""

from predictionio_tpu_torch.lifecycle.controller import (
    LifecycleController,
    read_json_file,
    register_lifecycle_metrics,
    write_control,
)
from predictionio_tpu_torch.lifecycle.policy import (
    LifecycleConfig,
    LifecycleDecision,
    LifecycleInputs,
    LifecyclePolicy,
)
from predictionio_tpu_torch.lifecycle.tune import build_grid_tuner
from predictionio_tpu_torch.lifecycle.warm import build_warmer, replay_queries

__all__ = [
    "LifecycleConfig",
    "LifecycleController",
    "LifecycleDecision",
    "LifecycleInputs",
    "LifecyclePolicy",
    "build_grid_tuner",
    "build_warmer",
    "read_json_file",
    "register_lifecycle_metrics",
    "replay_queries",
    "write_control",
]
