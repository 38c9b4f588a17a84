"""Model registry + progressive rollout.

The reference's lifecycle stops at "persist the trained blob, reload the
latest COMPLETED instance" (``CreateServer.scala`` MasterActor reload).
This package is the subsystem that makes a bad train unable to take down
serving:

- :mod:`.manifest` — self-describing lineage manifests (engine identity,
  params hash, parent version, train metrics, blob checksum);
- :mod:`.store` — content-addressed, sha256-verified artifact store with
  a rollout state machine (stable/candidate/history) and GC;
- :mod:`.router` — serving-lane snapshots: a pinned *stable* version plus
  a *candidate* taking a sticky-hashed canary fraction or shadow traffic;
- :mod:`.controller` — compares candidate vs stable over a bake window
  using the obs metrics registry and auto-promotes or auto-rolls-back.

Own copy of ``predictionio_tpu/registry/`` (not its ``result_cache``: the
port's query server has no result cache yet). Import-light by design: ``manifest``/``store`` are stdlib-only so the
CLI's ``pio models`` verbs start without jax/numpy.
"""

from predictionio_tpu_torch.registry.controller import (
    PromotionCriteria,
    RolloutController,
)
from predictionio_tpu_torch.registry.manifest import (
    ModelManifest,
    params_hash_of,
)
from predictionio_tpu_torch.registry.probe import registry_rollout_probe
from predictionio_tpu_torch.registry.router import (
    Lane,
    RolloutInstruments,
    RolloutPlan,
    sticky_bucket,
)
from predictionio_tpu_torch.registry.store import (
    ArtifactIntegrityError,
    ArtifactStore,
    RolloutState,
    default_registry_dir,
)

__all__ = [
    "ArtifactIntegrityError",
    "ArtifactStore",
    "Lane",
    "ModelManifest",
    "PromotionCriteria",
    "RolloutController",
    "RolloutInstruments",
    "RolloutPlan",
    "RolloutState",
    "default_registry_dir",
    "params_hash_of",
    "registry_rollout_probe",
    "sticky_bucket",
]
