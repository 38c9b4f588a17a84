"""The shared "rollout active" probe.

Two control loops must never act while a candidate bakes: the
autoscaler must not resize and the lifecycle controller must not
launch a retune grid. Both defer on the SAME question — is any
engine's rollout mode != off — and a private copy in each would let the
definitions drift (e.g. one learning about shadow mode, the other not).
This is the one home.

(Own copy of ``predictionio_tpu/registry/probe.py``.)
"""

from __future__ import annotations

from typing import Callable


def registry_rollout_probe(registry_dir: str) -> Callable[[], bool]:
    """True while ANY engine's rollout is mid-bake (mode != off) — the
    never-act-mid-bake input, read from the same registry the fleet
    coordinates through. Raises on an unreadable registry: callers must
    not act on unknown rollout state (their tick loops count the error
    and retry)."""
    from predictionio_tpu_torch.registry.store import ArtifactStore

    store = ArtifactStore(registry_dir)

    def probe() -> bool:
        return any(
            store.state_by_key(key).mode != "off" for key in store.engines()
        )

    return probe


__all__ = ["registry_rollout_probe"]
