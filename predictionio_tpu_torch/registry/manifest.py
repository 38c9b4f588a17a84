"""Lineage manifests: the self-describing identity of one model version.

MLlib's persistence paper (1505.06807) motivates portable, self-describing
model artifacts; the TensorFlow paper (1605.08695) treats versioned
checkpoint lineage as a first-class system concern. A manifest records
everything needed to answer "what exactly is this blob and where did it
come from" without loading it: engine identity, a canonical hash of the
training params, the parent version it superseded, metrics known at train
time, and the blob's sha256 + length (verified on every read by
:mod:`predictionio_tpu_torch.registry.store`).

Stdlib-only: ``pio models`` must start without jax/numpy.

(Own copy of ``predictionio_tpu/registry/manifest.py``; the same JSON,
so a manifest either package wrote reads in the other.)
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import json
from typing import Any

UTC = _dt.timezone.utc


def params_hash_of(params: Any) -> str:
    """Canonical sha256 of an engine-params JSON structure (sorted keys,
    compact separators) so semantically identical params always hash
    identically regardless of dict ordering."""
    canonical = json.dumps(params, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


@dataclasses.dataclass
class ModelManifest:
    """One versioned model artifact's lineage record."""

    version: str  # registry version id, e.g. "v000007" ("" until published)
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str = ""
    instance_id: str = ""  # metadata-store EngineInstance this came from
    params_hash: str = ""  # params_hash_of(engine params json)
    parent_version: str = ""  # stable version at publish time ("" for first)
    created_at: str = ""  # ISO-8601 UTC
    data_span: dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    # training evidence: the obs/xray TrainProfile JSON of the run that
    # produced this blob (step timeline, phase/device timings, memory
    # peaks, capacity estimate) — `pio models show` renders it, `diff`
    # compares wall clock and memory between versions. Empty for versions
    # published before the profiler existed (or with PIO_XRAY=0).
    train_profile: dict[str, Any] = dataclasses.field(default_factory=dict)
    # evaluation-grid evidence (``tuning/``):
    # when this version is a grid search's winning refit, the full search
    # record rides here — metric, fold layout, per-params scores table,
    # per-cell results, and the trial ledger's sha256 as the integrity
    # anchor — so "why did this version ship" is answerable from the
    # manifest alone. Empty for versions trained outside a grid.
    eval_evidence: dict[str, Any] = dataclasses.field(default_factory=dict)
    # the version's ANN retrieval index (not yet built by the port):
    # a second content-addressed blob in the same engine's blob store,
    # recorded here with its sha256/bytes plus layout metadata (items,
    # clusters, bucketCap, nprobe, quantized, builtFrom). Empty when no
    # index was built (small corpus, or a model type ANN doesn't apply to)
    # — serving then stays on exact scoring.
    ann_index: dict[str, Any] = dataclasses.field(default_factory=dict)
    blob_sha256: str = ""  # filled by the store on publish
    blob_size: int = 0

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, data: dict[str, Any]) -> "ModelManifest":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    @staticmethod
    def now_iso() -> str:
        return _dt.datetime.now(tz=UTC).isoformat()

    def summary_row(self) -> dict[str, Any]:
        """The compact row ``pio models list`` prints."""
        return {
            "version": self.version,
            "created": self.created_at,
            "instance": self.instance_id,
            "paramsHash": self.params_hash[:12],
            "sha256": self.blob_sha256[:12],
            "bytes": self.blob_size,
            "parent": self.parent_version,
        }
