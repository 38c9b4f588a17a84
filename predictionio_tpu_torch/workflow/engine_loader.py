"""Engine discovery: engine.json variants and factory loading (port of
``predictionio_tpu/workflow/engine_loader.py`` without the template
version check).

An engine directory holds ``engine.json``: ``{"id", "description",
"engineFactory": "pkg.module.fn", "datasource": ..., "algorithms": [...],
"serving": ...}``; the directory joins ``sys.path`` so a template's own
modules import.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
from typing import Any

from predictionio_tpu_torch.controller.engine import Engine


class EngineLoadError(RuntimeError):
    pass


@dataclasses.dataclass
class EngineManifest:
    engine_id: str
    version: str
    variant: str  # variant file name
    engine_factory: str
    description: str = ""
    variant_json: dict[str, Any] = dataclasses.field(default_factory=dict)
    engine_dir: str = "."


def load_engine_factory(dotted: str) -> Engine:
    """Resolve "pkg.module.attr" to an Engine instance."""
    module_name, _, attr = dotted.rpartition(".")
    if not module_name:
        raise EngineLoadError(f"engineFactory {dotted!r} must be a dotted path")
    try:
        module = importlib.import_module(module_name)
    except ImportError as exc:
        raise EngineLoadError(f"cannot import {module_name}: {exc}") from exc
    factory = getattr(module, attr, None)
    if factory is None:
        raise EngineLoadError(f"{module_name} has no attribute {attr}")
    engine = factory if isinstance(factory, Engine) else factory()
    if not isinstance(engine, Engine):
        raise EngineLoadError(f"{dotted} returned {type(engine).__name__}, not an Engine")
    return engine


def load_manifest(engine_dir: str, variant_path: str | None = None) -> EngineManifest:
    engine_dir = os.path.abspath(engine_dir)
    variant_path = variant_path or os.path.join(engine_dir, "engine.json")
    if not os.path.isabs(variant_path):
        variant_path = os.path.join(engine_dir, variant_path)
    if not os.path.exists(variant_path):
        raise EngineLoadError(f"engine variant file not found: {variant_path}")
    with open(variant_path) as f:
        variant = json.load(f)
    factory = variant.get("engineFactory")
    if not factory:
        raise EngineLoadError(f"{variant_path} missing engineFactory")
    # a generic id must not collide across engines: fall back to the directory
    variant_id = variant.get("id")
    engine_id = variant_id if variant_id and variant_id != "default" else engine_dir
    return EngineManifest(
        engine_id=engine_id,
        version=str(variant.get("version", "1")),
        variant=os.path.basename(variant_path),
        engine_factory=factory,
        description=variant.get("description", ""),
        variant_json=variant,
        engine_dir=engine_dir,
    )


def load_engine(engine_dir: str, variant_path: str | None = None) -> tuple[EngineManifest, Engine]:
    manifest = load_manifest(engine_dir, variant_path)
    if manifest.engine_dir not in sys.path:
        sys.path.insert(0, manifest.engine_dir)
    return manifest, load_engine_factory(manifest.engine_factory)
