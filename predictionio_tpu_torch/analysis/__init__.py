"""Static analysis for the port (`pio lint`).

AST checks that catch the PyTorch and CUDA serving failure modes at review
time: Python control flow and host casts on tensors inside a function that
``torch.compile`` stages or a CUDA graph captures, recompile hazards
(``torch.compile`` built per call, literal arguments its guards specialise
on, a compiled closure over mutable state), device->host syncs on the
serving and training paths (``.item()``, ``.cpu()``, ``torch.cuda.
synchronize()`` ...), unlocked shared state in threaded modules, storage
backends that drift from the ``storage/base.py`` abstract contract, and the
framework-neutral families it shares with the JAX package's analyzer.

The engine is whole-program: a cross-file call graph (``callgraph.py``)
plus reachability from declared entry points (``reachability.py``,
``LintConfig.entry_points``) scope the context-sensitive rules; ``mesh-*``
checks axis names against the meshes of ``parallel/mesh.py``, host fetches
of per-rank shards and per-shard top-k merging; ``async-blocking-call``
finds blocking I/O on event-loop paths, transitively through the call
graph. The rule ids, families and severities are the JAX analyzer's.

Public surface:

- :func:`analyze_paths` / :func:`analyze_source` — run the rule registry.
- :class:`Finding`, :class:`Severity`, :class:`LintConfig`,
  :class:`Report`, :class:`EntryPoint`.
- ``predictionio_tpu_torch.analysis.cli:main`` — the ``pio lint`` / ``lint``
  console entry point.

Inline suppression: ``# pio-lint: disable=rule-id[,rule-id...] -- reason``
on the offending line (or alone on the line above); file-level with
``# pio-lint: disable-file=rule-id``. Suppressions should carry a reason.

This package imports no ``torch``, ``numpy`` or ``jax``: `pio lint` runs in
CI and pre-commit hooks, where initialising CUDA or loading a framework is
exactly what it must not do.
"""

from predictionio_tpu_torch.analysis.core import (
    Finding,
    LintConfig,
    Report,
    Severity,
    all_rules,
    analyze_paths,
    analyze_source,
)
from predictionio_tpu_torch.analysis.reachability import EntryPoint

# importing the rule modules registers their checkers
from predictionio_tpu_torch.analysis import (  # noqa: F401  (registration side effect)
    rules_async,
    rules_concurrency,
    rules_fleet,
    rules_hostsync,
    rules_mesh,
    rules_obs,
    rules_recompile,
    rules_storage,
    rules_stream,
    rules_tracer,
    rules_train,
)

__all__ = [
    "EntryPoint",
    "Finding",
    "LintConfig",
    "Report",
    "Severity",
    "all_rules",
    "analyze_paths",
    "analyze_source",
]
