"""Storage DAO tracing: every method call becomes a ``storage`` span (the
port's own copy of ``predictionio_tpu/data/storage/traced.py``).

The serving/ingestion paths touch storage through DAO objects (LEvents,
Apps, EngineInstances, ...); wrapping one with :func:`trace_dao` records
a span per method call — name ``storage.<dao>.<method>``, kind
``storage`` — carrying whatever trace id is current in the caller's
context. Combined with the ingress trace id installed by the servers,
that is the third hop of the acceptance trail: one trace id observed
across ingress, batch, and storage spans.

Composes with the resilience layer in either order; the convention used
by the servers is ``policy.call(traced_dao.method, ...)`` so retries of
one storage call show up as multiple storage spans on the same trace —
which is exactly what an operator debugging a slow request wants to see.
"""

from __future__ import annotations

from typing import Any

from predictionio_tpu_torch.obs.tracing import Tracer, get_tracer


class TracedDAO:
    """Transparent proxy: callable public attributes are wrapped in a
    span; dunder/private attributes and non-callables pass through
    untouched (same shape as ``resilience.ResilientProxy``)."""

    def __init__(self, target: Any, dao_name: str, tracer: Tracer | None = None):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_dao_name", dao_name)
        object.__setattr__(self, "_tracer", tracer or get_tracer())

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._target, name)
        if not callable(attr) or name.startswith("_"):
            return attr
        tracer: Tracer = self._tracer
        span_name = f"storage.{self._dao_name}.{name}"

        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with tracer.span(span_name, kind="storage"):
                return attr(*args, **kwargs)

        wrapper.__name__ = getattr(attr, "__name__", name)
        return wrapper

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._target, name, value)

    def __repr__(self) -> str:
        return f"TracedDAO({self._dao_name}, {self._target!r})"


def trace_dao(dao: Any, dao_name: str, tracer: Tracer | None = None) -> TracedDAO:
    """Wrap a storage DAO so every method call records a storage span."""
    return TracedDAO(dao, dao_name, tracer=tracer)
