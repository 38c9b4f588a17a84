"""A proxy that runs every method of a wrapped object through one
:class:`~predictionio_tpu_torch.resilience.policy.ResiliencePolicy` (port
of ``ResilientProxy`` and ``wrap_dao`` from
``predictionio_tpu/resilience/wrappers.py``)."""

from __future__ import annotations

from typing import Any

from predictionio_tpu_torch.resilience.policy import ResiliencePolicy


class ResilientProxy:
    """Every public method call on the wrapped object runs through the
    policy. ``exempt`` methods (``close``) bypass it: a shutdown call must
    not be blocked by an open breaker or retried against a dying backend."""

    def __init__(self, target: Any, policy: ResiliencePolicy, exempt: tuple[str, ...] = ("close",)):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_policy", policy)
        object.__setattr__(self, "_exempt", exempt)

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._target, name)
        if not callable(attr) or name in self._exempt or name.startswith("_"):
            return attr
        policy = self._policy

        def wrapper(*args: Any, **kwargs: Any) -> Any:
            return policy.call(attr, *args, **kwargs)

        wrapper.__name__ = getattr(attr, "__name__", name)
        return wrapper

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._target, name, value)

    def __repr__(self) -> str:
        return f"ResilientProxy({self._target!r})"


def wrap_dao(dao: Any, policy: ResiliencePolicy, exempt: tuple[str, ...] = ("close",)) -> ResilientProxy:
    """Policy-wrap a storage DAO. A scan that returns an iterator is
    protected only on the call that builds it: a half-consumed scan cannot
    be replayed here."""
    return ResilientProxy(dao, policy, exempt=exempt)
