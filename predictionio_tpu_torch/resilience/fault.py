"""Fault injection: wrap any object and make its methods fail on demand
(port of ``predictionio_tpu/resilience/fault.py``).

The chaos harness's only moving part. ``FaultInjector(target)`` proxies
every attribute of ``target``; ``inject(...)`` arms faults that matching
method calls then experience — an exception (for the next N calls or at a
probability), added latency, or a hang — before (or instead of) delegating
to the real implementation. Wrap a storage DAO to simulate a flaky
database, an HTTP transport to simulate a dead collector, an algorithm to
simulate a wedged device.

Injected errors are ``InjectedFault`` (a ``ConnectionError``, transient by
nature) unless the spec supplies its own exception factory, so retry
policies classify them exactly like real connection failures.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable


class InjectedFault(ConnectionError):
    """A fault produced by ``FaultInjector`` (transient, like the real
    connection failures it stands in for)."""

    transient = True


@dataclasses.dataclass
class FaultSpec:
    """One armed fault. ``methods=None`` matches every method call."""

    methods: tuple[str, ...] | None = None
    fail_count: int = 0  # fail this many matching calls, then disarm
    fail_rate: float = 0.0  # else fail each matching call with this prob.
    exception: Callable[[str], BaseException] = lambda m: InjectedFault(
        f"injected fault in {m}"
    )
    latency_s: float = 0.0  # sleep before every matching call (even passing)
    hang_s: float = 0.0  # sleep before *failing* calls (simulates a stall)

    def matches(self, method: str) -> bool:
        return self.methods is None or method in self.methods


class FaultInjector:
    """Transparent proxy over ``target`` with armable faults.

    Non-callable attributes pass straight through; method calls consult the
    armed specs first. Counters (``calls``, ``faults``) let tests assert
    how much real work reached the target vs. was intercepted.
    """

    def __init__(self, target: Any, rng: Callable[[], float] = random.random):
        # avoid __setattr__ recursion via object.__setattr__
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_specs", [])
        object.__setattr__(self, "_lock", threading.Lock())
        object.__setattr__(self, "_rng", rng)
        object.__setattr__(self, "calls", 0)
        object.__setattr__(self, "faults", 0)

    # -- arming -------------------------------------------------------------
    def inject(
        self,
        methods: str | tuple[str, ...] | None = None,
        fail_count: int = 0,
        fail_rate: float = 0.0,
        exception: Callable[[str], BaseException] | None = None,
        latency_s: float = 0.0,
        hang_s: float = 0.0,
    ) -> FaultSpec:
        if isinstance(methods, str):
            methods = (methods,)
        spec = FaultSpec(
            methods=methods,
            fail_count=fail_count,
            fail_rate=fail_rate,
            latency_s=latency_s,
            hang_s=hang_s,
        )
        if exception is not None:
            spec.exception = exception
        with self._lock:
            self._specs.append(spec)
        return spec

    def clear(self) -> None:
        """Disarm everything: the wrapped object behaves normally again."""
        with self._lock:
            self._specs.clear()

    # -- proxying -----------------------------------------------------------
    def _apply_faults(self, method: str) -> None:
        """Raise/delay per the armed specs. Counting + spec decay under the
        lock; sleeping outside it."""
        to_sleep = 0.0
        to_raise: BaseException | None = None
        with self._lock:
            self.calls += 1
            for spec in self._specs:
                if not spec.matches(method):
                    continue
                to_sleep += spec.latency_s
                if to_raise is not None:
                    continue
                if spec.fail_count > 0:
                    spec.fail_count -= 1
                    to_raise = spec.exception(method)
                elif spec.fail_rate > 0 and self._rng() < spec.fail_rate:
                    to_raise = spec.exception(method)
                if to_raise is not None:
                    self.faults += 1
                    to_sleep += spec.hang_s
        if to_sleep > 0:
            time.sleep(to_sleep)
        if to_raise is not None:
            raise to_raise

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._target, name)
        if not callable(attr):
            return attr

        def wrapper(*args: Any, **kwargs: Any) -> Any:
            self._apply_faults(name)
            return attr(*args, **kwargs)

        wrapper.__name__ = getattr(attr, "__name__", name)
        return wrapper

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("calls", "faults"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._target, name, value)

    def __repr__(self) -> str:
        return f"FaultInjector({self._target!r}, specs={len(self._specs)})"
