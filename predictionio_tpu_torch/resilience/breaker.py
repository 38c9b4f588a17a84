"""Circuit breaker (port of ``predictionio_tpu/resilience/breaker.py``
without ``force_open``).

closed: consecutive failures are counted; at ``failure_threshold`` the
circuit opens and every call is refused with :class:`CircuitOpenError`.
After ``recovery_timeout_s`` it is half-open: a bounded number of probes go
through, one success closes it, one failure opens it again. Thread-safe;
the clock is injectable. A ``listener`` sees each transition as
``(name, old_state, new_state)``, called outside the lock.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitOpenError(RuntimeError):
    """Refused without trying: the circuit is open. Not transient."""

    transient = False

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(f"circuit '{name}' is open; retry after {retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    def __init__(
        self,
        name: str = "",
        failure_threshold: int = 5,
        recovery_timeout_s: float = 5.0,
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        listener: Callable[[str, str, str], None] | None = None,
    ):
        self.name = name or "breaker"
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_timeout_s = recovery_timeout_s
        self.half_open_max_probes = max(1, half_open_max_probes)
        self._clock = clock
        self.listener = listener
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_inflight = 0
        self.trips = 0

    def _trip(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._probes_inflight = 0
        self.trips += 1

    def _notify(self, transition: tuple[str, str] | None) -> None:
        if transition is not None and self.listener is not None:
            try:
                self.listener(self.name, *transition)
            except Exception:
                pass  # monitoring must never break the state machine

    def allow(self) -> None:
        """Gate one call; pair a return with record_success/record_failure."""
        transition = None
        err = None
        with self._lock:
            if self._state == CLOSED:
                return
            elapsed = self._clock() - self._opened_at
            if self._state == OPEN:
                if elapsed < self.recovery_timeout_s:
                    err = CircuitOpenError(self.name, self.recovery_timeout_s - elapsed)
                else:
                    self._state = HALF_OPEN
                    self._probes_inflight = 0
                    transition = (OPEN, HALF_OPEN)
            if err is None:
                if self._probes_inflight >= self.half_open_max_probes:
                    err = CircuitOpenError(self.name, self.recovery_timeout_s)
                else:
                    self._probes_inflight += 1
        self._notify(transition)
        if err is not None:
            raise err

    def record_success(self) -> None:
        transition = None
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probes_inflight = 0
                transition = (HALF_OPEN, CLOSED)
        self._notify(transition)

    def release_probe(self) -> None:
        """Un-claim a half-open probe slot whose call never ran."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_inflight > 0:
                self._probes_inflight -= 1

    def record_failure(self) -> None:
        transition = None
        with self._lock:
            if self._state == HALF_OPEN:
                self._trip()
                transition = (HALF_OPEN, OPEN)
            else:
                self._consecutive_failures += 1
                if self._state == CLOSED and self._consecutive_failures >= self.failure_threshold:
                    self._trip()
                    transition = (CLOSED, OPEN)
        self._notify(transition)

    def chain_listener(self, fn: Callable[[str, str, str], None]) -> None:
        """Add a transition observer after the existing one; each runs
        isolated from the other's exceptions."""
        previous = self.listener

        def chained(name: str, old: str, new: str) -> None:
            if previous is not None:
                try:
                    previous(name, old, new)
                except Exception:
                    pass
            fn(name, old, new)

        self.listener = chained

    def reset(self) -> None:
        transition = None
        with self._lock:
            if self._state != CLOSED:
                transition = (self._state, CLOSED)
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probes_inflight = 0
        self._notify(transition)

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        counts_as_failure: Callable[[BaseException], bool] | None = None,
        **kwargs: Any,
    ) -> Any:
        """Gate, run and record in one step. An error that
        ``counts_as_failure`` does not classify as the dependency's fault
        records neither outcome and frees its half-open probe slot."""
        self.allow()
        try:
            result = fn(*args, **kwargs)
        except BaseException as exc:
            if counts_as_failure is None or counts_as_failure(exc):
                self.record_failure()
            else:
                self.release_probe()
            raise
        self.record_success()
        return result

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == OPEN and self._clock() - self._opened_at >= self.recovery_timeout_s:
                return HALF_OPEN
            return self._state

    def snapshot(self) -> dict[str, Any]:
        state = self.state
        with self._lock:
            return {
                "name": self.name,
                "state": state,
                "consecutiveFailures": self._consecutive_failures,
                "trips": self.trips,
            }
