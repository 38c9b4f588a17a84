"""Absolute deadlines on a monotonic clock (port of
``predictionio_tpu/resilience/deadline.py``).

A ``Deadline`` is created once at the edge (the query handler, the stream
tailer) and passed down through every layer that can block: admission,
dispatch, fetch, retries. Each layer sizes its own wait from
``remaining()``, so a request spends its budget once. The clock is
injectable so tests advance time without sleeping."""

from __future__ import annotations

import time
from typing import Callable


class DeadlineExceeded(TimeoutError):
    """The operation's deadline passed before it completed. Not transient:
    retrying inside the same budget cannot help."""

    transient = False


class Deadline:
    """``None`` budget = unbounded."""

    __slots__ = ("_at", "_clock")

    def __init__(self, timeout_s: float | None, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._at = None if timeout_s is None else clock() + max(0.0, timeout_s)

    @classmethod
    def after(cls, timeout_s: float | None, clock: Callable[[], float] = time.monotonic) -> "Deadline":
        """``timeout_s <= 0`` or ``None`` builds an unbounded deadline."""
        if timeout_s is None or timeout_s <= 0:
            return cls(None, clock)
        return cls(timeout_s, clock)

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    @property
    def bounded(self) -> bool:
        return self._at is not None

    def remaining(self) -> float | None:
        """Seconds left (clamped at 0), or None when unbounded."""
        if self._at is None:
            return None
        return max(0.0, self._at - self._clock())

    @property
    def expired(self) -> bool:
        return self._at is not None and self._clock() >= self._at

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceeded(f"{what}: deadline exceeded")

    def clamp(self, timeout_s: float | None) -> float | None:
        """Fit a layer-local timeout inside this deadline: the smaller of
        the two, None meaning unbounded on either side."""
        rem = self.remaining()
        if rem is None:
            return timeout_s
        if timeout_s is None:
            return rem
        return min(rem, timeout_s)

    @staticmethod
    def min_of(deadlines: "list[Deadline]") -> "Deadline":
        """The tightest of a set (a micro-batch answers by its most
        impatient member); unbounded members do not tighten it."""
        best: Deadline | None = None
        for d in deadlines:
            if d._at is not None and (best is None or d._at < best._at):
                best = d
        return best if best is not None else Deadline.never()

    def __repr__(self) -> str:
        rem = self.remaining()
        return f"Deadline(remaining={'inf' if rem is None else f'{rem:.3f}s'})"
