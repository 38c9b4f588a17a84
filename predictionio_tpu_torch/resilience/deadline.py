"""Absolute deadlines on a monotonic clock (port of
``predictionio_tpu/resilience/deadline.py``, the parts the stream tailer
uses)."""

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
