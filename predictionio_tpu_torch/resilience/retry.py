"""Retry with exponential backoff and jitter, bounded by a per-process
budget (port of ``predictionio_tpu/resilience/retry.py``).

Only errors that can succeed on replay are retried: an exception whose
``transient`` attribute says so, or a connection-level error. The token
bucket caps retries at ``ratio`` of first attempts, so a dying backend sees
its load drop instead of multiply. ``sleep`` and ``rng`` are injectable.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable

from predictionio_tpu_torch.resilience.deadline import Deadline

_TRANSIENT_TYPES = (ConnectionError, InterruptedError)

# HTTP statuses worth replaying (server-side trouble a fresh attempt can
# clear), shared by the REST storage drivers (elasticsearch, s3, hdfs)
TRANSIENT_HTTP_STATUSES = (500, 502, 503, 504)


def mark_transient(exc: BaseException) -> BaseException:
    """Tag an exception as replay-safe for ``is_transient`` and return it
    (``raise mark_transient(SomeError(...)) from exc``)."""
    exc.transient = True
    return exc


def is_transient(exc: BaseException) -> bool:
    marked = getattr(exc, "transient", None)
    if marked is not None:
        return bool(marked)
    return isinstance(exc, _TRANSIENT_TYPES)


class RetryBudget:
    """Token bucket: each first attempt deposits ``ratio`` tokens (capped
    at ``max_tokens``), each retry withdraws one; ``min_tokens`` pre-funds
    a cold process."""

    def __init__(self, ratio: float = 0.1, max_tokens: float = 100.0, min_tokens: float = 10.0):
        self.ratio = ratio
        self.max_tokens = max_tokens
        self._tokens = min(min_tokens, max_tokens)
        self._lock = threading.Lock()

    def record_attempt(self) -> None:
        with self._lock:
            self._tokens = min(self.max_tokens, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


@dataclasses.dataclass
class RetryPolicy:
    """Attempt k sleeps a uniform draw from ``[b·m^k·(1 - jitter), b·m^k]``,
    capped at ``backoff_max_s``."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 2.0
    jitter: float = 0.5
    retry_on: Callable[[BaseException], bool] = is_transient
    budget: RetryBudget | None = None
    sleep: Callable[[float], None] = time.sleep
    rng: Callable[[], float] = random.random
    # called once per retry decision with the error being retried
    on_retry: Callable[[BaseException], None] | None = None
    retries_attempted: int = 0

    def backoff_s(self, retry_index: int) -> float:
        raw = min(self.backoff_max_s, self.backoff_base_s * self.backoff_multiplier**retry_index)
        return raw * (1.0 - self.jitter * self.rng())

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        deadline: Deadline | None = None,
        **kwargs: Any,
    ) -> Any:
        """Run ``fn`` with retries; the underlying error propagates
        unchanged when it is not transient, the attempts run out, or the
        next backoff would pass ``deadline``."""
        if self.budget is not None:
            self.budget.record_attempt()
        attempts = 0
        while True:
            if deadline is not None:
                deadline.check("retryable call")
            attempts += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:
                if not self.retry_on(exc) or attempts >= self.max_attempts:
                    raise
                if self.budget is not None and not self.budget.try_spend():
                    raise
                self.retries_attempted += 1
                if self.on_retry is not None:
                    try:
                        self.on_retry(exc)
                    except Exception:
                        pass  # monitoring must never break the retry loop
                pause = self.backoff_s(attempts - 1)
                if deadline is not None:
                    rem = deadline.remaining()
                    if rem is not None and pause >= rem:
                        raise
                if pause > 0:
                    self.sleep(pause)
