"""One dependency's policy: retries around breaker-gated attempts inside
an optional deadline (port of ``ResiliencePolicy`` from
``predictionio_tpu/resilience/wrappers.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from predictionio_tpu_torch.resilience.breaker import CircuitBreaker
from predictionio_tpu_torch.resilience.deadline import Deadline
from predictionio_tpu_torch.resilience.retry import RetryPolicy


@dataclasses.dataclass
class ResiliencePolicy:
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker: CircuitBreaker | None = None

    def call(self, fn: Callable[..., Any], *args: Any, deadline: Deadline | None = None, **kwargs: Any) -> Any:
        if self.breaker is None:
            return self.retry.call(fn, *args, deadline=deadline, **kwargs)
        breaker = self.breaker
        # only errors the retry policy calls transient count against the
        # breaker: a request that fails deterministically must not open it
        classify = self.retry.retry_on

        def attempt() -> Any:
            return breaker.call(fn, *args, counts_as_failure=classify, **kwargs)

        return self.retry.call(attempt, deadline=deadline)

    def snapshot(self) -> dict[str, Any]:
        return {
            "breaker": self.breaker.snapshot() if self.breaker else None,
            "retryBudgetTokens": self.retry.budget.tokens if self.retry.budget else None,
            "retriesAttempted": self.retry.retries_attempted,
        }
