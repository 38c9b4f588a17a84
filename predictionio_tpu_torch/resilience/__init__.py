"""Resilience: the retry policy and circuit breaker that guard the
offline pipeline's event-store writeback (port of
``predictionio_tpu/resilience/{retry,breaker}.py``; deadlines, the fault
injector and the servers' load shedding come later)."""

from predictionio_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpenError
from predictionio_tpu_torch.resilience.retry import RetryBudget, RetryPolicy, is_transient

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "RetryBudget",
    "RetryPolicy",
    "is_transient",
]
