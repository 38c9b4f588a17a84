"""Resilience: retry policy, circuit breaker, deadlines and the policy
that composes them, guarding the offline pipeline's event-store writeback
and the stream tailer (port of ``predictionio_tpu/resilience/``; the
fault injector and the servers' load shedding come later)."""

from predictionio_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpenError
from predictionio_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from predictionio_tpu_torch.resilience.policy import ResiliencePolicy
from predictionio_tpu_torch.resilience.retry import RetryBudget, RetryPolicy, is_transient

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceeded",
    "ResiliencePolicy",
    "RetryBudget",
    "RetryPolicy",
    "is_transient",
]
