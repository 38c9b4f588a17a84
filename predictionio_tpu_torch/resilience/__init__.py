"""Resilience: retry policy, circuit breaker, deadlines, the policy that
composes them and the proxy that applies it to a DAO, and the fault
injector of the chaos tests (port of ``predictionio_tpu/resilience/``).
They guard the event server's storage, the query server's dispatch, the
offline pipeline's event-store writeback and the stream tailer."""

from predictionio_tpu_torch.resilience.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    CircuitOpenError,
)
from predictionio_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from predictionio_tpu_torch.resilience.fault import FaultInjector, FaultSpec, InjectedFault
from predictionio_tpu_torch.resilience.policy import ResiliencePolicy
from predictionio_tpu_torch.resilience.retry import (
    TRANSIENT_HTTP_STATUSES,
    RetryBudget,
    RetryPolicy,
    is_transient,
    mark_transient,
)
from predictionio_tpu_torch.resilience.wrappers import ResilientProxy, wrap_dao

__all__ = [
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceeded",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "ResiliencePolicy",
    "ResilientProxy",
    "RetryBudget",
    "RetryPolicy",
    "TRANSIENT_HTTP_STATUSES",
    "is_transient",
    "mark_transient",
    "wrap_dao",
]
