"""Resilience of the port: the engine's overload degradation ladder, and
what the annotation uplink composes (retry with decorrelated-jitter backoff
under a deadline, a per-dependency circuit breaker, the dead-letter spool),
counterparts of the JAX package's ``resilience/`` modules of the same
names."""

from .breaker import BreakerOpen, CircuitBreaker
from .ladder import RUNGS, DegradationLadder
from .policy import Deadline, DeadlineExceeded, RetryPolicy
from .spool import DeadLetterSpool

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
    "DegradationLadder",
    "DeadLetterSpool",
    "RetryPolicy",
    "RUNGS",
]
