"""Retry policy with decorrelated-jitter backoff + deadline budgets.

No reference counterpart: the reference proxy retries nothing — a failed
annotation POST is dropped (``grpc_server.go:204-217``) and a failed
Redis call surfaces to the caller; recovery is Docker restart-always.
Here every remote call site composes an explicit :class:`RetryPolicy`
bounded by a :class:`Deadline`, so retries never exceed the caller's
remaining time budget and never synchronize across a fleet (decorrelated
jitter, AWS architecture-blog algorithm: ``delay = min(cap,
uniform(base, prev * 3))``).

Clock, sleep, and RNG are injectable so tier-1 tests and the replay
harness stay deterministic and sleep-free.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Sequence, Tuple, Type

__all__ = ["Deadline", "DeadlineExceeded", "RetryPolicy"]


class DeadlineExceeded(TimeoutError):
    """A deadline budget was exhausted before the work completed."""


class Deadline:
    """An absolute point on a monotonic clock that nested calls share.

    Pass one ``Deadline`` down a call chain and clamp every per-attempt
    timeout with :meth:`clamp`; the sum of nested waits can then never
    exceed the top-level budget, no matter how retries interleave.
    """

    __slots__ = ("_at", "_clock")

    def __init__(self, at_s: float, *, clock: Callable[[], float] = time.monotonic):
        self._at = float(at_s)
        self._clock = clock

    @classmethod
    def after(
        cls, seconds: float, *, clock: Callable[[], float] = time.monotonic
    ) -> "Deadline":
        """Deadline ``seconds`` from now on ``clock``."""
        return cls(clock() + float(seconds), clock=clock)

    def remaining(self) -> float:
        """Seconds left; never negative."""
        return max(0.0, self._at - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self._at

    def clamp(self, timeout_s: float) -> float:
        """Shrink a per-attempt timeout to the remaining budget."""
        return min(float(timeout_s), self.remaining())

    def check(self, what: str = "deadline") -> None:
        """Raise :class:`DeadlineExceeded` if the budget is spent."""
        if self.expired:
            raise DeadlineExceeded(f"{what}: deadline exceeded")

    def sub(self, seconds: float) -> "Deadline":
        """A child budget: at most ``seconds`` from now, never past self."""
        return Deadline(min(self._at, self._clock() + float(seconds)), clock=self._clock)


class RetryPolicy:
    """Bounded retries with decorrelated-jitter exponential backoff.

    ``next_delay(prev)`` draws ``min(cap, uniform(base, max(base, prev*3)))``
    — decorrelated jitter spreads a fleet's retries instead of
    synchronizing them into thundering herds. ``run(fn)`` drives the loop:
    attempts are capped by ``max_attempts`` and, when a ``deadline`` is
    given, sleeps are clamped so the whole loop fits the caller's budget.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        base_s: float = 0.1,
        cap_s: float = 5.0,
        *,
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self._sleep = sleep

    def next_delay(self, prev_s: Optional[float] = None) -> float:
        """Next backoff delay given the previous one (None = first retry)."""
        prev = self.base_s if not prev_s else float(prev_s)
        return min(self.cap_s, self._rng.uniform(self.base_s, max(self.base_s, prev * 3.0)))

    def run(
        self,
        fn: Callable[[], object],
        *,
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        abort_on: Tuple[Type[BaseException], ...] = (),
        should_retry: Optional[Callable[[BaseException], bool]] = None,
        deadline: Optional[Deadline] = None,
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    ) -> object:
        """Call ``fn`` until it succeeds, retries exhaust, or deadline spends.

        An exception is retried iff ``should_retry(exc)`` (when given) or
        ``isinstance(exc, retry_on) and not isinstance(exc, abort_on)``.
        Terminal exceptions re-raise immediately. With a ``deadline``, the
        loop never sleeps past the remaining budget: if the next delay
        would overrun it, the last failure re-raises instead.
        """
        prev_delay: Optional[float] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except BaseException as exc:  # noqa: B902 - classified below
                if should_retry is not None:
                    retryable = should_retry(exc)
                else:
                    retryable = isinstance(exc, retry_on) and not isinstance(exc, abort_on)
                if not retryable or attempt >= self.max_attempts:
                    raise
                delay = self.next_delay(prev_delay)
                if deadline is not None:
                    budget = deadline.remaining()
                    if budget <= 0.0 or delay > budget:
                        raise
                    delay = min(delay, budget)
                prev_delay = delay
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                if delay > 0.0:
                    self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover
