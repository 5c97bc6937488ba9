"""Shared retry/backoff/deadline policy for transient distributed faults.

Counterpart of paddle_tpu/distributed/retries.py, copied (the module is
stdlib-only, but importing it would import the JAX package). Every
retryable surface goes through ONE policy object so budgets are visible
and testable. A policy is immutable and cheap; call `run(fn)` (or use it
as a decorator) and it retries `fn` on the configured exception types
with exponential backoff, honoring both an attempt budget and a
wall-clock deadline. The delay sequence is the JAX module's: the same
policy and the same seeded rng give the same delays.

Retryable vs fatal is decided by exception TYPE: pass the typed errors
as `retryable`; anything else propagates on the first throw.
`on_retry(attempt, exc)` lets callers re-establish state between
attempts.

`default_policy(**overrides)` takes its budgets from the module
constants DEFAULT_MAX_ATTEMPTS and DEFAULT_DEADLINE_S and the overrides
alone: the port reads no environment variable (the JAX module's
PADDLE_TPU_RETRY_MAX_ATTEMPTS / PADDLE_TPU_RETRY_DEADLINE_S are its
own).
"""
from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass, field

__all__ = ["RetryPolicy", "RetryBudgetExceeded", "default_policy",
           "DEFAULT_MAX_ATTEMPTS", "DEFAULT_DEADLINE_S"]

#: `default_policy`'s attempt budget (total tries, not re-tries)
DEFAULT_MAX_ATTEMPTS = 3
#: `default_policy`'s wall-clock budget across attempts (None: unbounded)
DEFAULT_DEADLINE_S = None


def _note_retry(exhausted=False):
    """Count retries/exhaustions in the port's metrics registry. On the
    retry path a fault already fired, so the lazy import is noise against
    the backoff sleep; import failures (partial interpreter teardown) are
    swallowed: retrying matters more than counting it."""
    try:
        from paddle_tpu_torch import observability
        if observability.ENABLED:
            if exhausted:
                observability.inc("retry.exhausted")
            else:
                observability.inc("retry.attempts")
    except Exception:   # lint: disable=silent-swallow -- retry telemetry must never break the retried op
        pass


class RetryBudgetExceeded(RuntimeError):
    """All attempts (or the deadline) exhausted; `last` is the final
    underlying exception, also chained as __cause__."""

    def __init__(self, msg, last):
        super().__init__(msg)
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3             # total tries, not re-tries
    base_delay: float = 0.05          # first backoff sleep (seconds)
    max_delay: float = 2.0            # backoff cap
    multiplier: float = 2.0
    deadline: float | None = None     # wall-clock budget across attempts
    retryable: tuple = (ConnectionError, TimeoutError)
    # "full" = AWS full jitter: each backoff is uniform over
    # [0, min(base * mult^n, max_delay)], so many callers retrying the
    # same fault spread out instead of re-colliding every attempt.
    # None (default) keeps the exact exponential sequence.
    jitter: str | None = None
    # seedable RNG for deterministic jittered tests (None = the module
    # random, i.e. genuinely random in production)
    rng: object = field(default=None, repr=False)
    # sleep hook: tests swap in a recorder to run fast
    sleep: object = field(default=time.sleep, repr=False)

    def delays(self):
        rng = self.rng if self.rng is not None else random
        d = self.base_delay
        while True:
            cap = min(d, self.max_delay)
            yield rng.uniform(0.0, cap) if self.jitter == "full" else cap
            d *= self.multiplier

    def run(self, fn, *args, desc=None, on_retry=None, **kwargs):
        """Call fn(*args, **kwargs), retrying on `retryable` errors with
        exponential backoff until attempts or deadline run out."""
        start = time.monotonic()
        last = None
        gen = self.delays()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:   # noqa: PERF203 — the point
                last = e
                if attempt >= self.max_attempts:
                    break
                delay = next(gen)
                if self.deadline is not None and (
                        time.monotonic() - start + delay > self.deadline):
                    break
                _note_retry()           # cold path: a fault already hit
                self.sleep(delay)
                if on_retry is not None:
                    try:
                        on_retry(attempt, e)
                    except Exception:   # lint: disable=silent-swallow -- on_retry recovery is best-effort; the next attempt reports
                        pass
        _note_retry(exhausted=True)
        raise RetryBudgetExceeded(
            f"{desc or getattr(fn, '__name__', 'op')} failed after "
            f"{self.max_attempts} attempts "
            f"({time.monotonic() - start:.2f}s): {last!r}", last) from last

    def __call__(self, fn):
        """Decorator form."""

        @functools.wraps(fn)
        def wrapped(*a, **k):
            return self.run(fn, *a, **k)
        return wrapped


def default_policy(**overrides) -> RetryPolicy:
    """Policy with the module's default attempt/deadline budgets, then
    `overrides`."""
    kw = dict(max_attempts=DEFAULT_MAX_ATTEMPTS,
              deadline=DEFAULT_DEADLINE_S)
    kw.update(overrides)
    return RetryPolicy(**kw)
