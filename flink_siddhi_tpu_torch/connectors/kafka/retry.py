"""Retry policy for the connector path: exponential backoff with
deterministic seeded jitter, bounded attempts, and a per-call deadline.

The policy is *pure scheduling*: what counts as retryable lives in the
error taxonomy (``errors.is_retryable``), and side effects on retry
(reconnect, re-negotiate, fault counters) are the caller's
``on_retry`` hook. Determinism matters twice: the fault-injection
tests replay identical schedules against identical backoff sequences
(``seed``), and two clients with different seeds de-synchronize their
retry storms against a recovering broker instead of stampeding it.

Exhaustion re-raises the LAST underlying error, type-preserved — a
caller that catches ``CorruptBatchError`` still catches it when every
bounded attempt hit corruption; ``exc.retry_attempts`` records how
many attempts the policy spent before giving up.

Usage::

    policy = RetryPolicy(max_attempts=5, base_delay_ms=20.0, seed=7)
    result = policy.call(do_fetch, classify=is_retryable,
                         on_retry=note_and_reconnect)
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay(i) = min(base * multiplier**i, max),
    each delay jittered by a deterministic ``seed``-keyed draw in
    ``[1 - jitter, 1 + jitter]``. ``deadline_ms`` gates FURTHER
    attempts and sleeps: once the elapsed time plus the next backoff
    would exceed it, the call fails with the last error instead of
    retrying on. It does NOT interrupt an attempt already in flight —
    a blocking call's own timeout (e.g. the client socket timeout)
    bounds that, so the worst case is one attempt's timeout past the
    deadline."""

    max_attempts: int = 5
    base_delay_ms: float = 20.0
    max_delay_ms: float = 2_000.0
    multiplier: float = 2.0
    jitter: float = 0.5  # +- fraction of the nominal delay
    deadline_ms: Optional[float] = None  # whole-call budget
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def delays_ms(self) -> Iterator[float]:
        """The deterministic backoff sequence (delay before attempt
        i+1). A fresh iterator replays identically — seeded jitter,
        not wall-clock entropy."""
        rng = random.Random(self.seed)
        delay = float(self.base_delay_ms)
        while True:
            yield max(
                delay * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)),
                0.0,
            )
            delay = min(delay * self.multiplier, float(self.max_delay_ms))

    def call(
        self,
        fn: Callable,
        classify: Callable[[BaseException], bool],
        on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        """Run ``fn`` under the policy. ``classify(exc)`` says whether
        the failure is retryable; ``on_retry(exc, attempt, delay_ms)``
        fires before each backoff sleep (fault counters, reconnects).
        Fatal errors re-raise immediately; an exhausted budget
        (attempts OR deadline) re-raises the last error with
        ``retry_attempts`` stamped on it."""
        t0 = clock()
        delays = self.delays_ms()
        last: Optional[BaseException] = None
        attempt = 0
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except BaseException as e:
                if not classify(e):
                    raise
                last = e
            if attempt >= self.max_attempts:
                break
            delay_ms = next(delays)
            if self.deadline_ms is not None:
                elapsed_ms = (clock() - t0) * 1e3
                if elapsed_ms + delay_ms > self.deadline_ms:
                    break  # the budget is spent: fail with `last` now
            if on_retry is not None:
                on_retry(last, attempt, delay_ms)
            if delay_ms > 0:
                sleep(delay_ms / 1e3)
        try:
            last.retry_attempts = attempt  # type: ignore[union-attr]
        except AttributeError:
            pass  # exception types with __slots__: raise unannotated
        raise last
