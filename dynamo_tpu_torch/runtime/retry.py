"""Unified retry policy: capped exponential backoff + full jitter.

A copy of dynamo_tpu/runtime/retry.py (the port imports nothing of the
JAX package).  The n-th delay is drawn uniformly from
[0, min(cap, base * mult^n)] ("full jitter"), which decorrelates
retrying clients after a fleet-wide blip instead of stampeding them in
lockstep.

Two entry points:

  * :func:`call_with_retry` — wrap an async callable; retries on the
    given exception types until attempts/deadline run out (the disagg
    pull's chunk ops use it with PULL_POLICY, engine/core.py; the KVBM
    pull with KVBM_POLICY, kvbm/remote.py).
  * :class:`Backoff` — an attempt pacer for call sites that cannot be
    expressed as a closure.

Both are cancellation-aware: a stopped CancellationToken aborts the
backoff sleep immediately.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Optional, Tuple, Type

from .cancellation import CancellationToken


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter and a deadline.

    max_attempts counts TOTAL attempts (first try included); deadline_s
    bounds the whole operation's wall clock including sleeps (None = no
    deadline)."""

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    multiplier: float = 2.0
    jitter: bool = True       # full jitter; False = deterministic ladder
    deadline_s: Optional[float] = None

    def raw_delay(self, attempt: int) -> float:
        """Un-jittered delay before attempt `attempt` (1-based retry
        index: attempt=1 is the delay after the first failure)."""
        return min(self.cap_s,
                   self.base_s * self.multiplier ** max(0, attempt - 1))

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        raw = self.raw_delay(attempt)
        if not self.jitter:
            return raw
        return (rng or random).uniform(0.0, raw)


# the disagg pull's chunk ops (engine/core.py _stream_pull)
PULL_POLICY = RetryPolicy(max_attempts=3, base_s=0.05, cap_s=0.5)
# the cross-worker KVBM pull (kvbm/remote.py RemoteKvbmPuller.fetch_run)
KVBM_POLICY = RetryPolicy(max_attempts=3, base_s=0.05, cap_s=0.5)


class Backoff:
    """Attempt pacer over a policy: call sleep() after each failure;
    False means give up (attempts exhausted, deadline passed, or the
    token stopped)."""

    def __init__(self, policy: RetryPolicy,
                 rng: Optional[random.Random] = None):
        self.policy = policy
        self.rng = rng
        self.attempt = 0  # failures seen so far
        self._t0 = time.monotonic()

    def give_up(self) -> bool:
        if self.attempt + 1 >= self.policy.max_attempts:
            return True
        d = self.policy.deadline_s
        return d is not None and (time.monotonic() - self._t0) >= d

    async def sleep(self, token: Optional[CancellationToken] = None) -> bool:
        """Pace the next attempt.  Returns False when the caller should
        stop retrying; wakes early (returning False) if `token` stops."""
        if self.give_up():
            return False
        self.attempt += 1
        delay = self.policy.delay(self.attempt, self.rng)
        d = self.policy.deadline_s
        if d is not None:
            # never sleep past the deadline
            delay = min(delay, max(0.0, d - (time.monotonic() - self._t0)))
        if token is None:
            await asyncio.sleep(delay)
            return True
        if token.is_stopped():
            return False
        try:
            await asyncio.wait_for(token.wait_stopped(), timeout=delay)
            return False  # token stopped mid-backoff
        except asyncio.TimeoutError:
            return True


async def call_with_retry(
    fn,
    policy: RetryPolicy,
    *,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    token: Optional[CancellationToken] = None,
    rng: Optional[random.Random] = None,
    on_retry=None,
):
    """Await `fn()` with retries under `policy`.

    Retries only errors matching `retry_on` (asyncio.CancelledError is
    never retried).  `on_retry(attempt, exc)` is called before each
    backoff sleep.  Raises the last error when attempts/deadline run
    out or the token stops."""
    bo = Backoff(policy, rng=rng)
    while True:
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except retry_on as e:
            if on_retry is not None:
                on_retry(bo.attempt + 1, e)
            if not await bo.sleep(token=token):
                raise


__all__ = [
    "Backoff",
    "KVBM_POLICY",
    "PULL_POLICY",
    "RetryPolicy",
    "call_with_retry",
]
