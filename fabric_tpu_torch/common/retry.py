"""Shared retry/backoff discipline.

A copy of the JAX package's `common/retry`: `RetryPolicy`, `Backoff`,
`call_with_retry`, the `DELIVER_POLICY` and `DISPATCH_POLICY` constants
and `CooldownGate`. In the port the VerifyBatcher's dispatch path
(`parallel/batcher.py`) is a consumer: a transient launch failure (an
injected fault, an OSError) retries a bounded number of times before the
error fans out to every waiting resolver; the deliver client's failover
(`deliver/client.py`) paces its reconnects by `DELIVER_POLICY`.

Determinism: jitter draws from a ``random.Random(seed)`` stream and the
deadline is accounted against *nominal* (requested) sleep time, so a
fake sleeper replays bit-identically.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.faults import InjectedFault

#: Exception types a retry layer may treat as transient by default.
#: Deliberately narrow: a ValueError/KeyError is a bug, not weather.
TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (
    ConnectionError,
    TimeoutError,
    OSError,
    InjectedFault,
)


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with a total-delay deadline.

    delay(n) = min(base_s * multiplier**(n-1), cap_s), n = 1, 2, ...
    jittered by ±(jitter * delay) when jitter > 0.  The sequence stops
    when ``max_attempts`` retries have been taken or when the cumulative
    nominal delay would exceed ``deadline_s`` — the deadline is a budget
    on time *spent waiting*, matching the reference deliverer's
    total-sleep accounting (blocksprovider.go:141)."""

    base_s: float = 0.05
    multiplier: float = 2.0
    cap_s: float = 10.0
    deadline_s: float = 60.0
    max_attempts: Optional[int] = None
    jitter: float = 0.0


#: The reference deliver backoff: 1.2**n * 60 ms capped at 10 s, one hour
#: of total sleep (`deliver/client.py`'s pull loop).
DELIVER_POLICY = RetryPolicy(
    base_s=0.06, multiplier=1.2, cap_s=10.0, deadline_s=3600.0
)

#: Bounded in-process retry for a device/pool launch: fail fast — the
#: batcher's waiting resolvers are backpressure on live traffic.
DISPATCH_POLICY = RetryPolicy(
    base_s=0.005, multiplier=4.0, cap_s=0.1, deadline_s=0.5, max_attempts=3
)


class Backoff:
    """Stateful delay sequence for one retry loop.

    ``sleep()`` takes the next delay (returns False with no sleep once
    the policy budget is exhausted); ``reset()`` re-arms after a success
    (the deliverer resets on every delivered block)."""

    def __init__(
        self,
        policy: RetryPolicy,
        seed: Optional[int] = None,
        sleeper: Callable[[float], None] = time.sleep,
    ):
        self.policy = policy
        self._sleeper = sleeper
        self._rng = random.Random(seed) if policy.jitter > 0 else None
        self.attempts = 0  # retries taken since the last reset
        self.total_delay_s = 0.0  # nominal, never reset (deadline budget)

    def next_delay(self) -> Optional[float]:
        """The delay the next sleep() would take, or None if exhausted."""
        p = self.policy
        if p.max_attempts is not None and self.attempts >= p.max_attempts:
            return None
        # exponent clamp: with an infinite deadline the attempt count is
        # unbounded and multiplier**n would overflow a float around
        # n=1024 — past ~64 the min() is decided by cap_s anyway
        delay = min(p.base_s * p.multiplier ** min(self.attempts, 64), p.cap_s)
        if self.total_delay_s + delay > p.deadline_s:
            return None
        return delay

    def sleep(self) -> bool:
        delay = self.next_delay()
        if delay is None:
            return False
        # a Backoff is confined to the one retry loop that constructed
        # it (deliverer run(), call_with_retry frame) — never shared
        self.attempts += 1  # loop-scoped instance, single owner thread
        self.total_delay_s += delay  # loop-scoped instance, single owner thread
        # obs: retries are where backpressure and flaps become visible;
        # the NOMINAL delay is recorded so fake sleepers chart the same
        fabobs.obs_count("fabric_retry_attempts_total")
        fabobs.obs_observe("fabric_retry_backoff_seconds", delay)
        if self._rng is not None:
            delay *= 1.0 + self.policy.jitter * (2.0 * self._rng.random() - 1.0)
        if delay > 0:
            self._sleeper(delay)
        return True

    def reset(self) -> None:
        """Success: restart the exponential ramp (the total-delay
        deadline budget intentionally keeps accruing)."""
        self.attempts = 0  # loop-scoped instance, single owner thread


def call_with_retry(
    fn: Callable[[int], object],
    policy: RetryPolicy = DISPATCH_POLICY,
    retry_on: Tuple[Type[BaseException], ...] = TRANSIENT_ERRORS,
    seed: Optional[int] = None,
    sleeper: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[BaseException, int], None]] = None,
):
    """Run ``fn(attempt)`` (attempt = 0, 1, ...) until it returns,
    retrying ``retry_on`` failures per the policy.  The terminal failure
    re-raises unchanged once the budget is spent; non-transient
    exceptions propagate immediately."""
    bo = Backoff(policy, seed=seed, sleeper=sleeper)
    while True:
        attempt = bo.attempts
        try:
            return fn(attempt)
        except retry_on as exc:
            if not bo.sleep():
                raise
            if on_retry is not None:
                on_retry(exc, attempt)


class CooldownGate:
    """Failure-driven circuit for expensive rebuilds (process pools)
    and dial attempts (the serve client).

    ``ready()`` answers "may we rebuild now?"; each ``record_failure()``
    opens the gate for an exponentially longer cooldown (policy delays),
    ``record_success()`` closes it and resets the ramp.  Thread-safe on
    its own (leaf lock, acquired around state only — safe to call under
    any caller lock): gates are now shared across serve worker threads,
    not just callers that already hold a pool lock."""

    def __init__(
        self,
        policy: Optional[RetryPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or RetryPolicy(
            base_s=0.5, multiplier=2.0, cap_s=30.0, deadline_s=float("inf")
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._open_until = 0.0

    def ready(self) -> bool:
        with self._lock:
            return self._clock() >= self._open_until

    def record_failure(self) -> None:
        p = self.policy
        with self._lock:
            # clamp: a persistently-broken environment (this gate's
            # whole reason to exist) grows _failures without bound, and
            # multiplier**1024 raises OverflowError as a float
            cooldown = min(
                p.base_s * p.multiplier ** min(self._failures, 64), p.cap_s
            )
            self._failures += 1
            self._open_until = self._clock() + cooldown

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._open_until = 0.0
