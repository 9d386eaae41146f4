"""Retrying I/O: exponential backoff + jitter for flaky storage.

A copy of megatron_tpu/resilience/retry.py (plain Python); the port keeps its
own so that it never imports the JAX package.

Long preemptible runs checkpoint to GCS/NFS-class filesystems whose
transient failures (connection resets, stale handles, throttling) are
routine at week-long timescales; the reference has no retry layer at
all — one flaky `torch.save` kills the run (ref: megatron/
checkpointing.py:304-337 writes with no error handling). Here every
checkpoint/tracker I/O path goes through `retry(fn, policy)`:
full-jitter exponential backoff, a bounded attempt budget, and loud
logging of every retried failure so storage flakes are auditable
rather than silent.

Only exceptions in `policy.retry_on` (default: OSError — covering
IOError/FileNotFoundError-on-NFS-lag/TimeoutError) are retried;
anything else is a programming error and propagates immediately.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Tuple, Type, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule: attempt n (1-based) sleeps
    `min(base * 2**(n-1), max) * (1 ± jitter)` before retrying.
    `max_attempts=1` disables retrying (one try, no sleep)."""

    max_attempts: int = 4
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    jitter: float = 0.25  # fraction of the delay randomized both ways
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)

    def validate(self) -> "RetryPolicy":
        assert self.max_attempts >= 1, self.max_attempts
        assert self.base_delay_s >= 0.0, self.base_delay_s
        assert self.max_delay_s >= self.base_delay_s, (
            self.base_delay_s, self.max_delay_s)
        assert 0.0 <= self.jitter <= 1.0, self.jitter
        return self

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number `attempt` (1-based count of
        FAILED attempts so far)."""
        d = min(self.base_delay_s * (2.0 ** (attempt - 1)),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


def policy_from(resilience) -> RetryPolicy:
    """Build the I/O RetryPolicy from a ResilienceConfig (kept here so
    config.py stays import-free of this package)."""
    return RetryPolicy(
        max_attempts=resilience.io_retries,
        base_delay_s=resilience.io_backoff_s,
        max_delay_s=resilience.io_backoff_max_s,
        jitter=resilience.io_jitter,
    ).validate()


def retry(fn: Callable[[], T], policy: RetryPolicy = RetryPolicy(), *,
          label: str = "io", sleep: Callable[[float], None] = time.sleep,
          rng: random.Random = None) -> T:
    """Call `fn()` until it succeeds or the attempt budget runs out.

    Retries only `policy.retry_on` exceptions; the final failure
    re-raises the LAST exception unchanged so callers see the real
    error. `sleep`/`rng` are injectable for tests."""
    from megatron_tpu_torch.utils.logging import print_rank_0
    rng = rng if rng is not None else random.Random()
    last: BaseException = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except policy.retry_on as e:  # noqa: PERF203 — cold path
            last = e
            if attempt >= policy.max_attempts:
                break
            d = policy.delay_for(attempt, rng)
            print_rank_0(
                f"retry[{label}]: attempt {attempt}/{policy.max_attempts} "
                f"failed ({type(e).__name__}: {e}); retrying in {d:.2f}s")
            sleep(d)
    print_rank_0(f"retry[{label}]: giving up after {policy.max_attempts} "
                 f"attempts ({type(last).__name__}: {last})")
    raise last
