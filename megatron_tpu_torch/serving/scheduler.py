"""SLO-aware admission scheduler for the serving engine
(megatron_tpu/serving/scheduler.py).

A bounded thread-safe admission queue feeds the engine loop, which drains
it into free KV-pool slots at token granularity. Admission control happens
at submit time: oversize prompts and a full queue are rejected at once, so
callers get backpressure instead of unbounded latency. The queue is ordered
by (priority desc, deadline asc, arrival), earliest deadline first within a
priority level, and supports early load shedding (`shed_on_overload`):
when the estimated queue delay (an EWMA of slot service time times the
queue position over the slots) already exceeds a new request's deadline,
it fails at once with a retryable OverloadShedError. A preempted request
re-enters through `requeue`, past the bound and at its original arrival
position; `peek_priority` is preemption's trigger. Fan-out batches and
the brownout hooks come with their slices.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, List, Optional

from megatron_tpu_torch.serving.request import GenRequest


class QueueFullError(RuntimeError):
    """Bounded queue overflow — the HTTP layer maps this to 429 with a
    Retry-After hint and the current queue depth in the JSON body."""

    def __init__(self, msg: str, retry_after: Optional[int] = None,
                 queue_depth: Optional[int] = None):
        super().__init__(msg)
        self.retry_after = retry_after
        self.queue_depth = queue_depth


class OverloadShedError(QueueFullError):
    """Early load shedding: the estimated queue delay already exceeds
    the request's deadline, so it is failed at SUBMIT time (retryable,
    → 429 + Retry-After) instead of queueing toward a certain 504."""


class EngineUnhealthyError(RuntimeError):
    """The engine's crash-loop circuit breaker is open
    (max_engine_restarts exceeded) — the HTTP layer maps this to 503 so
    clients retry against another replica."""


class AdmissionError(ValueError):
    """Request can never be served (e.g. prompt + new tokens exceed the
    pool's max_len) — the HTTP layer maps this to 400."""


class AdmissionScheduler:
    """Bounded admission queue with SLO-aware ordering and shedding.

    Thread contract: `submit`/`cancel`/`depth`/`close` are called from
    any thread; `pop_ready`/`drop_expired`/`observe_service` only from the
    engine loop. `notify` (set by the
    engine) wakes the loop when work arrives; `active_fn` (set by the
    engine) reports busy slots for the shed estimate."""

    def __init__(self, max_queue: int, max_total_len: int,
                 num_slots: int = 1, shed_on_overload: bool = False,
                 default_deadline_s: Optional[float] = None):
        assert max_queue >= 1, max_queue
        self.max_queue = max_queue
        self.max_total_len = max_total_len
        self.num_slots = max(num_slots, 1)
        self.shed_on_overload = shed_on_overload
        self.default_deadline_s = default_deadline_s
        self._q: List[GenRequest] = []
        self._lock = threading.Lock()
        self._closed = False
        self._service_ewma: Optional[float] = None
        self.notify: Callable[[], None] = lambda: None
        self.active_fn: Callable[[], int] = lambda: 0

    # ---- ordering ----------------------------------------------------
    def _key(self, req: GenRequest):
        """(priority desc, deadline asc, arrival): EDF within a
        priority level, FIFO (by monotonic request id) among
        deadline-less peers."""
        ad = req.absolute_deadline(self.default_deadline_s)
        return (-req.priority, ad if ad is not None else math.inf,
                req.id)

    # ---- overload estimation (engine-updated, submit-consulted) ------
    def observe_service(self, seconds: float) -> None:
        """EWMA of per-request slot service time (admit → finish),
        pushed by the engine at each completion — the basis of the
        shed estimate."""
        s = max(float(seconds), 0.0)
        with self._lock:
            self._service_ewma = (s if self._service_ewma is None
                                  else 0.7 * self._service_ewma + 0.3 * s)

    def service_time_ewma(self) -> float:
        """Observed per-request slot service time (seconds; 0.0 before
        the first completion) — exported through `engine.health()` as
        `service_time_ewma_ms`."""
        with self._lock:
            return float(self._service_ewma or 0.0)

    def _estimate_delay_locked(self, req: GenRequest) -> Optional[float]:
        """Coarse queue-delay estimate for `req`: requests that would be
        served before it (queued-ahead + busy slots) spread over the
        slot grid at the observed service rate. None until the first
        completion has been observed (never shed blind)."""
        if self._service_ewma is None:
            return None
        key = self._key(req)
        ahead = sum(1 for r in self._q if self._key(r) <= key)
        busy = max(int(self.active_fn()), 0)
        return self._service_ewma * (ahead + busy) / self.num_slots

    def _retry_after_locked(self, depth: int) -> int:
        """Backoff hint in whole seconds, ALWAYS >= 1: a sub-second
        EWMA estimate must never truncate to 0 — Retry-After: 0 tells
        every shed client to retry immediately, a synchronized herd at
        the worst possible moment."""
        if self._service_ewma is None:
            return 1
        est = self._service_ewma * max(depth, 1) / self.num_slots
        return max(1, min(int(math.ceil(est)), 60))

    def retry_after_hint(self) -> int:
        """The backoff hint for refusals decided outside the scheduler
        (the engine's brownout sheds): the same clamped [1, 60] s
        estimate a queue-full refusal carries."""
        with self._lock:
            return self._retry_after_locked(len(self._q))

    # ---- admission ---------------------------------------------------
    def check_admissible(self, req: GenRequest):
        """Length admission check, shared with the engine's
        zero-decode short-circuit (which never enqueues)."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_total_len:
            raise AdmissionError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) = {total} exceeds the engine's "
                f"max_len={self.max_total_len}")

    def submit(self, req: GenRequest) -> GenRequest:
        self.check_admissible(req)
        with self._lock:
            if self._closed:
                # a submit can race the breaker trip / drain closing
                # the queue (the engine's own flag checks run before
                # this): stay a TYPED, retryable 503 — never a bare
                # RuntimeError the HTTP layer would map to 500
                raise EngineUnhealthyError(
                    "engine unavailable (queue closed by drain or "
                    "circuit breaker); retry against another replica")
            depth = len(self._q)
            if depth >= self.max_queue:
                raise QueueFullError(
                    f"request queue full ({self.max_queue}); retry later",
                    retry_after=self._retry_after_locked(depth),
                    queue_depth=depth)
            if self.shed_on_overload:
                est = self._estimate_delay_locked(req)
                ad = req.absolute_deadline(self.default_deadline_s)
                if est is not None and ad is not None \
                        and req.submit_time + est > ad:
                    budget = ad - req.submit_time
                    raise OverloadShedError(
                        f"overloaded: estimated queue delay {est:.1f}s "
                        f"exceeds the request deadline ({budget:.1f}s); "
                        "shed early — retry later or against another "
                        "replica",
                        retry_after=max(1, int(math.ceil(est - budget))),
                        queue_depth=depth)
            self._q.append(req)
        self.notify()
        return req

    def submit_many(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """All-or-nothing admission of an n-best fan-out's samples: a
        partly admitted fan-out would return fewer samples than asked
        for. The bound covers the whole group; the shed estimate runs on
        the first sample (the samples share one deadline and one queue
        position)."""
        assert reqs, "empty fan-out"
        for r in reqs:
            self.check_admissible(r)
        with self._lock:
            if self._closed:
                raise EngineUnhealthyError(
                    "engine unavailable (queue closed by drain or "
                    "circuit breaker); retry against another replica")
            depth = len(self._q)
            if depth + len(reqs) > self.max_queue:
                raise QueueFullError(
                    f"request queue full ({depth} + {len(reqs)}-sample "
                    f"fan-out exceeds {self.max_queue}); retry later",
                    retry_after=self._retry_after_locked(depth),
                    queue_depth=depth)
            if self.shed_on_overload:
                head = reqs[0]
                est = self._estimate_delay_locked(head)
                ad = head.absolute_deadline(self.default_deadline_s)
                if est is not None and ad is not None \
                        and head.submit_time + est > ad:
                    budget = ad - head.submit_time
                    raise OverloadShedError(
                        f"overloaded: estimated queue delay {est:.1f}s "
                        f"exceeds the fan-out deadline ({budget:.1f}s); "
                        "shed early — retry later or against another "
                        "replica",
                        retry_after=max(1, int(math.ceil(est - budget))),
                        queue_depth=depth)
            self._q.extend(reqs)
        self.notify()
        return reqs

    def pop_ready(self, n: int) -> List[GenRequest]:
        """Up to n non-cancelled requests in (priority, deadline,
        arrival) order (engine loop only); cancelled entries are
        dropped and failed in passing."""
        out: List[GenRequest] = []
        if n <= 0:
            # every iteration of a saturated engine pops 0 — don't
            # sort the whole queue under the submit-path lock for it
            return out
        with self._lock:
            self._q.sort(key=self._key)
            while self._q and len(out) < n:
                req = self._q.pop(0)
                if req.cancelled:
                    req.fail("cancelled")
                    continue
                out.append(req)
        return out

    def requeue(self, req: GenRequest) -> bool:
        """Re-admit a preempted (or restart-requeued) request: no bound
        check, a victim is never rejected by its own preemption, and its
        request id keeps its arrival order. On a closed (draining)
        scheduler the request fails with a retryable 503 instead; returns
        False."""
        with self._lock:
            closed = self._closed
            if not closed:
                self._q.append(req)
        if closed:
            req.fail("engine draining (shutdown in progress); preempted "
                     "work is not resumed; retry against another replica",
                     kind="unavailable")
            return False
        self.notify()
        return True

    def peek_priority(self) -> Optional[int]:
        """Priority of the request the next pop would serve first (None
        when nothing live is queued), read without disturbing the queue:
        preemption's trigger. Cancelled requests are skipped."""
        with self._lock:
            best = None
            for r in self._q:
                if r.cancelled:
                    continue
                k = self._key(r)
                if best is None or k < best[0]:
                    best = (k, r)
            return None if best is None else best[1].priority

    def parked_count(self) -> int:
        """Queued requests holding parked preemption KV (the engine's park
        budget)."""
        with self._lock:
            return sum(1 for r in self._q if r.parked is not None)

    def clear_parked(self) -> int:
        """Drop every queued request's parked KV (an engine restart: the
        device state is rebuilt). They resume by replaying their effective
        prompt, still token-exact since `resume_rng` lives on the host.
        Returns the count."""
        n = 0
        with self._lock:
            for r in self._q:
                if r.parked is not None:
                    r.parked = None
                    n += 1
        return n

    def drop_resumed(self) -> List[GenRequest]:
        """Remove and return the queued requests carrying mid-stream
        resume state (parked KV, a saved generator state or committed
        tokens); fresh requests stay queued."""
        with self._lock:
            keep: List[GenRequest] = []
            out: List[GenRequest] = []
            for r in self._q:
                if (r.parked is not None or r.resume_rng is not None
                        or r.generated):
                    out.append(r)
                else:
                    keep.append(r)
            self._q = keep
        return out

    def live_depth(self) -> int:
        """Queued requests not already terminal (a cancelled request stays
        queued, already counted, until the next pop drops it)."""
        with self._lock:
            return sum(1 for r in self._q if not r.done())

    @staticmethod
    def group_by_bucket(reqs: List[GenRequest], bucket_fn,
                        max_group: int) -> list:
        """Coalesce already-popped requests into same-bucket groups of
        at most `max_group` for batched prefill. Returns
        [(bucket, [requests])] — groups ordered by each bucket's first
        arrival, FIFO within a group. The engine partitions a pop into
        prefix-hit / chunked / resuming singles and groupable misses
        first, so grouping is exposed separately from the pop."""
        groups: dict = {}
        for req in reqs:
            groups.setdefault(bucket_fn(req), []).append(req)
        out = []
        for bucket, rs in groups.items():
            for i in range(0, len(rs), max(max_group, 1)):
                out.append((bucket, rs[i:i + max(max_group, 1)]))
        return out

    def cancel(self, req: GenRequest) -> bool:
        """Drop a still-QUEUED request; returns False if it already left
        the queue (the engine evicts running ones at the next step)."""
        with self._lock:
            try:
                self._q.remove(req)
            except ValueError:
                return False
        req.fail("cancelled")
        return True

    def drop_expired(self, deadline_s: Optional[float],
                     now: float) -> List[GenRequest]:
        """Remove queued requests past their effective deadline
        (per-request `deadline_s`, else the engine default passed here)
        and fail them with a deadline error (engine loop only) — a
        request that waited out its whole deadline in the queue must
        504, not start decoding output its caller already gave up on."""
        expired: List[GenRequest] = []
        with self._lock:
            keep: List[GenRequest] = []
            for req in self._q:
                ad = req.absolute_deadline(deadline_s)
                if ad is not None and now > ad:
                    expired.append(req)
                else:
                    keep.append(req)
            self._q = keep
        for req in expired:
            eff = (req.deadline_s if req.deadline_s is not None
                   else deadline_s)
            req.fail(f"deadline exceeded after "
                     f"{now - req.submit_time:.1f}s in queue "
                     f"(deadline {eff:.1f}s)", kind="deadline")
        return expired

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def close(self) -> List[GenRequest]:
        """Reject further submits; return the drained backlog so the
        engine can fail them."""
        with self._lock:
            self._closed = True
            backlog = list(self._q)
            self._q.clear()
        return backlog

