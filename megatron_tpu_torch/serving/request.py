"""Request objects for the continuous-batching engine
(megatron_tpu/serving/request.py).

Requests enter and leave the persistent decode batch at token granularity,
so each carries its own sampling state, seed and lifecycle timestamps, and
signals completion through a threading.Event that HTTP handler threads
block on, and each committed token through a condition that the SSE
streaming cursor and the router's retry pump wait on (`wait_token`). A
preempted request carries its resume state: `parked` (its
KV copied out of the pool and its carried logits row), `resume_rng` and
`resume_reject`. A LoRA request carries `adapter_id`, the `adapter_ns`
(id, registration generation) it first ran under and the `bank_idx` it
holds pinned. A structured request carries its compiled `fsm` and its
`fsm_state` (host state, so it survives preemption, replay and restarts);
an n-best fan-out's samples are plain requests aggregated by
`FanoutRequest`, the siblings gating their admission on the leader's
prompt KV (`fanout_leader`).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import math
import threading
import time
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"        # accepted, waiting for a free slot
    RUNNING = "running"      # prefilled into a slot, decoding
    FINISHED = "finished"    # EOS or max_new_tokens reached
    FAILED = "failed"        # engine error, deadline, or shutdown


class DeadlineExceededError(RuntimeError):
    """The request outlived its per-request deadline (queued or
    running) and was evicted — the HTTP layer maps this to 504."""


class ServiceUnavailableError(RuntimeError):
    """The request was dropped because the engine is draining for
    shutdown (queued work is not carried across restarts) — the HTTP
    layer maps this to 503 so clients retry against another replica."""


class RequestFailedError(RuntimeError):
    """Generic terminal failure (engine crash/hang/breaker, non-finite
    logits, cancellation, adapter load failure): the typed spelling of
    what used to surface as a bare RuntimeError from `result()`. A
    RuntimeError subclass, so every existing `except RuntimeError`
    caller keeps working — but the serving invariant checker
    (serving/invariants.py "typed-terminal law") can now assert that NO
    request ever resolves with a BARE RuntimeError: every failure is
    one of {DeadlineExceededError (504), ServiceUnavailableError (503,
    retryable), RequestFailedError (500)} or a typed submit-time
    rejection."""


class GrammarDeadEndError(RuntimeError):
    """A grammar-constrained request reached a state where EVERY
    candidate token is masked out (the model must emit something, the
    grammar admits nothing — e.g. max_new_tokens ran out mid-structure
    with no legal stopping point, or the sampler returned the all-
    banned sentinel). The request fails TYPED instead of sampling from
    a renormalized-empty distribution; the HTTP layer maps this to
    422 — the request was well-formed, the constrained generation is
    unprocessable."""


@dataclasses.dataclass(frozen=True)
class SamplingOptions:
    """Per-REQUEST sampling knobs. The engine batches these into [slots]
    arrays so one compiled decode step serves mixed requests
    (inference/sampling.py sample_batched)."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0


_req_ids = itertools.count()


class GenRequest:
    """One generation request flowing through the engine.

    Completion is signalled through a threading.Event so HTTP handler
    threads can block on `result()` while the engine thread decodes."""

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 sampling: SamplingOptions = SamplingOptions(),
                 seed: int = 0, priority: int = 0,
                 deadline_s: Optional[float] = None,
                 arrival_id: Optional[int] = None,
                 adapter_id=None):
        assert prompt, "empty prompt"
        assert max_new_tokens >= 0, max_new_tokens
        # `arrival_id` lets the router's failover retries preserve the
        # ORIGINAL arrival position: the scheduler's EDF key ties break
        # on this id, so a resubmitted victim re-enters a survivor's
        # queue where its first attempt stood, not at the back
        self.id = next(_req_ids) if arrival_id is None else int(arrival_id)
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.sampling = sampling
        self.seed = int(seed)
        # SLO fields: higher `priority` wins admission ordering and may
        # preempt lower-priority running slots (ServingConfig.preemption);
        # `deadline_s` overrides the engine-wide request_deadline_s for
        # this request (None inherits the engine default)
        self.priority = int(priority)
        self.deadline_s = (None if deadline_s is None
                           else float(deadline_s))
        # a NaN deadline would make every expiry comparison False (an
        # unreapable request) and poison the scheduler's EDF sort key
        # for OTHER requests; the HTTP validator rejects these with a
        # 400 before construction — this guards direct API callers
        assert self.deadline_s is None or (
            math.isfinite(self.deadline_s) and self.deadline_s > 0.0), (
            f"deadline_s must be a finite number > 0, "
            f"got {self.deadline_s}")
        self.state = RequestState.QUEUED
        self.generated: List[int] = []
        self.gen_logprobs: List[float] = []
        self.error: Optional[str] = None
        self.error_kind: str = "error"
        # lifecycle timestamps (metrics: queue wait, TTFT, decode rate)
        self.submit_time = time.monotonic()
        self.admit_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self._done = threading.Event()
        # per-token progress (append_token and the terminal transitions
        # notify): what `wait_token` blocks on
        self._progress = threading.Condition()
        # terminal transitions are check-then-act (finish/fail race
        # between the engine loop, the watchdog thread, and HTTP
        # cancel paths); this lock makes first-wins ATOMIC so the
        # terminal-accounting hook below can fire exactly once per
        # request — the request-conservation invariant
        # (serving/invariants.py) rests on it
        self._term_lock = threading.Lock()
        # terminal-accounting hook (set by the engine at submit):
        # called exactly once, AFTER the winning terminal transition,
        # with (request, outcome) where outcome is one of
        # "completed" | "expired" | "cancelled" | "failed" — the single
        # choke point behind the metrics conservation law
        # requests_received == completed + rejected + failed +
        # cancelled + expired (+ in-flight)
        self._on_terminal = None
        self.cancelled = False
        # prefix-cache bookkeeping (engine thread): tokens whose KV was
        # reused through a region clone instead of a forward pass, and
        # the number of prefill chunks the prompt's forward was split
        # into (1 = monolithic). Observability only — correctness is
        # pinned by the token-exact cache-on/off tests.
        self.prefix_len = 0
        self.prefill_chunks = 0
        # preemption bookkeeping (engine thread): a preempted request
        # re-queues carrying its resumption state — `resume_rng` is the
        # state of the slot's torch.Generator at preemption, a host
        # uint8 tensor (empty for a greedy row, which draws nothing), so
        # the stream continues exactly where it stopped; `parked` holds
        # the (sub_cache, last_logits_row) copies taken out of the
        # victim slot (insert-only resume, no re-prefill). `parked` may
        # be dropped (engine restart, park budget) — the request then
        # replays its effective prompt through prefill, still
        # token-exact because `resume_rng` survives on the host.
        self.preemptions = 0
        self.resume_rng = None
        self.parked = None
        # speculative decoding: the residual-carry token banned from
        # this request's next sample (a stochastic rejection in its
        # last verify round; -1 = none). Saved at preemption alongside
        # resume_rng — distribution correctness needs the ban to
        # survive a park/replay exactly like the PRNG chain does.
        # Unlike draft proposals (droppable, re-proposed every window)
        # this IS committed sampling state.
        self.resume_reject = -1
        # multi-tenant LoRA serving (serving/adapters.py): the adapter
        # this request decodes under (None = base model) and the bank
        # row the engine resolved it to at admission (0 = identity;
        # engine-thread bookkeeping, re-resolved after preemption /
        # restart — the bank row may have been recycled meanwhile, the
        # ID is the stable key). `adapter_ns` is the (id, registration
        # generation) prefix-cache namespace captured at FIRST
        # admission: a re-register mid-flight changes the generation,
        # and the engine fails the request rather than resume its
        # stream under different weights.
        self.adapter_id = adapter_id
        self.adapter_ns = None
        self.bank_idx = 0
        # structured output (serving/structured.py): `fsm` is the
        # TokenFSM compiled at submit (shared across an n-best
        # fan-out's samples — compile once), `fsm_state` the integer
        # automaton state after the committed tokens. HOST-side by
        # construction, so it survives preemption/park/resume and
        # engine restarts exactly like the PRNG chain does — replaying
        # the effective prompt re-lands the slot at the same state the
        # host already tracks. `response_format` keeps the source
        # grammar for observability / the invariant checker.
        self.response_format = None
        self.fsm = None
        self.fsm_state = 0
        # parallel sampling (n-best fan-out): which sample of a
        # fan-out this request is (0 = the PREFILL LEADER whose
        # retained prompt KV the siblings alias copy-on-write), and
        # the leader request siblings gate their admission on — a
        # sibling admits after its leader's prompt KV is indexed (or
        # the leader went terminal, in which case it admits standalone
        # rather than deadlock). None/0 for plain requests.
        self.sample_index = 0
        self.fanout_leader: Optional["GenRequest"] = None

    def effective_prompt(self) -> List[int]:
        """Tokens whose KV must be slot-resident before the next decode
        step: the prompt plus everything generated so far (the prompt
        for a never-preempted request)."""
        return self.prompt + self.generated

    def absolute_deadline(self, default_s: Optional[float] = None
                          ) -> Optional[float]:
        """Monotonic-clock instant this request expires (per-request
        deadline_s, else `default_s`, else None = no deadline)."""
        d = self.deadline_s if self.deadline_s is not None else default_s
        return None if d is None else self.submit_time + d

    def cancel(self):
        """Best-effort: a QUEUED request is dropped before admission; a
        RUNNING one is evicted at the next decode step (its slot frees
        without waiting for EOS/max-tokens)."""
        self.cancelled = True

    # ---- engine side -------------------------------------------------
    def mark_admitted(self):
        # never resurrect a terminal request: the watchdog (its own
        # thread) may have failed this request while the engine was
        # mid-admission — overwriting FAILED with RUNNING would make
        # result() return partial tokens instead of raising
        if self._done.is_set():
            return
        self.state = RequestState.RUNNING
        self.admit_time = time.monotonic()

    def append_token(self, token: int, logprob: float):
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        self.generated.append(int(token))
        self.gen_logprobs.append(float(logprob))
        self._notify_progress()

    def _notify_progress(self):
        with self._progress:
            self._progress.notify_all()

    def wait_token(self, i: int, timeout: Optional[float] = None) -> bool:
        """Block until token index `i` exists in `generated` or the request
        is terminal (the SSE streaming cursor's wait). True in either case,
        False on timeout: the caller tells "token ready" from "stream over"
        by reading `len(generated)` and `done()` again."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._progress:
            while len(self.generated) <= i and not self._done.is_set():
                if deadline is None:
                    self._progress.wait()
                    continue
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._progress.wait(rem)
        return True

    def _fire_terminal(self, outcome: str):
        hook = self._on_terminal
        if hook is not None:
            hook(self, outcome)

    def finish(self) -> bool:
        """First terminal transition wins — ATOMICALLY (the engine
        loop, the hung-step watchdog, and HTTP cancel paths may race):
        a request the watchdog already failed stays failed. Returns
        True when THIS call transitioned the request.

        The accounting hook fires BEFORE `_done` is set (and before any
        waiter can wake): a caller unblocked by `result()` must find the
        terminal counters already updated, or a strict conservation
        sweep racing the terminal thread would see a phantom dropped
        transition. The hook only takes the metrics lock — no cycle
        with `_term_lock` — and `_done.set()` is in a finally so a
        failing hook can never strand the waiters."""
        with self._term_lock:
            if self._done.is_set():
                return False
            self.state = RequestState.FINISHED
            self.finish_time = time.monotonic()
            try:
                self._fire_terminal("completed")
            finally:
                self._done.set()
        self._notify_progress()
        return True

    def fail(self, msg: str, kind: str = "error") -> bool:
        """`kind` picks the exception `result()` raises: "deadline" →
        DeadlineExceededError (504), "unavailable" →
        ServiceUnavailableError (503), "grammar" → GrammarDeadEndError
        (422), anything else → RequestFailedError. Idempotent AND atomic: the first terminal
        transition wins (the watchdog and the engine loop may race to
        fail the same request — the lock makes the winner unique, so
        the terminal-accounting hook fires exactly once). Returns True
        when THIS call transitioned the request."""
        with self._term_lock:
            if self._done.is_set():
                return False
            self.state = RequestState.FAILED
            self.error = msg
            self.error_kind = kind
            self.finish_time = time.monotonic()
            self.parked = None  # drop parked KV device refs promptly
            try:
                # terminal taxonomy for the conservation law: a
                # deadline death is "expired", a caller-initiated
                # cancellation "cancelled", everything else (crash/
                # hang/breaker/drain/nonfinite/adapter) "failed" —
                # exactly one bucket per request, counted BEFORE any
                # waiter can wake (see finish())
                self._fire_terminal("expired" if kind == "deadline"
                                    else "cancelled" if self.cancelled
                                    else "failed")
            finally:
                self._done.set()
        self._notify_progress()
        return True

    # ---- caller side -------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until finished; returns (tokens, logprobs) where tokens
        is prompt + generated (the serial path's row layout,
        inference/generation.py generate)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still {self.state}")
        # `error` is checked alongside state so a racing state write
        # (admission bookkeeping vs the watchdog's fail) can never
        # turn a failed request into a bogus success
        if self.state is RequestState.FAILED or self.error is not None:
            kind = getattr(self, "error_kind", "error")
            if kind == "deadline":
                raise DeadlineExceededError(
                    f"request {self.id}: {self.error}")
            if kind == "unavailable":
                raise ServiceUnavailableError(
                    f"request {self.id}: {self.error}")
            if kind == "grammar":
                raise GrammarDeadEndError(
                    f"request {self.id}: {self.error}")
            raise RequestFailedError(
                f"request {self.id} failed: {self.error}")
        return self.prompt + self.generated, list(self.gen_logprobs)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class FanoutRequest:
    """Aggregate handle over an n-best fan-out's child GenRequests
    (engine.submit with best_of > 1): ONE prompt, `best_of` independently
    seeded decode streams sharing the prompt's physical KV blocks
    copy-on-write, of which the `n` highest-scoring completions are
    returned. Each child is a full GenRequest (its own slot, seed
    `seed + i`, terminal accounting) — this wrapper only aggregates.

    Ranking: cumulative generated logprob, descending (ties break on
    sample index for determinism). With n == best_of the ranking is a
    stable reorder of all samples."""

    def __init__(self, children: List[GenRequest], n: int):
        assert children, "fan-out with no samples"
        assert 1 <= n <= len(children), (n, len(children))
        self.children = list(children)
        self.n = int(n)
        self.best_of = len(children)
        self.id = children[0].id
        self.prompt = children[0].prompt

    def done(self) -> bool:
        return all(c.done() for c in self.children)

    def cancel(self) -> None:
        for c in self.children:
            c.cancel()

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for c in self.children:
            rem = (None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
            if not c._done.wait(rem):
                return False
        return True

    def result(self, timeout: Optional[float] = None):
        """Block until every sample resolves; returns (tokens_list,
        logprobs_list) — the n best completions, each entry the same
        (prompt + generated, logprobs) shape a plain GenRequest's
        result() has. If fewer than n samples completed, the first
        failed child's typed error propagates (so a deadline/grammar/
        crash death keeps its HTTP status)."""
        if not self.wait(timeout):
            pending = [c.id for c in self.children if not c.done()]
            raise TimeoutError(f"fan-out {self.id}: samples {pending} "
                               "still running")
        completed, first_error = [], None
        for c in self.children:
            try:
                toks, lps = c.result(timeout=0)
                completed.append((c.sample_index, toks, lps))
            except Exception as e:  # noqa: BLE001 — typed, re-raised below
                if first_error is None:
                    first_error = e
        if len(completed) < self.n:
            raise first_error
        completed.sort(key=lambda t: (-sum(t[2]), t[0]))
        top = completed[:self.n]
        return [t[1] for t in top], [t[2] for t in top]
