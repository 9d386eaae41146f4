"""Prefix-affinity router with health-driven failover
(megatron_tpu/serving/router.py): the in-process front door over N
`ServingEngine` replicas.

One replica dies with its loop or its crash-loop breaker; N replicas behind
a router survive any one of them crashing, wedging or draining. The router
reads only host-side signals the engine already has: `health()` (liveness,
breaker, queue, busy slots, the service-time EWMA) and `prefix_peek` (the
prefix index and the host KV tier).

- Cache-aware routing: a request goes to the replica whose prefix cache
  holds the longest match for its prompt (under its adapter's namespace),
  then to one holding its LoRA adapter on the device (`adapter_peek` 2)
  over one a load away (1), ties broken by the least load: (queue depth +
  busy slots + pending prefills) x the replica's service-time EWMA, both
  from its last `health()` snapshot. A prefix hit saves forward work every
  time; a cold adapter load is paid once.
- Health-driven failover: a replica whose snapshot reports draining, an
  open breaker or a dead loop, or that has not given a healthy snapshot
  within `heartbeat_timeout_s` (a wedged one gets that grace: its
  watchdog may restart it), is ejected (`router_failovers`). Work it
  failed, or work stuck on it once it is ejected, is resubmitted to a
  survivor with bounded retries and backoff (`router_retries`) under its
  original arrival id. Every request carries a concrete seed, so a full
  resubmission regenerates the same tokens: retried completions are
  token-exact. Only when every replica is down does `submit` raise
  `NoReplicaAvailableError` (HTTP 503).
- Half-open recovery: a DOWN replica whose snapshot is healthy again
  becomes PROBING; exactly one canary request goes to it, its success
  promotes it to UP and its failure ejects it again for `probe_backoff_s`.

With one replica the pick is the identity and a healthy replica's requests
never retry; the server builds a router only for `num_replicas >= 2`.

Thread contract: `submit`, `cancel`, `health` and `queue_depth` run on
HTTP threads under the router lock; retries are driven by the caller's
thread inside `RouterRequest.wait_done` / `wait_token` (there is no router
thread to die, and every future a caller waits on resolves).

- Rolling upgrade (`rolling_upgrade`): the checkpoint is staged once, then
  one replica at a time is drained (held out of rotation: its traffic
  fails over), swapped (`ServingEngine.swap_weights` with the shared
  staged copy), probed by one canary request under the new weights and
  re-admitted, so at most one replica is ever out of rotation. A refusal
  aborts the walk with `RollingUpgradeError` while the fleet serves on.
- `register_adapter` registers an adapter on every replica, so a failover
  can resume an adapter request anywhere.

A request's `response_format` rides to the replica, which compiles it at
admission (a failover replays the same constrained stream); fan-out
(`n`/`best_of` > 1) is refused with an AdmissionError, as the reference
refuses it.

The replicas may be `RemoteReplica`s (serving/remote.py): replica
processes reached over HTTP, which satisfy the same duck type. Then the
router is a front tier that holds no weights; a rolling upgrade lets each
replica stage the checkpoint itself, and `affinity_digest` merges the
replicas' digests for a router one tier further out.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

from megatron_tpu_torch.serving.metrics import _BASE_COUNTERS, ServingMetrics
from megatron_tpu_torch.serving.request import (RequestState,
                                                SamplingOptions,
                                                ServiceUnavailableError)
from megatron_tpu_torch.serving.scheduler import (AdmissionError,
                                                  EngineUnhealthyError)
from megatron_tpu_torch.serving.weights import WeightSwapError, load_staged
from megatron_tpu_torch.utils.logging import print_rank_0

UP, DOWN, PROBING = "up", "down", "probing"

# engine gauges summed across replicas in the aggregate /metrics snapshot
_SUM_GAUGES = ("queue_depth", "active_slots", "num_slots",
               "kv_blocks_used", "kv_blocks_retained", "kv_bytes_wasted",
               "active_adapters")
# engine gauges reported as the worst replica: per-step readings and the
# attention path, which summing would turn into values no replica has,
# and the brownout level (max by contract: a fleet scrape reports its
# most-degraded replica)
_MAX_GAUGES = ("kv_gather_bytes_per_step", "kv_attn_path", "degrade_level")
# gauges the router sets itself on the aggregate snapshot
_ROUTER_GAUGES = ("fleet_replicas_up",)

class NoReplicaAvailableError(ServiceUnavailableError):
    """Every replica is ejected or down: the HTTP layer answers 503."""


class RollingUpgradeError(RuntimeError):
    """A rolling upgrade aborted: the failing replica kept (or is back on)
    its previous weights and re-enters rotation through the half-open
    canary. The fleet serves on: upgraded replicas stay on the new version,
    the rest on the old (the weight_version min/max gauges show it)."""


class _Replica:
    __slots__ = ("idx", "engine", "state", "last_health", "last_healthy_t",
                 "down_until", "canary", "canary_t", "upgrading")

    def __init__(self, idx: int, engine):
        self.idx = idx
        self.engine = engine
        self.state = UP
        self.last_health: dict = {}
        self.last_healthy_t = time.monotonic()
        self.down_until = 0.0
        self.canary = None  # the RouterRequest probing this replica
        self.canary_t = 0.0
        # a planned drain (rolling_upgrade): held out of rotation, its work
        # failing over, until the swap's verdict
        self.upgrading = False


class RouterRequest:
    """The future a router caller holds: a facade over the current
    attempt's `GenRequest` that resubmits on retryable failures. Token
    reads (`generated`, `wait_token`) follow the live attempt: a retry
    regenerates the same stream (same prompt, seed and sampling), so a
    streaming reader's delivered indices replay equal and it waits for the
    regeneration to pass its cursor."""

    def __init__(self, router: "EngineRouter", spec: dict):
        self._router = router
        self.spec = spec
        self.arrival_id: Optional[int] = None
        self.attempts = 0
        self.inner = None          # the current attempt's GenRequest
        self.replica: Optional[_Replica] = None
        self.cancelled = False
        self._terminal = None      # ("ok"|"err", GenRequest) | ("exc", e)
        self._lock = threading.RLock()
        self._last_health_check = 0.0  # rate-limits _pump's re-check

    @property
    def id(self):
        return self.arrival_id

    @property
    def prompt(self) -> List[int]:
        return self.spec["prompt"]

    @property
    def generated(self) -> List[int]:
        inner = self.inner
        return inner.generated if inner is not None else []

    @property
    def gen_logprobs(self) -> List[float]:
        inner = self.inner
        return inner.gen_logprobs if inner is not None else []

    def done(self) -> bool:
        return self._terminal is not None

    def cancel(self):
        self.cancelled = True
        inner, rep = self.inner, self.replica
        if inner is not None and rep is not None:
            rep.engine.cancel(inner)

    # ---- the retry pump (caller thread) ------------------------------
    def _settle(self, terminal: str, attempt_ok: Optional[bool]):
        """Mark terminal and report the attempt's verdict to the canary
        bookkeeping (None: inconclusive, frees the canary slot)."""
        self._terminal = (terminal, self.inner)
        self._router._note_attempt(self.replica, self, ok=attempt_ok)

    def _on_inner_done(self):
        with self._lock:
            if self._terminal is not None:
                return
            inner = self.inner
            if not inner.done():
                return  # a concurrent pump already retried this attempt
            if inner.state is RequestState.FINISHED and inner.error is None:
                self._settle("ok", True)
                return
            if self.cancelled or inner.error_kind in ("deadline",
                                                      "grammar"):
                # the client gave up, the deadline burned, or the grammar
                # dead-ended (the same grammar, prompt and seed dead-end on
                # every replica): a retry cannot help, and none says the
                # replica is broken
                self._settle("err", None)
                return
            # a retryable failure of the replica (crash, hang, shutdown)
            self._retry(f"attempt on replica {self.replica.idx} failed: "
                        f"{inner.error}")

    def _retry(self, why: str):
        failed = self.replica
        if self.attempts >= self._router.max_retries:
            inner = self.inner
            if inner is not None and not inner.done():
                # exhaustion can settle on a still-running attempt (a
                # wedged replica may never consume the cancel): fail it
                # now, so result() raises the typed retryable 503
                inner.fail(
                    "router: failover retries exhausted "
                    f"({self._router.max_retries}) after replica "
                    f"failures; retry against another front door ({why})",
                    kind="unavailable")
            self._settle("err", False)
            return
        self._router._note_attempt(failed, self, ok=False)
        self._router.metrics.count("router_retries")
        self.attempts += 1
        time.sleep(min(self._router.retry_backoff_s * self.attempts, 1.0))
        try:
            self._router._dispatch(
                self, exclude=(failed.idx,) if failed is not None else ())
        except Exception as e:  # noqa: BLE001 — the typed 503/429 is kept
            self._terminal = ("exc", e)
        else:
            print_rank_0(f"router: requeued request {self.arrival_id} onto "
                         f"replica {self.replica.idx} (attempt "
                         f"{self.attempts + 1}; {why})")

    def _pump(self, step: float, token_i: Optional[int] = None):
        """One wait-and-check beat: wait on the current attempt (on token
        `token_i` for a streaming cursor, so tokens are delivered as they
        land), then detect a replica ejected mid-flight (an attempt on a
        wedged, ejected replica may never resolve: cancel it there and
        retry on a survivor). The health re-check is rate-limited per
        request, so waiting callers do not serialise on the router lock."""
        inner, rep = self.inner, self.replica
        if token_i is None:
            inner._done.wait(step)
        else:
            inner.wait_token(token_i, step)
        if inner.done():
            self._on_inner_done()
            return
        now = time.monotonic()
        if now - self._last_health_check < 0.5:
            return
        self._last_health_check = now
        if rep is not None and self._router._check_replica(rep) == DOWN \
                and not inner.done():
            with self._lock:
                if self._terminal is None and self.inner is inner:
                    rep.engine.cancel(inner)
                    self._retry(f"replica {rep.idx} ejected mid-flight")

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._terminal is None:
            step = 0.25
            if deadline is not None:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                step = min(step, rem)
            self._pump(step)
        return True

    def wait_token(self, i: int, timeout: Optional[float] = None) -> bool:
        """True once token i exists on the live attempt or the request is
        terminal: the streaming cursor's wait, driving the same retry pump
        as `wait_done`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            inner = self.inner
            if inner is not None and len(inner.generated) > i:
                return True
            if self._terminal is not None:
                return True
            step = 0.25
            if deadline is not None:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                step = min(step, rem)
            self._pump(step, token_i=i)

    def result(self, timeout: Optional[float] = None):
        if not self.wait_done(timeout):
            raise TimeoutError(f"router request {self.arrival_id} still "
                               f"pending (attempt {self.attempts + 1})")
        kind, val = self._terminal
        if kind == "exc":
            raise val
        # the settled attempt's own result(): the tokens, or its typed
        # error
        return val.result(timeout=0.001)


class EngineRouter:
    """In-process front door over N engine replicas (the module docstring
    has the policy). Shaped like `ServingEngine` where the HTTP layer
    touches it: submit, cancel, generate, drain, close, health,
    queue_depth, metrics, max_len."""

    def __init__(self, engines: Sequence, metrics: Optional[ServingMetrics]
                 = None, max_retries: int = 2,
                 heartbeat_timeout_s: float = 5.0,
                 probe_backoff_s: float = 0.5,
                 retry_backoff_s: float = 0.05):
        if not engines:
            raise ValueError("the router needs at least one replica")
        self.replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.max_retries = max(int(max_retries), 0)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.probe_backoff_s = float(probe_backoff_s)
        self.retry_backoff_s = float(retry_backoff_s)
        # a canary's verdict is settled by its waiting caller; past this
        # with no verdict (the caller went away) the slot frees and the
        # next request probes afresh
        self.canary_timeout_s = max(self.heartbeat_timeout_s * 2, 10.0)
        self.max_len = min(e.max_len for e in engines)
        self._lock = threading.RLock()

    # ---- health tracking, ejection, half-open probing ----------------
    def _eval_replica(self, rep: _Replica, now: float) -> str:
        """Refresh one replica's snapshot and classify it: DOWN when the
        snapshot fails, reports a hard-down state (breaker open, draining,
        loop dead), or no healthy snapshot came within the heartbeat
        deadline (a wedged replica's grace)."""
        try:
            h = rep.engine.health()
        except Exception:  # noqa: BLE001 — a missed heartbeat
            h = None
        if h is not None:
            rep.last_health = h
        hard_down = (h is None or h.get("circuit_breaker_open")
                     or h.get("state") in ("draining", "unhealthy")
                     or not h.get("loop_alive", False))
        if not hard_down and h.get("healthy") \
                and h.get("state") == "running":
            rep.last_healthy_t = now
        missed = now - rep.last_healthy_t > self.heartbeat_timeout_s
        return DOWN if (hard_down or missed) else UP

    def _check_replica(self, rep: _Replica) -> str:
        with self._lock:
            self._refresh_one(rep, time.monotonic())
            return rep.state

    def _refresh_one(self, rep: _Replica, now: float):
        if rep.upgrading:
            # healthy, but held out of rotation like a DOWN replica (its
            # work fails over by the same retry path); no canary until the
            # swap's verdict
            rep.state = DOWN
            rep.canary = None
            return
        verdict = self._eval_replica(rep, now)
        if verdict == DOWN:
            if rep.state != DOWN:
                self.metrics.count("router_failovers")
                why = (rep.last_health or {}).get("state", "no heartbeat")
                print_rank_0(f"router: replica {rep.idx} ejected ({why}); "
                             "traffic fails over to survivors")
                rep.state = DOWN
                rep.down_until = now + self.probe_backoff_s
                rep.canary = None
        elif rep.state == DOWN and now >= rep.down_until:
            # a healthy snapshot again: half-open, admit one canary
            rep.state = PROBING
            rep.canary = None
            print_rank_0(f"router: replica {rep.idx} half-open (awaiting "
                         "canary)")
        elif rep.state == PROBING and rep.canary is not None \
                and now - rep.canary_t > self.canary_timeout_s:
            # an abandoned canary: free the slot for a fresh probe
            rep.canary = None
            print_rank_0(f"router: replica {rep.idx} canary abandoned "
                         f"(> {self.canary_timeout_s:.0f}s); re-probing")

    def _refresh_locked(self):
        now = time.monotonic()
        for rep in self.replicas:
            self._refresh_one(rep, now)

    def _note_attempt(self, rep: Optional[_Replica], rreq,
                      ok: Optional[bool]):
        """Canary bookkeeping: the probing replica's one canary promotes
        it (success) or ejects it again (failure); None (cancel, deadline)
        is inconclusive and frees the canary slot."""
        if rep is None:
            return
        with self._lock:
            if rep.canary is not rreq:
                return
            rep.canary = None
            if rep.state != PROBING or ok is None:
                return
            if ok:
                rep.state = UP
                print_rank_0(f"router: replica {rep.idx} canary succeeded; "
                             "back in full rotation")
            else:
                rep.state = DOWN
                rep.down_until = time.monotonic() + self.probe_backoff_s
                print_rank_0(f"router: replica {rep.idx} canary failed; "
                             "ejected again")

    # ---- routing -----------------------------------------------------
    def _load(self, rep: _Replica) -> float:
        """The least-loaded tie-break: work queued or running there times
        its observed service time."""
        h = rep.last_health or {}
        waiting = (h.get("queue_depth", 0) + h.get("active_slots", 0)
                   + h.get("prefilling", 0))
        return float(waiting) * max(
            float(h.get("service_time_ewma_ms", 0.0)), 1.0)

    def _pick_locked(self, tokens: Sequence[int], exclude=(),
                     adapter_id=None):
        """(replica, is_canary): a PROBING replica with no canary in flight
        takes the request as its canary; otherwise among UP replicas the
        longest `prefix_peek` under the adapter's namespace, then adapter
        locality (`adapter_peek`), ties by the least load."""
        self._refresh_locked()
        for rep in self.replicas:
            if rep.idx not in exclude and rep.state == PROBING \
                    and rep.canary is None:
                return rep, True
        best, best_key = None, None
        for rep in self.replicas:
            if rep.idx in exclude or rep.state != UP:
                continue
            apeek = (rep.engine.adapter_peek(adapter_id)
                     if adapter_id is not None else 0)
            key = (-rep.engine.prefix_peek(tokens, adapter_id), -apeek,
                   self._load(rep), rep.idx)
            if best_key is None or key < best_key:
                best, best_key = rep, key
        if best is None:
            # no UP replica and every PROBING one has its canary out: a
            # probing replica is healthy by its snapshot, so it serves; a
            # 503 is for replicas that are actually DOWN
            for rep in self.replicas:
                if rep.idx not in exclude and rep.state == PROBING:
                    return rep, False
        return best, False

    def _dispatch(self, rreq: RouterRequest, exclude=()):
        """Route one attempt, trying candidates in pick order: a replica's
        submit-time refusal (queue full, breaker) moves on to the next.
        Raises the last refusal when every candidate refused, and
        NoReplicaAvailableError when there is no candidate."""
        spec = rreq.spec
        tried = set()
        relaxed = False
        last_err: Optional[Exception] = None
        while True:
            with self._lock:
                rep, is_canary = self._pick_locked(
                    spec["prompt"], exclude=tried | set(exclude),
                    adapter_id=spec["adapter_id"])
                if rep is None and exclude and not relaxed:
                    # the just-failed replica may be the only one left
                    # standing: take it again rather than answer 503
                    relaxed = True
                    rep, is_canary = self._pick_locked(
                        spec["prompt"], exclude=tried,
                        adapter_id=spec["adapter_id"])
                if rep is None:
                    break
                if is_canary:
                    rep.canary = rreq
                    rep.canary_t = time.monotonic()
            tried.add(rep.idx)
            try:
                inner = rep.engine.submit(
                    spec["prompt"], spec["max_new_tokens"],
                    spec["sampling"], seed=spec["seed"],
                    priority=spec["priority"],
                    deadline_s=spec["deadline_s"],
                    arrival_id=rreq.arrival_id,
                    adapter_id=spec["adapter_id"],
                    response_format=spec["response_format"])
            except AdmissionError:
                with self._lock:
                    if rep.canary is rreq:
                        rep.canary = None
                raise  # 400: no replica can serve it
            except Exception as e:  # noqa: BLE001 — one replica refused
                last_err = e
                with self._lock:
                    if rep.canary is rreq:
                        rep.canary = None
                    if isinstance(e, EngineUnhealthyError):
                        # breaker open: eject now, not at the next refresh
                        self._refresh_one(rep, time.monotonic())
                continue
            with self._lock:
                rreq.inner = inner
                rreq.replica = rep
                if rreq.arrival_id is None:
                    rreq.arrival_id = inner.id
            return
        if last_err is not None:
            raise last_err
        raise NoReplicaAvailableError(
            f"all {len(self.replicas)} replicas are down (ejected by "
            "health checks); retry later")

    # ---- the public API (ServingEngine-shaped) -----------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               sampling: SamplingOptions = SamplingOptions(),
               seed: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None,
               arrival_id: Optional[int] = None,
               adapter_id=None, response_format=None, n: int = 1,
               best_of: Optional[int] = None) -> RouterRequest:
        """Route one request. `response_format` rides to the replica (each
        attempt compiles the grammar at admission, so a failover replays
        the same constrained stream). Fan-out is refused: the retry pump
        fronts one GenRequest, and a FanoutRequest has no state for it to
        read."""
        if (best_of or n or 1) > 1:
            raise AdmissionError(
                "parallel sampling (n/best_of > 1) is not supported "
                "behind the EngineRouter; submit to a replica engine "
                "directly or fan out client-side with n=1 requests")
        rreq = RouterRequest(self, dict(
            prompt=list(prompt), max_new_tokens=int(max_new_tokens),
            sampling=sampling, seed=int(seed), priority=int(priority),
            deadline_s=deadline_s, adapter_id=adapter_id,
            response_format=response_format))
        if arrival_id is not None:
            rreq.arrival_id = int(arrival_id)
        # requests_received is counted by the replica each attempt lands
        # on, and the aggregate snapshot sums those
        self._dispatch(rreq)
        return rreq

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 64,
                 sampling: SamplingOptions = SamplingOptions(),
                 seed: int = 0, timeout: Optional[float] = None,
                 adapter_id=None):
        return self.submit(prompt, max_new_tokens, sampling, seed,
                           adapter_id=adapter_id).result(timeout)

    def cancel(self, rreq: RouterRequest):
        rreq.cancel()

    @property
    def engines(self) -> List:
        """The replica engines in index order: the invariant checker's
        walk (serving/invariants.py sweeps each, then the router-level
        laws)."""
        return [rep.engine for rep in self.replicas]

    def queue_depth(self) -> int:
        n = 0
        for rep in self.replicas:
            try:
                n += rep.engine.queue_depth()
            except Exception:  # noqa: BLE001 — a dead replica queues 0
                pass
        return n

    def prefix_peek(self, tokens: Sequence[int], adapter_id=None) -> int:
        return max(rep.engine.prefix_peek(tokens, adapter_id)
                   for rep in self.replicas)

    def adapter_peek(self, adapter_id) -> int:
        return max(rep.engine.adapter_peek(adapter_id)
                   for rep in self.replicas)

    def register_adapter(self, adapter_id, path: Optional[str] = None,
                         factors=None, rank: Optional[int] = None,
                         alpha: float = 1.0):
        """Register on every replica, so a failover can resume an adapter
        request anywhere (each bank loads it at first use)."""
        for rep in self.replicas:
            rep.engine.register_adapter(adapter_id, path=path,
                                        factors=factors, rank=rank,
                                        alpha=alpha)

    def rolling_upgrade(self, ckpt_dir: str,
                        swap_timeout_s: Optional[float] = None,
                        canary_timeout_s: float = 60.0):
        """Upgrade the fleet to `ckpt_dir` one replica at a time (router.py
        rolling_upgrade): stage once, then for each replica drain (held
        out of rotation), swap, canary and re-admit. A replica already
        hard down is skipped. Returns the new WeightVersion; counts
        `rolling_upgrades` on completion. Raises RollingUpgradeError on a
        refusal (the fleet serves on); a staging refusal counts
        `weight_swap_failures` once on the router. Over remote replicas
        nothing is staged here (host buffers cannot cross a process
        boundary): each replica stages `ckpt_dir` itself inside its swap,
        one read a process."""
        example = next((rep.engine.gen.params for rep in self.replicas
                        if hasattr(rep.engine, "gen")), None)
        staged = None
        if example is not None:
            try:
                staged = load_staged(ckpt_dir, example)
            except WeightSwapError as e:
                self.metrics.count("weight_swap_failures")
                raise RollingUpgradeError(
                    f"rolling upgrade refused before any replica drained: "
                    f"{e}; the fleet keeps serving") from e
        version = None
        for rep in self.replicas:
            try:
                h = rep.engine.health()
            except Exception:  # noqa: BLE001 — unreachable is down
                h = None
            if h is None or h.get("circuit_breaker_open") \
                    or not h.get("loop_alive", False):
                print_rank_0(f"router: rolling upgrade skips replica "
                             f"{rep.idx} (already down: "
                             f"{(h or {}).get('detail', 'unreachable')})")
                continue
            with self._lock:
                rep.upgrading = True
                rep.state = DOWN
                rep.canary = None
            print_rank_0(f"router: rolling upgrade: replica {rep.idx} "
                         "draining (its traffic fails over)")
            try:
                version = rep.engine.swap_weights(
                    ckpt_dir, timeout=swap_timeout_s, staged=staged)
            except Exception as e:
                # the refused swap flipped nothing: the replica re-enters
                # rotation through the half-open canary
                with self._lock:
                    rep.upgrading = False
                    rep.state = DOWN
                    rep.down_until = time.monotonic()
                raise RollingUpgradeError(
                    f"rolling upgrade aborted at replica {rep.idx}: {e}; "
                    "the fleet keeps serving (upgraded replicas on the new "
                    "version, this and later ones on the old)") from e
            ok = self._canary_probe(rep, timeout=canary_timeout_s)
            with self._lock:
                rep.upgrading = False
                if ok:
                    rep.state = UP
                    rep.last_healthy_t = time.monotonic()
                else:
                    rep.state = DOWN
                    rep.down_until = time.monotonic() + self.probe_backoff_s
            if not ok:
                raise RollingUpgradeError(
                    f"rolling upgrade aborted: replica {rep.idx} failed its "
                    f"canary under {version.label}; it stays ejected "
                    "(half-open re-admission applies) and the fleet keeps "
                    "serving")
            print_rank_0(f"router: replica {rep.idx} upgraded to "
                         f"{version.label} and re-admitted (canary passed)")
        if version is None:
            raise RollingUpgradeError(
                "rolling upgrade applied to no replica (every replica is "
                "already down)")
        self.metrics.count("rolling_upgrades")
        return version

    def _canary_probe(self, rep: _Replica, timeout: float = 60.0) -> bool:
        """One canary on a just-swapped replica, submitted to its engine
        directly (it is still out of rotation): a one-token greedy request
        must complete and the replica must still accept."""
        try:
            req = rep.engine.submit([1], 1, SamplingOptions(temperature=0.0),
                                    seed=0, deadline_s=max(timeout, 1.0))
            req.result(timeout=timeout)
            return bool(rep.engine.health().get("accepting"))
        except Exception:  # noqa: BLE001 — any failure fails the canary
            return False

    def affinity_digest(self) -> dict:
        """The replicas' affinity digests merged (`GET /affinity` of a
        router-fronted process): the union of the chains and the highest
        residency of each adapter. Affinity is a hint, so claiming a hit
        one replica holds costs a worse pick, never a wrong token; a
        replica that cannot answer adds nothing."""
        merged: dict = {"granularity": 0, "namespaces": {}, "adapters": {}}
        for rep in self.replicas:
            try:
                d = rep.engine.affinity_digest()
            except Exception:  # noqa: BLE001 — a dead replica has none
                continue
            merged["granularity"] = (merged["granularity"]
                                     or int(d.get("granularity", 0)))
            for label, chain in d.get("namespaces", {}).items():
                merged["namespaces"].setdefault(label, set()).update(chain)
            for aid, level in d.get("adapters", {}).items():
                merged["adapters"][aid] = max(
                    merged["adapters"].get(aid, 0), int(level))
        merged["namespaces"] = {label: sorted(v) for label, v
                                in merged["namespaces"].items()}
        return merged

    def health(self) -> dict:
        """The router's `/healthz` payload: `state` tells DEGRADED (some
        replicas down, still serving: ready, 200) from DOWN (none left:
        503). Per-replica summaries ride along."""
        with self._lock:
            self._refresh_locked()
            states = [rep.state for rep in self.replicas]
            up = sum(1 for s in states if s != DOWN)
            self.metrics.set_fleet_gauge(up)
            state = ("running" if up == len(states)
                     else "degraded" if up else "down")
            reps = []
            for rep in self.replicas:
                h = rep.last_health or {}
                reps.append({
                    "idx": rep.idx, "router_state": rep.state,
                    "state": h.get("state", "unknown"),
                    "healthy": bool(h.get("healthy", False)),
                    "queue_depth": int(h.get("queue_depth", 0)),
                    "active_slots": int(h.get("active_slots", 0)),
                    "service_time_ewma_ms":
                        float(h.get("service_time_ewma_ms", 0.0)),
                    # which replica is shedding service (the aggregate
                    # /metrics reports the max)
                    "degrade_level": int(h.get("degrade_level", 0)),
                    # mixed versions are visible mid-rollout
                    "weight_version": h.get("weight_version", "unversioned"),
                    "upgrading": rep.upgrading,
                })
        return {
            "healthy": up > 0,
            "accepting": up > 0,
            "state": state,
            "loop_alive": any(r["healthy"] or r["router_state"] != DOWN
                              for r in reps),
            "replicas_up": up,
            "num_replicas": len(self.replicas),
            "queue_depth": self.queue_depth(),
            "replicas": reps,
            "detail": "" if up else "all replicas down",
        }

    def aggregate_snapshot(self) -> dict:
        """The router's `/metrics`: base counters and occupancy gauges
        summed across replicas, the router's own counters (failovers,
        retries, stream reconnects) added from its registry, and latency,
        rate and per-step keys as the worst replica's."""
        out = self.metrics.snapshot()
        versions = []
        for rep in self.replicas:
            try:
                snap = rep.engine.metrics.snapshot()
            except Exception:  # noqa: BLE001
                continue
            versions.append(float(snap.get("weight_version", 0.0)))
            for k in _BASE_COUNTERS + _SUM_GAUGES:
                out[k] = out.get(k, 0.0) + snap.get(k, 0.0)
            for k, v in snap.items():
                if k.endswith("_ms") or k in (("tokens_per_s",
                                               "slot_occupancy")
                                              + _MAX_GAUGES):
                    out[k] = max(out.get(k, 0.0), v)
        # the weight version as the fleet's floor, with its spread: a fleet
        # mid-rollout shows min < max on one scrape
        out["weight_version_min"] = min(versions) if versions else 0.0
        out["weight_version_max"] = max(versions) if versions else 0.0
        out["weight_version"] = out["weight_version_min"]
        out["num_replicas"] = float(len(self.replicas))
        # the current rotation, not the last health() push
        out["fleet_replicas_up"] = float(
            sum(1 for rep in self.replicas if rep.state != DOWN))
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        ok = True
        for rep in self.replicas:
            ok = rep.engine.drain(timeout) and ok
        return ok

    def close(self):
        for rep in self.replicas:
            rep.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
