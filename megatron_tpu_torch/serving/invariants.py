"""System-wide serving invariants: the laws that must hold under ANY
fault schedule (megatron_tpu/serving/invariants.py, the port's own copy).
Over a fleet of remote replicas (serving/remote.py) each replica process
runs its own sweep and serves the report (`GET /invariants`); `check_all`
folds those reports into the fleet's sweep.

Every robustness PR so far proved its own corner with a hand-scripted
drill (tools/chaos_serve.py / chaos_router.py / chaos_upgrade.py), and
every review round still found cross-feature bugs the scripts never
reached (the np.int64 slot-id leak, the retain-before-evict
resurrection, the mark_admitted race, swap-racing-handoff). This module
is the FoundationDB-style move: instead of enumerating scenarios,
state the invariants that hold under *any* interleaving of admissions,
preemptions, swaps, crashes, and corruptions — then let a seeded
generator (tools/chaos_mesh.py) walk the scenario space and check them
after every storm. A new feature doesn't need a new drill; it needs to
keep these laws true.

The laws (each independently checkable, composed by `check_all`):

1. **Request conservation** — every request the front door received
   reaches exactly one terminal bucket:
   ``received == completed + rejected + failed + cancelled + expired
   (+ live in-flight)``. Enforced structurally (the atomic terminal
   hook on GenRequest) and checked here against the metrics snapshot,
   so a dropped terminal transition — a stranded future — is a law
   violation, not a hung test.
2. **Typed-terminal law** — every tracked future RESOLVES (no
   TimeoutError = no stranded future) and every failure is typed:
   DeadlineExceededError (504), ServiceUnavailableError /
   EngineUnhealthyError / NoReplicaAvailableError (503, retryable),
   QueueFullError / OverloadShedError (429, retryable),
   AdmissionError (400), or RequestFailedError (500). A BARE
   RuntimeError or TimeoutError escaping `result()` is a violation.
3. **Token exactness** — every COMPLETED request's stream equals a
   serial oracle's output for its (seed, sampling, adapter_id) under
   SOME admitted weight version (a mid-rollout fleet legitimately
   serves several). Preemption, speculation, prefix hits, failover
   retries, and hot swaps may move *when* tokens appear — never
   *which* tokens.
4. **KV-block accounting** — recomputed from first principles against
   `SlotKVPool.accounting()`: per-block refcounts equal row refs +
   retained-entry refs + pending-prefill refs; free + used == total;
   free rows map to TRASH; and no physical block is shared across
   prefix namespaces (adapter or weight generation) — cross-tenant /
   cross-version KV reuse is structurally impossible.
5. **Metrics-schema stability** — a snapshot's key set equals a fresh
   registry's (plus the router aggregate's documented extras):
   scrapers never see the schema mutate mid-run.
6. **healthz consistency** — the `health()` payload is internally
   consistent (`accepting` ⟺ healthy ∧ running ∧ loop-alive; breaker
   ⟺ unhealthy) and the router distinguishes DEGRADED (some replicas
   down, still ready/200) from DOWN — partial failure must degrade,
   never lie.
7. **Grammar validity** — every token a COMPLETED structured request
   emitted is FSM-legal from the state its predecessors reached
   (TokenFSM.replay), and when the grammar is bounded and the token
   budget covers its longest path, the final text PARSES
   (final_text_valid — `json.loads` for json_schema grammars).
   Constrained decoding may never emit an illegal token, under any
   storm; a grammar with no legal continuation fails TYPED
   (GrammarDeadEndError → 422), which rides law 2's taxonomy.

PERF laws (8–11, tools/chaos_storm.py): the same machinery pointed at
latency and goodput, so an SLO regression prints a seed repro line
exactly like a correctness bug. These take HARNESS-side measurements
(stream timings, per-arm shed fractions, a polled level series) rather
than an engine object — the harness measures, the law judges:

8.  **SLO bounds** — measured TTFT / inter-token-latency percentiles
    sit under their bounds (p99 ITL bounded under burst, TTFT bounded
    at target utilization; bounds are derived from a measured
    calibration run, not guessed).
9.  **Goodput floor** — `goodput_tokens` (completed work that met its
    TTFT SLO) is at least a floor fraction of `tokens_generated`:
    degradation must trade work AWAY, not burn it.
10. **Shed monotonicity** — across offered-load arms of one seed, the
    shed fraction never decreases as offered load rises (admission
    control responds to load, it doesn't oscillate with it).
11. **Degradation monotone-revert** — the brownout level stays within
    the configured ladder, does not thrash (hysteresis bounds the
    direction changes), and fully REVERTS to 0 after the storm
    drains: a brownout is a mode, not a ratchet.

Thread contract: the strict sweeps (`check_all(..., strict=True)`,
`check_kv_accounting`) read engine-thread-owned accounting — run them
against a QUIESCED engine (idle: every tracked future resolved and the
queue drained; or drained/closed/breaker-tripped). The live sweep
(`strict=False`) uses only race-safe reads (snapshot, health) and
inequality forms of the laws, so it can run mid-storm.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from megatron_tpu_torch.serving.metrics import ServingMetrics, _percentile
from megatron_tpu_torch.serving.request import (DeadlineExceededError,
                                                GrammarDeadEndError,
                                                RequestFailedError,
                                                ServiceUnavailableError)
from megatron_tpu_torch.serving.scheduler import (AdmissionError,
                                                  EngineUnhealthyError,
                                                  QueueFullError)


class InvariantViolation(AssertionError):
    """One or more serving invariants failed. `law` names the first
    violated law; `violations` carries every (law, detail) found in the
    sweep — the chaos tools print these next to the `--seed` repro
    line."""

    def __init__(self, violations: Sequence[Tuple[str, str]]):
        self.violations = list(violations)
        self.law = self.violations[0][0] if self.violations else "?"
        super().__init__("; ".join(
            f"[{law}] {detail}" for law, detail in self.violations))


# the full typed-terminal taxonomy `result()` may raise; anything else
# (and in particular a BARE RuntimeError or a TimeoutError) violates
# the typed-terminal law. Retryable: 429/503. Non-retryable: 400/500/504.
TYPED_TERMINAL_ERRORS = (
    DeadlineExceededError,       # 504
    ServiceUnavailableError,     # 503 (NoReplicaAvailableError ⊂)
    EngineUnhealthyError,        # 503
    QueueFullError,              # 429 (OverloadShedError ⊂)
    AdmissionError,              # 400 (UnknownAdapterError ⊂)
    RequestFailedError,          # 500
    GrammarDeadEndError,         # 422 (constrained generation stuck)
)

# terminal-side counters of the conservation law (completed is checked
# separately so the violation message names the missing bucket)
_TERMINAL_KEYS = ("requests_completed", "requests_rejected",
                  "requests_failed", "requests_cancelled",
                  "requests_expired")

# keys the router's aggregate_snapshot adds on top of the engine schema
ROUTER_EXTRA_KEYS = frozenset(
    {"weight_version_min", "weight_version_max", "num_replicas"})


class _Sweep:
    """Violation collector: each check appends instead of raising, so
    one sweep reports EVERY broken law (a storm that breaks two laws
    should say so)."""

    def __init__(self):
        self.violations: List[Tuple[str, str]] = []
        self.checked: List[str] = []

    def note(self, law: str, ok: bool, detail: str):
        if law not in self.checked:
            self.checked.append(law)
        if not ok:
            self.violations.append((law, detail))

    def raise_if_violated(self):
        if self.violations:
            raise InvariantViolation(self.violations)


# ---------------------------------------------------------------------
# law 1: request conservation
# ---------------------------------------------------------------------
def check_metrics_conservation(snapshot: Dict[str, float],
                               in_flight: int = 0,
                               strict: bool = True,
                               sweep: Optional[_Sweep] = None) -> dict:
    """``received == completed + rejected + failed + cancelled +
    expired + in_flight`` (exact when `strict`; `<=` inequality for a
    mid-storm sweep, where `in_flight` is racy), plus the subset law
    ``shed <= rejected`` and non-negativity of every bucket."""
    sw = sweep or _Sweep()
    received = snapshot.get("requests_received", 0.0)
    terms = {k: snapshot.get(k, 0.0) for k in _TERMINAL_KEYS}
    total = sum(terms.values())
    for k, v in dict(terms, requests_received=received).items():
        sw.note("conservation", v >= 0, f"{k} negative: {v}")
    balance = {"received": received, **terms, "in_flight": in_flight}
    if strict:
        sw.note("conservation", total + in_flight == received,
                f"dropped terminal transition: received={received:g} != "
                f"terminals={total:g} + in_flight={in_flight} "
                f"(buckets: {terms})")
    else:
        sw.note("conservation", total <= received,
                f"terminal counts exceed received: {total:g} > "
                f"{received:g} (buckets: {terms})")
    sw.note("conservation",
            snapshot.get("requests_shed", 0.0)
            <= snapshot.get("requests_rejected", 0.0),
            "requests_shed exceeds requests_rejected "
            f"({snapshot.get('requests_shed')} > "
            f"{snapshot.get('requests_rejected')}) — shed must be a "
            "subset of rejected")
    if sweep is None:
        sw.raise_if_violated()
    return balance


# ---------------------------------------------------------------------
# law 2: typed terminals / no stranded futures
# ---------------------------------------------------------------------
def resolve_terminals(requests: Sequence, timeout: float = 120.0,
                      sweep: Optional[_Sweep] = None
                      ) -> Dict[str, int]:
    """Resolve every tracked future and classify its terminal outcome.
    A TimeoutError here IS the stranded-future violation; a bare
    RuntimeError (not one of the typed subclasses) or any exception
    outside the taxonomy violates the typed-terminal law. Returns
    outcome counts keyed by class name (plus "completed")."""
    sw = sweep or _Sweep()
    out: Dict[str, int] = {"completed": 0}
    for req in requests:
        try:
            req.result(timeout=timeout)
            out["completed"] += 1
            sw.note("typed_terminals", True, "")
        except TimeoutError:
            sw.note("typed_terminals", False,
                    f"STRANDED future: request {getattr(req, 'id', '?')} "
                    f"unresolved after {timeout}s "
                    f"(prompt={list(getattr(req, 'prompt', []))[:8]})")
            out["stranded"] = out.get("stranded", 0) + 1
        except TYPED_TERMINAL_ERRORS as e:
            name = type(e).__name__
            out[name] = out.get(name, 0) + 1
            sw.note("typed_terminals", True, "")
        except Exception as e:  # noqa: BLE001 — the law under test
            sw.note("typed_terminals", False,
                    f"UNTYPED terminal on request "
                    f"{getattr(req, 'id', '?')}: {type(e).__name__}: "
                    f"{e} — every failure must be one of "
                    f"{[c.__name__ for c in TYPED_TERMINAL_ERRORS]}")
            out["untyped"] = out.get("untyped", 0) + 1
    if sweep is None:
        sw.raise_if_violated()
    return out


# ---------------------------------------------------------------------
# law 3: token exactness vs a serial oracle
# ---------------------------------------------------------------------
def check_token_exact(requests: Sequence,
                      oracles: Sequence[Callable],
                      sweep: Optional[_Sweep] = None) -> Dict[str, int]:
    """Every COMPLETED request's (prompt + generated) must equal the
    serial oracle's output under SOME oracle in `oracles` — one per
    live weight version (a mid-rollout fleet legitimately completes
    work at both N and N+1; matching *neither* means the storm moved a
    token). Each oracle is ``fn(req) -> expected token list``; it keys
    the serial reference by the request's own (prompt, max_new_tokens,
    seed, sampling, adapter_id). Returns per-oracle match counts."""
    sw = sweep or _Sweep()
    counts = {f"oracle_{i}": 0 for i in range(len(oracles))}
    counts["checked"] = 0
    flat = []
    for r in requests:
        # FanoutRequest aggregates check per CHILD: each sample is
        # independently seeded and must match its own serial oracle
        flat.extend(getattr(r, "children", None) or [r])
    for req in flat:
        if not req.done() or getattr(req, "error", None) is not None:
            continue
        state = getattr(req, "state", None)
        if state is not None and getattr(state, "value", "") != "finished":
            continue
        got = list(req.prompt) + list(req.generated)
        counts["checked"] += 1
        matched = False
        for i, fn in enumerate(oracles):
            if got == fn(req):
                counts[f"oracle_{i}"] += 1
                matched = True
                break
        sw.note("token_exact", matched,
                f"completed request {getattr(req, 'id', '?')} "
                f"(seed={getattr(req, 'seed', '?')}, "
                f"adapter={getattr(req, 'adapter_id', None)!r}) matches "
                f"NO oracle: got {got[:24]}...")
    if sweep is None:
        sw.raise_if_violated()
    return counts


# ---------------------------------------------------------------------
# law 7: grammar validity (structured output)
# ---------------------------------------------------------------------
def check_grammar_validity(requests: Sequence,
                           sweep: Optional[_Sweep] = None
                           ) -> Dict[str, int]:
    """Every COMPLETED grammar-constrained request's stream must be
    FSM-legal end to end (TokenFSM.replay: each token allowed from the
    state its predecessors reached, EOS only from an accepting state),
    and — when the grammar is BOUNDED (acyclic DFA, max_path_len not
    None) and the request's token budget covers its longest path — the
    final text must PARSE (TokenFSM.final_text_valid: the char-DFA
    accepts, and json.loads succeeds for json_schema grammars). The
    parse check is skipped for unbounded grammars or tight budgets:
    there a run can legitimately end mid-structure at max_new_tokens
    (replay-legality still holds; guaranteed-parse is only promised
    when the budget makes it reachable). FanoutRequest aggregates are
    flattened to their children. Returns counts."""
    sw = sweep or _Sweep()
    flat = []
    for r in requests:
        flat.extend(getattr(r, "children", None) or [r])
    counts = {"checked": 0, "parsed": 0}
    for req in flat:
        fsm = getattr(req, "fsm", None)
        if fsm is None or not req.done() \
                or getattr(req, "error", None) is not None:
            continue
        state = getattr(req, "state", None)
        if state is not None and getattr(state, "value", "") != "finished":
            continue
        counts["checked"] += 1
        toks = list(req.generated)
        legal, final_state = fsm.replay(toks)
        sw.note("grammar_validity", legal,
                f"structured request {getattr(req, 'id', '?')} emitted "
                f"an FSM-ILLEGAL token (seed={req.seed}, tokens "
                f"{toks[:24]}...) — constrained decoding must never "
                "commit outside the grammar")
        if (legal and fsm.max_path_len is not None
                and req.max_new_tokens >= fsm.max_path_len):
            ok = fsm.final_text_valid(toks)
            counts["parsed"] += int(ok)
            sw.note("grammar_validity", ok,
                    f"structured request {getattr(req, 'id', '?')} "
                    "completed with text that does not parse "
                    f"(seed={req.seed}, budget {req.max_new_tokens} >= "
                    f"longest path {fsm.max_path_len}: a parse was "
                    "guaranteed-reachable)")
    if sweep is None:
        sw.raise_if_violated()
    return counts


# ---------------------------------------------------------------------
# law 4: KV-block accounting
# ---------------------------------------------------------------------
def check_kv_accounting(engine, sweep: Optional[_Sweep] = None) -> dict:
    """Recompute the pool's refcounts/free lists from first principles
    (rows + retained entries + pending prefills) and compare with the
    pool's own books; verify free rows park on TRASH and no physical
    block is shared across prefix namespaces. Quiesced-engine check."""
    sw = sweep or _Sweep()
    acct = engine.pool.accounting()
    st = engine.invariant_state()
    free_rows = set(acct["free_rows"])
    stats = {"blocks_enabled": acct["blocks_enabled"]}
    if not acct["blocks_enabled"]:
        retained = set(acct["retained"])
        sw.note("kv_accounting", not (free_rows & retained),
                f"slots both free and retained: {free_rows & retained}")
        sw.note("kv_accounting",
                free_rows <= set(range(acct["num_slots"]))
                and retained <= set(range(acct["num_slots"])),
                f"slot ids out of range: free={free_rows} "
                f"retained={retained}")
        busy = set(range(acct["num_slots"])) - free_rows - retained
        owners = ({s for s, _ in st["slot_requests"]}
                  | {slot for _, slot, _, _ in st["prefilling"]})
        sw.note("kv_accounting", busy <= owners,
                f"busy slots with no owning request (leaked regions): "
                f"{busy - owners}")
        stats.update(free=len(free_rows), retained=len(retained),
                     busy=len(busy))
        if sweep is None:
            sw.raise_if_violated()
        return stats
    # ---- block mode --------------------------------------------------
    import numpy as np
    rc, bmap, trash = acct["rc"], acct["map"], acct["trash"]
    total = acct["total_blocks"]
    expected = np.zeros(total, np.int64)
    ns_holders: Dict[int, set] = {}

    def _ns_of_req(req):
        return (st["weight_gen"], getattr(req, "adapter_ns", None))

    slot_req = dict(st["slot_requests"])
    pending_by_slot = {slot: (req, blocks, installed)
                       for req, slot, blocks, installed
                       in st["prefilling"]}
    for slot in range(acct["num_slots"]):
        if slot in free_rows:
            sw.note("kv_accounting",
                    all(int(b) == trash for b in bmap[slot]),
                    f"free row {slot} maps non-TRASH blocks "
                    f"{[int(b) for b in bmap[slot]]} — idle grid "
                    "writes could clobber live KV")
            continue
        owner = slot_req.get(slot)
        if owner is None and slot in pending_by_slot:
            owner = pending_by_slot[slot][0]
        for b in bmap[slot]:
            b = int(b)
            if b == trash:
                continue
            expected[b] += 1
            if owner is not None:
                ns_holders.setdefault(b, set()).add(_ns_of_req(owner))
    for key, ent in acct["retained"].items():
        for b in ent["blocks"]:
            expected[int(b)] += 1
            ns_holders.setdefault(int(b), set()).add(ent["namespace"])
    for req, slot, blocks, installed in st["prefilling"]:
        if blocks is not None and not installed:
            # reserved at admission, map still on TRASH: the pending
            # holds the only refs
            for b in blocks:
                expected[int(b)] += 1
                ns_holders.setdefault(int(b), set()).add(_ns_of_req(req))
    mism = [(b, int(rc[b]), int(expected[b]))
            for b in range(total) if b != trash
            and int(rc[b]) != int(expected[b])]
    sw.note("kv_accounting", not mism,
            f"refcount drift (block, pool_rc, recomputed): {mism[:8]} "
            "— a leak (pool > recomputed) pins blocks forever; the "
            "reverse is a use-after-free")
    free_blocks = set(acct["free_blocks"])
    zero = {b for b in range(total) if b != trash and int(rc[b]) == 0}
    sw.note("kv_accounting", free_blocks == zero,
            f"free-list drift: on free list but rc>0: "
            f"{sorted(free_blocks - zero)[:8]}; rc==0 but not free: "
            f"{sorted(zero - free_blocks)[:8]}")
    used = sum(1 for b in range(total) if b != trash and int(rc[b]) > 0)
    sw.note("kv_accounting", used + len(free_blocks) == total - 1,
            f"free + used != total: {used} + {len(free_blocks)} != "
            f"{total - 1}")
    shared_bad = {b: ns for b, ns in ns_holders.items()
                  if len(ns) > 1}
    sw.note("kv_accounting", not shared_bad,
            f"cross-namespace block sharing (tenant/version isolation "
            f"broken): {dict(list(shared_bad.items())[:4])}")
    stats.update(used_blocks=used, free_blocks=len(free_blocks),
                 retained_entries=len(acct["retained"]))
    if sweep is None:
        sw.raise_if_violated()
    return stats


# ---------------------------------------------------------------------
# law 5: metrics-schema stability
# ---------------------------------------------------------------------
def check_schema(snapshot: Dict[str, float], router: bool = False,
                 sweep: Optional[_Sweep] = None):
    """A live snapshot's key set must equal a fresh registry's — the
    schema never mutates mid-run (scrapers key on a fixed set). The
    router aggregate adds exactly ROUTER_EXTRA_KEYS."""
    sw = sweep or _Sweep()
    want = set(ServingMetrics().snapshot())
    if router:
        want |= ROUTER_EXTRA_KEYS
    got = set(snapshot)
    sw.note("metrics_schema", got == want,
            f"schema drift: missing={sorted(want - got)} "
            f"extra={sorted(got - want)}")
    if sweep is None:
        sw.raise_if_violated()


# ---------------------------------------------------------------------
# law 6: healthz / accepting consistency
# ---------------------------------------------------------------------
_ENGINE_HEALTH_KEYS = (
    "healthy", "state", "accepting", "loop_alive",
    "circuit_breaker_open", "active_slots", "num_slots", "queue_depth",
    "free_slots")


def check_engine_health(h: dict, sweep: Optional[_Sweep] = None):
    sw = sweep or _Sweep()
    missing = [k for k in _ENGINE_HEALTH_KEYS if k not in h]
    sw.note("healthz", not missing,
            f"health() payload missing keys {missing}")
    if not missing:
        sw.note("healthz",
                h["accepting"] == (h["healthy"]
                                   and h["state"] == "running"
                                   and h["loop_alive"]),
                f"accepting={h['accepting']} inconsistent with "
                f"healthy={h['healthy']} state={h['state']!r} "
                f"loop_alive={h['loop_alive']}")
        sw.note("healthz",
                h["circuit_breaker_open"] == (h["state"] == "unhealthy"),
                f"breaker={h['circuit_breaker_open']} but "
                f"state={h['state']!r}")
        sw.note("healthz", not (h["state"] == "running"
                                and not h["healthy"]),
                "state 'running' on an unhealthy engine")
        sw.note("healthz",
                0 <= h["active_slots"] <= h["num_slots"]
                and 0 <= h["free_slots"] <= h["num_slots"],
                f"slot counts out of range: active={h['active_slots']} "
                f"free={h['free_slots']} of {h['num_slots']}")
    if sweep is None:
        sw.raise_if_violated()


def check_router_health(h: dict, sweep: Optional[_Sweep] = None):
    """Degraded-not-down: with SOME replicas up the router must stay
    ready (healthy/accepting, state 'degraded'); only a fleet with
    zero live replicas reports 'down'/503."""
    sw = sweep or _Sweep()
    up, n = h.get("replicas_up"), h.get("num_replicas")
    ok_keys = up is not None and n is not None
    sw.note("healthz", ok_keys,
            "router health() missing replicas_up/num_replicas")
    if ok_keys:
        want_state = ("running" if up == n else
                      "degraded" if up > 0 else "down")
        sw.note("healthz", h.get("state") == want_state,
                f"router state {h.get('state')!r} with {up}/{n} "
                f"replicas up (want {want_state!r})")
        sw.note("healthz",
                bool(h.get("healthy")) == (up > 0)
                and bool(h.get("accepting")) == (up > 0),
                f"degraded-not-down broken: {up}/{n} up but "
                f"healthy={h.get('healthy')} "
                f"accepting={h.get('accepting')}")
    if sweep is None:
        sw.raise_if_violated()


# ---------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------
def wait_quiesced(target, timeout: float = 60.0) -> bool:
    """Poll until no engine has active slots, pending prefills, or live
    queued work (the strict sweeps read engine-thread accounting, so
    they want a quiet grid). A dead-loop or breaker-tripped engine
    counts as quiet — nothing mutates its accounting anymore. Returns
    False on timeout (the caller may still sweep; violations then need
    a racy-read grain of salt)."""
    import time as _time
    engines = getattr(target, "engines", None)
    if engines is None:
        engines = [target]
    deadline = _time.monotonic() + timeout
    while True:
        quiet = True
        for e in engines:
            try:
                h = e.health()
            except Exception:  # noqa: BLE001 — an unreachable remote
                # replica has no accounting changing under the sweep: it
                # counts as quiet, like a dead loop
                continue
            if not h.get("loop_alive") or h.get("circuit_breaker_open"):
                continue
            # a remote replica has no scheduler here: its health payload's
            # queue depth answers the same question over the wire
            sched = getattr(e, "scheduler", None)
            depth = (sched.live_depth() if sched is not None
                     else h.get("queue_depth", 0))
            if h.get("active_slots") or h.get("prefilling") or depth:
                quiet = False
                break
        if quiet:
            return True
        if _time.monotonic() >= deadline:
            return False
        _time.sleep(0.01)


def check_engine(engine, strict: bool = True,
                 sweep: Optional[_Sweep] = None) -> dict:
    """One engine's full sweep: conservation (strict needs quiesce),
    schema, healthz, and — strict only — KV accounting."""
    sw = sweep or _Sweep()
    snap = engine.metrics.snapshot()
    # the live sweep must not walk engine-thread-owned lists (they
    # mutate under it); the inequality form needs no in-flight term
    in_flight = engine.invariant_state()["in_flight"] if strict else 0
    balance = check_metrics_conservation(
        snap, in_flight=in_flight, strict=strict, sweep=sw)
    check_schema(snap, router=False, sweep=sw)
    check_engine_health(engine.health(), sweep=sw)
    stats = {"balance": balance}
    if strict:
        stats["kv"] = check_kv_accounting(engine, sweep=sw)
    if sweep is None:
        sw.raise_if_violated()
    return stats


def _check_remote_engine(e, strict: bool, sw: _Sweep) -> dict:
    """One remote replica's sweep (fleet mode). KV accounting and the
    in-flight walks need the live objects, which cannot cross the wire, so
    the replica process runs its own sweep (`GET /invariants`,
    `MegatronServer.invariant_report`) and its violations are folded into
    this sweep, tagged with its address. An unreachable replica is
    recorded, not convicted: a process that is gone has no accounting left
    to break, and its in-flight work shows in laws 1-2 on the survivors'
    counters and the tracked futures."""
    addr = getattr(e, "addr", repr(e))
    try:
        rep = e.invariant_report(strict=strict)
    except Exception as ex:  # noqa: BLE001 — typed transport faults
        return {"remote": addr, "unreachable": str(ex)}
    for law in rep.get("laws_checked", ()):
        if law not in sw.checked:
            sw.checked.append(str(law))
    for v in rep.get("violations", ()):
        if isinstance(v, (list, tuple)) and len(v) == 2:
            law, detail = v
        else:
            law, detail = "remote", str(v)
        sw.violations.append((str(law), f"replica {addr}: {detail}"))
    return {"remote": addr, "report": rep}


# ---------------------------------------------------------------------
# perf laws 8-11 (tools/chaos_storm.py): harness-measured inputs
# ---------------------------------------------------------------------
def check_slo_bounds(samples_ms: Dict[str, Sequence[float]],
                     bounds_ms: Dict[str, Tuple[float, float]],
                     sweep: Optional[_Sweep] = None) -> dict:
    """Law 8: each named latency series (``"ttft_ms"``, ``"itl_ms"``,
    ...) keeps its specified percentile under its bound.
    `bounds_ms[name] = (quantile, bound_ms)` — e.g. ``{"itl_ms":
    (0.99, 80.0)}`` states "p99 inter-token latency <= 80ms". An empty
    series is vacuously fine (the harness decides whether zero samples
    is itself an error). Returns per-series stats for the record."""
    sw = sweep or _Sweep()
    stats: dict = {}
    for name, (q, bound) in bounds_ms.items():
        vals = sorted(float(v) for v in samples_ms.get(name, ()))
        got = _percentile(vals, q)
        stats[name] = {"n": len(vals), "quantile": q,
                       "value_ms": got, "bound_ms": float(bound)}
        sw.note("slo_bounds", not vals or got <= bound,
                f"{name} p{q * 100:g} = {got:.1f}ms exceeds the "
                f"{bound:.1f}ms bound ({len(vals)} samples)")
    if sweep is None:
        sw.raise_if_violated()
    return stats


def check_goodput_floor(snapshot: Dict[str, float], floor: float,
                        sweep: Optional[_Sweep] = None) -> dict:
    """Law 9: ``goodput_tokens >= floor * tokens_generated`` — of the
    work the engine actually decoded, at least `floor` was useful
    (completed within its TTFT SLO). A degradation controller that
    admits work it then serves too late to matter fails HERE even
    though every correctness law holds."""
    sw = sweep or _Sweep()
    gen = float(snapshot.get("tokens_generated", 0.0))
    good = float(snapshot.get("goodput_tokens", 0.0))
    ratio = good / gen if gen else 1.0
    sw.note("goodput_floor", ratio >= floor,
            f"goodput {good:g} / generated {gen:g} = {ratio:.2f} "
            f"below the {floor:.2f} floor — admitted work was decoded "
            "but delivered too late to count")
    if sweep is None:
        sw.raise_if_violated()
    return {"tokens_generated": gen, "goodput_tokens": good,
            "ratio": ratio, "floor": floor}


def check_shed_monotone(arms: Sequence[Tuple[float, float]],
                        tolerance: float = 0.05,
                        sweep: Optional[_Sweep] = None) -> list:
    """Law 10: across `(offered_load, shed_fraction)` arms of ONE
    seed, the shed fraction never DECREASES as offered load rises
    (within `tolerance`, for sampling noise on small arms). A shed
    rate that falls as load grows means admission control is keying
    on something other than load."""
    sw = sweep or _Sweep()
    arms = sorted((float(l), float(s)) for l, s in arms)
    for (l0, s0), (l1, s1) in zip(arms, arms[1:]):
        sw.note("shed_monotone", s1 >= s0 - tolerance,
                f"shed fraction fell {s0:.3f} -> {s1:.3f} as offered "
                f"load rose {l0:g}x -> {l1:g}x (tolerance "
                f"{tolerance:g})")
    if sweep is None:
        sw.raise_if_violated()
    return list(arms)


def check_degrade_revert(levels: Sequence[int], max_level: int,
                         require_rise: bool = False,
                         max_direction_changes: Optional[int] = None,
                         sweep: Optional[_Sweep] = None) -> dict:
    """Law 11 on a polled brownout-level series (storm through
    post-storm quiesce): every reading within ``[0, max_level]``, the
    FINAL reading 0 (a brownout is a mode, not a ratchet), optionally
    a required rise (a 2x-overload arm that never degraded means the
    controller is dead — checker-not-vacuous), and optionally a bound
    on rise/fall direction changes (hysteresis must stop one storm
    from thrashing the ladder; the theoretical minimum is 2: up once,
    down once)."""
    sw = sweep or _Sweep()
    lv = [int(x) for x in levels]
    peak = max(lv) if lv else 0
    sw.note("degrade_revert",
            all(0 <= x <= max_level for x in lv),
            f"level left the ladder [0, {max_level}]: {lv}")
    sw.note("degrade_revert", not lv or lv[-1] == 0,
            f"level did not revert to 0 after the storm "
            f"(final {lv[-1] if lv else '?'}; peak {peak})")
    if require_rise:
        sw.note("degrade_revert", peak > 0,
                "level never rose under a storm that demanded "
                "degradation — the controller is dead or the storm "
                "vacuous")
    if max_direction_changes is not None:
        deltas = [b - a for a, b in zip(lv, lv[1:]) if b != a]
        changes = 1 + sum(1 for a, b in zip(deltas, deltas[1:])
                          if (a > 0) != (b > 0)) if deltas else 0
        sw.note("degrade_revert", changes <= max_direction_changes,
                f"ladder thrashed: {changes} direction changes "
                f"(> {max_direction_changes}) in {lv}")
    if sweep is None:
        sw.raise_if_violated()
    return {"peak": peak, "final": lv[-1] if lv else 0,
            "samples": len(lv)}


def check_all(target, requests: Sequence = (),
              oracles: Sequence[Callable] = (),
              strict: bool = True, timeout: float = 120.0,
              raise_on_violation: bool = True) -> dict:
    """The system-wide sweep, callable against a `ServingEngine` OR an
    `EngineRouter` (each replica engine is swept, then the router-level
    laws), a router over remote replicas included: each of those sweeps
    itself in its own process and its report arrives over HTTP
    (`_check_remote_engine`). `requests` are the tracked
    futures of the storm (engine GenRequests or RouterRequests) —
    resolved and typed-checked, and, when `oracles` are given,
    token-exactness-checked. Returns a report dict; raises
    InvariantViolation listing EVERY broken law unless
    `raise_on_violation=False` (the report then carries them)."""
    sw = _Sweep()
    report: dict = {}
    if requests:
        report["outcomes"] = resolve_terminals(requests, timeout,
                                               sweep=sw)
    engines = getattr(target, "engines", None)
    if engines is not None:  # router
        report["replicas"] = [
            _check_remote_engine(e, strict, sw)
            if hasattr(e, "invariant_report")
            else check_engine(e, strict=strict, sweep=sw)
            for e in engines]
        check_router_health(target.health(), sweep=sw)
        check_schema(target.aggregate_snapshot(), router=True, sweep=sw)
    else:
        report["engine"] = check_engine(target, strict=strict, sweep=sw)
    if requests and oracles:
        report["token_exact"] = check_token_exact(requests, oracles,
                                                  sweep=sw)
    if requests:
        report["grammar"] = check_grammar_validity(requests, sweep=sw)
    report["laws_checked"] = list(sw.checked)
    report["violations"] = [f"[{law}] {d}" for law, d in sw.violations]
    report["ok"] = not sw.violations
    if raise_on_violation:
        sw.raise_if_violated()
    return report
