"""Seeded load storms against the brownout ladder, judged by the perf laws
(the port of the root tools/chaos_storm.py).

One seed derives a trace-driven workload (bursty Poisson arrivals,
multi-turn sessions, adapter skew, prompt- and decode-length mixtures, a
few n-best fan-outs), replayed at several offered-load multiples of the
engine's calibrated sustainable rate (`--arms`, default 0.5x/1x/2x)
against an engine running the full ladder (`degrade_ladder=4`). The
arrivals are paced in the engine's busy loop passes (`EngineClock`), the
calibration measures a request in them too: a host whose speed changes
between the calibration and an arm, or during one, then offers each arm
the same load per pass, where seconds would offer it more or less.

The laws per seed (serving/invariants.py 8-11, beside the structural
sweep):

- slo_bounds: TTFT bounded at the 1x arm, the per-request mean ITL's p99
  bounded over all arms; the bounds derive from the calibration, with
  slack for host jitter.
- goodput_floor: completed-token goodput stays above a floor of the
  generated total while the 2x arm sheds.
- shed_monotone: the shed fraction does not fall as offered load rises
  (within a tolerance for scheduling noise).
- degrade_revert: the polled level series stays in [0, max_level], rises
  under the 2x arm and is back at 0 after the storm drains.
- no stranded future, and every completed request equals the serial
  oracle of its own effective config (a rung-2 clamp rewrites
  max_new_tokens and best_of at admission, and the oracle keys off the
  request's fields).

`--inject_slo_regression` stalls the engine loop 8 s mid-storm and
requires the SLO law to catch it (the perf laws are not vacuous).

Every record carries its seed and a one-line repro. `--smoke` runs the
fixed seed set: a plain storm, a speculative engine's (rung 1 meets
verify rounds) and an adapter-skewed one, plus the injected regression.

  python -m megatron_tpu_torch.tools.chaos_storm --smoke [--device cpu]
  python -m megatron_tpu_torch.tools.chaos_storm --seed 17 --requests 14
      [--inject_slo_regression] [--device cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import contextlib
import random
import sys
import threading
import time

from megatron_tpu_torch.tools import chaos_common as cc

SMOKE_SEEDS = [(17, ()), (29, ("spec",)), (41, ("adapters",))]
DEFAULT_ARMS = (0.5, 1.0, 2.0)
SHED_TOLERANCE = 0.15     # adjacent arms' shed-fraction noise allowance
GOODPUT_FLOOR = 0.5
LORA_RANK, LORA_ALPHA = 4, 8.0


def sample_config(rng: random.Random, require=()) -> dict:
    """Serving kwargs of the stormed engine: mostly fixed (the storm varies
    load, not layout), with the speculation and adapter axes seeded so
    rungs 1 and 2 meet real traffic. The rungs' thresholds are low enough
    for a 2x arm on a small grid to climb the ladder within a short
    trace."""
    kw = {
        "num_slots": 2,
        "max_queue": rng.choice([6, 8]),
        "max_len": 96,
        "shed_on_overload": True,
        "priority_levels": 2,
        "degrade_ladder": 4,
        "degrade_raise_at": (0.25, 0.5, 1.0, 2.0),
        "degrade_hysteresis": 0.5,
        # dwell counts are loop iterations, which the port's engine runs
        # several times faster than the reference's: 4 keeps a burst of
        # a few back-to-back arrivals from reaching the shed rungs
        # before the grid absorbs it
        "degrade_dwell_up": 4,
        "degrade_dwell_down": 4,
        "degrade_max_new_tokens": 6,
        # the engine's SLO counters, at wall-clock bounds that only check
        # the wiring (the calibrated harness bounds are the law)
        "slo_ttft_ms": 30_000.0,
        "slo_itl_p99_ms": 30_000.0,
    }
    if "spec" in require or (not require and rng.random() < 0.3):
        kw["speculative_k"] = 2
    if "adapters" in require:
        kw["adapter_slots"] = 2
        kw["adapter_rank"] = LORA_RANK
    return kw


def build_trace(rng: random.Random, serving_kw: dict, n_requests: int,
                new_tokens: int, adapters=(), vocab: int = 128):
    """The seeded trace every arm replays, with arm-scaled gaps: bursty
    arrivals, a prompt-length and a decode-length mixture, 70% priority 0
    (rung 3's class), 80/20 adapter skew, multi-turn follow-ups and a few
    n-best fan-outs (rung 2's best_of clamp)."""
    greedy_only = bool(serving_kw.get("speculative_k"))
    max_len = serving_kw["max_len"]
    adapters = list(adapters)
    specs = []
    for i in range(n_requests):
        long_prompt = rng.random() < 0.3
        plen = rng.randint(16, 28) if long_prompt else rng.randint(4, 8)
        spec = {
            "prompt": [rng.randrange(1, vocab) for _ in range(plen)],
            "max_new_tokens": (new_tokens if rng.random() < 0.7
                               else max(2, new_tokens // 2)),
            "seed": rng.randrange(1 << 16),
            "priority": 1 if rng.random() < 0.3 else 0,
            "adapter_id": None,
            "n": 1, "best_of": None,
            "session_of": None,
            # a speculative engine storms greedy: its seeded drawing rows
            # do not equal the serial route's
            "temperature": (0.0 if greedy_only or rng.random() < 0.6
                            else 0.8),
        }
        if adapters and rng.random() < 0.5:
            spec["adapter_id"] = (adapters[0] if rng.random() < 0.8
                                  else rng.choice(adapters))
        if i >= 2 and rng.random() < 0.25:
            spec["session_of"] = rng.randrange(i)
        elif spec["priority"] and rng.random() < 0.3:
            spec["n"], spec["best_of"] = 1, 2
        spec["prompt"] = spec["prompt"][:max_len - new_tokens - 16]
        specs.append(spec)
    # arrivals in units of the sustainable gap: exponential gaps with
    # periodic back-to-back bursts
    gaps, burst_every, burst_len = [], rng.randint(5, 8), rng.randint(3, 4)
    for i in range(n_requests):
        in_burst = (i % burst_every) < burst_len and i > 0
        gaps.append(0.0 if in_burst else rng.expovariate(1.0))
    return specs, gaps


def make_oracle(gen, adapter_factors: dict):
    """`fn(req) -> expected tokens` for invariants.check_token_exact, keyed
    by the request's own (effective) fields."""
    from megatron_tpu_torch.inference.generation import SamplingParams
    gens = cc.adapter_generators(gen, adapter_factors, LORA_RANK,
                                 LORA_ALPHA)
    cache = {}

    def want(req):
        sp = req.sampling
        key = (req.adapter_id, tuple(req.prompt), req.max_new_tokens,
               req.seed, (sp.temperature, sp.top_k, sp.top_p))
        if key not in cache:
            t, lens, _ = gens[req.adapter_id].generate(
                [list(req.prompt)], req.max_new_tokens,
                SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                               top_p=sp.top_p), seed=req.seed)
            cache[key] = t[0, :lens[0]].tolist()
        return cache[key]

    return want


class LevelPoller:
    """Samples health()["degrade_level"] every `period_s` on its own
    thread: the series the degrade_revert law judges (10 ms is well under
    a dwell window, so no transition slips between samples)."""

    def __init__(self, engine, period_s: float = 0.01):
        self.levels, self._stop = [], threading.Event()
        self._t = threading.Thread(target=self._run,
                                   args=(engine, period_s), daemon=True)

    def _run(self, engine, period_s):
        while not self._stop.is_set():
            self.levels.append(int(engine.health()["degrade_level"]))
            time.sleep(period_s)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5.0)


def calibrate(engine, rng: random.Random, new_tokens: int,
              vocab: int = 128, adapters=()) -> dict:
    """The quiet engine's cost of a request, the warmup excluded:
    {"service_s": seconds, "service_passes": busy loop passes (the
    sustainable gap at 1x is either over num_slots), "passes_per_s": the
    busy loop's rate}. The warmup loads every adapter of the trace into
    the bank and the timed requests cycle through them and the base
    model, so the first arm neither pays the loads nor meets a slower
    path than the one calibrated."""
    mix = [None] + list(adapters)
    for aid in mix:
        engine.submit([1, 2, 3], new_tokens,
                      adapter_id=aid).result(timeout=600.0)
    # one concurrent wave of the trace's shapes (short and long prompts,
    # batched prefills, a fan-out), so that no arm pays a first call of
    # a shape the calibration never ran
    wave = [engine.submit([1 + (i * 7 + j) % (vocab - 1)
                           for j in range(6 if i % 2 else 20)],
                          new_tokens, adapter_id=mix[i % len(mix)])
            for i in range(min(2 * engine.num_slots,
                               engine.serving.max_queue - 2))]
    wave.append(engine.submit([5, 6, 7], new_tokens, n=1, best_of=2))
    for r in wave:
        r.result(timeout=600.0)
    times, passes = [], []
    for i in range(3):
        t0, n0 = time.monotonic(), engine.iterations
        engine.submit([rng.randrange(1, vocab) for _ in range(6)],
                      new_tokens, seed=rng.randrange(1 << 16),
                      adapter_id=mix[i % len(mix)]).result(timeout=600.0)
        times.append(time.monotonic() - t0)
        passes.append(engine.iterations - n0)
    service_s = max(sum(times) / len(times), 1e-3)
    service_passes = max(sum(passes) / len(passes), 1.0)
    return {"service_s": service_s, "service_passes": service_passes,
            "passes_per_s": service_passes / service_s}


class EngineClock:
    """The arms' time, in engine loop passes. While the engine has work
    it is the count of its busy passes, the unit the ladder's dwell
    counts are in, so an arm offers the same load per pass however fast
    the host runs it; while the engine is idle, time runs at the
    calibrated passes a second. `wall=True` runs it on the wall clock
    at that rate throughout: a loop stall is a wall-clock event, and
    arrivals must keep coming while it lasts."""

    def __init__(self, engine, passes_per_s: float, wall: bool = False):
        self.engine, self.rate, self.wall = engine, passes_per_s, wall
        self._t0 = self._last = time.monotonic()
        self._idle = 0.0

    def now(self) -> float:
        t = time.monotonic()
        if self.wall:
            return (t - self._t0) * self.rate
        if not self.engine.has_work():
            self._idle += (t - self._last) * self.rate
        self._last = t
        return self.engine.iterations + self._idle

    def wait_until(self, target: float) -> None:
        while self.now() < target:
            time.sleep(0.0005)


def run_arm(engine, specs, gaps, mult: float, base_gap: float,
            clock: EngineClock):
    """Replay the trace at `mult` x the sustainable rate, `base_gap` being
    the 1x gap in the clock's passes. Returns (the admitted requests, the
    arm's stats). A submit-time 429 (a full queue or a brownout shed) is a
    shed; its Retry-After must be >= 1 s."""
    from megatron_tpu_torch.serving import QueueFullError, SamplingOptions
    tracked, stats = [], {"mult": mult, "submitted": 0, "shed": 0,
                          "bad_retry_after": 0, "stranded": 0,
                          "completed": 0, "failed": 0,
                          "ttft_ms": [], "itl_ms": []}
    done_prompts = {}
    t_start = time.monotonic()
    n_start = engine.iterations
    p_next = clock.now()
    for i, (spec, gap) in enumerate(zip(specs, gaps)):
        p_next += gap * base_gap / max(mult, 1e-6)
        clock.wait_until(p_next)
        prompt = list(spec["prompt"])
        parent = done_prompts.get(spec["session_of"])
        if parent is not None:
            # a follow-up turn carries the prior exchange
            prompt = (parent[0] + parent[1])[-24:] + prompt[:6]
        stats["submitted"] += 1
        try:
            r = engine.submit(
                prompt, spec["max_new_tokens"],
                SamplingOptions(temperature=spec["temperature"]),
                seed=spec["seed"], priority=spec["priority"],
                adapter_id=spec["adapter_id"], n=spec["n"],
                best_of=spec["best_of"])
        except QueueFullError as e:   # OverloadShedError subclasses it
            stats["shed"] += 1
            if e.retry_after is not None and e.retry_after < 1:
                stats["bad_retry_after"] += 1
            continue
        tracked.append((i, r))
    t_offered = time.monotonic() - t_start
    stats["offered_rps"] = stats["submitted"] / max(t_offered, 1e-6)
    stats["offered_passes"] = engine.iterations - n_start
    for i, r in tracked:
        try:
            r.result(timeout=600.0)
        except TimeoutError:
            stats["stranded"] += 1
            continue
        except Exception:  # noqa: BLE001 — typed enough: it resolved
            stats["failed"] += 1
            continue
        stats["completed"] += 1
        children = getattr(r, "children", None) or [r]
        done_prompts[i] = (list(children[0].prompt),
                           list(children[0].generated))
        for c in children:
            if c.ttft is not None:
                stats["ttft_ms"].append(c.ttft * 1e3)
            n = len(c.generated)
            if n > 1 and c.finish_time and c.first_token_time:
                stats["itl_ms"].append(
                    (c.finish_time - c.first_token_time) * 1e3 / (n - 1))
    stats["passes_per_s"] = ((engine.iterations - n_start)
                             / max(time.monotonic() - t_start, 1e-6))
    stats["shed_frac"] = stats["shed"] / max(stats["submitted"], 1)
    return [r for _, r in tracked], stats


def _pct(vals, q):
    from megatron_tpu_torch.serving.metrics import _percentile
    return _percentile(sorted(vals), q)


def run_one(seed: int, require=(), n_requests: int = 10,
            new_tokens: int = 8, arms=DEFAULT_ARMS,
            inject_slo_regression: bool = False, device=None, gen=None,
            check_tokens: bool = True, serving_overrides=None) -> dict:
    """One seeded storm over all arms; record["ok"] is the verdict and
    record["repro"] the one-line reproduction. `gen` storms a Generator
    the caller built (the tiny model by default); `check_tokens` False
    skips the serial-oracle law (a bf16 model's batched tokens need not
    equal its batch-1 ones). The injected regression's arms run on the
    wall clock (see `EngineClock`)."""
    from megatron_tpu_torch.resilience.faults import (FaultInjector,
                                                      use_fault_injector)
    from megatron_tpu_torch.serving import invariants
    rng = random.Random(seed)
    t0 = time.monotonic()
    arms = tuple(sorted(arms))
    repro = ("python -m megatron_tpu_torch.tools.chaos_storm "
             f"--seed {seed}"
             + (f" --require {','.join(require)}" if require else "")
             + f" --requests {n_requests} --new_tokens {new_tokens}"
             + f" --arms {','.join(str(a) for a in arms)}"
             + (" --inject_slo_regression" if inject_slo_regression
                else ""))
    serving_kw = sample_config(rng, require)
    serving_kw.update(serving_overrides or {})
    record = {"metric": "storm_requests_conformant",
              "unit": ("completed requests, every perf and structural law "
                       "held"),
              "seed": seed, "repro": repro, "require": list(require),
              "config": {k: v for k, v in serving_kw.items()
                         if k not in ("slo_ttft_ms", "slo_itl_p99_ms")},
              "completed": False, "ok": False, "violations": []}
    engine, gen = cc.tiny_engine(serving_kw, device, gen)
    vocab = gen.cfg.vocab_size
    adapter_factors = {}
    try:
        if serving_kw.get("adapter_slots"):
            adapter_factors = cc.make_adapters(gen.cfg, 2, rank=LORA_RANK)
            for aid, factors in sorted(adapter_factors.items()):
                engine.register_adapter(aid, factors=factors,
                                        rank=LORA_RANK, alpha=LORA_ALPHA)
        specs, gaps = build_trace(rng, serving_kw, n_requests, new_tokens,
                                  adapters=sorted(adapter_factors),
                                  vocab=min(vocab, 128))
        cal = calibrate(engine, rng, new_tokens, min(vocab, 128),
                        sorted(adapter_factors))
        svc_s = cal["service_s"]
        base_gap = cal["service_passes"] / serving_kw["num_slots"]
        # generous calibrated bounds: host jitter must not trip them, a
        # wedged loop must
        ttft_bound_ms = 30 * svc_s * 1e3 + 5_000
        itl_bound_ms = 50 * svc_s * 1e3 / max(new_tokens, 1) + 2_000
        # the regression: an 8 s loop stall early in the first arm (the
        # injector counts steps from its install, after calibration)
        injector = (FaultInjector(serve_delay_calls={5: 8.0})
                    if inject_slo_regression else None)
        all_reqs, arm_stats = [], []
        clock = EngineClock(engine, cal["passes_per_s"],
                            wall=inject_slo_regression)
        with LevelPoller(engine) as poller:
            with (use_fault_injector(injector) if injector is not None
                  else contextlib.nullcontext()):
                for mult in arms:
                    reqs, stats = run_arm(engine, specs, gaps, mult,
                                          base_gap, clock)
                    all_reqs.extend(reqs)
                    arm_stats.append(stats)
            # drain: the idle loop walks the ladder back down
            deadline = time.monotonic() + 30.0
            while (engine.health()["degrade_level"]
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            time.sleep(0.1)   # a last settled sample

        oracles = ([make_oracle(gen, adapter_factors)] if check_tokens
                   else [])
        sweep = cc.invariant_sweep(engine, reqs=all_reqs, oracles=oracles,
                                   strict=True, timeout=600.0)
        violations = list(sweep.get("violations", []))
        stranded = sum(s["stranded"] for s in arm_stats)
        if stranded:
            violations.append(f"[stranded] {stranded} futures never "
                              "resolved")
        bad_ra = sum(s["bad_retry_after"] for s in arm_stats)
        if bad_ra:
            violations.append(f"[retry_after] {bad_ra} shed responses "
                              "hinted Retry-After < 1s")
        if inject_slo_regression:
            # the stall fires in the first arm: the whole storm's TTFT
            # series against a tightened bound
            samples = {"ttft_all": [v for s in arm_stats
                                    for v in s["ttft_ms"]]}
            bounds = {"ttft_all": (0.9, 4_000.0)}
        else:
            target = next((s for s in arm_stats if s["mult"] == 1.0),
                          arm_stats[len(arm_stats) // 2])
            samples = {"ttft_1x": target["ttft_ms"],
                       "itl_all": [v for s in arm_stats
                                   for v in s["itl_ms"]]}
            bounds = {"ttft_1x": (0.95, ttft_bound_ms),
                      "itl_all": (0.99, itl_bound_ms)}
        slo_violated = False
        try:
            record["slo"] = invariants.check_slo_bounds(samples, bounds)
        except invariants.InvariantViolation as e:
            slo_violated = True
            if not inject_slo_regression:
                violations.append(str(e))
        if not inject_slo_regression:
            # the load-shape laws hold for an unfaulted storm only
            for check, kwargs in (
                    (invariants.check_shed_monotone,
                     {"arms": [(s["mult"], s["shed_frac"])
                               for s in arm_stats],
                      "tolerance": SHED_TOLERANCE}),
                    (invariants.check_goodput_floor,
                     {"snapshot": engine.metrics.snapshot(),
                      "floor": GOODPUT_FLOOR}),
                    (invariants.check_degrade_revert,
                     {"levels": poller.levels,
                      "max_level": serving_kw["degrade_ladder"],
                      "require_rise": max(arms) >= 2.0})):
                try:
                    check(**kwargs)
                except invariants.InvariantViolation as e:
                    violations.append(str(e))
        record["arms"] = [dict(
            {k: v for k, v in s.items() if k not in ("ttft_ms", "itl_ms")},
            ttft_p50_ms=_pct(s["ttft_ms"], 0.5),
            ttft_p99_ms=_pct(s["ttft_ms"], 0.99),
            itl_p50_ms=_pct(s["itl_ms"], 0.5),
            itl_p99_ms=_pct(s["itl_ms"], 0.99)) for s in arm_stats]
        record["calibrated_service_s"] = svc_s
        record["calibrated_service_passes"] = cal["service_passes"]
        record["pacing"] = "wall" if clock.wall else "engine_passes"
        record["levels"] = poller.levels
        record["degrade_peak"] = max(poller.levels or [0])
        record["degrade_final"] = (poller.levels or [0])[-1]
        snap = engine.metrics.snapshot()
        record["counters"] = {
            k: snap[k] for k in ("degrade_transitions",
                                 "slo_ttft_violations",
                                 "slo_itl_violations", "goodput_tokens",
                                 "tokens_generated", "requests_shed")}
        record["bounds_ms"] = {"ttft_1x": ttft_bound_ms,
                               "itl_all": itl_bound_ms}
        record["value"] = sum(s["completed"] for s in arm_stats)
        record["violations"] = violations
        if inject_slo_regression:
            # the verdict inverts: ok iff the injected stall was caught
            record["injected_caught"] = slo_violated
            record["ok"] = slo_violated and not violations
        else:
            record["ok"] = not violations
        record["completed"] = record["ok"]
    finally:
        engine.close()
    record["wall_s"] = time.monotonic() - t0
    if not record["ok"]:
        print(f"chaos_storm: VIOLATION — repro: {record['repro']}",
              file=sys.stderr)
        for v in record["violations"]:
            print(f"  {v}", file=sys.stderr)
    return record


def run_smoke(n_requests: int, new_tokens: int, device=None) -> dict:
    runs = [run_one(seed, require, n_requests=n_requests,
                    new_tokens=new_tokens, device=device)
            for seed, require in SMOKE_SEEDS]
    # the vacuity check rides along: one injected regression must trip
    runs.append(run_one(SMOKE_SEEDS[0][0], SMOKE_SEEDS[0][1],
                        n_requests=n_requests, new_tokens=new_tokens,
                        inject_slo_regression=True, device=device))
    ok = all(r["ok"] for r in runs)
    return {
        "metric": "storm_seeds_green",
        "value": sum(1 for r in runs if r["ok"]),
        "unit": (f"seeded storms with every perf law held (of {len(runs)}: "
                 "plain, speculative and adapter storms and one caught "
                 "injected regression)"),
        "completed": ok, "ok": ok,
        "seed": SMOKE_SEEDS[0][0],
        "seeds": [list(s) for s in SMOKE_SEEDS],
        "runs": runs,
        "wall_s": sum(r["wall_s"] for r in runs),
    }


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="run one seeded storm (config, trace and arrivals "
                         "all derive from it)")
    ap.add_argument("--require", type=str, default="",
                    help="comma-separated config biases: spec, adapters")
    ap.add_argument("--smoke", action="store_true",
                    help="the fixed seed set and one injected regression")
    ap.add_argument("--requests", type=int, default=10,
                    help="trace length an arm")
    ap.add_argument("--new_tokens", type=int, default=8,
                    help="max decode length a request")
    ap.add_argument("--arms", type=str, default="0.5,1.0,2.0",
                    help="offered-load multiples of the calibrated rate")
    ap.add_argument("--inject_slo_regression", action="store_true",
                    help="stall the loop mid-storm and require the SLO law "
                         "to catch it (exit 0 iff caught)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)
    device = device if device is not None else args.device
    require = tuple(t for t in args.require.split(",") if t)
    arms = tuple(float(a) for a in args.arms.split(","))
    if args.smoke:
        record = run_smoke(args.requests, args.new_tokens, device)
    else:
        record = run_one(17 if args.seed is None else args.seed, require,
                         n_requests=args.requests,
                         new_tokens=args.new_tokens, arms=arms,
                         inject_slo_regression=args.inject_slo_regression,
                         device=device)
    cc.emit_record(record, args.out, seed=record.get("seed", 0))
    return 0 if record["completed"] else 1


if __name__ == "__main__":
    sys.exit(main())
