"""Scripted serving chaos drills on one engine (the port of the root
tools/chaos_serve.py): overload with injected faults through a real
ServingEngine, checking that nothing strands and no token moves.

1. Overload: offered load far above the slot grid, with priorities, early
   shedding, preemption, LoRA adapters interleaved through the traffic
   and one NaN-poisoned slot. Every future resolves; sheds fail fast at
   submit; a preemption fires; the poisoned request fails alone; every
   completed request, the preempted and resumed ones too, equals its own
   adapter's merged-weights serial oracle token for token.
2. Wedge: one decode iteration stalls past the watchdog deadline. The
   watchdog fails the in-flight request, the supervisor restarts once the
   stalled call returns, and a fresh probe completes token-exact.
3. Crash loop: every step crashes. The supervisor restarts up to
   `max_engine_restarts`, then the breaker opens: everything resolves
   typed, health() reports unhealthy and submits raise
   EngineUnhealthyError.

Each drill ends with the invariant sweep (serving/invariants.py
`check_all`, strict): conservation, typed terminals, KV accounting, the
schema and /healthz hold on top of the drill's own checks. With
`--speculative_k` every drill runs on a speculative engine (greedy, the
streams then equal the serial route).

Prints one JSON record and exits 0 when every drill held.

  python -m megatron_tpu_torch.tools.chaos_serve --smoke [--device cpu]
      [--out FILE]
"""
from __future__ import annotations

import argparse
import sys
import time

from megatron_tpu_torch.tools.chaos_common import (adapter_generators,
                                                   emit_record,
                                                   invariant_sweep,
                                                   make_adapters, pool_mode,
                                                   resolve_all, tiny_engine)

RANK, ALPHA = 4, 8.0


def overload_drill(new_tokens: int, spec_k: int = 0, pool_kwargs=None,
                   n_adapters: int = 2, device=None, gen=None) -> dict:
    from megatron_tpu_torch.inference.generation import SamplingParams
    from megatron_tpu_torch.resilience.faults import (FaultInjector,
                                                      use_fault_injector)
    from megatron_tpu_torch.serving import OverloadShedError, SamplingOptions
    eng, gen = tiny_engine(dict(
        num_slots=2, max_queue=64, max_len=128, priority_levels=2,
        shed_on_overload=True, preemption=True, max_engine_restarts=2,
        speculative_k=spec_k, adapter_slots=n_adapters,
        adapter_rank=RANK, **(pool_kwargs or {})), device, gen)
    adapters = make_adapters(gen.cfg, n_adapters, RANK)
    for aid, factors in sorted(adapters.items()):
        eng.register_adapter(aid, factors=factors, rank=RANK, alpha=ALPHA)
    cycle = [None] + sorted(adapters)

    def aid_for(i):
        return cycle[i % len(cycle)]

    # greedy: one serial generate per (adapter, prompt, n) is the oracle
    sampling = SamplingOptions(temperature=0.0)
    reqs, shed = [], 0
    # NaN-poison one active slot a few steps in: the non-finite guard fails
    # that request while the grid decodes on
    injector = FaultInjector(serve_nan_calls={6: 0})
    try:
        with use_fault_injector(injector):
            # warmup: builds the kernels and gives the shed estimator its
            # first service time (it never sheds blind)
            eng.generate([3, 1, 4], 2, sampling, seed=0)
            # wave 1: low-priority work fills both slots and the queue (a
            # repeated motif gives the drafter something to match)
            for i in range(6):
                p = [5 + i, 2, 7, 2, 7]
                reqs.append((eng.submit(p, new_tokens, sampling, seed=i,
                                        priority=0, adapter_id=aid_for(i)),
                             p, new_tokens, aid_for(i)))
            # wait until low-priority work occupies the slots, so the
            # high-priority wave must preempt
            t_wait = time.monotonic() + 30
            while (eng.health()["active_slots"] < 2
                   and time.monotonic() < t_wait):
                time.sleep(0.002)
            for i in range(3):
                n = max(new_tokens // 2, 2)
                p = [9, 8 + i]
                reqs.append((eng.submit(p, n, sampling, seed=100 + i,
                                        priority=1,
                                        adapter_id=aid_for(i + 1)),
                             p, n, aid_for(i + 1)))
            # wave 2: hopeless deadlines, shed at submit by the estimator
            for i in range(16):
                p = [2, i + 1]
                try:
                    reqs.append((eng.submit(p, new_tokens, sampling,
                                            seed=200 + i, deadline_s=0.001,
                                            adapter_id=aid_for(i)),
                                 p, new_tokens, aid_for(i)))
                except OverloadShedError:
                    shed += 1
            outcomes = resolve_all([r for r, _, _, _ in reqs])
        snap = eng.metrics.snapshot()
        health = eng.health()
        oracles = adapter_generators(gen, adapters, RANK, ALPHA)
        cache, exact, checked, adapter_checked = {}, True, 0, 0
        for r, prompt, n, aid in reqs:
            if r.state.value != "finished":
                continue
            key = (aid, tuple(prompt), n)
            if key not in cache:
                t, lens, _ = oracles[aid].generate(
                    [prompt], n, SamplingParams(temperature=0.0))
                cache[key] = t[0, :lens[0]].tolist()
            checked += 1
            adapter_checked += aid is not None
            if r.prompt + r.generated != cache[key]:
                exact = False
        inv = invariant_sweep(eng, [r for r, _, _, _ in reqs])
    finally:
        eng.close()
    nan_fired = sum(1 for f, _ in injector.fired if f == "serve_nan")
    return {
        "submitted": len(reqs), "shed_at_submit": shed,
        "outcomes": outcomes,
        "preemptions": int(snap["preemptions"]),
        "requests_shed": int(snap["requests_shed"]),
        "nonfinite_logit_fails": int(snap["nonfinite_logit_fails"]),
        "nan_faults_fired": nan_fired,
        "speculative_k": spec_k,
        "spec_rounds": int(snap["spec_rounds"]),
        "draft_tokens": int(snap["draft_tokens"]),
        "adapters": n_adapters,
        "adapter_loads": int(snap["adapter_loads"]),
        "adapter_rows_checked": adapter_checked,
        "completed_token_exact": exact,
        "completed_checked": checked,
        "healthy_after": bool(health["healthy"]),
        "invariants_ok": inv["ok"],
        "invariant_violations": inv["violations"],
        "ok": (outcomes["stranded"] == 0
               and shed + int(snap["requests_shed"]) >= 1
               and int(snap["preemptions"]) >= 1
               and int(snap["nonfinite_logit_fails"]) >= nan_fired > 0
               and exact and checked >= 1
               and (spec_k == 0 or int(snap["spec_rounds"]) >= 1)
               and (n_adapters == 0
                    or (int(snap["adapter_loads"]) >= 1
                        and adapter_checked >= 1))
               and health["healthy"] and inv["ok"]),
    }


def hang_drill(timeout_s: float, stall_s: float, spec_k: int = 0,
               pool_kwargs=None, device=None, gen=None) -> dict:
    from megatron_tpu_torch.inference.generation import SamplingParams
    from megatron_tpu_torch.resilience.faults import (FaultInjector,
                                                      use_fault_injector)
    from megatron_tpu_torch.serving import SamplingOptions
    eng, gen = tiny_engine(dict(
        num_slots=1, max_queue=16, max_len=128,
        engine_step_timeout_s=timeout_s, max_engine_restarts=2,
        speculative_k=spec_k, **(pool_kwargs or {})), device, gen)
    sampling = SamplingOptions(temperature=0.0)
    try:
        # warmup: the kernels built and the watchdog armed (it arms after
        # the first full iteration)
        eng.generate([1, 2, 3], 2, sampling, seed=0)
        with use_fault_injector(FaultInjector(
                serve_delay_calls={1: stall_s})):
            victim = eng.submit([4, 5, 4, 5], 8, sampling, seed=1)
            t0 = time.monotonic()
            try:
                victim.result(timeout=stall_s + timeout_s + 30)
                victim_failed = False
            except TimeoutError:
                victim_failed = False
            except Exception:  # noqa: BLE001 — the watchdog failed it
                victim_failed = True
            detect_s = time.monotonic() - t0
            # the supervisor restarts after the stalled call returns; a
            # fresh probe then completes
            probe = eng.submit([6, 7, 6, 7], 4, sampling, seed=2)
            probe_toks, _ = probe.result(timeout=60)
            recovery_s = time.monotonic() - t0
        t, lens, _ = gen.generate([[6, 7, 6, 7]], 4,
                                  SamplingParams(temperature=0.0))
        probe_exact = probe_toks == t[0, :lens[0]].tolist()
        health = eng.health()
        snap = eng.metrics.snapshot()
        inv = invariant_sweep(eng, [victim, probe])
    finally:
        eng.close()
    return {
        "watchdog_timeout_s": timeout_s, "stall_s": stall_s,
        "victim_failed_typed": victim_failed,
        "detect_s": detect_s, "recovery_s": recovery_s,
        "engine_restarts": int(snap["engine_restarts"]),
        "speculative_k": spec_k,
        "probe_token_exact": probe_exact,
        "healthy_after": bool(health["healthy"]),
        "invariants_ok": inv["ok"],
        "invariant_violations": inv["violations"],
        # the watchdog fails the victim before the stalled call itself
        # returns
        "ok": (victim_failed and inv["ok"]
               and int(snap["engine_restarts"]) >= 1
               and detect_s < stall_s + timeout_s and probe_exact
               and health["healthy"] and health["state"] == "running"),
    }


def crash_loop_drill(spec_k: int = 0, pool_kwargs=None, device=None,
                     gen=None) -> dict:
    from megatron_tpu_torch.resilience.faults import (FaultInjector,
                                                      use_fault_injector)
    from megatron_tpu_torch.serving import (EngineUnhealthyError,
                                            SamplingOptions)
    eng, _ = tiny_engine(dict(
        num_slots=1, max_queue=16, max_len=128, max_engine_restarts=1,
        speculative_k=spec_k, **(pool_kwargs or {})), device, gen)
    sampling = SamplingOptions(temperature=1.0)
    try:
        eng.generate([1, 2], 2, sampling, seed=0)
        with use_fault_injector(FaultInjector(
                serve_crash_calls=set(range(1, 64)))):
            reqs = [eng.submit([3 + i], 4, sampling, seed=i)
                    for i in range(4)]
            outcomes = resolve_all(reqs, timeout=60)
        health = eng.health()
        snap = eng.metrics.snapshot()
        try:
            eng.submit([9], 2, sampling, seed=99)
            refused_503 = False
        except EngineUnhealthyError:
            refused_503 = True
        # the laws hold on a broken engine too
        inv = invariant_sweep(eng, reqs)
    finally:
        eng.close()
    return {
        "submitted": 4, "outcomes": outcomes,
        "engine_restarts": int(snap["engine_restarts"]),
        "breaker_open": bool(health["circuit_breaker_open"]),
        "state": health["state"],
        "submit_rejected_503": refused_503,
        "invariants_ok": inv["ok"],
        "invariant_violations": inv["violations"],
        "ok": (outcomes["stranded"] == 0 and outcomes["ok"] == 0
               and int(snap["engine_restarts"]) == 1
               and health["circuit_breaker_open"] and not health["healthy"]
               and refused_503 and inv["ok"]),
    }


def run_chaos(new_tokens: int, timeout_s: float, stall_s: float,
              spec_k: int = 0, block: int = 16, block_native: bool = True,
              n_adapters: int = 2, device=None, gen=None) -> dict:
    """The three drills; `gen` serves them over a Generator the caller
    built (chip_smoke's fp32 slice) instead of the tiny model."""
    t0 = time.monotonic()
    pool_kwargs = pool_mode(block, block_native)
    overload = overload_drill(new_tokens, spec_k, pool_kwargs, n_adapters,
                              device, gen)
    hang = hang_drill(timeout_s, stall_s, spec_k, pool_kwargs, device, gen)
    crash = crash_loop_drill(spec_k, pool_kwargs, device, gen)
    ok = overload["ok"] and hang["ok"] and crash["ok"]
    return {
        "metric": "serve_chaos_hang_recovery_s",
        "value": hang["recovery_s"],
        "unit": (f"s from the hang to a served probe (watchdog "
                 f"{timeout_s}s, stall {stall_s}s)"),
        "completed": ok,
        "speculative_k": spec_k,
        "kv_block_size": block or None,
        "block_native_attn": bool(block and block_native),
        "adapters": n_adapters,
        "overload": overload,
        "hang": hang,
        "crash_loop": crash,
        "wall_s": time.monotonic() - t0,
    }


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small fixed scenario")
    ap.add_argument("--new_tokens", type=int, default=24,
                    help="decode length of the overload wave's requests")
    ap.add_argument("--watchdog_s", type=float, default=1.0,
                    help="engine_step_timeout_s of the wedge drill")
    ap.add_argument("--stall_s", type=float, default=3.0,
                    help="the wedged step's stall")
    ap.add_argument("--speculative_k", type=int, default=4,
                    help="run every drill on a speculative engine at this "
                         "k (0: no speculation)")
    ap.add_argument("--adapters", type=int, default=2,
                    help="LoRA adapters interleaved through the overload "
                         "drill (0: none)")
    ap.add_argument("--kv_block_size", type=int, default=16,
                    help="the block pool's block size (0: whole-region)")
    ap.add_argument("--no_block_native", action="store_true",
                    help="the resolve/scatter bracket instead of the block "
                         "kernel")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)
    if args.smoke:
        args.new_tokens, args.watchdog_s, args.stall_s = 16, 1.0, 2.5
    record = run_chaos(args.new_tokens, args.watchdog_s, args.stall_s,
                       args.speculative_k, args.kv_block_size,
                       not args.no_block_native, args.adapters,
                       device if device is not None else args.device)
    emit_record(record, args.out, seed=0)
    return 0 if record["completed"] else 1


if __name__ == "__main__":
    sys.exit(main())
