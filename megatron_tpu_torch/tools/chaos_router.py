"""Scripted front-door chaos drills (the port of the root
tools/chaos_router.py, drills 1-3): a replica killed, a replica wedged and
a host-tier entry corrupted, each over a real EngineRouter in front of two
real ServingEngine replicas of one tiny model, checking that no future
strands and no token moves.

1. Replica kill: one replica is closed mid-traffic. Every future resolves,
   every completion (retried ones included) equals the serial route, the
   router ejects the dead replica (`router_failovers`) and retries its
   work on the survivor (`router_retries`), /healthz reports degraded (not
   down), and new submits succeed.
2. Wedge: one replica's decode step stalls past its watchdog deadline
   mid-decode. The watchdog fails the wedged work, the router retries it
   on the survivor token-exact, and once the stalled replica's supervisor
   restarts it the router re-admits it through one half-open canary: both
   replicas end in rotation.
3. Host-tier corruption: a demoted prefix restores through the router
   (affinity picks the replica holding it) token-exact; then its host
   bytes are flipped and the next hit is a checksum miss
   (`host_tier_checksum_misses`) that recomputes, still token-exact.

Drills 4 and 5 of the reference (a disaggregated replica losing its
prefill or decode half, a pipeline-sharded replica losing a stage) need
the serving topology (ROADMAP Queue 1 item 7) and raise
NotImplementedError. The reference's invariant sweep comes with the
invariant checker (item 6).

Prints one JSON record and exits 0 when every drill held.

  python -m megatron_tpu_torch.tools.chaos_router --smoke [--device cpu]
      [--out FILE]
"""
from __future__ import annotations

import argparse
import sys
import time

from megatron_tpu_torch.tools.chaos_common import (emit_record, resolve_exact,
                                                   serial_oracle, tiny_router)

_DRILLS_4_5 = ("the serving topology (ROADMAP Queue 1 item 7): a "
               "disaggregated or pipeline-sharded replica is a group of "
               "devices, which the port does not build yet")


def kill_drill(new_tokens: int, device=None) -> dict:
    from megatron_tpu_torch.serving import SamplingOptions
    router, engines, gen = tiny_router(dict(
        num_slots=2, max_queue=64, max_len=128, enable_prefix_cache=True,
        kv_block_size=16, block_native_attn=True), device=device)
    sampling = SamplingOptions(temperature=0.0)
    want = serial_oracle(gen)
    try:
        for eng in engines:
            eng.generate([3, 1, 4], 2, sampling, seed=0)
        reqs = []
        for i in range(8):
            p = [5 + i, 2, 7, 2, 7]
            reqs.append((router.submit(p, new_tokens, sampling, seed=i), p,
                         new_tokens))
        # wait until work is decoding on replica 0, then kill it
        give_up = time.monotonic() + 30
        while (engines[0].health()["active_slots"] == 0
               and time.monotonic() < give_up):
            time.sleep(0.002)
        engines[0].close()
        outcomes, exact = resolve_exact(reqs, want)
        health = router.health()
        snap = router.aggregate_snapshot()
        post = router.submit([9, 9, 8], 4, sampling, seed=99)
        post_exact = post.result(timeout=60)[0] == want([9, 9, 8], 4)
    finally:
        router.close()
    return {
        "submitted": len(reqs), "outcomes": outcomes,
        "completed_token_exact": exact,
        "router_failovers": int(snap["router_failovers"]),
        "router_retries": int(snap["router_retries"]),
        "health_state": health["state"],
        "healthz_ready": bool(health["healthy"]),
        "post_kill_serve_exact": post_exact,
        "ok": (outcomes["stranded"] == 0 and outcomes["error"] == 0
               and outcomes["ok"] == len(reqs) and exact
               and int(snap["router_failovers"]) >= 1
               and health["state"] == "degraded" and health["healthy"]
               and post_exact),
    }


def wedge_drill(new_tokens: int, timeout_s: float, stall_s: float,
                device=None) -> dict:
    from megatron_tpu_torch.serving import SamplingOptions
    router, engines, gen = tiny_router(
        dict(num_slots=1, max_queue=32, max_len=128,
             engine_step_timeout_s=timeout_s, max_engine_restarts=2),
        heartbeat_s=timeout_s, device=device)
    sampling = SamplingOptions(temperature=0.0)
    want = serial_oracle(gen)
    try:
        for eng in engines:
            # the kernels built and each watchdog armed
            eng.generate([1, 2, 3], 2, sampling, seed=0)
        # replica 0's next decode step stalls past its watchdog deadline
        decode = engines[0]._decode_fn
        fired = []

        def stalling_decode():
            if not fired:
                fired.append(1)
                time.sleep(stall_s)
            return decode()

        engines[0]._decode_fn = stalling_decode
        reqs = []
        for i in range(4):
            p = [4 + i, 5, 4, 5]
            reqs.append((router.submit(p, new_tokens, sampling, seed=i), p,
                         new_tokens))
        outcomes, exact = resolve_exact(reqs, want,
                                        timeout=stall_s + timeout_s + 60)
        snap = router.aggregate_snapshot()
        # the restarted replica comes back through a half-open canary:
        # traffic drives it, until both replicas are in rotation
        recovered = False
        give_up = time.monotonic() + stall_s + 30
        while time.monotonic() < give_up:
            h = router.health()
            if h["state"] == "running" and h["replicas_up"] == 2:
                recovered = True
                break
            try:
                router.submit([8, 8], 2, sampling, seed=7).result(30)
            except Exception:  # noqa: BLE001 — the probe loop goes on
                pass
            time.sleep(0.05)
        health = router.health()
    finally:
        router.close()
    return {
        "watchdog_timeout_s": timeout_s, "stall_s": stall_s,
        "submitted": len(reqs), "outcomes": outcomes,
        "completed_token_exact": exact,
        "router_failovers": int(snap["router_failovers"]),
        "router_retries": int(snap["router_retries"]),
        "wedged_fired": bool(fired),
        "recovered_both_up": recovered,
        "health_state": health["state"],
        "ok": (outcomes["stranded"] == 0 and outcomes["error"] == 0
               and exact and bool(fired) and recovered),
    }


def host_tier_drill(new_tokens: int, device=None) -> dict:
    import numpy as np

    from megatron_tpu_torch.serving import SamplingOptions
    router, engines, gen = tiny_router(dict(
        num_slots=2, max_queue=32, max_len=128, enable_prefix_cache=True,
        kv_block_size=16, block_native_attn=True, retained_slots=1,
        host_kv_bytes=1 << 22), device=device)
    sampling = SamplingOptions(temperature=0.0)
    want = serial_oracle(gen)
    prefix = list(range(2, 20))  # more than one 16-token block
    try:
        # warm replica 0 only, then churn its retained entries so that the
        # prefix demotes to host RAM
        engines[0].generate(prefix, new_tokens, sampling, seed=0)
        engines[0].generate([40, 41, 42], 2, sampling, seed=0)
        engines[0].generate([50, 51, 52], 2, sampling, seed=0)
        tier = engines[0]._host_tier
        demoted = len(tier) >= 1
        # a clean restore through the router: affinity picks replica 0
        p1 = prefix + [90, 91]
        affinity = router.prefix_peek(p1)
        r1 = router.submit(p1, new_tokens, sampling, seed=1)
        exact1 = r1.result(60)[0] == want(p1, new_tokens)
        routed_to_warm = r1.replica.idx == 0
        snap1 = router.aggregate_snapshot()
        # churn the device copy out (a device hit would win), corrupt
        # every demoted entry holding a whole block, and hit again
        engines[0].generate([60, 61, 62], 2, sampling, seed=0)
        engines[0].generate([70, 71, 72], 2, sampling, seed=0)
        for ent in tier._entries.values():
            if ent.length >= 16:
                ent.arrays["k"].view(np.uint8).flat[0] ^= 0xFF
        p2 = prefix + [92, 93]
        exact2 = router.submit(p2, new_tokens, sampling,
                               seed=2).result(60)[0] == want(p2, new_tokens)
        snap2 = router.aggregate_snapshot()
    finally:
        router.close()
    return {
        "demoted": demoted,
        "affinity_peek_tokens": int(affinity),
        "routed_to_warm_replica": routed_to_warm,
        "host_tier_demotions": int(snap2["host_tier_demotions"]),
        "host_tier_hits": int(snap2["host_tier_hits"]),
        "host_tier_checksum_misses": int(snap2["host_tier_checksum_misses"]),
        "clean_restore_exact": exact1,
        "corrupt_restore_exact": exact2,
        "ok": (demoted and affinity >= 16 and routed_to_warm
               and int(snap1["host_tier_hits"]) >= 1 and exact1
               and int(snap2["host_tier_checksum_misses"]) >= 1 and exact2),
    }


def kill_half_drill(*args, **kwargs) -> dict:
    raise NotImplementedError(f"drill 4 (kill a replica's prefill or decode "
                              f"half) needs {_DRILLS_4_5}")


def kill_stage_drill(*args, **kwargs) -> dict:
    raise NotImplementedError(f"drill 5 (kill a pipeline stage) needs "
                              f"{_DRILLS_4_5}")


def run_chaos(new_tokens: int, timeout_s: float, stall_s: float,
              device=None) -> dict:
    t0 = time.monotonic()
    kill = kill_drill(new_tokens, device)
    wedge = wedge_drill(new_tokens, timeout_s, stall_s, device)
    host = host_tier_drill(new_tokens, device)
    ok = kill["ok"] and wedge["ok"] and host["ok"]
    return {
        "metric": "router_chaos_failover_retries",
        "value": kill["router_retries"] + wedge["router_retries"],
        "unit": ("requests retried on a survivor across the kill and wedge "
                 "drills (all token-exact, none lost)"),
        "completed": ok,
        "kill": kill,
        "wedge": wedge,
        "host_tier": host,
        "wall_s": time.monotonic() - t0,
    }


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small fixed scenario")
    ap.add_argument("--new_tokens", type=int, default=24,
                    help="decode length of the drills' requests")
    ap.add_argument("--watchdog_s", type=float, default=1.0,
                    help="engine_step_timeout_s of the wedge drill")
    ap.add_argument("--stall_s", type=float, default=3.0,
                    help="the wedged step's stall")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)
    if args.smoke:
        args.new_tokens, args.watchdog_s, args.stall_s = 12, 1.0, 2.5
    record = run_chaos(args.new_tokens, args.watchdog_s, args.stall_s,
                       device if device is not None else args.device)
    emit_record(record, args.out, seed=0)
    return 0 if record["completed"] else 1


if __name__ == "__main__":
    sys.exit(main())
