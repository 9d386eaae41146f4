"""Scripted live-weight chaos drills (the port of the root
tools/chaos_upgrade.py, drills 1-2): rolling fleet upgrades under traffic
with failures at the worst moments, over a real EngineRouter in front of
two real ServingEngine replicas and real manifest-sealed checkpoints on
disk.

1. Kill the draining replica mid-rollout: traffic flows while
   `rolling_upgrade` walks the fleet, and replica 0 is closed the moment
   it enters its planned drain. The rollout aborts typed
   (RollingUpgradeError), the fleet stays degraded-not-down and serves
   on, no future strands, and every completed request equals the serial
   oracle of the version it was admitted under (1 or 2).
2. A corrupt publish mid-watch: a CheckpointWatcher drives the fleet; a
   good publish upgrades it, a corrupt one is refused at the manifest gate
   (the fleet stays on the good version, `weight_swap_failures` counts it,
   the watcher does not retry the same tag), and the next good publish
   applies.

Drill 3 of the reference races an upgrade with the disaggregated
prefill/decode handoff; it needs the serving topology (ROADMAP Queue 1
item 7) and raises NotImplementedError. Each drill ends with the
invariant sweep (serving/invariants.py `check_all`).

Prints one JSON record and exits 0 when every drill held.

  python -m megatron_tpu_torch.tools.chaos_upgrade --smoke [--device cpu]
      [--out FILE]
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import threading
import time

from megatron_tpu_torch.tools.chaos_common import (corrupt_payload,
                                                   emit_record,
                                                   invariant_sweep,
                                                   publish_checkpoint,
                                                   serial_oracle,
                                                   tiny_model_cfg)
from megatron_tpu_torch.utils.device import resolve_device

_DRILL_3 = ("drill 3 (an upgrade racing the disaggregated handoff) needs "
            "the serving topology (ROADMAP Queue 1 item 7): a "
            "disaggregated replica is a group of devices, which the port "
            "does not build yet")


class _Fleet:
    """Two replicas serving version 1 of the tiny model (the weights of
    seed 0), with version 2 (seed 1) already published under a checkpoint
    root; `model(seed)` builds the weights of later versions."""

    def __init__(self, serving_kwargs, device=None):
        import torch

        from megatron_tpu_torch.config import ServingConfig
        from megatron_tpu_torch.inference.generation import Generator
        from megatron_tpu_torch.serving import EngineRouter, ServingEngine
        self.device = resolve_device(device)
        self.cfg = tiny_model_cfg()
        m1, m2 = self.model(0), self.model(1)
        # eos -1: no early EOS, request lifetimes are their budgets
        self.gens = [Generator(m, self.cfg, eos_id=-1, pad_id=0,
                               device=self.device,
                               kv_cache_dtype=torch.float32)
                     for m in (m1, m2)]
        self.root = tempfile.mkdtemp(prefix="chaos_upgrade_")
        self.d2 = publish_checkpoint(self.root, m2, self.cfg, 2)
        serving = ServingConfig(**serving_kwargs).validate(self.cfg)
        self.engines = [ServingEngine(self.gens[0], serving,
                                      device=self.device)
                        for _ in range(2)]
        self.router = EngineRouter(self.engines, max_retries=2,
                                   heartbeat_timeout_s=3.0,
                                   probe_backoff_s=0.2)

    def model(self, seed: int):
        from megatron_tpu_torch.models.language_model import LanguageModel
        return LanguageModel(self.cfg, device=self.device, seed=seed)

    def close(self):
        self.router.close()
        shutil.rmtree(self.root, ignore_errors=True)


def _load_workers(router, new_tokens, n_workers=3):
    """Background greedy traffic: (results, stop, threads), each result
    (prompt, seed, tokens or None, error or None)."""
    from megatron_tpu_torch.serving import SamplingOptions
    sampling = SamplingOptions(temperature=0.0)
    results, stop, lock = [], threading.Event(), threading.Lock()

    def worker(wid):
        i = 0
        while not stop.is_set():
            p = [3 + (wid + i) % 5, 7, 11]
            seed = 1000 * wid + i
            try:
                toks, _ = router.submit(p, new_tokens, sampling,
                                        seed=seed).result(timeout=120)
                with lock:
                    results.append((p, seed, toks, None))
            except Exception as e:  # noqa: BLE001 — counted by the caller
                with lock:
                    results.append((p, seed, None, e))
            i += 1

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_workers)]
    for t in threads:
        t.start()
    return results, stop, threads


def _classify(results, want1, want2, new_tokens):
    """(errors, at version 1, at version 2, mismatches) of the results."""
    errors, v1, v2, bad = [], 0, 0, []
    for p, seed, toks, err in results:
        if err is not None:
            errors.append(repr(err))
        elif toks == want1(p, new_tokens, seed):
            v1 += 1
        elif toks == want2(p, new_tokens, seed):
            v2 += 1
        else:
            bad.append((p, seed, toks))
    return errors, v1, v2, bad


def kill_draining_drill(new_tokens: int, device=None) -> dict:
    from megatron_tpu_torch.serving import SamplingOptions
    from megatron_tpu_torch.serving.router import RollingUpgradeError
    fleet = _Fleet(dict(num_slots=2, max_queue=64, max_len=128), device)
    router, engines = fleet.router, fleet.engines
    want1, want2 = (serial_oracle(g) for g in fleet.gens)
    sampling = SamplingOptions(temperature=0.0)
    try:
        for eng in engines:
            eng.generate([3, 1, 4], 2, sampling, seed=0)
        # widen the mid-swap window: replica 0's apply stalls briefly, so
        # the kill lands while it drains or applies, never after
        orig_apply = engines[0]._apply_swap

        def slow_apply(ticket):
            time.sleep(0.5)
            return orig_apply(ticket)

        engines[0]._apply_swap = slow_apply
        engines[0].submit([2, 2, 2], 80, sampling, seed=0)
        results, stop, threads = _load_workers(router, new_tokens)
        time.sleep(0.2)
        aborted = []

        def upgrade():
            try:
                router.rolling_upgrade(fleet.d2, swap_timeout_s=120)
            except RollingUpgradeError as e:
                aborted.append(repr(e))

        up = threading.Thread(target=upgrade)
        up.start()
        t0 = time.monotonic()
        while not router.replicas[0].upgrading \
                and time.monotonic() - t0 < 30:
            time.sleep(0.002)
        time.sleep(0.05)
        engines[0].close()  # the draining replica dies mid-swap
        up.join(timeout=180)
        # traffic goes on over the degraded fleet until it has served a
        # few requests (a loaded host may have served few so far)
        t0 = time.monotonic()
        while len(results) < 6 and time.monotonic() - t0 < 60:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join()
        errors, v1, v2, bad = _classify(results, want1, want2, new_tokens)
        health = router.health()
        snap = router.aggregate_snapshot()
        # the degraded fleet still serves, on version 1 (the rollout died
        # before any replica upgraded)
        post = router.submit([9, 9, 8], 4, sampling, seed=99)
        post_exact = post.result(timeout=60)[0] == want1([9, 9, 8], 4, 99)
        inv = invariant_sweep(router, [post])
    finally:
        fleet.close()
    return {
        "submitted": len(results), "errors": len(errors),
        "completed_v1": v1, "completed_v2": v2,
        "version_mismatches": len(bad),
        "rollout_aborted_typed": len(aborted) == 1,
        "health_state": health["state"],
        "healthz_ready": bool(health["healthy"]),
        "weight_swap_failures": int(snap["weight_swap_failures"]),
        "post_kill_serve_exact": post_exact,
        "invariants_ok": inv["ok"],
        "invariant_violations": inv["violations"],
        "ok": (not errors and not bad and len(aborted) == 1
               and health["state"] == "degraded" and health["healthy"]
               and post_exact and (v1 + v2) == len(results)
               and (v1 + v2) >= 4 and inv["ok"]),
    }


def corrupt_watch_drill(new_tokens: int, device=None) -> dict:
    from megatron_tpu_torch.serving import SamplingOptions
    from megatron_tpu_torch.serving.weights import CheckpointWatcher
    fleet = _Fleet(dict(num_slots=2, max_queue=64, max_len=128), device)
    router, engines = fleet.router, fleet.engines
    want2 = serial_oracle(fleet.gens[1])
    sampling = SamplingOptions(temperature=0.0)
    try:
        for eng in engines:
            eng.generate([3, 1, 4], 2, sampling, seed=0)
        watcher = CheckpointWatcher(router, fleet.root, interval_s=0.1)
        # beat 1: the good version-2 publish (on disk already) applies
        applied = watcher.poll_once()
        snap1 = router.aggregate_snapshot()
        on_v2 = snap1["weight_version_min"] == 2.0 \
            == snap1["weight_version_max"]
        toks, _ = router.submit([5, 6, 7], new_tokens, sampling,
                                seed=5).result(timeout=60)
        exact_v2 = toks == want2([5, 6, 7], new_tokens, 5)
        # beat 2: a corrupt version 3, refused, counted, not retried
        corrupt_payload(publish_checkpoint(fleet.root, fleet.model(2),
                                           fleet.cfg, 3))
        refused = not watcher.poll_once()
        failures_1 = watcher.failures
        re_polled = not watcher.poll_once()  # the same tag: skipped
        failures_2 = watcher.failures
        snap2 = router.aggregate_snapshot()
        stayed = snap2["weight_version_min"] == 2.0 \
            == snap2["weight_version_max"]
        # beat 3: the next good publish applies
        publish_checkpoint(fleet.root, fleet.model(3), fleet.cfg, 4)
        recovered = watcher.poll_once()
        snap3 = router.aggregate_snapshot()
        on_v4 = snap3["weight_version_min"] == 4.0 \
            == snap3["weight_version_max"]
        health = router.health()
        inv = invariant_sweep(router)
    finally:
        fleet.close()
    return {
        "good_publish_applied": bool(applied),
        "fleet_on_v2": on_v2, "serve_exact_v2": exact_v2,
        "corrupt_publish_refused": refused,
        "no_retry_loop": re_polled and failures_1 == failures_2 == 1,
        "fleet_stayed_on_v2": stayed,
        "weight_swap_failures": int(snap2["weight_swap_failures"]),
        "next_publish_applied": bool(recovered),
        "fleet_on_v4": on_v4,
        "health_state": health["state"],
        "invariants_ok": inv["ok"],
        "invariant_violations": inv["violations"],
        "ok": (bool(applied) and on_v2 and exact_v2 and refused
               and re_polled and failures_2 == 1 and stayed
               and int(snap2["weight_swap_failures"]) >= 1
               and bool(recovered) and on_v4
               and health["state"] == "running" and inv["ok"]),
    }


def disagg_race_drill(*args, **kwargs) -> dict:
    raise NotImplementedError(_DRILL_3)


def run_chaos(new_tokens: int, device=None) -> dict:
    t0 = time.monotonic()
    kill = kill_draining_drill(new_tokens, device)
    watch = corrupt_watch_drill(new_tokens, device)
    ok = kill["ok"] and watch["ok"]
    return {
        "metric": "upgrade_chaos_swap_failures_contained",
        "value": (kill["weight_swap_failures"]
                  + watch["weight_swap_failures"]),
        "unit": ("refused or failed swaps across the kill and corrupt-watch "
                 "drills (the fleet served through every one)"),
        "completed": ok,
        "kill_draining": kill,
        "corrupt_watch": watch,
        "disagg_race": {"not_run": _DRILL_3},
        "wall_s": time.monotonic() - t0,
    }


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small fixed scenario")
    ap.add_argument("--new_tokens", type=int, default=12,
                    help="decode length of the drills' requests")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)
    if args.smoke:
        args.new_tokens = 8
    record = run_chaos(args.new_tokens,
                       device if device is not None else args.device)
    emit_record(record, args.out, seed=0)
    return 0 if record["completed"] else 1


if __name__ == "__main__":
    sys.exit(main())
