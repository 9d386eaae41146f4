"""Serving metrics registry: queue depth, TTFT, tokens/s, occupancy
(megatron_tpu/serving/metrics.py, with the counters and gauges of the
core engine, the prefix cache, chunked prefill, preemption, speculative
decoding, the front door (the router, SSE streams and the host KV tier),
LoRA serving, live weights, structured output, fan-out and the brownout
ladder with its SLO accounting).

Counters and latency reservoirs are updated from the engine loop and HTTP
threads and snapshotted as plain floats for `/metrics`. Beside the
reference's reservoirs the port keeps one of inter-token gaps (the host
clock between a slot's consecutive commits), the serving latency a
streaming client would see between tokens.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional, Tuple


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence; 0.0 for an
    empty window (a /metrics scrape before the first request)."""
    vals = list(sorted_vals)
    if not vals:
        return 0.0
    idx = min(len(vals) - 1, max(0, int(q * len(vals))))
    return vals[idx]


# counters a snapshot always carries (0.0 before any traffic), so a scrape
# of a fresh engine has the schema of a busy one. Every terminal transition
# is counted once through GenRequest's terminal hook, so on a quiet engine
#   requests_received == requests_completed + requests_rejected
#                        + requests_failed + requests_cancelled
#                        + requests_expired
# (requests_rejected: submit-time refusals, requests_shed its early-shedding
# subset; requests_failed: failures after admission)
_BASE_COUNTERS = (
    "requests_received", "requests_admitted", "requests_completed",
    "requests_rejected", "requests_failed",
    "requests_cancelled", "requests_expired", "requests_shed",
    "tokens_generated", "decode_steps", "host_syncs",
    "wasted_decode_steps", "sampling_uploads",
    "prefill_calls", "prefill_prompts", "prefill_forward_tokens",
    "nonfinite_logit_fails", "engine_restarts",
    # prefix cache: prefix_hit_tokens counts tokens matched at lookup
    # (with hits forfeited to pool pressure), prefill_tokens_saved those
    # whose forward a KV copy replaced; prefill_chunks counts chunked and
    # suffix forwards, preemptions the running slots evicted for a
    # higher-priority arrival
    "prefix_hits", "prefix_hit_tokens", "prefill_tokens_saved",
    "prefill_chunks", "preemptions",
    # speculative decoding: verify rounds, drafts proposed for live rows,
    # drafts committed, and plain decode steps a speculative engine ran
    # because no slot proposed a draft
    "spec_rounds", "draft_tokens", "accepted_tokens", "spec_fallback_steps",
    # front door: replicas the router ejected from rotation, attempts it
    # resubmitted to a survivor, prefix restores served from the host-RAM
    # KV tier, retained block lists demoted there on eviction, demoted
    # entries dropped because their checksum no longer verified (a miss,
    # never wrong tokens), and SSE streams resumed through Last-Event-ID
    "router_failovers", "router_retries", "host_tier_hits",
    "host_tier_demotions", "host_tier_checksum_misses",
    "stream_reconnects",
    # remote replicas (serving/remote.py): calls to a replica process that
    # hit a connect or read timeout (it may be wedged, not dead),
    # transport-level retries of one HTTP call (distinct from
    # router_retries, a whole request resubmitted to a survivor), and
    # health probes that failed with a typed transport fault
    "router_remote_timeouts", "router_remote_retries",
    "router_probe_failures",
    # LoRA serving: adapters written into bank rows, rows evicted under
    # bank pressure, loads served from the checksummed host copy, and host
    # copies dropped because their checksum failed (a reload from source)
    "adapter_loads", "adapter_evictions", "adapter_host_hits",
    "adapter_host_checksum_misses",
    # live weights: hot swaps applied, swaps refused or failed (the old
    # weights serve on each time), completed rolling fleet upgrades
    "weight_swaps", "weight_swap_failures", "rolling_upgrades",
    # structured output and fan-out: grammar-constrained requests
    # admitted (one a sample), per-slot mask rows written to the device
    # (only when a slot's FSM state changes: a self-loop state reuses its
    # row), requests failed typed (422) because every token was masked,
    # fan-outs admitted and the samples they expanded into (each sample
    # also counts in requests_received)
    "structured_requests", "mask_uploads", "grammar_dead_ends",
    "fanout_requests", "fanout_samples",
    # the brownout ladder and SLO accounting: level changes (either
    # direction), first tokens later than slo_ttft_ms, sync windows whose
    # inter-token gap exceeded slo_itl_p99_ms, and the generated tokens
    # of completed requests that met their TTFT SLO (all of them without
    # an SLO)
    "degrade_transitions", "slo_ttft_violations", "slo_itl_violations",
    "goodput_tokens",
)

# gauges a snapshot always carries, by the attribute each is stored under.
# kv_blocks_retained: blocks (regions on a whole-region pool) pinned by
# retained prefixes; kv_attn_path: 0 = whole-region pool (dot path),
# 1 = block pool through
# the resolve/scatter bracket, 2 = block-native kernel;
# kv_gather_bytes_per_step: the bytes the bracket moved per decode step
# over the last sync window (0 on the other two paths);
# fleet_replicas_up: the router's replicas in rotation (router-pushed);
# active_adapters: device-resident LoRA adapters; degrade_level: the
# brownout ladder's level (the router reports the fleet's maximum).
# Beside these every
# snapshot carries `weight_version`, the served checkpoint's iteration (0
# until a versioned start or a swap), which the router reports as the
# fleet's minimum with `weight_version_min`/`_max`.
# Every gauge here needs an aggregation rule in serving/router.py, or a
# fleet scrape reads it as 0 (tests/test_torch_router.py pins that).
_BASE_GAUGES = (
    "queue_depth", "active_slots", "num_slots",
    "kv_blocks_used", "kv_blocks_retained", "kv_bytes_wasted",
    "kv_gather_bytes_per_step", "kv_attn_path", "fleet_replicas_up",
    "active_adapters", "degrade_level",
)


class ServingMetrics:
    """Thread-safe registry. The record_* methods are cheap (no device
    sync); `snapshot()` computes derived stats on demand."""

    def __init__(self, max_samples: int = 4096,
                 throughput_window_s: float = 30.0):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._ttft: Deque[float] = collections.deque(maxlen=max_samples)
        self._itl: Deque[float] = collections.deque(maxlen=max_samples)
        self._queue_wait: Deque[float] = collections.deque(
            maxlen=max_samples)
        self._req_latency: Deque[float] = collections.deque(
            maxlen=max_samples)
        # (timestamp, tokens emitted that step) for the tokens/s window
        self._token_events: Deque[Tuple[float, int]] = collections.deque(
            maxlen=max_samples)
        self._window_s = throughput_window_s
        # occupancy accumulators (slot-steps busy / slot-steps total)
        self._busy_slot_steps = 0
        self._total_slot_steps = 0
        for name in _BASE_GAUGES:
            setattr(self, name, 0)
        self.weight_version = 0.0

    # ---- recording ---------------------------------------------------
    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] += n

    def record_admitted(self, queue_wait_s: float):
        with self._lock:
            self._counters["requests_admitted"] += 1
            self._queue_wait.append(queue_wait_s)

    def record_first_token(self, ttft_s: float):
        with self._lock:
            self._ttft.append(ttft_s)

    def record_inter_token(self, gap_s: float):
        with self._lock:
            self._itl.append(gap_s)

    def record_completed(self, latency_s: float, gen_tokens: int,
                         good_tokens: Optional[int] = None):
        """`good_tokens`: the SLO-conformant share of `gen_tokens` (the
        goodput ledger); None counts every completed token."""
        with self._lock:
            self._counters["requests_completed"] += 1
            self._counters["tokens_generated"] += gen_tokens
            self._counters["goodput_tokens"] += (
                gen_tokens if good_tokens is None else good_tokens)
            self._req_latency.append(latency_s)

    def set_kv_gauges(self, blocks_used: int, blocks_retained: int,
                      bytes_wasted: int):
        """Engine-pushed KV-pool occupancy and fragmentation gauges
        (SlotKVPool.kv_gauges)."""
        with self._lock:
            self.kv_blocks_used = int(blocks_used)
            self.kv_blocks_retained = int(blocks_retained)
            self.kv_bytes_wasted = int(bytes_wasted)

    def set_attn_gauges(self, gather_bytes_per_step: int, path: int):
        """Engine-pushed attention-path gauges, once a sync window."""
        with self._lock:
            self.kv_gather_bytes_per_step = int(gather_bytes_per_step)
            self.kv_attn_path = int(path)

    def set_fleet_gauge(self, replicas_up: int):
        """Router-pushed: the replicas currently in rotation."""
        with self._lock:
            self.fleet_replicas_up = int(replicas_up)

    def set_adapter_gauge(self, active: int):
        """Engine-pushed: device-resident LoRA adapters."""
        with self._lock:
            self.active_adapters = int(active)

    def set_degrade_gauge(self, level: int) -> None:
        """Engine-pushed on every brownout-ladder transition."""
        with self._lock:
            self.degrade_level = int(level)

    def set_weight_version(self, iteration) -> None:
        """Engine-pushed: the iteration of the weights being served."""
        with self._lock:
            self.weight_version = float(iteration)

    def record_step(self, active_slots: int, num_slots: int,
                    tokens_emitted: int, queue_depth: int):
        now = time.monotonic()
        with self._lock:
            self._counters["decode_steps"] += 1
            self._busy_slot_steps += active_slots
            self._total_slot_steps += num_slots
            self._token_events.append((now, tokens_emitted))
            self.queue_depth = queue_depth
            self.active_slots = active_slots
            self.num_slots = num_slots

    # ---- derived -----------------------------------------------------
    def tokens_per_s(self) -> float:
        now = time.monotonic()
        with self._lock:
            events = [(t, n) for t, n in self._token_events
                      if now - t <= self._window_s]
        if len(events) < 2:
            return 0.0
        span = max(now - events[0][0], 1e-9)
        return sum(n for _, n in events) / span

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            counters = dict(self._counters)
            ttft = sorted(self._ttft)
            itl = sorted(self._itl)
            qwait = sorted(self._queue_wait)
            lat = sorted(self._req_latency)
            occ = (self._busy_slot_steps / self._total_slot_steps
                   if self._total_slot_steps else 0.0)
            gauges = {k: float(getattr(self, k)) for k in _BASE_GAUGES}
            gauges["weight_version"] = float(self.weight_version)
        out = {k: 0.0 for k in _BASE_COUNTERS}
        out.update({k: float(v) for k, v in counters.items()})
        out.update(gauges)
        out.update({
            "ttft_p50_ms": _percentile(ttft, 0.50) * 1e3,
            "ttft_p95_ms": _percentile(ttft, 0.95) * 1e3,
            "ttft_p99_ms": _percentile(ttft, 0.99) * 1e3,
            "itl_p50_ms": _percentile(itl, 0.50) * 1e3,
            "itl_p99_ms": _percentile(itl, 0.99) * 1e3,
            "queue_wait_p50_ms": _percentile(qwait, 0.50) * 1e3,
            "queue_wait_p95_ms": _percentile(qwait, 0.95) * 1e3,
            "queue_wait_p99_ms": _percentile(qwait, 0.99) * 1e3,
            "latency_p50_ms": _percentile(lat, 0.50) * 1e3,
            "latency_p95_ms": _percentile(lat, 0.95) * 1e3,
            "tokens_per_s": self.tokens_per_s(),
            "slot_occupancy": occ,
        })
        steps = counters.get("decode_steps", 0)
        out["host_syncs_per_step"] = (
            counters.get("host_syncs", 0) / steps if steps else 0.0)
        calls = counters.get("prefill_calls", 0)
        out["prompts_per_prefill"] = (
            counters.get("prefill_prompts", 0) / calls if calls else 0.0)
        return out
