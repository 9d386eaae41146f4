"""Continuous-batching serving engine (megatron_tpu/serving/engine.py, its
core loop).

Orca-style iteration-level scheduling over a pooled KV cache:

- one decode step over a fixed grid of `num_slots` batch slots: every
  slot's next token is sampled from its carried logits with its own knobs
  (`sample_batched`) and all slots forward one token together, each at its
  own position (per-row cache offsets and RoPE positions). Idle slots ride
  along and their outputs are discarded;
- each slot owns a region of a pre-allocated pool (serving/kv_pool.py),
  in `ServingConfig.kv_dtype`, else the generator's cache dtype (bf16,
  fp32, or int8 with per-(token, head) scales); a sliding-window model
  whose window W is below max_len gets a rolling pool of W positions a
  slot, which prefills at the exact prompt length (pad tokens would evict
  real ones from the ring). With `kv_block_size` the pool is a block
  arena: with `block_native_attn` the decode attention is the Hopper
  block kernel reading it through the per-slot block map (path 2);
  without, every decode step and prefill is bracketed by `resolve_view`
  (the slots' blocks gathered into the contiguous view), the dot path and
  `scatter_view` back (path 1, its bytes counted in
  `kv_gather_bytes_per_step`). Without blocks each slot owns a contiguous
  region and decode takes the dot path over it (path 0);
- a bounded, priority- and deadline-ordered queue (serving/scheduler.py)
  gives backpressure; between decode steps the loop drains it into free
  slots, prefilling same-bucket prompts together (`prefill_max_batch`,
  prompts padded to `prefill_bucket`, the batch to a power of two) through
  the flash kernel (the dot path for an int8 pool, as the serial route
  takes it), so new requests join the running batch at token granularity;
- `decode_sync_interval` K chains K decode steps on device state (lengths
  advance on the device) and fetches all K token grids in one transfer:
  one host sync per K tokens, at the cost of up to K-1 wasted steps for a
  request that finishes inside a window.

Seeded determinism: a request with seed s reproduces the port's serial
`Generator.generate([prompt], n, seed=s)` token for token. The slot's
`torch.Generator` is seeded with s and advanced past the draws the serial
path spends on its in-prompt steps (it prefills only a PREFILL_BUCKET
multiple of the prompt and steps through the rest), and each stochastic row
draws with the [1, vocab] call the serial path makes at batch 1. Greedy
rows carry no generator.

The engine loop runs on its own thread inside `torch.inference_mode` (which
is per thread); HTTP handler threads touch only host-side request results.

The loop is supervised (`_loop`). An iteration that raises fails the
requests in its slots, rebuilds the device state from scratch
(`_restart_session`: a new pool, logits, lengths; the old tensors are
dropped, since an in-place step that raised mid-layer left them half
written) and serves the queue on, up to `max_engine_restarts` times; one
more opens the circuit breaker: every request fails typed, `health()`
reports unhealthy and `submit` raises EngineUnhealthyError. Restarts age
out after RESTART_DECAY_S of healthy running. With
`engine_step_timeout_s` a detection-only `StepWatchdog`, armed after the
first full iteration (which builds the kernels) and fed while idle, fails
the in-flight requests from its own thread when an iteration stalls
(`_on_hang`) and flags the session, whose thread raises EngineHungError
when the stalled call returns: a restart like a crash. A CUDA fault is
sticky, so a restart after one fails to allocate and opens the breaker.
An active FaultInjector (resilience/faults.py) stalls, crashes or
NaN-poisons one slot at scheduled steps (`serve_delay`, `serve_crash`,
`serve_nan`).

The prefix cache, chunked prefill, preemption, speculative decoding,
adapters, structured output and fan-out come with later slices and raise
when configured (ServingConfig.validate).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from megatron_tpu_torch.config import SERVING_KV_DTYPES, ServingConfig
from megatron_tpu_torch.inference.generation import PREFILL_BUCKET, Generator
from megatron_tpu_torch.inference.sampling import sample, sample_batched
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.models.attention import KVCache
from megatron_tpu_torch.resilience.faults import get_fault_injector
from megatron_tpu_torch.resilience.watchdog import StepWatchdog
from megatron_tpu_torch.serving.kv_pool import (SlotKVPool,
                                                block_native_cache,
                                                insert_blocks, insert_prefill,
                                                resolve_view, scatter_view)
from megatron_tpu_torch.serving.metrics import ServingMetrics
from megatron_tpu_torch.serving.request import (GenRequest, RequestState,
                                                SamplingOptions)
from megatron_tpu_torch.serving.scheduler import (AdmissionScheduler,
                                                  EngineUnhealthyError,
                                                  OverloadShedError,
                                                  QueueFullError)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import print_rank_0


class EngineHungError(RuntimeError):
    """Raised by the loop when the watchdog flagged a wedged iteration that
    eventually returned: the supervisor treats it as a crash."""


class ServingEngine:
    """Drives generation for many concurrent requests through one decode
    grid. Built from a `Generator`, whose model, config and rope tables it
    reuses; `device` must name the generator's device (None: the current
    CUDA device, raising without one)."""

    # a restart this long ago no longer counts toward the crash-loop
    # breaker, which exists to catch a loop, not to add up isolated
    # recovered faults over a replica's lifetime
    RESTART_DECAY_S = 300.0

    def __init__(self, generator: Generator,
                 serving: Optional[ServingConfig] = None, *,
                 device: DeviceLike = None, start: bool = True):
        self.device = resolve_device(device)
        if generator.device != self.device:
            raise ValueError(f"generator runs on {generator.device}, the "
                             f"engine on {self.device}")
        self.gen = generator
        cfg = generator.cfg
        self.cfg = cfg
        self.serving = (serving if serving is not None
                        else ServingConfig()).validate(cfg)
        self.max_len = self.serving.max_len or cfg.max_position_embeddings
        if self.max_len > cfg.max_position_embeddings:
            raise ValueError(f"ServingConfig.max_len={self.max_len} exceeds "
                             "max_position_embeddings="
                             f"{cfg.max_position_embeddings}")
        self.num_slots = S = self.serving.num_slots
        kv_dtype = (generator.kv_cache_dtype if self.serving.kv_dtype is None
                    else SERVING_KV_DTYPES[self.serving.kv_dtype])
        self.pool = self._new_pool(kv_dtype)
        # 2 = block kernel, 1 = block pool through the resolve/scatter
        # bracket, 0 = whole-region dot path
        self._blocks_on = self.pool.blocks_enabled
        self._kernel_on = (self._blocks_on
                           and self.serving.block_native_attn)
        self._attn_path = (2 if self._kernel_on
                           else 1 if self._blocks_on else 0)
        # bytes one bracket (a gather or a scatter of the whole view)
        # moves; the bracketed prefills add to _bracket_bytes and _step
        # folds it into the window's per-step gauge (engine thread only)
        self._view_bytes = self.pool.view_nbytes()
        self._bracket_bytes = 0
        self.scheduler = AdmissionScheduler(
            self.serving.max_queue, max_total_len=self.max_len,
            num_slots=S, shed_on_overload=self.serving.shed_on_overload,
            default_deadline_s=self.serving.request_deadline_s)
        self.scheduler.notify = self._wake
        self.scheduler.active_fn = lambda: int(self._active.sum())
        self.metrics = ServingMetrics()
        self.metrics.kv_attn_path = self._attn_path
        self._vp = cfg.padded_vocab_size
        self._last_logits = torch.zeros(S, self._vp, dtype=torch.float32,
                                        device=self.device)
        # per-slot generator: None for greedy and idle rows
        self._gens: List[Optional[torch.Generator]] = [None] * S
        # per-slot host state (engine thread only)
        self._lengths = np.zeros(S, np.int32)
        self._active = np.zeros(S, bool)
        self._temps = np.ones(S, np.float32)
        self._top_ks = np.zeros(S, np.int64)
        self._top_ps = np.zeros(S, np.float32)
        self._slot_req: List[Optional[GenRequest]] = [None] * S
        # device copies, re-uploaded only on slot churn; between churns the
        # lengths advance on the device through the chained decode steps
        self._d_lengths = self._upload(self._lengths)
        self._sampling_dirty = True
        self._lengths_dirty = True
        self._kv_dirty = True
        self._admitting: List[GenRequest] = []
        self._sync_interval = self.serving.decode_sync_interval
        self._prefill_max_batch = max(
            min(self.serving.prefill_max_batch, S), 1)
        self._cond = threading.Condition()
        self._stop = False
        self._draining = False
        self._deadline_s = self.serving.request_deadline_s
        self._broken: Optional[str] = None
        # supervisor state: restarts consumed, the wedged-iteration flag
        # (set by the watchdog thread) and the detection-only watchdog,
        # armed after the first full iteration
        self._restarts = 0
        self._last_restart_t: Optional[float] = None
        self._wedged = False
        self._max_restarts = self.serving.max_engine_restarts
        self._watchdog: Optional[StepWatchdog] = None
        self._idle_wait = 0.5
        if self.serving.engine_step_timeout_s:
            self._watchdog = StepWatchdog(
                self.serving.engine_step_timeout_s, on_timeout=self._on_hang,
                exit_process=False, dump_stacks=False)
            # idle waits heartbeat faster than the deadline, or an empty
            # engine would look hung
            self._idle_wait = min(0.5,
                                  self.serving.engine_step_timeout_s / 4.0)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        if start:
            self._thread.start()

    def _new_pool(self, dtype) -> SlotKVPool:
        return SlotKVPool(self.cfg, self.num_slots, self.max_len,
                          dtype=dtype, block_size=self.serving.kv_block_size,
                          device=self.device)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # a copy: on the CPU torch.from_numpy would share the host array
        return torch.tensor(arr, device=self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               sampling: SamplingOptions = SamplingOptions(),
               seed: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None) -> GenRequest:
        """Non-blocking: enqueue and return the request handle. Raises
        QueueFullError (-> 429) on a full queue or a draining engine,
        OverloadShedError (-> 429) when early shedding fires,
        EngineUnhealthyError (-> 503) when the circuit breaker is open, and
        AdmissionError (-> 400) when the request can never fit.
        `priority` clamps into [0, priority_levels); `deadline_s`
        overrides the engine-wide request_deadline_s."""
        if self._broken:
            raise EngineUnhealthyError(
                f"engine unhealthy (circuit breaker open): {self._broken}")
        self.metrics.count("requests_received")
        try:
            if self._draining:
                raise QueueFullError(
                    "engine draining (shutdown in progress); retry "
                    "against another replica", retry_after=5,
                    queue_depth=self.scheduler.depth())
            priority = max(0, min(int(priority),
                                  self.serving.priority_levels - 1))
            req = GenRequest(list(prompt), max_new_tokens, sampling, seed,
                             priority=priority, deadline_s=deadline_s)
            req._on_terminal = self._count_terminal
            if max_new_tokens == 0:
                # nothing to decode: the serial path returns the prompt
                # unchanged; the same admission check still applies
                self.scheduler.check_admissible(req)
                req.mark_admitted()
                req.finish()
                self.metrics.record_admitted(0.0)
            else:
                self.scheduler.submit(req)
        except OverloadShedError:
            self.metrics.count("requests_shed")
            self.metrics.count("requests_rejected")
            raise
        except Exception:
            self.metrics.count("requests_rejected")
            raise
        return req

    def _count_terminal(self, req: GenRequest, outcome: str):
        """GenRequest's terminal hook: fires exactly once per request."""
        if outcome == "completed":
            self.metrics.record_completed(
                (req.finish_time or req.submit_time) - req.submit_time,
                len(req.generated))
        else:
            self.metrics.count("requests_" + outcome)

    def cancel(self, req: GenRequest):
        """A queued request is dropped and failed at once; a running one is
        evicted at the next iteration."""
        req.cancel()
        if not req.done():
            self.scheduler.cancel(req)
        self._wake()

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 64,
                 sampling: SamplingOptions = SamplingOptions(),
                 seed: int = 0, timeout: Optional[float] = None):
        """Blocking: submit and wait. Returns (prompt + generated tokens,
        generated logprobs)."""
        return self.submit(prompt, max_new_tokens, sampling,
                           seed).result(timeout)

    def close(self):
        """Stop the loop; fail queued and in-flight requests."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.ident is not None:
            self._thread.join(timeout=60)
        if self._watchdog is not None:
            self._watchdog.stop()
        for req in self.scheduler.close():
            req.fail("engine shut down")
        for req in self._slot_req:
            if req is not None and req.state is RequestState.RUNNING:
                req.fail("engine shut down")

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (queued requests fail with a
        retryable 503, new submits get 429), let every slotted request
        decode to completion, then stop the loop. True when it finished
        within `timeout`."""
        self._draining = True
        for req in self.scheduler.close():
            req.fail("engine draining (shutdown in progress); retry "
                     "against another replica", kind="unavailable")
        self._wake()
        if self._thread.ident is not None:
            self._thread.join(timeout)
        drained = not self._thread.is_alive()
        if drained and self._watchdog is not None:
            self._watchdog.stop()
        return drained

    def health(self) -> dict:
        """Liveness/readiness for `/healthz`: host-state reads only, each
        flag read once so that one payload is consistent while the
        watchdog thread may flip `_wedged`."""
        broken, draining, wedged = (self._broken, self._draining,
                                    self._wedged)
        pool = self.pool
        state = ("unhealthy" if broken else
                 "draining" if draining else
                 "wedged" if wedged else "running")
        loop_alive = self._thread.is_alive()
        healthy = broken is None and not wedged
        return {
            "healthy": healthy,
            "state": state,
            "accepting": healthy and state == "running" and loop_alive,
            "loop_alive": loop_alive,
            "circuit_breaker_open": broken is not None,
            "engine_restarts": self._restarts,
            "max_engine_restarts": self._max_restarts,
            "active_slots": int(self._active.sum()),
            "num_slots": self.num_slots,
            "queue_depth": self.scheduler.depth(),
            # the pool is None for the moment a restart rebuilds it
            "free_slots": int(pool.free_rows()) if pool is not None else 0,
            "service_time_ewma_ms":
                self.scheduler.service_time_ewma() * 1e3,
            "kv_attn_path": self._attn_path,
            "max_len": int(self.max_len),
            "detail": broken or "",
        }

    def queue_depth(self) -> int:
        return self.scheduler.depth()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # device-side steps
    # ------------------------------------------------------------------
    def _decode_fn(self):
        """One decode step for the whole slot grid: sample each slot's next
        token from its carried logits (logprob under the raw logits, the
        serial path's convention), forward all slots' tokens at their
        per-slot positions, advance the device lengths. The clamp at
        max_len - 1 binds only for rows idling past their end inside a
        window, and keeps their indices in range. Returns (tokens [S],
        logprobs [S]) on the device."""
        lengths = self._d_lengths
        toks = sample_batched(self._gens, self._last_logits,
                              temperature=self._d_temps,
                              top_k=self._d_top_ks, top_p=self._d_top_ps,
                              vocab_size=self.cfg.vocab_size)
        lps = torch.log_softmax(self._last_logits, dim=-1).gather(
            -1, toks[:, None])[:, 0]
        if self._kernel_on:
            caches = block_native_cache(self.pool.caches)
        elif self._blocks_on:
            caches = resolve_view(self.pool.caches)
        else:
            caches = self.pool.caches
        caches = dataclasses.replace(caches, offset=lengths)
        logits, caches = lm.model_forward(
            self.gen.params, toks[:, None], self.cfg, kv_caches=caches,
            position_ids=lengths[:, None].long(), rope=self.gen.rope)
        if self._blocks_on and not self._kernel_on:
            scatter_view(self.pool.caches, caches)
        self._last_logits = logits[:, 0]
        self._d_lengths = torch.clamp(lengths + 1, max=self.max_len - 1)
        return toks, lps

    def _prefill_bucket(self, plen: int) -> int:
        """Prompts pad up to a multiple of `prefill_bucket`; a rolling pool
        prefills at the exact length (pad tokens fed through the ring would
        evict real ones)."""
        if self.pool.rolling:
            return plen
        b = self.serving.prefill_bucket
        return min(-(-plen // b) * b, self.max_len)

    @staticmethod
    def _batch_bucket(n: int) -> int:
        """A prefill batch rounds up to a power of two."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _initial_rng(self, seed: int, plen: int) -> torch.Generator:
        """A request's generator, seeded and advanced past the draws the
        serial path spends on its in-prompt steps: Generator.generate
        prefills the prompt rounded down to a PREFILL_BUCKET multiple and
        draws once per position from there, the prompt's own included."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        burn = plen - max((plen // PREFILL_BUCKET) * PREFILL_BUCKET, 1)
        if burn:
            dummy = torch.zeros(1, self._vp, device=self.device)
            for _ in range(burn):
                sample(gen, dummy, temperature=1.0)
        return gen

    # ------------------------------------------------------------------
    # engine loop (single thread)
    # ------------------------------------------------------------------
    def _wake(self):
        with self._cond:
            self._cond.notify_all()

    def _heartbeat(self):
        if self._watchdog is not None and self._watchdog.started:
            self._watchdog.heartbeat()

    def _loop(self):
        """Supervisor: run `_session` until it exits cleanly; after a
        crashed or hung iteration restart it (rebuild the device state,
        fail only the slotted requests, serve the queue on) up to
        `max_engine_restarts` times, then open the circuit breaker."""
        blocks = (f", {self.pool.block_size}-token blocks"
                  if self._blocks_on else "")
        if self._kernel_on:
            blocks += ", block-native attn"
        elif self._blocks_on:
            blocks += ", resolve/scatter bracket"
        print_rank_0(
            f"serving engine: {self.num_slots} slots x cap "
            f"{self.pool.cap} ({self.pool.dtype}"
            f"{', rolling' if self.pool.rolling else ''}{blocks}), "
            f"pool {self.pool.nbytes() / 2**20:.1f} MiB, "
            f"queue bound {self.serving.max_queue}")
        while True:
            try:
                with torch.inference_mode():
                    if self._session():
                        return
            except Exception as e:  # noqa: BLE001 — supervise, not hang
                # only the message leaves this block: the traceback's
                # frames hold the failed step's tensors, which must be
                # gone before the restart allocates new ones
                msg = repr(e)
            if self._restarts >= self._max_restarts:
                self._trip_breaker(msg)
                return
            self._restarts += 1
            self._last_restart_t = time.monotonic()
            self.metrics.count("engine_restarts")
            print_rank_0(f"serving engine: loop failed ({msg}); restarting "
                         f"({self._restarts}/{self._max_restarts})")
            try:
                # a slow rebuild must not trip the deadline: in the crash
                # path the watchdog has not fired, and firing now would
                # fail requests the restart keeps queued
                if self._watchdog is not None:
                    with self._watchdog.suspend():
                        self._restart_session(msg)
                else:
                    self._restart_session(msg)
            except Exception as e2:  # noqa: BLE001
                self._trip_breaker(f"restart failed: {e2!r} (after {msg})")
                return

    def _session(self) -> bool:
        """The engine loop proper. Returns True on a clean exit (stop, or
        drain complete); raises on a crashed or watchdog-flagged
        iteration."""
        while True:
            with self._cond:
                while (not self._stop and not self._draining
                       and not self._wedged
                       and self.scheduler.depth() == 0
                       and not self._active.any()):
                    self._cond.wait(timeout=self._idle_wait)
                    self._heartbeat()  # idleness is not a hang
                if self._stop:
                    return True
                if self._draining and not self._active.any():
                    return True
            if self._wedged:
                raise EngineHungError(
                    "engine iteration exceeded the watchdog deadline "
                    f"({self.serving.engine_step_timeout_s}s); in-flight "
                    "requests were failed by the watchdog")
            self._maybe_decay_restarts()
            self._reap_cancelled()
            self._reap_expired()
            self._admit()
            self._heartbeat()  # admission may build kernels; decode is
            #                    the call the deadline protects
            if self._active.any():
                self._step()
            if self._watchdog is not None:
                if not self._watchdog.started:
                    # armed after a full iteration: the first one builds
                    # the kernels, unrelated to the steady-state deadline
                    self._watchdog.start()
                else:
                    self._watchdog.heartbeat()

    # ------------------------------------------------------------------
    # supervisor: hang detection, restart, circuit breaker
    # ------------------------------------------------------------------
    def _maybe_decay_restarts(self):
        """Forget consumed restarts after RESTART_DECAY_S of healthy
        running (the `engine_restarts` counter keeps counting)."""
        if self._restarts and self._last_restart_t is not None and \
                time.monotonic() - self._last_restart_t \
                > self.RESTART_DECAY_S:
            print_rank_0(
                f"serving engine: {self._restarts} restart(s) aged out "
                f"(> {self.RESTART_DECAY_S:.0f}s healthy); crash-loop "
                "budget reset")
            self._restarts = 0
            self._last_restart_t = None

    def _on_hang(self):
        """Watchdog thread: no loop progress within the deadline. Fail
        every in-flight request now (its device state is suspect and the
        engine thread is stuck), flag the session wedged, and let the
        supervisor restart when the stalled call returns. Queued requests
        stay: they are host-side and are served after the restart."""
        self._wedged = True
        msg = (f"engine hung: no decode-loop progress within "
               f"{self.serving.engine_step_timeout_s:.1f}s (watchdog); "
               "request failed, engine restarting")
        print_rank_0("serving " + msg)
        for req in list(self._slot_req):
            if req is not None:
                req.fail(msg)
        # pops wedged inside a prefill dispatch are in no slot yet
        for req in list(self._admitting):
            req.fail(msg)
        self._wake()

    def _trip_breaker(self, msg: str):
        """More crashes than `max_engine_restarts`: the engine goes and
        stays unhealthy. Every in-flight and queued request fails typed,
        `submit` raises EngineUnhealthyError, `/healthz` reports
        unhealthy."""
        self._broken = (f"circuit breaker open after {self._restarts} "
                        f"restart(s): {msg}")
        print_rank_0(f"serving engine: {self._broken}")
        for req in self._slot_req:
            if req is not None:
                req.fail(self._broken)
        for req in self.scheduler.close():
            req.fail(self._broken, kind="unavailable")

    def _restart_session(self, msg: str):
        """Reset after a crashed or hung iteration. The slotted requests
        fail (their streams rest on state no longer trusted); queued ones
        stay queued. The device state is built anew: the port updates the
        pool in place, so a step that raised mid-layer left it half
        written, and every reference to the old tensors is dropped first
        so that a full-size pool is never held twice. Host state the
        restart does not touch survives: the scheduler and its
        service-time estimate."""
        for req in self._slot_req:
            if req is not None:
                req.fail(f"engine step failed while this request was "
                         f"slotted: {msg}")
        S = self.num_slots
        dtype = self.pool.dtype
        self._slot_req = [None] * S
        self._gens = [None] * S
        self.pool = self._last_logits = None
        self._d_lengths = self._d_temps = None
        self._d_top_ks = self._d_top_ps = None
        self.pool = self._new_pool(dtype)
        self._last_logits = torch.zeros(S, self._vp, dtype=torch.float32,
                                        device=self.device)
        self._lengths[:] = 0
        self._active[:] = False
        self._d_lengths = self._upload(self._lengths)
        self._sampling_dirty = True
        self._lengths_dirty = True
        self._kv_dirty = True
        self._bracket_bytes = 0
        self._wedged = False
        if self._watchdog is not None:
            self._watchdog.rearm()

    def _admit(self):
        popped = self.scheduler.pop_ready(self.pool.free_count())
        if not popped:
            return
        pending = list(popped)
        self._admitting = pending
        try:
            for padded, reqs in AdmissionScheduler.group_by_bucket(
                    popped, lambda r: self._prefill_bucket(len(r.prompt)),
                    self._prefill_max_batch):
                self._prefill_group(reqs, padded)
                for r in reqs:
                    pending.remove(r)
        except Exception as e:
            for r in pending:
                r.fail(repr(e))
            raise
        finally:
            self._admitting = []

    def _prefill_group(self, reqs: List[GenRequest], padded: int):
        """One batched prefill for same-bucket admissions. The batch rounds
        up to a power of two with pad rows replicating row 0; only the real
        rows land in the pool. The prefill cache is [L, batch, padded]: its
        positions past a prompt's length are garbage that decode overwrites
        before reading."""
        B_real = len(reqs)
        B = self._batch_bucket(B_real)
        if self._blocks_on:
            slots = []
            for _ in reqs:
                got = self.pool.alloc_row(sync=False)
                if got is None:
                    raise RuntimeError("popped more requests than free "
                                       "slots")
                slots.append(got[0])
            self.pool._sync_map()  # one map upload for the group
        else:
            slots = [self.pool.alloc() for _ in reqs]
        plens = [len(r.prompt) for r in reqs]
        toks = np.full((B, padded), self.gen.pad_id, np.int64)
        for i, r in enumerate(reqs):
            toks[i, :plens[i]] = r.prompt
        toks[B_real:] = toks[0]
        last = np.asarray(plens + [plens[0]] * (B - B_real)) - 1
        caches = self.pool.make_prefill_caches(B, padded)
        logits, caches = lm.model_forward(
            self.gen.params, self._upload(toks), self.cfg,
            kv_caches=caches, rope=self.gen.rope,
            head_positions=self._upload(last))
        # the bracketed mode lands the rows in the gathered view and
        # scatters it back, as the reference's prefill program does
        view = (resolve_view(self.pool.caches)
                if self._blocks_on and not self._kernel_on else None)
        for i, (slot, plen, req) in enumerate(zip(slots, plens, reqs)):
            sub = KVCache(caches.k[:, i:i + 1], caches.v[:, i:i + 1], 0,
                          *(None if sc is None else sc[:, i:i + 1]
                            for sc in (caches.k_scale, caches.v_scale)))
            if self._kernel_on:
                insert_blocks(self.pool.caches, sub, slot, plen)
            else:
                insert_prefill(view if view is not None
                               else self.pool.caches, sub, slot, plen)
            self._last_logits[slot] = logits[i, 0]
            sp = req.sampling
            self._gens[slot] = (
                None if sp.temperature == 0.0 or sp.top_k == 1
                else self._initial_rng(req.seed, plen))
            self._lengths[slot] = plen
            self._active[slot] = True
            self._temps[slot] = sp.temperature
            self._top_ks[slot] = sp.top_k
            self._top_ps[slot] = sp.top_p
            self._slot_req[slot] = req
            # a request admitted before (then requeued) records its queue
            # wait once
            first = req.admit_time is None
            req.mark_admitted()  # no-op on a concurrently failed request
            if first and req.admit_time is not None:
                self.metrics.record_admitted(req.admit_time
                                             - req.submit_time)
            req.prefill_chunks = 1
        if view is not None:
            scatter_view(self.pool.caches, view)
            self._bracket_bytes += 2 * self._view_bytes
        self._sampling_dirty = True
        self._kv_dirty = True
        self._lengths_dirty = True
        self.metrics.count("prefill_calls")
        self.metrics.count("prefill_prompts", B_real)
        self.metrics.count("prefill_forward_tokens", int(sum(plens)))

    def _reap_cancelled(self):
        for slot in np.nonzero(self._active)[0]:
            req = self._slot_req[slot]
            if req is not None and req.cancelled:
                self._evict(slot, failed="cancelled")

    def _reap_expired(self):
        """Evict running slots and drop queued requests whose deadline
        (request `deadline_s`, else request_deadline_s) ran out."""
        now = time.monotonic()
        for slot in np.nonzero(self._active)[0]:
            req = self._slot_req[slot]
            if req is None:
                continue
            ad = req.absolute_deadline(self._deadline_s)
            if ad is not None and now > ad:
                self._evict(
                    slot,
                    failed=(f"deadline exceeded after "
                            f"{now - req.submit_time:.1f}s "
                            f"(deadline {ad - req.submit_time:.1f}s, "
                            f"{len(req.generated)} tokens generated)"),
                    kind="deadline")
        self.scheduler.drop_expired(self._deadline_s, now)

    def _evict(self, slot: int, failed: Optional[str] = None,
               kind: str = "error"):
        slot = int(slot)
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._active[slot] = False
        self._gens[slot] = None
        self._lengths[slot] = 0  # idle rows park at position 0
        self.pool.release(slot)
        self._kv_dirty = True
        self._lengths_dirty = True
        self._sampling_dirty = True
        if failed is not None:
            req.fail(failed, kind=kind)
            return
        if req.finish():
            self.scheduler.observe_service(
                req.finish_time - (req.admit_time or req.submit_time))

    def _step(self):
        """K chained decode steps, ONE host sync, then bookkeeping. A
        request that hits EOS or its token budget at inner step r discards
        the window's remaining K-1-r steps (`wasted_decode_steps`) and is
        evicted at the boundary; per-request streams are the same for any
        K, since no slot's logits, generator or KV cross slots or
        windows."""
        K = self._sync_interval
        inj = get_fault_injector()
        if inj is not None:
            # serving fault points: stall the loop (watchdog bait), crash
            # the iteration (supervisor bait), or NaN-poison one active
            # slot's carried logits for the non-finite guard to catch
            call = inj.next_serve_step()
            inj.maybe_serve_delay(call)
            inj.check_serve_crash(call)
            ordinal = inj.serve_nan_slot(call)
            if ordinal is not None:
                act = np.nonzero(self._active)[0]
                if len(act):
                    self._last_logits[int(act[ordinal % len(act)])] = \
                        float("nan")
        if self._sampling_dirty:
            # a filter off on every drawing row is passed as None, and
            # sampling skips its sort
            draws = np.array([g is not None for g in self._gens])
            ks, ps = self._top_ks[draws], self._top_ps[draws]
            self._d_temps = self._upload(self._temps)
            self._d_top_ks = (self._upload(self._top_ks) if (ks > 0).any()
                              else None)
            self._d_top_ps = (self._upload(self._top_ps)
                              if ((ps > 0) & (ps < 1)).any() else None)
            self._sampling_dirty = False
            self.metrics.count("sampling_uploads")
        if self._lengths_dirty or not self._active.all():
            # churn re-syncs positions from the host; a partly idle grid
            # also re-parks its idle rows each window
            self._d_lengths = self._upload(self._lengths)
            self._lengths_dirty = False
        tok_steps, lp_steps = [], []
        for _ in range(K):
            toks, lps = self._decode_fn()
            tok_steps.append(toks)
            lp_steps.append(lps)
        toks = torch.stack(tok_steps).cpu().numpy()  # the window's one sync
        tok_lp = torch.stack(lp_steps).cpu().numpy()
        self.metrics.count("host_syncs")
        if self._wedged:
            # the watchdog flagged this iteration in flight and already
            # failed its requests: its results rest on untrusted state
            raise EngineHungError("engine iteration exceeded the watchdog "
                                  "deadline mid-dispatch")
        active_slots = np.nonzero(self._active)[0]
        n_active = len(active_slots)
        consumed = np.zeros(K, np.int64)
        commit_t = time.monotonic()
        for slot in active_slots:
            req = self._slot_req[slot]
            had = len(req.generated)
            for r in range(K):
                lp = float(tok_lp[r, slot])
                if not math.isfinite(lp):
                    # a poisoned request fails; the engine continues
                    self.metrics.count("nonfinite_logit_fails")
                    if K - 1 - r:
                        self.metrics.count("wasted_decode_steps", K - 1 - r)
                    self._evict(slot, failed=(
                        f"non-finite logits at position "
                        f"{int(self._lengths[slot])} (after "
                        f"{len(req.generated)} tokens)"))
                    break
                tok = int(toks[r, slot])
                first = not req.generated
                req.append_token(tok, lp)
                if first:
                    self.metrics.record_first_token(req.ttft)
                self._lengths[slot] += 1
                consumed[r] += 1
                if (tok == self.gen.eos_id
                        or len(req.generated) >= req.max_new_tokens):
                    if K - 1 - r:
                        self.metrics.count("wasted_decode_steps", K - 1 - r)
                    self._evict(slot)
                    break
            n_new = len(req.generated) - had
            prev = getattr(req, "_last_commit_t", None)
            if prev is not None and n_new:
                self.metrics.record_inter_token((commit_t - prev) / n_new)
            req._last_commit_t = commit_t
        # bytes the bracket moved this window, per step: one gather and
        # one scatter of the whole view per decode step, plus the
        # bracketed prefills since the last window
        window_bracket = self._bracket_bytes
        self._bracket_bytes = 0
        if self._blocks_on and not self._kernel_on:
            window_bracket += K * 2 * self._view_bytes
        self.metrics.set_attn_gauges(window_bracket // K, self._attn_path)
        depth = self.scheduler.depth()
        for k in range(K):
            self.metrics.record_step(n_active, self.num_slots,
                                     int(consumed[k]), depth)
        if self._kv_dirty:
            self.metrics.set_kv_gauges(*self.pool.kv_gauges(self._lengths))
            self._kv_dirty = False
