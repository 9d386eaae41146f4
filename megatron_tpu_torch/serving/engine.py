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
  fp32, or int8 with per-(token, head) scales).
  With `kv_block_size` and `block_native_attn` the pool is a block arena
  and the decode attention is the Hopper block kernel reading it through
  the per-slot block map; without, each slot owns a contiguous region and
  decode takes the dot path over it;
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
A step that raises fails the slotted and queued requests and marks the
engine unhealthy (`health()`, EngineUnhealthyError on submit); supervisor
restarts, the watchdog, the prefix cache, chunked prefill, preemption,
speculative decoding, adapters, structured output and fan-out come with
later slices and raise when configured (ServingConfig.validate).
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
from megatron_tpu_torch.serving.kv_pool import (SlotKVPool,
                                                block_native_cache,
                                                insert_blocks, insert_prefill)
from megatron_tpu_torch.serving.metrics import ServingMetrics
from megatron_tpu_torch.serving.request import (GenRequest, RequestState,
                                                SamplingOptions)
from megatron_tpu_torch.serving.scheduler import (AdmissionScheduler,
                                                  EngineUnhealthyError,
                                                  OverloadShedError,
                                                  QueueFullError)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


class ServingEngine:
    """Drives generation for many concurrent requests through one decode
    grid. Built from a `Generator`, whose model, config and rope tables it
    reuses; `device` must name the generator's device (None: the current
    CUDA device, raising without one)."""

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
        self.pool = SlotKVPool(cfg, S, self.max_len, dtype=kv_dtype,
                               block_size=self.serving.kv_block_size,
                               device=self.device)
        # block pools run only block-native here (validate refuses the
        # bracketed mode); 2 = block kernel, 0 = whole-region dot path
        self._kernel_on = self.pool.blocks_enabled
        self._attn_path = 2 if self._kernel_on else 0
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
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        if start:
            self._thread.start()

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
        EngineUnhealthyError (-> 503) after a crashed step, and
        AdmissionError (-> 400) when the request can never fit.
        `priority` clamps into [0, priority_levels); `deadline_s`
        overrides the engine-wide request_deadline_s."""
        if self._broken:
            raise EngineUnhealthyError(
                f"engine unhealthy: {self._broken}")
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
        return not self._thread.is_alive()

    def health(self) -> dict:
        """Liveness/readiness for `/healthz`: host-state reads only."""
        broken, draining = self._broken, self._draining
        state = ("unhealthy" if broken else
                 "draining" if draining else "running")
        loop_alive = self._thread.is_alive()
        healthy = broken is None
        return {
            "healthy": healthy,
            "state": state,
            "accepting": healthy and state == "running" and loop_alive,
            "loop_alive": loop_alive,
            "circuit_breaker_open": broken is not None,
            "engine_restarts": 0,
            "max_engine_restarts": self.serving.max_engine_restarts,
            "active_slots": int(self._active.sum()),
            "num_slots": self.num_slots,
            "queue_depth": self.scheduler.depth(),
            "free_slots": int(self.pool.free_rows()),
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
        caches = (block_native_cache(self.pool.caches) if self._kernel_on
                  else self.pool.caches)
        caches = dataclasses.replace(caches, offset=lengths)
        logits, _ = lm.model_forward(self.gen.params, toks[:, None],
                                     self.cfg, kv_caches=caches,
                                     position_ids=lengths[:, None].long(),
                                     rope=self.gen.rope)
        self._last_logits = logits[:, 0]
        self._d_lengths = torch.clamp(lengths + 1, max=self.max_len - 1)
        return toks, lps

    def _prefill_bucket(self, plen: int) -> int:
        """Prompts pad up to a multiple of `prefill_bucket`."""
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

    def _loop(self):
        """Run the loop; a step that raises fails the slotted and queued
        requests and leaves the engine unhealthy (restarts come with the
        supervisor in a later slice)."""
        try:
            with torch.inference_mode():
                self._session()
        except Exception as e:  # noqa: BLE001 — a crash fails its requests
            self._broken = f"engine step failed: {e!r}"
            for req in self._slot_req:
                if req is not None:
                    req.fail(self._broken)
            for req in self._admitting:
                req.fail(self._broken)
            for req in self.scheduler.close():
                req.fail(self._broken, kind="unavailable")

    def _session(self):
        while True:
            with self._cond:
                while (not self._stop and not self._draining
                       and self.scheduler.depth() == 0
                       and not self._active.any()):
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    return
                if self._draining and not self._active.any():
                    return
            self._reap_cancelled()
            self._reap_expired()
            self._admit()
            if self._active.any():
                self._step()

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
        if self._kernel_on:
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
        for i, (slot, plen, req) in enumerate(zip(slots, plens, reqs)):
            sub = KVCache(caches.k[:, i:i + 1], caches.v[:, i:i + 1], 0,
                          *(None if sc is None else sc[:, i:i + 1]
                            for sc in (caches.k_scale, caches.v_scale)))
            if self._kernel_on:
                insert_blocks(self.pool.caches, sub, slot, plen)
            else:
                insert_prefill(self.pool.caches, sub, slot, plen)
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
            req.mark_admitted()  # no-op on a concurrently failed request
            if req.admit_time is not None:
                self.metrics.record_admitted(req.admit_time
                                             - req.submit_time)
            req.prefill_chunks = 1
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
        depth = self.scheduler.depth()
        for k in range(K):
            self.metrics.record_step(n_active, self.num_slots,
                                     int(consumed[k]), depth)
        if self._kv_dirty:
            self.metrics.set_kv_gauges(*self.pool.kv_gauges(self._lengths))
            self._kv_dirty = False
