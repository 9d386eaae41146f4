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

Throughput features (engine.py, the same machinery): every request that
does not take the batched prefill becomes a pending prefill
(`_PendingPrefill`): it holds a slot (on a block pool its blocks, the map
row left on TRASH until activation) and its KV accumulates in a batch-1
cache outside the pool, which the grid's idle writes cannot reach; the
loop runs one chunk of one pending request per iteration, between decode
steps, and the last chunk lands it with one insert.

- Prefix cache (`enable_prefix_cache`, `retained_slots`): a host trie
  (serving/prefix_index.py) indexes each slot's prompt at activation and a
  finished request's full sequence at retention (serving/kv_pool.py). A
  hit, floored to whole blocks and capped at len - 1 so one suffix token
  forwards for the logits, copies the prefix out of the pool (on a block
  pool the prefix blocks are aliased into the new row, and the insert
  skips them) and forwards only the suffix. A rolling block pool adds the
  ring-validity gate and forwards the suffix one token an iteration.
- Chunked prefill (`prefill_chunk`): a longer prompt forwards in chunks,
  the first at offset 0 through the flash kernel, the rest through the dot
  path at their offset.
- Preemption (`preemption`): a queued request of higher priority with no
  allocatable slot evicts the lowest-priority running slot. The victim's
  KV is copied out (`slice_blocks` / `slice_slot`) with its carried logits
  row, its generator state and its residual carry, and it is requeued; it
  resumes with one insert. Beyond `num_slots` parked victims, or after a
  restart, it replays its prompt plus generated tokens through prefill and
  continues its saved generator: the same stream either way.
- Speculative decoding (`speculative_k`, `drafter=`): each step proposes k
  drafts a running slot on the host (serving/spec_decode.py) and verifies
  every slot's window [t0, d1..dk] in one forward (the block kernel at
  w = k + 1). Greedy rows accept by exact match, drawing rows by u < p
  under the processed distribution; each drawing row draws t0 and then k
  uniforms from its own generator every step, a fallback decode step too,
  so a seeded stream does not depend on the other slots. Lengths rewind
  to 1 + accepted, the carried logits are those after the last committed
  token, and a stochastic rejection bans its draft from the next draw.

- Host KV tier (`host_kv_bytes`, serving/host_tier.py): a retained block
  list evicted under block pressure demotes to host RAM (the pool's
  `on_evict_entry` fires before the unref; the entry's blocks are copied to
  host numpy arrays under a CRC32), and a later prompt whose longest cached
  prefix lives only there restores it: the checksum is verified, the live
  blocks are uploaded into a batch-1 cache of the region's length and the
  suffix prefills on it like a device hit. Only a strictly longer host match beats a device hit;
  a corrupt entry is a miss. `prefix_peek` reads both halves for the
  router (serving/router.py).

- LoRA adapters (`adapter_slots`, serving/adapters.py): a device bank of
  stacked factors with the identity row 0, and a per-slot `adapter_idx`
  beside the block map. `submit(adapter_id=...)` pins the adapter's row at
  admission (loading it, evicting the LRU unpinned row under pressure;
  every row pinned requeues the request), and every forward of the slot
  (its prefill, decode steps and verify windows) adds its adapter's
  low-rank delta. Base rows gather row 0's zeros; with `adapter_slots=0`
  there is no bank and the forward is today's. Prefix lookups are
  namespaced by (weight generation, adapter namespace), so a prefix never
  hits across adapters, registrations or weight versions; a preempted
  request re-acquires its adapter at resume.
- Live weights (`swap_weights`, serving/weights.py): a checkpoint is
  verified against its manifest and staged in host memory on the calling
  thread; at the swap point admissions hold (nothing is rejected), the
  slots and pending prefills in flight finish under the old weights, and
  between two iterations the engine builds the new device tree and flips
  its Generator to it. Then the prefix index is rebuilt, retained prefixes
  and host-tier entries drop, the weight generation bumps, queued requests
  carrying resume state fail typed and retryable, and every adapter's
  generation bumps. A refused checkpoint raises `WeightSwapError` and the
  engine serves on. The engine keeps its own Generator view, so replicas
  that share a Generator swap one at a time.

Structured output and fan-out come with later slices and raise when
configured (ServingConfig.validate).
"""
from __future__ import annotations

import copy
import dataclasses
import math
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from megatron_tpu_torch.config import SERVING_KV_DTYPES, ServingConfig
from megatron_tpu_torch.inference.generation import (PREFILL_BUCKET,
                                                     Generator, prefill_chunk,
                                                     verify_tokens)
from megatron_tpu_torch.inference.sampling import (sample, sample_batched,
                                                   verify_draft_probs)
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.models.attention import KVCache
from megatron_tpu_torch.resilience.faults import get_fault_injector
from megatron_tpu_torch.resilience.watchdog import StepWatchdog
from megatron_tpu_torch.serving.adapters import (AdapterBank,
                                                 AdapterBankFullError,
                                                 UnknownAdapterError)
from megatron_tpu_torch.serving.host_tier import HostKVTier
from megatron_tpu_torch.serving.kv_pool import (SlotKVPool,
                                                block_native_cache,
                                                insert_blocks, insert_prefill,
                                                resolve_view, scatter_view,
                                                slice_blocks, slice_slot)
from megatron_tpu_torch.serving.metrics import ServingMetrics
from megatron_tpu_torch.serving.prefix_index import PrefixIndex
from megatron_tpu_torch.serving.request import (GenRequest, RequestState,
                                                SamplingOptions)
from megatron_tpu_torch.serving.scheduler import (AdmissionScheduler,
                                                  EngineUnhealthyError,
                                                  OverloadShedError,
                                                  QueueFullError)
from megatron_tpu_torch.serving.spec_decode import (NGramDrafter,
                                                    build_draft_rounds)
from megatron_tpu_torch.serving.weights import (WeightSwapError, load_staged,
                                                place_params)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import print_rank_0

# a preempted greedy row's saved generator state: it draws nothing
_NO_RNG = torch.empty(0, dtype=torch.uint8)


class EngineHungError(RuntimeError):
    """Raised by the loop when the watchdog flagged a wedged iteration that
    eventually returned: the supervisor treats it as a crash."""


class _HostSrc:
    """A prefix-lookup source in the host KV tier (not a slot or a
    retained entry): carries the tier's key. `_start_pending` restores it
    into a fresh batch-1 cache; nothing is aliased."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key


class _SwapTicket:
    """One pending weight swap: the staged checkpoint from the calling
    thread, applied by the engine thread at the swap point. `taken` flips
    (under the engine's condition) when the engine commits to applying, so
    a caller that times out can tell a cancellable wait from an apply in
    flight; `done` carries the verdict."""

    __slots__ = ("staged", "done", "taken", "version", "error", "created")

    def __init__(self, staged):
        self.staged = staged
        self.done = threading.Event()
        self.taken = False
        self.version = None
        self.error: Optional[BaseException] = None
        self.created = time.perf_counter()


class _PendingPrefill:
    """A request mid-prefill (engine.py _PendingPrefill). It owns a slot,
    but its KV accumulates in `sub`, a batch-1 cache outside the pool that
    the grid's idle writes cannot reach. `pos` counts the tokens whose KV
    `sub` holds (the prefix length on a hit); `last` is the logits row of
    the latest chunk's last real token; `tokens` is the sequence being
    prefilled (the prompt, or prompt + generated for a preemption replay);
    `rng` the generator the slot decodes with. On a block pool `blocks` are
    the reserved physical blocks (the map row stays on TRASH until
    activation installs them), `pfx_blocks` the aliased count the insert
    skips, and `installed` whether the row was installed. `aidx` is the
    adapter bank row the chunks forward under (0: the base model)."""

    __slots__ = ("req", "slot", "sub", "pos", "rng", "last", "tokens",
                 "blocks", "pfx_blocks", "installed", "aidx")

    def __init__(self, req: GenRequest, slot: int, sub: KVCache, pos: int,
                 rng: Optional[torch.Generator], tokens: List[int],
                 blocks: Optional[List[int]] = None, pfx_blocks: int = 0):
        self.req = req
        self.slot = slot
        self.sub = sub
        self.pos = pos
        self.rng = rng
        self.last: Optional[torch.Tensor] = None
        self.tokens = tokens
        self.blocks = blocks
        self.pfx_blocks = pfx_blocks
        self.installed = False
        self.aidx = int(req.bank_idx)


class ServingEngine:
    """Drives generation for many concurrent requests through one decode
    grid. Built from a `Generator`, whose model, config and rope tables it
    reuses; `device` must name the generator's device (None: the current
    CUDA device, raising without one). `weight_version` names the
    checkpoint the generator's weights came from, when known."""

    # a restart this long ago no longer counts toward the crash-loop
    # breaker, which exists to catch a loop, not to add up isolated
    # recovered faults over a replica's lifetime
    RESTART_DECAY_S = 300.0

    def __init__(self, generator: Generator,
                 serving: Optional[ServingConfig] = None, *,
                 device: DeviceLike = None, start: bool = True,
                 drafter=None, weight_version=None):
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
        self._host_tier: Optional[HostKVTier] = None
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
        self._prefix_on = self.serving.enable_prefix_cache
        self._chunk = self.serving.prefill_chunk
        self._preempt_on = self.serving.preemption
        self._spec_k = self.serving.speculative_k
        self.drafter = drafter if drafter is not None else NGramDrafter()
        self._index = self._new_index()
        if self.serving.host_kv_bytes > 0:
            # the tier survives restarts (host RAM is not device state);
            # _new_pool wires each pool's eviction hook to it
            self._host_tier = HostKVTier(self.serving.host_kv_bytes,
                                         self._index.granularity)
            self.pool.on_evict_entry = self._demote_entry
        self._prefilling: List[_PendingPrefill] = []
        self.scheduler = AdmissionScheduler(
            self.serving.max_queue, max_total_len=self.max_len,
            num_slots=S, shed_on_overload=self.serving.shed_on_overload,
            default_deadline_s=self.serving.request_deadline_s)
        self.scheduler.notify = self._wake
        self.scheduler.active_fn = (
            lambda: int(self._active.sum()) + len(self._prefilling))
        self.metrics = ServingMetrics()
        self.metrics.kv_attn_path = self._attn_path
        # the LoRA bank (None with adapter_slots=0: no extra op anywhere)
        # and each slot's bank row, uploaded on churn like the lengths
        self.adapters: Optional[AdapterBank] = None
        if self.serving.adapter_slots > 0:
            self.adapters = AdapterBank(
                cfg, self.serving.adapter_slots, self.serving.adapter_rank,
                host_bytes=self.serving.adapter_host_bytes,
                metrics=self.metrics, device=self.device)
        self._adapter_idx = np.zeros(S, np.int64)
        self._d_adapter_idx = self._upload(self._adapter_idx)
        self._adapters_dirty = False
        # live weights: the served version, the generation that namespaces
        # the prefix cache (bumped by every applied swap) and the pending
        # swap the loop applies once the grid is quiet
        self.weight_version = weight_version
        self._weight_gen = 0
        self._pending_swap: Optional[_SwapTicket] = None
        # the last applied swap's seconds: admissions held (the ticket's
        # wait for the grid to drain), then placement, flip and hygiene
        self.last_swap: dict = {}
        if weight_version is not None:
            self.metrics.set_weight_version(weight_version.iteration)
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
        # speculative residual carry: the token a stochastic rejection bans
        # from the slot's next draw (-1: none); the host mirror is exact
        # at window boundaries
        self._reject = np.full(S, -1, np.int64)
        # device copies, re-uploaded only on slot churn; between churns the
        # lengths advance on the device through the chained decode steps
        self._d_lengths = self._upload(self._lengths)
        self._d_reject = self._upload(self._reject)
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
        pool = SlotKVPool(self.cfg, self.num_slots, self.max_len,
                          dtype=dtype, block_size=self.serving.kv_block_size,
                          retained_limit=self.serving.retained_slots,
                          device=self.device)
        # retained KV about to be overwritten leaves the index
        pool.on_reclaim = lambda key: self._index.remove(key)
        if self._host_tier is not None:
            pool.on_evict_entry = self._demote_entry
        return pool

    def _new_index(self) -> PrefixIndex:
        # block pools index whole blocks, so a hit aliases them
        return PrefixIndex(self.pool.block_size if self.pool.blocks_enabled
                           else self.serving.prefill_bucket)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # a copy: on the CPU torch.from_numpy would share the host array
        return torch.tensor(arr, device=self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               sampling: SamplingOptions = SamplingOptions(),
               seed: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None,
               arrival_id: Optional[int] = None,
               adapter_id=None) -> GenRequest:
        """Non-blocking: enqueue and return the request handle. Raises
        QueueFullError (-> 429) on a full queue or a draining engine,
        OverloadShedError (-> 429) when early shedding fires,
        EngineUnhealthyError (-> 503) when the circuit breaker is open, and
        AdmissionError (-> 400) when the request can never fit.
        `priority` clamps into [0, priority_levels); `deadline_s`
        overrides the engine-wide request_deadline_s; `arrival_id` (the
        router's failover retries) keeps a request's original position in
        the queue's order. `adapter_id` selects a registered LoRA adapter
        (None: the base model); an unknown one, or any on an engine with
        no bank, is an AdmissionError (-> 400)."""
        if self._broken:
            raise EngineUnhealthyError(
                f"engine unhealthy (circuit breaker open): {self._broken}")
        self.metrics.count("requests_received")
        try:
            if adapter_id is not None:
                if self.adapters is None:
                    raise UnknownAdapterError(
                        f"adapter_id {adapter_id!r} on an engine serving no "
                        "adapters (adapter_slots=0)")
                if not self.adapters.known(adapter_id):
                    raise UnknownAdapterError(
                        f"unknown adapter_id {adapter_id!r}: register it "
                        "before submitting requests against it")
            if self._draining:
                raise QueueFullError(
                    "engine draining (shutdown in progress); retry "
                    "against another replica", retry_after=5,
                    queue_depth=self.scheduler.depth())
            priority = max(0, min(int(priority),
                                  self.serving.priority_levels - 1))
            req = GenRequest(list(prompt), max_new_tokens, sampling, seed,
                             priority=priority, deadline_s=deadline_s,
                             arrival_id=arrival_id, adapter_id=adapter_id)
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
                 seed: int = 0, timeout: Optional[float] = None,
                 adapter_id=None):
        """Blocking: submit and wait. Returns (prompt + generated tokens,
        generated logprobs)."""
        return self.submit(prompt, max_new_tokens, sampling, seed,
                           adapter_id=adapter_id).result(timeout)

    def close(self):
        """Stop the loop; fail queued and in-flight requests."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._fail_pending_swap("engine closing")
        if self._thread.ident is not None:
            self._thread.join(timeout=60)
        if self._watchdog is not None:
            self._watchdog.stop()
        for req in self.scheduler.close():
            req.fail("engine shut down")
        for req in self._slot_req:
            if req is not None and req.state is RequestState.RUNNING:
                req.fail("engine shut down")
        for st in self._prefilling:
            st.req.fail("engine shut down")

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (queued requests fail with a
        retryable 503, new submits get 429), let every slotted request
        decode to completion, then stop the loop. True when it finished
        within `timeout`."""
        self._draining = True
        self._fail_pending_swap("engine draining")
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
            "prefilling": len(self._prefilling),
            "num_slots": self.num_slots,
            "queue_depth": self.scheduler.depth(),
            # the pool is None for the moment a restart rebuilds it
            "free_slots": int(pool.free_rows()) if pool is not None else 0,
            "kv_blocks_retained": (int(pool.retained_count())
                                   if pool is not None else 0),
            "service_time_ewma_ms":
                self.scheduler.service_time_ewma() * 1e3,
            "kv_attn_path": self._attn_path,
            "max_len": int(self.max_len),
            # the router's adapter-locality signal (0 without a bank)
            "active_adapters": (self.adapters.active_count()
                                if self.adapters is not None else 0),
            # the served weights, for a fleet mid-upgrade
            "weight_version": (self.weight_version.label
                               if self.weight_version is not None
                               else "unversioned"),
            "weight_iteration": (self.weight_version.iteration
                                 if self.weight_version is not None
                                 else None),
            "weight_swap_pending": self._pending_swap is not None,
            "detail": broken or "",
        }

    def queue_depth(self) -> int:
        return self.scheduler.depth()

    def prefix_peek(self, tokens: Sequence[int], adapter_id=None) -> int:
        """Longest cached prefix (device index or host tier) this engine
        could serve `tokens` with under `adapter_id`'s current namespace
        and the current weights (0 without the prefix cache): the router's
        affinity hint, read from other threads, so a racy read degrades to
        0; admission resolves the real hit."""
        if not self._prefix_on or not tokens:
            return 0
        ns = None
        if adapter_id is not None:
            if self.adapters is None:
                return 0
            ns = self.adapters.namespace(adapter_id)
            if ns is None:
                return 0
        toks = list(tokens)
        try:
            wns = self._ns(ns)
            src, hit = self._index.lookup(toks, len(toks) - 1,
                                          namespace=wns)
            best = hit if src is not None else 0
            if self._host_tier is not None:
                _, hhit = self._host_tier.lookup(toks, len(toks) - 1,
                                                 namespace=wns)
                best = max(best, hhit)
            return int(best)
        except Exception:  # noqa: BLE001 — cross-thread peek
            return 0

    def register_adapter(self, adapter_id, path: Optional[str] = None,
                         factors=None, rank: Optional[int] = None,
                         alpha: float = 1.0):
        """Make `adapter_id` servable here, from a `.npz` path or raw
        factors (validated now; serving/adapters.py). Raises on an engine
        with no bank."""
        if self.adapters is None:
            raise RuntimeError(
                "this engine serves no adapters (adapter_slots=0); set "
                "ServingConfig.adapter_slots to register adapters")
        self.adapters.register(adapter_id, path=path, factors=factors,
                               rank=rank, alpha=alpha)

    def adapter_peek(self, adapter_id) -> int:
        """The router's adapter-locality signal: 2 on the device here, 1
        registered (a host restore or disk load away), 0 unknown."""
        if self.adapters is None or adapter_id is None:
            return 0
        return self.adapters.peek(adapter_id)

    # ------------------------------------------------------------------
    # live weights (serving/weights.py)
    # ------------------------------------------------------------------
    def swap_weights(self, ckpt_dir: str, timeout: Optional[float] = None,
                     staged=None):
        """Hot-swap the running engine to the checkpoint in `ckpt_dir`
        (engine.py swap_weights, without the topology and placement
        branches).

        1. Stage on the calling thread: the checkpoint verifies against its
           manifest and loads into host memory (`load_staged`) before
           anything touches the card; a corrupt, truncated or
           manifest-less one raises WeightSwapError and counts
           `weight_swap_failures`.
        2. The swap point, on the engine thread: admissions hold (queued
           work waits), the slots and pending prefills in flight finish
           under the current weights, then between two iterations the
           new device tree is built whole and the engine's Generator flips
           to it. The pool survives untouched.
        3. Version hygiene (`_swap_hygiene`).

        Requests admitted before the swap are pure version N, those after
        it pure N+1. Returns the new WeightVersion. Raises WeightSwapError
        on a refusal, on a placement failure, or when the drain outlasts
        `timeout` (default `ServingConfig.swap_timeout_s`). `staged` (a
        StagedWeights) skips the staging: a rolling upgrade stages once for
        every replica."""
        old = (self.weight_version.label if self.weight_version is not None
               else "unversioned")
        if self._broken:
            raise WeightSwapError(
                f"engine unhealthy (circuit breaker open): {self._broken}; "
                "nothing to swap onto")
        if staged is None:
            try:
                staged = load_staged(ckpt_dir, self.gen.params)
            except WeightSwapError:
                self.metrics.count("weight_swap_failures")
                raise
        ticket = _SwapTicket(staged)
        with self._cond:
            if self._stop or self._draining:
                self.metrics.count("weight_swap_failures")
                raise WeightSwapError("engine stopping or draining; a "
                                      "shutting-down replica does not swap")
            if self._pending_swap is not None:
                self.metrics.count("weight_swap_failures")
                raise WeightSwapError("a weight swap is already in "
                                      "progress on this engine")
            self._pending_swap = ticket
            self._cond.notify_all()
        budget = (timeout if timeout is not None
                  else float(self.serving.swap_timeout_s))
        if not ticket.done.wait(budget):
            with self._cond:
                if self._pending_swap is ticket and not ticket.taken:
                    # still at the barrier: cancel, admissions resume
                    self._pending_swap = None
                    self.metrics.count("weight_swap_failures")
                    raise WeightSwapError(
                        f"weight swap timed out after {budget:.1f}s "
                        "waiting for in-flight work to drain; the engine "
                        f"keeps serving {old}")
            # the apply is in flight: wait for its verdict
            if not ticket.done.wait(max(budget, 60.0)):
                raise WeightSwapError(
                    "weight swap verdict still pending (device placement "
                    "in flight); it may yet complete: check "
                    "health()['weight_version'] before retrying")
        if ticket.error is not None:
            self.metrics.count("weight_swap_failures")
            raise WeightSwapError(
                f"weight swap failed during device placement "
                f"({ticket.error!r}); the engine keeps serving {old}"
            ) from ticket.error
        if ticket.version is None:
            self.metrics.count("weight_swap_failures")
            raise WeightSwapError(f"weight swap aborted (the engine went "
                                  f"down mid-swap); last version {old}")
        return ticket.version

    def _apply_swap(self, ticket: _SwapTicket):
        """Engine thread, at the swap point (no active slots, no pending
        prefills): build the new device tree, then flip. A failure before
        the flip leaves the old weights serving."""
        staged = ticket.staged
        t0 = time.perf_counter()
        try:
            params = place_params(staged, self.gen.params, self.cfg,
                                  self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception as e:  # noqa: BLE001 — a typed refusal upstream
            ticket.error = e
            ticket.done.set()
            return
        # the swap point: this engine's own view of the Generator takes the
        # new tree (a Generator shared with other replicas keeps its own)
        gen = copy.copy(self.gen)
        gen.params = params
        self.gen = gen
        self.weight_version = staged.version
        self.metrics.count("weight_swaps")
        self.metrics.set_weight_version(staged.version.iteration)
        ticket.version = staged.version
        try:
            self._swap_hygiene(staged)
        finally:
            # the weights flipped whatever the sweep did; a failed sweep
            # raises into the supervisor, whose restart rebuilds more
            self.last_swap = dict(hold_s=t0 - ticket.created,
                                  apply_s=time.perf_counter() - t0)
            ticket.done.set()
        print_rank_0(f"serving engine: weights hot-swapped to "
                     f"{staged.version.label} between iterations")

    def _swap_hygiene(self, staged):
        """After the flip: nothing computed under the old weights may be
        reused under the new."""
        self._weight_gen += 1
        self._index = self._new_index()
        self.pool.on_reclaim = lambda key: self._index.remove(key)
        dropped = self.pool.drop_retained()
        tier_dropped = (self._host_tier.clear()
                        if self._host_tier is not None else 0)
        # no active slots at the barrier: every row parks at 0
        self._lengths[:] = 0
        self._reject[:] = -1
        self._lengths_dirty = True
        self._kv_dirty = True
        # a queued request with resume state committed tokens under the
        # old weights: continuing it under the new would mix versions in
        # one stream, so it fails retryable (a router resubmits it whole)
        for req in self.scheduler.drop_resumed():
            req.fail("weights hot-swapped while this preempted request was "
                     "queued: its committed tokens came from the previous "
                     f"version and cannot continue under "
                     f"{staged.version.label}; resubmit",
                     kind="unavailable")
        if self.adapters is not None:
            # adapters were trained against the old base
            self.adapters.bump_generations()
        print_rank_0(f"serving engine: version hygiene dropped {dropped} "
                     f"retained prefix(es) and {tier_dropped} host-tier "
                     f"entr(ies) for {staged.version.label}")

    def _fail_pending_swap(self, msg: str):
        """Resolve a pending, never-applied swap when the engine goes down,
        so its caller does not hang."""
        with self._cond:
            ticket, self._pending_swap = self._pending_swap, None
        if ticket is not None and not ticket.done.is_set():
            ticket.done.set()  # version stays None: a typed abort

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
        k = self._spec_k
        toks = sample_batched(self._gens, self._last_logits,
                              temperature=self._d_temps,
                              top_k=self._d_top_ks, top_p=self._d_top_ps,
                              vocab_size=self.cfg.vocab_size,
                              banned=self._d_reject if k else None)
        if k:
            # a speculative engine's step: the residual carry is consumed,
            # and each drawing row spends the k uniforms a verify round
            # draws, so its stream does not depend on whether another slot
            # proposed a draft this step
            self._uniforms(k)
            self._d_reject = torch.full_like(self._d_reject, -1)
        lps = torch.log_softmax(self._last_logits, dim=-1).gather(
            -1, toks[:, None])[:, 0]
        caches = dataclasses.replace(self._grid_caches(), offset=lengths)
        logits, caches = lm.model_forward(
            self.gen.params, toks[:, None], self.cfg, kv_caches=caches,
            position_ids=lengths[:, None].long(), rope=self.gen.rope,
            adapters=self._lora(self._d_adapter_idx))
        if self._blocks_on and not self._kernel_on:
            scatter_view(self.pool.caches, caches)
        self._last_logits = logits[:, 0]
        self._d_lengths = torch.clamp(lengths + 1, max=self.max_len - 1)
        return toks, lps

    def _lora(self, idx):
        """The forward's `adapters` argument: the bank and the rows' bank
        indices (a device tensor, or host rows uploaded here), or None on
        an engine with no bank."""
        if self.adapters is None:
            return None
        if not isinstance(idx, torch.Tensor):
            idx = self._upload(np.asarray(idx, np.int64))
        return self.adapters.stacked, idx

    def _grid_caches(self):
        """The slot grid's cache as the forward takes it: the block-native
        view (path 2), the gathered contiguous view (path 1; the caller
        scatters it back) or the whole-region pool (path 0)."""
        if self._kernel_on:
            return block_native_cache(self.pool.caches)
        if self._blocks_on:
            return resolve_view(self.pool.caches)
        return self.pool.caches

    def _uniforms(self, k: int) -> torch.Tensor:
        """[S, k] accept uniforms: k draws from each drawing row's own
        generator, zeros for greedy and idle rows (which accept by exact
        match)."""
        u = torch.zeros(self.num_slots, k, device=self.device)
        for i, g in enumerate(self._gens):
            if g is not None:
                u[i] = torch.rand(k, generator=g, device=self.device)
        return u

    def _verify_fn(self, drafts: torch.Tensor):
        """One speculative round for the whole grid (engine.py _verify_fn,
        without the structured-output masks): sample each slot's t0 from
        its carried logits (the residual distribution where last round's
        rejection bans a draft), forward [t0, d1..dk] through the pool at
        the per-slot lengths (`verify_tokens`; the block kernel at
        w = k + 1), and accept each slot's drafts left to right: exact
        match with the argmax for greedy rows, u < p(d) under the processed
        distribution for drawing rows; NO_DRAFT fillers never, and no
        draft whose position would pass max_len - 1. A slot commits
        1 + accepted tokens; its length rewinds there (the rejected
        positions' KV is overwritten write-before-read), its carried
        logits become the row after its last committed token, and a real
        stochastic rejection at the stop position becomes its residual
        carry. Returns (window [S, k+1], logprobs [S, k+1] under the raw
        logits, accepted [S]) on the device."""
        S, k = drafts.shape
        lengths = self._d_lengths
        last = self._last_logits
        toks0 = sample_batched(self._gens, last, temperature=self._d_temps,
                               top_k=self._d_top_ks, top_p=self._d_top_ps,
                               vocab_size=self.cfg.vocab_size,
                               banned=self._d_reject)
        u = self._uniforms(k)
        lp0 = torch.log_softmax(last, dim=-1).gather(-1, toks0[:, None])
        window = torch.cat([toks0[:, None], drafts], dim=1)
        logits, caches = verify_tokens(
            self.gen.params, window, self._grid_caches(), self.cfg,
            rope=self.gen.rope, lengths=lengths, max_len=self.max_len,
            adapters=self._lora(self._d_adapter_idx))
        if self._blocks_on and not self._kernel_on:
            scatter_view(self.pool.caches, caches)
        # logits[:, j]: the distribution of the token after window[:, j],
        # which drafts[:, j] claims to be
        ctx = logits[:, :k]
        probs, targets = verify_draft_probs(
            ctx, drafts, temperature=self._d_temps, top_k=self._d_top_ks,
            top_p=self._d_top_ps, vocab_size=self.cfg.vocab_size)
        accept = torch.where(self._d_greedy[:, None], drafts == targets,
                             u < probs) & (drafts >= 0)
        steps = torch.arange(k, device=self.device)
        allow = lengths.long()[:, None] + 1 + steps <= self.max_len - 1
        a = torch.cumprod((accept & allow).long(), dim=1).sum(dim=1)
        draft_lp = torch.log_softmax(ctx, dim=-1).gather(
            -1, drafts.clamp(min=0)[..., None])[..., 0]
        rows = torch.arange(S, device=self.device)
        self._last_logits = logits[rows, a]
        a_idx = torch.clamp(a, max=k - 1)
        d_stop = drafts[rows, a_idx]
        self._d_reject = torch.where(
            (a < k) & allow[rows, a_idx] & (d_stop >= 0), d_stop,
            torch.full_like(d_stop, -1))
        self._d_lengths = torch.clamp(lengths + 1 + a,
                                      max=self.max_len - 1).int()
        return window, torch.cat([lp0, draft_lp], dim=1), a

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

    def _sub_len(self, plen: int) -> int:
        """Positions of a pending prefill's batch-1 cache: room for the
        padded chunks of a `plen`-token sequence (a chunk's tail pads by
        less than one prefill bucket), in whole blocks on a block pool;
        the ring of W on a rolling pool."""
        if self.pool.rolling:
            return self.pool.cap
        n = plen + self.serving.prefill_bucket
        if self._blocks_on:
            B = self.pool.block_size
            n = -(-n // B) * B
        return min(n, self.pool.cap)

    def _restore_rng(self, state: torch.Tensor
                     ) -> Optional[torch.Generator]:
        """A fresh generator on the engine's device carrying a saved
        state (None for a greedy row's empty state)."""
        if state.numel() == 0:
            return None
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        return gen

    def _request_rng(self, req: GenRequest,
                     plen: int) -> Optional[torch.Generator]:
        """The generator a request decodes with: its saved state after a
        preemption, a fresh seeded one for a drawing request, None for a
        greedy one."""
        if req.resume_rng is not None:
            return self._restore_rng(req.resume_rng)
        sp = req.sampling
        if sp.temperature == 0.0 or sp.top_k == 1:
            return None
        return self._initial_rng(req.seed, plen)

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
                       and self._pending_swap is None
                       and self.scheduler.depth() == 0
                       and not self._active.any()
                       and not self._prefilling):
                    self._cond.wait(timeout=self._idle_wait)
                    self._heartbeat()  # idleness is not a hang
                if self._stop:
                    return True
                if (self._draining and not self._active.any()
                        and not self._prefilling):
                    return True
            if self._wedged:
                raise EngineHungError(
                    "engine iteration exceeded the watchdog deadline "
                    f"({self.serving.engine_step_timeout_s}s); in-flight "
                    "requests were failed by the watchdog")
            self._maybe_decay_restarts()
            self._reap_cancelled()
            self._reap_expired()
            if self._pending_swap is not None:
                # the swap barrier: admissions hold (queued work waits)
                # while the slots and prefills in flight finish under the
                # current weights; a quiet grid swaps between iterations
                if not self._active.any() and not self._prefilling:
                    with self._cond:
                        ticket = self._pending_swap
                        if ticket is not None:
                            ticket.taken = True
                            self._pending_swap = None
                    if ticket is not None:
                        self._apply_swap(ticket)
                    self._heartbeat()
                    continue
            else:
                self._preempt_for_priority()
                self._admit()
            # one chunk an iteration, between decode steps, so running
            # slots keep emitting while a long prompt lands
            self._advance_prefill()
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
        for st in list(self._prefilling):
            st.req.fail(msg)
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
        self._fail_pending_swap(self._broken)
        for req in self._slot_req:
            if req is not None:
                req.fail(self._broken)
        for st in self._prefilling:
            st.req.fail(self._broken)
        for req in self.scheduler.close():
            req.fail(self._broken, kind="unavailable")

    def _restart_session(self, msg: str):
        """Reset after a crashed or hung iteration. The slotted requests
        fail (their streams rest on state no longer trusted); requests
        mid-prefill requeue, and queued preemption victims drop their
        parked KV and will replay (their generator state is on the host).
        The device state is built anew: the port updates the pool in
        place, so a step that raised mid-layer left it half written, and
        every reference to the old tensors is dropped first so that a
        full-size pool is never held twice. Host state the restart does
        not touch survives: the scheduler and its service-time
        estimate."""
        for req in self._slot_req:
            if req is not None:
                req.fail(f"engine step failed while this request was "
                         f"slotted: {msg}")
        for st in self._prefilling:
            if not st.req.done():  # the watchdog may have failed it
                st.req.state = RequestState.QUEUED
                self.scheduler.requeue(st.req)
        self._prefilling = []
        self.scheduler.clear_parked()
        S = self.num_slots
        dtype = self.pool.dtype
        self._slot_req = [None] * S
        self._gens = [None] * S
        self.pool = self._last_logits = None
        self._d_lengths = self._d_temps = self._d_reject = None
        self._d_top_ks = self._d_top_ps = self._d_greedy = None
        self.pool = self._new_pool(dtype)
        self._index = self._new_index()
        self._reject[:] = -1
        self._d_reject = self._upload(self._reject)
        self._last_logits = torch.zeros(S, self._vp, dtype=torch.float32,
                                        device=self.device)
        self._lengths[:] = 0
        self._active[:] = False
        self._d_lengths = self._upload(self._lengths)
        # every slotted request failed, so no adapter pin survives; the
        # bank's rows stay loaded
        self._adapter_idx[:] = 0
        self._d_adapter_idx = self._upload(self._adapter_idx)
        if self.adapters is not None:
            self.adapters.reset_pins()
        self._sampling_dirty = True
        self._lengths_dirty = True
        self._kv_dirty = True
        self._bracket_bytes = 0
        self._wedged = False
        if self._watchdog is not None:
            self._watchdog.rearm()

    # ------------------------------------------------------------------
    # priority preemption
    # ------------------------------------------------------------------
    def _preempt_for_priority(self):
        """A queued request of higher priority with no allocatable slot
        evicts the lowest-priority running slot, the youngest on a tie
        (the least sunk work); one victim an iteration, since the next
        `_admit` takes the freed slot."""
        if not self._preempt_on or self.pool.free_count() > 0:
            return
        top = self.scheduler.peek_priority()
        if top is None:
            return
        victim, vprio = None, None
        for slot in np.nonzero(self._active)[0]:
            req = self._slot_req[slot]
            if req is None:
                continue
            if (vprio is None or req.priority < vprio
                    or (req.priority == vprio
                        and req.id > self._slot_req[victim].id)):
                victim, vprio = int(slot), req.priority
        if victim is None or vprio >= top:
            return
        self._preempt(victim)

    def _preempt(self, slot: int):
        """Evict `slot` without losing its stream: copy its KV out of the
        pool (the live blocks, or the region's live prefix) with its
        carried logits row, keep its generator state and residual carry on
        the host, and requeue it; it resumes with one insert. Past
        `num_slots` parked victims the copy is skipped and the request
        replays its prompt plus generated tokens instead."""
        req = self._slot_req[slot]
        plen = int(self._lengths[slot])
        if plen != len(req.effective_prompt()):
            raise RuntimeError(f"slot {slot}: length {plen} but "
                               f"{len(req.effective_prompt())} committed "
                               "tokens")
        gen = self._gens[slot]
        req.resume_rng = gen.get_state() if gen is not None else _NO_RNG
        req.resume_reject = int(self._reject[slot])
        if self.scheduler.parked_count() < self.num_slots:
            if self._blocks_on:
                blocks = self.pool.map_row(slot)[:self.pool.live_blocks(plen)]
                sub = slice_blocks(self.pool.caches, blocks, plen)
            else:
                sub = slice_slot(self.pool.caches, slot, plen, length=plen)
            req.parked = (sub, self._last_logits[slot].clone())
        else:
            req.parked = None  # the replay fallback
        req.preemptions += 1
        self.metrics.count("preemptions")
        self._slot_req[slot] = None
        self._active[slot] = False
        self._gens[slot] = None
        self._reject[slot] = -1
        # the pin frees with the slot; the victim re-acquires its adapter
        # by id at resume, whichever row it lands in
        self._release_adapter(req)
        self._free_adapter_row(slot)
        self._sampling_dirty = True
        self._kv_dirty = True
        self._lengths_dirty = True
        self._index.remove(slot)
        self.pool.release(slot)
        self._lengths[slot] = 0
        req.state = RequestState.QUEUED
        self.scheduler.requeue(req)

    # ------------------------------------------------------------------
    # admission: batched misses, pending prefills, resumes
    # ------------------------------------------------------------------
    def _admit(self):
        popped = self.scheduler.pop_ready(self.pool.free_count())
        if not popped:
            return
        pending = list(popped)
        self._admitting = pending
        try:
            groupable: List[GenRequest] = []
            # once a request blocks on a full bank, later adapter requests
            # this pass requeue untried, so a busy resident adapter cannot
            # starve the blocked head (arrival ids keep the order)
            bank_blocked = False
            for r in popped:
                if bank_blocked and r.adapter_id is not None:
                    self.scheduler.requeue(r)
                    pending.remove(r)
                    continue
                verdict = self._acquire_adapter(r)
                if verdict != "ok":
                    bank_blocked = bank_blocked or verdict == "blocked"
                    pending.remove(r)
                    continue
                if r.parked is not None:
                    # a preemption victim with its KV intact: one insert,
                    # no forward
                    self._resume_parked(r)
                    pending.remove(r)
                    continue
                # a replay prefills prompt + generated
                toks = r.effective_prompt()
                src, hit = self._lookup_prefix(toks, r.adapter_ns)
                if hit or r.resume_rng is not None or (
                        self._chunk is not None and len(toks) > self._chunk):
                    self._start_pending(r, src, hit)
                    pending.remove(r)
                else:
                    groupable.append(r)
            for padded, reqs in AdmissionScheduler.group_by_bucket(
                    groupable, lambda r: self._prefill_bucket(len(r.prompt)),
                    self._prefill_max_batch):
                self._prefill_group(reqs, padded)
                for r in reqs:
                    pending.remove(r)
        except Exception as e:
            for r in pending:
                self._release_adapter(r)
                r.fail(repr(e))
            raise
        finally:
            self._admitting = []

    def _acquire_adapter(self, req: GenRequest) -> str:
        """Pin req.adapter_id's bank row (req.bank_idx) and record its
        namespace (req.adapter_ns). Returns "ok", "blocked" (the bank is
        full: requeued until a pin frees) or "failed" (the request failed
        typed: unknown since submit, unloadable, or re-registered or
        swapped while it was queued or preempted, since a stream never
        continues under other weights than it started with)."""
        req.bank_idx = 0
        if self.adapters is None or req.adapter_id is None:
            return "ok"
        try:
            idx = self.adapters.acquire(req.adapter_id)
        except AdapterBankFullError:
            self.scheduler.requeue(req)
            return "blocked"
        except UnknownAdapterError as e:
            req.fail(str(e))
            return "failed"
        except Exception as e:  # noqa: BLE001 — an unloadable source
            req.fail(f"adapter {req.adapter_id!r} failed to load: {e!r}")
            return "failed"
        ns = self.adapters.namespace(req.adapter_id)
        if req.adapter_ns is not None and ns != req.adapter_ns:
            self.adapters.release(idx)
            req.fail(f"adapter {req.adapter_id!r} was re-registered while "
                     "this request was queued or preempted; its stream "
                     "cannot continue under different weights: resubmit")
            return "failed"
        req.adapter_ns = ns
        req.bank_idx = idx
        return "ok"

    def _release_adapter(self, req: Optional[GenRequest]):
        """Drop a request's admission-time pin (idempotent)."""
        if req is None or self.adapters is None:
            return
        if req.bank_idx:
            self.adapters.release(int(req.bank_idx))
            req.bank_idx = 0

    def _free_adapter_row(self, slot: int):
        if self._adapter_idx[slot]:
            self._adapter_idx[slot] = 0  # idle rows decode the base model
            self._adapters_dirty = True

    def _ns(self, adapter_ns):
        """The prefix index's and host tier's namespace: (weight
        generation, adapter namespace), so KV computed under other weights
        or another adapter is invisible to a lookup."""
        return (self._weight_gen, adapter_ns)

    def _record_admission(self, req: GenRequest):
        # a request admitted before (then requeued) records its queue wait
        # once
        first = req.admit_time is None
        req.mark_admitted()  # no-op on a concurrently failed request
        if first and req.admit_time is not None:
            self.metrics.record_admitted(req.admit_time - req.submit_time)

    def _lookup_prefix(self, toks: List[int], namespace=None):
        """The longest reusable cached prefix of `toks` computed under
        `namespace` (the request's adapter namespace; None: the base
        model) and the current weights, and its source: a
        running slot (an int) or a retained prefix's key. The match is
        capped at len - 1 so one suffix token forwards for the logits.
        Rolling pools (block mode) add the ring-validity gate: a retained
        ring holds only its sequence's last W positions, so a copy is sound
        when the prompt continues the retained sequence in full (the hit is
        then its exact length) or the ring never wrapped; running rolling
        slots are never indexed."""
        if not self._prefix_on:
            return None, 0
        namespace = self._ns(namespace)
        src, hit = self._index.lookup(toks, len(toks) - 1,
                                      namespace=namespace)
        if src is None or not hit:
            src, hit = None, 0
        elif self.pool.rolling:
            ent = (None if isinstance(src, (int, np.integer))
                   else self.pool.entry(src))
            if ent is None:
                src, hit = None, 0
            elif ent.length <= len(toks) - 1 \
                    and toks[:ent.length] == ent.tokens:
                # a full continuation at the exact length
                src, hit = src, ent.length
            elif ent.length > self.pool.cap:
                src, hit = None, 0  # wrapped: the prefix left the ring
        # the host tier: only a strictly longer demoted match beats the
        # device hit (a restore costs an upload; the on-card copy wins a
        # tie)
        if self._host_tier is not None:
            hkey, hhit = self._host_tier.lookup(toks, len(toks) - 1,
                                                namespace=namespace)
            if hkey is not None and hhit > hit:
                return _HostSrc(hkey), hhit
        return src, hit

    def _demote_entry(self, ent):
        """SlotKVPool.on_evict_entry: a retained prefix is dying under block
        pressure or the retained limit; copy its blocks to the host tier so
        that a later hit restores instead of recomputing. Rolling rings
        never demote (a ring restore is sound only as an exact-length
        continuation). The pool prints and drops a failure (best-effort);
        the size gate runs before the device copy, so an entry the budget
        can never hold costs nothing."""
        if self._host_tier is None or self.pool.rolling:
            return
        est = (len(ent.blocks) * self.pool.block_size
               * self.pool.bytes_per_token())
        if est > self._host_tier.budget_bytes:
            return
        arrays = self.pool.gather_blocks_host(ent.blocks)
        if self._host_tier.demote(ent.key, ent.tokens, ent.length, arrays,
                                  namespace=ent.namespace):
            self.metrics.count("host_tier_demotions")

    def _restore_host(self, key, plen: int):
        """Checksum-verified host-tier restore: the batch-1 cache holding
        the demoted prefix's blocks at offset `plen`, or None on a checksum
        miss, when the entry is dropped and the caller prefills the whole
        prompt."""
        if not self._host_tier.has(key):
            return None  # evicted from the tier since the lookup
        ent = self._host_tier.restore(key)
        if ent is None:
            self.metrics.count("host_tier_checksum_misses")
            return None
        nb = -(-plen // self.pool.block_size)
        return self.pool.host_blocks_to_sub(
            {k: v[:, :nb] for k, v in ent.arrays.items()}, plen)

    def _src_blocks(self, src) -> List[int]:
        """Physical blocks behind a prefix source: a running slot's map
        row, or a retained prefix's pinned blocks."""
        if isinstance(src, (int, np.integer)):
            return self.pool.map_row(int(src))
        return list(self.pool.entry(src).blocks)

    def _resume_parked(self, req: GenRequest):
        """Resume a preemption victim whose KV survived in its parked copy:
        a slot, one insert of the copy, its logits row and its generator,
        and it decodes on where it stopped."""
        sub, last = req.parked
        req.parked = None
        tokens = req.effective_prompt()
        blocks = None
        if self._blocks_on:
            got = self.pool.alloc_row(install=False)
            if got is None:
                raise RuntimeError("popped more requests than free slots")
            slot, blocks = got
        else:
            slot = self.pool.alloc()
            if slot is None:
                raise RuntimeError("popped more requests than free slots")
        st = None
        try:
            st = _PendingPrefill(req, slot, sub, len(tokens),
                                 self._restore_rng(req.resume_rng), tokens,
                                 blocks=blocks)
            st.last = last
            self._record_admission(req)
            self._activate_pending(st)
        except Exception:
            if blocks is not None and not (st is not None and st.installed):
                self.pool.drop_blocks(blocks)
            self.pool.release(slot)
            raise

    def _start_pending(self, req: GenRequest, src, prefix_len: int):
        """Reserve a slot and begin a suffix or chunked prefill. On a hit
        the prefix is copied out of `src` (on a block pool through the new
        row's own block list, whose first blocks alias the source's;
        refs taken at alloc, the row installed at activation); otherwise
        the batch-1 cache starts empty at offset 0. A preemption replay
        prefills prompt + generated and continues its saved generator. A
        host-tier source is restored first (checksum-verified, into fresh
        blocks): a corrupt entry makes the admission a plain miss."""
        tokens = req.effective_prompt()
        plen = len(tokens)
        host_sub = None
        if prefix_len and isinstance(src, _HostSrc):
            host_sub = self._restore_host(src.key, prefix_len)
            if host_sub is None:
                src, prefix_len = None, 0
        if prefix_len:
            # counted at the match, so hit_tokens - tokens_saved measures
            # hits forfeited to pool pressure
            self.metrics.count("prefix_hit_tokens", prefix_len)
        blocks = None
        pfx_blocks = 0
        roll_src = None
        device_hit = prefix_len and host_sub is None
        if self._blocks_on:
            alias = []
            if device_hit and self.pool.rolling:
                # captured before alloc_row, which may evict the entry;
                # its blocks keep their content until something writes
                # them, and the copy below comes first. A ring is copied
                # whole, never aliased: the new row's writes wrap into its
                # early blocks
                roll_src = list(self.pool.entry(src).blocks)
            elif device_hit:
                pfx_blocks = prefix_len // self.pool.block_size
                alias = self._src_blocks(src)[:pfx_blocks]
            got = self.pool.alloc_row(alias=alias, install=False)
            if got is None and prefix_len:
                # block pressure: forfeit the hit, admit plain
                src, prefix_len, pfx_blocks = None, 0, 0
                host_sub = None
                got = self.pool.alloc_row(install=False)
            if got is None:
                raise RuntimeError("popped more requests than free slots")
            slot, blocks = got
        else:
            slot = self.pool.alloc(exclude=(src,) if prefix_len else ())
            if slot is None:
                # the only allocatable slot is the source itself: forfeit
                src, prefix_len = None, 0
                slot = self.pool.alloc()
            if slot is None:
                raise RuntimeError("popped more requests than free slots")
        try:
            n = self._sub_len(plen)
            if prefix_len and host_sub is not None:
                # restored from the host tier: the sub holds the prefix at
                # offset prefix_len and the row's own blocks take it all
                # at the insert (no aliasing, pfx_blocks 0)
                req.prefix_len = prefix_len
                self.metrics.count("host_tier_hits")
                self.metrics.count("prefill_tokens_saved", prefix_len)
                sub = host_sub
            elif prefix_len:
                if isinstance(src, (int, np.integer)):
                    self.pool.touch(int(src))
                else:
                    self.pool.touch_key(src)
                req.prefix_len = prefix_len
                self.metrics.count("prefix_hits")
                self.metrics.count("prefill_tokens_saved", prefix_len)
                if not self._blocks_on:
                    sub = slice_slot(self.pool.caches, int(src), prefix_len,
                                     length=n)
                elif roll_src is not None:
                    sub = slice_blocks(self.pool.caches, roll_src,
                                       prefix_len)
                else:
                    sub = slice_blocks(self.pool.caches,
                                       blocks[:n // self.pool.block_size],
                                       prefix_len)
            else:
                sub = self.pool.make_prefill_caches(1, n)
            st = _PendingPrefill(req, slot, sub, prefix_len,
                                 self._request_rng(req, plen), tokens,
                                 blocks=blocks, pfx_blocks=pfx_blocks)
            self._record_admission(req)
            self._prefilling.append(st)
        except Exception:
            if blocks is not None:
                self.pool.drop_blocks(blocks)  # the row was never installed
            self.pool.release(slot)
            raise

    def _advance_prefill(self):
        """One chunk of the oldest pending prefill; its last chunk lands it
        in its slot. A chunk's tail pads up to the prefill bucket (at most
        the chunk size, and never past the region); a rolling pool's
        suffix after a hit forwards one token a step, since a multi-token
        ring write at offset > 0 would evict history its own queries
        need."""
        if not self._prefilling:
            return
        st = self._prefilling[0]
        plen = len(st.tokens)
        n = plen - st.pos
        if self._chunk is not None:
            n = min(n, self._chunk)
        if self.pool.rolling and st.pos > 0:
            n = 1
        b = self.serving.prefill_bucket
        if self.pool.rolling or (self._chunk is not None
                                 and n == self._chunk):
            padded = n
        else:
            padded = -(-n // b) * b
            if self._chunk is not None:
                padded = min(padded, max(self._chunk, n))
            padded = min(padded, self.max_len - st.pos)
        toks = np.full((1, padded), self.gen.pad_id, np.int64)
        toks[0, :n] = st.tokens[st.pos:st.pos + n]
        st.sub, st.last = prefill_chunk(
            self.gen.params, self._upload(toks), st.sub, self.cfg,
            rope=self.gen.rope, last_idx=n - 1, next_offset=st.pos + n,
            adapters=self._lora([st.aidx]))
        st.pos += n
        st.req.prefill_chunks += 1
        self.metrics.count("prefill_chunks")
        self.metrics.count("prefill_forward_tokens", n)
        if st.pos >= plen:
            self._prefilling.pop(0)
            self._activate_pending(st)

    def _activate_pending(self, st: _PendingPrefill):
        """Land a finished pending prefill: install its map row (only now,
        so the decode steps between its chunks wrote nothing into its
        blocks), insert its KV past the aliased prefix, and activate the
        slot with its logits row, generator and residual carry."""
        slot, req = st.slot, st.req
        plen = len(st.tokens)
        if self._blocks_on:
            self.pool.install_row(slot, st.blocks)
            st.installed = True
            insert_blocks(self.pool.caches, st.sub, slot, plen,
                          st.pfx_blocks)
        else:
            insert_prefill(self.pool.caches, st.sub, slot, plen)
        self._last_logits[slot] = st.last
        sp = req.sampling
        self._gens[slot] = st.rng
        self._lengths[slot] = plen
        self._active[slot] = True
        self._temps[slot] = sp.temperature
        self._top_ks[slot] = sp.top_k
        self._top_ps[slot] = sp.top_p
        self._reject[slot] = req.resume_reject  # -1 unless resumed
        self._slot_req[slot] = req
        self._adapter_idx[slot] = st.aidx
        self._adapters_dirty = True
        self._sampling_dirty = True
        self._kv_dirty = True
        self._lengths_dirty = True
        if self._prefix_on and not self.pool.rolling:
            # cloneable for the sequence it now holds; a running ring
            # keeps wrapping over its prefix, so rolling slots are indexed
            # only when retained
            self._index.insert(slot, st.tokens,
                               namespace=self._ns(req.adapter_ns))

    def _drop_pending(self, st: _PendingPrefill, msg: str,
                      kind: str = "error"):
        self._prefilling.remove(st)
        if st.blocks is not None:
            # still pending: the row was never installed, so only the
            # pending prefill holds its blocks
            self.pool.drop_blocks(st.blocks)
        self._kv_dirty = True
        self.pool.release(st.slot)
        self._release_adapter(st.req)
        st.req.fail(msg, kind=kind)

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
        rows = [r.bank_idx for r in reqs]
        rows += [rows[0]] * (B - B_real)  # pad rows replicate row 0
        logits, caches = lm.model_forward(
            self.gen.params, self._upload(toks), self.cfg,
            kv_caches=caches, rope=self.gen.rope,
            head_positions=self._upload(last),
            adapters=self._lora(rows))
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
            self._reject[slot] = -1
            self._slot_req[slot] = req
            self._adapter_idx[slot] = req.bank_idx
            self._adapters_dirty = True
            self._record_admission(req)
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
        if self._prefix_on and not self.pool.rolling:
            for slot, req in zip(slots, reqs):
                self._index.insert(slot, req.prompt,
                                   namespace=self._ns(req.adapter_ns))

    def _reap_cancelled(self):
        for slot in np.nonzero(self._active)[0]:
            req = self._slot_req[slot]
            if req is not None and req.cancelled:
                self._evict(slot, failed="cancelled")
        for st in list(self._prefilling):
            if st.req.cancelled:
                self._drop_pending(st, "cancelled")

    def _reap_expired(self):
        """Evict running slots and drop pending and queued requests whose
        deadline (request `deadline_s`, else request_deadline_s) ran
        out."""
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
        for st in list(self._prefilling):
            ad = st.req.absolute_deadline(self._deadline_s)
            if ad is not None and now > ad:
                self._drop_pending(
                    st, f"deadline exceeded after "
                    f"{now - st.req.submit_time:.1f}s "
                    f"(deadline {ad - st.req.submit_time:.1f}s, "
                    f"{st.pos} prompt tokens prefilled)", kind="deadline")
        self.scheduler.drop_expired(self._deadline_s, now)

    def _evict(self, slot: int, failed: Optional[str] = None,
               kind: str = "error"):
        """Free a finished or failed slot. With the prefix cache a finished
        request's KV is retained and indexed by its full sequence: on a
        block pool as a row-less entry pinning the blocks it covers (the
        row parks at 0 with an all-TRASH map); on a whole-region pool the
        slot itself, which parks its decode position at its final length
        so the grid's idle writes land past every cloneable prefix."""
        slot = int(slot)
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._active[slot] = False
        self._gens[slot] = None
        self._reject[slot] = -1
        self._kv_dirty = True
        self._lengths_dirty = True
        self._sampling_dirty = True
        self._release_adapter(req)
        self._free_adapter_row(slot)
        tokens = req.prompt + req.generated
        ns = self._ns(req.adapter_ns)
        if failed is None and self._prefix_on and self._blocks_on:
            self._index.remove(slot)
            key = self.pool.retain_row(slot, int(self._lengths[slot]),
                                       tokens, namespace=ns)
            if key is not None:
                self._index.insert(key, tokens, namespace=ns)
            self._lengths[slot] = 0
        elif failed is None and self._prefix_on:
            # indexed before retain: a retain that reclaims this very slot
            # (retained_slots=0) removes the entry again through on_reclaim
            self._index.insert(slot, tokens, namespace=ns)
            self.pool.retain(slot)
        else:
            self._lengths[slot] = 0  # idle rows park at position 0
            self.pool.release(slot)
            self._index.remove(slot)
        if failed is not None:
            req.fail(failed, kind=kind)
            return
        if req.finish():
            self.scheduler.observe_service(
                req.finish_time - (req.admit_time or req.submit_time))

    def _step(self):
        """K chained steps, ONE host read, then bookkeeping. A request that
        hits EOS or its token budget at inner step r discards the window's
        remaining K-1-r steps (`wasted_decode_steps`) and is evicted at the
        boundary; per-request streams are the same for any K, since no
        slot's logits, generator or KV cross slots or windows.

        With `speculative_k` each step is a verify round: the window's
        draft grids are proposed up front from the committed history
        (`build_draft_rounds`), a round commits 1 + accepted tokens a live
        slot, and the accept counts and residual carry chain on the device
        between reads. A round in which no slot proposes a draft runs the
        plain decode step (`spec_fallback_steps`), which consumes the
        carry too."""
        K = self._sync_interval
        inj = get_fault_injector()
        if inj is not None:
            # serving fault points: stall the loop (watchdog bait), crash
            # the iteration (supervisor bait), or NaN-poison one active
            # slot's carried logits for the non-finite guard to catch
            call = inj.next_serve_step()
            inj.maybe_serve_delay(call)
            inj.check_serve_crash(call)
            # flip bytes in a demoted host-tier entry: its CRC gate must
            # turn the next restore into a miss, never wrong tokens
            if inj.serve_host_corrupt(call) and self._host_tier is not None:
                inj.corrupt_host_tier_entry(self._host_tier)
            # flip bytes in a demoted host adapter copy: its CRC gate must
            # turn the next restore into a reload from the source
            if inj.serve_adapter_corrupt(call) and self.adapters is not None:
                inj.corrupt_adapter_host_entry(self.adapters)
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
            self._d_greedy = self._upload(~draws)
            self._sampling_dirty = False
            self.metrics.count("sampling_uploads")
        if self._lengths_dirty or not self._active.all():
            # churn re-syncs positions (and the residual carry, exact on
            # the host at boundaries) from the host; a partly idle grid
            # also re-parks its idle rows each window
            self._d_lengths = self._upload(self._lengths)
            self._d_reject = self._upload(self._reject)
            self._lengths_dirty = False
        if self._adapters_dirty:
            self._d_adapter_idx = self._upload(self._adapter_idx)
            self._adapters_dirty = False
        k = self._spec_k
        spec_round = [False] * K
        grids = None
        if k:
            histories: List[Optional[List[int]]] = [None] * self.num_slots
            win = getattr(self.drafter, "scan_window", None)
            for slot in np.nonzero(self._active)[0]:
                req = self._slot_req[slot]
                hist = req.prompt + req.generated
                histories[slot] = hist if win is None else hist[-win:]
            grids, spec_round, _ = build_draft_rounds(histories,
                                                      self.drafter, k, K)
        W = k + 1
        steps = []
        for r in range(K):
            if spec_round[r]:
                window, lps, acc = self._verify_fn(
                    self._upload(grids[r].astype(np.int64)))
                self.metrics.count("spec_rounds")
            else:
                toks, tok_lp = self._decode_fn()
                window = torch.zeros(self.num_slots, W, dtype=torch.int64,
                                     device=self.device)
                window[:, 0] = toks
                lps = torch.zeros(self.num_slots, W, device=self.device)
                lps[:, 0] = tok_lp
                acc = torch.zeros(self.num_slots, dtype=torch.int64,
                                  device=self.device)
                if k:
                    self.metrics.count("spec_fallback_steps")
            steps.append(torch.cat([window.double(), lps.double(),
                                    acc.double()[:, None]], dim=1))
        # the window's one host read: tokens, logprobs and accept counts of
        # every step, and the residual carry
        packed = torch.cat([torch.stack(steps).reshape(-1),
                            self._d_reject.double()]).cpu().numpy()
        self.metrics.count("host_syncs")
        if self._wedged:
            # the watchdog flagged this iteration in flight and already
            # failed its requests: its results rest on untrusted state
            raise EngineHungError("engine iteration exceeded the watchdog "
                                  "deadline mid-dispatch")
        S = self.num_slots
        grid = packed[:K * S * (2 * W + 1)].reshape(K, S, 2 * W + 1)
        toks = grid[..., :W].astype(np.int64)
        tok_lp = grid[..., W:2 * W]
        accs = grid[..., 2 * W].astype(np.int64)
        self._reject = packed[K * S * (2 * W + 1):].astype(np.int64)
        active_slots = np.nonzero(self._active)[0]
        n_active = len(active_slots)
        consumed = np.zeros(K, np.int64)
        commit_t = time.monotonic()
        for slot in active_slots:
            req = self._slot_req[slot]
            had = len(req.generated)
            done = False
            for r in range(K):
                if done:
                    break
                n = 1 + int(accs[r, slot])
                if spec_round[r]:
                    drafted = int((grids[r][slot] >= 0).sum())
                    if drafted:
                        self.metrics.count("draft_tokens", drafted)
                for j in range(n):
                    lp = float(tok_lp[r, slot, j])
                    if not math.isfinite(lp):
                        # a poisoned request fails; the engine continues
                        self.metrics.count("nonfinite_logit_fails")
                        if K - 1 - r:
                            self.metrics.count("wasted_decode_steps",
                                               K - 1 - r)
                        self._evict(slot, failed=(
                            f"non-finite logits at position "
                            f"{int(self._lengths[slot])} (after "
                            f"{len(req.generated)} tokens)"))
                        done = True
                        break
                    tok = int(toks[r, slot, j])
                    first = not req.generated
                    req.append_token(tok, lp)
                    if first:
                        self.metrics.record_first_token(req.ttft)
                    if j:
                        self.metrics.count("accepted_tokens")
                    self._lengths[slot] += 1
                    consumed[r] += 1
                    if (tok == self.gen.eos_id
                            or len(req.generated) >= req.max_new_tokens):
                        if K - 1 - r:
                            self.metrics.count("wasted_decode_steps",
                                               K - 1 - r)
                        self._evict(slot)
                        done = True
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
        for r in range(K):
            self.metrics.record_step(n_active, self.num_slots,
                                     int(consumed[r]), depth)
        if self._kv_dirty:
            self.metrics.set_kv_gauges(*self.pool.kv_gauges(self._lengths))
            if self.adapters is not None:
                self.metrics.set_adapter_gauge(self.adapters.active_count())
            self._kv_dirty = False
