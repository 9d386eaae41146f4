"""The training loop: `train`, `evaluate` and `training_log`
(megatron_tpu/training/loop.py), with the reference's semantics.

- Log, eval, save and exit intervals, `exit_duration_in_mins`, and
  checkpoint-and-exit on SIGTERM (the handler is installed for the run and
  the previous one restored after it).
- Windowed metrics: the step's scalars stay on the device and each log
  window is fetched in ONE device-to-host copy (`_MetricsWindow.flush`,
  the loop's only sync besides evaluation and saves). Skip and NaN
  accounting and the divergence guard replay the window's per-step values
  at the flush: the same decisions as a per-step fetch, at most
  log_interval - 1 steps late. `sync_metrics` (or `profile`) fetches
  every step.
- Divergence rollback: on the guard's order the newest valid checkpoint is
  restored (`load_fn`), the data stream is rebuilt at its exact saved
  position (`reset_data_fn`) and the window (checkpoint iteration, trigger
  iteration] is pulled and skipped with no update, recorded in the
  quarantine log that rides in every later checkpoint.
- Each step's random draws come from a CPU `torch.Generator` seeded from
  (seed, iteration) (`step_seed`), as the reference folds the iteration
  into its key, so a resumed run with dropout draws the same masks; a
  rollback re-seeds the replayed steps as the reference does.
- Input batches are numpy arrays until the main thread copies them to the
  device, on the stream the step runs on, so each copy is ordered before
  the step that reads it. Batch N+1 is pulled and copied right after step
  N is queued, while the device runs it; the exact-resume snapshot of the
  iterator is taken before that pull.
- `profile` records a torch.profiler trace of the steps
  [profile_step_start, profile_step_end] (a Chrome trace in
  `profile_dir`, else `tensorboard_dir`, else the temp directory).

- `step_timeout_s` arms a `StepWatchdog` after the first step's flush
  (that step builds the kernels): a stall past the deadline dumps the
  stacks, attempts a final checkpoint through `save_fn` and exits with
  `watchdog_exit_code`. Metrics are fetched once a log window, and a
  healthy flush may wait a whole window of device time, so the deadline is
  `step_timeout_s` x `log_interval` unless `sync_metrics` fetches every
  step (the reference's run-ahead rule). Evaluation and saves suspend it.
- On a state sharded over a mesh (training/train_step.py) every rank runs
  the loop in step: each is handed the same global batches, the metrics
  are the global ones on every rank (under pp the loss reaches every
  stage, and the evaluation runs the pipelined forward), and the exit decisions that read a
  rank's own clock or signals (SIGTERM, `exit_duration_in_mins`) are
  summed over the world first, on the host (`collectives.any_rank`), so
  the ranks stop at the same iteration.
  Rank 0 alone writes the metrics and the profiler trace. The hung-step
  watchdog's checkpoint needs every rank and is refused under a mesh.
- An active FaultInjector (resilience/faults.py) stalls (`maybe_delay`)
  or poisons (`corrupt_batch`) the host batch of each step call before it
  is copied to the device; the look-ahead copy is off while one is active,
  so each batch meets the injector in step order.
"""
from __future__ import annotations

import contextlib
import os
import signal
import tempfile
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import MegatronConfig
from megatron_tpu_torch.data.samplers import PrefetchIterator
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import DATA_AXIS
from megatron_tpu_torch.resilience import (DivergenceGuard, GuardAction,
                                           StepWatchdog,
                                           TrainingDivergedError,
                                           get_fault_injector)
from megatron_tpu_torch.training.microbatches import MicrobatchCalculator
from megatron_tpu_torch.parallel.multihost import make_global_batch
from megatron_tpu_torch.training.train_step import (TrainState,
                                                    init_train_state,
                                                    make_train_step,
                                                    shard_lm_batch, sum_loss)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import (make_writer, print_rank_0,
                                              report_memory)
from megatron_tpu_torch.utils.timers import Timers

# keys of a batch that are token indices (the rest keep their dtype)
_INDEX_KEYS = ("tokens",)
_ROLLBACK_SALT = 0x5EED


def step_seed(seed: int, iteration: int) -> int:
    """The seed of iteration `iteration`'s generator: a splitmix64 mix of
    the run's seed and the iteration, in [0, 2^63)."""
    z = (seed * 0x9E3779B97F4A7C15 + iteration + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def _device_fetch(values: list) -> list:
    """ONE device-to-host copy of a list of device scalars -> floats."""
    if not values:
        return []
    return torch.stack([v.detach().double().reshape(())
                        for v in values]).cpu().tolist()


class _MetricsWindow:
    """The steps' metrics between two host syncs: tensors stay on the
    device, plain numbers (lr, wd) pass through."""

    def __init__(self):
        self._its = []
        self._metrics = []

    def __len__(self):
        return len(self._its)

    def push(self, iteration: int, metrics: dict):
        self._its.append(iteration)
        self._metrics.append(metrics)

    def flush(self):
        """-> [(iteration, {name: float})] in step order, one device fetch
        for the whole window; empties it."""
        if not self._its:
            return []
        slots = [(i, k) for i, m in enumerate(self._metrics)
                 for k, v in m.items() if isinstance(v, torch.Tensor)]
        fetched = _device_fetch([self._metrics[i][k] for i, k in slots])
        out = [{k: float(v) for k, v in m.items()
                if not isinstance(v, torch.Tensor)} for m in self._metrics]
        for (i, k), v in zip(slots, fetched):
            out[i][k] = v
        flushed = list(zip(self._its, out))
        self._its, self._metrics = [], []
        return flushed


def _iter_state(it) -> Optional[dict]:
    get_state = getattr(it, "state_dict", None)
    return get_state() if get_state is not None else None


def _to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device`, token ids as int64. A CUDA copy
    goes through pinned memory on the current stream, ordered before the
    step that reads it."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if k in _INDEX_KEYS:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class SignalState:
    """SIGTERM -> checkpoint and exit at the next iteration boundary. Works
    on the main thread only (`signal.signal`); elsewhere it stays inert."""

    def __init__(self):
        self.received = False
        self._previous = None
        self._installed = False

    def install(self):
        def handler(signum, frame):
            self.received = True
        try:
            self._previous = signal.signal(signal.SIGTERM, handler)
            self._installed = True
        except ValueError:
            pass  # not the main thread
        return self

    def restore(self):
        if self._installed:
            signal.signal(signal.SIGTERM, self._previous)
            self._installed = False


def training_log(metrics: dict, iteration: int, consumed_samples: int,
                 elapsed_per_iter: float, tokens_per_sec: float,
                 writer, skipped_total: int, nan_total: int,
                 quarantined_total: int = 0) -> str:
    """Format and emit the per-interval dashboard line."""
    loss = float(metrics["lm_loss"])
    lr = float(metrics["lr"])
    gnorm = float(metrics["grad_norm"])
    lscale = float(metrics.get("loss_scale", 1.0))
    line = (f"iteration {iteration} | consumed samples {consumed_samples} | "
            f"elapsed time per iteration (ms): {elapsed_per_iter*1000:.1f} | "
            f"tokens/s: {tokens_per_sec:.1f} | learning rate: {lr:.3E} | "
            f"lm loss: {loss:.6E} | loss scale: {lscale:.1f} | "
            f"grad norm: {gnorm:.3f} | skipped iterations: {skipped_total} | "
            f"nan iterations: {nan_total}")
    if quarantined_total:
        line += f" | quarantined iterations: {quarantined_total}"
        writer.add_scalar("resilience/quarantined iterations",
                          quarantined_total, iteration)
    writer.add_scalar("lm-loss-training/lm loss", loss, iteration)
    writer.add_scalar("learning-rate/learning rate", lr, iteration)
    writer.add_scalar("grad-norm/grad norm", gnorm, iteration)
    writer.add_scalar("loss-scale/loss scale", lscale, iteration)
    writer.add_scalar("throughput/tokens per sec", tokens_per_sec, iteration)
    if "params_norm" in metrics:
        pn = float(metrics["params_norm"])
        line += f" | params norm: {pn:.3f}"
        writer.add_scalar("params-norm/params norm", pn, iteration)
    if "num_zeros" in metrics:
        writer.add_scalar("num-zeros/num zeros",
                          float(metrics["num_zeros"]), iteration)
    return line


def _make_eval_step(cfg: MegatronConfig, device: DeviceLike = None,
                    loss_fn=None, mesh=None, pipelined_spec=None,
                    pipelined_loss_fn=None):
    """The evaluation loss of a batch, as the reference's eval step: the
    mean over microbatches of the masked-mean lm loss, deterministic, with
    no position or segment ids; or of `loss_fn(params, mb, None)` (the
    BERT and T5 entry points' loss). Returns a device scalar. On a `mesh`
    each rank takes its dp rows of the global batch (and the LM loss its
    cp chunk), divides by the whole microbatch's mask count, or returns
    its share of a custom loss, and the sum goes over dp and cp, as in the
    step. On a pipeline mesh the loss is the pipelined forward's: the LM's
    `pipeline_loss_fn`, a custom loss's `pipelined_spec` or
    `pipelined_loss_fn` (make_train_step's), every rank getting it."""
    from megatron_tpu_torch.parallel import pipeline as pl
    device = resolve_device(device)
    rope = lm.make_rope(cfg.model, device=device)
    pipelined = mesh is not None and mesh.shape["pp"] > 1

    def pipelined_custom(params, batch: dict) -> torch.Tensor:
        if pipelined_loss_fn is not None:
            return pipelined_loss_fn(params, batch, None, None)[0]
        if pipelined_spec is None:
            raise ValueError("evaluation under pp > 1 with a custom loss "
                             "needs pipelined_spec or pipelined_loss_fn")
        intake, chunk, head = pipelined_spec(cfg.model, True, mesh)
        tokens = batch["tokens"]
        return pl.pipeline_eval_loss(
            params, batch, cfg.model, mesh, intake_fn=intake,
            chunk_fn=chunk, head_loss_fn=head, act_shape=pl.boundary_shape(
                mesh, tokens.shape[1], tokens.shape[2],
                cfg.model.hidden_size),
            vpp=cfg.parallel.virtual_pipeline_chunks)

    @torch.no_grad()
    def eval_step(params, batch: dict) -> torch.Tensor:
        if pipelined:
            if loss_fn is not None or pipelined_spec is not None \
                    or pipelined_loss_fn is not None:
                total = pipelined_custom(params,
                                         make_global_batch(batch, mesh))
            else:
                batch, counts = shard_lm_batch(batch, mesh)
                total = pl.pipeline_loss_fn(
                    params, batch["tokens"], cfg.model, mesh,
                    vpp=cfg.parallel.virtual_pipeline_chunks,
                    loss_mask=batch.get("loss_mask"), rope=rope,
                    counts=counts)
            return sum_loss(total, mesh)
        if loss_fn is not None:
            if mesh is not None:
                batch = make_global_batch(batch, mesh)
            n_micro = next(iter(batch.values())).shape[0]
            total = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n_micro):
                total += loss_fn(params, {k: v[i] for k, v in batch.items()},
                                 None)
            if mesh is not None:
                total = sum_loss(total, mesh)
            return total / n_micro
        counts = None
        if mesh is not None:
            batch, counts = shard_lm_batch(batch, mesh)
        tokens = batch["tokens"]
        n_micro = tokens.shape[0]
        mask = batch.get("loss_mask")
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(n_micro):
            total += lm.loss_fn(params, tokens[i], cfg.model,
                                loss_mask=None if mask is None else mask[i],
                                rope=rope, deterministic=True,
                                denominator=None if counts is None
                                else counts[i])
        if mesh is not None:
            total = sum_loss(total, mesh)
        return total / n_micro

    return eval_step


def evaluate(state: TrainState, eval_iterator, eval_step_fn,
             eval_iters: int, device: DeviceLike = None) -> Optional[dict]:
    """Mean lm loss and its perplexity over `eval_iters` batches, fetched in
    one copy after the loop and summed in host order. An iterator that runs
    dry stops early and averages what it gave; None when it gave
    nothing."""
    device = resolve_device(device)
    losses = []
    for _ in range(eval_iters):
        try:
            batch = next(eval_iterator)
        except StopIteration:
            print_rank_0(f"evaluate: valid iterator exhausted after "
                         f"{len(losses)}/{eval_iters} batches; "
                         + ("averaging over the batches seen" if losses
                            else "skipping this eval interval"))
            break
        losses.append(eval_step_fn(state.params, _to_device(batch, device)))
    if not losses:
        return None
    total = 0.0
    for v in _device_fetch(losses):
        total += v
    mean = total / len(losses)
    return {"lm loss": mean, "lm loss ppl": float(np.exp(min(mean, 20.0)))}


class _Profile:
    """torch.profiler over a step window; the trace lands as Chrome JSON."""

    def __init__(self, cfg: MegatronConfig, device: torch.device,
                 rank: int = 0):
        self.rank = rank
        tr = cfg.training
        self.out_dir = (tr.profile_dir or tr.tensorboard_dir or os.path.join(
            tempfile.gettempdir(), "megatron_tpu_torch_trace"))
        self.start_at, self.end_at = tr.profile_step_start, tr.profile_step_end
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._activities = activities
        self._prof = None

    def maybe_start(self, iteration: int):
        if self._prof is None and iteration == self.start_at:
            self._prof = torch.profiler.profile(activities=self._activities)
            self._prof.__enter__()

    def maybe_stop(self, iteration: int, force: bool = False):
        if self._prof is None or (iteration < self.end_at and not force):
            return
        self._prof.__exit__(None, None, None)
        if self.rank != 0:
            self._prof = None
            return
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"trace_{self.start_at}_{self.end_at}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print_rank_0(f"profiler trace written to {path} "
                     f"({self.start_at}..{self.end_at})")


def train(cfg: MegatronConfig, train_iterator: Iterator[dict],
          valid_iterator: Optional[Iterator[dict]] = None, *,
          state: Optional[TrainState] = None, seed: Optional[int] = None,
          start_iteration: int = 0, consumed_samples: int = 0,
          save_fn: Optional[Callable] = None,
          load_fn: Optional[Callable] = None,
          reset_data_fn: Optional[Callable] = None,
          quarantine_log: Optional[list] = None,
          step_kwargs: Optional[dict] = None,
          device: DeviceLike = None):
    """The `_train` loop on `device` (the current CUDA device when None;
    raises without one). `train_iterator` yields numpy batches
    {"tokens": [n_micro, mbs, seq+1], "loss_mask": [n_micro, mbs, seq],
    and "position_ids" / "segment_ids" with the EOD resets}. The state is
    updated in place. Returns (state, consumed_samples).

    Hooks: `save_fn(state, iteration, consumed_samples, data_state=,
    quarantine=)` persists a checkpoint with the iterator's exact-resume
    state; `load_fn() -> LoadedCheckpoint` restores the newest valid one
    when the divergence guard orders a rollback (without it a breach raises
    TrainingDivergedError); `reset_data_fn(consumed_samples, rollbacks,
    data_state=) -> iterator` rebuilds the stream at the checkpoint's
    position. `step_kwargs` goes to make_train_step (`loss_fn`: the BERT
    and T5 entry points' loss), and its `loss_fn` also makes the
    evaluation loss."""
    device = resolve_device(device)
    res = cfg.resilience.validate()
    tr = cfg.training
    sync_metrics = tr.sync_metrics or tr.profile
    timers = Timers(barrier_free=not sync_metrics)
    wandb_kwargs = {}
    if tr.wandb_logger:
        wandb_kwargs = {k: v for k, v in dict(
            project=tr.wandb_project or "megatron_tpu",
            entity=tr.wandb_entity, run_id=tr.wandb_id,
            resume=tr.wandb_resume).items() if v}
    writer = make_writer(tr.tensorboard_dir, use_wandb=tr.wandb_logger,
                         **wandb_kwargs)
    seed = tr.seed if seed is None else seed
    step_kwargs = dict(step_kwargs or {})
    if state is None:
        state = init_train_state(cfg, seed=seed, device=device)
    mesh = getattr(state.params, "mesh", None)
    if mesh is not None and res.step_timeout_s:
        raise NotImplementedError(
            "the hung-step watchdog under a mesh (its checkpoint needs "
            "every rank) is not ported (ROADMAP Queue 1 item 7 (f))")
    step_fn = make_train_step(cfg, mesh=mesh, device=device, **step_kwargs)
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]
    calc = MicrobatchCalculator(
        tr.global_batch_size or tr.micro_batch_size * dp,
        tr.micro_batch_size, dp, tr.rampup_batch_size)

    iteration = start_iteration
    skipped_total = nan_total = quarantined_total = 0
    quarantine_log = list(quarantine_log or [])
    data_state_now: Optional[dict] = None
    eval_step_fn = None
    t_start = interval_t0 = time.perf_counter()
    interval_iters = 0
    seq_len = cfg.model.seq_length
    guard = DivergenceGuard(
        max_consecutive_nonfinite=res.max_consecutive_nonfinite,
        loss_spike_factor=res.loss_spike_factor,
        loss_spike_window=res.loss_spike_window,
        max_rollbacks=res.max_rollbacks)
    base_seed = seed
    profile = (_Profile(cfg, device, 0 if mesh is None else mesh.rank)
               if tr.profile else None)
    injector = get_fault_injector()
    watchdog = None
    if res.step_timeout_s:
        def _watchdog_checkpoint():
            # best-effort final checkpoint from the monitor thread; the
            # closure reads the loop's current state and iteration
            if save_fn is not None:
                save_fn(state, iteration, consumed_samples,
                        data_state=data_state_now, quarantine=quarantine_log)
        wd_timeout = res.step_timeout_s
        if not sync_metrics:
            # the host sees device progress only at window flushes, and a
            # healthy flush may wait for a whole window of steps
            wd_timeout = res.step_timeout_s * max(tr.log_interval, 1)
            print_rank_0(
                f"watchdog: windowed metrics scale the step deadline to one "
                f"log window: {wd_timeout:.1f}s (step_timeout_s="
                f"{res.step_timeout_s:.1f} x log_interval={tr.log_interval});"
                f" use --sync_metrics for per-step hang detection")
        watchdog = StepWatchdog(wd_timeout, on_timeout=_watchdog_checkpoint,
                                exit_code=res.watchdog_exit_code)

    # batch N+1 is pulled and copied while step N runs (not under rampup:
    # the look-ahead would use a stale microbatch count; not under an
    # active injector, which acts on host batches in step-call order)
    prefetch_ahead = tr.rampup_batch_size is None and injector is None
    pending_batch = None
    pending_stop: Optional[StopIteration] = None

    def wrap_prefetch(it):
        # host-side batch assembly in a producer thread (the reference's
        # DataLoader workers); not under rampup, whose batches change size
        if (cfg.data.num_workers > 0 and tr.rampup_batch_size is None
                and not isinstance(it, PrefetchIterator)):
            return PrefetchIterator(it)
        return it

    train_iterator = wrap_prefetch(train_iterator)
    window = _MetricsWindow()
    last_metrics: dict = {}
    memory_reported = False
    signals = SignalState().install()
    t_step = timers("train-step", log_level=0)

    def local_exit_msgs() -> list:
        """The exits that read this rank's signals and clock; on a mesh a
        rank exits when any rank would."""
        msgs = []
        if signals.received:
            msgs.append("SIGTERM received: checkpointing and exiting")
        if tr.exit_duration_in_mins is not None:
            mins = (time.perf_counter() - t_start) / 60.0
            if mins > tr.exit_duration_in_mins:
                msgs.append(f"exiting after {mins:.1f} min (exit_duration)")
        if (mesh is not None and collectives.any_rank(bool(msgs), mesh)
                and not msgs):
            msgs.append("exiting with the other ranks (SIGTERM or "
                        "exit_duration on another rank)")
        return msgs

    try:
        while iteration < tr.train_iters:
            if watchdog is not None:
                watchdog.heartbeat()
            calc.update(consumed_samples)
            if hasattr(train_iterator, "num_microbatches"):
                train_iterator.num_microbatches = calc.num_microbatches
            stop_exc: Optional[StopIteration] = None
            if pending_batch is not None:
                batch, pending_batch = pending_batch, None
            elif pending_stop is not None:
                stop_exc, pending_stop = pending_stop, None
            else:
                try:
                    batch = next(train_iterator)
                except StopIteration as stop:
                    # the steps already queued must still reach the guard
                    # and the counters: flush first, raise below
                    stop_exc = stop
                else:
                    if injector is not None:
                        step_call = injector.next_step_call()
                        injector.maybe_delay(step_call)
                        batch = injector.corrupt_batch(batch, step_call)
                    batch = _to_device(batch, device)
            if stop_exc is None and save_fn is not None:
                # the iterator at THIS step's batch, before the look-ahead
                # pull: a checkpoint at iteration N resumes with batch N+1
                data_state_now = _iter_state(train_iterator)
            if stop_exc is None:
                gen = torch.Generator().manual_seed(
                    step_seed(base_seed, iteration))
                if profile is not None:
                    profile.maybe_start(iteration)
                t_step.ensure_started()
                state, metrics = step_fn(state, batch, gen)
                if sync_metrics:
                    t_step.stop(sync_on=metrics["lm_loss"])
                    if watchdog is not None and watchdog.started:
                        watchdog.heartbeat()
                if profile is not None:
                    profile.maybe_stop(iteration)
                iteration += 1
                interval_iters += 1
                consumed_samples += calc.global_batch_size
                window.push(iteration, metrics)
                if (prefetch_ahead and iteration < tr.train_iters):
                    try:
                        pending_batch = _to_device(next(train_iterator),
                                                   device)
                    except StopIteration as stop:
                        pending_stop = stop

            log_due = iteration % tr.log_interval == 0
            eval_due = bool(valid_iterator is not None and tr.eval_interval
                            and iteration % tr.eval_interval == 0)
            save_due = bool(save_fn is not None and tr.save_interval
                            and iteration % tr.save_interval == 0)
            # exit conditions, decided once per iteration
            exit_msgs = local_exit_msgs()
            if tr.exit_interval and iteration % tr.exit_interval == 0:
                exit_msgs.append(f"exiting at iteration {iteration} "
                                 "(exit_interval)")
            exit_due = bool(exit_msgs)
            flush_due = (sync_metrics or log_due or eval_due or save_due
                         or exit_due or stop_exc is not None
                         or iteration >= tr.train_iters
                         or iteration == start_iteration + 1)

            rollback_at = None
            if flush_due and len(window):
                flushed = window.flush()  # the window's one host sync
                t_step.stop_if_started()
                for it, m in flushed:
                    last_metrics = m
                    found_inf = bool(m["found_inf"])
                    if found_inf:
                        skipped_total += 1
                    if not np.isfinite(m["lm_loss"]):
                        nan_total += 1
                    if guard.enabled:
                        action = guard.observe(m["lm_loss"], found_inf)
                        if action is GuardAction.ROLLBACK:
                            # later steps of the window are discarded: the
                            # restore erases them, as a per-step fetch
                            # would never have run them
                            rollback_at = it
                            break
                if watchdog is not None:
                    watchdog.heartbeat()
                    if not watchdog.started:
                        # armed only now: the first step (kernel builds)
                        # is unrelated to the steady-state deadline
                        watchdog.start()
                if not memory_reported:
                    memory_reported = True
                    report_memory("after first step", device)

            if rollback_at is not None:
                if guard.note_rollback():
                    raise TrainingDivergedError(
                        f"divergence persisted through "
                        f"{guard.rollbacks - 1} rollback(s) at "
                        f"iteration {rollback_at}; aborting cleanly")
                if load_fn is None:
                    raise TrainingDivergedError(
                        f"divergence at iteration {rollback_at} "
                        f"({guard.max_consecutive_nonfinite} consecutive "
                        "non-finite steps or loss spike) with no "
                        "checkpoint to roll back to — configure --save to "
                        "enable rollback")
                print_rank_0(f"divergence guard: rolling back at iteration "
                             f"{rollback_at} (rollback {guard.rollbacks}/"
                             f"{res.max_rollbacks})")
                loaded = load_fn()
                if loaded is None or loaded[0] is None:
                    raise TrainingDivergedError(
                        "rollback requested but no restorable checkpoint "
                        "was found")
                state = loaded[0]
                iteration, consumed_samples = int(loaded[1]), int(loaded[2])
                # the replayed steps draw from a re-seeded generator; the
                # DATA order is never re-seeded
                base_seed = step_seed(seed, _ROLLBACK_SALT + guard.rollbacks)
                if reset_data_fn is not None:
                    if isinstance(train_iterator, PrefetchIterator):
                        train_iterator.close()
                    train_iterator = reset_data_fn(
                        consumed_samples, guard.rollbacks,
                        data_state=getattr(loaded, "data_state", None))
                    pending_batch, pending_stop = None, None
                    # the replayed order would serve the batches that
                    # diverged again: pull and skip the window
                    # (checkpoint iteration, trigger iteration]
                    q_from, q_count = iteration + 1, 0
                    q_consumed0 = consumed_samples
                    while iteration < rollback_at:
                        calc.update(consumed_samples)
                        if hasattr(train_iterator, "num_microbatches"):
                            train_iterator.num_microbatches = \
                                calc.num_microbatches
                        try:
                            next(train_iterator)
                        except StopIteration:
                            break
                        iteration += 1
                        consumed_samples += calc.global_batch_size
                        q_count += 1
                        if watchdog is not None:
                            watchdog.heartbeat()
                    if q_count:
                        quarantined_total += q_count
                        q_samples = consumed_samples - q_consumed0
                        quarantine_log.append({
                            "from_iteration": q_from,
                            "to_iteration": iteration,
                            "samples": q_samples,
                            "rollback": guard.rollbacks,
                        })
                        # the skipped window counts as completed, empty
                        # iterations (lr schedule, logs)
                        state.iteration = iteration
                        print_rank_0(
                            f"divergence guard: quarantined iterations "
                            f"[{q_from}, {iteration}] ({q_count} steps, "
                            f"{q_samples} samples) — exact data order "
                            "replayed, poison window skipped")
                    data_state_now = _iter_state(train_iterator)
                    train_iterator = wrap_prefetch(train_iterator)
                interval_t0 = time.perf_counter()
                interval_iters = 0
                continue

            if stop_exc is not None:
                raise stop_exc

            if log_due:
                dt = (time.perf_counter() - interval_t0) / max(
                    interval_iters, 1)
                toks = calc.global_batch_size * seq_len / dt
                print_rank_0(training_log(last_metrics, iteration,
                                          consumed_samples, dt, toks,
                                          writer, skipped_total, nan_total,
                                          quarantined_total))
                if tr.log_timers_to_tensorboard:
                    timers.write(["train-step"], writer, iteration,
                                 reset=False)
                print_rank_0(timers.log())
                interval_t0 = time.perf_counter()
                interval_iters = 0

            if eval_due:
                if eval_step_fn is None:
                    eval_step_fn = _make_eval_step(
                        cfg, device, loss_fn=step_kwargs.get("loss_fn"),
                        mesh=mesh,
                        pipelined_spec=step_kwargs.get("pipelined_spec"),
                        pipelined_loss_fn=step_kwargs.get(
                            "pipelined_loss_fn"))
                with (watchdog.suspend() if watchdog is not None
                      else contextlib.nullcontext()):
                    results = evaluate(state, valid_iterator, eval_step_fn,
                                       tr.eval_iters, device)
                if results is not None:
                    print_rank_0(f"validation at iteration {iteration}: "
                                 f"{results}")
                    for k, v in results.items():
                        writer.add_scalar(f"lm-loss-validation/{k}", v,
                                          iteration)

            # a SIGTERM or the duration clock crossing during an eval or a
            # save sweep exits now, once no unobserved step would be lost
            exiting = exit_due
            if not exiting and len(window) == 0:
                exit_msgs = local_exit_msgs()
                exiting = bool(exit_msgs)
            for msg in exit_msgs:
                print_rank_0(msg)
            if save_due or (exiting and save_fn is not None):
                # a slow save is not a hung step
                with (watchdog.suspend() if watchdog is not None
                      else contextlib.nullcontext()):
                    save_fn(state, iteration, consumed_samples,
                            data_state=data_state_now,
                            quarantine=quarantine_log)
            if exiting:
                break
    finally:
        if watchdog is not None:
            watchdog.stop()
        signals.restore()
        if profile is not None:
            profile.maybe_stop(iteration, force=True)
        if isinstance(train_iterator, PrefetchIterator):
            train_iterator.close()
    writer.flush()
    return state, consumed_samples
