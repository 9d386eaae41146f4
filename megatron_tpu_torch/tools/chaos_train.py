"""Scripted chaos run: train a tiny model while faults fire, and measure the
recovery (the port of the root tools/chaos_train.py).

The resilience tests prove each path alone; this composes them into one
run the way a bad day on preemptible machines would: transient checkpoint
write failures, a NaN streak mid-run (the divergence guard rolls back to
the newest valid checkpoint, replays the data stream exactly and
quarantines the poisoned window), then, after the run, a corrupted
checkpoint on disk (the load falls back to the previous valid one) and a
dataset corrupted every way the injector knows (each caught at open with a
typed error). It reports whether training completed, the rollback's
recovery latency (detect, restore, resume) and what each drill saw, as
ONE JSON record with the root tool's keys.

- `--smoke`: the tiny model, 8 iterations, the fixed fault script
  "write_error@2,nan@3,nan@4"; seconds on the CPU.
- otherwise `--train_iters`, `--hidden_size` and `--faults SPEC` (the
  MEGATRON_TPU_FAULTS syntax, e.g. "write_error@2,nan@5,nan@6,delay@8:2.0").

  python -m megatron_tpu_torch.tools.chaos_train --smoke [--device cpu]
      [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch


class _SyntheticDataset:
    """Map-style stand-in for GPTDataset: index -> deterministic tokens, so
    the run has a real BatchIterator (random sampler and the exact-resume
    state) for the rollback's replay and quarantine."""

    def __init__(self, n: int, seq_length: int, vocab: int):
        self._n, self._seq, self._vocab = n, seq_length, vocab

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        rng = np.random.RandomState((int(i) * 9973 + 7) % (2 ** 31))
        return {"text": rng.randint(0, self._vocab,
                                    size=self._seq + 1).astype(np.int64)}


def run_chaos(train_iters: int, hidden_size: int, fault_spec: str,
              workdir: str, device=None) -> dict:
    from megatron_tpu_torch.config import (DataConfig, MegatronConfig,
                                           ModelConfig, OptimizerConfig,
                                           ResilienceConfig, TrainingConfig)
    from megatron_tpu_torch.data.samplers import BatchIterator
    from megatron_tpu_torch.resilience import integrity
    from megatron_tpu_torch.resilience.faults import (FaultInjector,
                                                      use_fault_injector)
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training.loop import train
    from megatron_tpu_torch.training.train_step import init_train_state
    from megatron_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    model = ModelConfig(num_layers=2, hidden_size=hidden_size,
                        num_attention_heads=2, vocab_size=64,
                        seq_length=16).derived()
    cfg = MegatronConfig(
        model=model,
        optimizer=OptimizerConfig(lr=1e-3),
        training=TrainingConfig(micro_batch_size=1, global_batch_size=2,
                                train_iters=train_iters, log_interval=100,
                                save_interval=2, checkpoint_dir=workdir),
        data=DataConfig(num_workers=0),
        resilience=ResilienceConfig(max_consecutive_nonfinite=2,
                                    keep_last_k=3, io_backoff_s=0.05,
                                    io_backoff_max_s=0.2),
    ).validate()

    # small enough to wrap epochs mid-run, so a longer schedule's
    # quarantine replay also crosses an epoch boundary
    dataset = _SyntheticDataset(max(train_iters + 4, 12),
                                model.seq_length, model.vocab_size)

    def make_iterator(consumed, data_state=None):
        it = BatchIterator(dataset, cfg.training.micro_batch_size, 1,
                           cfg.num_microbatches,
                           consumed_samples=consumed,
                           dataloader_type="cyclic",
                           seed=cfg.training.seed)
        if data_state:
            it.load_state_dict(data_state)
        return it

    root = workdir
    timeline = {"saves": 0, "rollback_at": None, "resumed_at": None}

    def save_fn(st, iteration, consumed, data_state=None,
                quarantine=None):
        ckpt.save_checkpoint(root, st, cfg, iteration, consumed,
                             data_state=data_state, quarantine=quarantine)
        timeline["saves"] += 1

    example = init_train_state(cfg, seed=99, device=device)

    def load_fn():
        timeline["rollback_at"] = time.monotonic()
        out = ckpt.load_checkpoint(root, example,
                                   resilience=cfg.resilience)
        timeline["resumed_at"] = time.monotonic()
        return out

    def reset_data_fn(consumed, rollbacks, data_state=None):
        # exact replay: the same seed and the checkpointed iterator
        # state; the loop quarantines the poisoned window
        return make_iterator(consumed, data_state)

    injector = FaultInjector.from_env(fault_spec)
    assert injector is not None, f"empty fault spec {fault_spec!r}"

    t0 = time.monotonic()
    with use_fault_injector(injector):
        state, consumed = train(
            cfg, make_iterator(0), save_fn=save_fn, load_fn=load_fn,
            reset_data_fn=reset_data_fn, device=device)
    wall_s = time.monotonic() - t0
    # read now: after a rollback the loop's state is `example`, which the
    # fallback drill below loads into again
    final_iteration = int(state.iteration)

    # the quarantine audit: the final checkpoint's metadata carries the
    # poisoned windows the rollback skipped
    tag = ckpt.read_tracker(root)
    with open(os.path.join(root, f"iter_{int(tag):07d}",
                           "metadata.json")) as f:
        final_meta = json.load(f)
    quarantine = final_meta.get("quarantine", [])
    data_state_saved = final_meta.get("data_state") is not None

    # corruption drill 1: bit-rot the tracker-named checkpoint; the load
    # falls back to the previous valid one
    FaultInjector.corrupt_checkpoint(
        os.path.join(root, f"iter_{int(tag):07d}"))
    t1 = time.monotonic()
    recovered, rec_it, _ = ckpt.load_checkpoint(
        root, example, resilience=cfg.resilience)
    fallback_s = time.monotonic() - t1

    # corruption drill 2: a dataset corrupted every way the injector
    # knows is caught at open with a typed error, even beside a cached
    # clean handle of the same prefix
    data_faults_detected = FaultInjector.dataset_corruption_drill(workdir)

    recovery_s = (timeline["resumed_at"] - timeline["rollback_at"]
                  if timeline["rollback_at"] is not None else None)
    fired = {}
    for kind, _ in injector.fired:
        fired[kind] = fired.get(kind, 0) + 1
    valid = [it for it, d in integrity.list_iter_checkpoints(root)
             if integrity.verify_checkpoint(d)[0]]
    expect_quarantine = timeline["rollback_at"] is not None
    ok = (final_iteration == train_iters and recovered is not None
          and rec_it < int(tag) and data_state_saved
          and all(data_faults_detected.values())
          and (bool(quarantine) or not expect_quarantine))
    return {
        "metric": "chaos_recovery_latency_s",
        "value": round(recovery_s, 3) if recovery_s is not None else None,
        "unit": (f"s detect->restore->resume ({train_iters} iters, "
                 f"faults {fault_spec})"),
        "vs_baseline": None,
        "completed": ok,
        "final_iteration": final_iteration,
        "consumed_samples": int(consumed),
        "faults_fired": fired,
        "saves": timeline["saves"],
        "quarantine_windows": quarantine,
        "exact_resume_state_saved": data_state_saved,
        "corrupt_fallback_iteration": int(rec_it),
        "corrupt_fallback_s": round(fallback_s, 3),
        "data_faults_detected": data_faults_detected,
        "valid_checkpoints": valid,
        "wall_s": round(wall_s, 1),
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny fixed scenario")
    ap.add_argument("--train_iters", type=int, default=12)
    ap.add_argument("--hidden_size", type=int, default=64)
    ap.add_argument("--faults", type=str,
                    default="write_error@2,nan@5,nan@6",
                    help="MEGATRON_TPU_FAULTS-syntax fault schedule")
    ap.add_argument("--workdir", type=str, default=None,
                    help="checkpoint dir (default: a fresh temporary one)")
    ap.add_argument("--device", default=None,
                    help="cpu runs without a card (the default is the card)")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)
    if args.smoke:
        args.train_iters, args.hidden_size = 8, 32
        args.faults = "write_error@2,nan@3,nan@4"
    device = device if device is not None else args.device

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_train_")
    try:
        record = run_chaos(args.train_iters, args.hidden_size, args.faults,
                           workdir, device)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if record["completed"] else 1


if __name__ == "__main__":
    sys.exit(main())
