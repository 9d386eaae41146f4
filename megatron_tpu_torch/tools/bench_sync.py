"""Host-sync cadence in training and serving (the port of the root
tools/bench_sync.py).

The loop's metrics window (training/loop.py) and the engine's
`decode_sync_interval` take host round trips off the device's critical
path. This tool counts them, before and after:

- training arm: the same short run twice, `sync_metrics` (a fetch every
  step) against the async window, counting host syncs through the loop's
  `_device_fetch` and timing ms a step (fp32 master weights and Adam, at
  --train_layers when given: their state takes 16 bytes a parameter);
- serving arm: the engine at decode_sync_interval 1 and K on the same
  seeded burst: host syncs a decode step (1/K) and a token, tokens/s.

One JSON record on stdout (and into --out).

  python -m megatron_tpu_torch.tools.bench_sync [--iters N]
      [--log_interval N] [--requests N] [--new N] [--sync_k K] [--model
      small|llama2-7b] [--layers N] [--dtype float32|bfloat16] [--block N]
      [--smoke] [--device cpu] [--out FILE]

On a CPU (`--device cpu`) the times are a smoke of the harness; the counts
carry over.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from megatron_tpu_torch.config import (DataConfig, MegatronConfig,
                                       OptimizerConfig, ServingConfig,
                                       TrainingConfig)
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.tools import bench_common
from megatron_tpu_torch.training import loop as loop_mod
from megatron_tpu_torch.utils.device import resolve_device

SMOKE = dict(iters=9, log_interval=3, requests=3, slots=2, new=6, sync_k=3,
             hidden=64, vocab=128, seq=64)


def bench_training(args, device) -> dict:
    model = dataclasses.replace(
        bench_common.model_config(args), params_dtype="float32")

    def cfg_for(sync: bool) -> MegatronConfig:
        return MegatronConfig(
            model=model,
            optimizer=OptimizerConfig(lr=1e-4),
            training=TrainingConfig(
                micro_batch_size=args.micro_batch,
                global_batch_size=args.micro_batch * 2,
                train_iters=args.iters, log_interval=args.log_interval,
                sync_metrics=sync),
            data=DataConfig(num_workers=0),
        ).validate()

    rs = np.random.RandomState(0)
    seq = model.seq_length

    def batches():
        while True:
            yield {"tokens": rs.randint(
                0, args.vocab,
                (2, args.micro_batch, seq + 1)).astype(np.int32),
                "loss_mask": np.ones((2, args.micro_batch, seq),
                                     np.float32)}

    def run(sync: bool) -> dict:
        calls = [0]
        real = loop_mod._device_fetch

        def counting(values):
            calls[0] += 1
            return real(values)

        loop_mod._device_fetch = counting
        try:
            t0 = time.perf_counter()
            loop_mod.train(cfg_for(sync), batches(), seed=0, device=device)
            wall = time.perf_counter() - t0
        finally:
            loop_mod._device_fetch = real
        return {"host_syncs": calls[0],
                "host_syncs_per_step": round(calls[0] / args.iters, 4),
                "ms_per_step": round(wall * 1e3 / args.iters, 3)}

    sync = run(True)  # also takes the kernels' first builds
    async_ = run(False)
    return {"sync": sync, "async": async_,
            "sync_reduction_x": round(
                sync["host_syncs"] / max(async_["host_syncs"], 1), 1)}


def bench_serving(args, device) -> dict:
    gen = bench_common.build_generator(args, device, eos_id=0)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, gen.cfg.vocab_size, 24).tolist()
               for _ in range(args.requests)]
    sampled = SamplingOptions(temperature=1.0)

    def run(k: int) -> dict:
        serving = ServingConfig(num_slots=args.slots,
                                max_queue=max(args.requests, 64),
                                decode_sync_interval=k, max_len=args.seq,
                                kv_block_size=args.block,
                                block_native_attn=args.block is not None)
        with ServingEngine(gen, serving, device=device) as eng:
            # warm-up: the prefill shapes and the decode step
            eng.generate(prompts[0], 2, sampled, seed=0, timeout=600)
            t0 = time.monotonic()
            reqs = [eng.submit(p, args.new, sampled, seed=i)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                r.result(timeout=1800)
            wall = time.monotonic() - t0
            snap = eng.metrics.snapshot()
        toks = snap["tokens_generated"]
        return {"decode_sync_interval": k,
                "tokens": int(toks),
                "decode_steps": int(snap["decode_steps"]),
                "host_syncs": int(snap["host_syncs"]),
                "syncs_per_step": round(snap["host_syncs"]
                                        / max(snap["decode_steps"], 1),
                                        4),  # 1/K by construction
                "syncs_per_token": round(snap["host_syncs"]
                                         / max(toks, 1), 4),
                "wasted_decode_steps": int(
                    snap.get("wasted_decode_steps", 0)),
                "prompts_per_prefill": round(
                    snap.get("prompts_per_prefill", 1.0), 2),
                "tokens_per_s": round(toks / max(wall, 1e-9), 1)}

    base = run(1)
    k = run(args.sync_k)
    # the cadence changes when the host looks, not what is generated
    assert k["tokens"] == base["tokens"], (
        f"decode_sync_interval {args.sync_k} generated {k['tokens']} "
        f"tokens, 1 generated {base['tokens']}")
    return {"k1": base, "k": k,
            "sync_reduction_x": round(
                base["syncs_per_token"] / max(k["syncs_per_token"], 1e-9),
                1)}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_sync",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--smoke", action="store_true",
                   help="a tiny fixed scenario")
    p.add_argument("--iters", type=int, default=24)
    p.add_argument("--log_interval", type=int, default=8)
    p.add_argument("--micro_batch", type=int, default=2)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--new", type=int, default=24)
    p.add_argument("--sync_k", type=int, default=4,
                   help="decode_sync_interval of the K arm")
    p.add_argument("--block", type=int, default=None,
                   help="serving: kv_block_size with the block kernel "
                        "(default: whole-region slots)")
    bench_common.add_model_args(p, seq=128)
    return bench_common.parse_args(p, argv, SMOKE)


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    device = resolve_device(device if device is not None else args.device)
    bench_common.emit({
        "bench": "sync_cadence",
        "device": bench_common.device_kind(device),
        "training": bench_training(args, device),
        "serving": bench_serving(args, device),
    }, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
