"""Activation-recompute A/B at the headline training shape, on one card
(the port of the root tools/bench_remat.py).

The root bench.py's headline 0.74B configuration (12 layers of h 2048, 16
heads, ffn 5504, vocab 32000, seq 2048, micro-batch 2 x 4 microbatches,
bf16 compute, flash attention, fp32 Adam) trains with full recompute.
Each arm here is that step at one policy: "none", "selective" (the weight
GEMMs' outputs kept, the rest recomputed), "full" (only each layer's input
kept), and "full+int8" (full recompute with the forward GEMMs on the int8
path, `quantized_gemm="int8"`, whose backward runs in the compute dtype).
Full recompute runs each layer's forward twice a step, so it launches the
flash forward twice as often as "none".

Each arm runs alone (its state dropped before the next is built) and a
failure (out of memory, say) is reported on its arm without hiding the
others. One JSON record: `results` {arm: tokens a second or None} as the
root tool's, `arms` {arm: step ms, tokens/s, loss, peak GiB, flash
launches a step, or the error}, and `best` with its gain over "full".
It exits 1 when an arm failed. `--smoke` is a tiny shape that runs every
arm in seconds (with `--device cpu`, the plain versions; its times are
the harness's, not a device's).

  python -m megatron_tpu_torch.tools.bench_remat [--iters N] [--warmup N]
      [--smoke] [--device cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import sys

from megatron_tpu_torch.config import (MegatronConfig, OptimizerConfig,
                                       TrainingConfig, llama2_config)
from megatron_tpu_torch.tools import bench_common
from megatron_tpu_torch.utils.device import resolve_device

# (recompute_granularity, quantized_gemm) of each arm, in the root tool's
# order
ARMS = (("none", "none"), ("selective", "none"), ("full", "none"),
        ("full", "int8"))
HEADLINE = dict(num_layers=12, hidden_size=2048, num_attention_heads=16,
                num_kv_heads=16, ffn_hidden_size=5504, vocab_size=32000,
                seq_length=2048)
HEADLINE_BATCH = (2, 4)   # micro-batch, microbatches
SMOKE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             num_kv_heads=4, ffn_hidden_size=128, vocab_size=128,
             seq_length=64)
SMOKE_BATCH = (1, 1)


def arm_name(remat: str, qgemm: str) -> str:
    return remat if qgemm == "none" else f"{remat}+{qgemm}"


def arm_config(remat: str, qgemm: str, shape: dict, batch: tuple,
               iters: int) -> MegatronConfig:
    micro, n_micro = batch
    model = llama2_config("tiny", compute_dtype="bfloat16",
                          attention_impl="flash", quantized_gemm=qgemm,
                          recompute_granularity=remat,
                          max_position_embeddings=shape["seq_length"],
                          **shape)
    return MegatronConfig(
        model=model, optimizer=OptimizerConfig(lr=1e-4, clip_grad=1.0),
        training=TrainingConfig(micro_batch_size=micro,
                                global_batch_size=micro * n_micro,
                                train_iters=iters)).validate()


def measure(args, device) -> dict:
    shape, batch = ((SMOKE, SMOKE_BATCH) if args.smoke
                    else (HEADLINE, HEADLINE_BATCH))
    arms, results = {}, {}
    for remat, qgemm in ARMS:
        name = arm_name(remat, qgemm)
        cfg = arm_config(remat, qgemm, shape, batch, args.iters)
        try:
            arms[name] = bench_common.time_train_steps(
                cfg, device, warmup=args.warmup, iters=args.iters)
            results[name] = arms[name]["tok_s"]
        except Exception as e:  # noqa: BLE001 — reported on its arm
            arms[name] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
            results[name] = None
        print(f"remat={name:10s}: " + (
            f"{results[name]:10.1f} tok/s, {arms[name]['step_ms']:.1f} ms"
            if results[name] else f"FAILED {arms[name]['error']}"),
            file=sys.stderr, flush=True)
    ok = {k: v for k, v in results.items() if v}
    best = max(ok, key=ok.get) if ok else None
    return {
        "metric": "remat_train_tokens_per_sec",
        "device_kind": bench_common.device_kind(device),
        "shape": dict(shape, micro_batch_size=batch[0],
                      microbatches=batch[1]),
        "iters": args.iters, "warmup": args.warmup,
        "results": results, "arms": arms, "best": best,
        "best_vs_full": (ok[best] / ok["full"] - 1.0
                         if best and ok.get("full") else None),
        "completed": len(ok) == len(ARMS),
    }


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_remat",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes: every arm in seconds")
    p.add_argument("--device", default=None,
                   help="cpu runs without a card (the default is the card)")
    return p.parse_args(argv)


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    args.warmup, args.iters = max(args.warmup, 1), max(args.iters, 1)
    device = resolve_device(device if device is not None else args.device)
    record = measure(args, device)
    bench_common.emit(record, args.out)
    return 0 if record["completed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
