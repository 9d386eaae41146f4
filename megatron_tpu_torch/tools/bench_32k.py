"""Training throughput of a Llama-2-7B-width slice at long context (32k by
default; any seq), on one card (the port of the root tools/bench_32k.py).

A whole 7B model does not train on one card with fp32 master weights and
Adam (16 bytes a parameter: ~108 GB at 32 layers), so this measures slices
of its true width: h 4096, 32 heads, ffn 11008, vocab 32000, flash
attention, full recompute, bf16 compute, fp32 Adam, one sequence a step;
only the depth shrinks. Above 8192 positions the RoPE scaling is 8.0 (the
long-context recipe). The layer ladder is (4, 3, 2), largest first: the
first two depths that train fix the fit step_time(L) = a + b L (b the
per-layer time, a the embedding, head and optimizer), and the record
extrapolates it to `--extrapolate_layers` (32): a number labelled as an
extrapolation from a width-true slice, not a measured 7B step.

One JSON line per depth that trained (tokens a second, step ms, loss,
parameters, peak bytes, the flash kernels' launches a step), then the
extrapolation's. The width flags exist for a tiny run of the ladder and
the fit on the CPU (`--device cpu`, where the times are the harness's).
A depth that runs out of
card memory is recorded as failed and the ladder goes on to the next;
any other error stops the run. It exits 1 when no depth trained.

  python -m megatron_tpu_torch.tools.bench_32k [--seq_length N]
      [--iters N] [--warmup N] [--device cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import torch

from megatron_tpu_torch.config import (MegatronConfig, OptimizerConfig,
                                       TrainingConfig, llama2_config)
from megatron_tpu_torch.tools import bench_common
from megatron_tpu_torch.utils.device import resolve_device

LADDER = (4, 3, 2)
# dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet), for
# the extrapolation's model-FLOP utilization
H100_BF16_PEAK = 989e12
# the reference documents 890 tokens/s for a 7B step on one A100
A100_BASELINE_TOKS = 890.0
# fwd+bwd dense FLOPs a token of the true 7B (6 N, N = 6.74e9)
FLOPS_PER_TOKEN_7B = 6 * 6.74e9


def slice_config(args, layers: int) -> MegatronConfig:
    seq = args.seq_length
    model = llama2_config(
        "tiny", num_layers=layers, hidden_size=args.hidden,
        num_attention_heads=args.heads, num_kv_heads=args.heads,
        ffn_hidden_size=args.ffn, vocab_size=args.vocab, seq_length=seq,
        max_position_embeddings=seq,
        rope_scaling_factor=8.0 if seq > 8192 else 1.0,
        compute_dtype="bfloat16", attention_impl="flash",
        recompute_granularity="full")
    return MegatronConfig(
        model=model, optimizer=OptimizerConfig(lr=1e-4, clip_grad=1.0),
        training=TrainingConfig(micro_batch_size=1, global_batch_size=1,
                                train_iters=1)).validate()


def seq_tag(seq: int) -> str:
    return f"{seq // 1024}k" if seq >= 1024 else str(seq)


def fit(measured: list, layers: int) -> dict:
    """step(L) = a + b L through the first two (layers, seconds) points (one
    point folds a into b), extrapolated to `layers`."""
    if len(measured) >= 2:
        (l1, t1), (l2, t2) = measured[:2]
        per_layer = (t1 - t2) / (l1 - l2)
        overhead = t1 - per_layer * l1
        how = f"fit over L={l1},{l2}"
    else:
        (l1, t1), = measured
        per_layer, overhead = t1 / l1, 0.0
        how = f"single point L={l1} (overhead folded into per-layer)"
    return {"per_layer_s": per_layer, "overhead_s": overhead,
            "step_s": overhead + per_layer * layers, "how": how}


def measure(args, device) -> list:
    """The records: one per depth that trained, then the extrapolation."""
    seq, kind = args.seq_length, bench_common.device_kind(device)
    records, measured, last_err = [], [], None
    for layers in LADDER:
        try:
            r = bench_common.time_train_steps(
                slice_config(args, layers), device, warmup=args.warmup,
                iters=args.iters)
        except torch.cuda.OutOfMemoryError as e:  # try fewer layers
            last_err = f"{type(e).__name__}: {str(e)[:400]}"
            records.append({"layers": layers, "failed": last_err})
            continue
        records.append({
            "metric": f"{seq_tag(seq)}_slice_train_tokens_per_sec_per_card",
            "value": r["tok_s"], "layers": layers, "hidden": args.hidden,
            "seq": seq, "params_b": r["params"] / 1e9,
            "step_ms": r["step_ms"], "loss": r["loss"],
            "device_kind": kind,
            "peak_bytes": (None if r["peak_gib"] is None
                           else int(r["peak_gib"] * 2**30)),
            "launches_per_step": r["launches_per_step"]})
        measured.append((layers, r["step_ms"] / 1e3))
        if len(measured) == 2:
            break
    if not measured:
        return records + [{"metric": "bench_32k_failed", "error": last_err}]
    f = fit(measured, args.extrapolate_layers)
    tok_s = seq / f["step_s"]
    # a utilization or a card comparison only from a card's times
    on_card = device.type == "cuda"
    records.append({
        "metric": (f"extrapolated_7b_{seq_tag(seq)}_tokens_per_sec_per_card"),
        "value": tok_s,
        "note": (f"EXTRAPOLATED to {args.extrapolate_layers} layers from a "
                 f"width-true slice ({f['how']}): not a measured full-7B "
                 "step"),
        "per_layer_ms": f["per_layer_s"] * 1e3,
        "overhead_ms": f["overhead_s"] * 1e3,
        "seq": seq,
        "mfu_at_h100_bf16_peak": (tok_s * FLOPS_PER_TOKEN_7B
                                  / H100_BF16_PEAK if on_card else None),
        "vs_a100_baseline_toks": (tok_s / A100_BASELINE_TOKS if on_card
                                  else None),
        "device_kind": kind})
    return records


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_32k",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="also write the records here, one a line")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--seq_length", type=int, default=32768)
    p.add_argument("--extrapolate_layers", type=int, default=32,
                   help="the full model's depth for the a + b L fit")
    # width overrides exist for a tiny CPU run of the ladder and the fit;
    # the 7B-width slice is the default
    p.add_argument("--hidden", type=int, default=4096)
    p.add_argument("--ffn", type=int, default=11008)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--device", default=None,
                   help="cpu runs without a card (the default is the card)")
    return p.parse_args(argv)


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    args.warmup, args.iters = max(args.warmup, 1), max(args.iters, 1)
    device = resolve_device(device if device is not None else args.device)
    records = measure(args, device)
    lines = [json.dumps(r) for r in records]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if records[-1]["metric"].startswith("extrapolated") else 1


if __name__ == "__main__":
    raise SystemExit(main())
