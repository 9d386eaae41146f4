"""Serving throughput on one GPU: prefill + per-token decode of the serial
`Generator` (tools/bench_decode.py, ported).

Times `Generator.generate` over a batch of random prompts (one warm-up
call, then 3 timed) for a llama-architecture model with random bf16
weights, in up to four arms: bf16 weights and cache (`bf16`), an int8 KV
cache (`int8kv`, with --int8_kv), int8-resident weights (`int8`, with
--int8_weights, `ops/quantized.quantize_weights`) and both (`int8w+kv`).
The bf16-weight arms run first: the quantized arms free the bf16 tree.

Next to each rate it prints the decode roofline on an H100: every step
streams the weights and the cache slice for the mean context (an int8
cache its fp32 scales too) at 3.35 TB/s, so tok/s_ideal = batch / (bytes /
rate). On a CPU (`--device cpu`) or another card there is no roofline
line. `--sliding_window W` gives the model a band of W positions; when W is
below the generator's cache length (prompt + new rounded up to 64) every
arm runs on a rolling cache of W positions, and the roofline's context is
capped at W.

  python -m megatron_tpu_torch.tools.bench_decode [--batch N] [--prompt N]
      [--new N] [--layers N] [--hidden N] [--heads N] [--ffn N]
      [--int8_weights] [--int8_kv] [--smoke] [--device cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from megatron_tpu_torch.config import llama2_config
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.ops.quantized import quantize_weights
from megatron_tpu_torch.utils.device import resolve_device

# device memory rate by card name (NVIDIA's data sheets), bytes/s
HBM_BW = {"H100": 3.35e12}
SMOKE = dict(batch=2, prompt=24, new=4, layers=2, hidden=64, heads=4,
             ffn=128, vocab=512)


def _card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench_decode", description=__doc__)
    p.add_argument("--out", default=None,
                   help="also write the lines to this file")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=512)
    p.add_argument("--new", type=int, default=128)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--hidden", type=int, default=2048)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--ffn", type=int, default=5504)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--int8_weights", action="store_true",
                   help="also measure with int8-resident transformer "
                        "weights (ops/quantized.quantize_weights)")
    p.add_argument("--int8_kv", action="store_true",
                   help="also measure with the int8 KV cache (Generator "
                        "kv_cache_dtype=torch.int8); with --int8_weights a "
                        "combined arm runs too")
    p.add_argument("--sliding_window", type=int, default=None,
                   help="band of W positions; the caches roll when W is "
                        "below the cache length")
    p.add_argument("--smoke", action="store_true",
                   help="a tiny model and batch (timings meaningless)")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    if args.smoke:
        for k, v in SMOKE.items():
            setattr(args, k, v)
    device = resolve_device(args.device)
    log = open(args.out, "w", buffering=1) if args.out else None

    def emit(line):
        print(line, flush=True)
        if log:
            log.write(line + "\n")

    bw = None
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        emit(f"device: cuda {kind} ({_card(device)})")
        bw = next((v for k, v in HBM_BW.items() if k in kind), None)
    else:
        emit("device: cpu")

    cfg = llama2_config(
        "tiny", num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads, num_kv_heads=args.heads,
        ffn_hidden_size=args.ffn, vocab_size=args.vocab,
        seq_length=args.prompt + args.new, compute_dtype="bfloat16",
        attention_impl="flash", sliding_window=args.sliding_window)
    # serving layout: bf16 weights (the reference serves fp16)
    model = LanguageModel(cfg, device=device, dtype=torch.bfloat16, seed=0)
    n_params = sum(t.numel() for t in model.parameters())
    # Generator.generate's cache length: the cache rolls only when the
    # window is below it (generation.kv_region_cap)
    bucketed = -(-(args.prompt + args.new) // 64) * 64
    sw = ("" if args.sliding_window is None else
          f" sliding_window={args.sliding_window}"
          + (" (rolling cache)" if args.sliding_window < bucketed
             else " (band only: window >= context, cache stays "
                  "full-length)"))
    emit(f"model: {n_params / 1e9:.3f}B params, L={args.layers} "
         f"h={args.hidden}{sw}")

    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, args.vocab, args.prompt).tolist()
               for _ in range(args.batch)]
    new_toks = args.batch * args.new
    iters = 3
    # per-decode-step device-memory streams: the weights and the cache slice
    # for the mean context (+ an int8 cache's fp32 scales, 1/hd of it)
    ctx = args.prompt + args.new / 2
    if args.sliding_window is not None:
        ctx = min(ctx, args.sliding_window)
    hd = args.hidden // args.heads
    bf16_cache = 2 * args.layers * args.batch * ctx * args.heads * hd * 2
    int8_cache = bf16_cache / 2 * (1 + 4 / hd)
    bf16_params = n_params * 2
    state = {"model": model, "pq": None, "pq_bytes": 0}
    del model

    def make_params(int8_w):
        if not int8_w:
            return state["model"]
        if state["pq"] is None:
            state["pq"] = quantize_weights(state["model"])
            state["pq_bytes"] = tree_bytes(state["pq"])
            # no later arm needs the bf16 tree (its arms run first)
            state["model"] = None
            if device.type == "cuda":
                torch.cuda.empty_cache()
        return state["pq"]

    arms = [("bf16", False, False)]
    if args.int8_kv:
        arms.append(("int8kv", False, True))
    if args.int8_weights:
        arms.append(("int8", True, False))
    if args.int8_weights and args.int8_kv:
        arms.append(("int8w+kv", True, True))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    base_tok_s = None
    for name, int8_w, int8_kv in arms:
        gen = Generator(make_params(int8_w), cfg, eos_id=-1, pad_id=0,
                        device=device,
                        kv_cache_dtype=torch.int8 if int8_kv
                        else torch.bfloat16)
        sync()
        t0 = time.perf_counter()
        gen.generate(prompts, max_new_tokens=args.new, seed=1)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(iters):
            gen.generate(prompts, max_new_tokens=args.new, seed=2 + i)
        sync()
        dt = (time.perf_counter() - t0) / iters
        gen = None
        tok_s = new_toks / dt
        vs = ""
        if base_tok_s is None:
            base_tok_s = tok_s
        else:
            vs = f" ({tok_s / base_tok_s:.2f}x vs bf16)"
        if int8_w:
            vs += (f" [param bytes {bf16_params / 1e9:.2f} GB -> "
                   f"{state['pq_bytes'] / 1e9:.2f} GB]")
        label = "generate" if name == "bf16" else f"{name} generate"
        emit(f"{label}(batch={args.batch}, prompt={args.prompt}, "
             f"new={args.new}): {dt * 1e3:.1f} ms/call -> {tok_s:.0f} "
             f"new-tok/s ({tok_s / args.batch:.1f} tok/s/seq, warm-up "
             f"{warm_s:.1f}s){vs}")
        if bw:
            step_bytes = ((state["pq_bytes"] if int8_w else bf16_params)
                          + (int8_cache if int8_kv else bf16_cache))
            ideal = step_bytes / bw
            emit(f"  {name} roofline: {step_bytes / 1e9:.2f} GB/step @ "
                 f"{bw / 1e9:.0f} GB/s -> ideal {args.batch / ideal:.0f} "
                 f"new-tok/s (measured/ideal = "
                 f"{tok_s * ideal / args.batch:.2f})")
    emit("note: per-step sampling and done-mask bookkeeping run on the host "
         "loop; prefill is amortized over the call, not subtracted")
    if log:
        log.close()
    return 0


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree (W8 leaves: values and
    scales)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, tuple):
        return sum(tree_bytes(t) for t in tree)
    return sum(tree_bytes(v) for v in tree.values())


if __name__ == "__main__":
    raise SystemExit(main())
