"""Where the fused-norm backward's time goes on the card
(csrc/fused_norms.cu `norm_bwd_rows_kernel` or `norm_bwd_wide_kernel`,
then `norm_bwd_colsum_kernel`), through `rms_bwd_cuda` / `ln_bwd_cuda`.
Runs on the machine with the card:

    python -m megatron_tpu_torch.tools.norm_bwd_profile [--iters 20]

For each bf16 shape of SHAPES and each norm, one JSON line with:
- `resident`: the backward (both launches) with every call on the next
  copy of the inputs (copies spanning 4x the 50 MB L2) beside the same
  calls on one L2-resident copy: equal times say HBM does not hold the
  kernel back;
- `kernels_us`: the rows (or wide) kernel and the column sum apart
  (torch.profiler's device times).
Every time is queued behind a spin of the card, so it is the device's
alone, and carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import re
import subprocess
import sys

import torch

from megatron_tpu_torch.ops import fused_norms_cuda as fnc

# (label, rows, h): bench_kernels' [4, 2048, 2048], Llama-2-7B's and
# Falcon-7B's training rows, bench_kernels' [8, 1024, 8192], and GPT-3
# 175B's h 12288 (the wide kernel)
SHAPES = [("bench_4x2048x2048", 8192, 2048), ("llama2_7b_train", 4096, 4096),
          ("falcon7b_train", 2048, 4544), ("bench_8x1024x8192", 8192, 8192),
          ("wide_2048x12288", 2048, 12288)]
L2_BYTES = 50 * 2 ** 20
SPIN_CYCLES = 50_000_000  # ~30 ms: the host enqueues every call meanwhile
EPS = 1e-5


def queued_us(fn, iters: int) -> float:
    """us per call of fn between CUDA events, the calls queued behind a
    spin of the card."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters * 1e3


def profile(label, rows, h, kind, iters, card, gen):
    x = (torch.randn(rows, h, generator=gen, device="cuda") * 2
         + 0.5).bfloat16()
    dy = torch.randn(rows, h, generator=gen, device="cuda").bfloat16()
    scale = (1 + 0.2 * torch.randn(h, generator=gen,
                                   device="cuda")).bfloat16()
    n = max(2, -(-4 * L2_BYTES // (x.nbytes + dy.nbytes)))
    copies = [(x, dy)] + [(x.clone(), dy.clone()) for _ in range(n - 1)]
    bwd = fnc.ln_bwd_cuda if kind == "ln" else fnc.rms_bwd_cuda
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    keep = [None] * n

    def timed(m):
        turn = itertools.count()

        def call():
            i = next(turn) % m
            xc, dyc = copies[i]
            keep[i] = bwd(xc, scale, dyc, EPS)
        return queued_us(call, iters)

    resident = dict(rotated_us=[timed(n), timed(n)],
                    l2_resident_us=[timed(1), timed(1)])
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            xc, dyc = copies[i % n]
            keep[i % n] = bwd(xc, scale, dyc, EPS)
        torch.cuda.synchronize()
    kernels = {re.search(r"norm_bwd_\w+", e.key).group(0):
               e.device_time_total / e.count
               for e in prof.key_averages() if "norm_bwd" in e.key}
    return dict(shape=label, norm=kind, rows=rows, h=h,
                plan=dataclasses.asdict(fnc.bwd_plan(rows, h, 2, sms)),
                resident=resident, kernels_us=kernels, card=card)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_bwd_profile: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, rows, h in SHAPES:
        for kind in ("rms", "ln"):
            print(json.dumps(profile(label, rows, h, kind, args.iters, card,
                                     gen)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
