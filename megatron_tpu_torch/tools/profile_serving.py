"""Where the time goes on the serial serving path, on one GPU.

Builds Llama-2-7B at full width (random bf16 weights from a fixed seed),
then runs under torch.profiler (CPU + CUDA activities):

- prefill: one 512-token prompt through the cached forward (the flash
  kernel path);
- decode: 16 single-token steps through the same cache (the dot path).

For each phase it prints one JSON line, times per forward: the host wall of
five unprofiled repeats (all taken before any profiler session) and of the
profiled run, the device busy time (the sum of kernel times; kernels run on
one stream, so they do not overlap), the idle share against the fastest
unprofiled repeat, the kernel count, and the device time by kernel class
(GEMM, the port's flash kernel, the rest) with the five largest kernels by
name. Run from the root of a checkout:

    python -m megatron_tpu_torch.tools.profile_serving
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from megatron_tpu_torch.config import llama2_config
from megatron_tpu_torch.inference.generation import init_kv_caches
from megatron_tpu_torch.models import language_model as lm

PROMPT_LEN = 512
DECODE_STEPS = 16
REPEATS = 5
CALLS = {"prefill": 1, "decode": DECODE_STEPS}  # forwards a call


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd"
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas")):
        return "gemm"
    return "other"


def device_breakdown(prof, calls: int) -> dict:
    by_name = {}  # kernel name -> (device us, launches)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(evt.key, (0.0, 0))
            by_name[evt.key] = (t + evt.self_device_time_total,
                                n + evt.count)
    classes = {}
    for name, (t, _) in by_name.items():
        c = kernel_class(name)
        classes[c] = classes.get(c, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(
        device_ms_per_call=sum(t for t, _ in by_name.values()) / calls / 1e3,
        kernels_per_call=sum(n for _, n in by_name.values()) / calls,
        class_ms_per_call={c: t / calls / 1e3 for c, t in classes.items()},
        top_kernels=[dict(name=n[:80], ms_per_call=t / calls / 1e3)
                     for n, (t, _) in top])


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = llama2_config("7b")
    model = lm.LanguageModel(cfg, dtype=torch.bfloat16, seed=0)
    dev = model.device
    rope = lm.make_rope(cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), device=dev,
                           generator=torch.Generator(dev).manual_seed(0))

    def prefill():
        caches = init_kv_caches(cfg, 1, 576, device=dev)
        logits, caches = lm.model_forward(model, tokens, cfg,
                                          kv_caches=caches, rope=rope)
        return logits[:, -1].argmax(-1, keepdim=True), caches

    def decode(tok, caches):
        for _ in range(DECODE_STEPS):
            logits, caches = lm.model_forward(model, tok, cfg,
                                              kv_caches=caches, rope=rope)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return tok

    def run(phase, profiled=False):
        """One call of the phase, its set-up outside the clock and the
        profiler. Returns (host wall ms per forward, profiler or None)."""
        tok, caches = prefill()
        torch.cuda.synchronize()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                prefill()
            else:
                decode(tok, caches)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / CALLS[phase] * 1e3
        return ms, prof

    with torch.inference_mode():
        run("decode")  # warm-up: kernel build, cuBLAS handles
        # every unprofiled repeat before any profiler session, so none of
        # them pays for the profiler's hooks
        walls = {phase: [run(phase)[0] for _ in range(REPEATS)]
                 for phase in CALLS}
        for phase, calls in CALLS.items():
            profiled_ms, prof = run(phase, profiled=True)
            rec = dict(phase=phase, card=card, calls=calls,
                       profiled_wall_ms_per_call=profiled_ms,
                       unprofiled_wall_ms_per_call=walls[phase],
                       **device_breakdown(prof, calls))
            busy = rec["device_ms_per_call"]
            # idle share against the fastest unprofiled repeat: the least
            # idle the host allowed
            rec["device_idle_share"] = (1.0 - busy / min(walls[phase])
                                        if busy > 0 else None)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
