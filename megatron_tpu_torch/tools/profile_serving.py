"""Where the time goes on the serving paths, on one GPU.

Builds Llama-2-7B at full width and depth (random bf16 weights from a fixed
seed; `--model mixtral-8x7b` Mixtral-8x7B's widths instead, `--layers N`
another depth: 32 layers of Mixtral do not fit one card), then runs under
torch.profiler (CPU + CUDA activities). The default mode profiles the
serial path:

- prefill: one 512-token prompt through the cached forward (the flash
  kernel path);
- decode: 16 single-token steps through the same cache (the dot path).

`--engine` profiles the continuous-batching engine instead: one decode step
of an 8-slot ServingEngine on the block arena (ServingConfig(num_slots=8,
max_len=2048, kv_block_size=16, block_native_attn=True)), every slot live
at prompt lengths 37-1,000, the step being the engine's own `_step` (the
grid's sampling, the forward with the block kernel once per layer, and the
window's one host sync), driven from this thread with the engine loop not
started.

For each phase it prints one JSON line, times per call: the host wall of
five unprofiled repeats (all taken before any profiler session) and of the
profiled run, the device busy time (the sum of kernel times; kernels run on
one stream, so they do not overlap), the idle share against the fastest
unprofiled repeat, the kernel count, and the device time by kernel class
(GEMM, which holds an MoE model's expert-bank `bmm`s; sort, scatter,
gather and indexing kernels, which hold its dispatch and the embedding
lookup; the port's flash and block kernels; the rest) with the five
largest kernels by name. Run from the root of a checkout:

    python -m megatron_tpu_torch.tools.profile_serving [--engine] \
        [--model mixtral-8x7b --layers 16]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from megatron_tpu_torch.config import MODEL_PRESETS
from megatron_tpu_torch.inference.generation import init_kv_caches
from megatron_tpu_torch.models import language_model as lm

PROMPT_LEN = 512
DECODE_STEPS = 16
REPEATS = 5
CALLS = {"prefill": 1, "decode": DECODE_STEPS}  # forwards a call
ENGINE_PROMPTS = [37, 64, 100, 200, 300, 515, 700, 1000]


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd"
    if "block_attn" in low:
        return "block_attn"
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas")):
        return "gemm"
    if any(t in low for t in ("sort", "scatter", "gather", "index")):
        return "index_sort"
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


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def report(phase: str, card: str, calls: int, walls: list,
           profiled_ms: float, prof, *, model, **extra) -> None:
    rec = dict(phase=phase, card=card, calls=calls,
               layers=model.num_layers, experts=model.num_experts,
               profiled_wall_ms_per_call=profiled_ms,
               unprofiled_wall_ms_per_call=walls,
               **device_breakdown(prof, calls), **extra)
    busy = rec["device_ms_per_call"]
    # idle share against the fastest unprofiled repeat: the least idle
    # the host allowed
    rec["device_idle_share"] = (1.0 - busy / min(walls) if busy > 0
                                else None)
    print(json.dumps(rec), flush=True)


def model_config(name: str, layers):
    cfg = MODEL_PRESETS[name]()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def weight_bound_ms(model) -> float:
    """The bytes of every weight over the H100's 3.35 TB/s: the least time
    a decode step that reads them all can take."""
    return sum(p.numel() * p.element_size()
               for p in model.parameters()) / 3.35e12 * 1e3


def engine_step(cfg) -> None:
    """One 8-slot decode step of the engine on the block arena."""
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
    card = card_name()
    model = lm.LanguageModel(cfg, dtype=torch.bfloat16, seed=0)
    gen = Generator(model, cfg, eos_id=-1, pad_id=0)
    engine = ServingEngine(gen, ServingConfig(
        num_slots=8, max_len=2048, kv_block_size=16, block_native_attn=True),
        start=False)
    rs = torch.Generator().manual_seed(0)
    for i, n in enumerate(ENGINE_PROMPTS):
        prompt = torch.randint(3, cfg.vocab_size, (n,), generator=rs)
        sampling = SamplingOptions(temperature=0.0 if i % 2 else 0.8,
                                   top_p=0.9)
        engine.submit(prompt.tolist(), 2048 - n, sampling, seed=i)

    def step(profiled=False):
        torch.cuda.synchronize()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            engine._step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return ms, prof

    with torch.inference_mode():
        engine._admit()
        assert engine._active.all(), "every slot must be live"
        for _ in range(3):  # warm-up
            step()
        walls = [step()[0] for _ in range(REPEATS)]
        profiled_ms, prof = step(profiled=True)
    report("engine_decode_step", card, 1, walls, profiled_ms, prof,
           model=cfg, weight_bound_ms=weight_bound_ms(model))
    engine.close()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--engine", action="store_true",
                        help="profile one 8-slot decode step of the engine")
    parser.add_argument("--model", default="llama2-7b",
                        choices=sorted(MODEL_PRESETS))
    parser.add_argument("--layers", type=int, default=None,
                        help="depth (default: the preset's)")
    args = parser.parse_args()
    cfg = model_config(args.model, args.layers)
    if args.engine:
        engine_step(cfg)
        return
    card = card_name()
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
            report(phase, card, calls, walls[phase], profiled_ms, prof,
                   model=cfg)


if __name__ == "__main__":
    main()
