"""Where the time goes in one training step, on one GPU.

Builds the training main path of `chip_smoke.py`: Llama-2-7B at full width
with 8 of its 32 layers (fp32 master weights, bf16 compute, Adam), seq
4096, global batch 2 of micro-batch 1, random weights and one random batch
from fixed seeds. After one warm-up step (kernel build, cuBLAS handles) it
takes five unprofiled steps, all before any profiler session, then one
step under torch.profiler (CPU + CUDA activities), and prints one JSON
line: the host wall of each unprofiled step; the device busy time (the sum
of kernel times; kernels run on one stream, so they do not overlap); the
idle share against the fastest unprofiled step; the kernel count; the
device time of the step's two spans (forward + backward over the
microbatches, and the optimizer); the device time and the launches by
kernel class (GEMM, the three flash kernels, elementwise, reductions, the
rest) with the ten largest kernels by name; and the peak memory. Run from
the root of a checkout:

    python -m megatron_tpu_torch.tools.profile_training
"""
from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from megatron_tpu_torch.config import (MegatronConfig, OptimizerConfig,
                                       TrainingConfig, llama2_config)
from megatron_tpu_torch.training import init_train_state, make_train_step
from megatron_tpu_torch.training.train_step import (SPAN_FORWARD_BACKWARD,
                                                    SPAN_OPTIMIZER)

LAYERS = 8
REPEATS = 5


def kernel_class(name: str) -> str:
    low = name.lower()
    for flash in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if flash in low:
            return flash
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas")):
        return "gemm"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = MegatronConfig(
        model=llama2_config("7b", num_layers=LAYERS),
        optimizer=OptimizerConfig(lr=3e-4, clip_grad=1.0),
        training=TrainingConfig(micro_batch_size=1, global_batch_size=2))
    state = init_train_state(cfg, seed=0)
    step = make_train_step(cfg)
    s = cfg.model.seq_length
    tokens = torch.randint(0, cfg.model.vocab_size,
                           (cfg.num_microbatches, 1, s + 1), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
    batch = {"tokens": tokens}

    def run():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, float(metrics["lm_loss"])

    run()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = [run()[0] for _ in range(REPEATS)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms, loss = run()

    # Spans from the raw events: a span's device-side annotation bounds the
    # kernels it launched on the device timeline (backward kernels come
    # from autograd's own thread, so the host range does not hold them),
    # and the annotation itself is no kernel
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    span_names = (SPAN_FORWARD_BACKWARD, SPAN_OPTIMIZER)
    kernels = [e for e in events if e.name not in span_names]
    by_name, spans = {}, {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    for span in span_names:
        ranges = [e.time_range for e in events if e.name == span]
        spans[span] = sum(
            k.time_range.elapsed_us() for k in kernels
            if any(r.start <= k.time_range.start < r.end for r in ranges)
        ) / 1e3 if ranges else None
    classes, class_launches = {}, {}
    for name, (t, n) in by_name.items():
        c = kernel_class(name)
        classes[c] = classes.get(c, 0.0) + t
        class_launches[c] = class_launches.get(c, 0) + n
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    rec = dict(
        card=card, layers=LAYERS, seq_length=s,
        microbatches=cfg.num_microbatches, loss=loss,
        unprofiled_wall_ms=walls, profiled_wall_ms=profiled_ms,
        device_busy_ms=busy,
        device_idle_share=1.0 - busy / min(walls) if busy > 0 else None,
        kernels=sum(n for _, n in by_name.values()),
        span_device_ms=spans, class_ms=classes,
        class_launches=class_launches,
        top_kernels=[dict(name=n[:90], ms=t, launches=c)
                     for n, (t, c) in top],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
