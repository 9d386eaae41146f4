"""Kernel microbenchmarks on one GPU (tools/bench_kernels.py, ported).

The A/B of each hand-written kernel against the port's eager PyTorch
counterpart, at transformer shapes:

- the fused norms (csrc/fused_norms.cu): RMSNorm forward, LayerNorm
  forward, RMSNorm vjp and LayerNorm vjp against the eager norms of
  models/norms.py (the reference times the first three; the LayerNorm vjp
  arm is the port's, so that every norm kernel is timed);
- the int8 GEMM `ops/quantized.int8_matmul` (quantization included) against
  bf16 `x @ w`;
- the flash forward (csrc/flash_fwd.cu) against the plain blockwise
  attention.

The kernel arm is labelled `cuda`, or `plain` with `--device cpu`, where the
wrappers take their plain versions. Times are CUDA events on the card (the
host clock on the CPU) over `--iters` calls after one warm-up. An arm that
fails prints its FAILED line and the tool then exits 1. Lines go to stdout
and, with `--out`, to that file too.

  python -m megatron_tpu_torch.tools.bench_kernels [--iters N] [--smoke]
      [--device cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import time

import torch

from megatron_tpu_torch.models.norms import layernorm, rmsnorm
from megatron_tpu_torch.ops.flash_attention import (blockwise_attention,
                                                    flash_attention)
from megatron_tpu_torch.ops.fused_norms import fused_layernorm, fused_rmsnorm
from megatron_tpu_torch.ops.quantized import int8_matmul
from megatron_tpu_torch.utils.device import resolve_device

NORM_SHAPES = [(4, 2048, 2048), (2, 4096, 4096), (8, 1024, 8192)]
GEMM_SHAPES = [(8192, 4096, 11008), (4096, 4096, 4096), (2048, 8192, 8192)]
FLASH_SHAPES = [(2, 2048, 16, 128), (1, 8192, 8, 128), (1, 32768, 4, 128)]
SMOKE = dict(norm=[(2, 128, 256)], gemm=[(64, 128, 256)],
             flash=[(1, 256, 2, 64)])


def _timer(device: torch.device, iters: int):
    """us per call of fn: CUDA events on the card, the host clock on the
    CPU, after one warm-up call."""
    def timeit(fn) -> float:
        fn()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(stop) / iters * 1e3
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    return timeit


def _vjp(norm, dy):
    """The (x, scale[, bias]) grads of sum(norm(...) * dy), in fp32."""
    def run(*args):
        leaves = [a.detach().requires_grad_(True) for a in args]
        out = norm(*leaves).float()
        return torch.autograd.grad(out, leaves, dy.float())
    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench_kernels", description=__doc__)
    p.add_argument("--out", default=None,
                   help="also write the lines to this file")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes: every arm end to end in seconds "
                        "(timings meaningless)")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    label = "cuda" if device.type == "cuda" else "plain"
    log = open(args.out, "w", buffering=1) if args.out else None
    failed = []

    def emit(line):
        print(line, flush=True)
        if log:
            log.write(line + "\n")

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    emit(f"device: {device.type} {name}")
    timeit = _timer(device, args.iters)
    gen = torch.Generator(device=device)
    norm_shapes = SMOKE["norm"] if args.smoke else NORM_SHAPES
    gemm_shapes = SMOKE["gemm"] if args.smoke else GEMM_SHAPES
    flash_shapes = SMOKE["flash"] if args.smoke else FLASH_SHAPES

    def arm_failed(what, e):
        failed.append(what)
        emit(f"{what} FAILED: {type(e).__name__}: {str(e)[:160]}")

    # --- norms: the fused kernels against the eager model norms ---
    for (b, s, h) in norm_shapes:
        gen.manual_seed(0)
        x = torch.randn(b, s, h, generator=gen, device=device).to(
            torch.bfloat16)
        dy = torch.randn(b, s, h, generator=gen, device=device).to(
            torch.bfloat16)
        scale = torch.ones(h, dtype=torch.bfloat16, device=device)
        bias = torch.zeros(h, dtype=torch.bfloat16, device=device)
        gb_fwd = 2 * x.numel() * 2 / 1e9  # x read + y written, bf16
        gb_vjp = 3 * x.numel() * 2 / 1e9  # x + dy read, dx written
        eager_rms = lambda x, s: rmsnorm({"scale": s}, x)  # noqa: E731
        eager_ln = lambda x, s, b2: layernorm(  # noqa: E731
            {"scale": s, "bias": b2}, x)
        pairs = [
            ("rms fwd", gb_fwd, eager_rms, fused_rmsnorm, (x, scale)),
            ("ln  fwd", gb_fwd, eager_ln, fused_layernorm, (x, scale, bias)),
            ("rms vjp", gb_vjp, _vjp(eager_rms, dy), _vjp(fused_rmsnorm, dy),
             (x, scale)),
            ("ln  vjp", gb_vjp, _vjp(eager_ln, dy), _vjp(fused_layernorm, dy),
             (x, scale, bias)),
        ]
        for what, gb, f_eager, f_kernel, fargs in pairs:
            grad = torch.enable_grad() if "vjp" in what else torch.no_grad()
            try:
                with grad:
                    t_e = timeit(lambda: f_eager(*fargs))
                    t_k = timeit(lambda: f_kernel(*fargs))
                emit(f"{what} [{b},{s},{h}] bf16: eager {t_e:8.1f}us "
                     f"({gb / (t_e * 1e-6):5.0f} GB/s) | {label} "
                     f"{t_k:8.1f}us ({gb / (t_k * 1e-6):5.0f} GB/s)")
            except Exception as e:  # noqa: BLE001 — reported, then exit 1
                arm_failed(f"{what} [{b},{s},{h}]", e)

    # --- quantized GEMM: int8 (quantization included) against bf16 ---
    for (m, k, n) in gemm_shapes:
        gen.manual_seed(4)
        x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen, device=device).to(torch.bfloat16)
        fl = 2 * m * k * n
        try:
            with torch.no_grad():
                t_b = timeit(lambda: x @ w)
                t_q = timeit(lambda: int8_matmul(x, w))
            emit(f"gemm [{m}x{k}x{n}]: bf16 {t_b:9.1f}us "
                 f"({fl / (t_b * 1e-6) / 1e12:5.1f} TF/s) | int8(+quant) "
                 f"{t_q:9.1f}us ({fl / (t_q * 1e-6) / 1e12:5.1f} TOP/s)")
        except Exception as e:  # noqa: BLE001
            arm_failed(f"gemm [{m}x{k}x{n}]", e)
        del x, w

    # --- flash attention: the kernel against the plain blockwise version ---
    for (b, s, n, d) in flash_shapes:
        gen.manual_seed(2)
        q = torch.randn(b, s, n, d, generator=gen, device=device).to(
            torch.bfloat16)
        try:
            with torch.no_grad():
                t_k = timeit(lambda: flash_attention(q, q, q, causal=True))
                t_x = timeit(lambda: blockwise_attention(
                    q, q, q, causal=True, scale=None, block_kv=512))
            fl = 4 * b * n * s * s * d / 2  # causal matmul flops
            emit(f"flash fwd [{b},{s},{n},{d}] bf16: {label} {t_k:9.1f}us "
                 f"({fl / (t_k * 1e-6) / 1e12:5.1f} TF/s) | blockwise "
                 f"{t_x:9.1f}us ({fl / (t_x * 1e-6) / 1e12:5.1f} TF/s)")
        except Exception as e:  # noqa: BLE001
            arm_failed(f"flash [{b},{s},{n},{d}]", e)
        del q
    emit("done" if not failed else f"{len(failed)} arm(s) FAILED")
    if log:
        log.close()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
