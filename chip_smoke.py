#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (megatron_tpu_torch) on one NVIDIA
GPU. Run from the root of a checkout: `python3 chip_smoke.py`.

Phases, each fatal on failure (exit code 1, no result line):

1. device: prints `nvidia-smi --query-gpu=name,power.limit` on its own line;
2. build: compiles every kernel of the serving path from the checkout's
   sources (nvcc, sm_90a) and prints the build time;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at the main path's shapes and the edge shapes of KERNEL_CASES, with the
   stated tolerances, and times kernel, plain version and the PyTorch
   library call for the same function (scaled_dot_product_attention, a
   yardstick the port never calls);
4. main path: Llama-2-7B at full width (32 layers, random bf16 weights from
   a fixed seed) behind the port's serial MegatronServer on 127.0.0.1,
   answering requests (a)-(e) over HTTP; every kernel's launch count is
   zeroed just before and read just after, and each request must launch the
   flash kernel at least once per layer. A 2-layer slice of the same width
   checks the flash path's logits against the kernel-free dot path in fp32.
   Prefill time, decode tokens/s and peak memory are printed.

Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Without a CUDA device, or away from a checkout, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES = 3.35e12

# (label, b, s, nq, nkv, d, dtype name, causal, sliding_window). The first
# three are the prefills the main path runs: request (a) at b 1, s 512;
# request (b) at b 3, s 32 (its shortest prompt, 37, rounded down to the
# prefill bucket); request (d)'s beam search at b 4, s 24.
KERNEL_CASES = [
    ("llama2_7b_prefill", 1, 512, 32, 32, 128, "bfloat16", True, None),
    ("request_b_prefill", 3, 32, 32, 32, 128, "bfloat16", True, None),
    ("beam_prefill", 4, 24, 32, 32, 128, "bfloat16", True, None),
    ("ragged_s200", 1, 200, 32, 32, 128, "bfloat16", True, None),
    ("gqa_64q_8kv", 1, 512, 64, 8, 128, "bfloat16", True, None),
    ("falcon7b_mqa", 1, 512, 71, 1, 64, "bfloat16", True, None),
    ("fp32_window128", 1, 512, 32, 8, 128, "float32", True, 128),
]
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}  # (out, lse)
MAIN_SHAPE = "llama2_7b_prefill"


class ByteTokenizer:
    """Stand-in tokenizer: one id per UTF-8 byte (3 + byte); eod 0, bos 1."""
    eod = 0
    bos = 1
    vocab_size = 259

    def tokenize(self, text: str) -> list[int]:
        return [3 + b for b in text.encode()]

    def detokenize(self, ids) -> str:
        return bytes(i - 3 for i in ids if 3 <= i < 259).decode(
            "utf-8", errors="replace")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def attention_bound(b, sq, sk, nq, nkv, d, itemsize, dtype_name, causal,
                    window):
    """Least time on the card: the larger of the visible (q, k) pairs' 4d
    FLOPs over the dtype's peak and the bytes of q, k, v, out and lse read
    or written once over the memory rate."""
    pairs = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(0, i - window + 1) if (causal and window) else 0
        pairs += max(0, hi - lo)
    flops = 4 * d * pairs * b * nq
    nbytes = (itemsize * d * (2 * b * sq * nq + 2 * b * sk * nkv)
              + 4 * b * nq * sq)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    from megatron_tpu_torch.ops import flash_attention_cuda
    t0 = time.perf_counter()
    path = flash_attention_cuda.build()
    flash_attention_cuda._library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F
    from megatron_tpu_torch.ops.flash_attention import blockwise_attention
    from megatron_tpu_torch.ops.flash_attention_cuda import flash_fwd_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = []
    for (label, b, s, nq, nkv, d, dname, causal, window) in KERNEL_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(b, s, nq, d, generator=gen, device="cuda").to(dtype)
        # k and v as the strided halves of one fused projection, as the
        # model hands them over
        kv = torch.randn(b, s, 2, nkv, d, generator=gen,
                         device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
        scale = d ** -0.5

        def kernel():
            return flash_fwd_cuda(q, k, v, causal=causal, scale=scale,
                                  sliding_window=window)

        def plain():
            return blockwise_attention(q, k, v, causal=causal, scale=scale,
                                       sliding_window=window)

        out, lse = kernel()
        torch.cuda.synchronize()
        ref_out, ref_lse = plain()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dname]
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        check(err_out <= tol_out and err_lse <= tol_lse,
              f"{label}: kernel vs plain out err {err_out} (tol {tol_out}),"
              f" lse err {err_lse} (tol {tol_lse})")

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale,
                    enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale,
                    enable_gqa=True)

        bound_ms, bound_by = attention_bound(b, s, s, nq, nkv, d,
                                             q.element_size(), str(dtype),
                                             causal, window)
        r = dict(shape=label, b=b, s=s, nq=nq, nkv=nkv, d=d, dtype=dname,
                 causal=causal, sliding_window=window,
                 max_abs_err=err_out, max_abs_err_lse=err_lse,
                 ms=cuda_time_ms(kernel), plain_ms=cuda_time_ms(plain, 5, 1),
                 library_ms=cuda_time_ms(library), bound_ms=bound_ms,
                 bound_by=bound_by)
        log("kernel check: " + json.dumps(r))
        results.append(r)
    return results


def put(port: int, payload: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_reference_slice() -> float:
    """Logits of a 2-layer slice of the 7B width through the flash kernel
    against the kernel-free dot path, fp32 weights and compute."""
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.models.language_model import (LanguageModel,
                                                          model_forward)
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    model = LanguageModel(cfg, dtype=torch.float32, seed=1)
    toks = torch.randint(0, cfg.vocab_size, (2, 160), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    with torch.inference_mode():
        flash, _ = model_forward(model, toks, cfg)
        dot, _ = model_forward(model, toks,
                               dataclasses.replace(cfg, attention_impl="dot"))
    err = (flash - dot).abs().max().item()
    scale = dot.abs().max().item()
    del model
    torch.cuda.empty_cache()
    check(err <= 1e-3 * max(scale, 1.0),
          f"2-layer 7B slice: flash vs dot logits differ by {err} "
          f"(max |logit| {scale})")
    return err


def phase_main_path(smi: str) -> dict:
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.ops.flash_attention_cuda import flash_fwd_cuda

    slice_err = check_reference_slice()
    log(f"reference: 2-layer 7B-width slice, flash vs dot logits max err "
        f"{slice_err:.3g}")

    cfg = llama2_config("7b")
    check(cfg.num_layers == 32 and cfg.hidden_size == 4096
          and cfg.num_attention_heads == 32 and cfg.ffn_hidden_size == 11008
          and cfg.vocab_size == 32000 and cfg.attention_impl == "flash",
          "llama2_config('7b') is not Llama-2-7B")
    t0 = time.perf_counter()
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: Llama-2-7B, {n_params} parameters in bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod)
    server = MegatronServer(gen, tok)
    httpd = server.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def text(n: int, seed: int) -> str:
        alphabet = "abcdefghijklmnopqrstuvwxyz ,."
        return "".join(alphabet[(seed * 7 + i * 13 + i * i) % len(alphabet)]
                       for i in range(n))

    n_new = 32
    req_a = {"prompts": [text(512, 1)], "tokens_to_generate": n_new,
             "temperature": 0.0}
    req_b = {"prompts": [text(37, 2), text(200, 3), text(515, 4)],
             "tokens_to_generate": n_new, "temperature": 0.8, "top_k": 40,
             "top_p": 0.9, "random_seed": 7, "logprobs": True}
    req_d = {"prompts": [text(24, 5)], "tokens_to_generate": 16,
             "beam_width": 4}
    stats = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        flash_fwd_cuda.launches = 0
        per_request = {}
        bodies = {}
        for name, payload in (("a", req_a), ("b", req_b), ("c", req_a),
                              ("d", req_d)):
            before = flash_fwd_cuda.launches
            t0 = time.perf_counter()
            status, body = put(port, payload)
            secs = time.perf_counter() - t0
            check(status == 200, f"request ({name}): status {status} {body}")
            per_request[name] = flash_fwd_cuda.launches - before
            bodies[name] = body
            log(f"request ({name}): 200 in {secs:.2f} s, flash launches "
                f"{per_request[name]}")
        status, body = put(port, {})
        total_launches = flash_fwd_cuda.launches
        check(status == 400 and body == {"message":
                                         "prompts argument required"},
              f"request (e): {status} {body}")
        log("request (e): 400 prompts argument required")
        peak = torch.cuda.max_memory_allocated()

        for name in "abcd":
            check(per_request[name] >= cfg.num_layers,
                  f"request ({name}) launched the flash kernel "
                  f"{per_request[name]} times, < {cfg.num_layers} layers")
        for name, req in (("a", req_a), ("b", req_b)):
            body = bodies[name]
            check(len(body["segments"]) == len(req["prompts"]),
                  f"({name}) rows")
            for prompt, seg in zip(req["prompts"], body["segments"]):
                n_prompt = len(tok.tokenize(prompt))
                check(seg[:n_prompt] == tok.tokenize(prompt),
                      f"({name}) prompt not echoed")
                check(n_prompt < len(seg) <= n_prompt + n_new
                      and (len(seg) == n_prompt + n_new
                           or seg[-1] == tok.eod),
                      f"({name}) output length {len(seg)}")
                check(all(0 <= t < cfg.vocab_size for t in seg),
                      f"({name}) token out of vocab")
        for lps in bodies["b"]["logprobs"]:
            check(all(isinstance(x, float) and x == x and abs(x) != float(
                "inf") for x in lps), "(b) non-finite logprob")
        check(bodies["c"]["segments"] == bodies["a"]["segments"],
              "(c) greedy repeat differs from (a)")
        check(len(bodies["d"]["text"]) == 4
              and len(bodies["d"]["score"]) == 4
              and all(x == x for x in bodies["d"]["score"]),
              "(d) beam search output")

        # prefill and decode rates on the same path, off the HTTP clock
        ids = tok.tokenize(req_a["prompts"][0])
        greedy = SamplingParams(temperature=0.0)

        def timed(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen.generate([ids], n, sampling=greedy)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        timed(1)
        prefill_s = min(timed(1) for _ in range(3))
        full_s = min(timed(n_new + 1) for _ in range(2))
        stats = dict(
            prefill_tokens=len(ids), prefill_ms=prefill_s * 1e3,
            decode_tokens_per_s=n_new / (full_s - prefill_s),
            peak_memory_gib=peak / 2 ** 30,
            flash_launches_per_request=per_request, card=smi)
        log("serial serving: " + json.dumps(stats))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    stats["launches"] = total_launches
    return stats


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import megatron_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the "
              "repository (megatron_tpu_torch not importable)",
              file=sys.stderr)
        return 2
    try:
        smi = phase_device()
        phase_build()
        cases = phase_kernels()
        main_stats = phase_main_path(smi)
    except Exception:  # noqa: BLE001 — every phase failure fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    main_case = next(c for c in cases if c["shape"] == MAIN_SHAPE)
    kernel = dict(
        name="flash_fwd", route="cuda",
        source="megatron_tpu_torch/csrc/flash_fwd.cu",
        replaces="megatron_tpu/ops/flash_attention_pallas.py:98",
        launches=main_stats["launches"],
        max_abs_err=main_case["max_abs_err"],
        max_abs_err_lse=main_case["max_abs_err_lse"], ms=main_case["ms"],
        kernel_ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"], shape=MAIN_SHAPE, cases=cases)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
