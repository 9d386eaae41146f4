#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (megatron_tpu_torch) on one NVIDIA
GPU. Run from the root of a checkout: `python3 chip_smoke.py`.

Phases, each fatal on failure (exit code 1, no result line):

1. device: prints `nvidia-smi --query-gpu=name,power.limit` on its own line;
2. build: compiles every kernel source from the checkout (nvcc, sm_90a, one
   process per source, in parallel) and prints the build time and ptxas's
   register and spill lines; a wgmma, norm or block kernel that spills
   fails the run (SPILL_FREE);
3. kernels: holds each kernel against its plain PyTorch version on the card,
   with the stated tolerances, and times kernel, plain version and the
   PyTorch library call for the same function where there is one
   (scaled_dot_product_attention and its backward, yardsticks the port
   never calls): the forward at the serving shapes of KERNEL_CASES (the
   bf16 kernel's tile edges at s 129 and 255, the engine's longest prompt,
   a bf16 window, Falcon-7B's MQA at s 2048, and
   tools/bench_kernels.py's three flash shapes, up to s 32768; every
   forward time queued behind a spin, so it is the device's alone), and
   forward plus the dQ and dK/dV backward kernels at the training shapes of
   TRAIN_CASES (segment ids, dropout, an lse cotangent, GQA, MQA, ragged,
   a bf16 window, Falcon-7B MQA with segment ids and dropout at a ragged
   s 1000, fp32 with a window), each backward run twice and required
   bit-identical, every time queued; the dropout keep bits of the forward,
   dQ and dV kernels, read off their outputs, must equal the plain hash bit
   for bit; the block-native decode-attention kernel at
   BLOCK_CASES (the engine's decode shape, 64-token blocks, a 4-query
   verify window, 64/8 GQA, Falcon-7B's 71/1 heads at hd 64, fp32, int8
   with scales, idle rows, a slot whose keys reach the region's end), each
   on a scattered block map, run twice (the same bits required) and rerun
   with NaN in every dead block (the same bits again: dead blocks are never
   loaded), timed queued on rotating arena copies beside
   scaled_dot_product_attention on the gathered view (gather not counted,
   its own time beside it); the four fused-norm
   kernels (csrc/fused_norms.cu) forward and backward at NORM_CASES (the
   backward's launches summing dscale and dbias to [1, h] themselves), each
   backward run twice and required bit-identical, timed beside torch's
   rms_norm / layer_norm and their autograd backward on input copies that
   span 4x the L2 (NORM_ROTATION_BYTES);
3b. bench_kernels path: the ported tools/bench_kernels.py at its full
   shapes (5 iterations): no arm may fail, and the launch counts of the four
   norm kernels and the flash forward, zeroed just before, must advance;
4. serving main path: Llama-2-7B at full width (32 layers, random bf16
   weights from a fixed seed) behind the port's serial MegatronServer
   (ServingConfig(serial_fallback=True)) on 127.0.0.1, answering requests
   (a)-(e) over HTTP; every kernel's launch
   count is zeroed just before and read just after, and each request must
   launch the flash kernel at least once per layer. A 2-layer slice of the
   same width checks the flash path's logits against the kernel-free dot
   path in fp32. Prefill time, decode tokens/s and peak memory are printed;
5. engine main path: the same model behind MegatronServer's continuous-
   batching engine route (ENGINE_SERVING: 8 slots, 2048 positions,
   16-token blocks, the block kernel), 16 concurrent requests from 16
   threads, an empty payload and a /metrics read (`phase_engine`). Every
   request must return 200 with finite logprobs; counts zeroed just before
   the requests must show the block kernel once per layer per decode step
   and the flash forward once per layer per prefill. The kernel is held
   against its plain version on the engine's live state of one decode
   step. Tokens/s, TTFT p50/p99, inter-token p50, peak memory and the share
   of greedy requests equal to the serial route are printed. A 2-layer fp32
   slice checks that the block-native engine, the whole-region engine and
   the serial route give the same greedy tokens;
6. int8 serving: Llama-2-7B at full width and depth with int8-resident
   weights (`quantize_weights` of the random bf16 weights) behind the
   engine route with an int8 block pool (INT8_SERVING), 12 concurrent
   requests (`phase_int8`). Every request must return 200 with finite
   logprobs; the block kernel must run once per layer per decode step, on
   the int8 arena with its scales, and the flash forward 0 times (an int8
   cache prefills on the dot path). Tokens/s, TTFT p50/p99, inter-token
   p50, peak memory and the weight and pool bytes are printed. Then the
   ported tools/bench_decode.py at Llama-2-7B's width (batch 8, prompt
   512, 16 new tokens), all four arms; and a 2-layer fp32 slice where the
   int8-KV engine gives the same greedy tokens as the int8-KV serial route,
   the W8 + int8-KV engine's logprobs agree with its tokens fed through the
   serial route (every generated token, W8_LOGPROB_TOL) while two faults
   planted in its k scales must not, and the block kernel is held against
   its plain version on that engine's live int8 arena. The int8 GEMM
   (`torch._int_mm`, padded as ops/quantized.py pads it) is first checked
   exact at the decode and prefill shapes;
7. training main path: the serving model is freed, then `init_train_state`
   and `make_train_step` train Llama-2-7B at full width with 8 of its 32
   layers (fp32 master weights, Adam and its moments do not fit 32 layers
   in 80 GB), seq 4096, global batch 2 of micro-batch 1, bf16 compute, for
   3 steps on one fixed random batch (step 2's batch carries segment ids).
   Launch counts are zeroed before the steps: each step must launch each of
   the three kernels layers x microbatches times; the loss must start near
   ln(32000) and fall every step, with found_inf 0 and a finite grad norm.
   Step time, tokens/s, the model-FLOP share of 989 TFLOP/s and peak memory
   are printed. A 2-layer slice of the same width, fp32 compute with TF32
   off, checks the flash path's loss and grads (kernels) against the dot
   path (no kernel);
8. pretrain entry point (`phase_pretrain`): phase 7's model is freed, then
   a synthetic corpus (a GPT-2 byte-level vocab.json of exactly 32,000
   entries with its merges.txt, PRETRAIN_DOCS random documents, each
   shorter than a sequence) goes through the port's
   tools/preprocess_data.py --append_eod, and `finetune.main` trains
   Llama-2-7B's width with PRETRAIN_LAYERS layers (seq 4096, bf16 compute,
   flash, global batch 2 of micro-batch 1, EOD resets so the segment-id
   kernels run, eval every 2 iterations) three times, in process: U, 4
   iterations; A, --save D --exit_interval 2; B, --load D, which resumes at
   iteration 2. B's batches at iterations 3-4 must equal U's, its
   iteration-3 loss U's within PRETRAIN_LOSS3_RTOL and its iteration-4 loss
   within PRETRAIN_LOSS4_RTOL; U's loss starts near ln(32000) and falls;
   found_inf 0; D's manifest verifies and its metadata holds
   consumed_samples 4 and a data state; every iteration launches each
   flash kernel layers x microbatches times and every evaluation the
   forward alone (counts zeroed before each run); some row carries more
   than one segment. Step time and tokens/s of U, the data path's host
   seconds per batch, checkpoint bytes, save, manifest and load seconds and
   peak memory are printed; D is deleted.
9. weight toolchain (`phase_toolchain`): phase 8's model is freed, then
   (a) the golden-logit fixture replays on the card (fp32, TF32 off,
   average max-abs <= 1e-3) and the 100-step loss trajectory in fp32 and
   fp16 through verify_correctness.trajectory_mode, which gates the fp32
   losses and lr at the JAX package's tolerances and reports the other
   series; the fixture model (head dim 16) launches no kernel. (b)
   Llama-2-7B at full width and TOOLCHAIN_LAYERS layers: random bf16
   weights from a numpy seed written as an HF directory in the
   published layout (config.json, two safetensors shards, their index),
   imported by tools/convert_hf_checkpoint.py into a fp32 release
   checkpoint and exported back: every exported tensor equals the input
   upcast bit for bit, and a re-import the import. (c) That checkpoint
   served by tools/run_text_generation_server.main on 127.0.0.1 with phase
   8's 32,000-entry vocabulary: with --serial, greedy requests give the
   tokens of an in-process Generator on the imported model, and
   tools/text_generation_cli gets an answer; on the engine route (16-token
   blocks, num_slots from the card's free memory) TOOLCHAIN_ENGINE_REQUESTS
   concurrent requests return 200 with finite logprobs, the flash forward
   launching once per layer per prefill and the block kernel once per
   layer per decode step. (d) finetune.main --load the release --finetune
   --use_checkpoint_args --no_save_optim, TOOLCHAIN_FT_ITERS iterations at
   lr 3e-5 on phase 8's corpus: finite losses, each flash kernel launched
   layers x microbatches times an iteration, compare_loss_curves of the
   run's log against itself exits 0, and the finetuned checkpoint's export
   re-imports to its params bit for bit. (e) Falcon-7B at full width and
   TOOLCHAIN_LAYERS layers (fused multi-query QKV, tied head): import,
   serial greedy tokens equal to the in-process Generator's, an engine
   burst (flash and block kernels at hd 64, one kv head) and the export
   round trip. Bytes and seconds of each part are printed beside the card.

Then one JSON line {"kernels": [...]} (8 kernels; each launch count is one
that a main path's run counted, zeroed just before it and read just after,
the norm kernels' on every path above, the flash kernels' on phases 8 and
9 too, the block kernel's on phase 9 too) and, last, {"ok": true,
"device": ...}.
Without a CUDA device, or away from a checkout, it exits non-zero and
prints no result.

`--compare-fwd OLD_CU`, `--compare-bwd OLD_CU`, `--compare-norms OLD_CU`
and `--compare-block OLD_CU` replace the smoke run: they build an earlier
csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/fused_norms.cu or
csrc/block_attn.cu (headers beside it first, e.g. an earlier commit's
csrc/ unpacked with `git archive`) outside the checkout and time it beside
the current kernels at every bf16 shape (the block kernel at every
BLOCK_CASES shape), old, new, new, old (the norm backward through the
current wrapper with the autograd Function's cast).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12,
              "torch.int8": 1979e12}
PEAK_BYTES = 3.35e12

# (label, b, s, nq, nkv, d, dtype name, causal, sliding_window). The first
# three are the prefills the main path runs: request (a) at b 1, s 512;
# request (b) at b 3, s 32 (its shortest prompt, 37, rounded down to the
# prefill bucket); request (d)'s beam search at b 4, s 24. s 129 and s 255
# sit one row past a 128-row tile of the bf16 kernel and one row short of
# two; s 1000 is the engine phase's longest prompt; the bf16 window of 100
# crosses the band's edge inside tiles. The bench_ cases are
# tools/bench_kernels.py's flash shapes (FLASH_SHAPES), which the
# bench_kernels path launches.
KERNEL_CASES = [
    ("llama2_7b_prefill", 1, 512, 32, 32, 128, "bfloat16", True, None),
    ("request_b_prefill", 3, 32, 32, 32, 128, "bfloat16", True, None),
    ("beam_prefill", 4, 24, 32, 32, 128, "bfloat16", True, None),
    ("ragged_s200", 1, 200, 32, 32, 128, "bfloat16", True, None),
    ("tile_edge_s129", 1, 129, 32, 32, 128, "bfloat16", True, None),
    ("tile_edge_s255", 1, 255, 32, 32, 128, "bfloat16", True, None),
    ("engine_prompt_s1000", 1, 1000, 32, 32, 128, "bfloat16", True, None),
    ("gqa_64q_8kv", 1, 512, 64, 8, 128, "bfloat16", True, None),
    ("falcon7b_mqa", 1, 512, 71, 1, 64, "bfloat16", True, None),
    ("falcon7b_mqa_s2048", 1, 2048, 71, 1, 64, "bfloat16", True, None),
    ("bf16_window100", 1, 1024, 32, 8, 128, "bfloat16", True, 100),
    ("fp32_window128", 1, 512, 32, 8, 128, "float32", True, 128),
    ("bench_2x2048x16", 2, 2048, 16, 16, 128, "bfloat16", True, None),
    ("bench_1x8192x8", 1, 8192, 8, 8, 128, "bfloat16", True, None),
    ("bench_1x32768x4", 1, 32768, 4, 4, 128, "bfloat16", True, None),
]
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}  # (out, lse)
MAIN_SHAPE = "llama2_7b_prefill"

# (label, b, s, nq, nkv, d, dtype name, sliding_window, segment ids, dropout
# rate, lse cotangent): the training path's attention. The first is the
# main path's call (Llama-2-7B, s 4096); the others are the features and
# layouts the kernels take (segment ids give two documents a row; Falcon-7B
# trains at its 2048 positions). bf16_window100_train runs the bf16 backward
# with a window; falcon7b_mqa_extra_train holds the d 64 EXTRA
# instantiations (segment ids and dropout), the dK/dV head split of MQA
# and a ragged tail (1000 rows) in one case.
TRAIN_CASES = [
    ("llama2_7b_train", 1, 4096, 32, 32, 128, "bfloat16", None, False, 0.0,
     False),
    ("train_segments", 1, 4096, 32, 32, 128, "bfloat16", None, True, 0.0,
     False),
    ("train_dropout", 1, 4096, 32, 32, 128, "bfloat16", None, False, 0.1,
     False),
    ("train_dlse", 1, 4096, 32, 32, 128, "bfloat16", None, False, 0.0, True),
    ("gqa_64q_8kv_train", 1, 4096, 64, 8, 128, "bfloat16", None, False, 0.0,
     False),
    ("falcon7b_mqa_train", 1, 2048, 71, 1, 64, "bfloat16", None, False, 0.0,
     False),
    ("ragged_s200_train", 1, 200, 32, 32, 128, "bfloat16", None, False, 0.0,
     False),
    ("fp32_window128_train", 1, 2048, 32, 8, 128, "float32", 128, False, 0.0,
     False),
    ("bf16_window100_train", 1, 1024, 32, 8, 128, "bfloat16", 100, False,
     0.0, False),
    ("falcon7b_mqa_extra_train", 1, 1000, 71, 1, 64, "bfloat16", None, True,
     0.1, False),
]
TRAIN_MAIN_SHAPE = "llama2_7b_train"
DROPOUT_SEED = 4321
# gradient tolerance: bf16 within 2^-7 of the reference's largest magnitude
# (the kernels round their outputs to bf16 once, 2^-8 relative, on top of
# fp32 sums taken in another order); fp32 within 1e-4
GRAD_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
TRAIN_LAYERS = 8
# the fp32 training slice: loss and grads of the flash path (kernels) and
# the dot path (no kernel) agree within this share of each leaf's largest
# magnitude (fp32 on both, the same arithmetic in another order)
SLICE_TOL = 1e-4


# Block-native decode attention (csrc/block_attn.cu): (label, S, w, nq, nkv,
# hd, B, q dtype, arena dtype, lengths). Every case reads a scattered
# (permuted) block map over a region of BLOCK_CAP tokens, the engine phase's
# max_len, with one slot a length (mixed 37-1,200, BLOCK_LENGTHS); a slot
# of length 0 is idle, its map all trash. The first is the engine's decode
# shape: 8 slots of Llama-2-7B (32 heads of 128), 16-token blocks, bf16. In
# the last one slot's live keys reach the region's last key, so every
# split of the kernel's grid is live and the combine merges the most.
BLOCK_LENGTHS = [37, 64, 100, 200, 300, 515, 700, 1200]
BLOCK_CAP = 2048
BLOCK_CASES = [
    ("engine_decode", 8, 1, 32, 32, 128, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("block_64", 8, 1, 32, 32, 128, 64, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("verify_w4", 8, 4, 32, 32, 128, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("gqa_64q_8kv", 8, 1, 64, 8, 128, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("falcon7b_mqa", 8, 1, 71, 1, 64, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("fp32", 8, 1, 32, 8, 128, 16, "float32", "float32", BLOCK_LENGTHS),
    ("int8_scales", 8, 1, 32, 32, 128, 16, "bfloat16", "int8",
     BLOCK_LENGTHS),
    ("scattered_idle", 8, 1, 32, 32, 128, 16, "bfloat16", "bfloat16",
     [37, 0, 100, 200, 0, 515, 0, 1200]),
    ("full_region", 8, 1, 32, 32, 128, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS[:7] + [BLOCK_CAP - 1]),
]
BLOCK_MAIN = "engine_decode"
# the CUDA kernels of the block path, for the kernels line
BLOCK_CUDA_KERNELS = [
    "block_attn_split_kernel (split-KV grid, per-warp cp.async rings of "
    "8-key tiles, each split's (m, l, acc) to a workspace)",
    "block_attn_combine_kernel (a row's splits merged in split order, a "
    "programmatic dependent launch)"]
# max-abs tolerance by output (q) dtype. The random cases' outputs are
# softmax averages of randn values over 37-1,200 keys: a typical output is
# 0.05-0.3, the largest of a case 1-4. The bf16 limit is 4x the largest
# error seen (9.8e-4), so it still catches a dropped 32-key slice or a
# mis-masked key of a long slot; fp32 sums in another order only
BLOCK_TOL = {"bfloat16": 4e-3, "float32": 1e-4}
# the engine's live state: real activations, outputs up to ~4 (error seen:
# 3.9e-3, one bf16 rounding at 0.5-1)
BLOCK_LIVE_TOL = 1e-2

# The engine phase: Llama-2-7B at full width and depth behind the engine
# route. 16 concurrent requests: each prompt length twice, new tokens from
# 64 to 256, even requests greedy, odd ones seeded at temperature 0.8,
# top_p 0.9.
ENGINE_SERVING = dict(num_slots=8, max_len=2048, kv_block_size=16,
                      block_native_attn=True, prefill_max_batch=8)
ENGINE_PROMPTS = [37, 64, 100, 200, 300, 515, 700, 1000]
ENGINE_REQUESTS = 16


# Fused norms (csrc/fused_norms.cu): (label, shape, x dtype, scale/bias
# dtype, norms). The first three are tools/bench_kernels.py's shapes (the
# first is the kernels line's headline); then Llama-2-7B's and Falcon-7B's
# training rows, fp32, a row count no block's row group divides with fp32
# scales on bf16 rows, h 64, h 100 (rows of 200 bytes: scalar loads), 7
# rows (most of the backward's persistent blocks get no row, and their
# zero partial rows must still sum right), and two rows too wide for the
# backward's registers (its wide kernel): GPT-3 175B's h 12288, and h 4100
# (8,200 bytes: scalar loads).
NORM_CASES = [
    ("bench_4x2048x2048", (4, 2048, 2048), "bfloat16", "bfloat16",
     ("rms", "ln")),
    ("bench_2x4096x4096", (2, 4096, 4096), "bfloat16", "bfloat16",
     ("rms", "ln")),
    ("bench_8x1024x8192", (8, 1024, 8192), "bfloat16", "bfloat16",
     ("rms", "ln")),
    ("llama2_7b_train", (1, 4096, 4096), "bfloat16", "bfloat16", ("rms",)),
    ("falcon7b_train", (1, 2048, 4544), "bfloat16", "bfloat16", ("ln",)),
    ("fp32_1000x4096", (1000, 4096), "float32", "float32", ("rms", "ln")),
    ("ragged_1001x1536_fp32_scale", (1001, 1536), "bfloat16", "float32",
     ("rms", "ln")),
    ("h64_4099_rows", (4099, 64), "bfloat16", "bfloat16", ("rms", "ln")),
    ("h100_scalar_loads", (333, 100), "bfloat16", "bfloat16", ("rms", "ln")),
    ("rows7_4096", (7, 4096), "bfloat16", "bfloat16", ("rms", "ln")),
    ("wide_2048x12288", (2048, 12288), "bfloat16", "bfloat16",
     ("rms", "ln")),
    ("wide_scalar_65x4100", (65, 4100), "bfloat16", "bfloat16",
     ("rms", "ln")),
]
NORM_MAIN = "bench_4x2048x2048"
NORM_EPS = 1e-5
# max-abs tolerance as a share of the plain version's largest |value|: bf16
# one step (2^-7; both round the same fp32 result once, so only an fp32
# sum-order difference at a rounding boundary moves an element), fp32 1e-5
# (the same fp32 formulas, summed in another order). In bf16 at most
# NORM_MISMATCH of the elements may differ at all (another cast order would
# move a large share).
NORM_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
NORM_MISMATCH = 1e-3
# ~30 ms of spinning at the H100's clock: longer than the host takes to
# enqueue 20 calls of any norm variant (see cuda_time_ms)
QUEUE_SLEEP_CYCLES = 50_000_000
# The timed norm calls take their inputs in turn from copies of x and dy
# that hold at least this many bytes in all, 4x the H100's 50 MB L2, and
# keep each output until its copy comes round again: no call reads an
# input or writes an output that a recent call left in L2 (`rotating`)
NORM_ROTATION_BYTES = 4 * 50 * 2 ** 20
# the CUDA kernels of each direction, for the kernels line
NORM_CUDA_KERNELS = {
    "fwd": ["norm_fwd_rows_kernel (rows in registers behind a cp.async "
            "ring, persistent grid)",
            "norm_fwd_wide_kernel (rows over 16 values a thread, in shared "
            "memory)"],
    "bwd": ["norm_bwd_rows_kernel (rows in registers behind a cp.async "
            "ring, persistent grid, per-block partial column sums)",
            "norm_bwd_wide_kernel (rows over 16 values a thread, walked in "
            "device memory)",
            "norm_bwd_colsum_kernel (the partial rows summed in block "
            "order)"]}
# operations per element, for the bound (fp32, outside the tensor cores)
NORM_FLOPS = {("rms", "fwd"): 4, ("ln", "fwd"): 8, ("rms", "bwd"): 11,
              ("ln", "bwd"): 16}

# The int8 serving phase: Llama-2-7B with int8-resident weights behind the
# engine route with an int8 block pool; 12 concurrent requests.
INT8_SERVING = dict(ENGINE_SERVING, kv_dtype="int8")
INT8_REQUESTS = 12
# the engine's live int8 state: bf16 queries against dequantized keys, as
# BLOCK_LIVE_TOL
INT8_LIVE_TOL = 1e-2
# the W8 slice: the logprob of every token of the W8 engine's greedy
# streams, against the same tokens fed through the serial route
# (`teacher_forced_logprobs`), agree within this. A W8 activation that
# rounds the other way (its fp32 input differs by an ulp between the block
# kernel and the dot path) moves later logprobs by a few hundredths: up to
# 0.071 up to the first different token in an earlier run on the card.
# W8_FAULTS, each planted in the engine's cache reads, must exceed it
W8_LOGPROB_TOL = 0.25
# faults planted in the k scales the W8 engine's block kernel reads: the
# scales left at 1.0, and each block's scales taken from the block before
W8_FAULTS = ("k_scale_one", "k_scale_wrong_block")
# bench_decode at Llama-2-7B's width, all four arms
BENCH_DECODE_ARGS = ["--layers", "32", "--hidden", "4096", "--heads", "32",
                     "--ffn", "11008", "--vocab", "32000", "--batch", "8",
                     "--prompt", "512", "--new", "16", "--int8_weights",
                     "--int8_kv"]


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


def prompt_text(n: int, seed: int) -> str:
    """A deterministic n-character prompt (n tokens for ByteTokenizer)."""
    alphabet = "abcdefghijklmnopqrstuvwxyz ,."
    return "".join(alphabet[(seed * 7 + i * 13 + i * i) % len(alphabet)]
                   for i in range(n))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3,
                 queued: bool = False) -> float:
    """ms per call of fn between CUDA events. With `queued`, the card first
    spins for QUEUE_SLEEP_CYCLES, so the host enqueues every call before the
    first one starts: the events then time the device's work alone, not the
    host's launch rate (for kernels of tens of microseconds, which a Python
    wrapper launches no faster than the card runs them)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
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


def bound_ms(flops: float, nbytes: float, dtype_name: str):
    """The least time on the card: the larger of the operations over the
    dtype's peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def visible_pairs(s: int, window, seg) -> int:
    """(query, key) pairs a causal call sees, over the batch: the window
    and segment masks of this run's data included."""
    import torch
    pos = torch.arange(s, device="cuda")
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask = mask & (pos[:, None] - pos[None, :] < window)
    if seg is None:
        return int(mask.sum())
    return int((mask[None] & (seg[:, :, None] == seg[:, None, :])).sum())


def training_bounds(b, s, nq, nkv, d, item, dtype_name, pairs, seg, dlse):
    """(forward, dQ, dK/dV) bounds of one training call: each kernel's
    operations on this run's visible pairs (4 d, 6 d and 8 d a pair) and
    the bytes it must move (q, k, v, dout, out, dq, dk, dv, the [b, nq, s]
    fp32 row stats and the segment ids, each read or written once)."""
    seg_bytes = 4 * b * s if seg else 0
    stat_bytes = 4 * b * nq * s
    qo_bytes = item * b * s * nq * d  # one [b, s, nq, d] tensor
    kv_bytes = item * b * s * nkv * d  # one [b, s, nkv, d] tensor
    n_stats = 3 if dlse else 2  # lse, delta (, dlse)
    return (bound_ms(4 * d * pairs, 2 * qo_bytes + 2 * kv_bytes
                     + stat_bytes + seg_bytes, dtype_name),
            bound_ms(6 * d * pairs, 3 * qo_bytes + 2 * kv_bytes
                     + n_stats * stat_bytes + seg_bytes, dtype_name),
            bound_ms(8 * d * pairs, 2 * qo_bytes + 4 * kv_bytes
                     + n_stats * stat_bytes + seg_bytes, dtype_name))


def sdpa_calls(q, k, v, dout, scale, window):
    """(forward, backward) of scaled_dot_product_attention on the same
    inputs: the library yardstick for causal attention without segment
    ids or dropout."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    kw = dict(scale=scale, enable_gqa=True)
    if window:
        pos = torch.arange(q.shape[1], device="cuda")
        kw["attn_mask"] = ((pos[:, None] >= pos[None, :])
                           & (pos[:, None] - pos[None, :] < window))
    else:
        kw["is_causal"] = True

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dout_t = dout.transpose(1, 2)

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dout_t,
                                   retain_graph=True)
    return fwd, bwd


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


# kernels (by a part of their names) whose ptxas lines must show 0 spill
# bytes: the wgmma kernels, the norm kernels, and the block kernels
SPILL_FREE = ("wgmma", "norm_bwd", "norm_fwd", "block_attn")


def phase_build() -> None:
    from megatron_tpu_torch.ops import (block_attention_cuda, cuda_build,
                                        flash_attention_cuda,
                                        fused_norms_cuda)
    t0 = time.perf_counter()
    paths = cuda_build.build()
    check(len(paths) == 4, f"expected 4 kernel sources, built {list(paths)}")
    flash_attention_cuda._library("flash_fwd")
    flash_attention_cuda._library("flash_bwd")
    block_attention_cuda._library()
    fused_norms_cuda._library()
    log(f"build: {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    spilled = []
    for name, path in paths.items():
        kernel = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif ("registers" in line or "spill" in line
                  or "arning" in line):
                log(f"  ptxas {name} {kernel}: {line.strip()}")
                if (any(t in kernel for t in SPILL_FREE) and any(
                        int(n) for n in re.findall(r"(\d+) bytes spill",
                                                   line))):
                    spilled.append(kernel)
    # a wgmma kernel that spills loses its registers' worth of accumulators
    # to local memory, a norm kernel its rows and column sums, the block
    # kernel its running softmax state: the designs require none
    check(not spilled, f"kernels that must not spill registers do: "
          f"{spilled}")


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
                 ms=cuda_time_ms(kernel, queued=True),
                 plain_ms=cuda_time_ms(plain, 5, 1, queued=True),
                 library_ms=cuda_time_ms(library, queued=True),
                 bound_ms=bound_ms,
                 bound_by=bound_by)
        log("kernel check: " + json.dumps(r))
        results.append(r)
    return results


def check_dropout_bits() -> int:
    """The dropout keep bits of the forward and of both backward kernels
    against the plain hash, bit for bit, on slices of 2 batch rows and 4
    heads, each read off an output that is 0 exactly where a key is
    dropped:
    - forward (256 queries, 128 keys, d 128): with q = k = 0 every weight
      is 1/128, and with v the identity, out[b, i, h, j] = z_ij / 128;
    - dQ (d queries and keys, d 64 and 128, non-causal): with q = 0 every p
      is 1/d; with k the identity, v and dout all ones and delta 0, dS_ij =
      p z_ij d and dq[b, i, h, j] = scale z_ij;
    - dV (the same sizes): with q = k = 0 and dout the identity,
      dv[b, j, h, i] = z_ij / d.
    fp32 and bf16 each. Returns the number of bits compared."""
    import torch
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops.flash_attention import _dropout_keep
    b, nq = 2, 4
    bh = (torch.arange(b, device="cuda")[:, None, None, None] * nq
          + torch.arange(nq, device="cuda")[None, None, :, None])

    def keep(sq, sk):  # [b, sq, nq, sk]
        return _dropout_keep(
            DROPOUT_SEED, bh,
            torch.arange(sq, device="cuda")[None, :, None, None],
            torch.arange(sk, device="cuda")[None, None, None, :], 0.1)

    def differ(got, want, what):
        check(torch.equal(got, want),
              f"dropout keep bits of {what} differ from the plain hash: "
              f"{int((got != want).sum())} of {want.numel()}")
        return want.numel()

    drop = dict(dropout_rate=0.1, dropout_seed=DROPOUT_SEED)
    compared = 0
    want = keep(256, 128)
    d = 128
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(b, 256, nq, d, dtype=dtype, device="cuda")
        k = torch.zeros(b, d, nq, d, dtype=dtype, device="cuda")
        v = torch.eye(d, dtype=dtype, device="cuda")[None, :, None, :].expand(
            b, d, nq, d).contiguous()
        out, _ = fc.flash_fwd_cuda(q, k, v, causal=False, scale=d ** -0.5,
                                   **drop)
        torch.cuda.synchronize()
        compared += differ(out != 0, want, f"the forward ({dtype})")
    for d in (64, 128):
        want = keep(d, d)
        lse = torch.full((b, nq, d), math.log(d), device="cuda")
        delta = torch.zeros(b, nq, d, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            zeros = torch.zeros(b, d, nq, d, dtype=dtype, device="cuda")
            ones = torch.ones_like(zeros)
            eye = torch.eye(d, dtype=dtype, device="cuda")[
                None, :, None, :].expand(b, d, nq, d).contiguous()
            kw = dict(causal=False, scale=d ** -0.5, **drop)
            dq = fc.flash_bwd_dq_cuda(zeros, eye, ones, ones, lse, delta,
                                      **kw)
            _, dv = fc.flash_bwd_dkv_cuda(zeros, zeros, zeros, eye, lse,
                                          delta, **kw)
            torch.cuda.synchronize()
            compared += differ(dq != 0, want, f"dQ (d {d}, {dtype})")
            compared += differ(dv.permute(0, 3, 2, 1) != 0, want,
                               f"dV (d {d}, {dtype})")
    return compared


def phase_training_kernels() -> list[dict]:
    """The forward and both backward kernels against the plain versions at
    TRAIN_CASES, with times and bounds; each backward runs twice and must
    give bit-identical grads."""
    import torch
    from megatron_tpu_torch.ops import flash_attention as fa
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(99)
    results = []
    for (label, b, s, nq, nkv, d, dname, window, use_seg, rate,
         use_dlse) in TRAIN_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(b, s, nq, d, generator=gen, device="cuda").to(dtype)
        # k and v as the strided halves of one fused projection
        kv = torch.randn(b, s, 2, nkv, d, generator=gen,
                         device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
        dout = torch.randn(b, s, nq, d, generator=gen,
                           device="cuda").to(dtype)
        seg = None
        if use_seg:  # two documents a row
            seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
            seg[:, s // 2:] = 1
        dlse = (torch.randn(b, nq, s, generator=gen, device="cuda")
                if use_dlse else None)
        kw = dict(causal=True, scale=d ** -0.5, sliding_window=window,
                  segment_ids=seg, dropout_rate=rate,
                  dropout_seed=DROPOUT_SEED)
        bkw = dict(kw, dlse=dlse)

        out, lse = fc.flash_fwd_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.blockwise_attention(q, k, v, **kw)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dname]
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite out")
        check(err_out <= tol_out and err_lse <= tol_lse,
              f"{label}: forward vs plain out err {err_out} (tol "
              f"{tol_out}), lse err {err_lse} (tol {tol_lse})")

        # the backward's inputs are the plain forward's, for both versions
        delta = fa.attention_delta(ref_out, dout)

        def dq_kernel():
            return fc.flash_bwd_dq_cuda(q, k, v, dout, ref_lse, delta, **bkw)

        def dkv_kernel():
            return fc.flash_bwd_dkv_cuda(q, k, v, dout, ref_lse, delta,
                                         **bkw)

        def plain_bwd():
            return fa.blockwise_attention_bwd(q, k, v, dout, ref_lse, delta,
                                              **bkw)

        grads = (dq_kernel(), *dkv_kernel())
        torch.cuda.synchronize()
        again = (dq_kernel(), *dkv_kernel())
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in zip(grads, again)),
              f"{label}: two backward runs differ")
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain_bwd()):
            err = (got.float() - want.float()).abs().max().item()
            ref_max = want.float().abs().max().item()
            tol = (GRAD_TOL[dname] * ref_max if dname == "bfloat16"
                   else GRAD_TOL[dname])
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"{label}: {name} err {err} (tol {tol}, max |{name}| "
                  f"{ref_max})")
            errs[name] = dict(max_abs_err=err, max_abs_ref=ref_max, tol=tol)
        del grads, again

        pairs = visible_pairs(s, window, seg) * b * nq
        fwd_bound, dq_bound, dkv_bound = training_bounds(
            b, s, nq, nkv, d, q.element_size(), str(dtype), pairs,
            seg is not None, dlse is not None)
        same_as_sdpa = seg is None and not rate
        lib_fwd = lib_bwd = None
        if same_as_sdpa:
            sdpa_fwd, sdpa_bwd = sdpa_calls(q, k, v, dout, d ** -0.5, window)
            lib_fwd = cuda_time_ms(sdpa_fwd, 10, 2, queued=True)
            if dlse is None:
                lib_bwd = cuda_time_ms(sdpa_bwd, 10, 2, queued=True)
        plain_bwd_ms = cuda_time_ms(plain_bwd, 3, 1)
        r = dict(
            shape=label, b=b, s=s, nq=nq, nkv=nkv, d=d, dtype=dname,
            causal=True, sliding_window=window, segments=use_seg,
            dropout=rate, dlse=use_dlse, visible_pairs=pairs,
            fwd=dict(max_abs_err=err_out, max_abs_err_lse=err_lse,
                     ms=cuda_time_ms(lambda: fc.flash_fwd_cuda(q, k, v,
                                                               **kw), 10, 2,
                                     queued=True),
                     plain_ms=cuda_time_ms(
                         lambda: fa.blockwise_attention(q, k, v, **kw), 3, 1,
                         queued=True),
                     bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                     library_ms=lib_fwd),
            dq=dict(**errs["dq"], ms=cuda_time_ms(dq_kernel, 10, 2,
                                                  queued=True),
                    plain_ms=plain_bwd_ms, bound_ms=dq_bound[0],
                    bound_by=dq_bound[1], library_ms=lib_bwd),
            dkv=dict(max_abs_err=max(errs["dk"]["max_abs_err"],
                                     errs["dv"]["max_abs_err"]),
                     dk=errs["dk"], dv=errs["dv"],
                     ms=cuda_time_ms(dkv_kernel, 10, 2, queued=True),
                     plain_ms=plain_bwd_ms, bound_ms=dkv_bound[0],
                     bound_by=dkv_bound[1], library_ms=lib_bwd),
            bitwise_repeat=True)
        log("training kernel check: " + json.dumps(r))
        results.append(r)
        del q, kv, k, v, dout, out, lse, ref_out, ref_lse, delta
        torch.cuda.empty_cache()
    return results


def block_case_inputs(gen, S, w, nq, nkv, hd, B, qname, kvname, lens):
    """Random q, arena (with scales for int8), a permuted block map with
    the last block as trash, and the slots' lengths `lens` (a slot of
    length 0 idle, its map all trash), on the card."""
    import torch
    nb = BLOCK_CAP // B
    T = S * nb + 1
    q = torch.randn(S, w, nq, hd, generator=gen, device="cuda").to(
        getattr(torch, qname))
    ks = vs = None
    if kvname == "int8":
        ka, va = (torch.randint(-127, 128, (T, B, nkv, hd), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(T, B, nkv, 1, generator=gen, device="cuda")
                  * 0.02 for _ in range(2))
    else:
        ka, va = (torch.randn(T, B, nkv, hd, generator=gen,
                              device="cuda").to(getattr(torch, kvname))
                  for _ in range(2))
    perm = torch.randperm(T - 1, generator=gen, device="cuda")
    bmap = perm[:S * nb].reshape(S, nb).to(torch.int32)
    lengths = torch.tensor(lens[:S], dtype=torch.int32, device="cuda")
    for s, n in enumerate(lens[:S]):
        if n == 0:
            bmap[s] = T - 1
    return q, ka, va, bmap, lengths, ks, vs


def block_bound(q, ka, bmap, lengths, ks):
    """Bytes: each live key's K and V rows (and int8 scales) once, q and
    out, the live map entries and the lengths; operations: 4 hd per (query
    row, visible key). Peak by the arena's type. Returns (ms, what bounds
    it, bytes)."""
    S, w, nq, hd = q.shape
    _, B, nkv, _ = ka.shape
    cap = bmap.shape[1] * B
    keys = [min(int(n) + w, cap) for n in lengths.tolist()]
    live = sum(keys)
    nbytes = 2 * live * nkv * hd * ka.element_size()
    if ks is not None:
        nbytes += 2 * live * nkv * 4
    nbytes += 2 * q.numel() * q.element_size()
    nbytes += 4 * sum(-(-k // B) for k in keys) + 4 * S
    visible = sum(min(int(n) + j + 1, cap) for n in lengths.tolist()
                  for j in range(w))
    return (*bound_ms(4 * hd * visible * nq, nbytes, str(ka.dtype)), nbytes)


def block_copies(ka, va, ks, vs, nbytes):
    """The arena (with its scales) and copies of it, at most 16 in all,
    whose live bytes together span NORM_ROTATION_BYTES (4x the L2): a
    timed call on the next copy reads its keys from HBM, as each layer of
    a decode step does."""
    n = min(16, max(2, -(-NORM_ROTATION_BYTES // nbytes)))
    return [(ka, va, ks, vs)] + [
        tuple(None if t is None else t.clone() for t in (ka, va, ks, vs))
        for _ in range(n - 1)]


def poison_dead_blocks(ka, va, ks, vs, bmap, lengths, w):
    """Copies of the arena with NaN in every block no slot's live prefix
    maps (for int8, NaN scales): a kernel that loads none of them returns
    the same bits."""
    import torch
    B = ka.shape[1]
    live = torch.zeros(ka.shape[0], dtype=torch.bool, device=ka.device)
    for s, n in enumerate(lengths.tolist()):
        last = (min(n + w, bmap.shape[1] * B) - 1) // B
        live[bmap[s, :last + 1].long()] = True
    dead = ~live
    if ks is not None:
        ks2, vs2 = ks.clone(), vs.clone()
        ks2[dead] = float("nan")
        vs2[dead] = float("nan")
        return ka, va, ks2, vs2
    ka2, va2 = ka.clone(), va.clone()
    ka2[dead] = float("nan")
    va2[dead] = float("nan")
    return ka2, va2, ks, vs


def gathered_sdpa(q, ka, va, bmap, lengths, ks, vs, scale):
    """(gather, sdpa): the contiguous [S, cap] view of each slot's blocks
    (dequantized for int8) and scaled_dot_product_attention on it with the
    per-slot causal mask: the library yardstick, which reads no block map
    itself, so its time is reported with the gather not counted."""
    import torch
    import torch.nn.functional as F
    S, w, nq, hd = q.shape
    _, B, nkv, _ = ka.shape
    cap = bmap.shape[1] * B
    idx = bmap.long()

    def gather():
        k = ka[idx].reshape(S, cap, nkv, hd)
        v = va[idx].reshape(S, cap, nkv, hd)
        if ks is not None:
            k = k.to(q.dtype) * ks[idx].reshape(S, cap, nkv, 1).to(q.dtype)
            v = v.to(q.dtype) * vs[idx].reshape(S, cap, nkv, 1).to(q.dtype)
        return k.to(q.dtype).transpose(1, 2), v.to(q.dtype).transpose(1, 2)

    kt, vt = gather()
    qt = q.transpose(1, 2)
    pos = lengths.long()[:, None] + torch.arange(w, device=q.device)
    mask = (torch.arange(cap, device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]  # [S, 1, w, cap]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    return gather, sdpa


def phase_block_kernels() -> list[dict]:
    """The block kernel against its plain version at BLOCK_CASES, with
    times, bounds and the gathered-SDPA yardstick; every case runs twice
    (the same bits required) and again on an arena whose dead blocks are
    NaN (the same bits again). Kernel times are queued, each call on the
    next arena copy (`block_copies`)."""
    import itertools
    import torch
    from megatron_tpu_torch.ops.block_attention import (
        block_attention_reference)
    from megatron_tpu_torch.ops.block_attention_cuda import (
        block_attention_cuda, split_plan)
    from megatron_tpu_torch.ops.cuda_build import sm_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(77)
    results = []
    for (label, S, w, nq, nkv, hd, B, qname, kvname, lens) in BLOCK_CASES:
        q, ka, va, bmap, lengths, ks, vs = block_case_inputs(
            gen, S, w, nq, nkv, hd, B, qname, kvname, lens)
        scale = hd ** -0.5

        def kernel(ka=ka, va=va, ks=ks, vs=vs):
            return block_attention_cuda(q, ka, va, bmap, lengths,
                                        scale=scale, block_size=B,
                                        k_scale=ks, v_scale=vs)

        def plain():
            return block_attention_reference(q, ka, va, bmap, lengths,
                                             scale=scale, k_scale=ks,
                                             v_scale=vs)

        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BLOCK_TOL[qname]
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite out")
        check(err <= tol, f"{label}: block kernel vs plain err {err} "
              f"(tol {tol})")
        check(torch.equal(out, kernel()), f"{label}: two runs differ")
        again = kernel(*poison_dead_blocks(ka, va, ks, vs, bmap, lengths,
                                           w))
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"{label}: NaN in dead blocks changed the output")
        del again
        gather, sdpa = gathered_sdpa(q, ka, va, bmap, lengths, ks, vs,
                                     scale)
        bms, bby, nbytes = block_bound(q, ka, bmap, lengths, ks)
        copies = block_copies(ka, va, ks, vs, nbytes)
        timed = rotating([functools.partial(kernel, *c) for c in copies],
                         itertools.count(), [None] * len(copies))
        plan = split_plan(S, w, nq, nkv, bmap.shape[1], B,
                          sm_count(q.device.index))
        r = dict(shape=label, S=S, w=w, nq=nq, nkv=nkv, hd=hd,
                 block_size=B, q_dtype=qname, kv_dtype=kvname,
                 lengths=lengths.tolist(), cap=BLOCK_CAP,
                 split_plan=dataclasses.asdict(plan),
                 max_abs_err=err, max_abs_ref=ref.float().abs().max().item(),
                 tol=tol, bitwise_repeat=True, dead_blocks_nan_same_bits=True,
                 ms=cuda_time_ms(timed, queued=True),
                 arena_copies=len(copies),
                 plain_ms=cuda_time_ms(plain, 5, 1),
                 library_ms=cuda_time_ms(sdpa, queued=True),
                 library="scaled_dot_product_attention on the gathered "
                         "view, gather not counted",
                 gather_ms=cuda_time_ms(gather, queued=True), bound_ms=bms,
                 bound_by=bby)
        log("block kernel check: " + json.dumps(r))
        results.append(r)
        del q, ka, va, bmap, lengths, ks, vs, out, ref, copies, timed
        torch.cuda.empty_cache()
    return results


def norm_calls(kind, x2, dy2, scale, bias):
    """(kernel fwd, plain fwd, library fwd, kernel bwd, plain bwd, library
    bwd, kernel bwd alone) of one norm on rows x2 [rows, h]. The backward
    calls return (dx, dscale[, dbias]) with the [1, h] sums cast as the
    autograd Function casts them (the last one leaves them fp32 [1, h]);
    the library calls are torch's rms_norm / layer_norm and their autograd
    backward, with the parameters in x's dtype."""
    import torch
    import torch.nn.functional as F
    from megatron_tpu_torch.ops import fused_norms as fn
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    h = x2.shape[1]
    ln = kind == "ln"
    params = (scale, bias) if ln else (scale,)
    k_fwd = getattr(fnc, f"{kind}_fwd_cuda")
    k_bwd = getattr(fnc, f"{kind}_bwd_cuda")
    p_fwd = getattr(fn, f"{kind}_fwd_reference")
    p_bwd = getattr(fn, f"{kind}_bwd_reference")

    def summed(parts):
        dx, *sums = parts
        return (dx, *(fn.param_grad(t, scale.dtype) for t in sums))

    leaves = [t.detach().to(x2.dtype).requires_grad_(True)
              for t in (x2, *params)]
    if ln:
        lib_out = F.layer_norm(leaves[0], (h,), leaves[1], leaves[2],
                               NORM_EPS)
    else:
        lib_out = F.rms_norm(leaves[0], (h,), leaves[1], NORM_EPS)

    def lib_fwd():
        with torch.no_grad():
            if ln:
                return F.layer_norm(x2, (h,), leaves[1], leaves[2], NORM_EPS)
            return F.rms_norm(x2, (h,), leaves[1], NORM_EPS)

    def lib_bwd():
        return torch.autograd.grad(lib_out, leaves, dy2, retain_graph=True)

    return (lambda: k_fwd(x2, *params, NORM_EPS),
            lambda: p_fwd(x2, *params, NORM_EPS), lib_fwd,
            lambda: summed(k_bwd(x2, scale, dy2, NORM_EPS)),
            lambda: summed(p_bwd(x2, scale, dy2, NORM_EPS)), lib_bwd,
            lambda: k_bwd(x2, scale, dy2, NORM_EPS))


def rotating(fns, turn, keep):
    """One callable that calls fns[i] for the next i of the counter `turn`
    (shared by every rotating call of a case, so each call takes the next
    copy of the inputs, whatever arm it times) and keeps the result in
    keep[i] until i comes round again."""
    def call():
        i = next(turn) % len(fns)
        keep[i] = fns[i]()
    return call


def norm_compare(got, want, dtype_name, what, per_row=True):
    """Max-abs error of got against want within NORM_TOL of want's largest
    |value| and, for a bf16 per-row result (y, dx), at most NORM_MISMATCH
    of the elements differing; dscale and dbias are sums over every row in
    another order, so any of their elements may move by one step. Returns
    the record."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    ref_max = w.abs().max().item()
    tol = NORM_TOL[dtype_name] * ref_max
    share = (g != w).float().mean().item()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(err <= tol, f"{what}: err {err} (tol {tol}, max |ref| {ref_max})")
    if dtype_name == "bfloat16" and per_row:
        check(share <= NORM_MISMATCH, f"{what}: {share:.5f} of the elements "
              f"differ (limit {NORM_MISMATCH})")
    return dict(max_abs_err=err, max_abs_ref=ref_max, tol=tol,
                differing_share=share)


def phase_norm_kernels() -> list[dict]:
    """The four fused-norm kernels against their plain versions at
    NORM_CASES, forward and backward (dx, dscale, dbias), with times, bounds
    and torch's rms_norm / layer_norm (and their autograd backward) as the
    library yardstick. Every timed call rotates through NORM_ROTATION_BYTES
    of input copies, so the times are of HBM, not of L2."""
    import itertools
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(55)
    results = []
    for label, shape, xname, pname, kinds in NORM_CASES:
        xd, pd = getattr(torch, xname), getattr(torch, pname)
        h = shape[-1]
        x = (torch.randn(*shape, generator=gen, device="cuda") * 2
             + 0.5).to(xd)
        dy = torch.randn(*shape, generator=gen, device="cuda").to(xd)
        scale = (1 + 0.2 * torch.randn(h, generator=gen,
                                       device="cuda")).to(pd)
        bias = (0.3 * torch.randn(h, generator=gen, device="cuda")).to(pd)
        x2, dy2 = x.reshape(-1, h), dy.reshape(-1, h)
        rows = x2.shape[0]
        item, pitem = x.element_size(), scale.element_size()
        n_copies = max(2, -(-NORM_ROTATION_BYTES // (x2.nbytes + dy2.nbytes)))
        copies = [(x2, dy2)] + [(x2.clone(), dy2.clone())
                                for _ in range(n_copies - 1)]
        for kind in kinds:
            per_copy = [norm_calls(kind, xc, dyc, scale, bias)
                        for xc, dyc in copies]
            (k_fwd, p_fwd, l_fwd, k_bwd, p_bwd, l_bwd,
             k_bwd_raw) = per_copy[0]
            turn, keep = itertools.count(), [None] * n_copies
            timed = [rotating([c[j] for c in per_copy], turn, keep)
                     for j in range(7)]
            n_params = 2 if kind == "ln" else 1
            got = k_fwd()
            torch.cuda.synchronize()
            fwd = norm_compare(got, p_fwd(), xname, f"{label} {kind} fwd")
            got_b = k_bwd()
            torch.cuda.synchronize()
            again = k_bwd()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got_b, again)),
                  f"{label} {kind}: two backward runs differ")
            want_b = p_bwd()
            bwd = {name: norm_compare(g, w, xname if name == "dx" else pname,
                                      f"{label} {kind} {name}",
                                      per_row=name == "dx")
                   for name, g, w in zip(("dx", "dscale", "dbias"), got_b,
                                         want_b)}
            del got, got_b, again, want_b
            fwd_bytes = 2 * rows * h * item + n_params * h * pitem
            bwd_bytes = 3 * rows * h * item + (1 + n_params) * h * pitem
            fb = bound_ms(NORM_FLOPS[(kind, "fwd")] * rows * h, fwd_bytes,
                          "torch.float32")
            bb = bound_ms(NORM_FLOPS[(kind, "bwd")] * rows * h, bwd_bytes,
                          "torch.float32")
            (t_k_fwd, t_p_fwd, t_l_fwd, t_k_bwd, t_p_bwd, t_l_bwd,
             t_k_bwd_raw) = timed
            r = dict(
                shape=label, norm=kind, rows=rows, h=h, x_dtype=xname,
                param_dtype=pname, input_copies=n_copies,
                fwd=dict(**fwd, ms=cuda_time_ms(t_k_fwd, queued=True),
                         plain_ms=cuda_time_ms(t_p_fwd, 5, 1, queued=True),
                         library_ms=cuda_time_ms(t_l_fwd, queued=True),
                         bound_ms=fb[0],
                         bound_by=fb[1], bytes=fwd_bytes),
                bwd=dict(max_abs_err=max(v["max_abs_err"]
                                         for v in bwd.values()),
                         **bwd, ms=cuda_time_ms(t_k_bwd_raw, queued=True),
                         with_partial_sum_ms=cuda_time_ms(t_k_bwd,
                                                          queued=True),
                         plain_ms=cuda_time_ms(t_p_bwd, 5, 1, queued=True),
                         library_ms=cuda_time_ms(t_l_bwd, queued=True),
                         bound_ms=bb[0],
                         bound_by=bb[1], bytes=bwd_bytes),
                bitwise_repeat=True)
            log("norm kernel check: " + json.dumps(r))
            results.append(r)
            del per_copy, timed, keep
        del x, dy, x2, dy2, copies
        torch.cuda.empty_cache()
    return results


def forward_shapes():
    """Every bf16 forward shape of KERNEL_CASES and TRAIN_CASES as (label,
    b, s, nq, nkv, d, window, segment ids, dropout rate); training cases
    that differ only in the backward (an lse cotangent) are left out."""
    shapes = [(label, b, s, nq, nkv, d, window, False, 0.0)
              for (label, b, s, nq, nkv, d, dname, _, window) in KERNEL_CASES
              if dname == "bfloat16"]
    shapes += [(label, b, s, nq, nkv, d, window, seg, rate)
               for (label, b, s, nq, nkv, d, dname, window, seg, rate,
                    dlse) in TRAIN_CASES
               if dname == "bfloat16" and not dlse]
    return shapes


def build_old_library(old_source: str):
    """An earlier kernel source built into a temporary directory outside
    the checkout and loaded. Headers are looked up beside the source first
    (an earlier tree's csrc/ unpacked whole keeps its own headers), then in
    the current csrc/."""
    import ctypes
    import os
    import shutil
    import tempfile
    from megatron_tpu_torch.ops import cuda_build
    tmp = tempfile.mkdtemp(prefix="flash_old_")
    try:
        old_so = f"{tmp}/libflash_old.so"
        build = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             os.path.dirname(os.path.abspath(old_source)), "-I",
             str(cuda_build.CSRC), "-o", old_so, old_source],
            capture_output=True, text=True)
        check(build.returncode == 0, f"nvcc {old_source}: {build.stdout}"
              f"{build.stderr}")
        for line in build.stdout.splitlines() + build.stderr.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas (old) {line.strip()}")
        return ctypes.CDLL(old_so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compare_forward(old_source: str) -> int:
    """Before and after of the bf16 flash forward on one card: builds
    `old_source` (an earlier csrc/flash_fwd.cu with the same C interface)
    into a temporary directory outside the checkout, and times it and the
    current kernel through the same wrapper and the same queued timer at
    every shape of `forward_shapes()`, in the order old, new, new, old.
    Prints one JSON line a shape (both times, the bound, SDPA's time where
    it computes the same function, the plain version's, and the new
    kernel's error against the plain version) and exits 1 if any shape's
    new output leaves TOL."""
    import torch
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops.flash_attention import blockwise_attention
    smi = phase_device()
    new_lib = fc._library("flash_fwd")
    old_lib = build_old_library(old_source)
    old_lib.flash_fwd.argtypes = new_lib.flash_fwd.argtypes
    old_lib.flash_fwd.restype = new_lib.flash_fwd.restype
    libs = {"old": old_lib, "new": new_lib}
    original = fc._library
    gen = torch.Generator(device="cuda").manual_seed(7)
    failed = []
    for (label, b, s, nq, nkv, d, window, use_seg, rate) in forward_shapes():
        q = torch.randn(b, s, nq, d, generator=gen,
                        device="cuda").bfloat16()
        kv = torch.randn(b, s, 2, nkv, d, generator=gen,
                         device="cuda").bfloat16()
        k, v = kv[:, :, 0], kv[:, :, 1]
        seg = None
        if use_seg:
            seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
            seg[:, s // 2:] = 1
        kw = dict(causal=True, scale=d ** -0.5, sliding_window=window,
                  segment_ids=seg, dropout_rate=rate,
                  dropout_seed=DROPOUT_SEED)

        def call(which):
            fc._library = lambda name: libs[which]
            try:
                return fc.flash_fwd_cuda(q, k, v, **kw)
            finally:
                fc._library = original

        out, lse = call("new")
        torch.cuda.synchronize()
        ref_out, ref_lse = blockwise_attention(q, k, v, **kw)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        if not (err_out <= TOL["bfloat16"][0]
                and err_lse <= TOL["bfloat16"][1]):
            failed.append(label)
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(cuda_time_ms(lambda: call(which), 20, 3,
                                             queued=True))
        sdpa_ms = None
        if seg is None and not rate:
            sdpa_fwd, _ = sdpa_calls(q, k, v, q, d ** -0.5, window)
            sdpa_ms = cuda_time_ms(sdpa_fwd, 20, 3, queued=True)
        pairs = visible_pairs(s, window, seg) * b * nq
        bound = bound_ms(4 * d * pairs, 2 * (2 * b * s * nq * d
                                             + 2 * b * s * nkv * d)
                         + 4 * b * nq * s, "torch.bfloat16")
        old_ms = sum(times["old"]) / 2
        new_ms = sum(times["new"]) / 2
        r = dict(shape=label, b=b, s=s, nq=nq, nkv=nkv, d=d,
                 sliding_window=window, segments=use_seg, dropout=rate,
                 old_ms=old_ms, new_ms=new_ms, old_runs=times["old"],
                 new_runs=times["new"], speedup=old_ms / new_ms,
                 bound_ms=bound[0], bound_by=bound[1], library_ms=sdpa_ms,
                 plain_ms=cuda_time_ms(
                     lambda: blockwise_attention(q, k, v, **kw), 5, 1,
                     queued=True),
                 max_abs_err=err_out, max_abs_err_lse=err_lse, card=smi)
        log("forward before/after: " + json.dumps(r))
        del q, kv, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    check(not failed, f"new forward outside TOL at {failed}")
    return 0


class _OldBackward:
    """An earlier flash_bwd library behind the current wrapper's calls:
    where its flash_bwd_dkv predates the chunk and workspace arguments, they
    are dropped (one block then sums a whole group, as it did)."""

    def __init__(self, lib, new_lib, chunked: bool):
        self.flash_bwd_dq = lib.flash_bwd_dq
        self.flash_bwd_dq.argtypes = new_lib.flash_bwd_dq.argtypes
        self.flash_bwd_dq.restype = new_lib.flash_bwd_dq.restype
        self._dkv = lib.flash_bwd_dkv
        types = new_lib.flash_bwd_dkv.argtypes
        self._dkv.argtypes = types if chunked else types[:-3] + types[-1:]
        self._dkv.restype = new_lib.flash_bwd_dkv.restype
        self._chunked = chunked

    def flash_bwd_dkv(self, *args):
        if self._chunked:
            return self._dkv(*args)
        return self._dkv(*args[:-3], args[-1])


def compare_backward(old_source: str) -> int:
    """Before and after of the bf16 flash backward on one card: builds
    `old_source` (an earlier csrc/flash_bwd.cu; bound with its own C
    signature where that predates the dK/dV head chunks) outside the
    checkout, and times its dQ and dK/dV and the current ones through the
    same wrappers and the same queued timer at every bf16 shape of
    TRAIN_CASES, in the order old, new, new, old. Prints one JSON line a
    shape (both kernels' times old and new, their bounds, SDPA's backward
    where it computes the same function, the new grads' errors against the
    plain backward) and exits 1 if any new grad leaves GRAD_TOL."""
    import torch
    from megatron_tpu_torch.ops import flash_attention as fa
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops.cuda_build import sm_count
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    new_lib = fc._library("flash_bwd")
    with open(old_source) as f:
        chunked = "int chunks" in f.read()
    libs = {"old": _OldBackward(build_old_library(old_source), new_lib,
                                chunked),
            "new": new_lib}
    original = fc._library
    gen = torch.Generator(device="cuda").manual_seed(11)
    failed = []
    for (label, b, s, nq, nkv, d, dname, window, use_seg, rate,
         use_dlse) in TRAIN_CASES:
        if dname != "bfloat16":
            continue
        q = torch.randn(b, s, nq, d, generator=gen, device="cuda").bfloat16()
        kv = torch.randn(b, s, 2, nkv, d, generator=gen,
                         device="cuda").bfloat16()
        k, v = kv[:, :, 0], kv[:, :, 1]
        dout = torch.randn(b, s, nq, d, generator=gen,
                           device="cuda").bfloat16()
        seg = None
        if use_seg:
            seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
            seg[:, s // 2:] = 1
        dlse = (torch.randn(b, nq, s, generator=gen, device="cuda")
                if use_dlse else None)
        kw = dict(causal=True, scale=d ** -0.5, sliding_window=window,
                  segment_ids=seg, dropout_rate=rate,
                  dropout_seed=DROPOUT_SEED)
        out, lse = fa.blockwise_attention(q, k, v, **kw)
        delta = fa.attention_delta(out, dout)
        bkw = dict(kw, dlse=dlse)

        def call(which, fn):
            fc._library = lambda name: libs[which]
            try:
                return fn(q, k, v, dout, lse, delta, **bkw)
            finally:
                fc._library = original

        grads = (call("new", fc.flash_bwd_dq_cuda),
                 *call("new", fc.flash_bwd_dkv_cuda))
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads,
                                   fa.blockwise_attention_bwd(
                                       q, k, v, dout, lse, delta, **bkw)):
            err = (got.float() - want.float()).abs().max().item()
            tol = GRAD_TOL[dname] * want.float().abs().max().item()
            errs[name] = err
            if not (bool(torch.isfinite(got).all()) and err <= tol):
                failed.append(f"{label} {name}")
        del grads
        times = {(which, part): [] for which in ("old", "new")
                 for part in ("dq", "dkv")}
        for which in ("old", "new", "new", "old"):
            for part, fn in (("dq", fc.flash_bwd_dq_cuda),
                             ("dkv", fc.flash_bwd_dkv_cuda)):
                times[which, part].append(cuda_time_ms(
                    lambda: call(which, fn), 10, 2, queued=True))
        sdpa_ms = None
        if seg is None and not rate and dlse is None:
            sdpa_ms = cuda_time_ms(
                sdpa_calls(q, k, v, dout, d ** -0.5, window)[1], 10, 2,
                queued=True)
        pairs = visible_pairs(s, window, seg) * b * nq
        _, dq_bound, dkv_bound = training_bounds(
            b, s, nq, nkv, d, 2, "torch.bfloat16", pairs, seg is not None,
            dlse is not None)
        mean = {key: sum(v_) / len(v_) for key, v_ in times.items()}
        r = dict(shape=label, b=b, s=s, nq=nq, nkv=nkv, d=d,
                 sliding_window=window, segments=use_seg, dropout=rate,
                 dlse=use_dlse, visible_pairs=pairs,
                 dkv_head_chunks=fc.dkv_head_chunks(
                     b, s, nkv, nq // nkv, sm_count(q.device.index)),
                 old_dq_ms=mean["old", "dq"], new_dq_ms=mean["new", "dq"],
                 old_dkv_ms=mean["old", "dkv"],
                 new_dkv_ms=mean["new", "dkv"],
                 old_pair_ms=mean["old", "dq"] + mean["old", "dkv"],
                 new_pair_ms=mean["new", "dq"] + mean["new", "dkv"],
                 runs={f"{w}_{p}": t for (w, p), t in times.items()},
                 dq_bound_ms=dq_bound[0], dkv_bound_ms=dkv_bound[0],
                 bound_by=[dq_bound[1], dkv_bound[1]],
                 sdpa_bwd_ms=sdpa_ms, max_abs_err=errs, card=smi)
        r["pair_speedup"] = r["old_pair_ms"] / r["new_pair_ms"]
        log("backward before/after: " + json.dumps(r))
        del q, kv, k, v, dout, out, lse, delta
        torch.cuda.empty_cache()
    check(not failed, f"new backward outside GRAD_TOL at {failed}")
    return 0


def old_norm_bwd(lib, call):
    """`call` (a norm_calls backward with its cast) with an earlier
    fused_norms.cu's library in the current one's place: its
    fused_norm_bwd has the current signature, and the current wrapper lays
    it out and casts its sums as its autograd Function did."""
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    original = fnc._library
    fnc._library = lambda: lib
    try:
        return call()
    finally:
        fnc._library = original


def old_norm_fwd(lib, kind, x2, scale, bias):
    """An earlier fused_norms.cu's forward (the signature without a launch
    plan: one row group of 8 // wpr rows a block, in shared memory)
    launched as its wrapper launched it."""
    import torch
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    ln = kind == "ln"
    out = torch.empty_like(x2)
    rc = lib.fused_norm_fwd(
        x2.data_ptr(), scale.data_ptr(), bias.data_ptr() if ln else None,
        out.data_ptr(), fnc._DTYPES[x2.dtype], fnc._DTYPES[scale.dtype],
        fnc._DTYPES[bias.dtype] if ln else 0, int(ln), fnc._vec(x2, out),
        x2.shape[0], x2.shape[1],
        fnc.warps_per_row(x2.shape[1], x2.element_size()), NORM_EPS,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"old fused_norm_fwd: CUDA error {rc}")
    return out


def compare_norms(old_source: str) -> int:
    """Before and after of the fused norms on one card: builds `old_source`
    (an earlier csrc/fused_norms.cu whose fused_norm_fwd takes no launch
    plan, and whose fused_norm_bwd has the current signature) outside the
    checkout and times, at every bf16 NORM_CASES shape, its forward
    (kernels 5 and 7) against the current one, and its backward against
    the current one (kernels 6 and 8), both through the current wrapper
    and with the autograd Function's cast, each in the order
    old, new, new, old, each call on the next copy of the inputs and
    queued. Prints one JSON line a case and direction (both times, torch's
    call, the bound, the new kernel's errors against the plain version;
    for the forward also a device copy of x, the same bytes moved by
    torch's copy kernel) and exits 1 if a new result leaves NORM_TOL /
    NORM_MISMATCH."""
    import ctypes
    import itertools
    import torch
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    smi = phase_device()
    fnc._library()
    old_lib = build_old_library(old_source)
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    old_lib.fused_norm_bwd.argtypes = fnc._library().fused_norm_bwd.argtypes
    old_lib.fused_norm_bwd.restype = i
    old_lib.fused_norm_fwd.argtypes = [p] * 4 + [i] * 5 + [ll, i, i, f, p]
    old_lib.fused_norm_fwd.restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(55)
    failed = []
    for label, shape, xname, pname, kinds in NORM_CASES:
        if xname != "bfloat16":
            continue
        xd, pd = torch.bfloat16, getattr(torch, pname)
        h = shape[-1]
        x2 = ((torch.randn(*shape, generator=gen, device="cuda") * 2 + 0.5)
              .to(xd).reshape(-1, h))
        dy2 = torch.randn(*shape, generator=gen,
                          device="cuda").to(xd).reshape(-1, h)
        scale = (1 + 0.2 * torch.randn(h, generator=gen,
                                       device="cuda")).to(pd)
        bias = (0.3 * torch.randn(h, generator=gen, device="cuda")).to(pd)
        rows = x2.shape[0]
        n_copies = max(2, -(-NORM_ROTATION_BYTES // (x2.nbytes + dy2.nbytes)))
        copies = [(x2, dy2)] + [(x2.clone(), dy2.clone())
                                for _ in range(n_copies - 1)]
        for kind in kinds:
            per_copy = [norm_calls(kind, xc, dyc, scale, bias)
                        for xc, dyc in copies]
            olds = [functools.partial(old_norm_bwd, old_lib, c[3])
                    for c in per_copy]
            old_fwds = [functools.partial(old_norm_fwd, old_lib, kind, xc,
                                          scale, bias) for xc, _ in copies]
            turn, keep = itertools.count(), [None] * n_copies
            arms = {"new": rotating([c[3] for c in per_copy], turn, keep),
                    "old": rotating(olds, turn, keep),
                    "torch": rotating([c[5] for c in per_copy], turn, keep),
                    "new_fwd": rotating([c[0] for c in per_copy], turn,
                                        keep),
                    "old_fwd": rotating(old_fwds, turn, keep),
                    "torch_fwd": rotating([c[2] for c in per_copy], turn,
                                          keep)}
            # the forward
            want_y = per_copy[0][1]()
            try:
                fwd_err = norm_compare(per_copy[0][0](), want_y, xname,
                                       f"{label} {kind} fwd")
            except AssertionError as e:
                failed.append(str(e))
                fwd_err = None
            old_fwd_err = (old_fwds[0]().float()
                           - want_y.float()).abs().max().item()
            del want_y
            fwd_times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                fwd_times[which].append(
                    cuda_time_ms(arms[f"{which}_fwd"], queued=True))
            n_params = 2 if kind == "ln" else 1
            fwd_bound = bound_ms(
                NORM_FLOPS[(kind, "fwd")] * rows * h,
                2 * rows * h * 2 + n_params * h * scale.element_size(),
                "torch.float32")
            old_ms, new_ms = (sum(fwd_times["old"]) / 2,
                              sum(fwd_times["new"]) / 2)
            copy = rotating([(lambda xc=xc: torch.empty_like(xc).copy_(xc))
                             for xc, _ in copies], turn, keep)
            r = dict(shape=label, norm=kind, rows=rows, h=h,
                     param_dtype=pname, old_ms=old_ms, new_ms=new_ms,
                     old_runs=fwd_times["old"], new_runs=fwd_times["new"],
                     speedup=old_ms / new_ms,
                     torch_ms=cuda_time_ms(arms["torch_fwd"], queued=True),
                     copy_ms=cuda_time_ms(copy, queued=True),
                     bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                     new_over_bound=new_ms / fwd_bound[0],
                     plan=dataclasses.asdict(fnc.fwd_plan(rows, h, 2, sms)),
                     input_copies=n_copies, max_abs_err=fwd_err,
                     old_max_abs_err=old_fwd_err, card=smi)
            log("norm forward before/after: " + json.dumps(r))
            # the backward
            got, want = per_copy[0][3](), per_copy[0][4]()
            torch.cuda.synchronize()
            errs = {}
            for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
                try:
                    errs[name] = norm_compare(
                        g, w, xname if name == "dx" else pname,
                        f"{label} {kind} {name}", per_row=name == "dx")
                except AssertionError as e:
                    failed.append(str(e))
            old_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(olds[0](), want))
            del got, want
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                times[which].append(cuda_time_ms(arms[which], queued=True))
            torch_ms = cuda_time_ms(arms["torch"], queued=True)
            nbytes = 3 * rows * h * 2 + (2 if kind == "ln" else 1) * (
                h * scale.element_size())
            bound = bound_ms(NORM_FLOPS[(kind, "bwd")] * rows * h, nbytes,
                             "torch.float32")
            old_ms, new_ms = (sum(times["old"]) / 2, sum(times["new"]) / 2)
            plan = fnc.bwd_plan(rows, h, 2, sms)
            r = dict(shape=label, norm=kind, rows=rows, h=h, param_dtype=pname,
                     old_ms=old_ms, new_ms=new_ms, old_runs=times["old"],
                     new_runs=times["new"], speedup=old_ms / new_ms,
                     torch_ms=torch_ms, bound_ms=bound[0],
                     bound_by=bound[1], new_over_bound=new_ms / bound[0],
                     plan=dataclasses.asdict(plan), input_copies=n_copies,
                     max_abs_err=errs, old_max_abs_err=old_err, card=smi)
            log("norm backward before/after: " + json.dumps(r))
            del per_copy, olds, arms, keep
        del x2, dy2, copies
        torch.cuda.empty_cache()
    check(not failed, f"new norms outside NORM_TOL: {failed}")
    return 0


def compare_block(old_source: str) -> int:
    """Before and after of the block decode-attention kernel (kernel 4) on
    one card: builds `old_source` (an earlier csrc/block_attn.cu whose
    block_attn takes no workspace and no split plan) outside the checkout
    and times it, called as its wrapper called it, against the current
    wrapper at every BLOCK_CASES shape, in the order old, new, new, old,
    each call queued and on the next arena copy (`block_copies`). Prints
    one JSON line a case (both times, SDPA on the gathered view, the bound,
    the split plan and the new kernel's time on its neighbours, the new and
    old kernels' errors against the plain version) and exits 1 if a new
    result leaves BLOCK_TOL or differs between two runs."""
    import ctypes
    import itertools
    import torch
    from megatron_tpu_torch.ops.block_attention import (
        block_attention_reference)
    from megatron_tpu_torch.ops import block_attention_cuda as bac
    from megatron_tpu_torch.ops.block_attention_cuda import (
        _KV_DTYPES, _Q_DTYPES, _library, block_attention_cuda, split_plan)
    from megatron_tpu_torch.ops.cuda_build import sm_count
    smi = phase_device()
    _library()
    old_lib = build_old_library(old_source)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old_lib.block_attn.argtypes = ([p] * 8 + [i] * 9 + [ll] * 3
                                   + [ctypes.c_float, p])
    old_lib.block_attn.restype = i
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(77)
    failed = []
    for (label, S, w, nq, nkv, hd, B, qname, kvname, lens) in BLOCK_CASES:
        q, ka, va, bmap, lengths, ks, vs = block_case_inputs(
            gen, S, w, nq, nkv, hd, B, qname, kvname, lens)
        scale = hd ** -0.5
        nb = bmap.shape[1]

        def new(ka, va, ks, vs):
            return block_attention_cuda(q, ka, va, bmap, lengths,
                                        scale=scale, block_size=B,
                                        k_scale=ks, v_scale=vs)

        def old(ka, va, ks, vs):
            out = torch.empty(S, w, nq, hd, dtype=q.dtype, device="cuda")
            rc = old_lib.block_attn(
                q.data_ptr(), ka.data_ptr(), va.data_ptr(),
                None if ks is None else ks.data_ptr(),
                None if vs is None else vs.data_ptr(), bmap.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), _Q_DTYPES[q.dtype],
                _KV_DTYPES[ka.dtype], hd, S, w, nq, nkv, B, nb, q.stride(0),
                q.stride(1), q.stride(2), scale,
                torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"old block_attn: CUDA error {rc}")
            return out

        got = new(ka, va, ks, vs)
        torch.cuda.synchronize()
        ref = block_attention_reference(q, ka, va, bmap, lengths,
                                        scale=scale, k_scale=ks, v_scale=vs)
        err = (got.float() - ref.float()).abs().max().item()
        if not (err <= BLOCK_TOL[qname] and torch.isfinite(got).all()):
            failed.append(f"{label}: err {err}")
        if not torch.equal(got, new(ka, va, ks, vs)):
            failed.append(f"{label}: two runs differ")
        old_err = (old(ka, va, ks, vs).float()
                   - ref.float()).abs().max().item()
        bms, bby, nbytes = block_bound(q, ka, bmap, lengths, ks)
        copies = block_copies(ka, va, ks, vs, nbytes)
        turn, keep = itertools.count(), [None] * len(copies)
        arms = {name: rotating([functools.partial(fn, *c) for c in copies],
                               turn, keep)
                for name, fn in (("new", new), ("old", old))}
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(cuda_time_ms(arms[which], queued=True))
        _, sdpa = gathered_sdpa(q, ka, va, bmap, lengths, ks, vs, scale)
        old_ms, new_ms = sum(times["old"]) / 2, sum(times["new"]) / 2
        plan = split_plan(S, w, nq, nkv, nb, B, sm_count(q.device.index))
        # the new kernel on the plan's neighbours: half and twice the keys
        # a split, where they are whole blocks
        neighbours = {}
        for keys in (plan.keys // 2, plan.keys * 2):
            if keys % B or keys < B or keys > plan.cap:
                continue
            other = dataclasses.replace(plan, keys=keys,
                                        splits=-(-plan.cap // keys))
            arm = rotating([functools.partial(
                bac._run, q, c[0], c[1], bmap, lengths, scale, c[2], c[3],
                other) for c in copies], turn, keep)
            neighbours[keys] = cuda_time_ms(arm, queued=True)
        r = dict(shape=label, S=S, w=w, nq=nq, nkv=nkv, hd=hd, block_size=B,
                 q_dtype=qname, kv_dtype=kvname, lengths=lengths.tolist(),
                 old_ms=old_ms, new_ms=new_ms, old_runs=times["old"],
                 new_runs=times["new"], speedup=old_ms / new_ms,
                 library_ms=cuda_time_ms(sdpa, queued=True),
                 bound_ms=bms, bound_by=bby, new_over_bound=new_ms / bms,
                 split_plan=dataclasses.asdict(plan),
                 new_ms_by_split_keys=neighbours,
                 arena_copies=len(copies), max_abs_err=err,
                 old_max_abs_err=old_err, card=smi)
        log("block before/after: " + json.dumps(r))
        del q, ka, va, bmap, lengths, ks, vs, got, ref, copies, arms, keep
        torch.cuda.empty_cache()
    check(not failed, f"new block kernel: {failed}")
    return 0


def phase_bench_kernels() -> dict:
    """The ported tools/bench_kernels.py on the card at its full shapes
    with a few iterations: every arm must pass, and the launch counts
    (zeroed just before) of the four norm kernels and the flash forward
    must advance."""
    import contextlib
    import io
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    from megatron_tpu_torch.tools import bench_kernels
    fnc.reset_launch_counts()
    fc.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_kernels.main(["--iters", "5"])
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log("bench_kernels: " + line)
    counts = {**fnc.launch_counts(), **fc.launch_counts()}
    check(rc == 0 and "FAILED" not in text,
          f"bench_kernels exited {rc} or printed a FAILED line")
    for name in ("rms_fwd_cuda", "rms_bwd_cuda", "ln_fwd_cuda",
                 "ln_bwd_cuda", "flash_fwd_cuda"):
        check(counts[name] > 0, f"bench_kernels launched {name} no time")
    held = {(b, s, nq, d) for (_, b, s, nq, nkv, d, dname, causal, window)
            in KERNEL_CASES if dname == "bfloat16" and causal
            and window is None and nkv == nq}
    check(all(tuple(shape) in held for shape in bench_kernels.FLASH_SHAPES),
          "a bench_kernels flash shape is not among KERNEL_CASES, where the "
          "kernel is held against its plain version")
    stats = dict(seconds=secs, launches=counts,
                 lines=[ln for ln in text.splitlines() if "|" in ln])
    log("bench_kernels path: " + json.dumps(stats))
    return stats


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
    from megatron_tpu_torch.config import ServingConfig, llama2_config
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
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
    server = MegatronServer(gen, tok,
                            serving=ServingConfig(serial_fallback=True))
    httpd = server.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    text = prompt_text
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
        fc.reset_launch_counts()
        fnc.reset_launch_counts()
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
        counts = fc.launch_counts()
        norm_launches = fnc.launch_counts()
        total_launches = counts["flash_fwd_cuda"]
        check(counts["flash_bwd_dq_cuda"] == counts["flash_bwd_dkv_cuda"] == 0,
              f"serving launched a backward kernel: {counts}")
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
    stats["norm_launches"] = norm_launches
    return stats


def check_engine_slice() -> dict:
    """A 2-layer slice of the 7B width in fp32 (fp32 weights, compute and
    KV cache, TF32 off): the block-native engine (block kernel), the
    whole-region engine (dot path) and the serial route must give the same
    greedy tokens for 4 requests."""
    import torch
    from megatron_tpu_torch.config import ServingConfig, llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.models.language_model import LanguageModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    model = LanguageModel(cfg, dtype=torch.float32, seed=1)
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod,
                    kv_cache_dtype=torch.float32)
    payload = {"prompts": [prompt_text(n, 40 + i) for i, n in
                           enumerate((37, 100, 300, 515))],
               "tokens_to_generate": 32, "temperature": 0.0}
    outs = {}
    for name, serving in (("block", ServingConfig(**ENGINE_SERVING)),
                          ("region", ServingConfig(num_slots=8,
                                                   max_len=2048))):
        server = MegatronServer(gen, tok, serving=serving)
        try:
            status, body = server.handle(payload)
            check(status == 200, f"fp32 slice {name}: {status} {body}")
            outs[name] = body["segments"]
            if name == "block":
                status, body = server.handle(dict(payload, serial=True))
                check(status == 200, f"fp32 slice serial: {status} {body}")
                outs["serial"] = body["segments"]
        finally:
            server.close()
    del server, gen, model
    torch.cuda.empty_cache()
    check(outs["block"] == outs["region"] == outs["serial"],
          "fp32 slice: block-native engine, whole-region engine and serial "
          "route disagree on greedy tokens")
    return dict(requests=4, new_tokens=32, agree=True, allow_tf32=False,
                prompt_lengths=[37, 100, 300, 515])


def phase_engine(smi: str) -> dict:
    """Llama-2-7B (32 layers, random bf16 weights from a fixed seed) behind
    MegatronServer's engine route on 127.0.0.1, ServingConfig
    ENGINE_SERVING: 16 concurrent PUT /api requests from 16 threads, an
    empty payload and a /metrics read. Launch counts are zeroed just before
    the requests: every decode step must launch the block kernel once per
    layer and every prefill the flash forward once per layer. The kernel is
    then held against its plain version on the live arena, map, lengths
    and q of a real decode step of the run, and the greedy requests are
    replayed on the serial route (their agreement in bf16 is reported, not
    required)."""
    import gc
    import torch
    from megatron_tpu_torch.config import ServingConfig, llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    from megatron_tpu_torch.serving.metrics import ServingMetrics

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama2_config("7b")
    t0 = time.perf_counter()
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=0)
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod)
    server = MegatronServer(gen, tok,
                            serving=ServingConfig(**ENGINE_SERVING))
    engine = server.engine
    torch.cuda.synchronize()
    log(f"engine: Llama-2-7B, {cfg.num_layers} layers bf16, pool "
        f"{engine.pool.nbytes() / 2 ** 30:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    httpd = server.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    # capture the kernel's inputs at one decode step with >= 6 live slots
    captured = {}

    def recording(q, k_arena, v_arena, block_map, lengths, **kw):
        if not captured and int(engine._active.sum()) >= 6:
            captured.update(q=q.clone(), k=k_arena.clone(),
                            v=v_arena.clone(), map=block_map.clone(),
                            lengths=lengths.clone(), kw=kw)
        return block_attention_cuda(q, k_arena, v_arena, block_map,
                                    lengths, **kw)

    requests = []
    for i in range(ENGINE_REQUESTS):
        n = ENGINE_PROMPTS[i % len(ENGINE_PROMPTS)]
        payload = {"prompts": [prompt_text(n, 100 + i)],
                   "tokens_to_generate": 64 + (192 * i) // (
                       ENGINE_REQUESTS - 1),
                   "logprobs": True}
        if i % 2:
            payload.update(temperature=0.8, top_p=0.9, random_seed=1000 + i)
        else:
            payload.update(temperature=0.0)
        requests.append(payload)
    try:
        status, _ = put(port, {"prompts": ["warm up"],
                               "tokens_to_generate": 4,
                               "temperature": 0.0})
        check(status == 200, f"warm-up request: {status}")
        engine.metrics = ServingMetrics()  # the traffic's numbers only
        ba.block_attention_cuda = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        fnc.reset_launch_counts()
        block_attention_cuda.launches = 0
        bodies = [None] * ENGINE_REQUESTS

        def send(i):
            bodies[i] = put(port, requests[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(ENGINE_REQUESTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        empty = put(port, {})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as resp:
            mid_metrics = json.loads(resp.read())
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        # the loop records a window's step after its requests return
        settled, snap = None, None
        while True:
            snap = engine.metrics.snapshot()
            now = (snap["decode_steps"], block_attention_cuda.launches,
                   fc.launch_counts()["flash_fwd_cuda"])
            if now == settled:
                break
            settled = now
            time.sleep(0.3)
        steps, block_launches, flash_launches = settled
        norm_launches = fnc.launch_counts()
        ba.block_attention_cuda = block_attention_cuda
        peak = torch.cuda.max_memory_allocated()
        check(empty == (400, {"message": "prompts argument required"}),
              f"empty payload: {empty}")
        check("requests_received" in mid_metrics, "/metrics answer")
        generated = 0
        for i, (status, body) in enumerate(bodies):
            check(status == 200, f"engine request {i}: {status} {body}")
            seg, lps = body["segments"][0], body["logprobs"][0]
            n_prompt = ENGINE_PROMPTS[i % len(ENGINE_PROMPTS)]
            n_new = requests[i]["tokens_to_generate"]
            check(n_prompt < len(seg) <= n_prompt + n_new
                  and (len(seg) == n_prompt + n_new or seg[-1] == tok.eod),
                  f"engine request {i}: output length {len(seg)}")
            check(all(math.isfinite(x) for x in lps),
                  f"engine request {i}: non-finite logprob")
            generated += len(seg) - n_prompt
        L = cfg.num_layers
        check(steps > 0 and block_launches == L * steps,
              f"block kernel launched {block_launches} times in "
              f"{steps} decode steps of {L} layers")
        check(snap["prefill_calls"] > 0
              and flash_launches == L * snap["prefill_calls"],
              f"flash forward launched {flash_launches} times in "
              f"{snap['prefill_calls']} prefills of {L} layers")
        check(bool(captured), "no decode step ran with >= 6 live slots")

        # the kernel on the run's own state
        c = captured
        got = block_attention_cuda(c["q"], c["k"], c["v"], c["map"],
                                   c["lengths"], **c["kw"])
        ref = ba.block_attention_reference(
            c["q"], c["k"], c["v"], c["map"], c["lengths"],
            scale=c["kw"]["scale"])
        live_err = (got.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(got).all())
              and live_err <= BLOCK_LIVE_TOL,
              f"block kernel on the engine's live state: err {live_err}")
        live = dict(max_abs_err=live_err, lengths=c["lengths"].tolist(),
                    max_abs_ref=ref.float().abs().max().item(),
                    tol=BLOCK_LIVE_TOL)
        captured.clear()
        del c, got, ref

        same = 0
        greedy = [i for i in range(ENGINE_REQUESTS) if i % 2 == 0]
        for i in greedy:
            status, body = put(port, dict(requests[i], serial=True))
            check(status == 200, f"serial replay {i}: {status}")
            same += body["segments"] == bodies[i][1]["segments"]
        stats = dict(
            requests=ENGINE_REQUESTS, generated_tokens=generated,
            wall_s=wall, tokens_per_s=generated / wall,
            ttft_p50_ms=snap["ttft_p50_ms"], ttft_p99_ms=snap["ttft_p99_ms"],
            itl_p50_ms=snap["itl_p50_ms"], itl_p99_ms=snap["itl_p99_ms"],
            decode_steps=steps, prefill_calls=snap["prefill_calls"],
            prompts_per_prefill=snap["prompts_per_prefill"],
            slot_occupancy=snap["slot_occupancy"],
            peak_memory_gib=peak / 2 ** 30,
            launches=dict(block_attn=block_launches,
                          flash_fwd=flash_launches),
            norm_launches=norm_launches,
            launches_per_decode_step=block_launches / steps,
            launches_per_prefill=flash_launches / snap["prefill_calls"],
            live_state_check=live,
            greedy_equal_to_serial=f"{same}/{len(greedy)}", card=smi)
        log("engine serving: " + json.dumps(stats))
    finally:
        ba.block_attention_cuda = block_attention_cuda
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        server.close()
    del server, engine, gen, model, httpd, thread
    gc.collect()
    torch.cuda.empty_cache()
    stats["slice"] = check_engine_slice()
    log("engine slice (fp32, 2 layers): " + json.dumps(stats["slice"]))
    return stats


def check_int_mm() -> list[dict]:
    """torch._int_mm as the W8 GEMM pads it (ops/quantized.py) against the
    float64 product of the same int8 values (exact at these sizes): it must
    be exact at the decode and prefill row counts of Llama-2-7B's
    projections; at Falcon-7B's (k 4544, its fused kv projection n 128),
    whether cuBLASLt takes the shape is recorded, not required."""
    import torch
    from megatron_tpu_torch.ops.quantized import _int_mm_padded
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = []
    for model, m, k, n in (("llama2_7b", 1, 4096, 12288),
                           ("llama2_7b", 8, 4096, 22016),
                           ("llama2_7b", 16, 11008, 4096),
                           ("llama2_7b", 17, 4096, 4096),
                           ("llama2_7b", 520, 4096, 8192),
                           ("falcon7b", 8, 4544, 4544),
                           ("falcon7b", 8, 4544, 128),
                           ("falcon7b", 8, 18176, 4544)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        try:
            got = _int_mm_padded(a, b)
        except RuntimeError as e:
            check(model != "llama2_7b", f"_int_mm [{m}x{k}x{n}]: {e}")
            out.append(dict(model=model, m=m, k=k, n=n, taken=False,
                            error=str(e)[:200]))
            continue
        want = (a.double() @ b.double()).to(torch.int32)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"_int_mm [{m}x{k}x{n}] differs from the exact product")
        out.append(dict(model=model, m=m, k=k, n=n, taken=True, exact=True))
    log("int8 GEMM: torch._int_mm padded: " + json.dumps(out))
    return out


def teacher_forced_logprobs(gen, segments, prompt_lengths,
                            new_tokens: int) -> list[list[float]]:
    """The logprob of each token after its prompt in `segments`, with those
    tokens fed (not sampled) through the serial route's own prefill and
    decode steps (`_decode_fn`): the batch, prefill length and cache length
    that Generator.generate takes for these prompts, and its int8 cache."""
    import torch
    from megatron_tpu_torch.inference import generation as g
    lengths = [len(seg) for seg in segments]
    end = max(prompt_lengths) + new_tokens
    max_len = min(-(-end // 64) * 64, gen.cfg.max_position_embeddings)
    min_prompt = max(min(prompt_lengths) // g.PREFILL_BUCKET
                     * g.PREFILL_BUCKET, 1)
    toks = torch.full((len(segments), max_len), gen.pad_id, dtype=torch.int64)
    for i, seg in enumerate(segments):
        toks[i, :len(seg)] = torch.tensor(seg)
    with torch.inference_mode():
        _, lps = g._decode_fn(
            gen.params, toks.to(gen.device),
            torch.tensor(lengths, device=gen.device),
            torch.Generator(device=gen.device), cfg=gen.cfg,
            max_len=max_len, min_prompt=min_prompt, end=end,
            sp=g.SamplingParams(temperature=0.0), eos_id=gen.eos_id,
            pad_id=gen.pad_id, rope=gen.rope, kv_dtype=gen.kv_cache_dtype)
    lps = lps.cpu()
    return [lps[i, n:len(seg)].tolist()
            for i, (n, seg) in enumerate(zip(prompt_lengths, segments))]


def w8_logprob_diff(engine: dict, forced: list[list[float]],
                    prompt_lengths: list[int]) -> float:
    """The largest |logprob| difference over every generated token of every
    stream between the engine's answer and `forced`."""
    return max(abs(a - b) for n, lp, f in zip(prompt_lengths,
                                               engine["logprobs"], forced)
               for a, b in zip(lp[n:], f))


def first_differences(engine: dict, serial: dict,
                      prompt_lengths: list[int]) -> list:
    """Each stream's first generated position where the engine's and the
    serial route's greedy tokens differ (None where they are equal)."""
    return [next((i for i, (a, b) in enumerate(zip(e[n:], s_[n:]))
                  if a != b), None)
            for n, e, s_ in zip(prompt_lengths, engine["segments"],
                                serial["segments"])]


def check_int8_slice() -> dict:
    """A 2-layer slice of the 7B width in fp32, TF32 off, 4 greedy requests
    through the block-native int8 engine and the serial route: with fp32
    weights and an int8 KV cache the streams must be equal; with int8
    weights (W8) and an int8 KV cache, every generated token's logprob must
    agree within W8_LOGPROB_TOL with that token fed through the serial
    route (`teacher_forced_logprobs`: a W8 activation that rounds the other
    way between the kernel and the dot path moves later logprobs by a few
    hundredths, which swaps near-tied greedy choices of a random model, so
    the streams themselves may part). Each of W8_FAULTS, planted in the W8
    engine's cache reads, must move that difference past the tolerance.
    The block kernel is held against its plain version on a decode step's
    live int8 arena."""
    import torch
    from megatron_tpu_torch.config import ServingConfig, llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.models import attention as att
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    from megatron_tpu_torch.ops.quantized import quantize_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    model = LanguageModel(cfg, dtype=torch.float32, seed=1)
    tok = ByteTokenizer()
    new_tokens = 32
    payload = {"prompts": [prompt_text(n, 40 + i) for i, n in
                           enumerate((37, 100, 300, 515))],
               "tokens_to_generate": new_tokens, "temperature": 0.0,
               "logprobs": True}
    n_prompt = [len(tok.tokenize(t)) for t in payload["prompts"]]
    captured = {}

    def recording(q, k_arena, v_arena, block_map, lengths, **kw):
        if not captured and int((lengths > 0).sum()) >= 2:
            captured.update(q=q.clone(), k=k_arena.clone(),
                            v=v_arena.clone(), map=block_map.clone(),
                            lengths=lengths.clone(),
                            kw={k: (v.clone() if isinstance(v, torch.Tensor)
                                    else v) for k, v in kw.items()})
        return block_attention_cuda(q, k_arena, v_arena, block_map, lengths,
                                    **kw)

    attend = att.block_native_attention
    wrong = dict(k_scale_one=torch.ones_like,
                 k_scale_wrong_block=lambda ks: ks.roll(1, 0))

    def planted(fault):
        def call(*args, k_scale=None, **kw):
            return attend(*args, k_scale=wrong[fault](k_scale), **kw)
        return call

    def serve(gen, fault=None):
        server = MegatronServer(gen, tok,
                                serving=ServingConfig(**INT8_SERVING))
        ba.block_attention_cuda = recording
        if fault:
            att.block_native_attention = planted(fault)
        try:
            status, engine = server.handle(payload)
            check(status == 200, f"int8 slice engine ({fault}): {status} "
                  f"{engine}")
            if fault:
                return engine, None
            status, serial = server.handle(dict(payload, serial=True))
            check(status == 200, f"int8 slice serial: {status} {serial}")
            return engine, serial
        finally:
            ba.block_attention_cuda = block_attention_cuda
            att.block_native_attention = attend
            server.close()

    out = {}
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod,
                    kv_cache_dtype=torch.int8)
    engine, serial = serve(gen)
    check(engine["segments"] == serial["segments"],
          "int8 KV slice: the int8 engine and the int8 serial route "
          "disagree on greedy tokens")
    out["int8_kv"] = dict(equal_streams=len(payload["prompts"]))

    params = quantize_weights(model)
    gen = Generator(params, cfg, eos_id=tok.eod, pad_id=tok.eod,
                    kv_cache_dtype=torch.int8)
    engine, serial = serve(gen)
    forced = teacher_forced_logprobs(gen, engine["segments"], n_prompt,
                                     new_tokens)
    diff = w8_logprob_diff(engine, forced, n_prompt)
    firsts = first_differences(engine, serial, n_prompt)
    check(diff <= W8_LOGPROB_TOL,
          f"W8 slice: the engine's logprobs and its tokens fed through the "
          f"serial route differ by {diff} (tol {W8_LOGPROB_TOL})")
    faults = {}
    for fault in W8_FAULTS:
        bad, _ = serve(gen, fault)
        bad_forced = teacher_forced_logprobs(gen, bad["segments"], n_prompt,
                                             new_tokens)
        faults[fault] = w8_logprob_diff(bad, bad_forced, n_prompt)
        check(faults[fault] > W8_LOGPROB_TOL,
              f"W8 slice: planted fault {fault} moves the logprobs by only "
              f"{faults[fault]}, within the tolerance {W8_LOGPROB_TOL}")
    out["w8_int8_kv"] = dict(
        tokens_compared=sum(len(f) for f in forced),
        max_logprob_diff=diff, tol=W8_LOGPROB_TOL,
        first_difference_from_serial=firsts,
        equal_streams=sum(d is None for d in firsts),
        planted_fault_diff=faults)
    del gen, params
    c = captured
    check(bool(c) and c["k"].dtype == torch.int8
          and c["kw"].get("k_scale") is not None,
          "int8 slice: the block kernel never saw the int8 arena")
    got = block_attention_cuda(c["q"], c["k"], c["v"], c["map"],
                               c["lengths"], **c["kw"])
    ref = ba.block_attention_reference(
        c["q"], c["k"], c["v"], c["map"], c["lengths"],
        scale=c["kw"]["scale"], k_scale=c["kw"]["k_scale"],
        v_scale=c["kw"]["v_scale"])
    err = (got - ref).abs().max().item()
    check(err <= BLOCK_TOL["float32"],
          f"int8 slice: block kernel vs plain on the live arena err {err}")
    del model, captured, c, got, ref
    torch.cuda.empty_cache()
    return dict(requests=4, new_tokens=new_tokens, allow_tf32=False, **out,
                live_state_max_abs_err=err, tol=BLOCK_TOL["float32"])


def phase_int8(smi: str) -> dict:
    """Llama-2-7B at full width and depth with int8-resident weights
    (`quantize_weights` of random bf16 weights) behind MegatronServer's
    engine route with an int8 block pool (INT8_SERVING), INT8_REQUESTS
    concurrent requests. Launch counts are zeroed just before the requests:
    every decode step must launch the block kernel once per layer, on the
    int8 arena, and no prefill may launch the flash forward (an int8 cache
    prefills on the dot path). Then bench_decode's four arms at 7B width and
    the 2-layer fp32 int8 slice."""
    import contextlib
    import gc
    import io
    import torch
    from megatron_tpu_torch.config import ServingConfig, llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    from megatron_tpu_torch.ops.quantized import quantize_weights
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    from megatron_tpu_torch.tools import bench_decode
    from megatron_tpu_torch.tools.bench_decode import tree_bytes

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before the "
          "int8 phase: the earlier model was not freed")
    int_mm = check_int_mm()
    cfg = llama2_config("7b")
    t0 = time.perf_counter()
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=0)
    bf16_bytes = tree_bytes(model.tree())
    params = quantize_weights(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    int8_bytes = tree_bytes(params)
    tok = ByteTokenizer()
    gen = Generator(params, cfg, eos_id=tok.eod, pad_id=tok.eod)
    server = MegatronServer(gen, tok, serving=ServingConfig(**INT8_SERVING))
    engine = server.engine
    arena = engine.pool.caches.arena
    check(arena.k.dtype == torch.int8 and arena.k_scale is not None,
          "the int8 engine's pool is not an int8 arena with scales")
    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"int8 engine: Llama-2-7B, weights {bf16_bytes / 1e9:.2f} GB bf16 -> "
        f"{int8_bytes / 1e9:.2f} GB with int8 projections, pool "
        f"{engine.pool.nbytes() / 2 ** 30:.2f} GiB (scales included), "
        f"{weights_gib:.2f} GiB allocated, built in "
        f"{time.perf_counter() - t0:.1f} s")
    httpd = server.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    arenas = []

    def recording(q, k_arena, v_arena, block_map, lengths, **kw):
        if not arenas:
            arenas.append((k_arena.dtype, kw.get("k_scale") is not None))
        return block_attention_cuda(q, k_arena, v_arena, block_map, lengths,
                                    **kw)

    requests = []
    for i in range(INT8_REQUESTS):
        n = ENGINE_PROMPTS[i % len(ENGINE_PROMPTS)]
        payload = {"prompts": [prompt_text(n, 300 + i)],
                   "tokens_to_generate": 32 + (96 * i) // (
                       INT8_REQUESTS - 1),
                   "logprobs": True}
        if i % 2:
            payload.update(temperature=0.8, top_p=0.9, random_seed=2000 + i)
        else:
            payload.update(temperature=0.0)
        requests.append(payload)
    try:
        status, _ = put(port, {"prompts": ["warm up"],
                               "tokens_to_generate": 4, "temperature": 0.0})
        check(status == 200, f"int8 warm-up request: {status}")
        engine.metrics = ServingMetrics()
        ba.block_attention_cuda = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        fnc.reset_launch_counts()
        block_attention_cuda.launches = 0
        bodies = [None] * INT8_REQUESTS

        def send(i):
            bodies[i] = put(port, requests[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(INT8_REQUESTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        settled = None
        while True:
            snap = engine.metrics.snapshot()
            now = (snap["decode_steps"], block_attention_cuda.launches,
                   fc.launch_counts()["flash_fwd_cuda"])
            if now == settled:
                break
            settled = now
            time.sleep(0.3)
        steps, block_launches, flash_launches = settled
        norm_launches = fnc.launch_counts()
        ba.block_attention_cuda = block_attention_cuda
        peak = torch.cuda.max_memory_allocated()
        generated = 0
        for i, (status, body) in enumerate(bodies):
            check(status == 200, f"int8 request {i}: {status} {body}")
            seg, lps = body["segments"][0], body["logprobs"][0]
            n_prompt = ENGINE_PROMPTS[i % len(ENGINE_PROMPTS)]
            n_new = requests[i]["tokens_to_generate"]
            check(n_prompt < len(seg) <= n_prompt + n_new
                  and (len(seg) == n_prompt + n_new or seg[-1] == tok.eod),
                  f"int8 request {i}: output length {len(seg)}")
            check(all(math.isfinite(x) for x in lps),
                  f"int8 request {i}: non-finite logprob")
            generated += len(seg) - n_prompt
        L = cfg.num_layers
        check(arenas == [(torch.int8, True)],
              f"the block kernel did not read the int8 arena: {arenas}")
        check(steps > 0 and block_launches == L * steps,
              f"int8: block kernel launched {block_launches} times in "
              f"{steps} decode steps of {L} layers")
        check(snap["prefill_calls"] > 0 and flash_launches == 0,
              f"int8: flash forward launched {flash_launches} times in "
              f"{snap['prefill_calls']} prefills (an int8 cache prefills on "
              "the dot path)")
        stats = dict(
            requests=INT8_REQUESTS, generated_tokens=generated, wall_s=wall,
            tokens_per_s=generated / wall, ttft_p50_ms=snap["ttft_p50_ms"],
            ttft_p99_ms=snap["ttft_p99_ms"], itl_p50_ms=snap["itl_p50_ms"],
            itl_p99_ms=snap["itl_p99_ms"], decode_steps=steps,
            prefill_calls=snap["prefill_calls"],
            peak_memory_gib=peak / 2 ** 30,
            weights_gb=dict(bf16=bf16_bytes / 1e9, int8=int8_bytes / 1e9),
            pool_gib=engine.pool.nbytes() / 2 ** 30,
            launches=dict(block_attn=block_launches, flash_fwd=flash_launches),
            norm_launches=norm_launches,
            launches_per_decode_step=block_launches / steps,
            int_mm_checks=int_mm, card=smi)
        log("int8 engine serving: " + json.dumps(stats))
    finally:
        ba.block_attention_cuda = block_attention_cuda
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        server.close()
    del server, engine, gen, params, httpd, thread, arena
    gc.collect()
    torch.cuda.empty_cache()

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_decode.main(BENCH_DECODE_ARGS)
    text = buf.getvalue()
    for line in text.splitlines():
        log("bench_decode: " + line)
    check(rc == 0, f"bench_decode exited {rc}")
    arms = {}
    for line in text.splitlines():
        if "generate(" in line:  # not the roofline lines
            name = "bf16" if line.startswith("generate") else line.split()[0]
            arms[name] = float(line.split("-> ")[1].split()[0])
    check(set(arms) == {"bf16", "int8kv", "int8", "int8w+kv"},
          f"bench_decode arms: {sorted(arms)}")
    stats["bench_decode"] = dict(new_tokens_per_s=arms,
                                 seconds=time.perf_counter() - t0,
                                 args=BENCH_DECODE_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    stats["slice"] = check_int8_slice()
    log("int8 slice (fp32, 2 layers): " + json.dumps(stats["slice"]))
    return stats


def train_flops(cfg, n_seqs: int) -> float:
    """Model FLOPs of one training step over `n_seqs` causal sequences of
    cfg.seq_length: 6 per parameter of every matrix product per token
    (forward 2, backward 4), and 12 d per visible (q, k) pair per q-head per
    layer for attention (forward 4 d); the embedding lookup is no product."""
    h, s, hd = cfg.hidden_size, cfg.seq_length, cfg.kv_channels
    nq, nkv, ffn = cfg.num_attention_heads, cfg.num_kv_heads, \
        cfg.ffn_hidden_size
    glu = 2 if cfg.is_glu else 1
    per_layer = h * nq * hd + h * 2 * nkv * hd + nq * hd * h + \
        h * glu * ffn + ffn * h
    matmul = cfg.num_layers * per_layer + h * cfg.padded_vocab_size
    pairs = s * (s + 1) // 2
    return (6 * matmul * s * n_seqs
            + 12 * hd * pairs * nq * cfg.num_layers * n_seqs)


def check_training_slice() -> dict:
    """Loss and grads of a 2-layer slice of the 7B width, fp32 weights and
    compute, TF32 off, through the flash kernels against the kernel-free
    dot path, with two documents a row."""
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.models.language_model import (LanguageModel,
                                                          loss_fn)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    model = LanguageModel(cfg, dtype=torch.float32, seed=1, trainable=True)
    gen = torch.Generator("cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, 513), device="cuda",
                         generator=gen)
    seg = torch.zeros(1, 512, dtype=torch.int32, device="cuda")
    seg[:, 200:] = 1
    results = {}
    for impl in ("flash", "dot"):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, toks, dataclasses.replace(
            cfg, attention_impl=impl), segment_ids=seg)
        loss.backward()
        results[impl] = (loss.item(), {k: p.grad.clone() for k, p in
                                       model.named_parameters()})
    (l_flash, g_flash), (l_dot, g_dot) = results["flash"], results["dot"]
    loss_err = abs(l_flash - l_dot) / abs(l_dot)
    grad_err = max((g_flash[k] - g_dot[k]).abs().max().item()
                   / g_dot[k].abs().max().item() for k in g_dot)
    del model, results, g_flash, g_dot
    torch.cuda.empty_cache()
    check(loss_err <= SLICE_TOL and grad_err <= SLICE_TOL,
          f"2-layer 7B fp32 slice: flash vs dot loss rel err {loss_err}, "
          f"grad err {grad_err} of the leaf's largest (tol {SLICE_TOL})")
    return dict(loss_flash=l_flash, loss_dot=l_dot, loss_rel_err=loss_err,
                grad_err_of_leaf_max=grad_err, tol=SLICE_TOL,
                allow_tf32=False)


def phase_training(smi: str) -> dict:
    import gc
    import math
    import statistics

    import torch
    from megatron_tpu_torch.config import (MegatronConfig, OptimizerConfig,
                                           TrainingConfig, llama2_config)
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    from megatron_tpu_torch.training import init_train_state, make_train_step

    mcfg = llama2_config("7b", num_layers=TRAIN_LAYERS)
    check(mcfg.hidden_size == 4096 and mcfg.num_attention_heads == 32
          and mcfg.ffn_hidden_size == 11008 and mcfg.vocab_size == 32000
          and mcfg.seq_length == 4096 and mcfg.attention_impl == "flash"
          and mcfg.params_dtype == "float32"
          and mcfg.compute_dtype == "bfloat16",
          "llama2_config('7b') is not Llama-2-7B's width")
    cfg = MegatronConfig(
        model=mcfg, optimizer=OptimizerConfig(lr=3e-4, clip_grad=1.0),
        training=TrainingConfig(micro_batch_size=1, global_batch_size=2))
    n_micro, s = cfg.num_microbatches, mcfg.seq_length
    # the serving model (held in reference cycles through its HTTP server)
    # must be gone before training takes the card
    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before "
          "training: the serving model was not freed")
    t0 = time.perf_counter()
    state = init_train_state(cfg, seed=0)
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.parameters())
    state_gib = torch.cuda.memory_allocated() / 2 ** 30 - base_gib
    log(f"training model: Llama-2-7B width, {TRAIN_LAYERS} layers, "
        f"{n_params} fp32 parameters, state {state_gib:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator("cuda").manual_seed(5)
    tokens = torch.randint(0, mcfg.vocab_size, (n_micro, 1, s + 1),
                           device="cuda", generator=gen)
    seg = torch.zeros(n_micro, 1, s, dtype=torch.int32, device="cuda")
    seg[..., s // 2:] = 1
    batches = [{"tokens": tokens}, {"tokens": tokens, "segment_ids": seg},
               {"tokens": tokens}]
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    fnc.reset_launch_counts()
    steps = []
    for i, batch in enumerate(batches):
        before = fc.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = fc.launch_counts()
        rec = dict(step=i + 1, seconds=secs, lm_loss=float(m["lm_loss"]),
                   grad_norm=float(m["grad_norm"]),
                   found_inf=int(m["found_inf"]), lr=m["lr"],
                   segments="segment_ids" in batch,
                   launches={k: after[k] - before[k] for k in after})
        log("training step: " + json.dumps(rec))
        steps.append(rec)
    counts = fc.launch_counts()
    norm_launches = fnc.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del state, step, m
    torch.cuda.empty_cache()

    per_step = TRAIN_LAYERS * n_micro
    for rec in steps:
        check(all(n == per_step for n in rec["launches"].values()),
              f"step {rec['step']} launches {rec['launches']}, expected "
              f"{per_step} of each kernel")
        check(rec["found_inf"] == 0 and math.isfinite(rec["grad_norm"]),
              f"step {rec['step']}: found_inf {rec['found_inf']}, grad norm "
              f"{rec['grad_norm']}")
    losses = [rec["lm_loss"] for rec in steps]
    check(abs(losses[0] - math.log(mcfg.vocab_size)) < 1.0,
          f"first loss {losses[0]} is not near ln(32000)")
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"loss did not fall every step: {losses}")
    step_s = statistics.median(rec["seconds"] for rec in steps[1:])
    tokens_per_step = n_micro * s
    flops = train_flops(mcfg, n_micro)
    stats = dict(
        layers=TRAIN_LAYERS, seq_length=s, micro_batch_size=1,
        microbatches=n_micro, parameters=n_params, losses=losses,
        step_seconds=[rec["seconds"] for rec in steps],
        step_s_median_last2=step_s, tokens_per_s=tokens_per_step / step_s,
        model_flops_per_step=flops,
        model_flop_share_of_989tflops=flops / step_s / 989e12,
        peak_memory_gib=peak / 2 ** 30, state_gib=state_gib,
        allocated_before_gib=base_gib,
        launches=counts, norm_launches=norm_launches, card=smi)
    log("training: " + json.dumps(stats))
    stats["slice"] = check_training_slice()
    log("training slice (fp32, 2 layers, flash vs dot): "
        + json.dumps(stats["slice"]))
    return stats


# The pretraining entry point (phase 8): the port's preprocess tool and
# finetune.main at Llama-2-7B's width with PRETRAIN_LAYERS layers (fp32
# weights and Adam's two moments: a checkpoint of ~8.0 GB), on a synthetic
# corpus from PRETRAIN_SEED whose documents are shorter than a sequence.
PRETRAIN_LAYERS = 2
PRETRAIN_ITERS = 4
PRETRAIN_DOCS = 300
PRETRAIN_SEED = 0
PRETRAIN_VOCAB = 32000
# a finetuning learning rate: at the default 3e-4 with no warmup, Adam's
# first, sign-like steps on a batch of two sequences moved every logit by
# ~1 and the training loss rose on every other batch (11.19, 12.49, 10.21,
# 12.43 on the card; PERF.md §6)
PRETRAIN_LR = "3e-5"
# the resumed run's first step has the same fp32 state and batch as the
# uninterrupted run's (bit-equality expected); its second follows one Adam
# update of a state read back from the checkpoint, stated at 1e-5
PRETRAIN_LOSS3_RTOL = 1e-6
PRETRAIN_LOSS4_RTOL = 1e-5
PRETRAIN_DATA_BATCHES = 8


def pretrain_corpus(root: str) -> dict:
    """vocab.json (exactly PRETRAIN_VOCAB entries), merges.txt, a jsonl of
    PRETRAIN_DOCS random documents, and its .bin/.idx through the port's
    tools/preprocess_data.py --append_eod."""
    import os

    from megatron_tpu_torch.tools import preprocess_data, synthetic_corpus
    t0 = time.perf_counter()
    vocab_file, merge_file = synthetic_corpus.write_gpt2_vocab(
        root, PRETRAIN_VOCAB)
    with open(vocab_file) as f:
        n_vocab = len(json.load(f))
    check(n_vocab == PRETRAIN_VOCAB, f"vocab.json holds {n_vocab} entries")
    jsonl = synthetic_corpus.write_jsonl(os.path.join(root, "corpus.jsonl"),
                                         PRETRAIN_DOCS, PRETRAIN_SEED)
    t1 = time.perf_counter()
    prefix = os.path.join(root, "corpus")
    preprocess_data.main(["--input", jsonl, "--output_prefix", prefix,
                          "--tokenizer_type", "GPT2BPETokenizer",
                          "--vocab_file", vocab_file, "--merge_file",
                          merge_file, "--append_eod"])
    return dict(vocab=vocab_file, merges=merge_file,
                data=prefix + "_document", write_s=t1 - t0,
                preprocess_s=time.perf_counter() - t1)


def pretrain_argv(corpus: dict, *extra) -> list:
    return ["--model", "llama2-7b", "--num_layers", str(PRETRAIN_LAYERS),
            "--bf16", "--use_flash_attn", "--micro_batch_size", "1",
            "--global_batch_size", "2", "--reset_attention_mask",
            "--reset_position_ids", "--eod_mask_loss", "--log_interval", "1",
            "--eval_interval", "2", "--eval_iters", "1", "--train_iters",
            str(PRETRAIN_ITERS), "--lr", PRETRAIN_LR, "--split", "90,8,2",
            "--data_path",
            corpus["data"], "--tokenizer_type", "GPT2BPETokenizer",
            "--vocab_file", corpus["vocab"], "--merge_file",
            corpus["merges"], *extra]


def run_finetune(argv: list) -> dict:
    """One in-process finetune.main(argv) on the card, its launch counts
    zeroed just before. The loop's step and evaluate are wrapped to keep
    each step's batch (on the card), metrics, launches and CUDA-event time;
    nothing is synchronised until the run has ended."""
    import torch
    from megatron_tpu_torch import finetune
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.training import loop

    steps, evals = [], []
    make_step, evaluate = loop.make_train_step, loop.evaluate

    def recording_make(*a, **k):
        step = make_step(*a, **k)

        def recorded(state, batch, gen):
            it = state.iteration
            before = fc.launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            wall = time.perf_counter()
            start.record()
            state, m = step(state, batch, gen)
            stop.record()
            after = fc.launch_counts()
            steps.append(dict(iteration=it, wall=wall, start=start,
                              stop=stop, metrics=m,
                              batch={k: v.clone() for k, v in batch.items()},
                              launches={k: after[k] - before[k]
                                        for k in after}))
            return state, m
        return recorded

    def recording_evaluate(*a, **k):
        before = fc.launch_counts()
        out = evaluate(*a, **k)
        after = fc.launch_counts()
        evals.append(dict(result=out, launches={k: after[k] - before[k]
                                                for k in after}))
        return out

    loop.make_train_step, loop.evaluate = recording_make, recording_evaluate
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = finetune.main(argv)
        torch.cuda.synchronize()
    finally:
        loop.make_train_step, loop.evaluate = make_step, evaluate
    seconds = time.perf_counter() - t0
    check(rc == 0, f"finetune.main returned {rc}")
    for i, rec in enumerate(steps):
        m = rec.pop("metrics")
        rec.update(lm_loss=float(m["lm_loss"]),
                   grad_norm=float(m["grad_norm"]),
                   found_inf=int(m["found_inf"]),
                   device_ms=rec.pop("start").elapsed_time(rec.pop("stop")))
        nxt = steps[i + 1]["wall"] if i + 1 < len(steps) else None
        rec["wall_to_next_s"] = None if nxt is None else nxt - rec["wall"]
    for rec in steps:
        rec.pop("wall")
    return dict(steps=steps, evals=evals, launches=fc.launch_counts(),
                seconds=seconds)


def data_seconds_per_batch(argv: list) -> float:
    """Host seconds per batch of the data path finetune.main builds (index
    mappings cached, tokenizer built): BatchIterator.__next__ alone."""
    import dataclasses as dc

    from megatron_tpu_torch.arguments import parse_cli
    from megatron_tpu_torch.data import build_tokenizer
    from megatron_tpu_torch.finetune import build_data
    cfg, _ = parse_cli(argv)
    tok = build_tokenizer(cfg.data.tokenizer_type,
                          vocab_file=cfg.data.vocab_file,
                          merge_file=cfg.data.merge_file)
    cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                           vocab_size=tok.vocab_size))
    it = build_data(cfg, tok, 0)[0]
    next(it)
    t0 = time.perf_counter()
    for _ in range(PRETRAIN_DATA_BATCHES):
        next(it)
    return (time.perf_counter() - t0) / PRETRAIN_DATA_BATCHES


def segment_cost(seg) -> dict:
    """ms of the flash forward, dQ and dK/dV kernels at the pretrain
    shape (b 1, s 4096, 32 heads, d 128, bf16, causal, random q, k, v, dO)
    with the segment ids of a real batch row `seg` [1, s] against none,
    each timed queued; the visible pairs with those ids beside the causal
    count."""
    import torch
    from megatron_tpu_torch.ops import flash_attention as fa
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    s = seg.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, dout = (torch.randn(1, s, 32, 128, generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    out = {}
    for name, ids in (("none", None), ("real", seg.to(torch.int32))):
        kw = dict(causal=True, scale=128 ** -0.5, segment_ids=ids)
        o, lse = fc.flash_fwd_cuda(q, k, v, **kw)
        delta = fa.attention_delta(o, dout)
        out[name] = dict(
            fwd_ms=cuda_time_ms(lambda: fc.flash_fwd_cuda(q, k, v, **kw),
                                10, 2, queued=True),
            dq_ms=cuda_time_ms(lambda: fc.flash_bwd_dq_cuda(
                q, k, v, dout, lse, delta, **kw), 10, 2, queued=True),
            dkv_ms=cuda_time_ms(lambda: fc.flash_bwd_dkv_cuda(
                q, k, v, dout, lse, delta, **kw), 10, 2, queued=True),
            visible_pairs=visible_pairs(s, None, ids))
    out["segments"] = int(seg.max()) + 1
    return out


def phase_pretrain(smi: str) -> dict:
    """Phase 8: corpus -> preprocess -> finetune.main three times (U: 4
    iterations; A: --save D --exit_interval 2; B: --load D, 4 iterations),
    with the exact-resume and launch checks."""
    import gc
    import os
    import shutil

    import torch
    from megatron_tpu_torch.arguments import parse_cli
    from megatron_tpu_torch.ops import block_attention_cuda as bac
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    from megatron_tpu_torch.resilience import integrity
    from megatron_tpu_torch.training import checkpointing as ckpt

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before the "
          "pretrain phase: the training model was not freed")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_pretrain")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ckpt_dir = os.path.join(root, "D")
    try:
        corpus = pretrain_corpus(root)
        log(f"pretrain corpus: {PRETRAIN_DOCS} documents, vocab "
            f"{PRETRAIN_VOCAB}, written in {corpus['write_s']:.2f} s, "
            f"preprocessed in {corpus['preprocess_s']:.2f} s")
        cfg, _ = parse_cli(pretrain_argv(corpus))
        host_s = data_seconds_per_batch(pretrain_argv(corpus))
        torch.cuda.reset_peak_memory_stats()
        # the flash counts are zeroed before each run (run_finetune), the
        # norm and block kernels' once before the three
        fnc.reset_launch_counts()
        bac.block_attention_cuda.launches = 0
        runs = {}
        for name, extra in (
                ("U", ()),
                ("A", ("--save", ckpt_dir, "--exit_interval", "2")),
                ("B", ("--load", ckpt_dir))):
            runs[name] = run_finetune(pretrain_argv(corpus, *extra))
            gc.collect()
            torch.cuda.empty_cache()
            if name == "A":
                save = dict(ckpt.last_save)
                t0 = time.perf_counter()
                ok, why = integrity.verify_checkpoint(save["dir"])
                save["verify_s"] = time.perf_counter() - t0
                check(ok and why == "ok", f"checkpoint manifest: {why}")
                with open(os.path.join(save["dir"], "metadata.json")) as f:
                    meta = json.load(f)
                check(meta["consumed_samples"] == 4 and meta["iteration"] == 2
                      and meta.get("data_state"),
                      f"checkpoint metadata {meta}")
            if name == "B":
                load = dict(ckpt.last_load)
            log(f"pretrain run {name}: " + json.dumps(dict(
                seconds=runs[name]["seconds"],
                launches=runs[name]["launches"],
                steps=[{k: v for k, v in r.items() if k != "batch"}
                       for r in runs[name]["steps"]],
                evals=runs[name]["evals"])))
        peak = torch.cuda.max_memory_allocated()
        norm_launches = fnc.launch_counts()
        block_launches = bac.block_attention_cuda.launches
    finally:
        shutil.rmtree(root, ignore_errors=True)

    per_step = cfg.model.num_layers * cfg.num_microbatches
    for name, run in runs.items():
        for rec in run["steps"]:
            check(all(n == per_step for n in rec["launches"].values()),
                  f"run {name} iteration {rec['iteration'] + 1} launches "
                  f"{rec['launches']}, expected {per_step} of each kernel")
            check(rec["found_inf"] == 0 and math.isfinite(rec["grad_norm"]),
                  f"run {name}: found_inf {rec['found_inf']}, grad norm "
                  f"{rec['grad_norm']}")
        for ev in run["evals"]:
            check(ev["launches"] == {"flash_fwd_cuda": per_step,
                                     "flash_bwd_dq_cuda": 0,
                                     "flash_bwd_dkv_cuda": 0},
                  f"run {name} evaluation launches {ev['launches']}")
        n_steps, n_evals = len(run["steps"]), len(run["evals"])
        check(run["launches"] == {
            "flash_fwd_cuda": per_step * (n_steps + n_evals),
            "flash_bwd_dq_cuda": per_step * n_steps,
            "flash_bwd_dkv_cuda": per_step * n_steps},
            f"run {name} launches {run['launches']} over {n_steps} steps "
            f"and {n_evals} evaluations")
    u, a, b = runs["U"]["steps"], runs["A"]["steps"], runs["B"]["steps"]
    check([r["iteration"] for r in u] == [0, 1, 2, 3]
          and [r["iteration"] for r in a] == [0, 1]
          and [r["iteration"] for r in b] == [2, 3],
          "iterations run: U "
          f"{[r['iteration'] for r in u]}, A {[r['iteration'] for r in a]}, "
          f"B {[r['iteration'] for r in b]}")
    for ru, rb in zip(u[2:], b):
        check(sorted(ru["batch"]) == sorted(rb["batch"]) and all(
            torch.equal(ru["batch"][k], rb["batch"][k]) for k in ru["batch"]),
              f"resumed batch at iteration {rb['iteration'] + 1} differs "
              "from the uninterrupted run's")
    segments = max(int(r["batch"]["segment_ids"].max()) + 1 for r in u)
    check(segments > 1, "no batch carried more than one segment per row")
    losses = [r["lm_loss"] for r in u]
    err3 = abs(b[0]["lm_loss"] - u[2]["lm_loss"]) / abs(u[2]["lm_loss"])
    err4 = abs(b[1]["lm_loss"] - u[3]["lm_loss"]) / abs(u[3]["lm_loss"])
    check(err3 <= PRETRAIN_LOSS3_RTOL, f"resumed iteration-3 loss "
          f"{b[0]['lm_loss']} vs {u[2]['lm_loss']} (rel {err3})")
    check(err4 <= PRETRAIN_LOSS4_RTOL, f"resumed iteration-4 loss "
          f"{b[1]['lm_loss']} vs {u[3]['lm_loss']} (rel {err4})")
    check(abs(losses[0] - math.log(PRETRAIN_VOCAB)) < 1.0,
          f"first loss {losses[0]} is not near ln({PRETRAIN_VOCAB})")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    seg_row = max((r["batch"]["segment_ids"][0] for r in u),
                   key=lambda t: int(t.max()))
    seg_cost = segment_cost(seg_row)
    for run in runs.values():
        for rec in run["steps"]:
            del rec["batch"]
    # U's steps after the first (which pays the allocator's and cuBLAS's
    # first-use costs); the events bracket the step alone, not evaluation
    device_ms = [r["device_ms"] for r in u[1:]]
    step_s = sorted(device_ms)[len(device_ms) // 2] / 1e3
    tokens_per_step = cfg.training.global_batch_size * cfg.model.seq_length
    stats = dict(
        layers=PRETRAIN_LAYERS, iterations=PRETRAIN_ITERS,
        u_losses=losses, b_losses=[r["lm_loss"] for r in b],
        loss3_rel_err=err3, loss4_rel_err=err4,
        loss_rtol=dict(iteration3=PRETRAIN_LOSS3_RTOL,
                       iteration4=PRETRAIN_LOSS4_RTOL),
        max_segments_per_row=segments,
        u_step_device_ms=[r["device_ms"] for r in u],
        u_step_wall_to_next_s=[r["wall_to_next_s"] for r in u],
        u_step_s_median=step_s, u_tokens_per_s=tokens_per_step / step_s,
        data_host_s_per_batch=host_s,
        checkpoint=dict(bytes=save["bytes"], payload_s=save["payload_s"],
                        manifest_s=save["manifest_s"],
                        verify_s=save["verify_s"],
                        load_verify_s=load["verify_s"],
                        load_read_s=load["read_s"]),
        run_seconds={k: v["seconds"] for k, v in runs.items()},
        launches={k: v["launches"] for k, v in runs.items()},
        norm_launches=norm_launches, block_launches=block_launches,
        peak_memory_gib=peak / 2 ** 30,
        segment_cost=seg_cost,
        corpus_preprocess_s=corpus["preprocess_s"], card=smi)
    log("pretrain: " + json.dumps(stats))
    return stats


# The weight toolchain (phase 9): HF directories in the published layouts of
# Llama-2-7B and Falcon-7B at full width, cut to TOOLCHAIN_LAYERS layers (the
# cut phase 8 makes, for bytes and time), with random bf16 weights from
# TOOLCHAIN_SEED, imported, served, finetuned and exported by the port's
# tools. The config.json of each is the published one (meta-llama/
# Llama-2-7b-hf, tiiuae/falcon-7b) with the layer count cut and the dtype of
# the random weights.
TOOLCHAIN_LAYERS = 2
TOOLCHAIN_SEED = 0
TOOLCHAIN_NEW_TOKENS = 16
TOOLCHAIN_ENGINE_REQUESTS = 8
TOOLCHAIN_FT_ITERS = 2
LLAMA2_7B_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 11008,
    "max_position_embeddings": 4096, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": TOOLCHAIN_LAYERS,
    "num_key_value_heads": 32, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000}
FALCON_7B_HF_CONFIG = {
    "alibi": False, "apply_residual_connection_post_layernorm": False,
    "architectures": ["FalconForCausalLM"], "attention_dropout": 0.0,
    "bias": False, "bos_token_id": 11, "eos_token_id": 11,
    "hidden_dropout": 0.0, "hidden_size": 4544, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "model_type": "falcon",
    "multi_query": True, "new_decoder_architecture": False,
    "num_attention_heads": 71, "num_hidden_layers": TOOLCHAIN_LAYERS,
    "parallel_attn": True, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 65024}
TOOLCHAIN_PROMPTS = ["the quick brown fox jumps over the lazy dog",
                     "one two three four five six seven eight nine ten "
                     "eleven twelve thirteen fourteen fifteen",
                     "a b c d e f g h i j k l m n o p q r s t u v w x y z "
                     "and then the alphabet starts again with a b c"]


def falcon_tensor_names(cfg) -> list:
    """[(name, shape)] of FalconForCausalLM's checkpoint (7B layout: fused
    multi-query QKV, one input_layernorm, the LM head tied and not
    stored), in its order."""
    h, hd, f = cfg.hidden_size, cfg.kv_channels, cfg.ffn_hidden_size
    qkv = (cfg.num_attention_heads + 2 * cfg.num_kv_heads) * hd
    names = [("transformer.word_embeddings.weight", (cfg.vocab_size, h))]
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        names += [(p + "self_attention.query_key_value.weight", (qkv, h)),
                  (p + "self_attention.dense.weight", (h, h)),
                  (p + "mlp.dense_h_to_4h.weight", (f, h)),
                  (p + "mlp.dense_4h_to_h.weight", (h, f)),
                  (p + "input_layernorm.weight", (h,)),
                  (p + "input_layernorm.bias", (h,))]
    return names + [("transformer.ln_f.weight", (h,)),
                    ("transformer.ln_f.bias", (h,))]


def write_hf_dir(out_dir: str, names: list, config: dict, seed: int) -> dict:
    """An HF directory as the published 7B checkpoints ship: config.json,
    model-0000{1,2}-of-00002.safetensors split at half the bytes, and
    model.safetensors.index.json. Each tensor is drawn from one numpy
    stream, uniform with a standard deviation of 0.02 (numpy draws it
    faster than a normal; norm gains about 1), rounded to bf16 and streamed
    to its shard. Returns bytes and seconds."""
    import os
    import struct

    import numpy as np
    import torch
    t0 = time.perf_counter()
    os.makedirs(out_dir)
    sizes = [2 * math.prod(shape) for _, shape in names]
    cut = next(i for i in range(len(sizes))
               if 2 * sum(sizes[:i + 1]) >= sum(sizes)) + 1
    rng = np.random.default_rng(seed)
    weight_map = {}
    for k, part in enumerate((names[:cut], names[cut:])):
        file = f"model-{k + 1:05d}-of-00002.safetensors"
        header, off = {}, 0
        for name, shape in part:
            n = 2 * math.prod(shape)
            header[name] = {"dtype": "BF16", "shape": list(shape),
                            "data_offsets": [off, off + n]}
            weight_map[name], off = file, off + n
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(out_dir, file), "wb") as f:
            f.write(struct.pack("<Q", len(raw)) + raw)
            for name, shape in part:
                x = rng.random(shape, dtype=np.float32)
                x -= np.float32(0.5)
                x *= np.float32(0.02 * 12 ** 0.5)
                if name.endswith(("norm.weight", "ln_f.weight")):
                    x += np.float32(1.0)
                f.write(torch.from_numpy(x).to(torch.bfloat16)
                        .view(torch.int16).numpy().tobytes())
    with open(os.path.join(out_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes)},
                   "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return dict(bytes=sum(sizes), seconds=time.perf_counter() - t0)


def flat_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(flat_leaves(v, key) if isinstance(v, dict) else {key: v})
    return out


def check_same_params(tree: dict, state: dict, what: str) -> None:
    """A converter's tree against a state dict (tensors or arrays), leaf for
    leaf, bit for bit."""
    import numpy as np
    got = flat_leaves(tree)
    check(sorted(got) == sorted(state), f"{what}: leaves differ: "
          f"{sorted(set(got) ^ set(state))[:4]}")
    for k, want in state.items():
        want = (want.detach().cpu().numpy() if hasattr(want, "detach")
                else want)
        check(got[k].dtype == want.dtype and np.array_equal(got[k], want),
              f"{what}: {k} differs")


def check_export(hf_dir: str, out_dir: str, family: str) -> int:
    """Every exported tensor equals the input's, upcast to fp32, bit for
    bit (a tied LM head equals the embedding). Returns the tensors
    compared."""
    import numpy as np
    from megatron_tpu_torch.convert import hf_io
    with hf_io.HFStateDict(hf_dir) as src, hf_io.HFStateDict(out_dir) as out:
        names = set(src)
        if family == "falcon":
            names.add("lm_head.weight")
        check(set(out) == names, f"{family} export holds "
              f"{sorted(set(out) ^ names)[:4]} beside the input's tensors")
        for name in out:
            want = src[name if name in src
                       else "transformer.word_embeddings.weight"]
            got = out[name]
            check(got.dtype == np.float32 and np.array_equal(got, want),
                  f"{family} export: {name} is not the input upcast")
    return len(names)


def serve_tool(argv: list):
    """run_text_generation_server.main(argv) on a thread; returns (server,
    httpd, thread, seconds to bind) once it listens."""
    from megatron_tpu_torch.tools import run_text_generation_server as srv
    held, errors = {}, []
    ready = threading.Event()

    def on_ready(server, httpd):
        held.update(server=server, httpd=httpd)
        ready.set()

    def run():
        try:
            srv.main(argv, ready=on_ready)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
            ready.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    ready.wait(600)
    if errors:
        raise errors[0]
    check(bool(held), "the server did not start in 600 s")
    return held["server"], held["httpd"], thread, time.perf_counter() - t0


def stop_tool(httpd, thread) -> None:
    httpd.shutdown()
    thread.join(60)
    check(not thread.is_alive(), "the server thread did not stop")


def zero_counts() -> None:
    from megatron_tpu_torch.ops import block_attention_cuda as bac
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    fc.reset_launch_counts()
    fnc.reset_launch_counts()
    bac.block_attention_cuda.launches = 0


def read_counts() -> dict:
    from megatron_tpu_torch.ops import block_attention_cuda as bac
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    return dict(fc.launch_counts(),
                block_attention_cuda=bac.block_attention_cuda.launches,
                **fnc.launch_counts())


def serve_checkpoint(family: str, ckpt_dir: str, model, cfg, tok_files,
                     tok) -> dict:
    """Serve the release checkpoint through run_text_generation_server:
    --serial (greedy requests equal to an in-process Generator on the
    imported model, and one text_generation_cli request), then the engine
    with a block pool (TOOLCHAIN_ENGINE_REQUESTS concurrent requests: all
    200 with finite logprobs, the flash forward once per layer per prefill
    and the block kernel once per layer per decode step)."""
    import os

    import torch
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    L = cfg.num_layers
    argv = ["--load", ckpt_dir, "--tokenizer_type", "GPT2BPETokenizer",
            "--vocab_file", tok_files[0], "--merge_file", tok_files[1],
            "--host", "127.0.0.1", "--port", "0"]
    stats = dict(launches={})
    server, httpd, thread, stats["serial_start_s"] = serve_tool(
        argv + ["--serial"])
    port = httpd.server_address[1]
    try:
        check(server.engine is None, "--serial built an engine")
        zero_counts()
        served = []
        for prompt in TOOLCHAIN_PROMPTS:
            status, body = put(port, {"prompts": [prompt], "temperature": 0.0,
                                      "tokens_to_generate":
                                          TOOLCHAIN_NEW_TOKENS})
            check(status == 200, f"{family} serial request: {status} {body}")
            served.append(body["segments"][0])
        counts = read_counts()
        stats["launches"]["serial"] = counts
        check(counts["flash_fwd_cuda"] >= L * len(TOOLCHAIN_PROMPTS),
              f"{family} serial route: flash launches {counts}")
        cli = subprocess.run(
            [sys.executable, "-m",
             "megatron_tpu_torch.tools.text_generation_cli",
             f"127.0.0.1:{port}"], input=f"{TOOLCHAIN_PROMPTS[0]}\n8\n",
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(cli.returncode == 0 and "Megatron Response:" in cli.stdout,
              f"text_generation_cli: rc {cli.returncode} {cli.stdout[-300:]}"
              f" {cli.stderr[-300:]}")
    finally:
        stop_tool(httpd, thread)
    gen = Generator(model, cfg, eos_id=tok.eod)
    for prompt, seg in zip(TOOLCHAIN_PROMPTS, served):
        toks, lens, _ = gen.generate([tok.tokenize(prompt)],
                                     TOOLCHAIN_NEW_TOKENS,
                                     SamplingParams(temperature=0.0))
        check(seg == [int(t) for t in toks[0, :lens[0]]],
              f"{family}: served greedy tokens differ from the in-process "
              "Generator's")
    del gen, server
    torch.cuda.empty_cache()

    server, httpd, thread, stats["engine_start_s"] = serve_tool(
        argv + ["--kv_block_size", "16"])
    port = httpd.server_address[1]
    try:
        engine = server.engine
        check(engine is not None and server.serving.block_native_attn,
              f"{family}: no block-native engine")
        stats["num_slots"] = server.serving.num_slots
        engine.metrics = ServingMetrics()
        zero_counts()
        bodies = [None] * TOOLCHAIN_ENGINE_REQUESTS

        def send(i):
            words = TOOLCHAIN_PROMPTS[i % 3].split()
            bodies[i] = put(port, {
                "prompts": [" ".join(words * (1 + 2 * i))],
                "tokens_to_generate": 8 + 8 * i, "logprobs": True,
                **({"temperature": 0.0} if i % 2 == 0 else
                   {"temperature": 0.8, "top_p": 0.9,
                    "random_seed": 100 + i})})

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(TOOLCHAIN_ENGINE_REQUESTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        stats["engine_wall_s"] = time.perf_counter() - t0
        settled = None
        while True:  # the loop records a step after its requests return
            snap = engine.metrics.snapshot()
            now = (snap["decode_steps"], snap["prefill_calls"],
                   read_counts())
            if now == settled:
                break
            settled = now
            time.sleep(0.3)
        steps, prefills, counts = settled
        stats["launches"]["engine"] = counts
        stats.update(decode_steps=steps, prefill_calls=prefills)
        for i, answer in enumerate(bodies):
            check(answer is not None and answer[0] == 200,
                  f"{family} engine request {i}: {answer}")
            check(all(math.isfinite(x) for x in answer[1]["logprobs"][0]),
                  f"{family} engine request {i}: non-finite logprob")
        check(steps > 0 and counts["block_attention_cuda"] == L * steps,
              f"{family} engine: block kernel {counts} in {steps} decode "
              f"steps of {L} layers")
        check(prefills > 0 and counts["flash_fwd_cuda"] == L * prefills,
              f"{family} engine: flash forward {counts} in {prefills} "
              f"prefills of {L} layers")
    finally:
        stop_tool(httpd, thread)
    return stats


def import_release(family, hf_dir, out, cfg) -> tuple:
    """tools/convert_hf_checkpoint import of `hf_dir` into `out`, then an
    export beside it and its checks. Returns (model, stats)."""
    import os
    import shutil

    from megatron_tpu_torch.tools import convert_hf_checkpoint as tool
    from megatron_tpu_torch.training import checkpointing as ckpt
    _, model = tool.do_import(tool.parse_args(
        ["import", "--hf_path", hf_dir, "--out", out, "--family", family]),
        cfg)
    stats = dict(tool.last_import, save=dict(ckpt.last_save))
    stats.pop("dir")
    export_dir = out + "_hf"
    tool.do_export(tool.parse_args(["export", "--load", out, "--hf_out",
                                    export_dir, "--family", family]))
    stats["export"] = dict(tool.last_export)
    t0 = time.perf_counter()
    stats["export"]["tensors_equal"] = check_export(hf_dir, export_dir,
                                                    family)
    check_same_params(tool.read_hf_params(export_dir, family, cfg),
                      model.state_dict(), f"{family} re-import")
    stats["export"]["check_s"] = time.perf_counter() - t0
    shutil.rmtree(export_dir)
    stats["checkpoint_bytes"] = sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, files in os.walk(out) for f in files)
    return model, stats


def finetune_release(ckpt_dir: str, root: str, corpus: dict, cfg) -> dict:
    """finetune.main --load the release --finetune --use_checkpoint_args
    --no_save_optim for TOOLCHAIN_FT_ITERS iterations; then its checkpoint
    is exported, re-imported and compared, and compare_loss_curves reads
    the run's log."""
    import logging
    import os
    import shutil

    from megatron_tpu_torch.tools import compare_loss_curves
    from megatron_tpu_torch.tools import convert_hf_checkpoint as tool
    from megatron_tpu_torch.training import checkpointing as ckpt
    ft_dir = os.path.join(root, "llama_ft")
    log_file = os.path.join(root, "finetune.log")
    argv = pretrain_argv(
        corpus, "--load", ckpt_dir, "--finetune", "--use_checkpoint_args",
        "--no_save_optim", "--save", ft_dir, "--save_interval",
        str(TOOLCHAIN_FT_ITERS), "--train_iters", str(TOOLCHAIN_FT_ITERS),
        "--eval_interval", "1000", "--lr", "3e-5")
    handler = logging.FileHandler(log_file)
    logger = logging.getLogger("megatron_tpu_torch")
    logger.addHandler(handler)
    try:
        run = run_finetune(argv)
    finally:
        logger.removeHandler(handler)
        handler.close()
    per_step = cfg.num_layers * 2  # global batch 2 of micro-batch 1
    for rec in run["steps"]:
        check(math.isfinite(rec["lm_loss"]) and rec["found_inf"] == 0,
              f"finetune iteration {rec['iteration'] + 1}: loss "
              f"{rec['lm_loss']}, found_inf {rec['found_inf']}")
        check(all(n == per_step for n in rec["launches"].values()),
              f"finetune iteration {rec['iteration'] + 1} launches "
              f"{rec['launches']}, expected {per_step} of each kernel")
    check(len(run["steps"]) == TOOLCHAIN_FT_ITERS and not run["evals"],
          f"finetune ran {len(run['steps'])} steps, {len(run['evals'])} "
          "evaluations")
    check(compare_loss_curves.main([log_file, log_file, "--quiet"]) == 0,
          "compare_loss_curves of the finetune log against itself")
    save = dict(ckpt.last_save)
    export_dir = os.path.join(root, "llama_ft_hf")
    tool.do_export(tool.parse_args(["export", "--load", ft_dir, "--hf_out",
                                    export_dir, "--family", "llama"]))
    flat = ckpt.read_params(ckpt.tracked_dir(ft_dir))
    check_same_params(tool.read_hf_params(export_dir, "llama", cfg),
                      {k.replace("/", "."): v for k, v in flat.items()},
                      "finetuned re-import")
    export = dict(tool.last_export)
    for d in (ft_dir, export_dir):
        shutil.rmtree(d)
    for rec in run["steps"]:
        rec.pop("batch")
    return dict(losses=[r["lm_loss"] for r in run["steps"]],
                launches=read_counts(), seconds=run["seconds"],
                steps=run["steps"], save=save, export=export)


def phase_toolchain(smi: str) -> dict:
    """Phase 9: the weight toolchain on Llama-2-7B and Falcon-7B at full
    width and TOOLCHAIN_LAYERS layers: (a) both fixtures on the card, (b)
    HF directory -> import -> export round trip, (c) the CLI server, (d) a
    finetune from the release checkpoint and its export, (e) Falcon-7B's
    import, serving and round trip. Launch counts are zeroed before each
    drive and read after it; their sums are phase 9's."""
    import gc
    import os
    import shutil

    import torch
    from megatron_tpu_torch import verify_correctness as vc
    from megatron_tpu_torch.config import falcon_config, llama2_config
    from megatron_tpu_torch.data import build_tokenizer
    from megatron_tpu_torch.tools import synthetic_corpus

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before the "
          "toolchain phase: the pretrain model was not freed")
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_toolchain")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stats = dict(card=smi)
    t_phase = time.perf_counter()
    try:
        # (a) the fixtures, on the card
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: the fixtures are fp32")
        zero_counts()
        fixtures = os.path.join(here, "tests", "fixtures")
        t0 = time.perf_counter()
        golden = vc.golden_mode(os.path.join(
            fixtures, "golden_logits_llama_synthetic.npz"))
        check(golden["ok"], f"golden logits: {golden}")
        trajectory = vc.trajectory_mode(os.path.join(
            fixtures, "golden_loss_trajectory.npz"))
        check(trajectory["ok"], "loss trajectory: a gated series "
              f"({sorted(vc.GATED)}) failed: {trajectory['rows']}")
        counts = read_counts()
        check(not any(counts.values()), f"the fixtures launched {counts}")
        stats["fixtures"] = dict(
            golden_avg_max_abs_err=golden["avg_max_abs_err"],
            trajectory={name: dict(ok=ok, max_abs_dev=worst, gated=gated)
                        for name, ok, worst, gated in trajectory["rows"]},
            seconds=time.perf_counter() - t0)
        log("toolchain (a): the fixture model has head dim 16: its "
            "attention takes the dot path and launches no kernel")

        # (b) Llama-2-7B: HF directory -> release checkpoint -> HF
        corpus = pretrain_corpus(root)
        llama_tok = build_tokenizer("GPT2BPETokenizer",
                                    vocab_file=corpus["vocab"],
                                    merge_file=corpus["merges"])
        lcfg = llama2_config("7b", num_layers=TOOLCHAIN_LAYERS)
        hf_dir = os.path.join(root, "Llama-2-7b-hf")
        stats["llama_write"] = write_hf_dir(
            hf_dir, vc.synthetic_hf_llama_names(
                vocab=lcfg.vocab_size, hidden=lcfg.hidden_size,
                layers=lcfg.num_layers, heads=lcfg.num_attention_heads,
                kv=lcfg.num_kv_heads, ffn=lcfg.ffn_hidden_size),
            LLAMA2_7B_HF_CONFIG, TOOLCHAIN_SEED)
        llama_ckpt = os.path.join(root, "llama")
        model, stats["llama_import"] = import_release("llama", hf_dir,
                                                      llama_ckpt, lcfg)
        n_params = sum(t.numel() for t in model.state_dict().values())
        log(f"toolchain (b): Llama-2-7B width, {TOOLCHAIN_LAYERS} layers, "
            f"{n_params} parameters: " + json.dumps(
                dict(write=stats["llama_write"],
                     **stats["llama_import"])) + f" [{smi}]")
        shutil.rmtree(hf_dir)

        # (c) serve it
        stats["llama_serving"] = serve_checkpoint(
            "llama", llama_ckpt, model, lcfg,
            (corpus["vocab"], corpus["merges"]), llama_tok)
        log("toolchain (c): " + json.dumps(stats["llama_serving"])
            + f" [{smi}]")
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # (d) finetune from the release checkpoint
        zero_counts()
        stats["llama_finetune"] = finetune_release(llama_ckpt, root, corpus,
                                                   lcfg)
        log("toolchain (d): " + json.dumps(stats["llama_finetune"])
            + f" [{smi}]")
        shutil.rmtree(llama_ckpt)
        gc.collect()
        torch.cuda.empty_cache()

        # (e) Falcon-7B: HF directory -> import -> serving -> HF
        fcfg = falcon_config("7b", num_layers=TOOLCHAIN_LAYERS)
        falcon_files = synthetic_corpus.write_gpt2_vocab(
            os.path.join(root, "falcon_vocab"), fcfg.vocab_size)
        falcon_tok = build_tokenizer("GPT2BPETokenizer",
                                     vocab_file=falcon_files[0],
                                     merge_file=falcon_files[1])
        hf_dir = os.path.join(root, "falcon-7b")
        stats["falcon_write"] = write_hf_dir(
            hf_dir, falcon_tensor_names(fcfg), FALCON_7B_HF_CONFIG,
            TOOLCHAIN_SEED + 1)
        falcon_ckpt = os.path.join(root, "falcon")
        model, stats["falcon_import"] = import_release("falcon", hf_dir,
                                                       falcon_ckpt, fcfg)
        n_params = sum(t.numel() for t in model.state_dict().values())
        log(f"toolchain (e): Falcon-7B width, {TOOLCHAIN_LAYERS} layers, "
            f"{n_params} parameters: " + json.dumps(
                dict(write=stats["falcon_write"],
                     **stats["falcon_import"])) + f" [{smi}]")
        shutil.rmtree(hf_dir)
        stats["falcon_serving"] = serve_checkpoint(
            "falcon", falcon_ckpt, model, fcfg, falcon_files, falcon_tok)
        log("toolchain (e): " + json.dumps(stats["falcon_serving"])
            + f" [{smi}]")
        del model
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    drives = [stats["llama_serving"]["launches"]["serial"],
              stats["llama_serving"]["launches"]["engine"],
              stats["llama_finetune"]["launches"],
              stats["falcon_serving"]["launches"]["serial"],
              stats["falcon_serving"]["launches"]["engine"]]
    totals = {k: sum(d[k] for d in drives) for k in drives[0]}
    attention = ("flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
                 "block_attention_cuda")
    stats["launches"] = {k: totals[k] for k in attention}
    stats["norm_launches"] = {k: v for k, v in totals.items()
                              if k not in attention}
    stats["seconds"] = time.perf_counter() - t_phase
    log("toolchain: " + json.dumps(dict(
        seconds=stats["seconds"], launches=stats["launches"],
        norm_launches=stats["norm_launches"])) + f" [{smi}]")
    return stats


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--compare-fwd", metavar="FLASH_FWD_CU",
        help="instead of the smoke run, time this earlier csrc/flash_fwd.cu "
             "beside the current one at every bf16 forward shape")
    parser.add_argument(
        "--compare-bwd", metavar="FLASH_BWD_CU",
        help="instead of the smoke run, time this earlier csrc/flash_bwd.cu "
             "(headers beside it first) beside the current one at every "
             "bf16 training shape")
    parser.add_argument(
        "--compare-norms", metavar="FUSED_NORMS_CU",
        help="instead of the smoke run, time this earlier "
             "csrc/fused_norms.cu's forward and backward beside the current "
             "ones at every bf16 NORM_CASES shape")
    parser.add_argument(
        "--compare-block", metavar="BLOCK_ATTN_CU",
        help="instead of the smoke run, time this earlier "
             "csrc/block_attn.cu beside the current one at every "
             "BLOCK_CASES shape")
    args = parser.parse_args(argv)
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
    compares = [(fn, path) for fn, path in (
        (compare_forward, args.compare_fwd),
        (compare_backward, args.compare_bwd),
        (compare_norms, args.compare_norms),
        (compare_block, args.compare_block)) if path]
    if compares:
        try:
            for fn, path in compares:
                fn(path)
            return 0
        except Exception:  # noqa: BLE001 — any failure fails the run
            traceback.print_exc()
            return 1
    try:
        smi = phase_device()
        phase_build()
        cases = phase_kernels()
        train_cases = phase_training_kernels()
        bits = check_dropout_bits()
        log(f"dropout: the keep bits of the forward, dQ and dV kernels "
            f"equal the plain hash on {bits} (query, key) pairs, fp32 and "
            f"bf16")
        block_cases = phase_block_kernels()
        norm_cases = phase_norm_kernels()
        bench_stats = phase_bench_kernels()
        main_stats = phase_main_path(smi)
        engine_stats = phase_engine(smi)
        int8_stats = phase_int8(smi)
        train_stats = phase_training(smi)
        pretrain_stats = phase_pretrain(smi)
        toolchain_stats = phase_toolchain(smi)
    except Exception:  # noqa: BLE001 — every phase failure fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    serving_case = next(c for c in cases if c["shape"] == MAIN_SHAPE)
    train_case = next(c for c in train_cases
                      if c["shape"] == TRAIN_MAIN_SHAPE)
    train_counts = train_stats["launches"]
    # the three finetune.main runs of phase 8, each counted from zero
    pretrain_counts = {k: sum(run[k] for run in
                              pretrain_stats["launches"].values())
                       for k in train_counts}
    # phase 9's drives, each counted from zero
    tool_counts = toolchain_stats["launches"]

    def entry(name, source, replaces, launches, part, extra):
        main = train_case[part]
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=main["max_abs_err"],
            ms=main["ms"], kernel_ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=TRAIN_MAIN_SHAPE,
            cases=[dict(shape=c["shape"], **c[part]) for c in train_cases],
            **extra)

    pallas = "megatron_tpu/ops/flash_attention_pallas.py"
    engine_flash = engine_stats["launches"]["flash_fwd"]
    bench_counts = bench_stats["launches"]
    kernels = [
        entry("flash_fwd", "megatron_tpu_torch/csrc/flash_fwd.cu",
              f"{pallas}:98",
              main_stats["launches"] + engine_flash
              + train_counts["flash_fwd_cuda"]
              + pretrain_counts["flash_fwd_cuda"]
              + bench_counts["flash_fwd_cuda"]
              + tool_counts["flash_fwd_cuda"], "fwd",
              dict(cuda_kernels=["flash_fwd_wgmma_kernel (bf16: TMA ring, "
                                 "warp-specialised wgmma)",
                                 "flash_fwd_fma_kernel (fp32)"],
                   launches_by_path=dict(
                  serving=main_stats["launches"],
                  engine_prefill=engine_flash,
                  int8_engine_prefill=int8_stats["launches"]["flash_fwd"],
                  training=train_counts["flash_fwd_cuda"],
                  pretrain=pretrain_counts["flash_fwd_cuda"],
                  bench_kernels=bench_counts["flash_fwd_cuda"],
                  toolchain=tool_counts["flash_fwd_cuda"]),
                   max_abs_err_lse=train_case["fwd"]["max_abs_err_lse"],
                   serving_shape=dict(shape=MAIN_SHAPE, **{
                       k: serving_case[k] for k in (
                           "max_abs_err", "max_abs_err_lse", "ms",
                           "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}),
                   serving_cases=cases)),
        entry("flash_bwd_dq", "megatron_tpu_torch/csrc/flash_bwd.cu",
              f"{pallas}:191", train_counts["flash_bwd_dq_cuda"]
              + pretrain_counts["flash_bwd_dq_cuda"]
              + tool_counts["flash_bwd_dq_cuda"], "dq",
              dict(cuda_kernels=["flash_bwd_dq_wgmma_kernel (bf16: TMA "
                                 "ring, warp-specialised wgmma)",
                                 "flash_bwd_dq_fma_kernel (fp32)"],
                   launches_by_path=dict(
                       training=train_counts["flash_bwd_dq_cuda"],
                       pretrain=pretrain_counts["flash_bwd_dq_cuda"],
                       toolchain=tool_counts["flash_bwd_dq_cuda"]))),
        entry("flash_bwd_dkv", "megatron_tpu_torch/csrc/flash_bwd.cu",
              f"{pallas}:278", train_counts["flash_bwd_dkv_cuda"]
              + pretrain_counts["flash_bwd_dkv_cuda"]
              + tool_counts["flash_bwd_dkv_cuda"], "dkv",
              dict(cuda_kernels=["flash_bwd_dkv_wgmma_kernel (bf16: TMA "
                                 "ring, warp-specialised wgmma, q-head "
                                 "chunks)",
                                 "flash_bwd_dkv_sum_kernel (bf16, chunks "
                                 "> 1)",
                                 "flash_bwd_dkv_fma_kernel (fp32)"],
                   launches_by_path=dict(
                       training=train_counts["flash_bwd_dkv_cuda"],
                       pretrain=pretrain_counts["flash_bwd_dkv_cuda"],
                       toolchain=tool_counts["flash_bwd_dkv_cuda"]))),
    ]
    block_main = next(c for c in block_cases if c["shape"] == BLOCK_MAIN)
    kernels.append(dict(
        name="block_attn", route="cuda",
        source="megatron_tpu_torch/csrc/block_attn.cu",
        replaces="megatron_tpu/ops/block_attention_pallas.py:82",
        launches=(engine_stats["launches"]["block_attn"]
                  + int8_stats["launches"]["block_attn"]
                  + pretrain_stats["block_launches"]
                  + tool_counts["block_attention_cuda"]),
        launches_by_path=dict(
            engine=engine_stats["launches"]["block_attn"],
            int8_engine=int8_stats["launches"]["block_attn"],
            pretrain=pretrain_stats["block_launches"],
            toolchain=tool_counts["block_attention_cuda"]),
        launches_per_decode_step=engine_stats["launches_per_decode_step"],
        max_abs_err=block_main["max_abs_err"], ms=block_main["ms"],
        kernel_ms=block_main["ms"], plain_ms=block_main["plain_ms"],
        bound_ms=block_main["bound_ms"], bound_by=block_main["bound_by"],
        library_ms=block_main["library_ms"], library=block_main["library"],
        gather_ms=block_main["gather_ms"], shape=BLOCK_MAIN,
        cuda_kernels=BLOCK_CUDA_KERNELS,
        live_state_check=engine_stats["live_state_check"],
        cases=block_cases))
    norms = "megatron_tpu/ops/fused_norms.py"
    # each main path's norm launch counts, zeroed just before it and read
    # just after (0 where the models use models/norms.py, as the reference)
    path_stats = dict(serving=main_stats, engine=engine_stats,
                      int8_engine=int8_stats, training=train_stats,
                      pretrain=pretrain_stats, toolchain=toolchain_stats)
    for name, kind, part, line in (("rms_fwd", "rms", "fwd", 56),
                                   ("rms_bwd", "rms", "bwd", 62),
                                   ("ln_fwd", "ln", "fwd", 137),
                                   ("ln_bwd", "ln", "bwd", 146)):
        head = next(c for c in norm_cases
                    if c["shape"] == NORM_MAIN and c["norm"] == kind)[part]
        by_path = dict(bench_kernels=bench_counts[f"{name}_cuda"], **{
            path: st["norm_launches"][f"{name}_cuda"]
            for path, st in path_stats.items()})
        kernels.append(dict(
            name=name, route="cuda",
            source="megatron_tpu_torch/csrc/fused_norms.cu",
            replaces=f"{norms}:{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=head["max_abs_err"], ms=head["ms"],
            kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            library=("torch.nn.functional.rms_norm" if kind == "rms" else
                     "torch.nn.functional.layer_norm")
            + (" and its autograd backward" if part == "bwd" else ""),
            shape=NORM_MAIN, cuda_kernels=NORM_CUDA_KERNELS[part],
            **({"with_partial_sum_ms": head["with_partial_sum_ms"]}
               if part == "bwd" else {}),
            cases=[dict(shape=c["shape"], x_dtype=c["x_dtype"],
                        param_dtype=c["param_dtype"], rows=c["rows"],
                        h=c["h"], **c[part])
                   for c in norm_cases if c["norm"] == kind]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
