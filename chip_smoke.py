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
5. engine main path: the same width at ENGINE_LAYERS of its 32 layers
   behind MegatronServer's continuous-batching engine route (ENGINE_SERVING: 8 slots, 2048 positions,
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
6. int8 serving: Llama-2-7B at full width and ENGINE_LAYERS layers with
   int8-resident
   weights (`quantize_weights` of the random bf16 weights) behind the
   engine route with an int8 block pool (INT8_SERVING), 12 concurrent
   requests (`phase_int8`). Every request must return 200 with finite
   logprobs; the block kernel must run once per layer per decode step, on
   the int8 arena with its scales, and the flash forward 0 times (an int8
   cache prefills on the dot path). Tokens/s, TTFT p50/p99, inter-token
   p50, peak memory and the weight and pool bytes are printed. Then the
   ported tools/bench_decode.py at Llama-2-7B's width and ENGINE_LAYERS
   layers (batch 8, prompt 512, 16 new tokens), all four arms; and a 2-layer fp32 slice where the
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
10. sliding window and supervisor (`phase_window_supervisor`), at
   WINDOW_LAYERS layers: see its docstring.
11. engine throughput features (`phase_engine_features`): Llama-2-7B at
   full width and FEATURE_LAYERS layers (random bf16 weights, seed
   FEATURE_SEED) behind
   the engine route, ENGINE_SERVING plus each arm's fields, launch counts
   zeroed before each arm and read after it; every request returns 200
   with finite logprobs. (a) prefix cache: a miss of FEATURE_PREFIX shared
   tokens + 64 runs to its first token, then 7 hits (suffixes 64-200, each
   starting with its own character): 7 hits, 7 x FEATURE_PREFIX tokens
   saved, the flash forward once per layer (the miss only); a second wave
   of 8 hits the retained entries. (b) chunked prefill (CHUNK_SIZE): a
   CHUNK_LONG-token prompt arrives while 7 streams decode; 8 chunks with
   decode steps between them; the streams' inter-token gaps during its
   admission beside the unchunked engine's. (c) preemption: 8 priority-0
   streams, then 2 priority-1 requests; every victim resumes and finishes,
   and the allocated bytes after the arm equal those before it within
   FEATURE_MEMORY_SLACK. (d) speculative decoding (SPEC_K) with the n-gram
   drafter and with one proposing the k-0 arm's greedy streams, beside k 0,
   on prompts repeating a span: the block kernel once per layer per verify
   round or fallback step, one host read a round, and the kernel held
   against its plain version on a live verify round (w 5). (e) a 2-layer fp32 slice (TF32 off): greedy tokens equal with
   each feature on and off and on the serial route; preemption victims
   parked, replayed and unpreempted equal; a seeded sampled stream under
   speculative_k equal alone and among 7 others.
12. the front door (`phase_front_door`): Llama-2-7B at full width and
   FRONT_LAYERS layers (random bf16, seed FRONT_SEED), ENGINE_SERVING with the prefix
   cache. (a) two replicas behind the router (`num_replicas=2`) on HTTP:
   16 requests over 4 groups of a FRONT_PREFIX-token prefix, in two waves
   (wave 2 all prefix hits, routed by affinity); per replica picks, hits,
   tokens/s, TTFT, beside one replica. (c) a serve_delay of WEDGE_STALL_S
   past a WEDGE_TIMEOUT_S watchdog: the wedged work retried on the other
   replica, the replica ejected, restarted and promoted by one canary. (d)
   8 SSE streams of FRONT_STREAM_NEW tokens on HTTP: one dropped at event
   SSE_DROP_AT and resumed with Last-Event-ID, one cancelled (its slot
   free within a step, `requests_cancelled` 1, allocated bytes back);
   the gaps clients see. (b) 8 requests in flight, the busier replica
   closed: every future resolves, `router_failovers` 1, `router_retries`
   its requests, /healthz degraded, the block kernel held against its
   plain version on the survivor's live state. (b)-(d)'s tokens must
   equal a one-replica run's bit for bit (each is a prefix hit on
   prefixes prefilled alone). (e) one engine with retained_slots 2 and a
   TIER_BYTES host tier: two demotions (= evictions) of 1,536-token
   prefixes, a host restore, a device hit and a miss (their TTFTs), copy /
   CRC / upload seconds and bytes, MemAvailable, and an entry corrupted
   by serve_host_corrupt (a checksum miss with the miss path's tokens).
   (f) a 2-layer fp32 slice (TF32 off): the router, one engine and the
   serial route; a stream and its completion; a host restore, a miss and
   the tier off: equal greedy tokens.
13. LoRA serving, LoRA finetuning and live weights (`phase_lora_live`):
   (a) Llama-2-7B at full width and LORA_LAYERS layers behind the engine
   with an adapter bank of 8 rows at rank 16 (random fp32 factors): the three
   bench_lora arms (base, one adapter, 16 requests round-robin over the
   base model and 8 adapters), each request prefilled alone: tokens/s,
   TTFT and inter-token p50, peak memory, the gather bytes of a decode
   step; the mixed arm's base rows equal the base arm's; the block kernel
   held on the live adapter state at w 1 and on a w 5 verify round with
   adapters, the flash forward on an adapter request's prefill. (b) 4
   adapters registered by path into a bank of 2 rows: evictions demote to
   the host, a re-request is a host hit, serve_adapter_corrupt forces a
   checksum miss and the reload from disk gives equal tokens. (c)
   `finetune.main --lora_rank 16` at 7B width and 4 layers, 10 iterations:
   the flash forward, dQ and dK/dV launch counts advance, the kernels are
   held on the training's live inputs, the adapter lowers the first
   batch's loss, and its export serves on a 4-layer engine. (d) 4-layer
   checkpoints N and N+1 published by save_checkpoint; a swap to N+1 while
   8 requests stream and 8 more wait in the hold: each wave equals an
   engine holding only its version, nothing is rejected, old prefixes
   miss, device memory returns to one copy; a corrupt N+2 is refused and
   N+1 serves on (staging, apply and hold seconds, peak memory). (e) two
   replicas behind the router upgraded under traffic from two threads:
   every completion one version's tokens, at most one replica out of
   rotation, a corrupt publish aborts and the fleet serves on. (f) a
   2-layer fp32 slice: adapter rows on a fp32 and an int8 pool equal their
   merged-weights serial Generators; a swap driven by
   CheckpointWatcher.poll_once under load gives the serial N before it and
   N+1 after; a corrupt publish is refused once and not retried.
14. Structured output, n-best fan-out and the brownout ladder
   (`phase_structured_degrade`): Llama-2-7B at full width and
   STRUCT_LAYERS of its 32 layers, 8
   slots, 16-token blocks, the block kernel, each request prefilled alone,
   grammars over the byte-level identity table of 32,000 tokens (the
   TokenFSM compile seconds printed). (a) tools/bench_structured.py's free
   arm, then the same 8 requests under a regex and under a JSON-schema
   grammar: every completion FSM-legal and parsed, `mask_uploads` against
   the decode steps, tokens/s, TTFT and inter-token p50 of each arm, the
   block kernel held on the live masked grid. (b) an n=4 fan-out on an
   unseen prompt: its flash launches one prefill's (one a layer), 3 alias hits, the
   pool's books back to baseline, each sample equal to its n=1 twin (run on
   a second engine over the same weights). (c) constrained requests on a
   speculative engine: masked verify rounds at w 5, the block kernel held
   on one. (d) tools/chaos_storm.py, one seed, 0.5x/1x/2x of the rate a
   calibration sustains, the ladder at 4 rungs: laws 8-11 and the
   structural sweep, the level rising and back at 0. (e) a 2-layer fp32
   slice: constrained streams equal the masked serial oracle with
   speculation off and on, fp32 and int8 pools; fan-out samples equal
   serial n=1 generates; rung 2's clamp and rung 1 mid-stream change no
   token; tools/chaos_serve.py's three drills and tools/chaos_upgrade.py's
   drills 1-2, each ending in a strict invariant sweep.
15. Remote replicas (`phase_fleet`): Llama-2-7B at full width and
   FLEET_LAYERS layers (bf16, seed FLEET_SEED) in replica server processes (`tools/
   chaos_fleet.py --serve_replica`, the replica-mode MegatronServer),
   FLEET_SERVING (ENGINE_SERVING, the prefix cache, each request prefilled
   alone), behind a fleet front tier in this process that holds no
   weights, all over HTTP on 127.0.0.1. (a) /healthz shows two replicas;
   (b) 16 requests (8 of them SSE streams) over four 1,024-token prefixes,
   each warmed on one replica only: the affinity digest sends every
   request to its prefix's replica (8 prefix hits on each); (c) a replica
   SIGKILLed while its requests decode: they fail over, /healthz stays
   accepting with one replica up, the fleet's strict /invariants lists the
   dead address under `unreachable`, a respawn on its port is re-admitted
   through the canary; (d) a replica SIGSTOPped: the front tier's read
   timeouts eject it, its requests fail over, SIGCONT and re-admission;
   (e) the fleet's strict invariant sweep green. The completions of
   (b)-(d) equal one replica process's (the reference process R).
   tools/serving_bench.py --url --stream against the two-process fleet and
   against R alone: tokens/s, TTFT p50/p99, inter-token p50. Each replica
   writes its launch counts at its SIGTERM shutdown; every surviving one
   must show kernels 1 and 4. (f) a 2-layer fp32 slice in two replica
   processes, one SIGKILLed under traffic: every completion equals the
   serial route of the same weights here. No child outlives the phase.
16. The Mixture-of-Experts layer (`phase_moe`) at Mixtral-8x7B's widths
   (h 4096, 32/8 heads, 8 experts of ffn 14336, top-2, vocab 32000, the
   dropless capacity E / K; random weights from seeds; depth cut for
   memory, MOE_LAYERS of 32 for serving). (a) the serial /api route: a
   512-token greedy prompt with 64 new tokens, 3 sampled prompts, and
   `Generator.score` of the greedy stream; prefill ms, decode ms a token,
   peak memory, flash and block launches. (b) the engine on HTTP
   (MOE_SERVING: ENGINE_SERVING with each request prefilled alone), 16
   requests of 37-1,000 tokens, half sampled: tokens/s, TTFT p50/p99,
   inter-token p50, peak memory and the decode step's weight-read bound;
   each greedy request sent again alone gives the burst's tokens. (c)
   `quantize_weights` (the banks the same tensors), a W8 engine with an
   int8 block pool (its streams' logprobs against the bf16 and the W8
   serial routes reported, with the positions where a router's choice
   flipped); `int8_expert_matmul` against the bf16 bmm at the bank's
   decode and prefill shapes (MOE_BANK_TOL, the int32 product exact). (d)
   a 2-layer fp32 slice: sort and dense dispatch agree on logits and grads
   (MOE_SLICE_TOL), dropless and at capacity MOE_DROP_CAPACITY (drops
   counted), the engine with batched prefill equals the serial route, and
   the W8 + int8-KV engine's logprobs agree with its serial route's within
   W8_LOGPROB_TOL. (e) `make_train_step` at MOE_TRAIN_LAYERS
   layers, seq 4096, bf16 compute, fp32 Adam, 3 steps: finite losses, each
   layer's router loss, step ms, peak memory, the three flash kernels
   once per layer a step. (f) an HF Mixtral directory at MOE_TOOL_LAYERS
   layers through tools/convert_hf_checkpoint --family mixtral, served,
   exported and re-imported bit for bit; seconds and bytes.
17. BERT and T5 pretraining (`phase_bert_t5`): BERT-base and T5-base at
   the presets' full widths and depths (h 768, 12 heads of 64, ffn 3072,
   12 layers; T5 12 + 12 with cross-attention, decoder seq 128), seq 512,
   micro-batch 8, bf16 compute, fp32 master weights, flash attention,
   through `megatron_tpu_torch.pretrain_bert.main` and `pretrain_t5.main`
   on a synthetic corpus with a WordPiece vocabulary the phase writes
   (30,522 entries; 32,028 for T5, whose entry adds 100 sentinels). Each
   family: U, 3 iterations; P, --save at 2 and exit; R, --load P to 3; D,
   one iteration with hidden and attention dropout 0.1. P's and R's steps
   equal U's (loss and grad norm) and R's final state U's bit for bit
   (`state_digest`); the first loss within 1 nat of ln(vocab) (+ ln 2 for
   NSP); D's loss finite; every iteration launches each flash kernel once
   per attention call (BERT 12, T5 36). Then a 2-layer fp32 slice of each
   on the card (the kernels) and on the CPU (the plain versions), the
   same weights and 4 rows of the phase's data: loss and every gradient
   leaf within SLICE_TOL. The new kernel paths (non-causal with pad
   segments, cross-attention at sq 128 / sk 512 in bf16 and fp32, the
   decoder at s 128) are KERNEL_CASES' and TRAIN_CASES' cases, run in
   phase 3.
18. The BERT heads and the retriever (`phase_retrieval_tasks`) at
   BERT-base's full width and depth, bf16 compute, fp32 Adam, flash
   attention, random weights from RT_SEED, on files the phase writes in
   the published layouts (a WordPiece vocabulary, a sentence-split corpus
   with titles through the port's indexed-dataset builder, MNLI TSVs, RACE
   json lines, a DPR evidence TSV, NQ questions and DPR json). (a)
   `pretrain_ict.main`: 3 iterations at seq 256, micro-batch 32, ict_head
   128 (each flash kernel 24 times a step, two towers), one params-only
   checkpoint; the first loss beside ln 32; then U, P (save at 2, exit)
   and R (resume) on a 2-layer fp32 slice with shared towers, R's final
   state U's bit for bit. (b) `tasks.main` MNLI (seq 128, micro-batch 32)
   and RACE (seq 384, micro-batch 8 x 4 choices), one epoch. (c)
   `create_doc_index` over RT_PASSAGES passages from (a)'s checkpoint
   (passages/s), the store within one fp16 step of a batch-by-batch
   `embed_text` pass, then `tasks.main --task NQ` (top-1/5/20/100). (d)
   `MIPSIndex` over 21,015,324 x 128 fp32 embeddings made on the card,
   3,610 queries for the top 100, timed against its bound; 64 queries over
   the first 1,048,576 rows against a float64 numpy top-100. (e)
   `tasks.main --task RET-FINETUNE-NQ` from (a)'s checkpoint. (f) a
   2-layer fp32 slice: the classification, multiple-choice and retrieval
   losses through the kernels against the dot path. The padded kernel
   cases `ict_query_pad` and `race_mc_pad` run in phase 3.

Phases 1-3b run alone on the card, so that the kernels' times are the
card's own. Then phases 4-18 run in two lanes at once, each phase in the
order above within its lane: this process runs LANE_A, and a second
process (`chip_smoke.py --lane ...`, started here and stopped with its own
processes however the run ends) runs LANE_B, whose lines come through here
prefixed `lane B | `. The phases' host work (servers, conversions,
checkpoint I/O, process starts) is most of their time and the card idles
through most of it, so the lanes share it; the phases that hold most of the
card's memory (7, 15 and 16) run one after another in LANE_B, and LANE_A's
phases hold less than the rest. The serving and training rates the phases
print are taken beside the other lane's work.

Then one JSON line {"kernels": [...]} (8 kernels; each launch count is one
that a main path's run counted, zeroed just before it and read just after,
the norm kernels' on every path above, the flash kernels' on phases 8-18
too, the block kernel's on phases 9, 11-16 too, its verify rounds at
w 5 on phases 11, 13 and 14; phase 15's counts are the replica processes'
whole lives) and, last, {"ok": true, "device": ...}.
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

import ast
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

# phases 4-18 in two lanes at once (the module's docstring): the seconds
# each took alone on one host (a slower one than most) balance them,
# 508 s against 520 s
LANE_A = ("4", "5", "6", "8", "9", "12", "13")
LANE_B = ("15", "16", "7", "10", "11", "14", "17", "18")
# the most a phase waits for the other lane to give back card memory
LANE_MEMORY_WAIT_S = 900.0

# phase 18's padded batches: ICT's one-sentence queries padded to 256
# tokens (32 a batch), and RACE's 8 questions x 4 choices at 384 tokens
ICT_QUERY_PAD = ("pad", 8, 64)
RACE_MC_PAD = ("pad", 150, 384)

# (label, b, sq, sk, nq, nkv, d, dtype name, causal, sliding_window,
# segments: None, or "pad" for BERT's pad isolation over ragged real
# lengths, PAD_LENGTHS, or ("pad", first, last) over lengths first..last).
# The first three are the prefills the main path
# runs: request (a) at b 1, s 512;
# request (b) at b 3, s 32 (its shortest prompt, 37, rounded down to the
# prefill bucket); request (d)'s beam search at b 4, s 24. s 129 and s 255
# sit one row past a 128-row tile of the bf16 kernel and one row short of
# two; s 1000 is the engine phase's longest prompt; the bf16 window of 100
# crosses the band's edge inside tiles; mistral_window_prefill is phase 10's
# rolling prefill (a 4608-token prompt past a 4096 window);
# mixtral_prefill_s1000 is phase 16's longest engine prompt at Mixtral's
# 32/8 heads, with no window. The bench_ cases are tools/bench_kernels.py's
# flash shapes (FLASH_SHAPES), which the bench_kernels path launches. Then
# four of phase 17's attention at BERT-base's and T5-base's widths (12/12
# heads of 64, micro-batch 8): the bidirectional encoder with pad
# segments, T5's cross-attention (128 decoder queries over 512 encoder
# keys, no segment ids) in bf16 and fp32, and its causal decoder; and two
# of phase 18's: ICT's one-sentence queries padded to 256 tokens (32 a
# batch) and RACE's 8 x 4 choices at 384 tokens.
KERNEL_CASES = [
    ("llama2_7b_prefill", 1, 512, 512, 32, 32, 128, "bfloat16", True, None,
     None),
    ("request_b_prefill", 3, 32, 32, 32, 32, 128, "bfloat16", True, None,
     None),
    ("beam_prefill", 4, 24, 24, 32, 32, 128, "bfloat16", True, None, None),
    ("ragged_s200", 1, 200, 200, 32, 32, 128, "bfloat16", True, None, None),
    ("tile_edge_s129", 1, 129, 129, 32, 32, 128, "bfloat16", True, None,
     None),
    ("tile_edge_s255", 1, 255, 255, 32, 32, 128, "bfloat16", True, None,
     None),
    ("engine_prompt_s1000", 1, 1000, 1000, 32, 32, 128, "bfloat16", True,
     None, None),
    ("gqa_64q_8kv", 1, 512, 512, 64, 8, 128, "bfloat16", True, None, None),
    ("falcon7b_mqa", 1, 512, 512, 71, 1, 64, "bfloat16", True, None, None),
    ("falcon7b_mqa_s2048", 1, 2048, 2048, 71, 1, 64, "bfloat16", True, None,
     None),
    ("bf16_window100", 1, 1024, 1024, 32, 8, 128, "bfloat16", True, 100,
     None),
    ("mistral_window_prefill", 1, 4608, 4608, 32, 8, 128, "bfloat16", True,
     4096, None),
    ("fp32_window128", 1, 512, 512, 32, 8, 128, "float32", True, 128, None),
    ("mixtral_prefill_s1000", 1, 1000, 1000, 32, 8, 128, "bfloat16", True,
     None, None),
    ("bench_2x2048x16", 2, 2048, 2048, 16, 16, 128, "bfloat16", True, None,
     None),
    ("bench_1x8192x8", 1, 8192, 8192, 8, 8, 128, "bfloat16", True, None,
     None),
    ("bench_1x32768x4", 1, 32768, 32768, 4, 4, 128, "bfloat16", True, None,
     None),
    ("bert_base_pad", 8, 512, 512, 12, 12, 64, "bfloat16", False, None,
     "pad"),
    ("t5_cross", 8, 128, 512, 12, 12, 64, "bfloat16", False, None, None),
    ("t5_cross_fp32", 8, 128, 512, 12, 12, 64, "float32", False, None,
     None),
    ("t5_dec_self", 8, 128, 128, 12, 12, 64, "bfloat16", True, None, None),
    ("ict_query_pad", 32, 256, 256, 12, 12, 64, "bfloat16", False, None,
     ICT_QUERY_PAD),
    ("race_mc_pad", 32, 384, 384, 12, 12, 64, "bfloat16", False, None,
     RACE_MC_PAD),
]
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}  # (out, lse)
# the real lengths of a "pad" case's rows run evenly from the first to the
# second (BERT's pretraining rows, ragged up to the full 512)
PAD_LENGTHS = (200, 512)
MAIN_SHAPE = "llama2_7b_prefill"
# phase 10's rolling prefill: Mistral-7B's 32/8 heads, a prompt past its
# 4096-token window
WINDOW_SHAPE = "mistral_window_prefill"

# (label, b, sq, sk, nq, nkv, d, dtype name, causal, sliding_window,
# segment ids: False, True for two documents a row, "pad" for BERT's pad
# isolation, dropout rate, lse cotangent): the training path's attention.
# The first is the main path's call (Llama-2-7B, s 4096); the others are
# the features and
# layouts the kernels take (segment ids give two documents a row; Falcon-7B
# trains at its 2048 positions). bf16_window100_train runs the bf16 backward
# with a window; falcon7b_mqa_extra_train holds the d 64 EXTRA
# instantiations (segment ids and dropout), the dK/dV head split of MQA
# and a ragged tail (1000 rows) in one case; mixtral_train_s4096 is phase
# 16's training call (Mixtral-8x7B's 32/8 heads, s 4096); then four of
# phase 17's (BERT-base's padded encoder, T5-base's cross-attention in
# bf16 and fp32 and its decoder self-attention, micro-batch 8) and two of
# phase 18's (ICT's padded queries, RACE's padded choices).
TRAIN_CASES = [
    ("llama2_7b_train", 1, 4096, 4096, 32, 32, 128, "bfloat16", True, None,
     False, 0.0, False),
    ("train_segments", 1, 4096, 4096, 32, 32, 128, "bfloat16", True, None,
     True, 0.0, False),
    ("train_dropout", 1, 4096, 4096, 32, 32, 128, "bfloat16", True, None,
     False, 0.1, False),
    ("train_dlse", 1, 4096, 4096, 32, 32, 128, "bfloat16", True, None,
     False, 0.0, True),
    ("gqa_64q_8kv_train", 1, 4096, 4096, 64, 8, 128, "bfloat16", True, None,
     False, 0.0, False),
    ("falcon7b_mqa_train", 1, 2048, 2048, 71, 1, 64, "bfloat16", True, None,
     False, 0.0, False),
    ("ragged_s200_train", 1, 200, 200, 32, 32, 128, "bfloat16", True, None,
     False, 0.0, False),
    ("fp32_window128_train", 1, 2048, 2048, 32, 8, 128, "float32", True,
     128, False, 0.0, False),
    ("bf16_window100_train", 1, 1024, 1024, 32, 8, 128, "bfloat16", True,
     100, False, 0.0, False),
    ("falcon7b_mqa_extra_train", 1, 1000, 1000, 71, 1, 64, "bfloat16", True,
     None, True, 0.1, False),
    ("mixtral_train_s4096", 1, 4096, 4096, 32, 8, 128, "bfloat16", True,
     None, False, 0.0, False),
    ("bert_base_pad_train", 8, 512, 512, 12, 12, 64, "bfloat16", False,
     None, "pad", 0.0, False),
    ("t5_cross_train", 8, 128, 512, 12, 12, 64, "bfloat16", False, None,
     False, 0.0, False),
    ("t5_cross_fp32_train", 8, 128, 512, 12, 12, 64, "float32", False, None,
     False, 0.0, False),
    ("t5_dec_self_train", 8, 128, 128, 12, 12, 64, "bfloat16", True, None,
     False, 0.0, False),
    ("ict_query_pad_train", 32, 256, 256, 12, 12, 64, "bfloat16", False,
     None, ICT_QUERY_PAD, 0.0, False),
    ("race_mc_pad_train", 32, 384, 384, 12, 12, 64, "bfloat16", False, None,
     RACE_MC_PAD, 0.0, False),
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
# full_region one slot's live keys reach the region's last key, so every
# split of the kernel's grid is live and the combine merges the most;
# mixtral_decode is phase 16's engine decode (Mixtral-8x7B's 32/8 heads,
# 4 query rows a kv head), mixtral_int8 the same over phase 16 (c)'s int8
# arena.
BLOCK_LENGTHS = [37, 64, 100, 200, 300, 515, 700, 1200]
BLOCK_CAP = 2048
BLOCK_CASES = [
    ("engine_decode", 8, 1, 32, 32, 128, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("block_64", 8, 1, 32, 32, 128, 64, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("verify_w4", 8, 4, 32, 32, 128, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("spec_verify_w5", 8, 5, 32, 32, 128, 16, "bfloat16", "bfloat16",
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
    ("mixtral_decode", 8, 1, 32, 8, 128, 16, "bfloat16", "bfloat16",
     BLOCK_LENGTHS),
    ("mixtral_int8", 8, 1, 32, 8, 128, 16, "bfloat16", "int8",
     BLOCK_LENGTHS),
]
BLOCK_MAIN = "engine_decode"
# phase 11's speculative verify window (speculative_k 4)
BLOCK_VERIFY = "spec_verify_w5"
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

# The engine phase: Llama-2-7B at full width and ENGINE_LAYERS of its 32
# layers behind the engine route (phase 4 drives all 32; the whole smoke's
# time limit cuts the depth here, never the width: the serving loop's host
# time grows with the layers). 16 concurrent requests: each prompt length
# twice, new tokens from 64 to 256, even requests greedy, odd ones seeded
# at temperature 0.8, top_p 0.9.
ENGINE_LAYERS = 8
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

# The int8 serving phase: Llama-2-7B's width at ENGINE_LAYERS layers with
# int8-resident weights behind the engine route with an int8 block pool; 12
# concurrent requests.
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
# bench_decode at Llama-2-7B's width and ENGINE_LAYERS layers, all four arms
BENCH_DECODE_ARGS = ["--layers", str(ENGINE_LAYERS), "--hidden", "4096",
                     "--heads", "32",
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


_LOG_LOCK = threading.Lock()


def log(msg: str) -> None:
    # one write a line: the other lane's lines are printed from a thread
    with _LOG_LOCK:
        sys.stdout.write(msg + "\n")
        sys.stdout.flush()


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


def bound_ms(flops: float, nbytes: float, dtype_name: str):
    """The least time on the card: the larger of the operations over the
    dtype's peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def counterparts(causal: bool, seg) -> dict:
    """The counterparts of a bidirectional or segmented case, timed on the
    same inputs beside it: "causal_ms" made causal (top-left aligned)
    without segment ids, and for a segmented one "unsegmented_ms" without
    them. Returns {key: keyword overrides of the case's call}."""
    out = {}
    if not causal:
        out["causal_ms"] = dict(causal=True, segment_ids=None)
    if seg is not None:
        out["unsegmented_ms"] = dict(segment_ids=None)
    return out


def pad_segments(b: int, s: int, lengths=PAD_LENGTHS):
    """BERT's pad isolation over ragged real lengths (`lengths`' first to
    last spread over the rows): real tokens segment 0, the pad at position
    i segment 2 + i, which sees only itself. int32 [b, s] on the card."""
    import torch
    lo, hi = min(lengths[0], s), min(lengths[1], s)
    lengths = torch.tensor([lo + (hi - lo) * i // max(b - 1, 1)
                            for i in range(b)], device="cuda")
    pos = torch.arange(s, device="cuda")
    return torch.where(pos[None] < lengths[:, None], 0,
                       2 + pos[None]).to(torch.int32)


def case_segments(mode, b: int, s: int):
    """A case's segment ids: None, two documents a row (True), or BERT's
    pad isolation ("pad", or ("pad", first, last) real lengths)."""
    import torch
    if not mode:
        return None
    if mode == "pad":
        return pad_segments(b, s)
    if isinstance(mode, tuple):
        return pad_segments(b, s, mode[1:])
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    seg[:, s // 2:] = 1
    return seg


def visible_mask(sq: int, sk: int, causal: bool, window, seg):
    """The (query, key) pairs a call sees: bool [b|1, sq, sk] on the card
    (top-left aligned causal mask, the window, the segment ids of this
    run's data)."""
    import torch
    qp = torch.arange(sq, device="cuda")[:, None]
    kp = torch.arange(sk, device="cuda")[None]
    mask = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        mask = qp >= kp
        if window:
            mask = mask & (qp - kp < window)
    mask = mask[None]
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])
    return mask


def visible_pairs(b: int, sq: int, sk: int, causal: bool, window,
                  seg) -> int:
    """(query, key) pairs a call sees, over the batch of b rows."""
    mask = visible_mask(sq, sk, causal, window, seg)
    return int(mask.sum()) * (b // mask.shape[0])


def training_bounds(b, sq, sk, nq, nkv, d, item, dtype_name, pairs, seg,
                    dlse):
    """(forward, dQ, dK/dV) bounds of one training call: each kernel's
    operations on this run's visible pairs (4 d, 6 d and 8 d a pair) and
    the bytes it must move (q, k, v, dout, out, dq, dk, dv, the [b, nq, sq]
    fp32 row stats and the segment ids, each read or written once)."""
    seg_bytes = 4 * b * sq if seg else 0
    stat_bytes = 4 * b * nq * sq
    qo_bytes = item * b * sq * nq * d  # one [b, sq, nq, d] tensor
    kv_bytes = item * b * sk * nkv * d  # one [b, sk, nkv, d] tensor
    n_stats = 3 if dlse else 2  # lse, delta (, dlse)
    return (bound_ms(4 * d * pairs, 2 * qo_bytes + 2 * kv_bytes
                     + stat_bytes + seg_bytes, dtype_name),
            bound_ms(6 * d * pairs, 3 * qo_bytes + 2 * kv_bytes
                     + n_stats * stat_bytes + seg_bytes, dtype_name),
            bound_ms(8 * d * pairs, 2 * qo_bytes + 4 * kv_bytes
                     + n_stats * stat_bytes + seg_bytes, dtype_name))


def sdpa_calls(q, k, v, dout, scale, window, causal=True, seg=None):
    """(forward, backward) of scaled_dot_product_attention on the same
    inputs and the same mask: the library yardstick for attention without
    dropout (a boolean mask for a window or segment ids)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    kw = dict(scale=scale, enable_gqa=True)
    if window or seg is not None:
        kw["attn_mask"] = visible_mask(q.shape[1], k.shape[1], causal,
                                       window, seg)[:, None]
    else:
        kw["is_causal"] = causal

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
    from megatron_tpu_torch.ops.flash_attention import blockwise_attention
    from megatron_tpu_torch.ops.flash_attention_cuda import flash_fwd_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = []
    for (label, b, sq, sk, nq, nkv, d, dname, causal, window,
         seg_mode) in KERNEL_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(b, sq, nq, d, generator=gen, device="cuda").to(dtype)
        # k and v as the strided halves of one fused projection, as the
        # model hands them over
        kv = torch.randn(b, sk, 2, nkv, d, generator=gen,
                         device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
        seg = case_segments(seg_mode, b, sq)
        scale = d ** -0.5
        kw = dict(causal=causal, scale=scale, sliding_window=window,
                  segment_ids=seg)

        def kernel():
            return flash_fwd_cuda(q, k, v, **kw)

        def plain():
            return blockwise_attention(q, k, v, **kw)

        out, lse = kernel()
        torch.cuda.synchronize()
        ref_out, ref_lse = plain()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dname]
        check(bool(torch.isfinite(out).all())
              and bool(torch.isfinite(lse).all()),
              f"{label}: non-finite output or lse")
        check(err_out <= tol_out and err_lse <= tol_lse,
              f"{label}: kernel vs plain out err {err_out} (tol {tol_out}),"
              f" lse err {err_lse} (tol {tol_lse})")

        library, _ = sdpa_calls(q, k, v, q, scale, window, causal, seg)
        pairs = visible_pairs(b, sq, sk, causal, window, seg) * nq
        bound = training_bounds(b, sq, sk, nq, nkv, d, q.element_size(),
                                str(dtype), pairs, seg is not None,
                                False)[0]
        r = dict(shape=label, b=b, s=sq, sk=sk, nq=nq, nkv=nkv, d=d,
                 dtype=dname, causal=causal, sliding_window=window,
                 segments=seg_mode, visible_pairs=pairs,
                 max_abs_err=err_out, max_abs_err_lse=err_lse,
                 ms=cuda_time_ms(kernel, queued=True),
                 plain_ms=cuda_time_ms(plain, 5, 1, queued=True),
                 library_ms=cuda_time_ms(library, queued=True),
                 bound_ms=bound[0], bound_by=bound[1])
        for key, over in counterparts(causal, seg).items():
            r[key] = cuda_time_ms(
                lambda: flash_fwd_cuda(q, k, v, **dict(kw, **over)),
                queued=True)
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
    for (label, b, s, sk, nq, nkv, d, dname, causal, window, use_seg, rate,
         use_dlse) in TRAIN_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(b, s, nq, d, generator=gen, device="cuda").to(dtype)
        # k and v as the strided halves of one fused projection
        kv = torch.randn(b, sk, 2, nkv, d, generator=gen,
                         device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
        dout = torch.randn(b, s, nq, d, generator=gen,
                           device="cuda").to(dtype)
        seg = case_segments(use_seg, b, s)
        dlse = (torch.randn(b, nq, s, generator=gen, device="cuda")
                if use_dlse else None)
        kw = dict(causal=causal, scale=d ** -0.5, sliding_window=window,
                  segment_ids=seg, dropout_rate=rate,
                  dropout_seed=DROPOUT_SEED)
        bkw = dict(kw, dlse=dlse)

        out, lse = fc.flash_fwd_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.blockwise_attention(q, k, v, **kw)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dname]
        check(bool(torch.isfinite(out).all())
              and bool(torch.isfinite(lse).all()),
              f"{label}: non-finite out or lse")
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

        pairs = visible_pairs(b, s, sk, causal, window, seg) * nq
        fwd_bound, dq_bound, dkv_bound = training_bounds(
            b, s, sk, nq, nkv, d, q.element_size(), str(dtype), pairs,
            seg is not None, dlse is not None)
        lib_fwd = lib_bwd = None
        if not rate:
            sdpa_fwd, sdpa_bwd = sdpa_calls(q, k, v, dout, d ** -0.5, window,
                                            causal, seg)
            lib_fwd = cuda_time_ms(sdpa_fwd, 10, 2, queued=True)
            if dlse is None:
                lib_bwd = cuda_time_ms(sdpa_bwd, 10, 2, queued=True)
        plain_bwd_ms = cuda_time_ms(plain_bwd, 3, 1)
        times_of = {}
        for key, over in counterparts(causal, seg).items():
            kw2 = dict(bkw, **over)
            out2, lse2 = fc.flash_fwd_cuda(q, k, v, **dict(kw, **over))
            delta2 = fa.attention_delta(out2, dout)
            times_of[key] = {part: cuda_time_ms(fn, 10, 2, queued=True)
                             for part, fn in (
                ("fwd", lambda: fc.flash_fwd_cuda(q, k, v,
                                                  **dict(kw, **over))),
                ("dq", lambda: fc.flash_bwd_dq_cuda(q, k, v, dout, lse2,
                                                    delta2, **kw2)),
                ("dkv", lambda: fc.flash_bwd_dkv_cuda(q, k, v, dout, lse2,
                                                      delta2, **kw2)))}
        r = dict(
            shape=label, b=b, s=s, sk=sk, nq=nq, nkv=nkv, d=d, dtype=dname,
            causal=causal, sliding_window=window, segments=use_seg,
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
        for key, times in times_of.items():
            for part, ms in times.items():
                r[part][key] = ms
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
    b, sq, sk, nq, nkv, d, causal, window, segment ids, dropout rate);
    training cases that differ only in the backward (an lse cotangent) are
    left out."""
    shapes = [(label, b, sq, sk, nq, nkv, d, causal, window, seg, 0.0)
              for (label, b, sq, sk, nq, nkv, d, dname, causal, window,
                   seg) in KERNEL_CASES
              if dname == "bfloat16"]
    shapes += [(label, b, sq, sk, nq, nkv, d, causal, window, seg, rate)
               for (label, b, sq, sk, nq, nkv, d, dname, causal, window, seg,
                    rate, dlse) in TRAIN_CASES
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
    for (label, b, s, sk, nq, nkv, d, causal, window, use_seg,
         rate) in forward_shapes():
        q = torch.randn(b, s, nq, d, generator=gen,
                        device="cuda").bfloat16()
        kv = torch.randn(b, sk, 2, nkv, d, generator=gen,
                         device="cuda").bfloat16()
        k, v = kv[:, :, 0], kv[:, :, 1]
        seg = case_segments(use_seg, b, s)
        kw = dict(causal=causal, scale=d ** -0.5, sliding_window=window,
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
        if not rate:
            sdpa_fwd, _ = sdpa_calls(q, k, v, q, d ** -0.5, window, causal,
                                     seg)
            sdpa_ms = cuda_time_ms(sdpa_fwd, 20, 3, queued=True)
        pairs = visible_pairs(b, s, sk, causal, window, seg) * nq
        bound = training_bounds(b, s, sk, nq, nkv, d, 2, "torch.bfloat16",
                                pairs, seg is not None, False)[0]
        old_ms = sum(times["old"]) / 2
        new_ms = sum(times["new"]) / 2
        r = dict(shape=label, b=b, s=s, sk=sk, nq=nq, nkv=nkv, d=d,
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
    for (label, b, s, sk, nq, nkv, d, dname, causal, window, use_seg, rate,
         use_dlse) in TRAIN_CASES:
        if dname != "bfloat16":
            continue
        q = torch.randn(b, s, nq, d, generator=gen, device="cuda").bfloat16()
        kv = torch.randn(b, sk, 2, nkv, d, generator=gen,
                         device="cuda").bfloat16()
        k, v = kv[:, :, 0], kv[:, :, 1]
        dout = torch.randn(b, s, nq, d, generator=gen,
                           device="cuda").bfloat16()
        seg = case_segments(use_seg, b, s)
        dlse = (torch.randn(b, nq, s, generator=gen, device="cuda")
                if use_dlse else None)
        kw = dict(causal=causal, scale=d ** -0.5, sliding_window=window,
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
        if not rate and dlse is None:
            sdpa_ms = cuda_time_ms(
                sdpa_calls(q, k, v, dout, d ** -0.5, window, causal,
                           seg)[1], 10, 2, queued=True)
        pairs = visible_pairs(b, s, sk, causal, window, seg) * nq
        _, dq_bound, dkv_bound = training_bounds(
            b, s, sk, nq, nkv, d, 2, "torch.bfloat16", pairs,
            seg is not None, dlse is not None)
        mean = {key: sum(v_) / len(v_) for key, v_ in times.items()}
        r = dict(shape=label, b=b, s=s, sk=sk, nq=nq, nkv=nkv, d=d,
                 sliding_window=window, segments=use_seg, dropout=rate,
                 dlse=use_dlse, visible_pairs=pairs,
                 dkv_head_chunks=fc.dkv_head_chunks(
                     b, sk, nkv, nq // nkv, sm_count(q.device.index)),
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
    held = {(b, s, nq, d) for (_, b, s, sk, nq, nkv, d, dname, causal,
                               window, seg) in KERNEL_CASES
            if dname == "bfloat16" and causal and window is None
            and nkv == nq and sk == s and seg is None}
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
    """Llama-2-7B's width at ENGINE_LAYERS layers (random bf16 weights from
    a fixed seed) behind
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
    cfg = llama2_config("7b", num_layers=ENGINE_LAYERS)
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
    """Llama-2-7B at full width and ENGINE_LAYERS layers with int8-resident
    weights
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
    cfg = llama2_config("7b", num_layers=ENGINE_LAYERS)
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
    log(f"int8 engine: Llama-2-7B width, {cfg.num_layers} layers, weights "
        f"{bf16_bytes / 1e9:.2f} GB bf16 -> "
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
            visible_pairs=visible_pairs(1, s, s, True, None, ids))
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
# Llama-2-7B and Falcon-7B at full width, cut to TOOLCHAIN_LAYERS layers (for
# bytes; two, so that a mistake in the order of layers shows), with random
# bf16 weights from TOOLCHAIN_SEED, imported, served, finetuned and exported by the port's
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
    model.safetensors.index.json. Each tensor is drawn on the card from one
    seeded generator, uniform with a standard deviation of 0.02 (norm gains
    about 1), rounded to bf16 there and streamed to its shard. Returns
    bytes and seconds."""
    import os
    import struct

    import torch
    t0 = time.perf_counter()
    os.makedirs(out_dir)
    sizes = [2 * math.prod(shape) for _, shape in names]
    cut = next(i for i in range(len(sizes))
               if 2 * sum(sizes[:i + 1]) >= sum(sizes)) + 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
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
                x = torch.rand(shape, generator=gen, device="cuda")
                x.sub_(0.5).mul_(0.02 * 12 ** 0.5)
                if name.endswith(("norm.weight", "ln_f.weight")):
                    x.add_(1.0)
                f.write(x.to(torch.bfloat16).view(torch.int16).cpu()
                        .numpy())
                del x
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
        # phase 10 (e) needs this checkpoint: the CLI server on an HF
        # tokenizer.json
        zero_counts()
        stats["hf_tokenizer"] = serve_hf_tokenizer(llama_ckpt, corpus, root)
        stats["hf_tokenizer"]["launches"] = read_counts()
        log("window (e), in phase 9: " + json.dumps(stats["hf_tokenizer"])
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
              stats["hf_tokenizer"]["launches"],
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


# Phase 10: Mistral-7B-v0.1's published shape (h 4096, 32/8 heads, ffn
# 14336, vocab 32000, window 4096, rope theta 1e4, RMSNorm eps 1e-5, untied
# head) through llama2_config("7b", ...) overrides, with random bf16 weights
# from a seed, cut to WINDOW_LAYERS of its 32 layers (the whole smoke's time
# limit; the width is not cut). max_len 8192: the region rolls at 4096
# tokens.
WINDOW_LAYERS = 8
MISTRAL_7B = dict(num_kv_heads=8, ffn_hidden_size=14336, sliding_window=4096,
                  seq_length=8192, max_position_embeddings=8192,
                  rope_theta=1e4, norm_epsilon=1e-5)
WINDOW_SEED = 0
# (a) the serial route: one prompt longer than the window
WINDOW_SERIAL_PROMPT = 4608
WINDOW_SERIAL_NEW = 64
# (a) bf16 logprobs of the cached decode against one uncached windowed
# forward of prompt + output, the teacher-forced W8 check's tolerance
WINDOW_LOGPROB_TOL = 0.25
# (c) each engine arm: 8 concurrent requests, 37-4608 prompt tokens (3
# longer than the window), 64-256 new tokens, even ones greedy, odd ones
# sampled
WINDOW_PROMPTS = [37, 100, 700, 1500, 3000, 4100, 4400, 4608]
WINDOW_NEW = [64 + (192 * i) // 7 for i in range(8)]
WINDOW_SERVING = dict(num_slots=8, max_len=8192)
WINDOW_ARMS = {"rolling": dict(), "bracketed": dict(kv_block_size=16),
               "int8": dict(kv_dtype="int8")}
# (d) the supervisor drill on the rolling engine of WINDOW_LAYERS layers
SUPERVISOR_SERVING = dict(num_slots=2, max_len=8192,
                          engine_step_timeout_s=5.0, max_engine_restarts=2)
SUPERVISOR_STALL_S = 8.0
SUPERVISOR_MEMORY_SLACK = 64 * 2 ** 20
# (f) the training watchdog drill
WATCHDOG_STEP_TIMEOUT_S = 10
WATCHDOG_EXIT_CODE = 43


def window_prompts(seed: int, vocab: int) -> list:
    """WINDOW_PROMPTS random token lists (ids 1..vocab-1) from `seed`."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, n).tolist() for n in WINDOW_PROMPTS]


def window_sampling(i: int):
    from megatron_tpu_torch.serving import SamplingOptions
    return (SamplingOptions(temperature=0.0) if i % 2 == 0 else
            SamplingOptions(temperature=0.8, top_p=0.9))


def run_window_arm(gen, arm: dict, prompts: list) -> dict:
    """One engine arm: the requests of `prompts` submitted at once (one
    queue, 8 slots). Returns the outputs, counts and rates."""
    import torch
    from megatron_tpu_torch.config import ServingConfig
    engine_kw = dict(WINDOW_SERVING, **arm)
    from megatron_tpu_torch.serving import ServingEngine
    eng = ServingEngine(gen, ServingConfig(**engine_kw))
    try:
        check(eng.pool.rolling and eng.pool.cap == MISTRAL_7B[
            "sliding_window"], f"arm {arm}: the pool does not roll")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, WINDOW_NEW[i], window_sampling(i),
                           seed=500 + i) for i, p in enumerate(prompts)]
        outs = [r.result(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        for i, (toks, lps) in enumerate(outs):
            n_new = len(toks) - len(prompts[i])
            check(0 < n_new <= WINDOW_NEW[i],
                  f"arm {arm} request {i}: {n_new} new tokens")
            check(all(math.isfinite(x) for x in lps),
                  f"arm {arm} request {i}: non-finite logprob")
        generated = sum(len(t) - len(p) for (t, _), p in zip(outs, prompts))
        return dict(outs=[t for t, _ in outs], wall_s=wall,
                    generated_tokens=generated, tokens_per_s=generated / wall,
                    pool_bytes=eng.pool.nbytes(),
                    view_bytes=eng.pool.view_nbytes(),
                    kv_attn_path=snap["kv_attn_path"],
                    kv_gather_bytes_per_step=snap[
                        "kv_gather_bytes_per_step"],
                    decode_steps=snap["decode_steps"],
                    prefill_calls=snap["prefill_calls"],
                    ttft_p50_ms=snap["ttft_p50_ms"],
                    itl_p50_ms=snap["itl_p50_ms"])
    finally:
        eng.close()


def check_window_slice() -> dict:
    """(b) and the fp32 half of (c): a 2-layer slice of the same width in
    fp32 with TF32 off. The serial route's greedy tokens on the ring must
    equal the argmax of one uncached windowed forward, token for token;
    each engine arm's greedy tokens must equal the serial route's."""
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.models import language_model as lm
    from megatron_tpu_torch.models.language_model import LanguageModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32",
                        **MISTRAL_7B)
    model = LanguageModel(cfg, dtype=torch.float32, seed=WINDOW_SEED + 1)
    out = {}
    gens = {kv: Generator(model, cfg, eos_id=0, pad_id=0,
                          kv_cache_dtype=dt)
            for kv, dt in (("float32", torch.float32), ("int8", torch.int8))}
    prompt = window_prompts(WINDOW_SEED + 2, cfg.vocab_size)[-1]
    toks, lens, _ = gens["float32"].generate(
        [prompt], WINDOW_SERIAL_NEW, SamplingParams(temperature=0.0))
    seq = [int(t) for t in toks[0, :lens[0]]]
    with torch.inference_mode():
        logits, _ = lm.model_forward(
            model, torch.tensor([seq[:-1]], device=gens["float32"].device),
            cfg, rope=gens["float32"].rope)
    argmax = logits[0, len(prompt) - 1:].argmax(-1).tolist()
    del logits
    check(argmax == seq[len(prompt):],
          "fp32 slice: the ring's greedy tokens differ from the uncached "
          "windowed forward's argmax")
    out["serial_vs_uncached"] = dict(prompt=len(prompt),
                                     new_tokens=len(seq) - len(prompt),
                                     agree=True)
    prompts = window_prompts(WINDOW_SEED + 3, cfg.vocab_size)
    greedy = [i for i in range(len(prompts)) if i % 2 == 0]
    for name, arm in WINDOW_ARMS.items():
        gen = gens["int8" if arm.get("kv_dtype") == "int8" else "float32"]
        res = run_window_arm(gen, arm, prompts)
        serial = []
        for i in greedy:
            t, n, _ = gen.generate([prompts[i]], WINDOW_NEW[i],
                                   SamplingParams(temperature=0.0))
            serial.append([int(x) for x in t[0, :n[0]]])
        engine = [res["outs"][i] for i in greedy]
        first = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                      None) for x, y in zip(engine, serial)]
        check(engine == serial, f"fp32 slice arm {name}: greedy engine "
              f"tokens differ from the serial route's (first differing "
              f"positions {first})")
        out[name] = dict(greedy_requests=len(greedy), agree=True,
                         tokens_per_s=res["tokens_per_s"])
    del gens, model
    torch.cuda.empty_cache()
    return out


def supervisor_drill(gen, smi: str) -> dict:
    """(d) on the rolling engine (WINDOW_LAYERS), under one FaultInjector:
    a crash (the slotted requests fail typed, the queued one is served with
    a fault-free run's tokens), a stall past engine_step_timeout_s (the
    watchdog fails the in-flight requests, the engine restarts and serves
    the queued one), and a third fault, which opens the breaker.
    Allocated device memory after each restart stays within
    SUPERVISOR_MEMORY_SLACK of its reading before the faults; the seconds
    from each fault to the next served token are printed."""
    import torch
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.resilience import (FaultInjector,
                                               use_fault_injector)
    from megatron_tpu_torch.serving import (EngineUnhealthyError,
                                            RequestFailedError,
                                            SamplingOptions, ServingEngine)

    class TimedInjector(FaultInjector):
        """Notes the host time at which each serving fault fires."""

        def __init__(self):
            super().__init__()
            self.fault_times = []

        def check_serve_crash(self, call):
            if call in self.serve_crash_calls:
                self.fault_times.append(("crash", time.monotonic()))
            super().check_serve_crash(call)

        def maybe_serve_delay(self, call, sleep=time.sleep):
            if self.serve_delay_calls.get(call, 0.0) > 0.0:
                self.fault_times.append(("stall", time.monotonic()))
            return super().maybe_serve_delay(call, sleep)

    greedy = SamplingOptions(temperature=0.0)
    prompts = window_prompts(WINDOW_SEED + 4, gen.cfg.vocab_size)
    short = [p[:n] for p, n in zip(prompts, (37, 100, 150, 64, 80, 120))]
    new = 16
    eng = ServingEngine(gen, ServingConfig(**SUPERVISOR_SERVING))
    stats = dict(card=smi)
    try:
        # the fault-free run of the requests that will wait in the queue;
        # it also completes the iterations that arm the watchdog
        clean = {i: eng.submit(short[i], new, greedy).result(timeout=600)[0]
                 for i in (2, 5)}
        check(eng._watchdog is not None and eng._watchdog.started,
              "the watchdog is not armed after a full iteration")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        inj = TimedInjector()
        readings = []
        with use_fault_injector(inj):
            # 1. a crash on the first step after two requests are slotted
            inj.serve_crash_calls.add(inj._serve_steps + 2)
            a, b, q = (eng.submit(short[i], new, greedy) for i in (0, 1, 2))
            for r in (a, b):
                try:
                    r.result(timeout=600)
                    check(False, "a slotted request survived the crash")
                except RequestFailedError as e:
                    check("engine step failed" in str(e),
                          f"crash victim's error: {e}")
            check(q.result(timeout=600)[0] == clean[2],
                  "the queued request's tokens after the restart differ "
                  "from the fault-free run's")
            crash_t = inj.fault_times[-1][1]
            stats["crash_to_next_token_s"] = q.first_token_time - crash_t
            torch.cuda.synchronize()
            readings.append(torch.cuda.memory_allocated())
            # 2. a stall past the watchdog's deadline
            inj.serve_delay_calls[inj._serve_steps + 2] = SUPERVISOR_STALL_S
            a, b, q = (eng.submit(short[i], new, greedy) for i in (3, 4, 5))
            for r in (a, b):
                try:
                    r.result(timeout=600)
                    check(False, "a slotted request survived the stall")
                except RequestFailedError as e:
                    check("hung" in str(e), f"stall victim's error: {e}")
            stats["stall_detected_after_s"] = (
                max(a.finish_time, b.finish_time) - inj.fault_times[-1][1])
            check(q.result(timeout=600)[0] == clean[5],
                  "the queued request's tokens after the watchdog restart "
                  "differ from the fault-free run's")
            stats["stall_to_next_token_s"] = (q.first_token_time
                                              - inj.fault_times[-1][1])
            torch.cuda.synchronize()
            readings.append(torch.cuda.memory_allocated())
            health = eng.health()
            check(health["healthy"] and health["engine_restarts"] == 2,
                  f"after two restarts: {health}")
            # 3. a third fault: the budget of 2 is spent, the breaker opens
            inj.serve_crash_calls.add(inj._serve_steps + 1)
            r = eng.submit(short[0], new, greedy)
            try:
                r.result(timeout=600)
                check(False, "a request survived the third fault")
            except RequestFailedError as e:
                check("circuit breaker open" in str(e),
                      f"third fault's error: {e}")
            health = eng.health()
            check(not health["healthy"] and health["circuit_breaker_open"]
                  and health["state"] == "unhealthy",
                  f"after the third fault: {health}")
            try:
                eng.submit(short[1], new, greedy)
                check(False, "submit accepted with the breaker open")
            except EngineUnhealthyError:
                pass
        drift = [x - base for x in readings]
        check(all(abs(d) <= SUPERVISOR_MEMORY_SLACK for d in drift),
              f"allocated memory after the restarts moved by {drift} bytes "
              f"(slack {SUPERVISOR_MEMORY_SLACK})")
        stats.update(fired=inj.fired, restarts=eng.metrics.snapshot()[
            "engine_restarts"], memory_base_bytes=base,
            memory_after_restart_drift_bytes=drift,
            step_timeout_s=SUPERVISOR_SERVING["engine_step_timeout_s"],
            stall_s=SUPERVISOR_STALL_S)
    finally:
        eng.close()
    return stats


def write_tokenizer_json(vocab_file: str, merge_file: str,
                         out_dir: str) -> str:
    """A byte-level BPE tokenizer.json (Falcon-7B's layout without its
    Punctuation/Digits splits) holding a GPT-2 vocab.json and merges.txt,
    with <|endoftext|> as its special end token; returns the directory."""
    import os
    with open(vocab_file, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merge_file, encoding="utf-8") as f:
        merges = [line.split(" ") for line in f.read().split("\n")
                  if line and not line.startswith("#version")]
    level = {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": True}
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": vocab["<|endoftext|>"],
                              "content": "<|endoftext|>",
                              "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False,
                              "special": True}],
            "normalizer": None, "pre_tokenizer": level,
            "post_processor": None, "decoder": level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "eos_token": "<|endoftext|>"}, f)
    return out_dir


HF_TOKENIZER_TEXTS = ["the quick brown fox jumps over the lazy dog",
                      "x² + y½ = Ⅻ and 東京タワー, 中文字符串",
                      "it's   spaced\n\ttabs 12345 🙂"]


def serve_hf_tokenizer(ckpt_dir: str, corpus: dict, root: str) -> dict:
    """Phase 10 (e), run inside phase 9 on its release checkpoint: the CLI
    server with --tokenizer_type HuggingFaceTokenizer on a tokenizer.json
    written from phase 8's vocabulary and merges (--serial, greedy). The
    prompt ids it served must equal GPT2BPETokenizer's on the same texts,
    and its text the prompt's."""
    import os

    from megatron_tpu_torch.data import build_tokenizer
    tok_dir = write_tokenizer_json(corpus["vocab"], corpus["merges"],
                                   os.path.join(root, "hf_tokenizer"))
    gpt2 = build_tokenizer("GPT2BPETokenizer", vocab_file=corpus["vocab"],
                           merge_file=corpus["merges"])
    server, httpd, thread, start_s = serve_tool(
        ["--load", ckpt_dir, "--tokenizer_type", "HuggingFaceTokenizer",
         "--tokenizer_model", tok_dir, "--host", "127.0.0.1", "--port", "0",
         "--serial"])
    port = httpd.server_address[1]
    try:
        check(type(server.tokenizer).__name__ == "HFTokenizer",
              f"served with {type(server.tokenizer).__name__}")
        check(server.tokenizer.eod == gpt2.eod, "HF tokenizer eod")
        for text in HF_TOKENIZER_TEXTS:
            status, body = put(port, {"prompts": [text], "temperature": 0.0,
                                      "tokens_to_generate": 4})
            check(status == 200, f"HF tokenizer request: {status} {body}")
            ids = gpt2.tokenize(text)
            check(body["segments"][0][:len(ids)] == ids,
                  f"HF tokenizer ids differ from GPT2BPETokenizer's on "
                  f"{text!r}")
            check(body["text"][0].startswith(text),
                  f"HF tokenizer text: {body['text'][0]!r}")
    finally:
        stop_tool(httpd, thread)
    return dict(texts=len(HF_TOKENIZER_TEXTS), start_s=start_s,
                ids_equal_gpt2=True)


def watchdog_drill(smi: str) -> dict:
    """(f) python -m megatron_tpu_torch.finetune at phase 8's 2 layers in a
    subprocess, with --step_timeout_s WATCHDOG_STEP_TIMEOUT_S and
    MEGATRON_TPU_FAULTS=delay@3:<far longer>: it must exit with the
    watchdog's code, and the checkpoint its final save leaves must
    verify."""
    import os
    import shutil

    from megatron_tpu_torch.resilience import integrity
    from megatron_tpu_torch.training import checkpointing as ckpt
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_watchdog")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        corpus = pretrain_corpus(root)
        save = os.path.join(root, "ckpt")
        argv = pretrain_argv(corpus, "--train_iters", "6", "--save", save,
                             "--no_save_optim", "--step_timeout_s",
                             str(WATCHDOG_STEP_TIMEOUT_S))
        env = dict(os.environ, MEGATRON_TPU_FAULTS="delay@3:600")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "megatron_tpu_torch.finetune", *argv],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(run.returncode == WATCHDOG_EXIT_CODE,
              f"finetune under a stalled step exited {run.returncode}, not "
              f"{WATCHDOG_EXIT_CODE}: {run.stdout[-1500:]} "
              f"{run.stderr[-1500:]}")
        check("watchdog: no step progress" in run.stdout + run.stderr,
              "the watchdog's firing line is missing")
        tag = ckpt.read_tracker(save)
        check(tag == "2", f"the final checkpoint's tracker names {tag!r}")
        d = os.path.join(save, f"iter_{int(tag):07d}")
        ok, why = integrity.verify_checkpoint(d)
        check(ok, f"the watchdog's final checkpoint does not verify: {why}")
        return dict(exit_code=run.returncode, seconds=seconds,
                    checkpoint_iteration=int(tag),
                    checkpoint_bytes=sum(
                        os.path.getsize(os.path.join(d, f))
                        for f in os.listdir(d)), card=smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_window_supervisor(smi: str) -> dict:
    """Phase 10: Mistral-7B-v0.1's shape (MISTRAL_7B) at WINDOW_LAYERS
    layers with random bf16 weights: (a) the serial route on the bf16 and the int8 ring with a
    prompt longer than the window; (b) + the fp32 half of (c) on a 2-layer
    fp32 slice (check_window_slice); (c) the rolling, bracketed and int8
    rolling engine arms; (d) the supervisor drill; (e) runs inside phase 9
    (serve_hf_tokenizer); (f) the training watchdog drill. Kernel 1's
    launches are counted from just before (a) to just after (d)."""
    import gc

    import numpy as np
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.models.language_model import LanguageModel

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before "
          "phase 10: phase 9's model was not freed")
    t_phase = time.perf_counter()
    stats = dict(card=smi)
    cfg = llama2_config("7b", num_layers=WINDOW_LAYERS, **MISTRAL_7B)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=WINDOW_SEED)
    torch.cuda.synchronize()
    stats["model_build_s"] = time.perf_counter() - t0
    zero_counts()
    try:
        # (a) the serial route, bf16 and int8 rings
        prompt = window_prompts(WINDOW_SEED, cfg.vocab_size)[-1]
        check(len(prompt) == WINDOW_SERIAL_PROMPT, "serial prompt length")
        serial, gens = {}, {}
        for kv, dt in (("bfloat16", torch.bfloat16), ("int8", torch.int8)):
            gen = gens[kv] = Generator(model, cfg, eos_id=0, pad_id=0,
                                       kv_cache_dtype=dt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, lens, lps = gen.generate([prompt], WINDOW_SERIAL_NEW,
                                           SamplingParams(temperature=0.0))
            seconds = time.perf_counter() - t0
            n = int(lens[0])
            seq = [int(t) for t in toks[0, :n]]
            got = lps[0, len(prompt):n]
            check(bool(np.isfinite(got).all()), f"{kv} ring: non-finite "
                  "logprobs")
            serial[kv] = dict(new_tokens=n - len(prompt), seconds=seconds,
                              seq=seq, lps=got)
        # the bf16 ring's logprobs against one uncached windowed forward
        # of prompt + output (kernel 1 at s = prompt + output)
        seq = serial["bfloat16"]["seq"]
        forced = gens["bfloat16"].score([seq])[0, len(prompt) - 1:]
        del gens
        diff = float(np.abs(forced - serial["bfloat16"]["lps"]).max())
        check(diff <= WINDOW_LOGPROB_TOL,
              f"bf16 ring logprobs vs the uncached forward: {diff} > "
              f"{WINDOW_LOGPROB_TOL}")
        for kv in serial:
            serial[kv].pop("seq")
            serial[kv].pop("lps")
        stats["serial"] = dict(serial, prompt=len(prompt),
                               uncached_forward_tokens=len(seq),
                               bf16_logprob_max_abs_diff=diff,
                               tol=WINDOW_LOGPROB_TOL)
        log("window (a): " + json.dumps(stats["serial"]) + f" [{smi}]")

        # (c) the engine arms
        prompts = window_prompts(WINDOW_SEED + 1, cfg.vocab_size)
        check(sum(n > MISTRAL_7B["sliding_window"] for n in WINDOW_PROMPTS)
              == 3, "three prompts must be longer than the window")
        arms = {}
        for name, arm in WINDOW_ARMS.items():
            gen = Generator(model, cfg, eos_id=0, pad_id=0)
            before = read_counts()["flash_fwd_cuda"]
            res = run_window_arm(gen, arm, prompts)
            res.pop("outs")
            flash = read_counts()["flash_fwd_cuda"] - before
            check(flash == L * res["prefill_calls"],
                  f"arm {name}: flash forward launched {flash} times in "
                  f"{res['prefill_calls']} prefills of {L} layers")
            blocks = "kv_block_size" in arm
            check(res["kv_attn_path"] == (1 if blocks else 0),
                  f"arm {name}: attention path {res['kv_attn_path']}")
            check(res["kv_gather_bytes_per_step"] == (
                2 * res["view_bytes"] if blocks else 0),
                f"arm {name}: bracket bytes a step "
                f"{res['kv_gather_bytes_per_step']}")
            arms[name] = dict(res, flash_launches=flash)
            log(f"window (c) {name}: " + json.dumps(arms[name])
                + f" [{smi}]")
            gc.collect()
            torch.cuda.empty_cache()
        stats["engine_arms"] = arms

        # (d) the supervisor drill on the rolling engine
        gen = Generator(model, cfg, eos_id=0, pad_id=0)
        stats["supervisor"] = supervisor_drill(gen, smi)
        log("window (d): " + json.dumps(stats["supervisor"]))
        counts = read_counts()
    finally:
        del model
        gen = None
        gc.collect()
        torch.cuda.empty_cache()
    check(counts["flash_fwd_cuda"] > 0, "phase 10 launched no flash forward")
    stats["launches"] = {k: counts[k] for k in (
        "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
        "block_attention_cuda")}
    stats["norm_launches"] = {k: v for k, v in counts.items()
                              if k not in stats["launches"]}
    check(counts["block_attention_cuda"] == 0,
          "a sliding-window engine launched the block kernel")

    # (b) and the fp32 half of (c)
    stats["fp32_slice"] = check_window_slice()
    log("window (b, c fp32 slice): " + json.dumps(stats["fp32_slice"]))
    # (f) the training watchdog
    stats["watchdog"] = watchdog_drill(smi)
    log("window (f): " + json.dumps(stats["watchdog"]))
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"window/supervisor phase: {stats['seconds']:.1f} s, launches "
        f"{json.dumps(stats['launches'])} [{smi}]")
    return stats


# Phase 11: the engine's throughput features on Llama-2-7B at full width and
# FEATURE_LAYERS of its 32 layers (the whole smoke's time limit; the width is
# not cut) (ENGINE_SERVING plus each arm's fields), random bf16 weights
# (seed 0). (a) prefix cache: a miss of FEATURE_PREFIX shared tokens + 64, then 7
# hits; a second wave on the retained entries. (b) chunked prefill: a
# 1,900-token prompt arrives while 7 streams decode, beside the unchunked
# engine. (c) preemption: 8 priority-0 streams fill the grid, 2
# priority-1 requests arrive. (d) speculative decoding (k 4; the n-gram
# drafter, and one proposing the k-0 arm's greedy streams) beside k 0 on 8
# prompts that repeat a 32-token span.
FEATURE_SEED = 0
FEATURE_LAYERS = 8
FEATURE_PREFIX = 1536
FEATURE_SUFFIXES = [64] + [64 + (136 * i) // 6 for i in range(7)]
FEATURE_NEW = 32
CHUNK_STREAMS = 7
CHUNK_STREAM_NEW = 256
CHUNK_LONG = 1900
CHUNK_SIZE = 256
PREEMPT_LOW = (8, 300, 256)   # requests, prompt, new tokens
PREEMPT_HIGH = (2, 200, 64)
SPEC_K = 4
SPEC_PROMPT, SPEC_SPAN, SPEC_NEW = 512, 32, 128
# allocated bytes after an arm's traffic against before it
FEATURE_MEMORY_SLACK = 2 ** 20


def feature_text(first: str, n: int, seed: int) -> str:
    """An n-character prompt piece whose first character is `first`."""
    return first + prompt_text(n - 1, seed)


def spec_prompt(i: int) -> str:
    """SPEC_PROMPT characters repeating one SPEC_SPAN-character span."""
    span = prompt_text(SPEC_SPAN, 900 + i)
    return (span * (SPEC_PROMPT // SPEC_SPAN + 1))[:SPEC_PROMPT]


def feature_server(gen, tok, **fields):
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.server import MegatronServer
    return MegatronServer(gen, tok, serving=ServingConfig(
        **dict(ENGINE_SERVING, **fields)))


def serve_payloads(server, payloads):
    """Each payload through the engine route on its own thread; returns
    the (status, body) pairs in order."""
    out = [None] * len(payloads)

    def one(i):
        out[i] = server.handle(payloads[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    return threads, out


def check_bodies(what, results, prompt_lengths, news, eod):
    generated = 0
    for i, (status, body) in enumerate(results):
        check(status == 200, f"{what} request {i}: {status} {body}")
        seg, lps = body["segments"][0], body["logprobs"][0]
        n_new = len(seg) - prompt_lengths[i]
        check(0 < n_new <= news[i] and (n_new == news[i] or seg[-1] == eod),
              f"{what} request {i}: {n_new} new tokens of {news[i]}")
        check(all(math.isfinite(x) for x in lps),
              f"{what} request {i}: non-finite logprob")
        generated += n_new
    return generated


def capture_requests(engine) -> list:
    """The GenRequests the server submits, in order (for their TTFTs,
    priorities and chunk counts)."""
    made = []
    submit = engine.submit

    def recording(*a, **kw):
        req = submit(*a, **kw)
        made.append(req)
        return req

    engine.submit = recording
    return made


def wait_idle(engine, timeout=120.0):
    deadline = time.monotonic() + timeout
    while engine._active.any() or engine._prefilling \
            or engine.scheduler.depth():
        check(time.monotonic() < deadline, "engine did not go idle")
        time.sleep(0.05)


def settle(engine) -> dict:
    """The metrics once the loop has recorded its last window."""
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    last = None
    while True:
        snap = engine.metrics.snapshot()
        now = (snap["decode_steps"], block_attention_cuda.launches)
        if now == last:
            return snap
        last = now
        time.sleep(0.3)


def add_counts(out: dict, counts: dict) -> None:
    """Add one zeroed-then-read window's launch counts into out["launches"]
    (every kernel wrapper's count)."""
    total = out.setdefault("launches", {})
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def feature_prefix(gen, tok, L) -> dict:
    """(a): wave 1, the miss alone until its first token, then 7 hits of
    exactly FEATURE_PREFIX tokens (every suffix starts with its own
    character); wave 2, 8 more on the retained entries."""
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    prefix = prompt_text(FEATURE_PREFIX, 500)
    server = feature_server(gen, tok, enable_prefix_cache=True)
    engine = server.engine
    made = capture_requests(engine)
    out = {}
    try:
        # the engine's first forward of a shape pays one-time set-up that
        # the miss's TTFT should not carry
        status, _ = server.handle({"prompts": ["warm up"],
                                   "tokens_to_generate": 4,
                                   "temperature": 0.0})
        check(status == 200, f"prefix warm-up: {status}")
        wait_idle(engine)
        for wave, firsts in ((1, "abcdefgh"), (2, "ijklmnop")):
            prompts = [prefix + feature_text(firsts[i], n, 600 + 8 * wave + i)
                       for i, n in enumerate(FEATURE_SUFFIXES)]
            payloads = [{"prompts": [p], "tokens_to_generate": FEATURE_NEW,
                         "temperature": 0.0, "logprobs": True}
                        for p in prompts]
            engine.metrics = ServingMetrics()
            made.clear()
            zero_counts()
            t0 = time.perf_counter()
            if wave == 1:
                threads, res0 = serve_payloads(server, payloads[:1])
                while not made or not made[0].generated:
                    check(time.perf_counter() - t0 < 300, "miss: no token")
                    time.sleep(0.005)
                threads2, res1 = serve_payloads(server, payloads[1:])
                threads += threads2
            else:
                threads, res = serve_payloads(server, payloads)
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            res = res0 + res1 if wave == 1 else res
            generated = check_bodies(
                f"prefix wave {wave}", res,
                [len(p) for p in prompts], [FEATURE_NEW] * 8, tok.eod)
            snap = settle(engine)
            counts = read_counts()
            ttft = {id(r): r.ttft for r in made}
            w = dict(
                wall_s=wall, generated_tokens=generated,
                tokens_per_s=generated / wall,
                prefix_hits=snap["prefix_hits"],
                prefix_hit_tokens=snap["prefix_hit_tokens"],
                prefill_tokens_saved=snap["prefill_tokens_saved"],
                prefill_forward_tokens=snap["prefill_forward_tokens"],
                prefill_chunks=snap["prefill_chunks"],
                kv_blocks_retained=snap["kv_blocks_retained"],
                decode_steps=snap["decode_steps"],
                flash_launches=counts["flash_fwd_cuda"],
                block_launches=counts["block_attention_cuda"],
                ttft_ms=[ttft[id(r)] * 1e3 for r in made])
            check(w["block_launches"] == L * w["decode_steps"],
                  f"prefix wave {wave}: block kernel {w['block_launches']} "
                  f"in {w['decode_steps']} steps")
            if wave == 1:
                check(w["prefix_hits"] == 7, f"wave 1: {w['prefix_hits']} "
                      "hits, 7 expected")
                check(w["prefill_tokens_saved"] == 7 * FEATURE_PREFIX,
                      f"wave 1: {w['prefill_tokens_saved']} tokens saved")
                check(w["flash_launches"] == L, f"wave 1: flash forward "
                      f"{w['flash_launches']} times, {L} for the miss")
                w["miss_ttft_ms"] = w["ttft_ms"][0]
                w["hit_ttft_ms"] = w["ttft_ms"][1:]
            else:
                check(w["prefix_hits"] == 8 and w["kv_blocks_retained"] > 0,
                      f"wave 2: {w['prefix_hits']} hits, "
                      f"{w['kv_blocks_retained']} retained blocks")
                check(w["flash_launches"] == 0, "wave 2 ran the flash "
                      "forward")
            out[f"wave{wave}"] = w
            add_counts(out, counts)
    finally:
        server.close()
    return out


def feature_chunked(gen, tok, L) -> dict:
    """(b): CHUNK_STREAMS streams decode; the CHUNK_LONG prompt arrives
    once each has 16 tokens. With prefill_chunk it lands in 8 chunks with
    decode steps between them; the streams' inter-token gaps between its
    arrival and its first token, beside the unchunked engine's."""
    out = {}
    for arm, chunk in (("chunked", CHUNK_SIZE), ("unchunked", None)):
        server = feature_server(gen, tok, prefill_chunk=chunk)
        engine = server.engine
        made = capture_requests(engine)
        gaps = []
        record = engine.metrics.record_inter_token

        def recording(gap, record=record, gaps=gaps):
            gaps.append((time.monotonic(), gap))
            record(gap)

        engine.metrics.record_inter_token = recording
        marks = []
        advance = engine._advance_prefill

        def spying(engine=engine, advance=advance, marks=marks):
            before = engine.metrics.snapshot()["prefill_chunks"]
            steps = engine.metrics.snapshot()["decode_steps"]
            advance()
            if engine.metrics.snapshot()["prefill_chunks"] > before:
                marks.append(steps)

        engine._advance_prefill = spying
        try:
            zero_counts()
            streams = [{"prompts": [prompt_text(100, 700 + i)],
                        "tokens_to_generate": CHUNK_STREAM_NEW,
                        "temperature": 0.0, "logprobs": True}
                       for i in range(CHUNK_STREAMS)]
            long = {"prompts": [prompt_text(CHUNK_LONG, 750)],
                    "tokens_to_generate": 16, "temperature": 0.0,
                    "logprobs": True}
            t0 = time.perf_counter()
            threads, res = serve_payloads(server, streams)
            while len(made) < CHUNK_STREAMS or any(
                    len(r.generated) < 16 for r in made[:CHUNK_STREAMS]):
                check(time.perf_counter() - t0 < 300, "streams: no tokens")
                time.sleep(0.005)
            arrive = time.monotonic()
            threads2, res2 = serve_payloads(server, [long])
            for t in threads + threads2:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            snap = settle(engine)
            counts = read_counts()
            long_req = made[CHUNK_STREAMS]
            first = long_req.first_token_time
            check_bodies(f"chunked {arm}", res + res2,
                         [100] * CHUNK_STREAMS + [CHUNK_LONG],
                         [CHUNK_STREAM_NEW] * CHUNK_STREAMS + [16], tok.eod)
            during = sorted(g for t, g in gaps if arrive <= t <= first)
            check(len(during) > 0, f"{arm}: no inter-token gap while the "
                  "long prompt was admitted")
            a = dict(wall_s=wall, admission_s=first - arrive,
                     long_ttft_ms=long_req.ttft * 1e3,
                     prefill_chunks=snap["prefill_chunks"],
                     long_prefill_chunks=long_req.prefill_chunks,
                     itl_during_p50_ms=during[len(during) // 2] * 1e3,
                     itl_during_p99_ms=during[min(len(during) - 1, int(
                         0.99 * len(during)))] * 1e3,
                     itl_during_samples=len(during),
                     itl_p50_ms=snap["itl_p50_ms"],
                     decode_steps=snap["decode_steps"],
                     flash_launches=counts["flash_fwd_cuda"],
                     block_launches=counts["block_attention_cuda"])
            check(a["block_launches"] == L * a["decode_steps"],
                  f"chunked {arm}: block kernel {a['block_launches']} in "
                  f"{a['decode_steps']} steps")
            if chunk is not None:
                check(a["long_prefill_chunks"] == 8
                      and a["prefill_chunks"] == 8,
                      f"the {CHUNK_LONG}-token prompt took "
                      f"{a['long_prefill_chunks']} chunks, 8 expected")
                check(len(marks) == 8 and all(
                    b > x for x, b in zip(marks, marks[1:])),
                      f"decode steps between the chunks: {marks}")
                a["decode_steps_at_chunks"] = marks
            out[arm] = a
            add_counts(out, counts)
        finally:
            server.close()
    return out


def parked_nbytes(parked) -> int:
    sub, last = parked
    return sum(t.numel() * t.element_size() for t in
               (sub.k, sub.v, sub.k_scale, sub.v_scale, last)
               if t is not None)


def feature_preemption(gen, tok, L) -> dict:
    """(c): PREEMPT_LOW priority-0 streams fill the grid, then the
    PREEMPT_HIGH priority-1 requests arrive. Allocated bytes after the arm
    (every request done) against before it."""
    import gc
    import torch
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    server = feature_server(gen, tok, preemption=True, priority_levels=2)
    engine = server.engine
    made = capture_requests(engine)
    parked = []
    preempt = engine._preempt

    def spying(slot):
        req = engine._slot_req[slot]
        preempt(slot)
        if req.parked is not None:
            parked.append(parked_nbytes(req.parked))

    engine._preempt = spying
    try:
        status, _ = server.handle({"prompts": ["warm up"],
                                   "tokens_to_generate": 4,
                                   "temperature": 0.0})
        check(status == 200, f"preemption warm-up: {status}")
        wait_idle(engine)
        engine.metrics = ServingMetrics()  # the arm's numbers only
        made.clear()
        # earlier arms' engines sit in reference cycles until a collection
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        zero_counts()
        n_low, p_low, new_low = PREEMPT_LOW
        n_high, p_high, new_high = PREEMPT_HIGH
        low = [{"prompts": [prompt_text(p_low, 800 + i)],
                "tokens_to_generate": new_low, "logprobs": True,
                "priority": 0,
                **({"temperature": 0.0} if i % 2 == 0 else
                   {"temperature": 0.8, "top_p": 0.9,
                    "random_seed": 1100 + i})}
               for i in range(n_low)]
        high = [{"prompts": [prompt_text(p_high, 850 + i)],
                 "tokens_to_generate": new_high, "temperature": 0.0,
                 "logprobs": True, "priority": 1} for i in range(n_high)]
        t0 = time.perf_counter()
        threads, res = serve_payloads(server, low)
        while len(made) < n_low or any(len(r.generated) < 8
                                       for r in made[:n_low]):
            check(time.perf_counter() - t0 < 300, "low streams: no tokens")
            time.sleep(0.005)
        threads2, res2 = serve_payloads(server, high)
        for t in threads + threads2:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check_bodies("preemption", res + res2,
                     [p_low] * n_low + [p_high] * n_high,
                     [new_low] * n_low + [new_high] * n_high, tok.eod)
        snap = settle(engine)
        wait_idle(engine)
        counts = read_counts()
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        victims = [r for r in made[:n_low] if r.preemptions]
        out = dict(
            wall_s=wall, preemptions=snap["preemptions"],
            victims=len(victims),
            victims_finished=sum(r.state.value == "finished"
                                 for r in victims),
            high_ttft_ms=[r.ttft * 1e3 for r in made[n_low:]],
            low_ttft_p50_ms=sorted(r.ttft for r in made[:n_low])[
                n_low // 2] * 1e3,
            parked_bytes=parked, decode_steps=snap["decode_steps"],
            allocated_before=before, allocated_after=after,
            flash_launches=counts["flash_fwd_cuda"],
            block_launches=counts["block_attention_cuda"])
        add_counts(out, counts)
        check(out["preemptions"] >= 1 and victims
              and out["victims_finished"] == len(victims),
              f"preemption: {out['preemptions']} preemptions, "
              f"{out['victims_finished']}/{len(victims)} victims finished")
        check(len(parked) == out["preemptions"], "a victim was not parked")
        check(abs(after - before) <= FEATURE_MEMORY_SLACK,
              f"allocated bytes after the preemption arm {after} vs "
              f"{before} before")
        check(out["block_launches"] == L * out["decode_steps"],
              f"preemption: block kernel {out['block_launches']} in "
              f"{out['decode_steps']} steps")
    finally:
        server.close()
    return out


class StreamDrafter:
    """Proposes the continuation of known token streams (the plain arm's
    greedy outputs): a random model seldom repeats a span, so the n-gram
    drafter's proposals are few and rejected, and this drafter shows what
    accepted rounds buy on the same traffic."""

    def __init__(self, streams):
        self.streams = streams

    def propose(self, tokens, n):
        for seq in self.streams:
            if seq[:len(tokens)] == list(tokens):
                return seq[len(tokens):len(tokens) + n]
        return []


def feature_spec(gen, tok, L) -> dict:
    """(d): 8 requests of SPEC_PROMPT tokens repeating a SPEC_SPAN span,
    SPEC_NEW new tokens, half greedy, with speculative_k 0, then SPEC_K with
    the n-gram drafter, then SPEC_K with a drafter proposing the k-0 arm's
    greedy streams. The block kernel is held against its plain version on
    the live state of one verify round (w = SPEC_K + 1)."""
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    out = {}
    payloads = [{"prompts": [spec_prompt(i)], "tokens_to_generate": SPEC_NEW,
                 "logprobs": True,
                 **({"temperature": 0.0} if i % 2 == 0 else
                    {"temperature": 0.8, "top_p": 0.9,
                     "random_seed": 1200 + i})} for i in range(8)]
    captured = {}
    live = {}

    def recording(q, k_arena, v_arena, block_map, lengths, **kw):
        if (not captured and q.shape[1] == SPEC_K + 1
                and int(live["engine"]._active.sum()) >= 6):
            captured.update(q=q.clone(), k=k_arena.clone(),
                            v=v_arena.clone(), map=block_map.clone(),
                            lengths=lengths.clone(), kw=kw)
        return block_attention_cuda(q, k_arena, v_arena, block_map,
                                    lengths, **kw)

    streams = []
    for arm, k in (("plain", 0), ("speculative", SPEC_K),
                   ("speculative_streams", SPEC_K)):
        server = feature_server(gen, tok, speculative_k=k)
        engine = live["engine"] = server.engine
        if arm == "speculative_streams":
            engine.drafter = StreamDrafter(streams)
        made = capture_requests(engine)
        try:
            status, _ = server.handle({"prompts": ["warm up"],
                                       "tokens_to_generate": 4,
                                       "temperature": 0.0})
            check(status == 200, f"spec warm-up: {status}")
            wait_idle(engine)
            engine.metrics = ServingMetrics()
            if k:
                ba.block_attention_cuda = recording
            zero_counts()
            made.clear()
            t0 = time.perf_counter()
            threads, res = serve_payloads(server, payloads)
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            greedy = [r for r in made if r.sampling.temperature == 0.0]
            decode_s = sorted(r.finish_time - r.first_token_time
                              for r in greedy)
            generated = check_bodies(f"spec {arm}", res, [SPEC_PROMPT] * 8,
                                     [SPEC_NEW] * 8, tok.eod)
            if arm == "plain":
                streams = [body["segments"][0] for i, (_, body)
                           in enumerate(res) if i % 2 == 0]
            snap = settle(engine)
            counts = read_counts()
        finally:
            ba.block_attention_cuda = block_attention_cuda
            server.close()
        steps = snap["spec_rounds"] + snap["spec_fallback_steps"]
        a = dict(wall_s=wall, generated_tokens=generated,
                 tokens_per_s=generated / wall,
                 # the greedy requests' first token to last, the latency
                 # accepted drafts shorten
                 greedy_decode_s_median=decode_s[len(decode_s) // 2],
                 greedy_tokens_per_s=sum(len(r.generated) - 1
                                         for r in greedy) / sum(decode_s),
                 itl_p50_ms=snap["itl_p50_ms"],
                 itl_p99_ms=snap["itl_p99_ms"],
                 spec_rounds=snap["spec_rounds"],
                 spec_fallback_steps=snap["spec_fallback_steps"],
                 draft_tokens=snap["draft_tokens"],
                 accepted_tokens=snap["accepted_tokens"],
                 host_syncs=snap["host_syncs"],
                 decode_steps=snap["decode_steps"],
                 flash_launches=counts["flash_fwd_cuda"],
                 block_launches=counts["block_attention_cuda"])
        if k:
            a["acceptance"] = (a["accepted_tokens"] / a["draft_tokens"]
                               if a["draft_tokens"] else 0.0)
            a["syncs_per_round"] = a["host_syncs"] / max(steps, 1)
            a["tokens_per_step"] = generated / max(steps, 1)
            check(a["spec_rounds"] > 0, "no verify round ran")
            if arm == "speculative_streams":
                check(a["accepted_tokens"] > 0, "no draft of the known "
                      "greedy streams was accepted")
            check(a["block_launches"] == L * steps,
                  f"block kernel {a['block_launches']} in {steps} rounds "
                  f"and fallback steps of {L} layers")
            check(a["syncs_per_round"] <= 1.0, "more than one host read a "
                  "round")
        else:
            check(a["block_launches"] == L * a["decode_steps"],
                  "plain arm: block kernel launches")
        out[arm] = a
        add_counts(out, counts)
    live.clear()
    check(bool(captured), "no verify round with >= 6 live slots ran")
    c = captured
    got = block_attention_cuda(c["q"], c["k"], c["v"], c["map"],
                               c["lengths"], **c["kw"])
    ref = ba.block_attention_reference(c["q"], c["k"], c["v"], c["map"],
                                       c["lengths"], scale=c["kw"]["scale"])
    err = (got.float() - ref.float()).abs().max().item()
    import torch
    check(bool(torch.isfinite(got).all()) and err <= BLOCK_LIVE_TOL,
          f"block kernel on a live verify round: err {err}")
    out["live_verify_check"] = dict(
        w=int(c["q"].shape[1]), max_abs_err=err, tol=BLOCK_LIVE_TOL,
        max_abs_ref=ref.float().abs().max().item(),
        lengths=c["lengths"].tolist())
    captured.clear()
    return out


def check_features_slice() -> dict:
    """(e): a 2-layer fp32 slice of the 7B width (TF32 off). Greedy tokens
    equal with each feature on, with each off, and on the serial route;
    preemption victims (half sampled and seeded) equal their unpreempted
    run when parked and when forced to replay; a seeded sampled request
    under speculative_k equal alone and among 7 others."""
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    model = LanguageModel(cfg, dtype=torch.float32, seed=1)
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod,
                    kv_cache_dtype=torch.float32)
    prefix = prompt_text(512, 1300)
    first = {"prompts": [prefix + feature_text("a", 40, 1301)],
             "tokens_to_generate": 24, "temperature": 0.0}
    rest = [{"prompts": [p], "tokens_to_generate": 24, "temperature": 0.0}
            for p in (prefix + feature_text("b", 100, 1302),
                      spec_prompt(7)[:300], prompt_text(700, 1303))]
    arms = dict(plain={}, prefix=dict(enable_prefix_cache=True),
                chunked=dict(prefill_chunk=CHUNK_SIZE),
                preemption=dict(preemption=True, priority_levels=2),
                speculative=dict(speculative_k=SPEC_K))
    outs, stats = {}, {}
    for arm, fields in arms.items():
        server = feature_server(gen, tok, **fields)
        try:
            status, body = server.handle(first)
            check(status == 200, f"fp32 slice {arm}: {status}")
            segs = body["segments"]
            threads, res = serve_payloads(server, rest)
            for t in threads:
                t.join(timeout=300)
            for status, body in res:
                check(status == 200, f"fp32 slice {arm}: {status}")
                segs += body["segments"]
            outs[arm] = segs
            stats[arm] = {k: v for k, v in server.engine.metrics.snapshot()
                          .items() if k in ("prefix_hits", "prefill_chunks",
                                            "spec_rounds", "accepted_tokens")}
            if arm == "plain":
                serial = []
                for p in [first] + rest:
                    status, body = server.handle(dict(p, serial=True))
                    check(status == 200, f"fp32 slice serial: {status}")
                    serial += body["segments"]
                outs["serial"] = serial
        finally:
            server.close()
    check(all(o == outs["plain"] for o in outs.values()),
          "fp32 slice: greedy tokens differ between "
          + ", ".join(a for a, o in outs.items() if o != outs["plain"]))
    check(stats["prefix"]["prefix_hits"] >= 1
          and stats["chunked"]["prefill_chunks"] >= 3
          and stats["speculative"]["spec_rounds"] >= 1,
          f"fp32 slice: a feature did not run: {stats}")

    # preemption victims: parked, replayed and unpreempted
    low = [{"prompts": [prompt_text(120, 1310 + i)], "tokens_to_generate": 48,
            "priority": 0,
            **({"temperature": 0.0} if i % 2 == 0 else
               {"temperature": 0.8, "top_p": 0.9, "random_seed": 1400 + i})}
           for i in range(8)]
    high = [{"prompts": [prompt_text(60, 1320 + i)], "tokens_to_generate": 8,
             "temperature": 0.0, "priority": 1} for i in range(2)]
    victims = {}
    for arm in ("unpreempted", "parked", "replay"):
        server = feature_server(gen, tok, preemption=arm != "unpreempted",
                                priority_levels=2)
        engine = server.engine
        made = capture_requests(engine)
        if arm == "replay":
            engine.scheduler.parked_count = lambda: engine.num_slots
        try:
            t0 = time.perf_counter()
            threads, res = serve_payloads(server, low)
            while len(made) < 8 or any(len(r.generated) < 4
                                       for r in made[:8]):
                check(time.perf_counter() - t0 < 120, "slice low streams")
                time.sleep(0.002)
            threads2, res2 = serve_payloads(server, high)
            for t in threads + threads2:
                t.join(timeout=300)
            for status, body in res + res2:
                check(status == 200, f"fp32 slice {arm}: {status}")
            victims[arm] = [b["segments"] for _, b in res]
            n = server.engine.metrics.snapshot()["preemptions"]
            check((n >= 1) == (arm != "unpreempted"),
                  f"fp32 slice {arm}: {n} preemptions")
        finally:
            server.close()
    check(victims["parked"] == victims["unpreempted"] == victims["replay"],
          "fp32 slice: preemption victims differ from their unpreempted run")

    # a seeded sampled stream under speculative_k, alone and among 7
    target = {"prompts": [spec_prompt(3)[:256]], "tokens_to_generate": 48,
              "temperature": 0.8, "top_p": 0.9, "random_seed": 77}
    others = [{"prompts": [spec_prompt(10 + i)[:200]],
               "tokens_to_generate": 40,
               **({"temperature": 0.0} if i % 2 else
                  {"temperature": 0.9, "random_seed": 90 + i})}
              for i in range(7)]
    alone_among = []
    for crowd in ([], others):
        server = feature_server(gen, tok, speculative_k=SPEC_K)
        try:
            threads, res = serve_payloads(server, [target] + crowd)
            for t in threads:
                t.join(timeout=300)
            for status, body in res:
                check(status == 200, f"fp32 slice spec: {status}")
            alone_among.append(res[0][1]["segments"])
        finally:
            server.close()
    check(alone_among[0] == alone_among[1], "fp32 slice: a seeded sampled "
          "stream under speculative_k depends on the other slots")
    del gen, model
    torch.cuda.empty_cache()
    return dict(arms=sorted(outs), agree=True, feature_counts=stats,
                victims_parked_replay_equal=True,
                spec_stream_grid_independent=True, allow_tf32=False)


def phase_engine_features(smi: str) -> dict:
    """Phase 11: (a)-(d) on Llama-2-7B at full width and FEATURE_LAYERS
    layers behind the engine route, launch counts zeroed before each arm and read after it;
    (e) the 2-layer fp32 slice."""
    import gc
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before "
          "phase 11: phase 10's model was not freed")
    t_phase = time.perf_counter()
    cfg = llama2_config("7b", num_layers=FEATURE_LAYERS)
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=FEATURE_SEED)
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod)
    L = cfg.num_layers
    stats = dict(card=smi)
    try:
        for name, fn in (("prefix", feature_prefix),
                         ("chunked", feature_chunked),
                         ("preemption", feature_preemption),
                         ("speculative", feature_spec)):
            t0 = time.perf_counter()
            stats[name] = fn(gen, tok, L)
            stats[name]["seconds"] = time.perf_counter() - t0
            log(f"engine features ({name}): " + json.dumps(stats[name]))
    finally:
        del gen, model
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats["slice"] = check_features_slice()
    stats["slice"]["seconds"] = time.perf_counter() - t0
    log("engine features slice (fp32, 2 layers): "
        + json.dumps(stats["slice"]))
    total = {}
    for arm in ("prefix", "chunked", "preemption", "speculative"):
        add_counts(stats, stats[arm]["launches"])
        total[arm] = stats[arm]["launches"]
    launches = stats["launches"]
    # the kernels line's keys: flash and block counts, and the norm
    # kernels' under their wrappers' names
    stats["launches"] = dict(flash_fwd=launches["flash_fwd_cuda"],
                             block_attn=launches["block_attention_cuda"])
    stats["norm_launches"] = {k: v for k, v in launches.items()
                              if k.startswith(("rms_", "ln_"))}
    stats["launches_by_arm"] = total
    stats["seconds"] = time.perf_counter() - t_phase
    return stats


# Phase 12, the front door: Llama-2-7B at full width, FRONT_LAYERS of its 32
# layers (the whole smoke's time limit; the width is not cut), random bf16
# weights (seed FRONT_SEED), behind MegatronServer, ENGINE_SERVING with the
# prefix cache (`front_server`). Group prefixes of FRONT_PREFIX tokens; a
# request is a group's prefix and its own suffix (each starting with its
# own character, so a hit is exactly the prefix). The parts (b)-(d) send prefix hits on prefixes warmed alone
# on every replica: a hit's suffix forwards at batch 1 and the decode grid
# has a fixed shape, so a request's tokens do not depend on the other
# requests it ran beside, and a failed-over request regenerates the
# one-replica run's tokens bit for bit, sampled ones too (seeded).
FRONT_SEED = 0
FRONT_LAYERS = 8
FRONT_GROUPS = 4
FRONT_PREFIX = 1024
FRONT_NEW = 128
FRONT_STREAM_NEW = 256
# the wedge: the watchdog's deadline, the router's heartbeat and the stall
WEDGE_TIMEOUT_S = 3.0
WEDGE_HEARTBEAT_S = 2.0
WEDGE_STALL_S = 8.0
# the host tier: two retained entries on the card, 4 GiB of host RAM, four
# distinct 1,536-token prefixes
TIER_PREFIX = 1536
TIER_BYTES = 4 << 30
TIER_NEW = 16
SSE_DROP_AT = 10
SSE_CANCEL_AT = 20


def front_payloads(prefixes, first: int, count: int, new: int,
                   seed: int) -> list:
    """`count` payloads over the groups in turn: the group's prefix and a
    64-200-character suffix starting with the (first + j)-th letter (a set
    of payloads takes letters no other set of the same prefixes takes, so
    a hit is exactly the prefix), odd ones sampled (seeded)."""
    out = []
    for j in range(count):
        first_char = "abcdefghijklmnopqrstuvwxyz"[first + j]
        p = {"prompts": [prefixes[j % FRONT_GROUPS] + feature_text(
                 first_char, 64 + (136 * j) // max(count - 1, 1),
                 seed + j)],
             "tokens_to_generate": new, "logprobs": True}
        p.update({"temperature": 0.0} if j % 2 == 0 else
                 {"temperature": 0.8, "top_p": 0.9,
                  "random_seed": seed + 100 + j})
        out.append(p)
    return out


def front_server(gen, tok, **fields):
    """MegatronServer over `gen`: ENGINE_SERVING, the prefix cache and
    `fields`."""
    return feature_server(gen, tok, enable_prefix_cache=True, **fields)


def warm_prefixes(engines, prefixes) -> None:
    """Each group's prefix prefilled alone (batch 1) on every engine, the
    same way in every run, and retained."""
    from megatron_tpu_torch.serving import SamplingOptions
    tok = ByteTokenizer()
    for eng in engines:
        for p in prefixes:
            eng.generate(tok.tokenize(p + " "), 1,
                         SamplingOptions(temperature=0.0))


def http_waves(port, waves) -> tuple:
    """Each wave's payloads over HTTP from one thread each, a wave after
    the last one returned. Returns (results in order, wall seconds)."""
    res = []
    t0 = time.perf_counter()
    for wave in waves:
        out = [None] * len(wave)

        def one(i, wave=wave, out=out):
            out[i] = put(port, wave[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(wave))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        res += out
    return res, time.perf_counter() - t0


def serve_http(server):
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def new_tokens(payload, body) -> list:
    """The generated tokens of a completion (ByteTokenizer: one token a
    prompt character)."""
    return body["segments"][0][len(payload["prompts"][0]):]


def front_router_waves(server, port, payloads, L) -> dict:
    """(a): the 16 payloads in two waves of 8 (two a group each), so each
    group's second wave is routed by affinity. Per replica: picks, prefix
    hits, tokens/s, TTFT p50/p99; the card's peak memory."""
    import torch
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    router = server.engine
    engines = getattr(router, "engines", [router])
    made = capture_requests(router)
    waves = [[p for j, p in enumerate(payloads) if (j // FRONT_GROUPS) % 2
              == w] for w in (0, 1)]
    for eng in engines:
        eng.metrics = ServingMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = read_counts()
    res1, wall1 = http_waves(port, waves[:1])
    mid = [eng.metrics.snapshot() for eng in engines]
    res2, wall2 = http_waves(port, waves[1:])
    snaps = [settle(eng) for eng in engines]
    counts = {k: v - start[k] for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    res = res1 + res2
    prompts = [len(w["prompts"][0]) for w in waves[0] + waves[1]]
    generated = check_bodies("front door (a)", res, prompts,
                             [FRONT_NEW] * len(res), ByteTokenizer().eod)
    wall = wall1 + wall2
    hits2 = sum(s["prefix_hits"] - m["prefix_hits"]
                for s, m in zip(snaps, mid))
    saved2 = sum(s["prefill_tokens_saved"] - m["prefill_tokens_saved"]
                 for s, m in zip(snaps, mid))
    steps = sum(s["decode_steps"] for s in snaps)
    out = dict(wall_s=wall, generated_tokens=generated,
               tokens_per_s=generated / wall, peak_gib=peak / 2 ** 30,
               wave2_prefix_hits=hits2, wave2_tokens_saved=saved2,
               decode_steps=steps, launches=counts, replicas=[])
    # a bare engine's requests are all its own
    picked = [r.replica.idx if hasattr(r, "replica") else 0 for r in made]
    for idx, (eng, s) in enumerate(zip(engines, snaps)):
        out["replicas"].append(dict(
            picks=picked.count(idx),
            prefix_hits=s["prefix_hits"],
            tokens_generated=s["tokens_generated"],
            tokens_per_s=s["tokens_generated"] / wall,
            ttft_p50_ms=s["ttft_p50_ms"], ttft_p99_ms=s["ttft_p99_ms"],
            itl_p50_ms=s["itl_p50_ms"], decode_steps=s["decode_steps"],
            pool_gib=eng.pool.nbytes() / 2 ** 30))
    check(hits2 == len(waves[1]) and saved2 == len(waves[1]) * FRONT_PREFIX,
          f"(a) wave 2: {hits2} prefix hits saving {saved2} tokens, "
          f"{len(waves[1])} x {FRONT_PREFIX} expected")
    check(counts["block_attention_cuda"] == L * steps,
          f"(a): block kernel {counts['block_attention_cuda']} in {steps} "
          f"steps of {L} layers")
    return out


def front_wedge(server, payloads) -> tuple:
    """(c): the payloads decode on both replicas; then the next engine step
    (on either) stalls for WEDGE_STALL_S, past the watchdog's
    WEDGE_TIMEOUT_S. Its in-flight requests fail and the router retries
    them on the other replica; the router ejects the wedged replica after
    WEDGE_HEARTBEAT_S, its supervisor restarts it when the stall returns,
    one canary promotes it and both replicas end UP. Returns (the stats,
    the wedged replica)."""
    from megatron_tpu_torch.resilience import faults
    router = server.engine
    before = router.metrics.snapshot()
    made = capture_requests(router)
    threads, res = serve_payloads(server, payloads)
    t0 = time.monotonic()
    while len(made) < len(payloads) or any(len(r.generated) < 8
                                           for r in made):
        check(time.monotonic() - t0 < 300, "(c): the payloads did not "
              "start decoding")
        time.sleep(0.005)
    busy = {r.replica.idx for r in made}
    inj = faults.FaultInjector(serve_delay_calls={1: WEDGE_STALL_S})
    faults.activate(inj)
    marks = {}
    try:
        while not inj.fired:
            check(time.monotonic() - t0 < 300, "(c): no engine step ran")
            time.sleep(0.001)
        marks["fired"] = time.monotonic()
        faults.deactivate()
        wedged = None
        while "up" not in marks:
            now = time.monotonic()
            check(now - marks["fired"] < WEDGE_STALL_S + 120,
                  f"(c): no recovery: {marks}")
            h = router.health()
            for rep, rh in zip(router.replicas, h["replicas"]):
                if wedged is None and rh["state"] == "wedged":
                    wedged = rep
                    marks["watchdog"] = now
            if wedged is not None:
                if wedged.state == "down" and "down" not in marks:
                    marks["down"] = now
                if "down" in marks and wedged.state == "probing" \
                        and "probing" not in marks:
                    marks["probing"] = now
                    # the canary: the next request goes to the probing
                    # replica
                    status, _ = server.handle(
                        {"prompts": ["canary"], "tokens_to_generate": 4,
                         "temperature": 0.0})
                    check(status == 200, f"(c) canary: {status}")
                if "probing" in marks and wedged.state == "up" \
                        and h["replicas_up"] == 2:
                    marks["up"] = now
            time.sleep(0.05)
    finally:
        faults.deactivate()
    for t in threads:
        t.join(timeout=600)
    after = router.metrics.snapshot()
    h = router.health()
    retried = sum(1 for r in made if r.attempts)
    check(all(status == 200 for status, _ in res),
          f"(c): {[s for s, _ in res]}")
    check(h["state"] == "running" and h["replicas_up"] == 2,
          f"(c): router {h['state']}, {h['replicas_up']} up")
    restarts = wedged.engine.health()["engine_restarts"]
    check(restarts == 1, f"(c): the wedged replica restarted {restarts} "
          "times")
    check(retried >= 1 and after["router_retries"]
          - before["router_retries"] == retried,
          f"(c): {retried} requests retried, router_retries "
          f"{after['router_retries'] - before['router_retries']}")
    return dict(
        busy_replicas=sorted(busy), wedged_replica=wedged.idx,
        retried=retried, router_failovers=after["router_failovers"]
        - before["router_failovers"],
        watchdog_s=marks["watchdog"] - marks["fired"],
        detect_s=marks["down"] - marks["fired"],
        readmit_s=marks["up"] - marks["fired"],
        readmit_after_stall_s=marks["up"] - marks["fired"] - WEDGE_STALL_S,
        stall_s=WEDGE_STALL_S, engine_step_timeout_s=WEDGE_TIMEOUT_S,
        heartbeat_s=WEDGE_HEARTBEAT_S,
        bodies=[body for _, body in res]), wedged


def sse_open(port, payload, headers=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("PUT", "/api", body=json.dumps(payload),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    check(resp.status == 200
          and resp.getheader("Content-Type") == "text/event-stream",
          f"SSE: {resp.status} {resp.getheader('Content-Type')}")
    return conn, resp


def sse_frames(resp):
    """(event, id, data, arrival time) per frame, as the frames arrive."""
    fields = {}
    while True:
        line = resp.readline()
        if not line:
            return
        line = line.decode().rstrip("\n")
        if line:
            k, _, v = line.partition(": ")
            fields[k] = v
            continue
        if fields:
            yield (fields.get("event"), fields.get("id"),
                   json.loads(fields["data"]), time.perf_counter())
            fields = {}


def front_sse(server, port, payloads) -> dict:
    """(d): one stream per payload over HTTP, all at once. Stream 0's
    client drops after event SSE_DROP_AT and resumes with Last-Event-ID;
    stream 1 is cancelled after event SSE_CANCEL_AT. The inter-event gaps
    the clients see; the allocated bytes before and after."""
    import gc
    import torch
    router = server.engine
    before = router.aggregate_snapshot()
    gc.collect()
    torch.cuda.synchronize()
    alloc_before = torch.cuda.memory_allocated()
    streams = [dict(tokens=[], times=[], events=[]) for _ in payloads]

    def run(i):
        st = streams[i]
        conn, resp = sse_open(port, dict(payloads[i], stream=True))
        try:
            for event, eid, data, t in sse_frames(resp):
                st["events"].append(event)
                if event == "start":
                    st["sid"] = data["stream_id"]
                elif event == "token":
                    check(int(eid) == len(st["tokens"]),
                          f"stream {i}: event id {eid} after "
                          f"{len(st['tokens'])} tokens")
                    st["tokens"].append(data["token"])
                    st["times"].append(t)
                    if i == 0 and int(eid) == SSE_DROP_AT:
                        break  # the client drops
                    if i == 1 and int(eid) == SSE_CANCEL_AT:
                        cancel(st)
                else:
                    st["end"] = (event, data)
        finally:
            conn.close()
        if i == 0:
            # the resume: the header names the last event seen
            st["dropped_at"] = len(st["tokens"])
            conn, resp = sse_open(port, {"stream": True,
                                         "stream_id": st["sid"]},
                                  headers={"Last-Event-ID":
                                           str(SSE_DROP_AT)})
            try:
                for event, eid, data, t in sse_frames(resp):
                    st["events"].append(event)
                    if event == "start":
                        check(data["resumed"] and data["next_index"]
                              == SSE_DROP_AT + 1, f"resume start {data}")
                    elif event == "token":
                        check(int(eid) == len(st["tokens"]),
                              f"resumed stream: event id {eid} after "
                              f"{len(st['tokens'])} tokens")
                        st["tokens"].append(data["token"])
                        st["resumed_times"] = st.get("resumed_times", [])
                        st["resumed_times"].append(t)
                    else:
                        st["end"] = (event, data)
            finally:
                conn.close()

    def cancel(st):
        rreq = server._streams[st["sid"]].req
        eng = rreq.replica.engine
        st["steps_at_cancel"] = eng.metrics.snapshot()["decode_steps"]
        status, body = put(port, {"stream_id": st["sid"], "cancel": True})
        check(status == 200 and body["cancelled"], f"cancel: {body}")
        inner = rreq.inner
        give_up = time.monotonic() + 60
        while not inner.done() or inner in eng._slot_req:
            check(time.monotonic() < give_up, "the cancelled slot stayed")
            time.sleep(0.001)
        st["steps_to_free"] = (eng.metrics.snapshot()["decode_steps"]
                               - st["steps_at_cancel"])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    engines = router.engines
    for eng in engines:
        wait_idle(eng)
    after = router.aggregate_snapshot()
    gc.collect()
    torch.cuda.synchronize()
    alloc_after = torch.cuda.memory_allocated()
    gaps = sorted(b - a for st in streams
                  for ts in (st["times"], st.get("resumed_times", []))
                  for a, b in zip(ts, ts[1:]))
    for i, st in enumerate(streams):
        check("end" in st, f"stream {i}: no terminal event")
        want = "error" if i == 1 else "done"
        check(st["end"][0] == want, f"stream {i}: ended {st['end']}")
    check(streams[1]["end"][1]["status"] == 500
          and streams[1]["end"][1]["committed"] < FRONT_STREAM_NEW,
          f"cancelled stream: {streams[1]['end']}")
    check(streams[1]["steps_to_free"] <= 1,
          f"the cancelled slot freed after {streams[1]['steps_to_free']} "
          "decode steps")
    check(after["requests_cancelled"] - before["requests_cancelled"] == 1,
          "requests_cancelled did not move by 1")
    check(after["stream_reconnects"] - before["stream_reconnects"] == 1,
          "stream_reconnects did not move by 1")
    check(abs(alloc_after - alloc_before) <= FEATURE_MEMORY_SLACK,
          f"allocated bytes after the streams {alloc_after} vs "
          f"{alloc_before} before")
    return dict(
        streams=len(payloads), wall_s=wall,
        tokens=sum(len(st["tokens"]) for st in streams),
        gap_p50_ms=gaps[len(gaps) // 2] * 1e3,
        gap_p99_ms=gaps[min(len(gaps) - 1, int(0.99 * len(gaps)))] * 1e3,
        gap_samples=len(gaps), dropped_at=streams[0]["dropped_at"],
        cancelled_after=len(streams[1]["tokens"]),
        cancel_steps_to_free=streams[1]["steps_to_free"],
        allocated_before=alloc_before, allocated_after=alloc_after,
        stream_tokens=[st["tokens"] for st in streams])


def front_failover(server, payloads) -> dict:
    """(b): the payloads in flight on both replicas, every one with 8
    tokens; then the replica holding the most of them is closed. Every
    future resolves; router_failovers moves by 1 and router_retries by the
    killed replica's requests; /healthz reports degraded and a new request
    succeeds. The block kernel is held against its plain version on the
    survivor's state after the failover."""
    import torch
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    router = server.engine
    before = router.metrics.snapshot()
    made = capture_requests(router)
    captured, armed = {}, {}

    def recording(q, k_arena, v_arena, block_map, lengths, **kw):
        if armed and not captured and int(
                armed["survivor"].engine._active.sum()) >= 6:
            captured.update(q=q.clone(), k=k_arena.clone(),
                            v=v_arena.clone(), map=block_map.clone(),
                            lengths=lengths.clone(), kw=kw)
        return block_attention_cuda(q, k_arena, v_arena, block_map,
                                    lengths, **kw)

    ba.block_attention_cuda = recording
    try:
        threads, res = serve_payloads(server, payloads)
        t0 = time.monotonic()
        while len(made) < len(payloads) or any(len(r.generated) < 8
                                               for r in made):
            check(time.monotonic() - t0 < 300, "(b): the payloads did not "
                  "start decoding")
            time.sleep(0.005)
        victim = max(router.replicas, key=lambda rep: sum(
            1 for r in made if r.replica is rep and not r.done()))
        survivor = next(rep for rep in router.replicas if rep is not victim)
        victims = [r for r in made if r.replica is victim and not r.done()]
        armed["survivor"] = survivor
        t_kill = time.monotonic()
        victim.engine.close()
        for t in threads:
            t.join(timeout=600)
        t_last = max(r.inner.finish_time for r in victims)
        counts = read_counts()
    finally:
        ba.block_attention_cuda = block_attention_cuda
    after = router.metrics.snapshot()
    check(all(status == 200 for status, _ in res),
          f"(b): {[s for s, _ in res]}")
    check(after["router_failovers"] - before["router_failovers"] == 1,
          "(b): router_failovers did not move by 1")
    check(after["router_retries"] - before["router_retries"]
          == len(victims), f"(b): router_retries moved by "
          f"{after['router_retries'] - before['router_retries']}, "
          f"{len(victims)} requests were on the killed replica")
    status, h = server.healthz()
    check(status == 200 and h["state"] == "degraded",
          f"(b) /healthz: {status} {h['state']}")
    status, _ = server.handle({"prompts": ["after the kill"],
                               "tokens_to_generate": 8, "temperature": 0.0})
    check(status == 200, f"(b): a request after the kill: {status}")
    check(bool(captured), "(b): no decode step of the survivor captured")
    c = captured
    got = block_attention_cuda(c["q"], c["k"], c["v"], c["map"],
                               c["lengths"], **c["kw"])
    ref = ba.block_attention_reference(c["q"], c["k"], c["v"], c["map"],
                                       c["lengths"], scale=c["kw"]["scale"])
    err = (got.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()) and err <= BLOCK_LIVE_TOL,
          f"block kernel on the survivor's live state: err {err}")
    live = dict(max_abs_err=err, tol=BLOCK_LIVE_TOL,
                max_abs_ref=ref.float().abs().max().item(),
                lengths=c["lengths"].tolist())
    captured.clear()
    del c, got, ref
    return dict(killed_replica=victim.idx, in_flight=len(payloads),
                on_killed_replica=len(victims),
                router_failovers=1, router_retries=len(victims),
                kill_to_last_retried_s=t_last - t_kill,
                health_state=h["state"], live_state_check=live,
                launches=counts, bodies=[body for _, body in res])


def front_tier(gen, tok) -> dict:
    """(e): one engine with retained_slots 2 and TIER_BYTES of host RAM.
    Four distinct TIER_PREFIX-token prefixes (each request alone) force two
    demotions (demotions must equal evictions); a later hit on the first
    prefix restores from the host; then a device hit and a miss, for their
    TTFTs. Then the fault harness's serve_host_corrupt flips one demoted
    entry, and the next hit on it is a checksum miss. Copy, checksum and
    upload seconds and bytes, and MemAvailable."""
    import torch
    from megatron_tpu_torch.resilience import faults
    from megatron_tpu_torch.serving import host_tier as ht
    server = front_server(gen, tok, retained_slots=2,
                          host_kv_bytes=TIER_BYTES)
    engine = server.engine
    pool, tier = engine.pool, engine._host_tier
    timing = dict(evictions=0, demote_s=[], copy_s=[], copy_bytes=[],
                  crc_s={"demote": [], "restore": []}, restore_s=[],
                  upload_s=[], upload_bytes=[])
    phase = {"now": None}
    evict, on_evict = pool._evict_retained, pool.on_evict_entry
    gather, to_sub = pool.gather_blocks_host, pool.host_blocks_to_sub
    restore_host, checksum = engine._restore_host, ht._checksum
    demote, restore = tier.demote, tier.restore

    def timed(fn, key, label=None):
        def wrapper(*a, **kw):
            prev = phase["now"]
            if label is not None:
                phase["now"] = label
            t = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if key in ("upload_s", "restore_s"):
                    torch.cuda.synchronize()
                return out
            finally:
                dt = time.perf_counter() - t
                (timing[key][phase["now"]] if key == "crc_s"
                 else timing[key]).append(dt)
                phase["now"] = prev
        return wrapper

    def counting_evict():
        timing["evictions"] += 1
        return evict()

    def copy(blocks):
        out = timed(gather, "copy_s")(blocks)
        timing["copy_bytes"].append(sum(a.nbytes for a in out.values()))
        return out

    def upload(arrays, plen, pad_to_cap=True):
        timing["upload_bytes"].append(sum(a.nbytes
                                          for a in arrays.values()))
        return timed(to_sub, "upload_s")(arrays, plen, pad_to_cap)

    pool._evict_retained = counting_evict
    pool.on_evict_entry = timed(on_evict, "demote_s")
    pool.gather_blocks_host = copy
    pool.host_blocks_to_sub = upload
    engine._restore_host = timed(restore_host, "restore_s")
    ht._checksum = timed(checksum, "crc_s")
    tier.demote = _labelled(demote, phase, "demote")
    tier.restore = _labelled(restore, phase, "restore")
    made = capture_requests(engine)
    # prompt_text's seeds repeat mod 29: these four and the miss's (6400)
    # share no residue with each other or with the groups' (7000-7003,
    # 7100-7103), so no prompt here is a prefix of another
    prefixes = [prompt_text(TIER_PREFIX, 6003 + i) for i in range(4)]
    mem = [meminfo_available()]

    def ask(prompt, what):
        status, body = server.handle({"prompts": [prompt],
                                      "tokens_to_generate": TIER_NEW,
                                      "temperature": 0.0})
        check(status == 200, f"(e) {what}: {status}")
        return made[-1], body["segments"][0]

    try:
        for i, p in enumerate(prefixes):
            ask(p + feature_text("a", 32, 6100 + i), f"prefix {i}")
        mem.append(meminfo_available())
        snap = engine.metrics.snapshot()
        check(snap["host_tier_demotions"] == 2 == timing["evictions"],
              f"(e): {snap['host_tier_demotions']} demotions, "
              f"{timing['evictions']} evictions, 2 expected")
        host, _ = ask(prefixes[0] + feature_text("b", 32, 6200), "host hit")
        snap = engine.metrics.snapshot()
        check(snap["host_tier_hits"] == 1, f"(e): {snap['host_tier_hits']} "
              "host hits after a hit on a demoted prefix")
        device, _ = ask(prefixes[3] + feature_text("c", 32, 6300),
                        "device hit")
        check(device.prefix_len > 0, "(e): no device hit")
        # the corruption: one step of an unrelated request flips the
        # largest demoted entry
        inj = faults.FaultInjector(serve_host_corrupt_calls={1})
        faults.activate(inj)
        try:
            ask("corrupt step", "the corrupting step")
        finally:
            faults.deactivate()
        check(bool(inj.fired), "(e): serve_host_corrupt did not fire")
        key = ast.literal_eval(inj.fired[0][1].split("@", 1)[1])
        check(key in tier._entries, "(e): the corrupted entry left the tier")
        target = tier._entries[key].tokens[:TIER_PREFIX]
        corrupt_prefix = tok.detokenize(target)
        corrupt_prompt = corrupt_prefix + feature_text("e", 32, 6500)
        misses = engine.metrics.snapshot()["host_tier_checksum_misses"]
        corrupt_req, corrupt_tokens = ask(corrupt_prompt, "corrupted hit")
        miss, _ = ask(prompt_text(TIER_PREFIX, 6400)
                      + feature_text("d", 32, 6401), "miss")
        snap = settle(engine)
        mem.append(meminfo_available())
        check(snap["host_tier_checksum_misses"] == misses + 1
              and corrupt_req.prefix_len == 0,
              f"(e): the corrupted entry's hit: "
              f"{snap['host_tier_checksum_misses'] - misses} checksum "
              f"misses, prefix {corrupt_req.prefix_len}")
        check(snap["host_tier_demotions"] == timing["evictions"],
              f"(e): {snap['host_tier_demotions']} demotions of "
              f"{timing['evictions']} evictions")
    finally:
        ht._checksum = checksum
        server.close()
    return dict(
        demotions=snap["host_tier_demotions"],
        evictions=timing["evictions"], host_tier_hits=snap["host_tier_hits"],
        checksum_misses=snap["host_tier_checksum_misses"],
        ttft_host_restore_ms=host.ttft * 1e3,
        ttft_device_hit_ms=device.ttft * 1e3, ttft_miss_ms=miss.ttft * 1e3,
        host_prefix_len=host.prefix_len, device_prefix_len=device.prefix_len,
        demote_s=timing["demote_s"], copy_s=timing["copy_s"],
        copy_bytes=timing["copy_bytes"],
        crc_demote_s=timing["crc_s"]["demote"],
        crc_restore_s=timing["crc_s"]["restore"],
        restore_s=timing["restore_s"], upload_s=timing["upload_s"],
        upload_bytes=timing["upload_bytes"],
        host_bytes_used=tier.bytes_used, host_entries=len(tier),
        mem_available_kib=mem,
        corrupt_prompt=corrupt_prompt, corrupt_tokens=corrupt_tokens,
        corrupted=inj.fired[0][1])


def _labelled(fn, phase, label):
    """fn run with `phase["now"]` set to label (for the checksum timer)."""
    def wrapper(*a, **kw):
        prev = phase["now"]
        phase["now"] = label
        try:
            return fn(*a, **kw)
        finally:
            phase["now"] = prev
    return wrapper


def meminfo_available() -> int:
    """MemAvailable of /proc/meminfo, in KiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1])
    return -1


def check_front_slice() -> dict:
    """(f): a 2-layer fp32 slice of the 7B width (TF32 off). Greedy tokens
    equal through the router, one engine and the serial route; a stream
    equal to its completion; a host restore equal to a miss and to the
    tier off."""
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    model = LanguageModel(cfg, dtype=torch.float32, seed=1)
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod,
                    kv_cache_dtype=torch.float32)
    prefix = prompt_text(512, 1500)
    payloads = [{"prompts": [prefix + feature_text(c, 60 + 20 * i,
                                                   1501 + i)],
                 "tokens_to_generate": 24, "temperature": 0.0}
                for i, c in enumerate("abcd")]
    outs = {}
    for arm, fields in (("router", dict(num_replicas=2)), ("engine", {})):
        server = front_server(gen, tok, **fields)
        try:
            threads, res = serve_payloads(server, payloads)
            for t in threads:
                t.join(timeout=300)
            check(all(s == 200 for s, _ in res), f"(f) {arm}: {res}")
            outs[arm] = [b["segments"][0] for _, b in res]
            if arm == "router":
                status, body = server.handle(dict(payloads[0], stream=True))
                toks = [json.loads(f.split("data: ")[1])["token"]
                        for f in body if f.startswith("id: ")]
                check(toks == outs[arm][0][len(payloads[0]["prompts"][0]):],
                      "(f): a stream differs from its completion")
                serial = []
                for p in payloads:
                    status, body = server.handle(dict(p, serial=True))
                    check(status == 200, f"(f) serial: {status}")
                    serial.append(body["segments"][0])
                outs["serial"] = serial
        finally:
            server.close()
    check(outs["router"] == outs["engine"] == outs["serial"],
          "(f): greedy tokens differ between the router, one engine and "
          "the serial route")
    # the host tier: a prefix demoted by two fillers, then a hit on it
    tiers = {}
    for arm, fields in (("restore", dict(enable_prefix_cache=True,
                                         retained_slots=1,
                                         host_kv_bytes=1 << 30)),
                        ("tier_off", dict(enable_prefix_cache=True,
                                          retained_slots=1)),
                        ("miss", {})):
        server = feature_server(gen, tok, **fields)
        try:
            for p in ([payloads[0]]
                      + [{"prompts": [prompt_text(40, 1510 + i)],
                          "tokens_to_generate": 4, "temperature": 0.0}
                         for i in range(2)] + [payloads[1]]):
                status, body = server.handle(p)
                check(status == 200, f"(f) {arm}: {status}")
            tiers[arm] = body["segments"][0]
            if arm == "restore":
                snap = server.engine.metrics.snapshot()
                check(snap["host_tier_hits"] == 1
                      and snap["host_tier_demotions"] >= 1,
                      f"(f): host tier {snap['host_tier_hits']} hits, "
                      f"{snap['host_tier_demotions']} demotions")
        finally:
            server.close()
    check(tiers["restore"] == tiers["tier_off"] == tiers["miss"]
          == outs["engine"][1],
          "(f): a host restore's tokens differ from a miss's or the tier "
          "off's")
    del gen, model
    torch.cuda.empty_cache()
    return dict(agree=True, arms=sorted(outs) + sorted(tiers),
                allow_tf32=False)


def phase_front_door(smi: str) -> dict:
    """Phase 12: (a)-(e) on Llama-2-7B at full width and FRONT_LAYERS
    layers behind
    MegatronServer: two replicas behind the router (a)-(d), then one engine
    with the host tier (e), then one replica with the same config for the
    comparison and the completions the failed-over, wedged and streamed
    requests must equal; (f) the 2-layer fp32 slice. Launch counts are
    zeroed before the two-replica server's traffic and before (e), and read
    after them."""
    import gc
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before "
          "phase 12: phase 11's model was not freed")
    t_phase = time.perf_counter()
    cfg = llama2_config("7b", num_layers=FRONT_LAYERS)
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=FRONT_SEED)
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod)
    L = cfg.num_layers
    # distinct mod 29 (prompt_text's period in the seed), and from (e)'s
    groups_a = [prompt_text(FRONT_PREFIX, 7000 + g)
                for g in range(FRONT_GROUPS)]
    groups_b = [prompt_text(FRONT_PREFIX, 7100 + g)
                for g in range(FRONT_GROUPS)]
    waves = front_payloads(groups_a, 0, 16, FRONT_NEW, 7200)
    wedge = front_payloads(groups_b, 0, 4, FRONT_NEW, 7300)
    streams = front_payloads(groups_b, 1, 8, FRONT_STREAM_NEW, 7400)
    failover = front_payloads(groups_b, 9, 8, FRONT_NEW, 7500)
    stats = dict(card=smi)
    windows = {}
    try:
        t0 = time.perf_counter()
        server = front_server(gen, tok, num_replicas=2,
                                engine_step_timeout_s=WEDGE_TIMEOUT_S,
                                router_heartbeat_timeout_s=WEDGE_HEARTBEAT_S)
        httpd, thread = serve_http(server)
        port = httpd.server_address[1]
        try:
            router = server.engine
            zero_counts()
            status, _ = server.handle({"prompts": ["warm up"],
                                       "tokens_to_generate": 4,
                                       "temperature": 0.0})
            check(status == 200, f"front door warm-up: {status}")
            for eng in router.engines:
                # each engine's first iteration arms its watchdog
                eng.generate([7, 8, 9], 2)
            stats["router"] = front_router_waves(server, port, waves, L)
            log("front door (a) router: " + json.dumps(stats["router"]))
            warm_prefixes(router.engines, groups_b)
            stats["wedge"], wedged = front_wedge(server, wedge)
            # the restarted replica's pool is new: warm it again
            warm_prefixes([wedged.engine], groups_b)
            log("front door (c) wedge: " + json.dumps(
                {k: v for k, v in stats["wedge"].items() if k != "bodies"}))
            stats["sse"] = front_sse(server, port, streams)
            log("front door (d) sse: " + json.dumps(
                {k: v for k, v in stats["sse"].items()
                 if k != "stream_tokens"}))
            stats["failover"] = front_failover(server, failover)
            log("front door (b) failover: " + json.dumps(
                {k: v for k, v in stats["failover"].items()
                 if k != "bodies"}))
            add_counts(windows, stats["failover"].pop("launches"))
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            server.close()
        del server, router
        gc.collect()
        torch.cuda.empty_cache()
        stats["replicas_seconds"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        zero_counts()
        stats["tier"] = front_tier(gen, tok)
        add_counts(windows, read_counts())
        stats["tier"]["seconds"] = time.perf_counter() - t0
        log("front door (e) host tier: " + json.dumps(
            {k: v for k, v in stats["tier"].items()
             if k not in ("corrupt_prompt", "corrupt_tokens")}))
        gc.collect()
        torch.cuda.empty_cache()

        # one replica, the same config: the comparison and the completions
        t0 = time.perf_counter()
        server = front_server(gen, tok)
        httpd, thread = serve_http(server)
        try:
            status, _ = server.handle({"prompts": ["warm up"],
                                       "tokens_to_generate": 4,
                                       "temperature": 0.0})
            check(status == 200, f"one replica warm-up: {status}")
            stats["one_replica"] = front_router_waves(
                server, httpd.server_address[1], waves, L)
            log("front door (a) one replica: "
                + json.dumps(stats["one_replica"]))
            warm_prefixes([server.engine], groups_b)
            refs = wedge + failover + streams
            threads, res = serve_payloads(server, refs)
            for t in threads:
                t.join(timeout=900)
            check(all(s == 200 for s, _ in res),
                  f"one replica: {[s for s, _ in res]}")
            want = [new_tokens(p, b) for p, (_, b) in zip(refs, res)]
            status, body = server.handle({
                "prompts": [stats["tier"]["corrupt_prompt"]],
                "tokens_to_generate": TIER_NEW, "temperature": 0.0})
            check(status == 200, f"one replica, the miss: {status}")
            miss_ref = body["segments"][0]
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            server.close()
        stats["one_replica_seconds"] = time.perf_counter() - t0
    finally:
        del gen, model
        gc.collect()
        torch.cuda.empty_cache()

    n_w, n_f = len(wedge), len(failover)
    got_w = [new_tokens(p, b) for p, b in zip(wedge,
                                              stats["wedge"].pop("bodies"))]
    got_f = [new_tokens(p, b)
             for p, b in zip(failover, stats["failover"].pop("bodies"))]
    got_s = stats["sse"].pop("stream_tokens")
    want_w, want_f, want_s = want[:n_w], want[n_w:n_w + n_f], want[n_w + n_f:]
    check(got_w == want_w, "(c): a retried request's tokens differ from the "
          "one-replica run's")
    check(got_f == want_f, "(b): a failed-over request's tokens differ from "
          "the one-replica run's")
    for i, (g, w) in enumerate(zip(got_s, want_s)):
        check(g == (w[:len(g)] if i == 1 else w),
              f"(d): stream {i}'s tokens differ from its completion")
    check(stats["tier"].pop("corrupt_tokens") == miss_ref,
          "(e): the corrupted entry's request differs from the miss path")
    stats["exact"] = dict(wedge=n_w, failover=n_f, streams=len(got_s),
                          corrupt_miss=True)
    t0 = time.perf_counter()
    stats["slice"] = check_front_slice()
    stats["slice"]["seconds"] = time.perf_counter() - t0
    log("front door slice (fp32, 2 layers): " + json.dumps(stats["slice"]))
    total = windows["launches"]
    stats["launches"] = dict(flash_fwd=total["flash_fwd_cuda"],
                             block_attn=total["block_attention_cuda"])
    stats["norm_launches"] = {k: v for k, v in total.items()
                              if k.startswith(("rms_", "ln_"))}
    check(stats["launches"]["flash_fwd"] > 0
          and stats["launches"]["block_attn"] > 0
          and stats["launches"]["block_attn"] % L == 0,
          f"front door launches: {stats['launches']}")
    stats["seconds"] = time.perf_counter() - t_phase
    return stats


# Phase 13, LoRA serving, LoRA finetuning and live weights. (a)-(b):
# Llama-2-7B at full width and LORA_LAYERS of its 32 layers (the whole
# smoke's time limit) (random bf16 weights, seed LORA_SEED)
# behind the engine with an adapter bank (LORA_RANK, random fp32 factors from
# fixed seeds, 67.1 MB an adapter at 32 layers). Every request is prefilled
# alone (prefill_max_batch 1) and the decode grid has a fixed shape, so a
# request's tokens do not depend on the requests beside it, and a request
# repeated alone reproduces them bit for bit. (c) a LoRA finetune through
# finetune.main at 7B width and LIVE_LAYERS layers. (d)-(e) the hot swap and
# the rolling upgrade at LIVE_LAYERS layers between checkpoints that the
# port's save_checkpoint publishes (fp32 weights, SHA-256 manifests). (f)
# the 2-layer fp32 slice.
LORA_SEED = 0
LORA_LAYERS = 16
LORA_RANK = 16
LORA_ALPHA = 32.0
LORA_SLOTS = 8
LORA_REQUESTS = 16
LORA_PROMPT = 256
LORA_NEW = 64
LORA_SERVING = dict(ENGINE_SERVING, prefill_max_batch=1)
LORA_SPEC_REQUESTS = 8
LORA_SPEC_NEW = 32
PRESSURE_ROWS = 2
PRESSURE_ADAPTERS = 4
PRESSURE_NEW = 16
LORA_FT_ITERS = 10
LORA_FT_LR = "1e-3"
LIVE_LAYERS = 4
LIVE_SEEDS = (13, 14)  # the weights of versions N and N+1
LIVE_REQUESTS = 8
LIVE_PROMPT = 200
LIVE_NEW = 48
LIVE_MEMORY_SLACK = 2 ** 20
ROLL_PROMPTS = 6
ROLL_NEW = 24


class KernelTap:
    """A stand-in for a kernel wrapper that calls `before(*args, **kw)`
    and then the wrapper. The wrapper counts its launches on the module
    global of its own name, which is this object while it is installed:
    `launches` reads and writes the wrapper's own count."""

    def __init__(self, fn, before):
        self.fn = fn
        self.before = before
        self.__name__ = fn.__name__

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kw):
        self.before(*args, **kw)
        return self.fn(*args, **kw)


def live_tol(tol: float, ref_max: float) -> float:
    """A bf16 output's tolerance on live activations: `tol` at magnitudes
    up to 1, relative to the reference's largest magnitude above it (one
    bf16 ulp at |x| in [4, 8) is 0.03125)."""
    return tol * max(1.0, ref_max)


def lora_factors(cfg, n: int, seed0: int) -> dict:
    from megatron_tpu_torch.serving.adapters import random_adapter_factors
    return {f"tenant-{a}": random_adapter_factors(cfg, LORA_RANK, seed0 + a)
            for a in range(n)}


def lora_engine(gen, **fields):
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.serving import ServingEngine
    return ServingEngine(gen, ServingConfig(**dict(LORA_SERVING, **fields)))


def greedy():
    from megatron_tpu_torch.serving import SamplingOptions
    return SamplingOptions(temperature=0.0)


def submit_all(engine, prompts, assignment, new) -> list:
    reqs = [engine.submit(p, new, greedy(), adapter_id=a)
            for p, a in zip(prompts, assignment)]
    return [r.result(timeout=1800)[0] for r in reqs]


def lora_arm(gen, factors, prompts, assignment, L, captures=None) -> dict:
    """One arm of (a): a fresh engine with a bank of LORA_SLOTS rows (none
    for the base arm), its adapters registered, a warm-up, then every
    request submitted at once; launch counts and metrics from zero."""
    import gc

    import torch
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    from megatron_tpu_torch.tools.bench_lora import gather_bytes_per_step
    ids = sorted({a for a in assignment if a is not None})
    gc.collect()  # the previous arm's pool goes before this one's comes
    torch.cuda.empty_cache()
    engine = lora_engine(gen, adapter_slots=LORA_SLOTS if ids else 0,
                         adapter_rank=LORA_RANK)
    try:
        for aid in ids:
            engine.register_adapter(aid, factors=factors[aid],
                                    rank=LORA_RANK, alpha=LORA_ALPHA)
        engine.generate(prompts[0][:32], 4, greedy(), timeout=600,
                        adapter_id=ids[0] if ids else None)
        wait_idle(engine)
        engine.metrics = ServingMetrics()
        if engine.adapters is not None:
            engine.adapters.metrics = engine.metrics
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if captures is not None:
            captures["engine"] = engine
        zero_counts()
        t0 = time.perf_counter()
        outs = submit_all(engine, prompts, assignment, LORA_NEW)
        wall = time.perf_counter() - t0
        snap = settle(engine)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        engine.close()
        if captures is not None:
            captures.pop("engine", None)
    generated = sum(len(o) - len(p) for o, p in zip(outs, prompts))
    check(generated == int(snap["tokens_generated"]),
          f"lora arm: {generated} tokens, metrics {snap['tokens_generated']}")
    check(counts["block_attention_cuda"] == L * snap["decode_steps"],
          f"lora arm: {counts['block_attention_cuda']} block launches in "
          f"{snap['decode_steps']} steps of {L} layers")
    check(counts["flash_fwd_cuda"] == L * len(prompts),
          f"lora arm: {counts['flash_fwd_cuda']} flash launches for "
          f"{len(prompts)} prefills of {L} layers")
    return dict(adapters=len(ids), requests=len(prompts),
                generated_tokens=generated, wall_s=wall,
                tokens_per_s=generated / wall,
                ttft_p50_ms=snap["ttft_p50_ms"],
                itl_p50_ms=snap["itl_p50_ms"], peak_gib=peak,
                decode_steps=snap["decode_steps"],
                adapter_loads=snap["adapter_loads"],
                active_adapters=snap["active_adapters"],
                gather_bytes_per_step=(gather_bytes_per_step(
                    gen.cfg, LORA_RANK, LORA_SERVING["num_slots"])
                    if ids else 0),
                launches=counts, outputs=outs)


def lora_serving(gen, tok, L) -> dict:
    """(a): the three bench_lora arms at full width, the block kernel held
    on the mixed arm's live state at w 1 and on a verify round at w 5 with
    adapters, and the flash forward on an adapter request's prefill."""
    import torch
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops import flash_attention as fa
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    from megatron_tpu_torch.tools.bench_lora import assignments
    cfg = gen.cfg
    factors = lora_factors(cfg, LORA_SLOTS, 1000)
    prompts = [tok.tokenize(prompt_text(LORA_PROMPT, 1 + i))
               for i in range(LORA_REQUESTS)]
    captures = {}
    flash_fwd = fc.flash_fwd_cuda

    def recording_block(q, k_arena, v_arena, block_map, lengths, **kw):
        eng = captures.get("engine")
        key = f"w{q.shape[1]}"
        if (eng is not None and key not in captures
                and int(eng._active.sum()) >= 6
                and len(set(eng._adapter_idx.tolist())) >= 3):
            captures[key] = dict(q=q.clone(), k=k_arena.clone(),
                                 v=v_arena.clone(), map=block_map.clone(),
                                 lengths=lengths.clone(), kw=kw)
        return block_attention_cuda(q, k_arena, v_arena, block_map,
                                    lengths, **kw)

    def record_flash(q, k, v, **kw):
        eng = captures.get("engine")
        if eng is not None and "prefill" not in captures:
            captures["flash_calls"] = captures.get("flash_calls", 0) + 1
            # the second prefill's first layer: the mixed arm's request 1,
            # under tenant-0
            if captures["flash_calls"] == L + 1:
                captures["prefill"] = dict(q=q.clone(), k=k.clone(),
                                           v=v.clone(), kw=kw)

    recording_flash = KernelTap(flash_fwd, record_flash)

    out = {}
    outputs = {}
    for label, assignment in assignments(sorted(factors),
                                         LORA_REQUESTS).items():
        mixed = label.startswith("mixed")
        if mixed:
            ba.block_attention_cuda = recording_block
            fc.flash_fwd_cuda = recording_flash
        try:
            arm = lora_arm(gen, factors, prompts, assignment, L,
                           captures if mixed else None)
        finally:
            ba.block_attention_cuda = block_attention_cuda
            fc.flash_fwd_cuda = flash_fwd
        if mixed:
            check(assignment[1] == "tenant-0", "mixed arm: request 1")
        outputs[label] = arm.pop("outputs")
        out[label] = arm
        add_counts(out, arm["launches"])
    # the base rows of the mixed arm ride row 0's zero delta: the base
    # arm's tokens
    mixed_label = next(k for k in outputs if k.startswith("mixed"))
    base_rows = [i for i, a in enumerate(assignments(
        sorted(factors), LORA_REQUESTS)[mixed_label]) if a is None]
    check(all(outputs[mixed_label][i] == outputs["base"][i]
              for i in base_rows),
          "mixed arm: a base row's tokens differ from the base arm's")
    check(outputs["one_adapter"] != outputs["base"],
          "one-adapter arm: the adapter changed no token")
    out["mixed_base_rows_equal_base"] = len(base_rows)

    # the w 5 verify round with adapters: the n-gram drafter on prompts
    # repeating a span
    spec_prompts = [tok.tokenize(spec_prompt(i)[:LORA_PROMPT])
                    for i in range(LORA_SPEC_REQUESTS)]
    spec_assign = [(["tenant-0", "tenant-1", None, "tenant-2"])[i % 4]
                   for i in range(LORA_SPEC_REQUESTS)]
    engine = lora_engine(gen, adapter_slots=LORA_SLOTS,
                         adapter_rank=LORA_RANK, speculative_k=SPEC_K)
    ba.block_attention_cuda = recording_block
    try:
        for aid in ("tenant-0", "tenant-1", "tenant-2"):
            engine.register_adapter(aid, factors=factors[aid],
                                    rank=LORA_RANK, alpha=LORA_ALPHA)
        captures["engine"] = engine
        zero_counts()
        submit_all(engine, spec_prompts, spec_assign, LORA_SPEC_NEW)
        snap = settle(engine)
        counts = read_counts()
    finally:
        ba.block_attention_cuda = block_attention_cuda
        captures.pop("engine", None)
        engine.close()
    steps = snap["spec_rounds"] + snap["spec_fallback_steps"]
    check(snap["spec_rounds"] > 0, "lora verify: no verify round ran")
    check(counts["block_attention_cuda"] == L * steps,
          f"lora verify: {counts['block_attention_cuda']} block launches in "
          f"{steps} rounds and fallback steps of {L} layers")
    out["verify"] = dict(spec_rounds=snap["spec_rounds"],
                         spec_fallback_steps=snap["spec_fallback_steps"],
                         draft_tokens=snap["draft_tokens"],
                         accepted_tokens=snap["accepted_tokens"],
                         block_launches=counts["block_attention_cuda"])
    add_counts(out, counts)

    # the kernels on the live adapter state (not counted: the counts above
    # were read)
    for key, w in (("w1", 1), (f"w{SPEC_K + 1}", SPEC_K + 1)):
        check(key in captures, f"no block call at w {w} with >= 6 live "
              "slots over 3 bank rows")
        c = captures.pop(key)
        got = block_attention_cuda(c["q"], c["k"], c["v"], c["map"],
                                   c["lengths"], **c["kw"])
        ref = ba.block_attention_reference(c["q"], c["k"], c["v"], c["map"],
                                           c["lengths"],
                                           scale=c["kw"]["scale"])
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = live_tol(BLOCK_LIVE_TOL, ref_max)
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"block kernel on the live adapter state at w {w}: err {err} "
              f"(tol {tol})")
        out[f"live_block_{key}"] = dict(w=w, max_abs_err=err, tol=tol,
                                        max_abs_ref=ref_max,
                                        lengths=c["lengths"].tolist())
    check("prefill" in captures, "no adapter prefill was captured")
    c = captures.pop("prefill")
    got, got_lse = flash_fwd(c["q"], c["k"], c["v"], **c["kw"])
    ref, ref_lse = fa.blockwise_attention(c["q"], c["k"], c["v"], **c["kw"])
    err = (got.float() - ref.float()).abs().max().item()
    err_lse = (got_lse - ref_lse).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol_out, tol_lse = TOL["bfloat16"]
    tol_out = live_tol(tol_out, ref_max)
    check(bool(torch.isfinite(got).all()) and err <= tol_out
          and err_lse <= tol_lse,
          f"flash forward on an adapter prefill: err {err} (tol {tol_out}), "
          f"lse {err_lse}")
    out["live_flash_prefill"] = dict(shape=list(c["q"].shape),
                                     max_abs_err=err, max_abs_ref=ref_max,
                                     max_abs_err_lse=err_lse,
                                     tol=[tol_out, tol_lse])
    captures.clear()
    return out


def bank_pressure(gen, tok, root: str) -> dict:
    """(b): PRESSURE_ADAPTERS adapters exported to .npz and registered by
    path into a bank of PRESSURE_ROWS rows with a host budget for all of
    them, each request alone: evictions demote to the host, a re-request is
    a host hit, and a host copy corrupted by serve_adapter_corrupt reloads
    from disk with the tokens of its first run."""
    import os

    from megatron_tpu_torch.resilience.faults import (FaultInjector,
                                                      use_fault_injector)
    from megatron_tpu_torch.serving.adapters import adapter_bank_nbytes
    from megatron_tpu_torch.training.lora import export_adapter
    cfg = gen.cfg
    factors = lora_factors(cfg, PRESSURE_ADAPTERS, 2000)
    per = adapter_bank_nbytes(cfg, 1, LORA_RANK) // 2
    engine = lora_engine(gen, adapter_slots=PRESSURE_ROWS,
                         adapter_rank=LORA_RANK,
                         adapter_host_bytes=PRESSURE_ADAPTERS * per)
    prompt = tok.tokenize(prompt_text(128, 3))
    out = dict(adapter_mb=per / 1e6, rows=PRESSURE_ROWS,
               adapters=PRESSURE_ADAPTERS)
    runs = []

    def one(aid):
        req = engine.submit(prompt, PRESSURE_NEW, greedy(), adapter_id=aid)
        toks, _ = req.result(timeout=600)
        runs.append(dict(adapter=aid, ttft_ms=req.ttft * 1e3))
        return toks

    try:
        t0 = time.perf_counter()
        for aid, f in factors.items():
            path = os.path.join(root, f"{aid}.npz")
            export_adapter(path, f, rank=LORA_RANK, alpha=LORA_ALPHA)
            engine.register_adapter(aid, path=path)
        out["export_register_s"] = time.perf_counter() - t0
        ids = sorted(factors)
        zero_counts()
        first = {aid: one(aid) for aid in ids}
        one(ids[0])  # a host hit
        inj = FaultInjector(serve_adapter_corrupt_calls={1})
        with use_fault_injector(inj):
            one(ids[0])  # resident: its first step corrupts a host copy
        fired = [w for k, w in inj.fired if k == "serve_adapter_corrupt"]
        check(len(fired) == 1, f"serve_adapter_corrupt fired {fired}")
        victim = next(a for a in ids if repr(a) in fired[0])
        again = one(victim)
        snap = settle(engine)
        out["launches"] = read_counts()
    finally:
        engine.close()
    check(again == first[victim], f"{victim}: the reload from disk after a "
          "corrupt host copy changed its tokens")
    check(snap["adapter_evictions"] >= PRESSURE_ADAPTERS
          and snap["adapter_host_hits"] >= 1
          and snap["adapter_host_checksum_misses"] == 1,
          f"bank pressure counters: {snap}")
    out.update({k: snap[k] for k in ("adapter_loads", "adapter_evictions",
                                     "adapter_host_hits",
                                     "adapter_host_checksum_misses")},
               corrupted=victim, runs=runs, tokens_equal_after_reload=True)
    return out


def lora_finetune(root: str, L: int) -> dict:
    """(c): `finetune.main --lora_rank LORA_RANK` in process at 7B width
    and LIVE_LAYERS layers on the synthetic corpus, launch counts zeroed
    just before; the flash forward, dQ and dK/dV kernels held against their
    plain versions on the first call's live inputs; the trained adapter
    must lower the loss of the first batch; the export served on a
    LIVE_LAYERS engine over the same base."""
    import os

    import torch
    from megatron_tpu_torch import finetune
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models import language_model as lm
    from megatron_tpu_torch.ops import flash_attention as fa
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.training import lora as tlora
    os.makedirs(os.path.join(root, "corpus"))
    corpus = pretrain_corpus(os.path.join(root, "corpus"))
    export = os.path.join(root, "adapter.npz")
    argv = ["--model", "llama2-7b", "--num_layers", str(LIVE_LAYERS),
            "--bf16", "--use_flash_attn", "--micro_batch_size", "1",
            "--global_batch_size", "2", "--train_iters", str(LORA_FT_ITERS),
            "--lr", LORA_FT_LR, "--log_interval", "1", "--split",
            "100,0,0", "--data_path", corpus["data"], "--tokenizer_type",
            "GPT2BPETokenizer", "--vocab_file", corpus["vocab"],
            "--merge_file", corpus["merges"], "--lora_rank",
            str(LORA_RANK), "--lora_alpha", str(LORA_ALPHA),
            "--lora_export", export]
    rec = {}
    make_step = tlora.make_lora_step
    kernels = {name: getattr(fc, name) for name in (
        "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda")}

    def recording_make(base, cfg, rank, alpha, **kw):
        step, init = make_step(base, cfg, rank, alpha, **kw)
        rec.update(base=base, cfg=cfg)

        def recorded(factors, opt, tokens, mask):
            if "tokens" not in rec:
                rec.update(tokens=tokens, mask=mask)
            factors, opt, loss = step(factors, opt, tokens, mask)
            rec.setdefault("losses", []).append(float(loss))
            rec["factors"] = factors
            return factors, opt, loss
        return recorded, init

    def capturing(name):
        def keep(*a, **kw):
            if name not in rec:
                rec[name] = ([x.clone() if isinstance(x, torch.Tensor)
                              else x for x in a],
                             {k: (v.clone() if isinstance(v, torch.Tensor)
                                  else v) for k, v in kw.items()})
        return KernelTap(kernels[name], keep)

    tlora.make_lora_step = recording_make
    for name in kernels:
        setattr(fc, name, capturing(name))
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = finetune.main(argv)
        torch.cuda.synchronize()
    finally:
        tlora.make_lora_step = make_step
        for name, fn in kernels.items():
            setattr(fc, name, fn)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check(rc == 0, f"finetune --lora_rank returned {rc}")
    steps = tlora.last_run["step_ms"]
    check(len(steps) == LORA_FT_ITERS, f"{len(steps)} LoRA steps")
    for name in kernels:
        want = L * LORA_FT_ITERS
        check(counts[name] == want, f"lora finetune: {name} launched "
              f"{counts[name]} times, {want} expected")
    out = dict(seconds=seconds, iters=LORA_FT_ITERS, step_ms=steps,
               step_ms_median=sorted(steps)[len(steps) // 2],
               corpus_write_s=corpus["write_s"],
               corpus_preprocess_s=corpus["preprocess_s"],
               launches=counts, last_loss=tlora.last_run["last_loss"])
    # the training loss falls: the last three steps' mean below the first
    # three's (each step sees a new batch)
    losses = rec["losses"]
    check(sum(losses[-3:]) < sum(losses[:3]),
          f"lora finetune: the loss did not fall: {losses}")
    # and the first batch's loss with the trained adapter (B starts at 0,
    # so the first step's loss is the base model's), reported
    base, cfg = rec["base"], rec["cfg"]
    with torch.no_grad():
        after = float(lm.loss_fn(
            base, rec["tokens"], cfg, loss_mask=rec["mask"],
            adapters=tlora.lora_adapters(rec["factors"], LORA_RANK,
                                         LORA_ALPHA,
                                         rec["tokens"].shape[0])))
    out.update(losses=losses, first_batch_loss_before=losses[0],
               first_batch_loss_after=after)
    # the kernels on the LoRA training's live inputs
    a, kw = rec["flash_fwd_cuda"]
    got, got_lse = kernels["flash_fwd_cuda"](*a, **kw)
    ref, ref_lse = fa.blockwise_attention(*a, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    err_lse = (got_lse - ref_lse).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = live_tol(TOL["bfloat16"][0], ref_max)
    check(err <= tol and err_lse <= TOL["bfloat16"][1],
          f"lora training: flash forward err {err} (tol {tol}), lse "
          f"{err_lse}")
    out["live_fwd"] = dict(shape=list(a[0].shape), max_abs_err=err,
                           max_abs_ref=ref_max, tol=tol,
                           max_abs_err_lse=err_lse)
    a, kw = rec["flash_bwd_dq_cuda"]
    dq = kernels["flash_bwd_dq_cuda"](*a, **kw)
    a2, kw2 = rec["flash_bwd_dkv_cuda"]
    dk, dv = kernels["flash_bwd_dkv_cuda"](*a2, **kw2)
    plain = fa.blockwise_attention_bwd(*a, **kw)
    for gname, g, w in (("dq", dq, plain[0]), ("dk", dk, plain[1]),
                        ("dv", dv, plain[2])):
        err = (g.float() - w.float()).abs().max().item()
        tol = GRAD_TOL["bfloat16"] * w.float().abs().max().item()
        check(bool(torch.isfinite(g).all()) and err <= tol,
              f"lora training: {gname} err {err} (tol {tol})")
        out[f"live_{gname}"] = dict(max_abs_err=err, tol=tol)
    rec.clear()
    # the export on an engine over the trained base
    tok = ByteTokenizer()
    gen = Generator(base, cfg, eos_id=tok.eod, pad_id=tok.eod)
    engine = lora_engine(gen, adapter_slots=1, adapter_rank=LORA_RANK,
                         max_len=1024)
    try:
        engine.register_adapter("finetuned", path=export)
        prompts = [tok.tokenize(prompt_text(100, 7 + i)) for i in range(4)]
        zero_counts()
        outs = submit_all(engine, prompts, ["finetuned", None] * 2, 16)
        snap = settle(engine)
        serve_counts = read_counts()
    finally:
        engine.close()
    check(all(len(o) == len(p) + 16 or o[-1] == tok.eod
              for o, p in zip(outs, prompts)), "finetuned adapter: lengths")
    check(snap["adapter_loads"] == 1, f"finetuned adapter: {snap}")
    out["served"] = dict(requests=4, adapter_loads=snap["adapter_loads"])
    out["serve_launches"] = serve_counts
    del gen, base, engine
    return out


def live_model(cfg, seed: int, dtype):
    """LIVE weights from `seed`: drawn in fp32 (as the checkpoint holds
    them), then cast."""
    import torch
    from megatron_tpu_torch.models.language_model import LanguageModel
    model = LanguageModel(cfg, dtype=torch.float32, seed=seed)
    if dtype == torch.float32:
        return model
    cast = LanguageModel.from_state_dict(cfg, {
        k: t.to(dtype) for k, t in model.state_dict().items()})
    del model
    return cast


def publish_live(root: str, cfg, seed: int, iteration: int) -> tuple:
    """Publish the seed's fp32 weights as checkpoint `iteration` with the
    port's save_checkpoint (no optimizer state). Returns (dir, stats)."""
    import torch
    from megatron_tpu_torch.config import MegatronConfig
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training.train_step import TrainState
    model = live_model(cfg, seed, torch.float32)
    d = ckpt.save_checkpoint(root, TrainState(params=model, opt_state=None,
                                              iteration=iteration),
                             MegatronConfig(model=cfg), iteration)
    stats = {k: ckpt.last_save[k] for k in ("payload_s", "manifest_s",
                                            "bytes")}
    del model
    torch.cuda.empty_cache()
    return d, stats


def corrupt_copy(src: str, dst: str) -> None:
    """A corrupt publish of `src` at `dst`: the payload hard-linked, the
    small files copied, one byte of config.json flipped (its manifest
    digest no longer matches)."""
    import os
    import shutil
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith(".npz"):
            os.link(os.path.join(src, name), os.path.join(dst, name))
        else:
            shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(dst, "config.json"), "r+b") as f:
        b0 = f.read(1)
        f.seek(0)
        f.write(bytes([b0[0] ^ 0x01]))


def hot_swap(cfg, tok, root: str, L: int) -> dict:
    """(d): publish N and N+1, serve N on an engine with the prefix cache,
    swap to N+1 while LIVE_REQUESTS stream, LIVE_REQUESTS more submitted
    during the swap's hold; then a corrupt N+2."""
    import gc
    import os
    import threading

    import torch
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.serving.weights import (WeightSwapError,
                                                    load_staged)
    out = {}
    d_n, out["publish_n"] = publish_live(root, cfg, LIVE_SEEDS[0], 1)
    d_n1, out["publish_n1"] = publish_live(root, cfg, LIVE_SEEDS[1], 2)
    prompts = [tok.tokenize(prompt_text(LIVE_PROMPT, 40 + i))
               for i in range(2 * LIVE_REQUESTS)]
    wave_a, wave_b = prompts[:LIVE_REQUESTS], prompts[LIVE_REQUESTS:]
    none = [None] * LIVE_REQUESTS
    gen = Generator(live_model(cfg, LIVE_SEEDS[0], torch.bfloat16), cfg,
                    eos_id=tok.eod, pad_id=tok.eod)
    ref = lora_engine(gen)
    try:
        ref_a = submit_all(ref, wave_a, none, LIVE_NEW)
    finally:
        ref.close()
    engine = lora_engine(gen, enable_prefix_cache=True)
    del gen, ref
    try:
        # a warm-up shorter than a block: no later prompt can hit it (a
        # prompt_text seed shares its opening with every seed of its
        # residue mod 29)
        engine.generate(tok.tokenize("warm up"), 4, greedy(), timeout=600)
        wait_idle(engine)
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        # staged first (the host byte work a swap call does before its
        # ticket), so that wave A is still streaming at the swap point
        t0 = time.perf_counter()
        staged = load_staged(d_n1, engine.gen.params)
        out["staging"] = dict(seconds=time.perf_counter() - t0,
                              verify_s=staged.verify_s,
                              read_s=staged.read_s, bytes=staged.nbytes)
        zero_counts()
        reqs_a = [engine.submit(p, LIVE_NEW, greedy()) for p in wave_a]
        t0 = time.perf_counter()
        while not all(r.generated for r in reqs_a):
            check(time.perf_counter() - t0 < 300, "wave A never ran")
            time.sleep(0.005)
        torch.cuda.reset_peak_memory_stats()
        done = {}

        def swap():
            try:
                done["version"] = engine.swap_weights(d_n1, staged=staged,
                                                      timeout=600)
            except Exception as e:  # noqa: BLE001 — checked below
                done["error"] = e

        th = threading.Thread(target=swap)
        t_swap = time.perf_counter()
        th.start()
        while not engine.health()["weight_swap_pending"] \
                and "version" not in done and "error" not in done:
            time.sleep(0.001)
        reqs_b = [engine.submit(p, LIVE_NEW, greedy()) for p in wave_b]
        th.join(timeout=900)
        swap_s = time.perf_counter() - t_swap
        check("version" in done, f"the swap failed: {done.get('error')!r}")
        got_a = [r.result(timeout=900)[0] for r in reqs_a]
        got_b = [r.result(timeout=900)[0] for r in reqs_b]
        snap = settle(engine)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        device_bytes = sum(t.numel() * t.element_size() for t in
                           engine.gen.params.state_dict().values())
        del staged
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check(got_a == ref_a, "wave A (admitted before the swap) differs "
              "from an engine holding only N")
        check(snap["requests_rejected"] == 0 and snap["requests_failed"] == 0,
              f"the swap rejected or failed requests: {snap}")
        check(engine.prefix_peek(wave_a[0] + [5] * 20) == 0,
              "an N-era prefix still hits after the swap")
        check(abs(mem1 - mem0) <= LIVE_MEMORY_SLACK,
              f"device memory {mem0} before the swap, {mem1} after")
        # wave B against an engine holding only N+1 (the swapped weights)
        # and one fresh prompt for after the refusal below
        fresh = tok.tokenize(prompt_text(LIVE_PROMPT, 90))
        ref = lora_engine(engine.gen)
        try:
            ref_b = submit_all(ref, wave_b + [fresh], none + [None],
                               LIVE_NEW)
        finally:
            ref.close()
        ref_fresh = ref_b.pop()
        check(got_b == ref_b, "wave B (admitted after the swap) differs "
              "from an engine holding only N+1")
        hits0 = engine.metrics.snapshot()["prefix_hits"]
        engine.generate(wave_a[0] + [7] * 20, 4, greedy(), timeout=600)
        check(engine.metrics.snapshot()["prefix_hits"] == hits0,
              "an N-era prefix hit after the swap")
        # a corrupt N+2: refused before anything touches the card
        d_n2 = os.path.join(root, "iter_0000003")
        corrupt_copy(d_n1, d_n2)
        t0 = time.perf_counter()
        try:
            engine.swap_weights(d_n2, timeout=60)
            refused = False
        except WeightSwapError:
            refused = True
        refuse_s = time.perf_counter() - t0
        check(refused, "a corrupt N+2 was not refused")
        check(engine.metrics.snapshot()["weight_swap_failures"] == 1,
              "weight_swap_failures after the refusal")
        again = submit_all(engine, [fresh], [None], LIVE_NEW)
        check(again == [ref_fresh], "N+1 does not serve on after a "
              "refusal")
        out.update(
            swap_s=swap_s, hold_s=engine.last_swap["hold_s"],
            apply_s=engine.last_swap["apply_s"],
            version=done["version"].label, peak_gib=peak / 2 ** 30,
            before_gib=mem0 / 2 ** 30, after_minus_before_bytes=mem1 - mem0,
            device_weight_bytes=device_bytes,
            pre_swap_exact=len(got_a), post_swap_exact=len(got_b),
            refused_s=refuse_s, weight_swaps=snap["weight_swaps"],
            launches=counts)
    finally:
        engine.close()
    return out


def rolling_upgrade_drill(cfg, tok, root: str, L: int) -> dict:
    """(e): two replicas of N behind the router, traffic from two threads,
    `rolling_upgrade` to N+1 (staged once): no failed request, every
    completion one version's tokens, at most one replica out of rotation,
    the canaries passed; a corrupt publish aborts and the fleet serves on."""
    import os
    import threading

    import torch
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.serving.router import (DOWN, EngineRouter,
                                                   RollingUpgradeError)
    d_n1 = os.path.join(root, "iter_0000002")
    d_n2 = os.path.join(root, "iter_0000003")
    prompts = [tok.tokenize(prompt_text(LIVE_PROMPT, 60 + i))
               for i in range(ROLL_PROMPTS)]
    none = [None] * ROLL_PROMPTS
    gen = Generator(live_model(cfg, LIVE_SEEDS[0], torch.bfloat16), cfg,
                    eos_id=tok.eod, pad_id=tok.eod)
    engines = [lora_engine(gen) for _ in range(2)]
    router = EngineRouter(engines, heartbeat_timeout_s=30.0,
                          probe_backoff_s=0.2)
    del gen
    out = {}
    try:
        ref_n = submit_all(engines[0], prompts, none, ROLL_NEW)
        zero_counts()
        results, errors = [], []
        stop = threading.Event()
        max_down = [0]

        def worker(w):
            i = w
            while not stop.is_set():
                j = i % ROLL_PROMPTS
                try:
                    toks, _ = router.submit(prompts[j], ROLL_NEW,
                                            greedy()).result(timeout=600)
                    results.append((j, toks))
                except Exception as e:  # noqa: BLE001 — checked below
                    errors.append(repr(e))
                i += 1

        def monitor():
            while not stop.is_set():
                down = sum(r.state == DOWN for r in router.replicas)
                max_down[0] = max(max_down[0], down)
                time.sleep(0.01)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(2)] + [threading.Thread(target=monitor)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        t0 = time.perf_counter()
        try:
            version = router.rolling_upgrade(d_n1, swap_timeout_s=600)
        finally:
            upgrade_s = time.perf_counter() - t0
            time.sleep(1.0)
            stop.set()
            for t in threads:
                t.join(timeout=900)
        counts = read_counts()
        ref_n1 = submit_all(engines[0], prompts, none, ROLL_NEW)
        check(not errors, f"rolling upgrade: failed requests {errors[:3]}")
        at = {"N": 0, "N+1": 0}
        for j, toks in results:
            check(toks in (ref_n[j], ref_n1[j]), f"rolling upgrade: prompt "
                  f"{j}'s completion is neither version's tokens")
            at["N" if toks == ref_n[j] else "N+1"] += 1
        check(max_down[0] <= 1, f"{max_down[0]} replicas out of rotation")
        snap = router.aggregate_snapshot()
        check(snap["rolling_upgrades"] == 1 and snap["weight_swaps"] == 2
              and snap["weight_version_min"] == 2.0
              and snap["weight_version_max"] == 2.0,
              f"rolling upgrade counters: {snap}")
        check(engines[0].gen.params is engines[1].gen.params,
              "the replicas hold two copies of N+1")
        try:
            router.rolling_upgrade(d_n2, swap_timeout_s=60)
            aborted = False
        except RollingUpgradeError:
            aborted = True
        check(aborted, "a corrupt publish did not abort the rollout")
        after = router.submit(prompts[0], ROLL_NEW,
                              greedy()).result(timeout=600)[0]
        check(after == ref_n1[0], "the fleet does not serve N+1 after the "
              "aborted rollout")
        h = router.health()
        check(h["replicas_up"] == 2, f"after the abort: {h}")
        out.update(upgrade_s=upgrade_s, version=version.label,
                   completions=len(results), completions_by_version=at,
                   max_replicas_out=max_down[0],
                   replica_swaps=[dict(e.last_swap) for e in engines],
                   weight_swap_failures=snap["weight_swap_failures"],
                   launches=counts)
    finally:
        router.close()
    return out


def check_lora_live_slice(root: str) -> dict:
    """(f): a 2-layer fp32 slice of the 7B width (TF32 off). Adapter rows
    on a fp32 pool equal their merged-weights serial Generators token for
    token; on an int8 pool each row's logprobs, its tokens fed through the
    merged serial Generator's int8 cache, agree within W8_LOGPROB_TOL (the
    factored and the merged projection differ in the last fp32 bits, and a
    value at a quantization boundary moves one int8 step), and the rows
    whose greedy tokens equal the serial ones are counted. A swap driven
    by CheckpointWatcher.poll_once under load: admissions before it equal
    the serial N, after it the serial N+1; a corrupt publish is refused
    once and not retried."""
    import os

    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.serving.weights import CheckpointWatcher
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training.lora import merge_lora
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    tok = ByteTokenizer()
    model = live_model(cfg, 1, torch.float32)
    factors = lora_factors(cfg, 4, 3000)
    prompts = [tok.tokenize(prompt_text(120 + 40 * i, 70 + i))
               for i in range(8)]
    assign = [([None] + sorted(factors))[i % 5] for i in range(8)]

    def serial(params, p, n, kv):
        g = Generator(params, cfg, eos_id=tok.eod, pad_id=tok.eod,
                      kv_cache_dtype=kv)
        t, lens, _ = g.generate([p], n,
                                sampling=SamplingParams(temperature=0.0))
        return t[0, :lens[0]].tolist()

    out = {}
    for kv in ("float32", "int8"):
        kv_dtype = getattr(torch, kv)
        gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod,
                        kv_cache_dtype=torch.float32)
        engine = lora_engine(gen, adapter_slots=4, adapter_rank=LORA_RANK,
                             kv_dtype=kv, prefill_max_batch=8)
        try:
            for aid, f in factors.items():
                engine.register_adapter(aid, factors=f, rank=LORA_RANK,
                                        alpha=LORA_ALPHA)
            reqs = [engine.submit(p, 24, greedy(), adapter_id=a)
                    for p, a in zip(prompts, assign)]
            got = [r.result(timeout=1800) for r in reqs]
        finally:
            engine.close()
        merged, equal, diff = {}, 0, 0.0
        for p, a, (toks, lps) in zip(prompts, assign, got):
            if a not in merged:
                merged[a] = (model if a is None else merge_lora(
                    model, factors[a], cfg, LORA_RANK, LORA_ALPHA))
            same = toks == serial(merged[a], p, 24, kv_dtype)
            equal += same
            if kv == "float32":
                check(same, f"fp32 slice, fp32 pool: a row under {a} "
                      "differs from its merged-weights serial Generator")
            else:
                g = Generator(merged[a], cfg, eos_id=tok.eod,
                              pad_id=tok.eod, kv_cache_dtype=kv_dtype)
                forced = teacher_forced_logprobs(g, [toks], [len(p)],
                                                 24)[0]
                diff = max([diff] + [abs(x - y)
                                     for x, y in zip(lps, forced)])
        if kv == "int8":
            check(diff <= W8_LOGPROB_TOL,
                  f"fp32 slice, int8 pool: adapter rows' logprobs and the "
                  f"merged serial Generator's differ by {diff} (tol "
                  f"{W8_LOGPROB_TOL})")
            out["adapters_int8_max_logprob_diff"] = diff
        out[f"adapters_{kv}_rows_token_equal"] = equal
        del merged
    # the swap through the watcher
    slice_root = os.path.join(root, "slice")
    d2, _ = publish_live(slice_root, cfg, 2, 2)
    model2 = live_model(cfg, 2, torch.float32)
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod,
                    kv_cache_dtype=torch.float32)
    engine = lora_engine(gen, enable_prefix_cache=True)
    try:
        watcher = CheckpointWatcher(engine, slice_root)
        reqs_a = [engine.submit(p, 40, greedy()) for p in prompts[:4]]
        while not all(r.generated for r in reqs_a):
            time.sleep(0.005)
        check(watcher.poll_once() and watcher.applied == "2",
              "the watcher did not apply the publish")
        reqs_b = [engine.submit(p, 24, greedy()) for p in prompts[4:]]
        got_a = [r.result(timeout=600)[0] for r in reqs_a]
        got_b = [r.result(timeout=600)[0] for r in reqs_b]
        check(got_a == [serial(model, p, 40, torch.float32)
                        for p in prompts[:4]],
              "fp32 slice: a pre-swap admission differs from the serial N")
        check(got_b == [serial(model2, p, 24, torch.float32)
                        for p in prompts[4:]],
              "fp32 slice: a post-swap admission differs from the serial "
              "N+1")
        corrupt_copy(d2, os.path.join(slice_root, "iter_0000003"))
        ckpt._write_text_atomic(os.path.join(slice_root, ckpt.TRACKER), "3",
                                ckpt.RetryPolicy())
        check(not watcher.poll_once() and watcher.failures == 1
              and not watcher.poll_once() and watcher.failures == 1,
              "the watcher retried a refused publish")
        check(engine.health()["weight_iteration"] == 2,
              "the refused publish moved the version")
        out.update(swap_exact=dict(pre=len(got_a), post=len(got_b)),
                   watcher_refusals=watcher.failures)
    finally:
        engine.close()
    del gen, model, model2
    torch.cuda.empty_cache()
    out["allow_tf32"] = False
    return out


def phase_lora_live(smi: str) -> dict:
    """Phase 13: (a) the three bench_lora arms on Llama-2-7B with a bank of
    LORA_SLOTS adapters at rank LORA_RANK, the kernels held on the live
    adapter state; (b) bank pressure with a host budget and a corrupted
    host copy; (c) a LoRA finetune through finetune.main; (d) a hot swap
    under load; (e) a rolling upgrade of two replicas; (f) the fp32 slice.
    Launch counts are zeroed before each part's run and read after it."""
    import gc
    import shutil
    import tempfile

    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before "
          "phase 13: phase 12's model was not freed")
    t_phase = time.perf_counter()
    cfg = llama2_config("7b", num_layers=LORA_LAYERS)
    tok = ByteTokenizer()
    root = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    stats = dict(card=smi)
    try:
        model = LanguageModel(cfg, dtype=torch.bfloat16, seed=LORA_SEED)
        gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod)
        L = cfg.num_layers
        try:
            for name, fn in (("serving", lambda: lora_serving(gen, tok, L)),
                             ("pressure", lambda: bank_pressure(gen, tok,
                                                                root))):
                t0 = time.perf_counter()
                stats[name] = fn()
                stats[name]["seconds"] = time.perf_counter() - t0
                log(f"lora/live ({name}): " + json.dumps(stats[name]))
        finally:
            del gen, model
            gc.collect()
            torch.cuda.empty_cache()
        cfg_live = llama2_config("7b", num_layers=LIVE_LAYERS)
        for name, fn in (
                ("finetune", lambda: lora_finetune(root, LIVE_LAYERS)),
                ("swap", lambda: hot_swap(cfg_live, tok, root, LIVE_LAYERS)),
                ("rolling", lambda: rolling_upgrade_drill(
                    cfg_live, tok, root, LIVE_LAYERS)),
                ("slice", lambda: check_lora_live_slice(root))):
            t0 = time.perf_counter()
            stats[name] = fn()
            stats[name]["seconds"] = time.perf_counter() - t0
            log(f"lora/live ({name}): " + json.dumps(stats[name]))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {}
    for part in ("serving", "pressure", "finetune", "swap", "rolling"):
        for k, v in stats[part]["launches"].items():
            total[k] = total.get(k, 0) + v
    for k, v in stats["finetune"]["serve_launches"].items():
        total[k] = total.get(k, 0) + v
    stats["launches"] = dict(flash_fwd=total["flash_fwd_cuda"],
                             flash_bwd_dq=total["flash_bwd_dq_cuda"],
                             flash_bwd_dkv=total["flash_bwd_dkv_cuda"],
                             block_attn=total["block_attention_cuda"])
    stats["norm_launches"] = {k: v for k, v in total.items()
                              if k.startswith(("rms_", "ln_"))}
    check(all(v > 0 for v in stats["launches"].values()),
          f"phase 13 launches: {stats['launches']}")
    stats["seconds"] = time.perf_counter() - t_phase
    return stats


# Phase 14, structured output, n-best fan-out and the brownout ladder with
# its SLO accounting. (a)-(d): Llama-2-7B at full width and STRUCT_LAYERS
# of its 32 layers (the whole smoke's time limit cuts the depth, never the
# width; random bf16 weights, seed STRUCT_SEED), 8 slots, 16-token
# blocks, the block kernel, each request prefilled alone
# (`prefill_max_batch=1`), the
# grammars composed over the byte-level identity table
# (`default_token_strings(32000)`: token i is chr(i)), every prompt made of
# identity tokens. Launch counts are zeroed before each part and read after
# it.
STRUCT_SEED = 0
STRUCT_LAYERS = 8
STRUCT_SERVING = dict(ENGINE_SERVING, prefill_max_batch=1)
STRUCT_REQUESTS = 8
STRUCT_PROMPT = 160
STRUCT_NEW = 32
FANOUT_N = 4
FANOUT_PROMPT = 200   # not a multiple of the 16-token block
FANOUT_NEW = 32
FANOUT_SEED = 7
STRUCT_SPEC_REQUESTS = 8
STRUCT_SPEC_NEW = 24
STRUCT_SPEC_GRAMMAR = {"type": "regex", "pattern": "[0-9]{8,24}"}
STORM_SEED = 17
STORM_REQUESTS = 24
STORM_NEW = 8
STORM_SERVING = dict(num_slots=8, max_queue=16, kv_block_size=16,
                     block_native_attn=True)
SLICE_REQUESTS_NEW = 24


def id_tokens(text: str) -> list[int]:
    """Identity-table token ids of an ASCII text (token i is chr(i))."""
    return [ord(c) for c in text]


def structured_engine(gen, token_strings, **fields):
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.serving import ServingEngine
    return ServingEngine(gen, ServingConfig(**dict(STRUCT_SERVING,
                                                   **fields)),
                         token_strings=token_strings)


def block_capture(captures, want_w: int, min_active: int = 6):
    """A stand-in for the block kernel's wrapper that copies the inputs of
    its first call at w `want_w` made while `captures["engine"]` holds at
    least `min_active` running slots under a grammar mask, then launches."""
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda

    def recording(q, k_arena, v_arena, block_map, lengths, **kw):
        eng = captures.get("engine")
        key = f"w{q.shape[1]}"
        if (eng is not None and q.shape[1] == want_w and key not in captures
                and int((eng._mask_state >= 0).sum()) >= min_active):
            captures[key] = dict(q=q.clone(), k=k_arena.clone(),
                                 v=v_arena.clone(), map=block_map.clone(),
                                 lengths=lengths.clone(), kw=kw)
        return block_attention_cuda(q, k_arena, v_arena, block_map,
                                    lengths, **kw)
    return recording


def hold_block_capture(c: dict, what: str) -> dict:
    """The block kernel on a captured live state against its plain
    version (not counted: callers read their counts before)."""
    import torch
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    got = block_attention_cuda(c["q"], c["k"], c["v"], c["map"],
                               c["lengths"], **c["kw"])
    ref = ba.block_attention_reference(c["q"], c["k"], c["v"], c["map"],
                                       c["lengths"], scale=c["kw"]["scale"])
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = live_tol(BLOCK_LIVE_TOL, ref_max)
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"block kernel on {what}: err {err} (tol {tol})")
    return dict(w=int(c["q"].shape[1]), max_abs_err=err, tol=tol,
                max_abs_ref=ref_max, lengths=c["lengths"].tolist())


def structured_arms(gen, token_strings, L) -> dict:
    """(a): tools/bench_structured.py's constrained arm against its free
    arm, a regex and a JSON-schema grammar, on one engine; the block kernel
    held on the live masked grid."""
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    from megatron_tpu_torch.tools import bench_structured as bs
    prompts = [id_tokens(prompt_text(STRUCT_PROMPT, 40 + i))
               for i in range(STRUCT_REQUESTS)]
    engine = structured_engine(gen, token_strings)
    captures = {"engine": engine}
    try:
        engine.generate(prompts[0][:32], 4, greedy(), timeout=600)
        wait_idle(engine)
        engine.metrics = ServingMetrics()
        zero_counts()
        ba.block_attention_cuda = block_capture(captures, 1)
        try:
            arm = bs.arm_constrained_vs_free(engine, prompts, STRUCT_NEW,
                                             token_strings=token_strings)
        finally:
            ba.block_attention_cuda = block_attention_cuda
        snap = settle(engine)
        counts = read_counts()
    finally:
        captures.pop("engine", None)
        engine.close()
    check(arm["ok"], f"bench_structured constrained arm: {arm}")
    check(counts["block_attention_cuda"] == L * snap["decode_steps"],
          f"structured: {counts['block_attention_cuda']} block launches in "
          f"{snap['decode_steps']} steps of {L} layers")
    check(counts["flash_fwd_cuda"] == L * snap["prefill_calls"],
          f"structured: {counts['flash_fwd_cuda']} flash launches for "
          f"{snap['prefill_calls']} prefills of {L} layers")
    check("w1" in captures, "structured: no block call with 6 masked slots")
    arm["live_block_w1"] = hold_block_capture(captures.pop("w1"),
                                              "the live masked grid (w 1)")
    arm["launches"] = counts
    return arm


def pool_books(engine) -> tuple:
    """(references held, free blocks, shared blocks) of the pool, the
    trash block aside."""
    acct = engine.pool.accounting()
    rc = [int(r) for b, r in enumerate(acct["rc"]) if b != acct["trash"]]
    return (sum(rc), len(acct["free_blocks"]),
            engine.pool.shared_block_count())


def fanout_arm(gen, token_strings, L) -> dict:
    """(b): one n=4 fan-out on a prompt the engine has not seen (its flash
    launches one prefill's, the siblings aliasing the leader's blocks, the
    pool's books back to their baseline), then its four n=1 twins one after
    another on a second engine over the same weights; each sample equals its
    twin. A twin on the fan-out's own engine would hit the retained prompt
    and forward its last prompt token on the dot path, where the leader
    took the flash prefill: bf16 logits that differ in the last bits."""
    from megatron_tpu_torch.serving import SamplingOptions
    sampling = SamplingOptions(temperature=0.8, top_k=8)
    prompt = id_tokens(prompt_text(FANOUT_PROMPT, 77))
    hit = (len(prompt) - 1) // 16 * 16
    engine = structured_engine(gen, token_strings, enable_prefix_cache=True,
                               retained_slots=0)
    try:
        engine.generate(id_tokens(prompt_text(40, 3)), 4, greedy(),
                        timeout=600)
        wait_idle(engine)
        settle(engine)
        books0 = pool_books(engine)
        snap0 = engine.metrics.snapshot()
        zero_counts()
        t0 = time.perf_counter()
        agg = engine.submit(prompt, FANOUT_NEW, sampling, seed=FANOUT_SEED,
                            n=FANOUT_N, best_of=FANOUT_N)
        agg.result(timeout=1800)
        fan_wall = time.perf_counter() - t0
        snap = settle(engine)
        counts = read_counts()
        deadline = time.monotonic() + 30
        while pool_books(engine) != books0:
            check(time.monotonic() < deadline,
                  f"fan-out: the pool's books {pool_books(engine)} did not "
                  f"return to {books0}")
            time.sleep(0.05)
        samples = [c.prompt + c.generated for c in agg.children]
        ttft = [c.ttft * 1e3 for c in agg.children]
    finally:
        engine.close()
    d = {k: snap[k] - snap0[k] for k in (
        "prefix_hits", "prefill_tokens_saved", "prefill_forward_tokens",
        "fanout_requests", "fanout_samples", "requests_received")}
    check(counts["flash_fwd_cuda"] == L,
          f"fan-out: {counts['flash_fwd_cuda']} flash launches, not one "
          f"prefill's {L}")
    check(d["prefix_hits"] == FANOUT_N - 1
          and d["prefill_tokens_saved"] == (FANOUT_N - 1) * hit,
          f"fan-out: siblings did not alias the leader's blocks: {d}")
    check(d["fanout_requests"] == 1 and d["fanout_samples"] == FANOUT_N
          and d["requests_received"] == FANOUT_N, f"fan-out counters: {d}")
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    twins_engine = structured_engine(gen, token_strings,
                                     enable_prefix_cache=True)
    try:
        t0 = time.perf_counter()
        twins = [twins_engine.submit(prompt, FANOUT_NEW, sampling,
                                     seed=FANOUT_SEED + i
                                     ).result(timeout=1800)[0]
                 for i in range(FANOUT_N)]
        twin_wall = time.perf_counter() - t0
    finally:
        twins_engine.close()
    equal = sum(a == b for a, b in zip(samples, twins))
    check(equal == FANOUT_N,
          f"fan-out: {equal} of {FANOUT_N} samples equal their n=1 twins")
    gen_tokens = FANOUT_N * FANOUT_NEW
    return dict(n=FANOUT_N, prompt=len(prompt), counters=d,
                flash_launches=counts["flash_fwd_cuda"],
                block_launches=counts["block_attention_cuda"],
                pool_books=list(books0), samples_equal_twins=equal,
                fanout_wall_s=fan_wall, twins_wall_s=twin_wall,
                fanout_tokens_per_s=gen_tokens / fan_wall,
                twins_tokens_per_s=gen_tokens / twin_wall,
                fanout_ttft_ms=ttft, launches=counts)


def structured_spec(gen, token_strings, L) -> dict:
    """(c): constrained greedy requests on a speculative engine (k SPEC_K):
    verify rounds at w SPEC_K + 1 under per-position grammar masks, the
    block kernel held on one; every completion FSM-legal."""
    from megatron_tpu_torch.ops import block_attention as ba
    from megatron_tpu_torch.ops.block_attention_cuda import \
        block_attention_cuda
    from megatron_tpu_torch.serving.structured import \
        compile_response_format
    fsm = compile_response_format(STRUCT_SPEC_GRAMMAR, gen.cfg.vocab_size,
                                  token_strings=token_strings,
                                  eos_id=gen.eos_id)
    # digits repeating a span: the drafter proposes digit continuations,
    # legal under the grammar
    prompts = [id_tokens(("".join(str((i * 7 + j * 3) % 10)
                                  for j in range(5)) * 40)[:STRUCT_PROMPT])
               for i in range(STRUCT_SPEC_REQUESTS)]
    engine = structured_engine(gen, token_strings, speculative_k=SPEC_K)
    captures = {"engine": engine}
    ba.block_attention_cuda = block_capture(captures, SPEC_K + 1)
    try:
        zero_counts()
        reqs = [engine.submit(p, STRUCT_SPEC_NEW, greedy(),
                              response_format=STRUCT_SPEC_GRAMMAR)
                for p in prompts]
        outs = [r.result(timeout=1800)[0] for r in reqs]
        snap = settle(engine)
        counts = read_counts()
    finally:
        ba.block_attention_cuda = block_attention_cuda
        captures.pop("engine", None)
        engine.close()
    legal = all(fsm.replay(o[len(p):])[0] for o, p in zip(outs, prompts))
    check(legal, "structured verify: an illegal token was committed")
    check(snap["spec_rounds"] > 0, "structured verify: no verify round ran")
    check(counts["block_attention_cuda"] == L * snap["decode_steps"],
          f"structured verify: {counts['block_attention_cuda']} block "
          f"launches in {snap['decode_steps']} rounds and steps")
    key = f"w{SPEC_K + 1}"
    check(key in captures, "structured verify: no masked verify round "
          "with 6 grammar rows was captured")
    return dict(spec_rounds=snap["spec_rounds"],
                spec_fallback_steps=snap["spec_fallback_steps"],
                draft_tokens=snap["draft_tokens"],
                accepted_tokens=snap["accepted_tokens"],
                mask_uploads=snap["mask_uploads"],
                block_launches=counts["block_attention_cuda"],
                outputs_legal=legal,
                live_block_verify=hold_block_capture(
                    captures.pop(key), f"a masked verify round (w "
                                       f"{SPEC_K + 1})"),
                launches=counts)


def storm_arms(gen, L) -> dict:
    """(d): tools/chaos_storm.py, one seed, three arms at 0.5x, 1x and 2x
    of the rate a calibration on the card sustains, the ladder at 4 rungs,
    judged by laws 8-11 and the structural sweep (the serial-oracle law
    off: a bf16 model's batched tokens need not equal its batch-1 ones)."""
    from megatron_tpu_torch.tools import chaos_storm
    zero_counts()
    rec = chaos_storm.run_one(STORM_SEED, (), n_requests=STORM_REQUESTS,
                              new_tokens=STORM_NEW, gen=gen,
                              check_tokens=False,
                              serving_overrides=STORM_SERVING)
    counts = read_counts()
    check(rec["ok"], f"storm: {rec['violations']} (repro: {rec['repro']})")
    check(rec["degrade_peak"] >= 1 and rec["degrade_final"] == 0,
          f"storm: the level series peaked at {rec['degrade_peak']} and "
          f"ended at {rec['degrade_final']}")
    levels = rec.pop("levels")
    # the polled series, runs of one level as (level, samples)
    runs = []
    for lv in levels:
        if runs and runs[-1][0] == lv:
            runs[-1][1] += 1
        else:
            runs.append([lv, 1])
    rec["level_runs"] = runs
    rec["launches"] = counts
    return rec


def check_structured_slice() -> dict:
    """(e): a 2-layer fp32 slice of the 7B width (TF32 off). Constrained
    greedy streams equal the host-driven masked serial oracle
    (bench_structured.masked_serial_oracle) with speculation off and on, on
    an fp32 and an int8 pool; fan-out samples equal serial n=1 generates at
    seed + i; a rung-2 clamp gives the serial output of the effective
    config; rung 1 switched on mid-stream changes no token; then
    tools/chaos_serve.py's three drills (over this slice) and
    tools/chaos_upgrade.py's drills 1-2 (over the tools' tiny model) on the
    card, each ending in a strict invariant sweep."""
    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.serving import SamplingOptions
    from megatron_tpu_torch.serving.structured import (
        compile_response_format, default_token_strings)
    from megatron_tpu_torch.tools import chaos_serve, chaos_upgrade
    from megatron_tpu_torch.tools.bench_structured import (
        GRAMMAR, SCHEMA, masked_serial_oracle)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama2_config("7b", num_layers=2, compute_dtype="float32")
    strings = default_token_strings(cfg.vocab_size)
    model = LanguageModel(cfg, dtype=torch.float32, seed=1)
    gen = Generator(model, cfg, eos_id=-1, pad_id=0,
                    kv_cache_dtype=torch.float32)
    digits = {"type": "regex", "pattern": "[0-9]{6,16}"}
    cases = [(id_tokens(prompt_text(100 + 20 * i, 90 + i)), rf)
             for i, rf in enumerate((GRAMMAR, SCHEMA, digits))]
    cases.append((id_tokens("1212121212" * 8), digits))
    fsms = [compile_response_format(rf, cfg.vocab_size,
                                    token_strings=strings, eos_id=-1)
            for _, rf in cases]
    out = {}
    for kv in ("float32", "int8"):
        oracle_gen = Generator(model, cfg, eos_id=-1, pad_id=0,
                               kv_cache_dtype=getattr(torch, kv))
        want = [masked_serial_oracle(oracle_gen, p, SLICE_REQUESTS_NEW, f)
                for (p, _), f in zip(cases, fsms)]
        for k in (0, SPEC_K):
            engine = structured_engine(gen, strings, kv_dtype=kv,
                                       speculative_k=k)
            try:
                reqs = [engine.submit(p, SLICE_REQUESTS_NEW, greedy(),
                                      response_format=rf)
                        for p, rf in cases]
                reqs.append(engine.submit(cases[0][0], 8, greedy()))
                got = [r.result(timeout=600)[0] for r in reqs]
                snap = engine.metrics.snapshot()
            finally:
                engine.close()
            for (p, rf), g, w in zip(cases, got, want):
                check(g[len(p):] == w,
                      f"fp32 slice, {kv} pool, speculative_k {k}: a "
                      f"constrained stream ({rf}) differs from the masked "
                      "serial oracle")
            out[f"{kv}_k{k}"] = dict(mask_uploads=snap["mask_uploads"],
                                     spec_rounds=snap["spec_rounds"],
                                     accepted_tokens=snap["accepted_tokens"])
    # fan-out against serial n=1 generates
    sampling = SamplingOptions(temperature=0.8, top_k=8)
    prompt = id_tokens(prompt_text(FANOUT_PROMPT, 5))
    engine = structured_engine(gen, strings, enable_prefix_cache=True)
    try:
        agg = engine.submit(prompt, 16, sampling, seed=FANOUT_SEED, n=3,
                            best_of=3)
        agg.result(timeout=600)
        fan_hits = engine.metrics.snapshot()["prefix_hits"]
    finally:
        engine.close()
    for i, c in enumerate(agg.children):
        t, lens, _ = gen.generate([prompt], 16, SamplingParams(
            temperature=0.8, top_k=8), seed=FANOUT_SEED + i)
        check(c.prompt + c.generated == t[0, :lens[0]].tolist(),
              f"fp32 slice: fan-out sample {i} differs from the serial "
              "n=1 generate at its seed")
    out["fanout"] = dict(samples=3, prefix_hits=fan_hits)
    # rung 2's clamp and rung 1 mid-stream
    hold = dict(degrade_ladder=4, degrade_dwell_down=10 ** 9,
                degrade_max_new_tokens=4)
    engine = structured_engine(gen, strings, speculative_k=SPEC_K, **hold)
    try:
        p = cases[3][0]
        engine.degrade.level = 2
        r = engine.submit(p, 16, greedy())
        clamped = r.result(timeout=600)[0]
        t, lens, _ = gen.generate([p], 4, SamplingParams(temperature=0.0))
        check(r.max_new_tokens == 4 and clamped == t[0, :lens[0]].tolist(),
              "fp32 slice: rung 2's clamp is not the serial run of the "
              "effective config")
        engine.degrade.level = 0
        r = engine.submit(p, 40, greedy())
        while len(r.generated) < 8 and not r.done():
            time.sleep(0.001)
        engine.degrade.level = 1
        switched_at = len(r.generated)
        toks = r.result(timeout=600)[0]
        t, lens, _ = gen.generate([p], 40, SamplingParams(temperature=0.0))
        check(switched_at < 40 and toks == t[0, :lens[0]].tolist(),
              "fp32 slice: rung 1 switched mid-stream changed a token")
        snap = engine.metrics.snapshot()
    finally:
        engine.close()
    out["rungs"] = dict(clamped_to=4, rung1_switched_at=switched_at,
                        spec_rounds=snap["spec_rounds"])
    del gen, model
    torch.cuda.empty_cache()
    slice_model = LanguageModel(cfg, dtype=torch.float32, seed=2)
    slice_gen = Generator(slice_model, cfg, eos_id=-1, pad_id=0,
                          kv_cache_dtype=torch.float32)
    serve = chaos_serve.run_chaos(16, 1.0, 2.5, spec_k=SPEC_K,
                                  gen=slice_gen)
    del slice_gen, slice_model
    torch.cuda.empty_cache()
    check(serve["completed"], "chaos_serve on the card: " + json.dumps(
        {k: serve[k]["ok"] for k in ("overload", "hang", "crash_loop")}))
    upgrade = chaos_upgrade.run_chaos(8)
    check(upgrade["completed"], "chaos_upgrade on the card: " + json.dumps(
        {k: upgrade[k]["ok"] for k in ("kill_draining", "corrupt_watch")}))
    out["chaos_serve"] = {k: {kk: serve[k][kk] for kk in (
        "ok", "invariants_ok")} for k in ("overload", "hang", "crash_loop")}
    out["chaos_serve"]["hang_recovery_s"] = serve["hang"]["recovery_s"]
    out["chaos_upgrade"] = {k: {kk: upgrade[k][kk] for kk in (
        "ok", "invariants_ok")} for k in ("kill_draining", "corrupt_watch")}
    out["allow_tf32"] = False
    return out


def phase_structured_degrade(smi: str) -> dict:
    """Phase 14: (a) constrained against free, (b) an n=4 fan-out against
    its n=1 twins, (c) constrained verify rounds and (d) a load storm on
    Llama-2-7B at full width and STRUCT_LAYERS layers, launch counts
    zeroed before each
    part and read after it; (e) the 2-layer fp32 slice."""
    import gc

    import torch
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.serving.structured import default_token_strings
    from megatron_tpu_torch.tools.bench_structured import (GRAMMAR, SCHEMA,
                                                          compile_seconds)

    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before "
          "phase 14: phase 13's model was not freed")
    t_phase = time.perf_counter()
    cfg = llama2_config("7b", num_layers=STRUCT_LAYERS)
    strings = default_token_strings(cfg.vocab_size)
    stats = dict(card=smi)
    stats["fsm_compile_s"] = {
        name: compile_seconds(rf, cfg.vocab_size, strings, -1)[1]
        for name, rf in (("regex", GRAMMAR), ("json_schema", SCHEMA))}
    log("structured/degrade: TokenFSM compile seconds at V "
        f"{cfg.vocab_size} (host): {json.dumps(stats['fsm_compile_s'])}")
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=STRUCT_SEED)
    gen = Generator(model, cfg, eos_id=-1, pad_id=0)
    L = cfg.num_layers
    try:
        for name, fn in (
                ("structured", lambda: structured_arms(gen, strings, L)),
                ("fanout", lambda: fanout_arm(gen, strings, L)),
                ("verify", lambda: structured_spec(gen, strings, L)),
                ("storm", lambda: storm_arms(gen, L))):
            t0 = time.perf_counter()
            stats[name] = fn()
            stats[name]["seconds"] = time.perf_counter() - t0
            log(f"structured/degrade ({name}, {smi}): "
                + json.dumps(stats[name]))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        del gen, model
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats["slice"] = check_structured_slice()
    stats["slice"]["seconds"] = time.perf_counter() - t0
    log(f"structured/degrade slice (fp32, 2 layers, {smi}): "
        + json.dumps(stats["slice"]))
    total = {}
    for part in ("structured", "fanout", "verify", "storm"):
        for k, v in stats[part]["launches"].items():
            total[k] = total.get(k, 0) + v
    stats["launches"] = dict(flash_fwd=total["flash_fwd_cuda"],
                             block_attn=total["block_attention_cuda"])
    stats["norm_launches"] = {k: v for k, v in total.items()
                              if k.startswith(("rms_", "ln_"))}
    check(all(v > 0 for v in stats["launches"].values()),
          f"phase 14 launches: {stats['launches']}")
    stats["seconds"] = time.perf_counter() - t_phase
    return stats


# ---------------------------------------------------------------------
# phase 15: remote replicas
# ---------------------------------------------------------------------
FLEET_SEED = 0
# the replicas' depth, of Llama-2-7B's 32 layers (the whole smoke's time
# limit; the width is not cut)
FLEET_LAYERS = 16
# each request prefilled alone and the decode grid fixed: a request's bf16
# tokens then depend on none of its neighbours, so the fleet's completions
# can be held to one replica process's
FLEET_SERVING = dict(ENGINE_SERVING, enable_prefix_cache=True,
                     prefill_max_batch=1)
FLEET_NEW = 64
FLEET_STREAMS = 8
# the front tier's client: a short read timeout, which is what ejects a
# stopped (SIGSTOP) replica, as in tools/chaos_fleet.py
FLEET_REMOTE = dict(remote_connect_timeout_s=2.0, remote_read_timeout_s=5.0,
                    remote_max_retries=2, remote_digest_interval_s=0.5,
                    router_heartbeat_timeout_s=3.0)
FLEET_BOOT_S = 300.0
FLEET_KILL_AFTER = 8      # tokens every request holds before the fault
FLEET_BENCH = ["--requests", "32", "--new", "64", "--prompt", "256",
               "--stream", "--vary_prompts"]
FLEET_SLICE_LAYERS = 2
FLEET_SLICE_NEW = 48


class ReplicaProcs:
    """Replica server processes (`tools/chaos_fleet.py --serve_replica`,
    the `replica_mode` MegatronServer) on 127.0.0.1, each with its own log
    file and launch-count file under `root`. Every one is stopped in
    `close`, which the caller runs in a `finally`."""

    def __init__(self, root: str, args: list):
        self.root, self.args = root, list(args)
        self.procs, self.ports, self.counts, self.boot_s = {}, {}, {}, {}
        self._logs = []

    def spawn(self, name: str, port: int = 0):
        from megatron_tpu_torch.tools.chaos_common import (free_port,
                                                           spawn_replica)
        port = port or free_port()
        counts = f"{self.root}/{name}.{len(self._logs)}.counts.json"
        log_f = open(f"{self.root}/{name}.{len(self._logs)}.log", "w")
        self._logs.append(log_f)
        self.procs[name] = spawn_replica(
            port, self.args + ["--counts_out", counts], stdout=log_f,
            stderr=subprocess.STDOUT)
        self.ports[name], self.counts[name] = port, counts
        self.boot_s[name] = time.perf_counter()

    def wait_ready(self, *names) -> None:
        from megatron_tpu_torch.tools.chaos_common import wait_replica_ready
        for name in names:
            wait_replica_ready(self.addr(name), FLEET_BOOT_S,
                               self.procs[name])
            self.boot_s[name] = time.perf_counter() - self.boot_s[name]

    def addr(self, name: str) -> str:
        return f"127.0.0.1:{self.ports[name]}"

    def signal(self, name: str, sig) -> None:
        import os
        os.kill(self.procs[name].pid, sig)

    def kill(self, name: str) -> None:
        self.procs[name].kill()
        self.procs[name].wait(timeout=60)

    def memory_mib(self) -> dict:
        """The device memory of each process on the card, from nvidia-smi:
        by replica where its pids are this namespace's, else by the pid
        nvidia-smi reports."""
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout
        by_pid = {}
        for line in out.strip().splitlines():
            pid, _, mib = line.partition(",")
            if pid.strip().isdigit() and mib.strip().isdigit():
                by_pid[int(pid)] = int(mib)
        names = {p.pid: name for name, p in self.procs.items()
                 if p.poll() is None}
        return {names.get(pid, f"pid {pid}"): mib
                for pid, mib in sorted(by_pid.items())}

    def stop(self, name: str) -> dict:
        """SIGTERM: the replica drains and writes its launch counts."""
        import signal
        p = self.procs[name]
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=120)
        check(p.returncode == 0, f"replica {name} exited {p.returncode}")
        with open(self.counts[name]) as f:
            return json.load(f)

    def close(self) -> None:
        import signal
        for p in self.procs.values():
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGCONT)
                    p.kill()
                except OSError:
                    pass
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass
        for f in self._logs:
            f.close()

    def tail(self, n: int = 4000) -> str:
        """The replicas' log ends, for a failure's report."""
        out = []
        for f in self._logs:
            f.flush()
            with open(f.name) as r:
                out.append(f"--- {f.name}\n{r.read()[-n:]}")
        return "\n".join(out)


def fleet_front(addrs, tok=None):
    """A fleet front tier over `addrs`, serving on 127.0.0.1: (server,
    httpd, thread, port). It holds no weights and touches no device."""
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.server import MegatronServer
    server = MegatronServer(None, tok or ByteTokenizer(),
                            serving=ServingConfig(fleet=",".join(addrs),
                                                  **FLEET_REMOTE))
    httpd, thread = serve_http(server)
    return server, httpd, thread, httpd.server_address[1]


def get_json(port: int, path: str):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def warm_remote(port: int, prefixes) -> None:
    """Each prefix prefilled alone on the replica at `port` and retained
    (sent straight to it as `prompt_tokens`, past any front tier)."""
    tok = ByteTokenizer()
    for p in prefixes:
        status, body = put(port, {"prompt_tokens": [tok.tokenize(p + " ")],
                                  "tokens_to_generate": 1,
                                  "temperature": 0.0})
        check(status == 200, f"warming a prefix: {status} {body}")


def fleet_traffic(port: int, payloads, streams=()):
    """Every payload through the front tier at once, one thread each; the
    indices in `streams` as SSE streams (their token frames must equal
    their `done` frame). Returns (threads, the generated tokens of each in
    order once `join_traffic` returned, the errors raised)."""
    out = [None] * len(payloads)

    def one(i):
        if i in streams:
            conn, resp = sse_open(port, dict(payloads[i], stream=True))
            toks, end = [], None
            try:
                for event, eid, data, _ in sse_frames(resp):
                    if event == "token":
                        check(int(eid) == len(toks),
                              f"stream {i}: event {eid} after {len(toks)}")
                        toks.append(data["token"])
                    elif event in ("done", "error"):
                        end = (event, data)
            finally:
                conn.close()
            check(end is not None and end[0] == "done",
                  f"stream {i} ended {end}")
            plen = len(payloads[i]["prompts"][0])
            check(end[1]["segments"][plen:] == toks,
                  f"stream {i}: token frames differ from its done frame")
            out[i] = toks
        else:
            status, body = put(port, payloads[i])
            check(status == 200, f"request {i}: {status} {body}")
            out[i] = new_tokens(payloads[i], body)

    errors = []

    def guarded(i):
        try:
            one(i)
        except Exception as e:  # noqa: BLE001 — join_traffic raises it
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    return threads, out, errors


def join_traffic(threads, errors) -> None:
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "a request never returned")
    if errors:
        raise errors[0]


def replica_snaps(router) -> list:
    return [rep.engine.metrics.snapshot() for rep in router.replicas]


def wait_inflight(made, n: int, count: int, timeout: float = 300.0) -> None:
    """Until `count` router requests were made and each has at least n
    tokens (or is done)."""
    give_up = time.monotonic() + timeout
    while len(made) < count or not all(
            r.done() or len(r.generated) >= n for r in made):
        check(time.monotonic() < give_up, "requests did not start decoding")
        time.sleep(0.01)


def wait_fleet_up(server, timeout: float = 120.0) -> float:
    """Drive the half-open re-admission (canary requests through the front
    tier) until every replica is in rotation; returns the seconds."""
    router = server.engine
    t0 = time.perf_counter()
    give_up = time.monotonic() + timeout
    while router.health()["replicas_up"] < len(router.replicas):
        check(time.monotonic() < give_up, "a replica was not re-admitted: "
              + json.dumps(router.health()))
        status, body = server.handle({"prompts": ["canary"],
                                      "tokens_to_generate": 2,
                                      "temperature": 0.0})
        check(status in (200, 503), f"canary: {status} {body}")
        time.sleep(0.2)
    return time.perf_counter() - t0


def fleet_fault(server, port, procs, payloads, fault: str) -> dict:
    """(c) or (d): the payloads in flight on both replicas, each holding
    FLEET_KILL_AFTER tokens; then the replica holding the most of them is
    SIGKILLed, or SIGSTOPped until the front tier has ejected it. Every
    request completes; /healthz stays accepting with one replica up. A
    killed replica is respawned on its port and re-admitted, a stopped one
    continued and re-admitted. Returns the stats and the tokens."""
    import signal
    router = server.engine
    made = capture_requests(router)
    before = router.aggregate_snapshot()
    threads, out, errors = fleet_traffic(port, payloads)
    wait_inflight(made, FLEET_KILL_AFTER, len(payloads))
    on = [r.replica.idx for r in made if not r.done()]
    victim_idx = max(set(on), key=on.count) if on else 0
    victim = ["A", "B"][victim_idx]
    stats = dict(victim=victim, victim_requests=on.count(victim_idx))
    t0 = time.perf_counter()
    if fault == "sigkill":
        procs.kill(victim)
    else:
        procs.signal(victim, signal.SIGSTOP)
    try:
        give_up = time.monotonic() + 60
        while router.replicas[victim_idx].state != "down":
            check(time.monotonic() < give_up, f"{fault}: never ejected")
            router.health()
            time.sleep(0.1)
        stats["eject_s"] = time.perf_counter() - t0
        status, health = get_json(port, "/healthz")
        check(status == 200 and health["accepting"]
              and health["state"] == "degraded"
              and health["replicas_up"] == 1,
              f"{fault}: /healthz {status} {health}")
        join_traffic(threads, errors)
        stats["recovered_s"] = time.perf_counter() - t0
        if fault == "sigkill":
            # (e): the dead replica recorded, not convicted
            wait_quiet_remote(router.engines[1 - victim_idx])
            status, inv = get_json(port, "/invariants?strict=1")
            check(status == 200 and inv["ok"] and inv["engines"] == 2
                  and inv.get("unreachable") == [procs.addr(victim)],
                  f"(e) with a dead replica: {inv}")
            stats["invariants_dead"] = dict(
                ok=inv["ok"], engines=inv["engines"],
                unreachable=inv["unreachable"],
                laws=len(inv["laws_checked"]))
    finally:
        if fault == "sigstop":
            procs.signal(victim, signal.SIGCONT)
    after = router.aggregate_snapshot()
    stats.update(
        router_failovers=after["router_failovers"]
        - before["router_failovers"],
        router_retries=after["router_retries"] - before["router_retries"],
        remote_timeouts=after["router_remote_timeouts"]
        - before["router_remote_timeouts"],
        probe_failures=after["router_probe_failures"]
        - before["router_probe_failures"])
    check(stats["router_failovers"] >= 1
          and stats["router_retries"] >= stats["victim_requests"] >= 1,
          f"{fault}: {stats}")
    if fault == "sigkill":
        t1 = time.perf_counter()
        procs.spawn(victim, procs.ports[victim])
        procs.wait_ready(victim)
        stats["respawn_s"] = time.perf_counter() - t1
    return stats, out


def fleet_bench(port: int, root: str, label: str) -> dict:
    """tools/serving_bench.py --url against the front tier, in its own
    process: tokens/s, TTFT p50/p99 and the inter-token p50 clients see."""
    import sys
    out = f"{root}/bench_{label}.json"
    run = subprocess.run(
        [sys.executable, "-m", "megatron_tpu_torch.tools.serving_bench",
         "--url", f"127.0.0.1:{port}", "--out", out, *FLEET_BENCH],
        capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"serving_bench {label}: {run.stderr[-2000:]}")
    with open(out) as f:
        rec = json.load(f)
    check(rec["completed"] == 32 and not rec["failed"]
          and not rec["rejected_429"], f"serving_bench {label}: {rec}")
    return rec


def check_fleet_slice(root: str) -> dict:
    """(f): two 2-layer fp32 replica processes of the 7B width (TF32 off)
    behind a front tier: greedy completions and streams, the replica
    holding most of them SIGKILLed while they decode, every completion
    equal to the serial route of the same weights in this process."""
    import torch
    from megatron_tpu_torch.tools.chaos_fleet import replica_generator
    gen = replica_generator("llama2-7b", FLEET_SLICE_LAYERS, "float32",
                            FLEET_SEED + 1, "cuda")
    tok = ByteTokenizer()
    prompts = [prompt_text(100 + 60 * i, 1600 + i) for i in range(6)]
    payloads = [{"prompts": [p], "tokens_to_generate": FLEET_SLICE_NEW,
                 "temperature": 0.0} for p in prompts]
    procs = ReplicaProcs(root, [
        "--device", "cuda", "--model", "llama2-7b", "--layers",
        FLEET_SLICE_LAYERS, "--dtype", "float32", "--seed", FLEET_SEED + 1,
        "--serving", json.dumps(FLEET_SERVING)])
    try:
        procs.spawn("fA")
        procs.spawn("fB")
        procs.wait_ready("fA", "fB")
        server, httpd, thread, port = fleet_front(
            [procs.addr("fA"), procs.addr("fB")], tok)
        try:
            made = capture_requests(server.engine)
            threads, out, errors = fleet_traffic(port, payloads,
                                                 streams={4, 5})
            wait_inflight(made, 4, len(payloads))
            # the replica holding the most unfinished requests, as (c)
            # picks its victim (affinity may send them all to one)
            on = [r.replica.idx for r in made if not r.done()]
            procs.kill(["fA", "fB"][max(set(on), key=on.count) if on
                                    else 0])
            join_traffic(threads, errors)
            snap = server.engine.aggregate_snapshot()
        finally:
            stop_tool(httpd, thread)
            server.close()
    finally:
        procs.close()
    check(snap["router_retries"] >= 1, "(f): nothing failed over")
    want = []
    for p in prompts:
        toks, lens, _ = gen.generate([tok.tokenize(p)], FLEET_SLICE_NEW,
                                     greedy_params())
        want.append(toks[0, len(tok.tokenize(p)):int(lens[0])].tolist())
    check(out == want, "(f): a fleet completion differs from the serial "
          "route")
    del gen
    torch.cuda.empty_cache()
    return dict(agree=True, requests=len(payloads), streams=2,
                router_retries=snap["router_retries"],
                router_failovers=snap["router_failovers"],
                allow_tf32=False)


def greedy_params():
    from megatron_tpu_torch.inference.generation import SamplingParams
    return SamplingParams(temperature=0.0)


def phase_fleet(smi: str) -> dict:
    """Phase 15: remote replicas. Two Llama-2-7B replica processes
    (FLEET_LAYERS layers, bf16, seed FLEET_SEED) behind a fleet front tier
    in this process, which holds no weights, over HTTP on 127.0.0.1: (a)
    /healthz, (b) a 16-request trace (8 SSE streams) over four 1,024-token prefixes,
    each warmed on one replica only, routed by the affinity digest, (c) a
    SIGKILL mid-decode, the respawn and its re-admission, (d) a SIGSTOP
    ejected by read timeouts and re-admitted after SIGCONT, (e) the fleet's
    strict invariant sweep; the completions of (b)-(d) equal one replica
    process's; serving_bench against the fleet and against one replica
    process; (f) the 2-layer fp32 slice. Each replica's launch counts are
    its whole life's, written at its SIGTERM shutdown."""
    import gc
    import tempfile

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before "
          "phase 15: phase 14's model was not freed")
    t_phase = time.perf_counter()
    stats = dict(card=smi)
    groups_a = [prompt_text(FRONT_PREFIX, 8000 + g)
                for g in range(FRONT_GROUPS)]
    groups_b = [prompt_text(FRONT_PREFIX, 8100 + g)
                for g in range(FRONT_GROUPS)]
    trace = front_payloads(groups_a, 0, 16, FLEET_NEW, 8200)
    kill_load = front_payloads(groups_b, 0, 8, FLEET_NEW, 8300)
    stop_load = front_payloads(groups_b, 8, 4, FLEET_NEW, 8400)
    counts = {}
    with tempfile.TemporaryDirectory(dir="build") as root:
        procs = ReplicaProcs(root, [
            "--device", "cuda", "--model", "llama2-7b", "--layers",
            str(FLEET_LAYERS), "--seed", FLEET_SEED, "--serving",
            json.dumps(FLEET_SERVING)])
        try:
            t0 = time.perf_counter()
            for name in ("A", "B", "R"):  # R: the one-replica reference
                procs.spawn(name)
            procs.wait_ready("A", "B", "R")
            stats["boot_s"] = time.perf_counter() - t0
            stats["device_mib"] = procs.memory_mib()
            log(f"fleet: 3 replica processes up in {stats['boot_s']:.1f} s, "
                f"device MiB (nvidia-smi) {stats['device_mib']}")
            server, httpd, thread, port = fleet_front(
                [procs.addr("A"), procs.addr("B")])
            try:
                router = server.engine
                # (a)
                status, health = get_json(port, "/healthz")
                check(status == 200 and health["replicas_up"] == 2
                      and health["state"] == "running",
                      f"(a) /healthz {status} {health}")
                # (b): group g warm on replica g % 2 only
                for g, p in enumerate(groups_a):
                    warm_remote(procs.ports["AB"[g % 2]], [p])
                time.sleep(FLEET_REMOTE["remote_digest_interval_s"] + 0.1)
                router.health()  # the probes refresh the digests
                tok = ByteTokenizer()
                peeks = [[r.prefix_peek(tok.tokenize(p + "x"))
                          for r in router.engines] for p in groups_a]
                check(all(pk[g % 2] == FRONT_PREFIX and pk[1 - g % 2] == 0
                          for g, pk in enumerate(peeks)),
                      f"(b) digest peeks {peeks}")
                before = replica_snaps(router)
                t1 = time.perf_counter()
                threads, trace_out, errors = fleet_traffic(
                    port, trace, streams=set(range(8, 16)))
                join_traffic(threads, errors)
                wall = time.perf_counter() - t1
                after = replica_snaps(router)
                hits = [a["prefix_hits"] - b["prefix_hits"]
                        for a, b in zip(after, before)]
                saved = [a["prefill_tokens_saved"] - b["prefill_tokens_saved"]
                         for a, b in zip(after, before)]
                check(hits == [8, 8] and saved == [8 * FRONT_PREFIX] * 2,
                      f"(b) per-replica prefix hits {hits}, tokens saved "
                      f"{saved}: the digest did not steer every request to "
                      "its prefix's replica")
                stats["trace"] = dict(
                    requests=len(trace), streams=8, wall_s=wall,
                    prefix_hits=hits, tokens_saved=saved,
                    tokens_per_s=sum(map(len, trace_out)) / wall)
                log("fleet (b): " + json.dumps(stats["trace"]))
                stats["bench_fleet"] = fleet_bench(port, root, "fleet")
                log("fleet serving_bench, two replica processes: "
                    + json.dumps(stats["bench_fleet"]))
                # (c)-(d): every prefix warm on both, so a failed-over
                # request is a hit on a prefix prefilled alone
                for name in ("A", "B"):
                    warm_remote(procs.ports[name], groups_b)
                stats["sigkill"], kill_out = fleet_fault(
                    server, port, procs, kill_load, "sigkill")
                warm_remote(procs.ports[stats["sigkill"]["victim"]],
                            groups_b)
                stats["sigkill"]["readmit_s"] = wait_fleet_up(server)
                log("fleet (c) sigkill: " + json.dumps(stats["sigkill"]))
                stats["sigstop"], stop_out = fleet_fault(
                    server, port, procs, stop_load, "sigstop")
                stats["sigstop"]["readmit_s"] = wait_fleet_up(server)
                log("fleet (d) sigstop: " + json.dumps(stats["sigstop"]))
                for rep in router.engines:
                    wait_quiet_remote(rep)
                status, inv = get_json(port, "/invariants?strict=1")
                check(status == 200 and inv["ok"] and inv["engines"] == 2
                      and "unreachable" not in inv, f"(e) {inv}")
                stats["invariants"] = dict(ok=True, engines=2,
                                           laws=len(inv["laws_checked"]))
                stats["fleet_counters"] = {
                    k: router.aggregate_snapshot()[k] for k in (
                        "router_failovers", "router_retries",
                        "router_remote_timeouts", "router_remote_retries",
                        "router_probe_failures")}
            finally:
                stop_tool(httpd, thread)
                server.close()
            for name in ("A", "B"):
                counts[name] = procs.stop(name)
            # the reference: one replica process with the same config
            server, httpd, thread, port = fleet_front([procs.addr("R")])
            try:
                warm_remote(procs.ports["R"], groups_a)
                threads, ref_trace, errors = fleet_traffic(port, trace)
                join_traffic(threads, errors)
                warm_remote(procs.ports["R"], groups_b)
                threads, ref_cd, errors = fleet_traffic(
                    port, kill_load + stop_load)
                join_traffic(threads, errors)
                stats["bench_one"] = fleet_bench(port, root, "one")
                log("fleet serving_bench, one replica process: "
                    + json.dumps(stats["bench_one"]))
            finally:
                stop_tool(httpd, thread)
                server.close()
            counts["R"] = procs.stop("R")
        except Exception:
            log(procs.tail())
            raise
        finally:
            procs.close()
        check(all(p.poll() is not None for p in procs.procs.values()),
              "a replica process outlived phase 15")
        check(trace_out == ref_trace, "(b): a fleet completion differs from "
              "one replica process's")
        check(kill_out + stop_out == ref_cd, "(c)-(d): a failed-over "
              "completion differs from one replica process's")
        stats["replica_launches"] = counts
        stats["replica_peak_reserved_gib"] = {
            name: c.pop("peak_reserved_bytes") / 2 ** 30
            for name, c in counts.items()}
        log("fleet: each surviving replica's launches "
            + json.dumps(counts) + " and peak reserved GiB "
            + json.dumps(stats["replica_peak_reserved_gib"]))
        check(all(c["flash_fwd_cuda"] > 0 and c["block_attention_cuda"] > 0
                  for c in counts.values()),
              f"a surviving replica launched no flash or block kernel: "
              f"{counts}")
        fl, one = stats["bench_fleet"], stats["bench_one"]
        stats["fleet_over_one"] = fl["tokens_per_s"] / one["tokens_per_s"]
        log(f"fleet: two processes {fl['tokens_per_s']} tokens/s against "
            f"one {one['tokens_per_s']} ({stats['fleet_over_one']:.2f}x), "
            f"{smi}")
        t0 = time.perf_counter()
        stats["slice"] = check_fleet_slice(root)
        stats["slice"]["seconds"] = time.perf_counter() - t0
        log(f"fleet slice (fp32, 2 layers, {smi}): "
            + json.dumps(stats["slice"]))
    stats["launches"] = dict(
        flash_fwd=sum(c["flash_fwd_cuda"] for c in counts.values()),
        block_attn=sum(c["block_attention_cuda"] for c in counts.values()))
    stats["norm_launches"] = {
        k: sum(c[k] for c in counts.values())
        for k in counts["R"] if k.startswith(("rms_", "ln_"))}
    stats["seconds"] = time.perf_counter() - t_phase
    return stats


def wait_quiet_remote(rep, timeout: float = 120.0) -> None:
    """Until a replica's health shows no active slot, prefill or queue."""
    give_up = time.monotonic() + timeout
    while True:
        h = rep.health()
        if not (h["active_slots"] or h["prefilling"] or h["queue_depth"]):
            return
        check(time.monotonic() < give_up, f"replica {rep.addr} stayed busy")
        time.sleep(0.1)



# Phase 16: the Mixture-of-Experts layer at Mixtral-8x7B's widths (h 4096,
# 32/8 heads of 128, 8 experts of ffn 14336, top-2, vocab 32000, the
# preset's dropless capacity E / K), random weights from seeds. Depth is
# cut for memory, never width: 32 layers in bf16 take 93.4 GB, over the
# card's 80 GB, and the reference keeps the expert banks out of its int8
# weights, so int8 cannot close the gap. Serving runs MOE_LAYERS of 32
# (11.9 B parameters, 23.7 GB), training MOE_TRAIN_LAYERS (1.71 B
# parameters at 16 B each of fp32 state: 27.4 GB; two layers take 50.6 GB
# and peak at 54 GiB, which leaves the other lane of the smoke too little
# of the card), the toolchain MOE_TOOL_LAYERS.
MOE_LAYERS = 8
MOE_TRAIN_LAYERS = 1
MOE_TOOL_LAYERS = 1
MOE_SEED = 0
MOE_SERIAL_PROMPT = 512
MOE_SERIAL_NEW = 64
# ENGINE_SERVING with each request prefilled alone: a bf16 request's
# tokens do not depend on its neighbours
MOE_SERVING = dict(ENGINE_SERVING, prefill_max_batch=1)
MOE_REQUESTS = 16
MOE_INT8_REQUESTS = 2
# the greedy requests of (b) sent again alone
MOE_ALONE_REQUESTS = 4
# the int8 bank GEMM against the bf16 bmm, relative rms: per-row and
# per-column int8 rounding of Gaussian operands at K 4096 gives 1.2-1.3%
# (amax ~3.5 sigma over 127 steps, on each operand); a wrong scale or
# column gives tens of percent
MOE_BANK_TOL = 0.02
# the fp32 slice: sort against dense dispatch, logits and grads, relative
# to the largest magnitude (the same fp32 values, summed in another order)
MOE_SLICE_TOL = 1e-5
# 8 rows of 32 tokens: capacity is per row, C = ceil(2 * 32 * 1.25 / 8) = 10
# against 8 choices an expert on average, so rows drop at 1.25 (at 256
# tokens a row, a layer of independently routed tokens drops nothing 92%
# of the time)
MOE_SLICE_BATCH = (8, 32)
MOE_DROP_CAPACITY = 1.25
MOE_TRAIN_LR = 3e-5
# free card memory the phase waits for: its largest part, training, peaks
# at ~31 GiB (54 GiB at two layers)
MOE_FREE_BYTES = 40 * 2 ** 30
MOE_TOOL_NEW = 8
# the H100's HBM rate, for the decode step's weight-read bound
HBM_BYTES_PER_S = 3.35e12


def diff_summary(diffs: list) -> dict:
    """Max, median and 90th percentile of per-token |logprob| differences,
    the count over W8_LOGPROB_TOL and the first token over it."""
    d = sorted(diffs)
    return dict(n=len(d), max=d[-1], p50=d[len(d) // 2],
                p90=d[(9 * len(d)) // 10],
                over_tol=sum(x > W8_LOGPROB_TOL for x in diffs),
                first_over=next((i for i, x in enumerate(diffs)
                                 if x > W8_LOGPROB_TOL), None))


def moe_config(layers: int, **kw):
    from megatron_tpu_torch.config import mixtral_config
    cfg = mixtral_config("8x7b", num_layers=layers, **kw)
    check(cfg.hidden_size == 4096 and cfg.num_attention_heads == 32
          and cfg.num_kv_heads == 8 and cfg.kv_channels == 128
          and cfg.num_experts == 8 and cfg.ffn_hidden_size == 14336
          and cfg.moe_top_k == 2 and cfg.vocab_size == 32000
          and cfg.attention_impl == "flash",
          "mixtral_config('8x7b') is not Mixtral-8x7B's width")
    return cfg


def moe_requests() -> list:
    """(b)'s 16 requests: ENGINE_PROMPTS twice, 24-64 new tokens, even ones
    greedy, odd ones seeded at temperature 0.8, top_p 0.9."""
    out = []
    for i in range(MOE_REQUESTS):
        n = ENGINE_PROMPTS[i % len(ENGINE_PROMPTS)]
        payload = {"prompts": [prompt_text(n, 1600 + i)],
                   "tokens_to_generate": 24 + (40 * i) // (MOE_REQUESTS - 1),
                   "logprobs": True}
        if i % 2:
            payload.update(temperature=0.8, top_p=0.9, random_seed=1600 + i)
        else:
            payload.update(temperature=0.0)
        out.append(payload)
    return out


class RouteTap:
    """While installed (a context manager), records the top-k expert ids of
    every `models.moe.route` call, each call's [b, s, K] sorted along K, on
    the host."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from megatron_tpu_torch.models import moe
        self._route = moe.route

        def tap(*a, **kw):
            out = self._route(*a, **kw)
            self.calls.append(out[2].sort(-1).values.cpu())
            return out
        moe.route = tap
        return self

    def __exit__(self, *exc):
        from megatron_tpu_torch.models import moe
        moe.route = self._route

    def per_layer(self, layers: int) -> list:
        """Each layer's choices over its calls' positions: [b, s, K]."""
        import torch
        return [torch.cat(self.calls[i::layers], dim=1)
                for i in range(layers)]


def routing_flips(a: list, b: list, positions: int) -> set:
    """Row 0's positions below `positions` where some layer's set of top-k
    experts differs between the per-layer choices `a` and `b`."""
    flips = set()
    for x, y in zip(a, b):
        differ = (x[0, :positions] != y[0, :positions]).any(-1)
        flips.update(differ.nonzero().flatten().tolist())
    return flips


def moe_serial(gen, tok, cfg, smi) -> dict:
    """(a) the serial /api route: a 512-token greedy prompt with 64 new
    tokens, 3 sampled prompts in one payload, and `Generator.score` of the
    greedy stream (a full-sequence forward against prefill + decode). In
    bf16 a router's top-2 choice near a tie can flip between the two paths
    (RouteTap), and a flipped expert moves that position's logits by whole
    nats; at every position where no layer's choice flipped, the score's
    logprob must agree with the route's within W8_LOGPROB_TOL."""
    import torch
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.generation import SamplingParams
    from megatron_tpu_torch.inference.server import MegatronServer
    L = cfg.num_layers
    server = MegatronServer(gen, tok,
                            serving=ServingConfig(serial_fallback=True))
    httpd, thread = serve_http(server)
    port = httpd.server_address[1]
    req_a = {"prompts": [prompt_text(MOE_SERIAL_PROMPT, 1)],
             "tokens_to_generate": MOE_SERIAL_NEW, "temperature": 0.0,
             "logprobs": True}
    # the serial route feeds a batch's longer prompts one token a step
    # past its shortest: short prompts keep (b) to a few seconds
    req_b = {"prompts": [prompt_text(37, 2), prompt_text(64, 3),
                         prompt_text(100, 4)],
             "tokens_to_generate": 32, "temperature": 0.8, "top_k": 40,
             "top_p": 0.9, "random_seed": 7, "logprobs": True}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        bodies = {}
        with RouteTap() as routes_a:
            bodies["a"] = put(port, req_a)
        bodies["b"] = put(port, req_b)
        for name in "ab":
            status, body = bodies[name]
            check(status == 200, f"moe serial ({name}): {status} {body}")
            bodies[name] = body
        counts = read_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    check(counts["flash_fwd_cuda"] == 2 * L
          and counts["block_attention_cuda"] == 0,
          f"moe serial: launches {counts}, expected one flash prefill a "
          f"layer for each payload ({2 * L}) and no block kernel")
    n = len(tok.tokenize(req_a["prompts"][0]))
    seg_a, lps_a = bodies["a"]["segments"][0], bodies["a"]["logprobs"][0]
    check(len(seg_a) == n + MOE_SERIAL_NEW or seg_a[-1] == tok.eod,
          f"moe serial (a): {len(seg_a)} tokens")
    for seg, lps, p in zip(bodies["b"]["segments"], bodies["b"]["logprobs"],
                           req_b["prompts"]):
        m = len(tok.tokenize(p))
        check(m < len(seg) <= m + 32 and all(0 <= t < cfg.vocab_size
                                             for t in seg),
              f"moe serial (b): {len(seg)} tokens for a {m}-token prompt")
        check(all(math.isfinite(x) for x in lps[m:]),
              "moe serial (b): non-finite logprob")
    zero_counts()
    with RouteTap() as routes_s:
        scored = gen.score([seg_a])[0]
    score_counts = read_counts()
    flips = routing_flips(routes_a.per_layer(L), routes_s.per_layer(L),
                          len(seg_a) - 1)
    # the logprob of token p is read off position p - 1
    held = [abs(float(scored[p - 1]) - lps_a[p])
            for p in range(n, len(seg_a)) if p - 1 not in flips]
    moved = [abs(float(scored[p - 1]) - lps_a[p])
             for p in range(n, len(seg_a)) if p - 1 in flips]
    score_diffs = dict(
        positions=len(seg_a) - 1, layers=L,
        positions_with_a_flip=len(flips),
        generated_unflipped=diff_summary(held) if held else None,
        generated_flipped=diff_summary(moved) if moved else None)
    log("moe serial: score against the route: " + json.dumps(score_diffs))
    check(len(held) >= len(moved) and max(held) <= W8_LOGPROB_TOL,
          f"moe serial: score's logprobs of the greedy stream against the "
          f"route's: {score_diffs}")
    peak = torch.cuda.max_memory_allocated()

    ids = seg_a[:n]
    greedy = SamplingParams(temperature=0.0)

    def timed(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen.generate([ids], k, sampling=greedy)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    prefill_s = min(timed(1) for _ in range(2))
    full_s = timed(MOE_SERIAL_NEW + 1)
    decode_ms = (full_s - prefill_s) / MOE_SERIAL_NEW * 1e3
    return dict(prefill_tokens=n, prefill_ms=prefill_s * 1e3,
                decode_ms_per_token=decode_ms,
                decode_tokens_per_s=1e3 / decode_ms,
                peak_memory_gib=peak / 2 ** 30,
                score_logprob_diffs=score_diffs,
                launches=dict(flash_fwd=counts["flash_fwd_cuda"],
                              block_attn=counts["block_attention_cuda"],
                              score_flash_fwd=score_counts["flash_fwd_cuda"]),
                counts=counts, score_counts=score_counts, card=smi)


def moe_engine_burst(gen, tok, cfg, smi) -> dict:
    """(b) the engine route on HTTP (MOE_SERVING): 16 concurrent requests,
    launch counts zeroed just before; every request 200 with finite
    logprobs, the block kernel once per layer per decode step, the flash
    forward once per layer per prefill. Each greedy request is then sent
    again alone: its completion must equal the burst's bit for bit (a
    row's routing, capacity and grid row do not depend on its neighbours).
    Against the serial route a bf16 stream parts wherever a router's
    top-2 choice flips between the block kernel's and the dot path's
    rounding (see (a)); the exactness against the serial route is the fp32
    slice's."""
    import torch
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    L = cfg.num_layers
    server = MegatronServer(gen, tok, serving=ServingConfig(**MOE_SERVING))
    engine = server.engine
    httpd, thread = serve_http(server)
    port = httpd.server_address[1]
    requests = moe_requests()
    try:
        status, _ = put(port, {"prompts": ["warm up"],
                               "tokens_to_generate": 4, "temperature": 0.0})
        check(status == 200, f"moe engine warm-up: {status}")
        engine.metrics = ServingMetrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        bodies = [None] * MOE_REQUESTS

        def send(i):
            bodies[i] = put(port, requests[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(MOE_REQUESTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        settled = None
        while True:
            snap = engine.metrics.snapshot()
            now = (snap["decode_steps"], snap["prefill_calls"],
                   read_counts())
            if now == settled:
                break
            settled = now
            time.sleep(0.3)
        steps, prefills, counts = settled
        peak = torch.cuda.max_memory_allocated()
        generated = 0
        for i, answer in enumerate(bodies):
            check(answer is not None and answer[0] == 200,
                  f"moe engine request {i}: {answer}")
            seg, lps = answer[1]["segments"][0], answer[1]["logprobs"][0]
            n = len(tok.tokenize(requests[i]["prompts"][0]))
            new = requests[i]["tokens_to_generate"]
            check(n < len(seg) <= n + new
                  and (len(seg) == n + new or seg[-1] == tok.eod),
                  f"moe engine request {i}: {len(seg)} tokens")
            check(all(math.isfinite(x) for x in lps[n:]),
                  f"moe engine request {i}: non-finite logprob")
            generated += len(seg) - n
        check(steps > 0 and counts["block_attention_cuda"] == L * steps,
              f"moe engine: block kernel {counts} in {steps} decode steps "
              f"of {L} layers")
        check(prefills == MOE_REQUESTS
              and counts["flash_fwd_cuda"] == L * prefills,
              f"moe engine: flash forward {counts} in {prefills} prefills "
              f"of {L} layers")
        greedy = [i for i in range(MOE_REQUESTS)
                  if i % 2 == 0][:MOE_ALONE_REQUESTS]
        t0 = time.perf_counter()
        for i in greedy:
            status, body = put(port, requests[i])
            check(status == 200, f"moe replay {i}: {status}")
            check(body["segments"] == bodies[i][1]["segments"],
                  f"moe engine request {i}: alone it gives other tokens "
                  "than in the burst")
        alone_s = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        server.close()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in gen.params.parameters())
    return dict(
        requests=MOE_REQUESTS, generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall, ttft_p50_ms=snap["ttft_p50_ms"],
        ttft_p99_ms=snap["ttft_p99_ms"], itl_p50_ms=snap["itl_p50_ms"],
        itl_p99_ms=snap["itl_p99_ms"], decode_steps=steps,
        prefill_calls=prefills, peak_memory_gib=peak / 2 ** 30,
        weight_gb=weight_bytes / 1e9,
        decode_step_weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        launches=dict(flash_fwd=counts["flash_fwd_cuda"],
                      block_attn=counts["block_attention_cuda"]),
        counts=counts, greedy_equal_alone=f"{len(greedy)}/{len(greedy)}",
        alone_replay_s=alone_s, card=smi), requests, bodies


def moe_int8(model, gen, cfg, requests, smi) -> dict:
    """(c) `quantize_weights` on the served weights (the banks stay the same
    tensors) and an engine with W8 attention and an int8 block pool: every
    request finite, the block kernel on the int8 arena once per layer per
    decode step. Its greedy streams are fed through the bf16 serial route
    and through the W8 + int8-KV serial route, and the logprobs compared
    (reported, split by whether some layer's top-2 choice flipped at the
    position, RouteTap): W8's activations move the router's choices at
    many positions, each flip by whole nats, so no tolerance holds across
    them in bf16; the PR 4 rule is the fp32 slice's. `int8_expert_matmul`
    against the bf16 bmm at layer 0's bank, decode (8 rows an expert) and
    prefill (1,000 rows) shapes."""
    import torch
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.ops.quantized import (W8, _int_mm_padded,
                                                  _quantize_bank,
                                                  int8_expert_matmul,
                                                  quantize_rows,
                                                  quantize_weights)
    from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
    L = cfg.num_layers
    tree = quantize_weights(model)
    bank = tree["transformer"]["mlp"]
    check(all(bank[k] is model.transformer["mlp"][k]
              for k in ("router", "w1", "w2")),
          "quantize_weights did not leave the expert banks as they were")
    check(isinstance(tree["transformer"]["attention"]["wq"], W8),
          "quantize_weights did not quantize the attention")
    gen8 = Generator(tree, cfg, eos_id=gen.eos_id, pad_id=gen.pad_id)
    greedy = [r for r in requests if r["temperature"] == 0.0]
    greedy = greedy[:MOE_INT8_REQUESTS]
    tok = ByteTokenizer()
    prompts = [tok.tokenize(r["prompts"][0]) for r in greedy]
    engine = ServingEngine(gen8, ServingConfig(**dict(MOE_SERVING,
                                                      kv_dtype="int8")))
    try:
        zero_counts()
        reqs = [engine.submit(p, r["tokens_to_generate"],
                              SamplingOptions(temperature=0.0))
                for p, r in zip(prompts, greedy)]
        results = [r.result(timeout=600) for r in reqs]
        snap = settle(engine)
        counts = read_counts()
    finally:
        engine.close()
    check(counts["block_attention_cuda"] == L * snap["decode_steps"]
          and counts["flash_fwd_cuda"] == 0,
          f"int8 moe engine: launches {counts} in {snap['decode_steps']} "
          "decode steps (an int8 cache prefills on the dot path)")
    serial8 = Generator(tree, cfg, eos_id=gen.eos_id, pad_id=gen.pad_id,
                        kv_cache_dtype=torch.int8)
    held, moved, engine_vs_w8, flipped = [], [], [], []
    for p, (seg, lps) in zip(prompts, results):
        n = len(p)  # the engine's logprobs are the generated tokens'
        check(len(lps) == len(seg) - n and all(math.isfinite(x)
                                               for x in lps),
              "int8 moe engine: non-finite logprob")
        with RouteTap() as rb:
            fb = teacher_forced_logprobs(gen, [seg], [n], len(seg) - n)[0]
        with RouteTap() as r8:
            f8 = teacher_forced_logprobs(serial8, [seg], [n],
                                         len(seg) - n)[0]
        flips = routing_flips(rb.per_layer(L), r8.per_layer(L),
                              len(seg) - 1)
        flipped.append(len(flips))
        for j, (a, b) in enumerate(zip(fb, f8)):
            (moved if n + j - 1 in flips else held).append(abs(a - b))
        engine_vs_w8 += [abs(a - b) for a, b in zip(lps, f8)]
    diffs = dict(
        w8_vs_bf16_unflipped=diff_summary(held) if held else None,
        w8_vs_bf16_flipped=diff_summary(moved) if moved else None,
        engine_vs_w8_route=diff_summary(engine_vs_w8),
        positions_with_a_flip=flipped)
    log("int8 moe: logprobs of the engine's streams: " + json.dumps(diffs))
    del engine, gen8, serial8, tree, bank
    torch.cuda.empty_cache()

    # the bank GEMM: layer 0's w1 (gate and up), [E, h, 2 ffn]
    w = model.transformer["mlp"]["w1"][0].reshape(cfg.num_experts,
                                                  cfg.hidden_size, -1)
    gen_x = torch.Generator("cuda").manual_seed(9)
    banks = []
    for name, rows in (("decode", 8), ("prefill", 1000)):
        x = torch.randn(cfg.num_experts, rows, cfg.hidden_size,
                        generator=gen_x, device="cuda",
                        dtype=torch.bfloat16)
        with torch.inference_mode():
            got = int8_expert_matmul(x, w).float()
            want = torch.bmm(x, w).float()
            rel = ((got - want).square().mean().sqrt()
                   / want.square().mean().sqrt()).item()
            # the int32 product of the quantized values is exact
            xi, _ = quantize_rows(x)
            wi, _ = _quantize_bank(w)
            exact = all(torch.equal(
                _int_mm_padded(xi[e], wi[e]),
                (xi[e].double() @ wi[e].double()).to(torch.int32))
                for e in range(cfg.num_experts))
        del xi, wi
        check(rel <= MOE_BANK_TOL and exact,
              f"int8_expert_matmul at {name} ({rows} rows an expert): rel "
              f"rms {rel} (tol {MOE_BANK_TOL}), int32 product exact "
              f"{exact}")
        banks.append(dict(shape=name, rows_per_expert=rows, rel_rms=rel,
                          int32_exact=exact))
    torch.cuda.empty_cache()
    return dict(requests=len(greedy), decode_steps=snap["decode_steps"],
                logprob_diffs=diffs, tol=W8_LOGPROB_TOL,
                launches=dict(flash_fwd=counts["flash_fwd_cuda"],
                              block_attn=counts["block_attention_cuda"]),
                counts=counts, bank_gemm=banks, bank_tol=MOE_BANK_TOL,
                card=smi)


def moe_slice() -> dict:
    """(d) a 2-layer slice at full width in fp32 (TF32 off): sort against
    dense dispatch, logits and grads (MOE_SLICE_TOL), dropless and at
    capacity MOE_DROP_CAPACITY (its drops counted); with the dropless
    capacity the engine (batched prefill allowed) equal to the serial route
    token for token; and the W8 + int8-KV engine's logprobs within
    W8_LOGPROB_TOL of its tokens fed through its serial route (the PR 4
    rule, where fp32 activations leave the routing unflipped)."""
    import gc

    import torch
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.models import moe
    from megatron_tpu_torch.models.language_model import (LanguageModel,
                                                          loss_fn,
                                                          model_forward)
    from megatron_tpu_torch.ops.quantized import quantize_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = moe_config(2, compute_dtype="float32")
    model = LanguageModel(cfg, dtype=torch.float32, seed=1)
    b, s = MOE_SLICE_BATCH
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    drops = []
    sort_route = moe._sort_route

    def counting(*a, **kw):
        out = sort_route(*a, **kw)
        drops.append(int((~out[4]).sum()))
        return out

    out = {}
    for cap in (cfg.moe_capacity_factor, MOE_DROP_CAPACITY):
        logits = {}
        moe._sort_route = counting
        try:
            for mode in ("sort", "dense"):
                c = dataclasses.replace(cfg, moe_dispatch=mode,
                                        moe_capacity_factor=cap)
                with torch.inference_mode():
                    logits[mode], _ = model_forward(model, toks[:, :-1], c)
        finally:
            moe._sort_route = sort_route
        err = ((logits["sort"] - logits["dense"]).abs().max()
               / logits["dense"].abs().max()).item()
        check(err <= MOE_SLICE_TOL, f"fp32 moe slice, capacity {cap}: "
              f"sort and dense logits differ by {err} of the largest")
        out[f"capacity_{cap}"] = dict(logits_rel_err=err,
                                      dropped_choices=drops[-2:])
        drops.clear()
    dropped = out[f"capacity_{MOE_DROP_CAPACITY}"]["dropped_choices"]
    check(out[f"capacity_{cfg.moe_capacity_factor}"]["dropped_choices"]
          == [0, 0] and sum(dropped) > 0,
          f"fp32 moe slice: drops {out}")

    # grads: sort against dense, at capacity MOE_DROP_CAPACITY
    model.requires_grad_(True)
    grads = {}
    for mode in ("sort", "dense"):
        model.zero_grad(set_to_none=True)  # the sort grads are kept
        c = dataclasses.replace(cfg, moe_dispatch=mode,
                                moe_capacity_factor=MOE_DROP_CAPACITY)
        loss = loss_fn(model, toks, c)
        loss.backward()
        grads[mode] = (loss.item(), {k: p.grad for k, p in
                                     model.named_parameters()})
    (l_s, g_s), (l_d, g_d) = grads["sort"], grads["dense"]
    grad_err = max(((g_s[k] - g_d[k]).abs().max()
                    / g_d[k].abs().max()).item() for k in g_d)
    loss_err = abs(l_s - l_d) / abs(l_d)
    check(grad_err <= MOE_SLICE_TOL and loss_err <= MOE_SLICE_TOL,
          f"fp32 moe slice: sort vs dense loss {loss_err}, grads "
          f"{grad_err} of the leaf's largest")
    out.update(grad_rel_err=grad_err, loss_rel_err=loss_err)
    del grads, g_s, g_d
    model.requires_grad_(False)
    for p in model.parameters():
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()

    # the engine, batched prefill allowed, against the serial route
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod,
                    kv_cache_dtype=torch.float32)
    payload = {"prompts": [prompt_text(n, 60 + i) for i, n in
                           enumerate((37, 100, 300, 515))],
               "tokens_to_generate": 24, "temperature": 0.0}
    server = MegatronServer(gen, tok, serving=ServingConfig(**ENGINE_SERVING))
    try:
        status, body = server.handle(payload)
        check(status == 200, f"fp32 moe slice engine: {status} {body}")
        status, serial = server.handle(dict(payload, serial=True))
        check(status == 200, f"fp32 moe slice serial: {status} {serial}")
    finally:
        server.close()
    check(body["segments"] == serial["segments"],
          "fp32 moe slice: the engine's greedy tokens differ from the "
          "serial route's")
    # the W8 + int8-KV engine (the banks stay fp32): its logprobs against
    # its tokens fed through its own serial route (the PR 4 rule)
    gen8 = Generator(quantize_weights(model), cfg, eos_id=tok.eod,
                     pad_id=tok.eod, kv_cache_dtype=torch.int8)
    server = MegatronServer(gen8, tok, serving=ServingConfig(**INT8_SERVING))
    try:
        status, eng8 = server.handle(dict(payload, logprobs=True))
        check(status == 200, f"fp32 moe slice W8 engine: {status} {eng8}")
    finally:
        server.close()
    n_prompt = [len(tok.tokenize(t)) for t in payload["prompts"]]
    w8_diff = w8_logprob_diff(eng8, teacher_forced_logprobs(
        gen8, eng8["segments"], n_prompt, payload["tokens_to_generate"]),
        n_prompt)
    check(w8_diff <= W8_LOGPROB_TOL,
          f"fp32 moe slice: the W8 engine's logprobs differ from its tokens "
          f"fed through the serial route by {w8_diff}")
    out.update(w8_engine_logprob_diff=w8_diff, w8_tol=W8_LOGPROB_TOL)
    del gen8
    out.update(engine_equal_to_serial=True, tol=MOE_SLICE_TOL,
               batch=MOE_SLICE_BATCH, allow_tf32=False)
    del server, gen, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_training(smi) -> dict:
    """(e) `make_train_step` at Mixtral's width and MOE_TRAIN_LAYERS layers,
    seq 4096, batch 1, bf16 compute, fp32 Adam, 3 steps on one batch:
    finite losses with the router's loss in them (each layer's aux read off
    its moe_apply), every flash kernel launched layers times a step."""
    import gc

    import torch
    from megatron_tpu_torch.config import (MegatronConfig, OptimizerConfig,
                                           TrainingConfig)
    from megatron_tpu_torch.models import transformer as tfm
    from megatron_tpu_torch.training import init_train_state, make_train_step
    mcfg = moe_config(MOE_TRAIN_LAYERS)
    check(mcfg.seq_length == 4096 and mcfg.params_dtype == "float32"
          and mcfg.compute_dtype == "bfloat16", "mixtral training config")
    cfg = MegatronConfig(
        model=mcfg, optimizer=OptimizerConfig(lr=MOE_TRAIN_LR, clip_grad=1.0),
        training=TrainingConfig(micro_batch_size=1, global_batch_size=1))
    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB allocated before moe "
          "training")
    t0 = time.perf_counter()
    state = init_train_state(cfg, seed=MOE_SEED)
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.parameters())
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    build_s = time.perf_counter() - t0
    s = mcfg.seq_length
    tokens = torch.randint(0, mcfg.vocab_size, (1, 1, s + 1), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
    auxes = []
    moe_apply = tfm.moe_apply

    def recording(*a, **kw):
        y, aux = moe_apply(*a, **kw)
        auxes.append(aux.detach())
        return y, aux

    tfm.moe_apply = recording
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    steps = []
    try:
        for i in range(3):
            before = read_counts()
            auxes.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, {"tokens": tokens})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            after = read_counts()
            steps.append(dict(
                step=i + 1, seconds=secs, lm_loss=float(m["lm_loss"]),
                aux_by_layer=[float(a) for a in auxes],
                grad_norm=float(m["grad_norm"]),
                found_inf=int(m["found_inf"]),
                launches={k: after[k] - before[k] for k in after
                          if after[k] != before[k]}))
            log("moe training step: " + json.dumps(steps[-1]))
    finally:
        tfm.moe_apply = moe_apply
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    L = MOE_TRAIN_LAYERS
    for rec in steps:
        check(all(rec["launches"].get(k) == L for k in (
            "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda")),
              f"moe training step {rec['step']}: launches {rec['launches']}")
        check(math.isfinite(rec["lm_loss"]) and rec["found_inf"] == 0
              and math.isfinite(rec["grad_norm"])
              and len(rec["aux_by_layer"]) == L
              and all(0.0 < a <= mcfg.num_experts
                      for a in rec["aux_by_layer"]),
              f"moe training step {rec['step']}: {rec}")
    check(abs(steps[0]["lm_loss"] - math.log(mcfg.vocab_size)) < 1.0,
          f"first moe loss {steps[0]['lm_loss']} is not near ln(32000)")
    step_s = sorted(r["seconds"] for r in steps[1:])[0]
    return dict(layers=L, seq_length=s, parameters=n_params,
                state_gib=state_gib, build_s=build_s,
                losses=[r["lm_loss"] for r in steps],
                aux_by_layer=[r["aux_by_layer"] for r in steps],
                aux_loss_coeff=mcfg.moe_aux_loss_coeff,
                step_seconds=[r["seconds"] for r in steps],
                step_ms_best_of_last2=step_s * 1e3,
                tokens_per_s=s / step_s, peak_memory_gib=peak / 2 ** 30,
                launches=dict(flash_fwd=counts["flash_fwd_cuda"],
                              flash_bwd_dq=counts["flash_bwd_dq_cuda"],
                              flash_bwd_dkv=counts["flash_bwd_dkv_cuda"]),
                counts=counts, card=smi)


def moe_toolchain(root: str, smi) -> dict:
    """(f) an HF-format Mixtral directory at full width and MOE_TOOL_LAYERS
    layers (bf16 safetensors, two shards and their index, numpy values from
    a seed), imported by tools/convert_hf_checkpoint --family mixtral into
    a fp32 release checkpoint, exported back (every tensor the input's,
    upcast, bit for bit) and served (MOE_TOOL_NEW greedy tokens through the
    serial route)."""
    import gc
    import os

    import torch
    from megatron_tpu_torch.convert import hf_io
    from megatron_tpu_torch.inference.generation import (Generator,
                                                         SamplingParams)
    from megatron_tpu_torch.verify_correctness import \
        synthetic_hf_mixtral_names
    cfg = moe_config(MOE_TOOL_LAYERS)
    names = synthetic_hf_mixtral_names(
        vocab=cfg.vocab_size, hidden=cfg.hidden_size, layers=cfg.num_layers,
        heads=cfg.num_attention_heads, kv=cfg.num_kv_heads,
        ffn=cfg.ffn_hidden_size, experts=cfg.num_experts)
    hf_dir = os.path.join(root, "mixtral_hf")
    written = write_hf_dir(hf_dir, names, hf_io.hf_config_dict(
        cfg, "mixtral"), MOE_SEED)
    from megatron_tpu_torch.tools import convert_hf_checkpoint as tool
    from megatron_tpu_torch.training import checkpointing as ckpt
    t0 = time.perf_counter()
    out = os.path.join(root, "mixtral_ckpt")
    _, model = tool.do_import(tool.parse_args(
        ["import", "--hf_path", hf_dir, "--out", out, "--family",
         "mixtral"]), cfg)
    stats = dict(tool.last_import, save=dict(ckpt.last_save))
    stats.pop("dir")
    # the round trip: every exported tensor is the input's, upcast, bit
    # for bit (a re-import would read the same values again)
    tool.do_export(tool.parse_args(["export", "--load", out, "--hf_out",
                                    out + "_hf", "--family", "mixtral"]))
    stats["export"] = dict(tool.last_export)
    t1 = time.perf_counter()
    stats["export"]["tensors_equal"] = check_export(hf_dir, out + "_hf",
                                                    "mixtral")
    stats["export"]["check_s"] = time.perf_counter() - t1
    stats.update(seconds=time.perf_counter() - t0, hf_write=written)
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=-1, pad_id=tok.eod)
    zero_counts()
    toks, lens, lps = gen.generate([tok.tokenize(TOOLCHAIN_PROMPTS[0])],
                                   MOE_TOOL_NEW,
                                   SamplingParams(temperature=0.0))
    counts = read_counts()
    n = len(tok.tokenize(TOOLCHAIN_PROMPTS[0]))
    check(int(lens[0]) == n + MOE_TOOL_NEW
          and all(math.isfinite(float(x)) for x in lps[0, n:lens[0]])
          and counts["flash_fwd_cuda"] == cfg.num_layers,
          f"mixtral import served: {lens}, launches {counts}")
    stats.update(served_tokens=[int(t) for t in toks[0, n:lens[0]]],
                 launches=dict(flash_fwd=counts["flash_fwd_cuda"]),
                 counts=counts, card=smi)
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_moe(smi: str) -> dict:
    """Phase 16: the Mixture-of-Experts layer at Mixtral-8x7B's widths, (a)
    the serial route, (b) the engine, (c) int8 at MOE_LAYERS layers in bf16
    (one model), then (d) the fp32 slice, (e) training and (f) the
    toolchain. Launch counts are zeroed before each drive and read after
    it; their sums are phase 16's."""
    import gc
    import shutil
    import tempfile

    import torch
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel
    gc.collect()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    check(base_gib < 1.0, f"{base_gib:.2f} GiB still allocated before the "
          "moe phase")
    # phase 15's replica processes have exited, and their memory comes
    # back to the card within moments; the other lane's phases hold less
    # than the rest
    deadline = time.monotonic() + LANE_MEMORY_WAIT_S
    while (free := torch.cuda.mem_get_info()[0]) < MOE_FREE_BYTES:
        check(time.monotonic() < deadline, f"the card holds only "
              f"{free / 2 ** 30:.1f} GiB free before the moe phase")
        time.sleep(1.0)
    cfg = moe_config(MOE_LAYERS)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=MOE_SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe: Mixtral-8x7B width, {MOE_LAYERS} of 32 layers, {n_params} "
        f"bf16 parameters ({n_params * 2 / 1e9:.1f} GB), built in "
        f"{time.perf_counter() - t0:.1f} s")
    tok = ByteTokenizer()
    gen = Generator(model, cfg, eos_id=tok.eod, pad_id=tok.eod)
    stats = dict(layers=MOE_LAYERS, parameters=n_params, card=smi)
    t0 = time.perf_counter()
    stats["serial"] = moe_serial(gen, tok, cfg, smi)
    stats["serial"]["seconds"] = time.perf_counter() - t0
    log("moe (a) serial route: " + json.dumps(stats["serial"]))
    t0 = time.perf_counter()
    stats["engine"], requests, _ = moe_engine_burst(gen, tok, cfg, smi)
    stats["engine"]["seconds"] = time.perf_counter() - t0
    log("moe (b) engine: " + json.dumps(stats["engine"]))
    t0 = time.perf_counter()
    stats["int8"] = moe_int8(model, gen, cfg, requests, smi)
    stats["int8"]["seconds"] = time.perf_counter() - t0
    log("moe (c) int8: " + json.dumps(stats["int8"]))
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats["slice"] = moe_slice()
    stats["slice"]["seconds"] = time.perf_counter() - t0
    log("moe (d) fp32 slice: " + json.dumps(stats["slice"]))
    t0 = time.perf_counter()
    stats["training"] = moe_training(smi)
    stats["training"]["seconds"] = time.perf_counter() - t0
    log("moe (e) training: " + json.dumps(stats["training"]))
    root = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        t0 = time.perf_counter()
        stats["toolchain"] = moe_toolchain(root, smi)
        stats["toolchain"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("moe (f) toolchain: " + json.dumps(stats["toolchain"]))
    parts = ("serial", "engine", "int8", "training", "toolchain")
    stats["launches"] = {
        k: sum(stats[p]["counts"].get(k, 0) for p in parts)
        for k in ("flash_fwd_cuda", "flash_bwd_dq_cuda",
                  "flash_bwd_dkv_cuda", "block_attention_cuda")}
    stats["norm_launches"] = {
        k: sum(stats[p]["counts"].get(k, 0) for p in parts)
        for k in ("rms_fwd_cuda", "rms_bwd_cuda", "ln_fwd_cuda",
                  "ln_bwd_cuda")}
    check(all(stats["launches"][k] > 0 for k in stats["launches"]),
          f"moe phase: a kernel of its path never launched: "
          f"{stats['launches']}")
    return stats


# Phase 17: BERT-base and T5-base pretraining through the port's entry
# points at the presets' full widths and depths (models/bert.py
# bert_config, models/t5.py t5_config), micro-batch 8, bf16 compute, fp32
# master weights
BT_SEED = 0
BT_DOCS = 120
BT_VOCAB = {"bert": 30522, "t5": 32028}  # T5's entry adds 100 sentinels
BT_ITERS = 3
BT_MICRO = 8
BT_SEQ, BT_DEC_SEQ = 512, 128  # encoder, T5's decoder
BT_LR = "1e-4"
BT_DROPOUT = "0.1"
# layers each stack has in the flash kernels' per-step launches
BT_ATTENTION_CALLS = {"bert": 12, "t5": 36}
# the fp32 slices: BT_SLICE_LAYERS layers, BT_SLICE_BATCH rows of the
# phase's dataset, the card's kernels against the CPU's plain versions
BT_SLICE_LAYERS = 2
BT_SLICE_BATCH = 4


def bt_corpus(root: str, family: str) -> dict:
    """A WordPiece vocab.txt of BT_VOCAB[family] entries, BT_DOCS random
    documents, and their .bin/.idx through the port's
    tools/preprocess_data.py."""
    import os

    from megatron_tpu_torch.tools import preprocess_data, synthetic_corpus
    t0 = time.perf_counter()
    d = os.path.join(root, family)
    vocab = synthetic_corpus.write_wordpiece_vocab(d, BT_VOCAB[family])
    with open(vocab) as f:
        n_vocab = sum(1 for _ in f)
    check(n_vocab == BT_VOCAB[family], f"{family} vocab.txt holds {n_vocab}")
    jsonl = synthetic_corpus.write_jsonl(os.path.join(d, "corpus.jsonl"),
                                         BT_DOCS, BT_SEED)
    prefix = os.path.join(d, "corpus")
    preprocess_data.main(["--input", jsonl, "--output_prefix", prefix,
                          "--tokenizer_type", "BertWordPieceLowerCase",
                          "--vocab_file", vocab])
    return dict(vocab=vocab, data=prefix + "_document",
                seconds=time.perf_counter() - t0)


def bt_argv(family: str, corpus: dict, *extra, layers: int = 12) -> list:
    argv = ["--data_path", corpus["data"], "--vocab_file", corpus["vocab"],
            "--tokenizer_type", "BertWordPieceLowerCase",
            "--num_layers", str(layers), "--hidden_size", "768",
            "--num_attention_heads", "12", "--seq_length", str(BT_SEQ),
            "--bf16", "--attention_impl", "flash",
            "--micro_batch_size", str(BT_MICRO), "--global_batch_size",
            str(BT_MICRO), "--train_iters", str(BT_ITERS), "--lr", BT_LR,
            "--log_interval", "1", "--seed", str(BT_SEED), *extra]
    if family == "t5":
        argv += ["--decoder_seq_length", str(BT_DEC_SEQ)]
    return argv


def state_digest(state) -> list:
    """One int64 a tensor of the state (parameters, Adam's mu and nu): the
    sum of its bit patterns, read in one copy. Equal digests of two states
    say their bits agree."""
    import torch
    o = state.opt_state
    tensors = [*state.params.state_dict().values(), *o.mu.values(),
               *o.nu.values(), o.step]
    with torch.no_grad():
        sums = [t.detach().contiguous().view(torch.int32).to(
            torch.int64).sum() for t in tensors]
    return torch.stack(sums).tolist()


def run_entry(main, argv: list) -> dict:
    """One in-process run of an entry point's main(argv) on the card, the
    kernels' launch counts zeroed just before: each step's loss, grad norm,
    launches and CUDA-event ms, and the final state's digest."""
    import torch
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    from megatron_tpu_torch.training import loop

    steps, final = [], {}
    make_step, train = loop.make_train_step, loop.train

    def recording_make(*a, **k):
        step = make_step(*a, **k)

        def recorded(state, batch, gen):
            before = fc.launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch, gen)
            stop.record()
            after = fc.launch_counts()
            steps.append(dict(iteration=state.iteration, metrics=m,
                              start=start, stop=stop,
                              launches={k: after[k] - before[k]
                                        for k in after}))
            return state, m
        return recorded

    def recording_train(*a, **k):
        state, consumed = train(*a, **k)
        final["digest"] = state_digest(state)
        return state, consumed

    loop.make_train_step, loop.train = recording_make, recording_train
    fc.reset_launch_counts()
    fnc.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = main(argv)
        torch.cuda.synchronize()
    finally:
        loop.make_train_step, loop.train = make_step, train
    check(rc == 0, f"main returned {rc}")
    for rec in steps:
        m = rec.pop("metrics")
        rec.update(lm_loss=float(m["lm_loss"]),
                   grad_norm=float(m["grad_norm"]),
                   found_inf=int(m["found_inf"]),
                   device_ms=rec.pop("start").elapsed_time(rec.pop("stop")))
    return dict(steps=steps, digest=final.get("digest"),
                launches=fc.launch_counts(),
                norm_launches=fnc.launch_counts(),
                seconds=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def bt_family(family: str, corpus: dict, root: str, smi: str) -> dict:
    """U (BT_ITERS iterations), P (--save, --exit_interval 2), R (--load P
    to BT_ITERS) and D (one iteration with hidden and attention dropout
    BT_DROPOUT) through the family's entry point."""
    import os

    import torch
    from megatron_tpu_torch import pretrain_bert, pretrain_t5
    main = {"bert": pretrain_bert, "t5": pretrain_t5}[family].main
    save = os.path.join(root, f"{family}_ckpt")
    runs = {}
    for name, extra in (
            ("U", ()),
            ("P", ("--save", save, "--save_interval", "2",
                   "--exit_interval", "2")),
            ("R", ("--save", save, "--save_interval", "2")),
            ("D", ("--train_iters", "1", "--hidden_dropout", BT_DROPOUT,
                   "--attention_dropout", BT_DROPOUT))):
        torch.cuda.reset_peak_memory_stats()
        runs[name] = run_entry(main, bt_argv(family, corpus, *extra))
        log(f"{family} {name}: " + json.dumps(
            {k: v for k, v in runs[name].items() if k != "digest"}))
    u, p, r, d = (runs[k]["steps"] for k in "UPRD")
    check([s["iteration"] for s in u] == list(range(1, BT_ITERS + 1))
          and [s["iteration"] for s in p] == [1, 2]
          and [s["iteration"] for s in r] == list(range(3, BT_ITERS + 1)),
          f"{family}: iterations U {[s['iteration'] for s in u]}, P "
          f"{[s['iteration'] for s in p]}, R {[s['iteration'] for s in r]}")
    losses = [s["lm_loss"] for s in u]
    check(all(math.isfinite(x) for x in losses)
          and all(s["found_inf"] == 0 for s in u + p + r + d),
          f"{family}: losses {losses}")
    # MLM over the true vocabulary (+ NSP's ln 2 for BERT) at random init
    want0 = math.log(BT_VOCAB[family] + (100 if family == "t5" else 0)) + (
        math.log(2) if family == "bert" else 0.0)
    check(abs(losses[0] - want0) < 1.0,
          f"{family}: first loss {losses[0]} not near {want0:.2f}")
    # the resume: P's steps are U's, R's are U's, and R's final state is
    # U's, bit for bit
    for what, got, want in (("P", p, u[:2]), ("R", r, u[2:])):
        check([(s["lm_loss"], s["grad_norm"]) for s in got]
              == [(s["lm_loss"], s["grad_norm"]) for s in want],
              f"{family}: {what}'s steps differ from U's: "
              f"{[s['lm_loss'] for s in got]} vs "
              f"{[s['lm_loss'] for s in want]}")
    check(runs["R"]["digest"] == runs["U"]["digest"],
          f"{family}: the resumed state differs from the uninterrupted one")
    check(math.isfinite(d[0]["lm_loss"]) and d[0]["lm_loss"] != u[0]["lm_loss"],
          f"{family}: the dropout run's loss {d[0]['lm_loss']} (U "
          f"{u[0]['lm_loss']})")
    calls = BT_ATTENTION_CALLS[family]
    for s_ in u + p + r + d:
        check(all(v == calls for v in s_["launches"].values()),
              f"{family}: an iteration launched {s_['launches']}, not "
              f"{calls} of each flash kernel")
    totals = {k: sum(runs[n]["launches"][k] for n in runs)
              for k in runs["U"]["launches"]}
    norms = {k: sum(runs[n]["norm_launches"][k] for n in runs)
             for k in runs["U"]["norm_launches"]}
    tokens = BT_MICRO * (BT_SEQ + (BT_DEC_SEQ if family == "t5" else 0))
    step_ms = [s["device_ms"] for s in u[1:]]
    return dict(losses=losses, dropout_loss=d[0]["lm_loss"],
                resumed_bit_equal=True, launches=totals,
                norm_launches=norms, step_ms=step_ms,
                tokens_per_s=tokens / (sum(step_ms) / len(step_ms) / 1e3),
                run_seconds={k: v["seconds"] for k, v in runs.items()},
                peak_gib={k: v["peak_gib"] for k, v in runs.items()},
                card=smi)


def bt_slice(family: str, corpus: dict) -> dict:
    """BT_SLICE_LAYERS layers of the family's width in fp32 (TF32 off) on
    the card (the flash kernels) and on the CPU (the plain versions), the
    same weights and BT_SLICE_BATCH rows of the phase's dataset: the loss
    within SLICE_TOL relative, every gradient leaf within SLICE_TOL of its
    largest magnitude."""
    from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset
    from megatron_tpu_torch.data.masked_dataset import (BertDataset,
                                                        T5Dataset)
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.models import bert, t5
    import numpy as np
    import torch
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = 100 if family == "t5" else 0
    tok = build_tokenizer("BertWordPieceLowerCase",
                          vocab_file=corpus["vocab"], vocab_extra_ids=extra)
    indexed = MMapIndexedDataset(corpus["data"])
    kw = dict(num_layers=BT_SLICE_LAYERS, vocab_size=tok.vocab_size,
              compute_dtype="float32", attention_impl="flash")
    if family == "bert":
        cfg, cls, loss_fn = bert.bert_config(**kw), bert.BertModel, \
            bert.bert_loss
        ds = BertDataset(indexed, BT_SLICE_BATCH, BT_SEQ, tok.vocab_size,
                         cls_id=tok.cls, sep_id=tok.sep, mask_id=tok.mask,
                         pad_id=tok.pad, seed=BT_SEED)
    else:
        cfg, cls, loss_fn = t5.t5_config(**kw), t5.T5Model, t5.t5_loss
        ds = T5Dataset(indexed, BT_SLICE_BATCH, BT_SEQ, BT_DEC_SEQ,
                       tok.vocab_size,
                       sentinel_ids=range(tok.vocab_size - extra,
                                          tok.vocab_size),
                       bos_id=tok.cls, eos_id=tok.sep, pad_id=tok.pad,
                       seed=BT_SEED)
    items = [ds[i] for i in range(BT_SLICE_BATCH)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in items[0]}
    card = cls(cfg, seed=BT_SEED, trainable=True)
    cpu = cls.from_state_dict(cfg, {k: v.detach().cpu().clone() for k, v in
                                    card.state_dict().items()},
                              trainable=True)
    before = fc.launch_counts()
    got = loss_fn(card, {k: v.to(card.device) for k, v in batch.items()},
                  cfg)
    got.backward()
    torch.cuda.synchronize()
    launched = {k: fc.launch_counts()[k] - before[k] for k in before}
    t0 = time.perf_counter()
    want = loss_fn(cpu, batch, cfg)
    want.backward()
    cpu_s = time.perf_counter() - t0
    check(all(v > 0 for v in launched.values()),
          f"{family} slice: the card's loss launched {launched}")
    loss_err = abs(got.item() - want.item()) / abs(want.item())
    check(loss_err <= SLICE_TOL, f"{family} slice: loss {got.item()} vs "
          f"{want.item()} on the CPU")
    worst = 0.0
    grads_cpu = dict(cpu.named_parameters())
    for name, p_ in card.named_parameters():
        ref = grads_cpu[name].grad
        scale = max(ref.abs().max().item(), 1e-30)
        err = (p_.grad.cpu() - ref).abs().max().item() / scale
        worst = max(worst, err)
        check(err <= SLICE_TOL, f"{family} slice: grad {name} err {err} of "
              f"its largest magnitude (tol {SLICE_TOL})")
    return dict(layers=BT_SLICE_LAYERS, batch=BT_SLICE_BATCH,
                loss=got.item(), loss_cpu=want.item(), loss_rel_err=loss_err,
                worst_grad_rel_err=worst, launches=launched, cpu_s=cpu_s)


def phase_bert_t5(smi: str) -> dict:
    """Phase 17: BERT-base and T5-base pretraining (see the module's note);
    the new kernel cases of KERNEL_CASES and TRAIN_CASES ran in phase 3."""
    import gc
    import shutil
    import tempfile

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_bert_t5_")
    stats = dict(card=smi)
    try:
        for family in ("bert", "t5"):
            corpus = bt_corpus(root, family)
            log(f"{family} corpus: {json.dumps(corpus)}")
            t0 = time.perf_counter()
            stats[family] = bt_family(family, corpus, root, smi)
            stats[family]["seconds"] = time.perf_counter() - t0
            stats[family]["corpus_s"] = corpus["seconds"]
            log(f"{family} pretraining: " + json.dumps(stats[family]))
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            stats[f"{family}_slice"] = bt_slice(family, corpus)
            stats[f"{family}_slice"]["seconds"] = time.perf_counter() - t0
            log(f"{family} fp32 slice: "
                + json.dumps(stats[f"{family}_slice"]))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats["launches"] = {k: stats["bert"]["launches"][k]
                         + stats["t5"]["launches"][k]
                         for k in stats["bert"]["launches"]}
    stats["norm_launches"] = {k: stats["bert"]["norm_launches"][k]
                              + stats["t5"]["norm_launches"][k]
                              for k in stats["bert"]["norm_launches"]}
    return stats


# Phase 18: the BERT heads and the retriever at BERT-base's full width and
# depth (models/bert.py bert_config(): 12 layers, h 768, 12 heads of 64,
# ffn 3072, vocab 30,522 padded to 30,592), bf16 compute, fp32 Adam, random
# weights from RT_SEED, on a WordPiece vocabulary and files the phase
# writes in the published layouts (no GLUE, RACE, NQ or DPR file is in the
# repository)
RT_SEED = 0
RT_VOCAB = 30522
RT_LAYERS, RT_HIDDEN, RT_HEADS = 12, 768, 12
RT_SHAPE = ["--num_layers", str(RT_LAYERS), "--hidden_size", str(RT_HIDDEN),
            "--num_attention_heads", str(RT_HEADS)]
RT_DOCS = 400              # ICT's sentence-split corpus
RT_SEQ = 256               # ICT, the evidence, NQ (pretrain_ict.py:4-6)
RT_ICT_MICRO = 32          # the in-batch softmax's 32 x 32 scores
RT_ICT_ITERS = 3
RT_ICT_HEAD = 128
RT_LR = "1e-4"
RT_MNLI = (128, 64, 128, 32)   # train rows, dev rows, seq, micro-batch
RT_RACE = (32, 16, 384, 8)     # train questions, dev questions, seq, micro
RT_PASSAGES = 8192
RT_INDEX_BATCH = 128
RT_QUESTIONS = 64
RT_TOPK = 100
RT_RET = (32, 16, 8)           # DPR train rows, dev rows, micro-batch
# DPR's psgs_w100.tsv rows and NQ-test's questions, for the MIPS search
MIPS_ROWS = 21_015_324
MIPS_QUERIES = 3_610
MIPS_DIM = 128
MIPS_CHECK = (64, 1_048_576)   # queries, rows held against float64 numpy
MIPS_SUB_CHUNK = 5             # queries a chunk in the chunked check
MIPS_SCORE_TOL = 1e-3          # fp32 dot products of 128 terms, |s| < 60
RT_SLICE_LAYERS = 2
RT_SLICE_LOSS_TOL = 1e-6
RT_SLICE_GRAD_TOL = 1e-5
# the heads' outputs, of their largest: fp32 sums in another order
# through 2 layers of 768 (1.0e-6 measured on the multiple-choice scores)
RT_SLICE_OUT_TOL = 1e-5


def rt_sentences(text: str) -> list:
    return [t.strip() for t in text.split(".") if t.strip()]


def rt_files(root: str) -> dict:
    """The phase's vocabulary and files: the sentence-split ICT corpus and
    its titles (written through the port's indexed-dataset builder, one
    sentence a row), MNLI TSVs, RACE json lines, an evidence TSV with
    questions whose answers occur in known passages, and DPR json."""
    import os

    import numpy as np
    from megatron_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.tools import synthetic_corpus as sc
    t0 = time.perf_counter()
    vocab = sc.write_wordpiece_vocab(root, RT_VOCAB)
    tok = build_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    rng = np.random.RandomState(RT_SEED)
    out = dict(vocab=vocab)

    sents, titles = (os.path.join(root, n) for n in ("sents", "titles"))
    bs, bt = IndexedDatasetBuilder(sents), IndexedDatasetBuilder(titles)
    for doc in sc.random_documents(RT_DOCS, RT_SEED):
        parts = rt_sentences(doc)
        for sentence in parts:
            bs.add_item(tok.tokenize(sentence))
        bs.end_document()
        bt.add_item(tok.tokenize(" ".join(parts[0].split()[:3])))
        bt.end_document()
    bs.finalize()
    bt.finalize()
    out.update(sents=sents, titles=titles)

    words = " ".join(sc.random_documents(50, RT_SEED + 1)).split()

    def phrase(lo, hi):
        return " ".join(rng.choice(words, rng.randint(lo, hi + 1)))

    labels = ["contradiction", "entailment", "neutral"]
    header = "\t".join(["index"] + [f"c{i}" for i in range(1, 8)] + [
        "sentence1", "sentence2", "label1", "gold_label"])
    for split, n in (("train", RT_MNLI[0]), ("dev", RT_MNLI[1])):
        path = os.path.join(root, f"mnli_{split}.tsv")
        with open(path, "w") as f:
            f.write(header + "\n")
            for i in range(n):
                f.write("\t".join([str(i)] + [""] * 7 + [
                    phrase(10, 40), phrase(5, 20), "x",
                    labels[rng.randint(3)]]) + "\n")
        out[f"mnli_{split}"] = path
    for split, n in (("train", RT_RACE[0]), ("dev", RT_RACE[1])):
        d = os.path.join(root, f"race_{split}")
        os.makedirs(d)
        with open(os.path.join(d, "high.txt"), "w") as f:
            for _ in range(n // 4):
                qs = [phrase(4, 10) + (" _ ." if rng.rand() < 0.5 else " ?")
                      for _ in range(4)]
                f.write(json.dumps({
                    "article": phrase(250, 340), "questions": qs,
                    "options": [[phrase(1, 5) for _ in range(4)]
                                for _ in qs],
                    "answers": ["ABCD"[rng.randint(4)] for _ in qs]})
                    + "\n")
        out[f"race_{split}"] = d

    passages = sc.random_documents(RT_PASSAGES, RT_SEED + 2, min_words=80,
                                   max_words=100)
    psgs = os.path.join(root, "psgs_w100.tsv")
    with open(psgs, "w") as f:
        f.write("id\ttext\ttitle\n")
        for i, text in enumerate(passages):
            f.write(f"{i + 1}\t{text}\t{' '.join(text.split()[:2])}\n")
    out["psgs"] = psgs
    # each question's answer is a 3-word span of a known passage; the
    # question holds the words before it
    nq = os.path.join(root, "nq-test.csv")
    with open(nq, "w") as f:
        for q in range(RT_QUESTIONS):
            w = passages[rng.randint(RT_PASSAGES)].replace(".", "").replace(
                ",", "").split()
            at = rng.randint(8, len(w) - 3)
            f.write(f"{' '.join(w[at - 8:at])}\t{[' '.join(w[at:at + 3])]!r}"
                    "\n")
    out["nq"] = nq

    def ctx(i):
        return {"title": " ".join(passages[i].split()[:2]),
                "text": passages[i]}
    for split, n in (("train", RT_RET[0]), ("dev", RT_RET[1])):
        rows = []
        for _ in range(n):
            pos = rng.randint(RT_PASSAGES)
            rows.append({
                "question": " ".join(passages[pos].split()[5:15]) + "?",
                "answers": [" ".join(passages[pos].split()[15:17])],
                "positive_ctxs": [ctx(pos)],
                "negative_ctxs": [ctx(i) for i in rng.randint(
                    RT_PASSAGES, size=30)],
                "hard_negative_ctxs": [ctx(i) for i in rng.randint(
                    RT_PASSAGES, size=30)]})
        path = os.path.join(root, f"nq-{split}.json")
        with open(path, "w") as f:
            json.dump(rows, f)
        out[f"nq_{split}"] = path
    out["seconds"] = time.perf_counter() - t0
    return out


def ict_argv(files: dict, *extra, layers=None) -> list:
    layers = RT_LAYERS if layers is None else layers
    return ["--data_path", files["sents"], "--titles_data_path",
            files["titles"], "--vocab_file", files["vocab"],
            "--tokenizer_type", "BertWordPieceLowerCase",
            "--num_layers", str(layers), "--hidden_size", str(RT_HIDDEN),
            "--num_attention_heads", str(RT_HEADS), "--seq_length",
            str(RT_SEQ),
            "--attention_impl", "flash", "--micro_batch_size",
            str(RT_ICT_MICRO), "--global_batch_size", str(RT_ICT_MICRO),
            "--train_iters", str(RT_ICT_ITERS), "--lr", RT_LR,
            "--log_interval", "1", "--seed", str(RT_SEED),
            "--ict_head_size", str(RT_ICT_HEAD), "--query_in_block_prob",
            "0.1", *extra]


def zeroed(fn, *args):
    """fn(*args) with the flash and norm kernels' counts zeroed just
    before and read just after: (result, counts, norm counts, seconds)."""
    import torch
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    fc.reset_launch_counts()
    fnc.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, fc.launch_counts(), fnc.launch_counts(),
            time.perf_counter() - t0)


def rt_ict(files: dict, root: str) -> dict:
    """(a) ICT at full width and depth (RT_ICT_ITERS iterations, one
    params-only checkpoint), then exact resume on a 2-layer fp32 slice with
    shared towers: U, P (save at 2, exit), R (resume to 3)."""
    import os

    from megatron_tpu_torch import pretrain_ict
    save = os.path.join(root, "ict_ckpt")
    full = run_entry(pretrain_ict.main, ict_argv(
        files, "--bf16", "--save", save, "--save_interval",
        str(RT_ICT_ITERS), "--no_save_optim"))
    losses = [s_["lm_loss"] for s_ in full["steps"]]
    check(len(losses) == RT_ICT_ITERS and all(
        math.isfinite(x) for x in losses), f"ICT losses {losses}")
    # two towers: 2 * RT_LAYERS launches of each kernel a step
    for s_ in full["steps"]:
        check(all(v == 2 * RT_LAYERS for v in s_["launches"].values()),
              f"an ICT step launched {s_['launches']}, not "
              f"{2 * RT_LAYERS} of each")
    slice_root = os.path.join(root, "ict_resume")
    runs = {}
    for name, extra in (
            ("U", ()),
            ("P", ("--save", slice_root, "--save_interval", "2",
                   "--exit_interval", "2")),
            ("R", ("--save", slice_root, "--save_interval", "2"))):
        runs[name] = run_entry(pretrain_ict.main, ict_argv(
            files, "--biencoder_shared_query_context_model", *extra,
            layers=RT_SLICE_LAYERS))
    u, p, r = (runs[k]["steps"] for k in "UPR")
    for what, got, want in (("P", p, u[:2]), ("R", r, u[2:])):
        check([(s_["lm_loss"], s_["grad_norm"]) for s_ in got]
              == [(s_["lm_loss"], s_["grad_norm"]) for s_ in want],
              f"ICT slice: {what}'s steps differ from U's: "
              f"{[(s_['lm_loss'], s_['grad_norm']) for s_ in got]} vs "
              f"{[(s_['lm_loss'], s_['grad_norm']) for s_ in want]}")
    check(runs["R"]["digest"] == runs["U"]["digest"],
          "ICT slice: the resumed state differs from the uninterrupted one")
    step_ms = [s_["device_ms"] for s_ in full["steps"][1:]]
    return dict(losses=losses, ln_batch=math.log(RT_ICT_MICRO),
                step_ms=step_ms, launches=full["launches"],
                norm_launches=full["norm_launches"],
                seconds=full["seconds"], peak_gib=full["peak_gib"],
                ckpt=save, ckpt_bytes=sum(
                    os.path.getsize(os.path.join(dp, f_))
                    for dp, _, fs in os.walk(save) for f_ in fs),
                resume=dict(losses=[s_["lm_loss"] for s_ in u],
                            bit_equal=True, seconds={
                                k: v["seconds"] for k, v in runs.items()},
                            launches={k: (v["launches"], v["norm_launches"])
                                      for k, v in runs.items()}))


def rt_task(argv: list) -> tuple:
    """One tasks.main run on the card, counted from zero; returns (its
    metrics, flash counts, norm counts, seconds)."""
    from megatron_tpu_torch.tasks import main as tasks_main
    return zeroed(tasks_main.main, argv)


def rt_finetune(files: dict) -> dict:
    """(b) MNLI (seq 128, micro-batch 32, 3 classes) and RACE (seq 384,
    micro-batch 8 x 4 choices) through tasks.main, one epoch each."""
    out = {}
    for task, (n_train, _, seq, micro), key in (
            ("MNLI", RT_MNLI, "mnli"), ("RACE", RT_RACE, "race")):
        metrics, counts, norms, took = rt_task([
            "--task", task, "--train_data", files[f"{key}_train"],
            "--valid_data", files[f"{key}_dev"], "--vocab_file",
            files["vocab"], "--tokenizer_type", "BertWordPieceLowerCase",
            "--seq_length", str(seq), "--micro_batch_size", str(micro),
            "--epochs", "1", "--lr", "2e-5", *RT_SHAPE])
        check(sorted(metrics) == ["best accuracy", "last accuracy"]
              and 0.0 <= metrics["last accuracy"] <= 1.0,
              f"{task}: {metrics}")
        steps = n_train // micro
        # RT_LAYERS a step forward and backward; the evaluation's
        # forwards on top
        check(counts["flash_bwd_dq_cuda"] == RT_LAYERS * steps
              and counts["flash_fwd_cuda"] > RT_LAYERS * steps,
              f"{task}: launches {counts}")
        out[task] = dict(metrics=metrics, launches=counts,
                         norm_launches=norms, seconds=took, steps=steps)
    return out


def rt_index_and_eval(files: dict, ckpt: str, root: str) -> dict:
    """(c) create_doc_index over the evidence from (a)'s checkpoint, the
    store held against one batch-by-batch embed_text pass, then tasks.main
    --task NQ over it."""
    import os

    import numpy as np
    import torch
    from megatron_tpu_torch.data.orqa_dataset import \
        OpenRetrievalEvidenceDataset
    from megatron_tpu_torch.data.realm_index import OpenRetrievalDataStore
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.indexer import IndexBuilder
    from megatron_tpu_torch.models.biencoder import load_biencoder
    from megatron_tpu_torch.tasks.main import get_tasks_parser
    from megatron_tpu_torch.tools import create_doc_index
    emb = os.path.join(root, "evidence.npz")
    rc, counts, norms, took = zeroed(create_doc_index.main, [
        "--load", ckpt, "--evidence_data_path", files["psgs"],
        "--embedding_path", emb, "--vocab_file", files["vocab"],
        "--retriever_seq_length", str(RT_SEQ), "--indexer_batch_size",
        str(RT_INDEX_BATCH), "--ict_head_size", str(RT_ICT_HEAD),
        "--indexer_log_interval", "0"])
    check(rc == 0, f"create_doc_index returned {rc}")
    batches = -(-RT_PASSAGES // RT_INDEX_BATCH)
    check(counts["flash_fwd_cuda"] == RT_LAYERS * batches
          and counts["flash_bwd_dq_cuda"] == 0,
          f"create_doc_index launched {counts}")
    store = OpenRetrievalDataStore(emb)
    check(len(store) == RT_PASSAGES, f"the store holds {len(store)}")
    tok = build_tokenizer("BertWordPieceLowerCase",
                          vocab_file=files["vocab"])
    args = get_tasks_parser().parse_args([
        "--task", "NQ", "--valid_data", "x", "--load", ckpt,
        "--ict_head_size", str(RT_ICT_HEAD)])
    model, mcfg = load_biencoder(args, tok.vocab_size, RT_SEQ)
    evidence = OpenRetrievalEvidenceDataset(files["psgs"], tok, RT_SEQ)
    builder = IndexBuilder(model, mcfg, evidence, embedding_path=emb,
                           batch_size=RT_INDEX_BATCH)
    worst = 0.0
    for batch in evidence.batches(RT_INDEX_BATCH):
        n = batch["n_real"]
        got = builder.embed(batch)[:n].cpu().numpy()
        stored = np.stack([store.embed_data[int(i)] for i in
                           batch["row_id"][:n]]).astype(np.float32)
        step = np.spacing(np.maximum(np.abs(stored), np.abs(got)).astype(
            np.float16)).astype(np.float32)
        worst = max(worst, float((np.abs(stored - got) / step).max()))
    check(worst <= 1.0, f"the store differs from embed_text by {worst} "
          "fp16 steps")
    del model, builder
    torch.cuda.empty_cache()
    metrics, nq_counts, nq_norms, nq_took = rt_task([
        "--task", "NQ", "--load", ckpt, "--valid_data", files["nq"],
        "--evidence_data_path", files["psgs"], "--embedding_path", emb,
        "--tokenizer_type", "BertWordPieceLowerCase", "--vocab_file",
        files["vocab"], "--faiss_topk_retrievals", str(RT_TOPK),
        "--retriever_seq_length", str(RT_SEQ), "--micro_batch_size", "64",
        "--ict_head_size", str(RT_ICT_HEAD)])
    top = metrics[files["nq"]]
    check(sorted(top) == ["top1", "top100", "top20", "top5"]
          and top["top1"] <= top["top5"] <= top["top20"] <= top["top100"],
          f"NQ: {metrics}")
    return dict(index_seconds=took, passages_per_s=RT_PASSAGES / took,
                index_launches=counts, index_norm_launches=norms,
                store_vs_embed_text_fp16_steps=worst, nq=top,
                nq_seconds=nq_took, nq_launches=nq_counts,
                nq_norm_launches=nq_norms)


def rt_mips(smi: str) -> dict:
    """(d) MIPSIndex over MIPS_ROWS x 128 fp32 embeddings made on the card
    from a seeded generator, MIPS_QUERIES queries for the top RT_TOPK,
    timed. The timed search's first 64 rows (two of its chunks) are held
    against one block of those queries' scores over every row; 64 queries
    over the first 1,048,576 rows, in chunks of MIPS_SUB_CHUNK queries and
    in one block, against a float64 numpy top-100. A chunk's query count
    may change cuBLAS's kernel and so the scores' rounding: chunked and
    one-block results are held as the float64 check holds them, scores
    within MIPS_SCORE_TOL and each id's score, under the other search's
    scoring, within it too; how many ids are equal is reported."""
    import numpy as np
    import torch
    from megatron_tpu_torch.models.biencoder import MIPSIndex, exact_fp32
    gen = torch.Generator(device="cuda").manual_seed(RT_SEED)
    matrix = torch.randn(MIPS_ROWS, MIPS_DIM, generator=gen, device="cuda")
    queries = torch.randn(MIPS_QUERIES, MIPS_DIM, generator=gen,
                          device="cuda")
    index = MIPSIndex(MIPS_DIM)
    index.add_block_data(np.arange(MIPS_ROWS), matrix)
    index.search_device(queries[:8], RT_TOPK)  # cuBLAS and topk warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, rows = index.search_device(queries, RT_TOPK)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    check(scores.shape == (MIPS_QUERIES, RT_TOPK)
          and bool(torch.isfinite(scores).all())
          and bool((scores[:, :-1] >= scores[:, 1:]).all()),
          "MIPS: scores not finite and sorted")
    flops = 2.0 * MIPS_QUERIES * MIPS_ROWS * MIPS_DIM
    nbytes = 4.0 * (MIPS_ROWS * MIPS_DIM + MIPS_QUERIES * MIPS_DIM
                    + 2 * MIPS_QUERIES * RT_TOPK)
    bound, bound_by = bound_ms(flops, nbytes, "torch.float32")
    chunk_rows = index.chunk_rows()
    n_q, n_rows = MIPS_CHECK
    check(chunk_rows < n_q, f"MIPS: the timed search's first {n_q} queries "
          f"lie in one chunk of {chunk_rows}")
    # the timed search's first n_q rows against one block over every row
    with torch.no_grad(), exact_fp32():
        block = queries[:n_q] @ matrix.T
        top = torch.topk(block, RT_TOPK, dim=-1)
        full = dict(
            scores_max_diff=(scores[:n_q] - top.values).abs().max().item(),
            id_scores_max_diff=(torch.gather(block, 1, rows[:n_q])
                                - top.values).abs().max().item(),
            ids_equal=(rows[:n_q] == top.indices).float().mean().item())
    del block, top, scores, rows
    check(max(full["scores_max_diff"], full["id_scores_max_diff"])
          <= MIPS_SCORE_TOL, f"MIPS: the timed search's first {n_q} rows "
          f"vs one block over every row: {full} (tol {MIPS_SCORE_TOL})")
    sub = MIPSIndex(MIPS_DIM, score_bytes=4 * MIPS_SUB_CHUNK * n_rows)
    sub.add_block_data(np.arange(n_rows), matrix[:n_rows])
    check(sub.chunk_rows() == MIPS_SUB_CHUNK,
          f"MIPS: the chunked check runs {sub.chunk_rows()} queries a chunk")
    got_s, got_i = sub.search_mips_index(queries[:n_q], RT_TOPK)
    one = MIPSIndex(MIPS_DIM, score_bytes=4 * n_q * n_rows)
    one.add_block_data(np.arange(n_rows), matrix[:n_rows])
    check(one.chunk_rows() >= n_q, "MIPS: the one-block search is chunked")
    one_s, one_i = one.search_mips_index(queries[:n_q], RT_TOPK)
    m64 = matrix[:n_rows].double().cpu().numpy()
    q64 = queries[:n_q].double().cpu().numpy()
    del matrix, index, sub, one
    torch.cuda.empty_cache()
    s64 = q64 @ m64.T
    top = np.argpartition(-s64, RT_TOPK, axis=1)[:, :RT_TOPK]
    order = np.argsort(-np.take_along_axis(s64, top, axis=1), axis=1)
    want_i = np.take_along_axis(top, order, axis=1)
    want_s = np.take_along_axis(s64, want_i, axis=1)
    # the ids' own float64 scores: a correct top-k up to near-ties
    got_s64 = np.sort(np.take_along_axis(s64, got_i, axis=1), axis=1)[:, ::-1]
    one_s64 = np.sort(np.take_along_axis(s64, one_i, axis=1),
                      axis=1)[:, ::-1]
    err_scores = float(max(np.abs(got_s - want_s).max(),
                           np.abs(one_s - want_s).max(),
                           np.abs(got_s - one_s).max()))
    err_ids = float(max(np.abs(got_s64 - want_s).max(),
                        np.abs(one_s64 - want_s).max()))
    check(err_scores <= MIPS_SCORE_TOL and err_ids <= MIPS_SCORE_TOL,
          f"MIPS vs float64, chunked and one block: scores off by "
          f"{err_scores}, the ids' scores by {err_ids} "
          f"(tol {MIPS_SCORE_TOL})")
    return dict(rows=MIPS_ROWS, queries=MIPS_QUERIES, dim=MIPS_DIM,
                top_k=RT_TOPK, seconds=took, chunk_rows=chunk_rows,
                matrix_gb=MIPS_ROWS * MIPS_DIM * 4 / 1e9, bound_ms=bound,
                bound_by=bound_by, tflop=flops / 1e12,
                check=dict(queries=n_q, rows=n_rows,
                           max_score_err=err_scores,
                           max_id_score_err=err_ids,
                           ids_equal=float((got_i == want_i).mean()),
                           chunk_queries=MIPS_SUB_CHUNK,
                           chunked_ids_equal_one_block=float(
                               (got_i == one_i).mean()),
                           chunked_scores_max_diff=float(
                               np.abs(got_s - one_s).max())),
                timed_vs_one_block=dict(queries=n_q, **full),
                card=smi)


def rt_ret_finetune(files: dict, ckpt: str) -> dict:
    """(e) RET-FINETUNE-NQ from (a)'s checkpoint, as
    examples/finetune_retriever.sh: micro-batch 8, one hard negative,
    score scaling, seq 256."""
    n_train, _, micro = RT_RET
    metrics, counts, norms, took = rt_task([
        "--task", "RET-FINETUNE-NQ", "--train_data", files["nq_train"],
        "--valid_data", files["nq_dev"], "--pretrained_checkpoint", ckpt,
        "--vocab_file", files["vocab"], "--retriever_seq_length",
        str(RT_SEQ), "--micro_batch_size", str(micro), "--epochs", "1",
        "--lr", "2e-5", "--train_with_neg", "--train_hard_neg", "1",
        "--retriever_score_scaling", "--ict_head_size", str(RT_ICT_HEAD),
        *RT_SHAPE])
    check(sorted(metrics) == ["average_rank", "top1_accuracy"]
          and 1.0 <= metrics["average_rank"] <= 61.0,
          f"RET-FINETUNE-NQ: {metrics}")
    steps = n_train // micro
    check(counts["flash_bwd_dq_cuda"] == 2 * RT_LAYERS * steps,
          f"RET-FINETUNE-NQ launched {counts}")
    return dict(metrics=metrics, launches=counts, norm_launches=norms,
                seconds=took, steps=steps)


def rt_slice(files: dict) -> dict:
    """(f) RT_SLICE_LAYERS layers at BERT-base's width in fp32 (TF32 off):
    the classification, multiple-choice and retrieval losses through the
    flash kernels against the dot path, on the same weights and batches
    from the phase's files. Held for each loss:
    - the loss within RT_SLICE_LOSS_TOL relative, and the heads' outputs
      (logits, query and context embeddings) within RT_SLICE_OUT_TOL of
      their largest;
    - every gradient under a seeded cotangent on the outputs within
      RT_SLICE_GRAD_TOL of its leaf's largest;
    - every gradient of the loss through each path's backward, under the
      dot path's cotangent of the loss on the outputs, within
      RT_SLICE_GRAD_TOL of its leaf's scale: the larger of the leaf's
      largest and the leaf's terms' scale, the same backward under that
      cotangent with seeded random signs. At random init the heads'
      outputs barely depend on the row, and the multiple-choice and
      in-batch losses' cotangents sum to zero over the rows (the
      multiple-choice head's bias gets sum_c (p_c - y_c) = 0, the context
      ict_head's bias sum_i q_i sum_j (p_ij - d_ij) = 0): such a leaf's
      gradient is a difference of nearly equal terms, measured against
      their size.
    The classification loss's own gradients, flash against dot, are
    held within RT_SLICE_GRAD_TOL of each leaf's largest too; the other
    two losses' are reported: their cotangents are differences of nearly
    equal rows themselves, so the outputs' rounding reaches them
    amplified."""
    import numpy as np
    import torch
    from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset
    from megatron_tpu_torch.data.ict_dataset import ICTDataset
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.models import bert, biencoder, classification
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.tasks.glue.data import GlueDataset, read_mnli
    from megatron_tpu_torch.tasks.race.data import RaceDataset, read_race
    torch.backends.cuda.matmul.allow_tf32 = False
    tok = build_tokenizer("BertWordPieceLowerCase", vocab_file=files["vocab"])
    sents = MMapIndexedDataset(files["sents"])
    ict = ICTDataset(sents, sents.doc_idx, MMapIndexedDataset(
        files["titles"]), max_seq_length=RT_SEQ, cls_id=tok.cls,
        sep_id=tok.sep, pad_id=tok.pad, seed=RT_SEED, sizes=sents.sizes)

    def head_outputs(forward):
        def out(m, b, cfg):
            return [forward(m, b["tokens"], cfg,
                            tokentype_ids=b["tokentype_ids"],
                            padding_mask=b["padding_mask"])]
        return out

    def embeddings(m, b, cfg):
        return list(biencoder.biencoder_forward(
            m, b["query_tokens"], b["context_tokens"], cfg,
            query_pad_mask=b["query_pad_mask"],
            context_pad_mask=b["context_pad_mask"]))

    def head_loss(outs, b):
        return classification.cross_entropy_loss(outs[0], b["label"]).mean()

    def in_batch_loss(outs, b):
        q, c = outs
        scores = q @ c.T / math.sqrt(q.shape[-1])
        return -torch.log_softmax(scores, dim=-1).diagonal().mean()

    # name: (model, options, the port's loss, its outputs, the loss on
    # the outputs, data, rows, seq, its own gradients held)
    cases = {
        "classification": (
            classification.ClassificationModel, dict(num_classes=3),
            classification.classification_loss,
            head_outputs(classification.classification_forward), head_loss,
            GlueDataset(read_mnli(files["mnli_dev"])[:8], tok, RT_MNLI[2]),
            8, RT_MNLI[2], True),
        "multichoice": (
            classification.MultipleChoiceModel, {},
            classification.multiple_choice_loss,
            head_outputs(classification.multiple_choice_forward), head_loss,
            RaceDataset(read_race(files["race_dev"])[:2], tok, RT_RACE[2]),
            2, RT_RACE[2], False),
        "retrieval": (
            biencoder.BiencoderModel, dict(ict_head_size=RT_ICT_HEAD),
            lambda m, b, c: biencoder.retrieval_loss(m, b, c)[0],
            embeddings, in_batch_loss, ict, 8, RT_SEQ, False)}

    def leaf_errors(got, want, scale=None):
        """{leaf: max |got - want| / its scale}."""
        out = {}
        for n, ref in want.items():
            sc = ref.abs().max().item()
            if scale is not None:
                sc = max(sc, scale[n].abs().max().item())
            out[n] = (got[n] - ref).abs().max().item() / max(sc, 1e-30)
        return out

    out = {}
    for name, (cls, opts, loss_fn, out_fn, outs_loss, ds, rows, seq,
               hold_own) in cases.items():
        items = [ds[i] for i in range(rows)]
        batch = {k: torch.from_numpy(np.stack([it[k] for it in items])
                                     ).cuda() for k in items[0]}
        losses, outputs, own, vjps, through, launched = ({} for _ in
                                                         range(6))
        model = cot = signed = None
        for impl in ("dot", "flash"):
            cfg = bert.bert_config(num_layers=RT_SLICE_LAYERS,
                                   hidden_size=RT_HIDDEN,
                                   num_attention_heads=RT_HEADS,
                                   vocab_size=tok.vocab_size,
                                   seq_length=seq,
                                   max_position_embeddings=seq,
                                   compute_dtype="float32",
                                   attention_impl=impl)
            if model is None:
                model = cls(cfg, seed=RT_SEED, trainable=True, **opts)
            else:
                model = cls.from_state_dict(cfg, {
                    k: v.detach().clone() for k, v in
                    model.state_dict().items()}, trainable=True)
            params = dict(model.named_parameters())

            def grads(value, **kw):
                got = torch.autograd.grad(value, list(params.values()),
                                          allow_unused=True, **kw)
                return {n: torch.zeros_like(p) if g is None else g
                        for (n, p), g in zip(params.items(), got)}

            before = fc.launch_counts()
            loss = loss_fn(model, batch, cfg)
            outs = out_fn(model, batch, cfg)
            losses[impl] = loss.item()
            outputs[impl] = [o.detach() for o in outs]
            own[impl] = grads(loss)
            if cot is None:
                # the seeded cotangent, and the dot path's cotangent of
                # the loss on its outputs (that loss is the port's)
                gen = torch.Generator(device="cuda").manual_seed(RT_SEED)
                cot = [torch.randn(o.shape, generator=gen, device="cuda")
                       for o in outs]
                again = outs_loss(outs, batch)
                check(abs(again.item() - losses[impl])
                      <= RT_SLICE_LOSS_TOL * abs(losses[impl]),
                      f"{name} slice: the loss on the outputs "
                      f"{again.item()} vs the port's {losses[impl]}")
                dloss = [g.detach() for g in torch.autograd.grad(
                    again, outs, retain_graph=True)]
                signed = [g * torch.randint(0, 2, g.shape, generator=gen,
                                            device="cuda").mul(2).sub(1)
                          for g in dloss]
                terms = grads(outs, grad_outputs=signed, retain_graph=True)
            vjps[impl] = grads(outs, grad_outputs=cot, retain_graph=True)
            through[impl] = grads(outs, grad_outputs=dloss)
            torch.cuda.synchronize()
            launched[impl] = {k: fc.launch_counts()[k] - before[k]
                              for k in before}
        check(all(v > 0 for v in launched["flash"].values())
              and not any(launched["dot"].values()),
              f"{name} slice: launches {launched}")
        loss_err = abs(losses["flash"] - losses["dot"]) / abs(losses["dot"])
        check(loss_err <= RT_SLICE_LOSS_TOL,
              f"{name} slice: loss flash {losses['flash']} vs dot "
              f"{losses['dot']}")
        out_err = max((f - d).abs().max().item() / d.abs().max().item()
                      for f, d in zip(outputs["flash"], outputs["dot"]))
        check(out_err <= RT_SLICE_OUT_TOL,
              f"{name} slice: outputs err {out_err} of their largest")
        worst = {}
        for what, errs, held in (
                ("outputs", leaf_errors(vjps["flash"], vjps["dot"]), True),
                ("through", leaf_errors(through["flash"], through["dot"],
                                        terms), True),
                ("own", leaf_errors(own["flash"], own["dot"]), hold_own)):
            worst[what] = max(errs.items(), key=lambda kv: kv[1])
            check(not held or worst[what][1] <= RT_SLICE_GRAD_TOL,
                  f"{name} slice: {what} grad {worst[what][0]} err "
                  f"{worst[what][1]} of its scale (tol {RT_SLICE_GRAD_TOL})")
        out[name] = dict(loss=losses["flash"], loss_dot=losses["dot"],
                         loss_rel_err=loss_err, output_rel_err=out_err,
                         launches=launched["flash"], own_grads_held=hold_own,
                         **{f"worst_{w}_grad": list(v)
                            for w, v in worst.items()})
        del model, own, vjps, through, terms
        torch.cuda.empty_cache()
    return out


def phase_retrieval_tasks(smi: str) -> dict:
    """Phase 18: the BERT heads and the retriever (see the note above
    RT_SEED), parts (a)-(f); the new kernel cases of KERNEL_CASES and
    TRAIN_CASES ran in phase 3."""
    import gc
    import shutil
    import tempfile

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_retrieval_")
    stats = dict(card=smi)

    def part(name, fn, *args):
        t0 = time.perf_counter()
        stats[name] = fn(*args)
        stats[name]["part_seconds"] = time.perf_counter() - t0
        log(f"retrieval {name}: " + json.dumps(stats[name]))
        gc.collect()
        torch.cuda.empty_cache()

    try:
        files = rt_files(root)
        stats["files_s"] = files["seconds"]
        log(f"retrieval files: {files['seconds']:.1f} s")
        part("ict", rt_ict, files, root)
        ckpt = stats["ict"]["ckpt"]
        part("finetune", rt_finetune, files)
        part("index", rt_index_and_eval, files, ckpt, root)
        part("mips", rt_mips, smi)
        part("ret_finetune", rt_ret_finetune, files, ckpt)
        part("slice", rt_slice, files)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ict, ft, ix = stats["ict"], stats["finetune"], stats["index"]
    counted = [(ict["launches"], ict["norm_launches"]),
               *ict["resume"]["launches"].values(),
               (ft["MNLI"]["launches"], ft["MNLI"]["norm_launches"]),
               (ft["RACE"]["launches"], ft["RACE"]["norm_launches"]),
               (ix["index_launches"], ix["index_norm_launches"]),
               (ix["nq_launches"], ix["nq_norm_launches"]),
               (stats["ret_finetune"]["launches"],
                stats["ret_finetune"]["norm_launches"])]
    for key, at in (("launches", 0), ("norm_launches", 1)):
        stats[key] = {k: sum(c[at][k] for c in counted)
                      for k in counted[0][at]}
    return stats


PHASES = {"4": phase_main_path, "5": phase_engine, "6": phase_int8,
          "7": phase_training, "8": phase_pretrain, "9": phase_toolchain,
          "10": phase_window_supervisor, "11": phase_engine_features,
          "12": phase_front_door, "13": phase_lora_live,
          "14": phase_structured_degrade, "15": phase_fleet,
          "16": phase_moe, "17": phase_bert_t5,
          "18": phase_retrieval_tasks}


class Lane:
    """The second lane: `chip_smoke.py --lane` over `phases` in a process
    of its own session, whose output lines are logged here prefixed as
    they come. `join` returns its phases' results and seconds; `stop`
    kills it and every process it started, whatever state it is in."""

    PREFIX = "lane B | "

    def __init__(self, phases, smi: str):
        import os
        here = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(here, "build"), exist_ok=True)
        self.out = os.path.join(here, "build", "chip_smoke_lane.json")
        if os.path.exists(self.out):
            os.remove(self.out)
        self.proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--lane",
             ",".join(phases), "--lane-out", self.out, "--smi", smi],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        self.pump = threading.Thread(target=self._pump, daemon=True)
        self.pump.start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            log(self.PREFIX + line.rstrip("\n"))

    def check(self) -> None:
        """Raise once the lane has failed, so that this lane stops too."""
        rc = self.proc.poll()
        check(rc is None or rc == 0, f"lane B failed (exit code {rc})")

    def join(self) -> tuple:
        rc = self.proc.wait()
        self.stop()
        check(rc == 0, f"lane B failed (exit code {rc})")
        with open(self.out) as f:
            done = json.load(f)
        return done["stats"], done["seconds"]

    def stop(self) -> None:
        import os
        import signal
        try:  # the lane's own processes too (its replicas, subprocesses)
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()
        self.pump.join(timeout=30)


def run_lane(phases, out: str, smi: str) -> int:
    """`--lane`: phases of LANE_B in their order, then {"stats", "seconds"}
    written to `out` (JSON). Exit code 1, and no file, if one fails."""
    seconds, stats = {}, {}
    t_lane = time.perf_counter()
    try:
        for number in phases:
            t0 = time.perf_counter()
            stats[number] = PHASES[number](smi)
            took = time.perf_counter() - t0
            seconds[number] = round(took, 1)
            log(f"phase {number} ({PHASES[number].__name__}) took "
                f"{took:.1f} s")
    except Exception:  # noqa: BLE001 — every phase failure fails the run
        traceback.print_exc(file=sys.stdout)
        return 1
    log(f"chip_smoke: lane B took {time.perf_counter() - t_lane:.1f} s")
    with open(out + ".tmp", "w") as f:
        json.dump(dict(stats=stats, seconds=seconds), f, default=str)
    import os
    os.replace(out + ".tmp", out)
    return 0


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
    parser.add_argument(
        "--lane", metavar="PHASES",
        help="run only these phases (comma-separated numbers of LANE_B) "
             "and write their results to --lane-out: the smoke run's "
             "second lane, which the run starts itself")
    parser.add_argument("--lane-out", metavar="JSON",
                        help="where --lane writes its phases' results")
    parser.add_argument("--smi", help="--lane: the card's nvidia-smi line")
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
    if args.lane:
        return run_lane(args.lane.split(","), args.lane_out, args.smi)
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
    t_run = time.perf_counter()
    seconds = {}

    def timed(number, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took = time.perf_counter() - t0
        seconds[number] = round(seconds.get(number, 0.0) + took, 1)
        log(f"phase {number} ({fn.__name__}) took {took:.1f} s")
        return out

    try:
        smi = timed("1", phase_device)
        timed("2", phase_build)
        cases = timed("3", phase_kernels)
        train_cases = timed("3", phase_training_kernels)
        bits = timed("3", check_dropout_bits)
        log(f"dropout: the keep bits of the forward, dQ and dV kernels "
            f"equal the plain hash on {bits} (query, key) pairs, fp32 and "
            f"bf16")
        block_cases = timed("3", phase_block_kernels)
        norm_cases = timed("3", phase_norm_kernels)
        bench_stats = timed("3b", phase_bench_kernels)
        lane = Lane(LANE_B, smi)
        try:
            t_lane = time.perf_counter()
            stats = {}
            for number in LANE_A:
                lane.check()
                stats[number] = timed(number, PHASES[number], smi)
            log(f"chip_smoke: lane A took "
                f"{time.perf_counter() - t_lane:.1f} s")
            lane_stats, lane_seconds = lane.join()
        finally:
            lane.stop()
        stats.update(lane_stats)
        seconds.update(lane_seconds)
    except Exception:  # noqa: BLE001 — every phase failure fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    (main_stats, engine_stats, int8_stats, train_stats, pretrain_stats,
     toolchain_stats, window_stats, feature_stats, front_stats, lora_stats,
     struct_stats, fleet_stats, moe_stats, bt_stats, rt_stats) = (
        stats[str(n)] for n in range(4, 19))
    serving_case = next(c for c in cases if c["shape"] == MAIN_SHAPE)
    window_case = next(c for c in cases if c["shape"] == WINDOW_SHAPE)
    train_case = next(c for c in train_cases
                      if c["shape"] == TRAIN_MAIN_SHAPE)
    train_counts = train_stats["launches"]
    # the three finetune.main runs of phase 8, each counted from zero
    pretrain_counts = {k: sum(run[k] for run in
                              pretrain_stats["launches"].values())
                       for k in train_counts}
    # phase 9's drives, each counted from zero
    tool_counts = toolchain_stats["launches"]
    # phase 10's drives in process, counted from zero (kernels 2-3 run only
    # in its finetune subprocess, whose counts are not read)
    window_counts = window_stats["launches"]
    # phase 11's arms, each counted from zero
    feature_counts = feature_stats["launches"]
    # phase 12's two windows: the two replicas' traffic, and the host tier
    front_counts = front_stats["launches"]
    # phase 13's parts, each counted from zero
    lora_counts = lora_stats["launches"]
    # phase 14's parts (a)-(d), each counted from zero
    struct_counts = struct_stats["launches"]
    # phase 15's replica processes, each counted over its whole life
    fleet_counts = fleet_stats["launches"]
    # phase 16's drives, each counted from zero
    moe_counts = moe_stats["launches"]
    # phase 17's entry-point runs, each counted from zero
    bert_counts = bt_stats["bert"]["launches"]
    t5_counts = bt_stats["t5"]["launches"]
    # phase 18's runs (entry points, tasks, the index), each from zero
    rt_counts = rt_stats["launches"]

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
              + tool_counts["flash_fwd_cuda"]
              + window_counts["flash_fwd_cuda"]
              + feature_counts["flash_fwd"]
              + front_counts["flash_fwd"]
              + lora_counts["flash_fwd"]
              + struct_counts["flash_fwd"]
              + fleet_counts["flash_fwd"]
              + moe_counts["flash_fwd_cuda"]
              + bert_counts["flash_fwd_cuda"]
              + t5_counts["flash_fwd_cuda"]
              + rt_counts["flash_fwd_cuda"], "fwd",
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
                  toolchain=tool_counts["flash_fwd_cuda"],
                  window_supervisor=window_counts["flash_fwd_cuda"],
                  engine_features=feature_counts["flash_fwd"],
                  front_door=front_counts["flash_fwd"],
                  lora_live=lora_counts["flash_fwd"],
                  structured_degrade=struct_counts["flash_fwd"],
                  structured_degrade_fanout=struct_stats["fanout"][
                      "flash_launches"],
                  fleet=fleet_counts["flash_fwd"],
                  moe=moe_counts["flash_fwd_cuda"],
                  pretrain_bert=bert_counts["flash_fwd_cuda"],
                  pretrain_t5=t5_counts["flash_fwd_cuda"],
                  retrieval_tasks=rt_counts["flash_fwd_cuda"],
                  fleet_by_replica={
                      name: c["flash_fwd_cuda"] for name, c in
                      fleet_stats["replica_launches"].items()}),
                   window_shape=dict(shape=WINDOW_SHAPE, **{
                       k: window_case[k] for k in (
                           "max_abs_err", "max_abs_err_lse", "ms",
                           "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}),
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
              + tool_counts["flash_bwd_dq_cuda"]
              + lora_counts["flash_bwd_dq"]
              + moe_counts["flash_bwd_dq_cuda"]
              + bert_counts["flash_bwd_dq_cuda"]
              + t5_counts["flash_bwd_dq_cuda"]
              + rt_counts["flash_bwd_dq_cuda"], "dq",
              dict(cuda_kernels=["flash_bwd_dq_wgmma_kernel (bf16: TMA "
                                 "ring, warp-specialised wgmma)",
                                 "flash_bwd_dq_fma_kernel (fp32)"],
                   launches_by_path=dict(
                       training=train_counts["flash_bwd_dq_cuda"],
                       pretrain=pretrain_counts["flash_bwd_dq_cuda"],
                       toolchain=tool_counts["flash_bwd_dq_cuda"],
                       lora_live=lora_counts["flash_bwd_dq"],
                       moe=moe_counts["flash_bwd_dq_cuda"],
                       pretrain_bert=bert_counts["flash_bwd_dq_cuda"],
                       pretrain_t5=t5_counts["flash_bwd_dq_cuda"],
                       retrieval_tasks=rt_counts["flash_bwd_dq_cuda"]))),
        entry("flash_bwd_dkv", "megatron_tpu_torch/csrc/flash_bwd.cu",
              f"{pallas}:278", train_counts["flash_bwd_dkv_cuda"]
              + pretrain_counts["flash_bwd_dkv_cuda"]
              + tool_counts["flash_bwd_dkv_cuda"]
              + lora_counts["flash_bwd_dkv"]
              + moe_counts["flash_bwd_dkv_cuda"]
              + bert_counts["flash_bwd_dkv_cuda"]
              + t5_counts["flash_bwd_dkv_cuda"]
              + rt_counts["flash_bwd_dkv_cuda"], "dkv",
              dict(cuda_kernels=["flash_bwd_dkv_wgmma_kernel (bf16: TMA "
                                 "ring, warp-specialised wgmma, q-head "
                                 "chunks)",
                                 "flash_bwd_dkv_sum_kernel (bf16, chunks "
                                 "> 1)",
                                 "flash_bwd_dkv_fma_kernel (fp32)"],
                   launches_by_path=dict(
                       training=train_counts["flash_bwd_dkv_cuda"],
                       pretrain=pretrain_counts["flash_bwd_dkv_cuda"],
                       toolchain=tool_counts["flash_bwd_dkv_cuda"],
                       lora_live=lora_counts["flash_bwd_dkv"],
                       moe=moe_counts["flash_bwd_dkv_cuda"],
                       pretrain_bert=bert_counts["flash_bwd_dkv_cuda"],
                       pretrain_t5=t5_counts["flash_bwd_dkv_cuda"],
                       retrieval_tasks=rt_counts["flash_bwd_dkv_cuda"]))),
    ]
    block_main = next(c for c in block_cases if c["shape"] == BLOCK_MAIN)
    verify = next(c for c in block_cases if c["shape"] == BLOCK_VERIFY)
    kernels.append(dict(
        name="block_attn", route="cuda",
        source="megatron_tpu_torch/csrc/block_attn.cu",
        replaces="megatron_tpu/ops/block_attention_pallas.py:82",
        launches=(engine_stats["launches"]["block_attn"]
                  + int8_stats["launches"]["block_attn"]
                  + pretrain_stats["block_launches"]
                  + tool_counts["block_attention_cuda"]
                  + feature_counts["block_attn"]
                  + front_counts["block_attn"]
                  + lora_counts["block_attn"]
                  + struct_counts["block_attn"]
                  + fleet_counts["block_attn"]
                  + moe_counts["block_attention_cuda"]),
        launches_by_path=dict(
            engine=engine_stats["launches"]["block_attn"],
            int8_engine=int8_stats["launches"]["block_attn"],
            pretrain=pretrain_stats["block_launches"],
            toolchain=tool_counts["block_attention_cuda"],
            engine_features=feature_counts["block_attn"],
            front_door=front_counts["block_attn"],
            lora_live=lora_counts["block_attn"],
            structured_degrade=struct_counts["block_attn"],
            fleet=fleet_counts["block_attn"],
            moe=moe_counts["block_attention_cuda"],
            fleet_by_replica={
                name: c["block_attention_cuda"] for name, c in
                fleet_stats["replica_launches"].items()},
            lora_live_verify_rounds=lora_stats["serving"]["verify"][
                "spec_rounds"],
            structured_degrade_verify_rounds=struct_stats["verify"][
                "spec_rounds"],
            engine_features_verify_rounds=sum(
                feature_stats["speculative"][arm]["spec_rounds"]
                for arm in ("speculative", "speculative_streams"))),
        launches_per_decode_step=engine_stats["launches_per_decode_step"],
        verify_shape=dict(shape=BLOCK_VERIFY, **{
            k: verify[k] for k in ("w", "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}),
        live_verify_check=feature_stats["speculative"]["live_verify_check"],
        live_failover_check=front_stats["failover"]["live_state_check"],
        live_adapter_checks=[lora_stats["serving"][k] for k in (
            "live_block_w1", f"live_block_w{SPEC_K + 1}")],
        live_masked_checks=[struct_stats["structured"]["live_block_w1"],
                            struct_stats["verify"]["live_block_verify"]],
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
                      pretrain=pretrain_stats, toolchain=toolchain_stats,
                      window_supervisor=window_stats,
                      engine_features=feature_stats,
                      front_door=front_stats, lora_live=lora_stats,
                      structured_degrade=struct_stats, fleet=fleet_stats,
                      moe=moe_stats, bert_t5=bt_stats,
                      retrieval_tasks=rt_stats)
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
    log(f"chip_smoke: the phases' seconds {json.dumps(seconds)}")
    log(f"chip_smoke: the whole run took {time.perf_counter() - t_run:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
