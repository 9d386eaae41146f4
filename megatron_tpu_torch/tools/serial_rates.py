"""Serial-route rates on one GPU: prefill latency and batch-1 decode rate.

Builds Llama-2-7B at full width and depth (random bf16 weights, seed 0) and
times `Generator.generate` on one 512-token prompt as `chip_smoke.py`'s serial
phase does, with more repeats: prefill is the best of five 1-token
generates, and the decode rate is 32 tokens over the best of five 33-token
generates less the prefill. It does so greedy, and sampled at temperature 0.8 with the filters
off and with top_k 40 / top_p 0.9. Prints one JSON line with the card and
the path of the package it imported, so two checkouts can be compared in one
call:

    python -m megatron_tpu_torch.tools.serial_rates
    PYTHONPATH=<other checkout> python <this file>
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

import megatron_tpu_torch
from megatron_tpu_torch.config import llama2_config
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models.language_model import LanguageModel

PROMPT_LEN = 512
NEW = 32
REPEATS = 5
MODES = {"greedy": SamplingParams(temperature=0.0),
         "sampled_filters_off": SamplingParams(temperature=0.8),
         "sampled_top_k_top_p": SamplingParams(0.8, 40, 0.9)}


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = llama2_config("7b")
    model = LanguageModel(cfg, dtype=torch.bfloat16, seed=0)
    gen = Generator(model, cfg, eos_id=-1, pad_id=0)
    ids = torch.randint(3, cfg.vocab_size, (PROMPT_LEN,),
                        generator=torch.Generator().manual_seed(0)).tolist()

    def timed(n, sp):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen.generate([ids], n, sampling=sp, seed=7)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    rec = dict(card=card, package=megatron_tpu_torch.__file__)
    timed(2, MODES["sampled_top_k_top_p"])  # warm-up: kernel build
    for name, sp in MODES.items():
        prefill_s = min(timed(1, sp) for _ in range(REPEATS))
        full_s = min(timed(NEW + 1, sp) for _ in range(REPEATS))
        rec[name] = dict(prefill_ms=prefill_s * 1e3,
                         decode_tokens_per_s=NEW / (full_s - prefill_s))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
