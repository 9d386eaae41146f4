"""What the bench tools share: the engine tools' (bench_block_attn,
bench_spec, bench_prefix, bench_sync) model flags, model and device name,
and the training tools' (bench_remat, bench_32k) timed steps
(`time_train_steps`).

`--model small` is the reference tools' model at the flags' widths (kv
heads half the query heads, positions `--seq`, the vocabulary padded to a
multiple of 64); `--model llama2-7b` is Llama-2-7B's widths at `--layers`
layers. `--dtype` is the weights', the compute's and the KV cache's type:
float32 (the default) keeps the tools' token-for-token assertions exact
across attention paths; bfloat16 is the serving layout the card's times
are taken in. Weights are random, from seed 0.
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from megatron_tpu_torch.config import ModelConfig, llama2_config
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.models.language_model import LanguageModel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_model_args(p: argparse.ArgumentParser, *, seq: int = 256) -> None:
    p.add_argument("--model", default="small",
                   choices=("small", "llama2-7b"),
                   help="small: --hidden/--heads/--vocab/--seq widths; "
                        "llama2-7b: Llama-2-7B's widths at --layers")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seq", type=int, default=seq,
                   help="max_position_embeddings")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                   help="weights, compute and KV cache")
    p.add_argument("--device", default=None,
                   help="cpu runs without a card (the default is the card)")


def parse_args(p: argparse.ArgumentParser, argv, smoke: dict):
    """The flags, with `smoke`'s values as the defaults under --smoke (a
    flag given explicitly still wins)."""
    args = p.parse_args(argv)
    if args.smoke:
        p.set_defaults(**smoke)
        args = p.parse_args(argv)
    return args


def model_config(args) -> ModelConfig:
    """The flags' model."""
    if args.model == "llama2-7b":
        return llama2_config("7b", num_layers=args.layers,
                             compute_dtype=args.dtype,
                             seq_length=min(args.seq, 4096),
                             max_position_embeddings=args.seq)
    return ModelConfig(
        num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads,
        num_kv_heads=max(args.heads // 2, 1), vocab_size=args.vocab,
        seq_length=args.seq, max_position_embeddings=args.seq,
        make_vocab_size_divisible_by=64, attention_impl="flash",
        compute_dtype=args.dtype).derived()


def build_generator(args, device: torch.device, *, eos_id: int,
                    pad_id: int = 0) -> Generator:
    cfg = model_config(args)
    dtype = DTYPES[args.dtype]
    model = LanguageModel(cfg, device=device, dtype=dtype, seed=0)
    return Generator(model, cfg, eos_id=eos_id, pad_id=pad_id,
                     kv_cache_dtype=dtype, device=device)


def device_kind(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def first_divergence(got: list, want: list):
    """(request, position, got's token, want's token) where two arms'
    outputs first part, or None when they agree."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            return (i, j, g[j] if j < len(g) else None,
                    w[j] if j < len(w) else None)
    return None if len(got) == len(want) else (min(len(got), len(want)),
                                                0, None, None)


def emit(record: dict, out) -> None:
    """The record as one JSON line on stdout (and into `out`)."""
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


def time_train_steps(cfg, device: torch.device, *, warmup: int, iters: int,
                     seed: int = 0) -> dict:
    """`warmup` then `iters` timed make_train_step steps of `cfg` (random
    weights from `seed`, random tokens, every position in the loss) on
    `device`: the step's milliseconds and tokens a second by the host clock
    around work that ends in a synchronise, the last loss, the parameter
    count, the peak of allocated device memory over the steps (None on the
    CPU) and the flash kernels' launches a timed step (0 on the CPU, where
    the plain versions run). The state is dropped before it returns."""
    from megatron_tpu_torch.ops import flash_attention_cuda
    from megatron_tpu_torch.training.train_step import (init_train_state,
                                                        make_train_step)
    cuda = device.type == "cuda"
    tr, m = cfg.training, cfg.model
    n_micro = cfg.num_microbatches
    state = init_train_state(cfg, seed=seed, device=device)
    step = make_train_step(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, m.vocab_size,
                           (n_micro, tr.micro_batch_size, m.seq_length + 1),
                           generator=gen, device=device)
    batch = {"tokens": tokens}
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        for _ in range(max(warmup, 1)):
            state, metrics = step(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        before = flash_attention_cuda.launch_counts()
        t0 = time.perf_counter()
        for _ in range(max(iters, 1)):
            state, metrics = step(state, batch)
        loss = float(metrics["lm_loss"])   # a host read: the sync
        if cuda:
            torch.cuda.synchronize(device)
        dt = (time.perf_counter() - t0) / max(iters, 1)
        after = flash_attention_cuda.launch_counts()
        return {
            "step_ms": dt * 1e3,
            "tok_s": n_micro * tr.micro_batch_size * m.seq_length / dt,
            "loss": loss,
            "params": sum(p.numel() for p in state.params.parameters()),
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if cuda else None),
            "launches_per_step": {k: (after[k] - before[k]) / max(iters, 1)
                                  for k in after},
        }
    finally:
        state = step = batch = tokens = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
