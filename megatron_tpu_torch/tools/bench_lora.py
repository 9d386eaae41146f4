"""Multi-tenant LoRA serving on the engine, three arms (the port of the root
tools/bench_lora.py).

The same seeded greedy workload runs through:

- base: no adapter bank (`adapter_slots=0`, today's engine);
- one_adapter: every request under one adapter;
- mixed_N: requests round-robin over the base model and N adapters in one
  slot grid (one gather and two rank-r products a projection a row).

Every row of every arm is held token for token against its own adapter's
serial oracle: a plain `Generator` over the base weights with that
adapter's A B (alpha/rank) merged in (training/lora.py `merge_lora`), in
fp32, where factored and merged agree. Per arm it reports tokens/s, TTFT
and inter-token p50 (the engine's reservoirs), the card's peak memory, and
the bytes the adapter gather reads each decode step (every slot's A/B
slices of all 8 factors and layers, from the fp32 bank).

  python -m megatron_tpu_torch.tools.bench_lora [--requests N] [--new N]
      [--adapters N] [--rank R] [--slots N] [--smoke] [--device cpu]
      [--out FILE]

On a CPU (`--device cpu`) the times are a smoke of the harness; the
exactness check is the point there. Exits 1 when a row disagrees.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig, ServingConfig
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.serving.adapters import (adapter_bank_nbytes,
                                                 adapter_factor_shapes,
                                                 random_adapter_factors)
from megatron_tpu_torch.training.lora import merge_lora
from megatron_tpu_torch.utils.device import resolve_device

SMOKE = dict(requests=6, new=8, adapters=3, hidden=64, vocab=128, seq=128,
             prompt=8, slots=2)
GREEDY = SamplingOptions(temperature=0.0)


def gather_bytes_per_step(cfg: ModelConfig, rank: int, slots: int) -> int:
    """Bytes one decode step's adapter gather reads: each slot's fp32 A/B
    slices of every factor and layer."""
    per_row = sum(int(np.prod(s))
                  for s in adapter_factor_shapes(cfg, rank).values()) * 4
    return per_row * slots


def assignments(ids, n: int) -> dict:
    """The three arms' per-request adapter ids (None: the base model)."""
    return {"base": [None] * n,
            "one_adapter": [ids[0]] * n,
            f"mixed_{len(ids)}": [([None] + list(ids))[i % (len(ids) + 1)]
                                  for i in range(n)]}


def run_arm(gen: Generator, prompts, assignment, adapters: dict, *,
            rank: int, alpha: float, new: int, serving: dict,
            device) -> dict:
    """One arm on a fresh engine: register its adapters, warm up, submit
    every request at once and wait. Returns the arm's record, with the
    outputs under "outputs"."""
    ids = sorted({a for a in assignment if a is not None})
    cfg = ServingConfig(**dict(serving, max_queue=max(len(prompts), 64),
                               adapter_slots=(serving.get("adapter_slots")
                                              or len(ids)) if ids else 0,
                               adapter_rank=rank))
    cuda = device.type == "cuda"
    with ServingEngine(gen, cfg, device=device) as eng:
        for aid in ids:
            eng.register_adapter(aid, factors=adapters[aid], rank=rank,
                                 alpha=alpha)
        eng.generate(prompts[0], 2, GREEDY, seed=0, timeout=600,
                     adapter_id=ids[0] if ids else None)  # kernel builds
        eng.metrics = type(eng.metrics)()  # the timed run's reservoirs
        if eng.adapters is not None:
            eng.adapters.metrics = eng.metrics
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, new, GREEDY, seed=i, adapter_id=a)
                for i, (p, a) in enumerate(zip(prompts, assignment))]
        outs = [r.result(timeout=1800)[0] for r in reqs]
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if cuda else 0.0)
    toks = int(snap["tokens_generated"])
    return {"arm": None, "adapters": len(ids), "outputs": outs,
            "tokens_generated": toks, "tok_s": toks / max(wall, 1e-9),
            "wall_s": wall, "ttft_p50_ms": snap["ttft_p50_ms"],
            "itl_p50_ms": snap["itl_p50_ms"], "peak_gib": peak,
            "adapter_loads": int(snap["adapter_loads"]),
            "active_adapters": int(snap["active_adapters"])}


def oracle_outputs(model, cfg: ModelConfig, prompts, new: int,
                   adapters: dict, assignment, *, rank: int, alpha: float,
                   device) -> list:
    """Each request's tokens from its adapter's merged-weights serial
    Generator (the base weights for None)."""
    gens, want = {}, []
    for p, aid in zip(prompts, assignment):
        if aid not in gens:
            params = (model if aid is None else
                      merge_lora(model, adapters[aid], cfg, rank, alpha))
            gens[aid] = Generator(params, cfg, eos_id=-1, pad_id=0,
                                  kv_cache_dtype=torch.float32,
                                  device=device)
        t, lens, _ = gens[aid].generate(
            [p], new, sampling=SamplingParams(temperature=0.0))
        want.append(t[0, :lens[0]].tolist())
    return want


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser("bench_lora", description=__doc__)
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--smoke", action="store_true",
                   help="a tiny fixed scenario")
    p.add_argument("--device", default=None,
                   help="cpu runs without a card (the default is the card)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt", type=int, default=16)
    p.add_argument("--new", type=int, default=32)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--adapters", type=int, default=8)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--alpha", type=float, default=8.0)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seq", type=int, default=256)
    args = p.parse_args(argv)
    if args.smoke:
        for k, v in SMOKE.items():
            setattr(args, k, v)
    device = resolve_device(device if device is not None else args.device)

    cfg = ModelConfig(
        num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads,
        num_kv_heads=max(args.heads // 2, 1), vocab_size=args.vocab,
        seq_length=args.seq, max_position_embeddings=args.seq,
        make_vocab_size_divisible_by=64, attention_impl="flash",
        # fp32: rows are held against merged-weights oracles, which agree
        # with the factored delta token for token only in fp32
        compute_dtype="float32", params_dtype="float32").derived()
    model = LanguageModel(cfg, device=device, seed=0)
    gen = Generator(model, cfg, eos_id=-1, pad_id=0,
                    kv_cache_dtype=torch.float32, device=device)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, args.vocab, args.prompt).tolist()
               for _ in range(args.requests)]
    adapters = {f"tenant-{a}": random_adapter_factors(cfg, args.rank,
                                                      100 + a)
                for a in range(args.adapters)}
    serving = dict(num_slots=args.slots, kv_block_size=16,
                   block_native_attn=True, max_len=args.seq)
    arms, exact = [], True
    for label, assignment in assignments(sorted(adapters),
                                         len(prompts)).items():
        arm = run_arm(gen, prompts, assignment, adapters, rank=args.rank,
                      alpha=args.alpha, new=args.new, serving=serving,
                      device=device)
        arm["arm"] = label
        want = oracle_outputs(model, cfg, prompts, args.new, adapters,
                              assignment, rank=args.rank, alpha=args.alpha,
                              device=device)
        arm["rows_exact"] = arm.pop("outputs") == want
        exact &= arm["rows_exact"]
        arms.append(arm)
    record = {
        "bench": "lora_adapters", "device": str(device),
        "requests": args.requests, "new_tokens": args.new,
        "rank": args.rank, "alpha": args.alpha,
        "rows_token_exact_vs_merged_oracle": exact,
        "adapter_gather_bytes_per_step": gather_bytes_per_step(
            cfg, args.rank, args.slots),
        "bank_nbytes": adapter_bank_nbytes(cfg, args.adapters, args.rank),
        "arms": arms,
    }
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())
