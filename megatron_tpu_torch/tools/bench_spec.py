"""Speculative decoding against the plain decode step on the engine (the
port of the root tools/bench_spec.py).

A decode step reads every weight and the KV slice to commit one token a
slot. `speculative_k` verifies k self-drafted tokens a slot in one
[slots, k+1]-token window (the block kernel at w = k+1), so the tokens
committed a weight read rise toward 1 + k * acceptance. The same seeded
decode-heavy workload (repeating motifs, which the n-gram drafter drafts
from) runs through:

- baseline: speculative_k=0;
- one arm per k in --ks (default 2,4,8).

Every arm runs greedy and must equal the baseline token for token (the
tool asserts it). Per arm it reports the acceptance rate, the tokens
committed a verify round, tokens/s and the speedup, beside the decode
roofline on an H100: the bytes a step reads (weights and the mean
context's KV) at 3.35 TB/s. One JSON record on stdout (and into --out).

  python -m megatron_tpu_torch.tools.bench_spec [--requests N] [--new N]
      [--slots N] [--ks 2,4,8] [--model small|llama2-7b] [--layers N]
      [--dtype float32|bfloat16] [--smoke] [--device cpu] [--out FILE]

On a CPU (`--device cpu`) the times are a smoke of the harness; the
acceptance rate and the tokens a round carry over.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.tools import bench_common
from megatron_tpu_torch.tools.bench_decode import HBM_BW
from megatron_tpu_torch.utils.device import resolve_device

SMOKE = dict(requests=4, prompt=12, new=16, slots=3, ks="2,4", hidden=64,
             vocab=128, seq=128)
GREEDY = SamplingOptions(temperature=0.0)  # greedy: the arms must agree


def workload(args) -> list:
    """Decode-heavy prompts: a unique head of 4 tokens, then a motif of 2-4
    tokens repeated (the traffic self-drafting pays off on: code,
    templates, multi-turn chat)."""
    rs = np.random.RandomState(0)
    prompts = []
    for _ in range(args.requests):
        motif = rs.randint(1, args.vocab, rs.randint(2, 5)).tolist()
        head = rs.randint(1, args.vocab, 4).tolist()
        prompts.append((head + motif * 6)[:args.prompt])
    return prompts


def run_arm(gen, prompts, args, k: int, device) -> dict:
    serving = ServingConfig(num_slots=args.slots,
                            max_queue=max(len(prompts), 64),
                            speculative_k=k, max_len=args.seq,
                            kv_block_size=args.block,
                            block_native_attn=args.block is not None)
    with ServingEngine(gen, serving, device=device) as eng:
        eng.generate(prompts[0], 2, GREEDY, seed=0, timeout=600)  # warm-up
        snap0 = eng.metrics.snapshot()  # the counters leave it out
        t0 = time.monotonic()
        reqs = [eng.submit(p, args.new, GREEDY, seed=i)
                for i, p in enumerate(prompts)]
        outs = [r.result(timeout=1800)[0] for r in reqs]
        wall = time.monotonic() - t0
        snap = eng.metrics.snapshot()

    def delta(key):
        return int(snap[key] - snap0[key])

    drafts = delta("draft_tokens")
    accepted = delta("accepted_tokens")
    toks = delta("tokens_generated")
    return {
        "speculative_k": k,
        "outputs": outs,  # popped before the record; the arms must agree
        "tokens_generated": toks,
        "spec_rounds": delta("spec_rounds"),
        "spec_fallback_steps": delta("spec_fallback_steps"),
        "draft_tokens": drafts,
        "accepted_tokens": accepted,
        "acceptance_rate": round(accepted / drafts, 3) if drafts else 0.0,
        # tokens a slot commits a verify round: the sample plus k times the
        # acceptance (a plain decode step commits 1)
        "tokens_per_round": (1.0 if k == 0 or not drafts else
                             round(1 + k * accepted / drafts, 3)),
        "accepted_tok_s": round(toks / max(wall, 1e-9), 1),
        "wall_s": round(wall, 3),
    }


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_spec",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--smoke", action="store_true",
                   help="a tiny fixed scenario")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt", type=int, default=16)
    p.add_argument("--new", type=int, default=48,
                   help="decode-heavy: tokens generated a request")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--ks", type=str, default="2,4,8",
                   help="comma-separated speculative_k arms (0, the "
                        "baseline, always runs)")
    p.add_argument("--block", type=int, default=None,
                   help="kv_block_size with the block kernel (default: "
                        "whole-region slots)")
    bench_common.add_model_args(p)
    return bench_common.parse_args(p, argv, SMOKE)


def measure(args, device) -> tuple:
    """(the Generator, the baseline arm, the k arms), each arm's record
    holding its "outputs"."""
    # eos_id -1: no early EOS, so the arms decode the same token volume
    gen = bench_common.build_generator(args, device, eos_id=-1)
    prompts = workload(args)
    base = run_arm(gen, prompts, args, 0, device)
    arms = [run_arm(gen, prompts, args, int(k), device)
            for k in args.ks.split(",") if k.strip()]
    return gen, base, arms


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    device = resolve_device(device if device is not None else args.device)
    gen, base, arms = measure(args, device)
    base_out = base.pop("outputs")
    for arm in arms:
        # speculation changes the schedule, not the semantics: greedy arms
        # replay the baseline token for token
        got = arm.pop("outputs")
        assert got == base_out, (
            f"k={arm['speculative_k']} arm diverged from the baseline at "
            "(request, position, arm, baseline) "
            f"{bench_common.first_divergence(got, base_out)}")
        arm["speedup_x"] = round(arm["accepted_tok_s"]
                                 / max(base["accepted_tok_s"], 1e-9), 2)

    kind = bench_common.device_kind(device)
    bench_common.emit({
        "bench": "speculative_decode",
        "device": kind,
        "requests": args.requests,
        "new_tokens": args.new,
        "greedy_arms_token_exact": True,  # the asserts above
        "baseline": base,
        "arms": arms,
        "best_speedup_x": max((a["speedup_x"] for a in arms), default=1.0),
        "best_acceptance_rate": max((a["acceptance_rate"] for a in arms),
                                    default=0.0),
        "roofline": roofline(gen, args, kind),
    }, args.out)
    return 0


def roofline(gen, args, kind: str) -> dict:
    """The bytes a decode step reads (the weights and the KV slice of the
    mean context, in their own types) and the one-token rate they allow on
    a card of a known memory rate."""
    bw = next((v for k, v in HBM_BW.items() if k in kind), None)
    cfg = gen.cfg
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in gen.params.parameters())
    ctx = args.prompt + args.new / 2
    cache_bytes = (2 * cfg.num_layers * args.slots * ctx * cfg.num_kv_heads
                   * cfg.kv_channels * gen.kv_cache_dtype.itemsize)
    step_bytes = weight_bytes + cache_bytes
    return {
        "step_bytes": int(step_bytes),
        "ideal_tok_s": (round(args.slots * bw / step_bytes, 1)
                        if bw else None),
        "note": ("ideal accepted-tok/s ~= ideal_tok_s * tokens_per_round "
                 "on the memory-bound path"),
    }


if __name__ == "__main__":
    raise SystemExit(main())
