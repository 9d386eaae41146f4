"""The resolve/scatter bracket against block-native attention on the engine
(the port of the root tools/bench_block_attn.py).

With `kv_block_size` B and `block_native_attn` off, every decode or verify
step brackets its attention with kv_pool.resolve_view/scatter_view: the
whole [L, S, cap, nkv, hd] view gathered out of the block arena and
scattered back, O(pool bytes) of memory traffic a step. With it on, the
block kernel (csrc/block_attn.cu) reads the arena through the block map
and the step's append writes only the touched block. The same seeded
greedy decode-heavy workload runs through both arms at every block size
and pool dtype asked for:

- bracket arm: kv_block_size=B, block_native_attn off;
- kernel arm:  kv_block_size=B, block_native_attn on.

The arms must agree token for token (the kernel changes the data path, not
the semantics): the tool asserts it. Per combination it reports decode
tokens/s, the speedup, and the bracket's gather bytes a step (the engine's
kv_gather_bytes_per_step gauge, 0 in the kernel arm). One JSON record on
stdout (and into --out).

  python -m megatron_tpu_torch.tools.bench_block_attn [--blocks 16,64,256]
      [--dtypes bfloat16,int8] [--requests N] [--new N] [--model
      small|llama2-7b] [--layers N] [--dtype float32|bfloat16] [--smoke]
      [--device cpu] [--out FILE]

On a CPU (`--device cpu`) the times are a smoke of the harness.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.tools import bench_common
from megatron_tpu_torch.utils.device import resolve_device

SMOKE = dict(blocks="16", dtypes="bfloat16", requests=4, new=8, max_len=128,
             hidden=64, vocab=128)
GREEDY = SamplingOptions(temperature=0.0)  # greedy: the arms agree


def run_arm(gen, prompts, args, block: int, dtype: str, kernel: bool,
            device) -> dict:
    serving = ServingConfig(num_slots=args.slots,
                            max_queue=max(len(prompts), 64),
                            max_len=args.max_len, kv_dtype=dtype,
                            kv_block_size=block, block_native_attn=kernel)
    with ServingEngine(gen, serving, device=device) as eng:
        if eng._kernel_on != kernel:
            raise ValueError(
                "arm premise broken: block size >= cap degraded the pool "
                "to whole-region; shrink --blocks or grow --max_len")
        eng.generate(prompts[0], 2, GREEDY, seed=0, timeout=600)  # warm-up
        snap0 = eng.metrics.snapshot()
        t0 = time.monotonic()
        reqs = [eng.submit(p, args.new, GREEDY, seed=i)
                for i, p in enumerate(prompts)]
        outs = [r.result(timeout=1800)[0] for r in reqs]
        wall = time.monotonic() - t0
        snap = eng.metrics.snapshot()
    toks = int(snap["tokens_generated"] - snap0["tokens_generated"])
    return {
        "attn_path": "block_native" if kernel else "gather_scatter",
        "outputs": outs,  # popped before the record; the arms must agree
        "tokens_generated": toks,
        "decode_steps": int(snap["decode_steps"] - snap0["decode_steps"]),
        # the bytes the resolve/scatter bracket moved a decode step (a
        # gauge; 0 in the kernel arm)
        "kv_gather_bytes_per_step": int(snap["kv_gather_bytes_per_step"]),
        "kv_attn_path": int(snap["kv_attn_path"]),
        "tok_s": round(toks / max(wall, 1e-9), 1),
        "wall_s": round(wall, 3),
    }


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_block_attn",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--smoke", action="store_true",
                   help="one tiny combination (B 16, a bf16 pool)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt", type=int, default=16)
    p.add_argument("--new", type=int, default=32,
                   help="decode-heavy: tokens generated a request")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max_len", type=int, default=512,
                   help="slot capacity; every --blocks entry must divide "
                        "it strictly (B == cap degrades to whole-region)")
    p.add_argument("--blocks", type=str, default="16,64,256",
                   help="comma-separated kv_block_size arms")
    p.add_argument("--dtypes", type=str, default="bfloat16,int8",
                   help="comma-separated pool dtypes")
    bench_common.add_model_args(p, seq=None)
    args = bench_common.parse_args(p, argv, SMOKE)
    if args.seq is None:
        args.seq = args.max_len
    return args


def measure(args, device) -> list:
    """Both arms at every combination: [(block, pool dtype, bracket arm,
    kernel arm)], each arm's record holding its "outputs"."""
    # eos_id -1: no early EOS, so both arms decode the same token volume
    gen = bench_common.build_generator(args, device, eos_id=-1)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, args.vocab, args.prompt).tolist()
               for _ in range(args.requests)]
    out = []
    for dtype in [d for d in args.dtypes.split(",") if d.strip()]:
        for block in [int(b) for b in args.blocks.split(",") if b.strip()]:
            if block >= args.max_len:
                print(f"bench_block_attn: skipping B={block} >= cap "
                      f"{args.max_len} (whole-region degrade, no A/B)",
                      file=sys.stderr)
                continue
            out.append((block, dtype,
                        run_arm(gen, prompts, args, block, dtype, False,
                                device),
                        run_arm(gen, prompts, args, block, dtype, True,
                                device)))
    return out


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    device = resolve_device(device if device is not None else args.device)
    combos = []
    for block, dtype, bracket, kernel in measure(args, device):
        # the kernel changes the data path, not the semantics: greedy arms
        # replay each other exactly
        got, want = kernel.pop("outputs"), bracket.pop("outputs")
        assert got == want, (
            f"B={block} dtype={dtype}: block-native arm diverged from the "
            "gather/scatter arm at (request, position, kernel, bracket) "
            f"{bench_common.first_divergence(got, want)}")
        assert kernel["kv_gather_bytes_per_step"] == 0, (
            "kernel arm still paid a resolve/scatter bracket")
        assert bracket["kv_gather_bytes_per_step"] > 0
        combos.append({
            "kv_block_size": block,
            "kv_dtype": dtype,
            "bracket": bracket,
            "kernel": kernel,
            "speedup_x": round(kernel["tok_s"]
                               / max(bracket["tok_s"], 1e-9), 2),
            # the overhead traffic the kernel removes
            "bracket_overhead_bytes_per_step":
                bracket["kv_gather_bytes_per_step"],
        })

    bench_common.emit({
        "bench": "block_native_attn",
        "device": bench_common.device_kind(device),
        "requests": args.requests,
        "new_tokens": args.new,
        "max_len": args.max_len,
        "greedy_arms_token_exact": True,  # the asserts above
        "combos": combos,
        "best_speedup_x": max((c["speedup_x"] for c in combos),
                              default=1.0),
        "note": ("a CPU run's times are a smoke of the harness; on the "
                 "card the bracket's bytes a step are overhead on top of "
                 "the attention's own KV stream"),
    }, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
