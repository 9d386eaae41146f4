"""The prefix cache and chunked prefill against plain prefills on the
engine (the port of the root tools/bench_prefix.py).

A shared-prefix workload (the system-prompt and few-shot-template shape
the prefix cache exists for) runs in three arms on the same seeded
requests:

- baseline: cache off, one prefill a prompt;
- prefix:   enable_prefix_cache: hit rate, prefix tokens reused and the
            prefill tokens really forwarded (the engine's
            prefill_forward_tokens counter);
- chunked:  the prefix cache and `prefill_chunk` (long prefills
            interleaved with decode steps).

Then a multi-turn chat pair: sessions of a shared system prompt come back
for a second turn, serially, against a whole-region pool and a block pool
(--block) of the same bytes. Whole-region retention is bounded by the slot
count (a retained chat holds a whole region and a grid row, so the LRU
thrashes); block retention pins only the blocks each history covers.
`retained_capacity_x` is the ratio of the two arms' turn-2 session hit
rates. Every arm must produce the same tokens (the tool asserts it).
With --block_native_attn the block arm reads its pool through the block
kernel. One JSON record on stdout (and into --out).

  python -m megatron_tpu_torch.tools.bench_prefix [--requests N]
      [--shared N] [--unique N] [--slots N] [--new N] [--chunk N]
      [--sessions N] [--block N] [--block_native_attn] [--model
      small|llama2-7b] [--layers N] [--dtype float32|bfloat16] [--smoke]
      [--device cpu] [--out FILE]

On a CPU (`--device cpu`) the times are a smoke of the harness; the
forward-token counts carry over.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.tools import bench_common
from megatron_tpu_torch.utils.device import resolve_device

SMOKE = dict(requests=5, shared=32, unique=8, slots=3, new=4, chunk=16,
             sessions=5, block=16, hidden=64, vocab=128, seq=128)
SAMPLED = SamplingOptions(temperature=1.0)
GREEDY = SamplingOptions(temperature=0.0)


def workload(gen, args) -> list:
    rs = np.random.RandomState(0)
    vocab = gen.cfg.vocab_size
    shared = rs.randint(1, vocab, args.shared).tolist()
    return [shared + rs.randint(1, vocab, args.unique).tolist()
            for _ in range(args.requests)]


def run_arm(gen, prompts, args, device, *, prefix: bool, chunk) -> dict:
    serving = ServingConfig(
        num_slots=args.slots, max_queue=max(len(prompts), 64),
        enable_prefix_cache=prefix, prefill_chunk=chunk, max_len=args.seq)
    with ServingEngine(gen, serving, device=device) as eng:
        # warm-up; in the cache arms it also retains the shared prefix, so
        # the burst meets a warm cache (the steady serving state)
        eng.generate(prompts[0], 2, SAMPLED, seed=0, timeout=600)
        snap0 = eng.metrics.snapshot()  # the counters leave it out
        t0 = time.monotonic()
        reqs = [eng.submit(p, args.new, SAMPLED, seed=i)
                for i, p in enumerate(prompts)]
        outs = [r.result(timeout=1800)[0] for r in reqs]
        wall = time.monotonic() - t0
        snap = eng.metrics.snapshot()

    def delta(k):
        return int(snap[k] - snap0[k])

    return {
        "enable_prefix_cache": prefix,
        "prefill_chunk": chunk,
        "outputs": outs,  # popped before the record; the arms must agree
        "prefix_hits": delta("prefix_hits"),
        "hit_rate": round(delta("prefix_hits") / max(len(prompts), 1), 3),
        "prefix_hit_tokens": delta("prefix_hit_tokens"),
        "prefill_tokens_saved": delta("prefill_tokens_saved"),
        "prefill_forward_tokens": delta("prefill_forward_tokens"),
        "prefill_chunks": delta("prefill_chunks"),
        # the percentile reservoirs hold the warm-up's sample too
        "ttft_p50_ms": round(snap["ttft_p50_ms"], 2),
        "ttft_p95_ms": round(snap["ttft_p95_ms"], 2),
        "tokens_per_s": round(delta("tokens_generated")
                              / max(wall, 1e-9), 1),
    }


def run_multiturn_arm(gen, args, block, device) -> dict:
    """Serial chat sessions (system prompt + a session opener, then each
    session returns extending its whole history). The pool's bytes are
    the same in both arms (slots x max_len); only the retention's grain
    changes with `block`."""
    rs = np.random.RandomState(7)
    vocab = gen.cfg.vocab_size
    system = rs.randint(1, vocab, args.shared).tolist()
    # a session's opener spans one whole block, so that a session's own
    # history match (system + opener) is told apart from the shared
    # system-block match every sibling session offers
    opener_len = args.block
    own_len = args.shared + opener_len
    openers = [rs.randint(1, vocab, opener_len).tolist()
               for _ in range(args.sessions)]
    followups = [rs.randint(1, vocab, opener_len).tolist()
                 for _ in range(args.sessions)]
    serving = ServingConfig(
        num_slots=args.slots, max_queue=max(args.sessions, 64),
        enable_prefix_cache=True, kv_block_size=block, max_len=args.seq,
        block_native_attn=block is not None and args.block_native_attn)
    with ServingEngine(gen, serving, device=device) as eng:
        t0 = time.monotonic()
        histories = []
        for i, opener in enumerate(openers):  # turn 1, serially
            toks, _ = eng.generate(system + opener, args.new, GREEDY,
                                   seed=i, timeout=1800)
            histories.append(toks)
        retained_after_t1 = eng.pool.retained_count()
        snap0 = eng.metrics.snapshot()
        outs, own_hits = [], 0
        for i, hist in enumerate(histories):  # turn 2, serially
            req = eng.submit(hist + followups[i], args.new, GREEDY,
                             seed=100 + i)
            outs.append(req.result(timeout=1800)[0])
            # a retained-session hit reuses the session's own history; a
            # match of only the shared system block is not counted
            own_hits += int(req.prefix_len >= own_len)
        wall = time.monotonic() - t0
        snap = eng.metrics.snapshot()
        pool_bytes = eng.pool.nbytes()

    def delta(k):
        return int(snap[k] - snap0[k])

    return {
        "kv_block_size": block,
        "pool_bytes": int(pool_bytes),
        "outputs": outs,  # popped before the record; the arms must agree
        "retained_after_turn1": int(retained_after_t1),
        "turn2_hits": delta("prefix_hits"),
        "turn2_session_hits": own_hits,
        "turn2_session_hit_rate": round(own_hits
                                        / max(args.sessions, 1), 3),
        "turn2_hit_tokens": delta("prefix_hit_tokens"),
        "prefill_tokens_saved": delta("prefill_tokens_saved"),
        "prefill_forward_tokens": delta("prefill_forward_tokens"),
        "kv_blocks_retained": snap["kv_blocks_retained"],
        "kv_bytes_wasted": snap["kv_bytes_wasted"],
        "tokens_per_s": round(delta("tokens_generated")
                              / max(wall, 1e-9), 1),
    }


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_prefix",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--smoke", action="store_true",
                   help="a tiny fixed scenario")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--shared", type=int, default=48,
                   help="shared-prefix length (a system prompt)")
    p.add_argument("--unique", type=int, default=8,
                   help="each request's own suffix length")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--new", type=int, default=16)
    p.add_argument("--chunk", type=int, default=16,
                   help="prefill_chunk of the chunked arm")
    p.add_argument("--sessions", type=int, default=8,
                   help="multi-turn arms: chat sessions (each returns for "
                        "a second turn extending its history)")
    p.add_argument("--block", type=int, default=16,
                   help="multi-turn arms: kv_block_size of the block pool "
                        "(against whole-region at the same pool bytes)")
    p.add_argument("--block_native_attn", action="store_true",
                   help="multi-turn block arm: the block kernel reads the "
                        "pool (default: the resolve/scatter bracket)")
    bench_common.add_model_args(p)
    return bench_common.parse_args(p, argv, SMOKE)


def measure(args, device) -> dict:
    """Every arm's record, each holding its "outputs": baseline, prefix,
    chunked, and the multi-turn pair."""
    gen = bench_common.build_generator(args, device, eos_id=0)
    prompts = workload(gen, args)
    return {
        "baseline": run_arm(gen, prompts, args, device, prefix=False,
                            chunk=None),
        "prefix": run_arm(gen, prompts, args, device, prefix=True,
                          chunk=None),
        "prefix_chunked": run_arm(gen, prompts, args, device, prefix=True,
                                  chunk=args.chunk),
        "multiturn_whole_region": run_multiturn_arm(gen, args, None,
                                                    device),
        "multiturn_blocks": run_multiturn_arm(gen, args, args.block,
                                              device),
    }


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    device = resolve_device(device if device is not None else args.device)
    arms = measure(args, device)
    base, pref, chnk = (arms["baseline"], arms["prefix"],
                        arms["prefix_chunked"])
    mt_whole, mt_blocks = (arms["multiturn_whole_region"],
                           arms["multiturn_blocks"])
    # the cache changes the schedule, not the semantics: every arm replays
    # the same seeded requests token for token
    want = base.pop("outputs")
    for name, arm in (("prefix", pref), ("chunked", chnk)):
        got = arm.pop("outputs")
        assert got == want, (
            f"the {name} arm diverged from the baseline at (request, "
            f"position, arm, baseline) "
            f"{bench_common.first_divergence(got, want)}")
    got, want = mt_blocks.pop("outputs"), mt_whole.pop("outputs")
    assert got == want, (
        "the multi-turn block arm diverged from the whole-region arm at "
        f"(session, position, blocks, whole) "
        f"{bench_common.first_divergence(got, want)}")

    bench_common.emit({
        "bench": "prefix_cache",
        "device": bench_common.device_kind(device),
        "requests": args.requests,
        "shared": args.shared,
        "unique": args.unique,
        "baseline": base,
        "prefix": pref,
        "prefix_chunked": chnk,
        "forward_token_reduction_x": round(
            base["prefill_forward_tokens"]
            / max(pref["prefill_forward_tokens"], 1), 2),
        "multiturn_whole_region": mt_whole,
        "multiturn_blocks": mt_blocks,
        # retained-prefix capacity at fixed pool bytes: the turn-2 session
        # hit-rate ratio (the whole-region rate floored at one hit, so the
        # ratio stays finite when it thrashes to zero)
        "retained_capacity_x": round(
            mt_blocks["turn2_session_hit_rate"]
            / max(mt_whole["turn2_session_hit_rate"],
                  1.0 / max(args.sessions, 1)), 2),
    }, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
