"""Structured output and n-best fan-out on the serving engine, two arms on
one engine (the port of the root tools/bench_structured.py).

- Constrained against free: the same seeded greedy workload run free, then
  under a grammar (serving/structured.py). The grammar costs the host an
  FSM step a token and a mask row written only when a slot's state
  changes (`mask_uploads`, the arm's seam). Every constrained completion
  must replay FSM-legal and, the budget covering the grammar's longest
  path, parse (`json.loads` for a JSON-schema grammar); the tool checks
  both. Per arm: tokens/s, TTFT and inter-token p50 of its requests, the
  decode steps, and the seconds the TokenFSM compile takes on the host.
- n=1 x 4 against n=4: four submits of one prompt seeded seed + i, then
  one fan-out of four samples seeded the same. The fan-out prefills the
  prompt once and aliases its blocks into the other samples' rows
  (`prefill_tokens_saved` / `prefix_hits`, the seam); every sample must
  equal its n=1 twin token for token.

On a CPU (`--device cpu`) the times are a smoke of the harness; the counts
and the checks are the point there. Exits 1 when a check fails.

  python -m megatron_tpu_torch.tools.bench_structured [--smoke]
      [--requests N] [--new N] [--slots N] [--device cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# a bounded grammar over the identity token table (token i is chr(i)):
# digits only, 2-6 of them, so a slot's state (and its mask row) changes
# at every token and every budget covers the longest path
GRAMMAR = {"type": "regex", "pattern": "[0-9]{2,6}"}
SCHEMA = {"type": "json_schema",
          "schema": {"type": "object",
                     "properties": {"id": {"type": "integer", "minimum": 0,
                                           "maxDigits": 2},
                                    "ok": {"type": "boolean"}}}}


def _p50(vals):
    return float(np.percentile(vals, 50)) if vals else 0.0


def _timings(reqs) -> dict:
    """TTFT and mean inter-token gap p50 over finished requests (ms)."""
    ttft = [r.ttft * 1e3 for r in reqs if r.ttft is not None]
    itl = [(r.finish_time - r.first_token_time) * 1e3
           / (len(r.generated) - 1) for r in reqs
           if len(r.generated) > 1 and r.finish_time and r.first_token_time]
    return {"ttft_p50_ms": _p50(ttft), "itl_p50_ms": _p50(itl)}


def compile_seconds(rf, vocab: int, token_strings=None, eos_id=None):
    """(the compiled TokenFSM, the host seconds its compile took)."""
    from megatron_tpu_torch.serving.structured import compile_response_format
    t0 = time.perf_counter()
    fsm = compile_response_format(rf, vocab, token_strings=token_strings,
                                  eos_id=eos_id)
    return fsm, time.perf_counter() - t0


def masked_serial_oracle(gen, prompt, max_new: int, fsm) -> list:
    """The host-driven constrained greedy oracle, independent of the
    engine: the serial route's cache (`init_kv_caches`, the dot path), the
    prompt forwarded whole, then one token a step, the argmax over the
    tokens the FSM allows at its state, until a terminal state or the
    budget. Returns the generated tokens."""
    from megatron_tpu_torch.inference.generation import init_kv_caches
    from megatron_tpu_torch.models import language_model as lm
    cfg, dev = gen.cfg, gen.device
    caches = init_kv_caches(cfg, 1, len(prompt) + max_new,
                            dtype=gen.kv_cache_dtype,
                            prefill_len=len(prompt), device=dev)
    with torch.inference_mode():
        logits, caches = lm.model_forward(
            gen.params, torch.tensor([prompt], device=dev), cfg,
            kv_caches=caches, rope=gen.rope)
        last, state, out = logits[0, -1].float(), 0, []
        while len(out) < max_new:
            row = torch.from_numpy(fsm.mask_table[state]).to(dev)
            legal = torch.full_like(last, float("-inf"))
            legal[:row.shape[0]] = torch.where(row, last[:row.shape[0]],
                                               legal[:row.shape[0]])
            if not bool(row.any()):
                break  # a dead end: the engine fails such a request
            tok = int(torch.argmax(legal))
            out.append(tok)
            state = fsm.step(state, tok)
            if fsm.is_terminal(state) or tok == gen.eos_id:
                break
            logits, caches = lm.model_forward(
                gen.params, torch.tensor([[tok]], device=dev), cfg,
                kv_caches=caches, rope=gen.rope)
            last = logits[0, 0].float()
    return out


def arm_constrained_vs_free(eng, prompts, new: int,
                            grammars=(GRAMMAR, SCHEMA),
                            token_strings=None) -> dict:
    """The free run, then a constrained run a grammar, of the same greedy
    requests on `eng` (the budget covers every grammar's longest path);
    checks legality, parsing and the upload cadence of each."""
    from megatron_tpu_torch.serving import SamplingOptions
    sampling = SamplingOptions(temperature=0.0)
    vocab = eng.cfg.vocab_size
    compiled = [compile_seconds(g, vocab, token_strings, eng.gen.eos_id)
                for g in grammars]
    budget = max([new] + [f.max_path_len or 0 for f, _ in compiled])

    def run(rf):
        keys = ("tokens_generated", "decode_steps", "mask_uploads",
                "structured_requests", "grammar_dead_ends")
        snap0 = eng.metrics.snapshot()
        t0 = time.monotonic()
        reqs = [eng.submit(p, budget, sampling, seed=i, response_format=rf)
                for i, p in enumerate(prompts)]
        outs = [r.result(timeout=600)[0] for r in reqs]
        wall = time.monotonic() - t0
        snap = eng.metrics.snapshot()
        d = {k: int(snap[k] - snap0[k]) for k in keys}
        d.update(_timings(reqs), wall_s=wall,
                 tok_s=d["tokens_generated"] / max(wall, 1e-9))
        return d, [o[len(p):] for o, p in zip(outs, prompts)]

    free, _ = run(None)
    out = {"budget": budget, "free": free, "ok": free["mask_uploads"] == 0}
    chars = token_strings or [chr(i) for i in range(vocab)]
    for grammar, (fsm, compile_s) in zip(grammars, compiled):
        con, toks = run(grammar)
        legal = all(fsm.replay(t)[0] for t in toks)
        parsed = all(fsm.final_text_valid(t) for t in toks)
        if grammar["type"] == "json_schema" and parsed:
            for t in toks:
                json.loads("".join(chars[i] for i in t))
        # uploads track state changes (at most one a slot activation and
        # one a committed token, with the window that clears the previous
        # grammar's rows), never one a step a slot
        transitions = sum(len(t) for t in toks) + len(toks) + 1
        cadence = 0 < con["mask_uploads"] <= transitions
        out[grammar["type"]] = dict(
            con, grammar=grammar.get("pattern", grammar.get("schema")),
            fsm_states=int(fsm.mask_table.shape[0]),
            fsm_compile_s=compile_s, outputs_legal=legal,
            outputs_parse=parsed, upload_cadence_ok=cadence,
            overhead_x=con["wall_s"] / max(free["wall_s"], 1e-9),
            completions=["".join(chars[i] for i in t) for t in toks[:2]])
        out["ok"] = (out["ok"] and legal and parsed and cadence
                     and con["grammar_dead_ends"] == 0)
    return out


def arm_fanout(eng, prompt, new: int, n: int = 4, seed: int = 7,
               sampling=None) -> dict:
    """n submits of one prompt seeded seed + i, one after another, then one
    fan-out of n samples; each sample must equal its n=1 twin. With the
    prefix cache the later n=1 submits hit the first one's retained
    prompt, as the fan-out's siblings alias its leader's: the prefill work
    is alike, the fan-out decodes its samples at once."""
    from megatron_tpu_torch.serving import SamplingOptions
    sampling = sampling or SamplingOptions(temperature=0.8, top_k=8)
    keys = ("prefill_forward_tokens", "prefill_tokens_saved", "prefix_hits",
            "fanout_requests", "fanout_samples", "tokens_generated")

    def delta(snap0):
        snap = eng.metrics.snapshot()
        return {k: int(snap[k] - snap0[k]) for k in keys}

    snap0 = eng.metrics.snapshot()
    t0 = time.monotonic()
    # one after another: concurrent submits would share the prefix cache
    # and blur the prefill comparison
    serial_out = [eng.submit(prompt, new, sampling, seed=seed + i
                             ).result(timeout=600)[0] for i in range(n)]
    serial_wall = time.monotonic() - t0
    serial_d = delta(snap0)
    snap0 = eng.metrics.snapshot()
    t0 = time.monotonic()
    agg = eng.submit(prompt, new, sampling, seed=seed, n=n, best_of=n)
    toks_list, _ = agg.result(timeout=600)
    fan_wall = time.monotonic() - t0
    fan_d = delta(snap0)
    got = [c.prompt + c.generated for c in agg.children]
    exact = got == serial_out
    ranked = sorted(map(tuple, toks_list)) == sorted(map(tuple, got))
    return {
        "n": n,
        "serial": dict(serial_d, wall_s=serial_wall),
        "fanout": dict(fan_d, wall_s=fan_wall),
        "samples_token_exact": exact,
        "prefill_reduction_x": (max(serial_d["prefill_forward_tokens"], 1)
                                / max(fan_d["prefill_forward_tokens"], 1)),
        "fanout_speedup_x": serial_wall / max(fan_wall, 1e-9),
        "ok": (exact and ranked and fan_d["fanout_requests"] == 1
               and fan_d["fanout_samples"] == n
               and fan_d["prefill_tokens_saved"] > 0
               and fan_d["prefill_forward_tokens"] < n * len(prompt)),
    }


def main(argv=None, *, device=None) -> int:
    from megatron_tpu_torch.config import ModelConfig, ServingConfig
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
    from megatron_tpu_torch.utils.device import resolve_device
    p = argparse.ArgumentParser("bench_structured", description=__doc__)
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes for the CPU")
    p.add_argument("--device", default=None,
                   help="cpu runs without a card (the default is the card)")
    p.add_argument("--requests", type=int, default=8)
    # not a multiple of the 16-token block: a whole-prompt hit caps at
    # plen - 1, and a block-aligned prompt would alias no whole block
    p.add_argument("--prompt", type=int, default=24)
    p.add_argument("--new", type=int, default=24)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--speculative_k", type=int, default=0)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seq", type=int, default=256)
    args = p.parse_args(argv)
    if args.smoke:
        args.requests, args.new = min(args.requests, 4), min(args.new, 10)
        args.hidden, args.vocab, args.seq = 64, 128, 128
    device = resolve_device(device if device is not None else args.device)
    cfg = ModelConfig(
        num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads,
        num_kv_heads=max(args.heads // 2, 1), vocab_size=args.vocab,
        seq_length=args.seq, max_position_embeddings=args.seq,
        make_vocab_size_divisible_by=64, attention_impl="flash",
        compute_dtype="float32").derived()
    # eos -1: free rows decode exactly the budget, so both arms decode
    # comparable volumes; an fp32 cache keeps the fan-out samples equal to
    # their twins whatever the batch
    gen = Generator(LanguageModel(cfg, device=device, seed=0), cfg,
                    eos_id=-1, pad_id=0, device=device,
                    kv_cache_dtype=torch.float32)
    eng = ServingEngine(gen, ServingConfig(
        num_slots=args.slots, max_queue=max(4 * args.requests, 64),
        max_len=args.seq, kv_block_size=16, block_native_attn=True,
        enable_prefix_cache=True,
        speculative_k=args.speculative_k).validate(cfg), device=device)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, args.vocab, args.prompt).tolist()
               for _ in range(args.requests)]
    try:
        eng.generate(prompts[0][:8], 2, SamplingOptions(temperature=0.0))
        constrained = arm_constrained_vs_free(eng, prompts, args.new)
        # a prompt the engine has not cached: both arms start from a miss
        fanout = arm_fanout(eng, rs.randint(1, args.vocab,
                                            args.prompt).tolist(),
                            args.new, n=min(4, args.slots))
    finally:
        eng.close()
    record = {
        "bench": "structured_nbest",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "requests": args.requests, "new_tokens": args.new,
        "speculative_k": args.speculative_k,
        "constrained_vs_free": constrained,
        "n1_vs_n4": fanout,
        "ok": constrained["ok"] and fanout["ok"],
    }
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
