"""Measure what the head costs the pipeline's last stage, on one card (the
port of the root tools/bench_head.py).

It times (a) one transformer layer's forward and backward and (b) the
head's (final norm, the [b, s, h] x [h, V] logits, cross-entropy), at
Llama-2-7B's widths (h 4096, 32 heads, ffn 11008, V 32000), through the
same code the schedule runs: parallel/pipeline.py `gpt_1f1b_fns`' chunk
(a one-layer stack) and head loss. Both are plain forward + backward, no
recompute.

The port's schedule runs the head on the last stage alone (the
reference's runs it on every stage, masked, because its one SPMD program
must be branch-free). So its cost is the last stage's extra work beside
its Lc = L/pp layers, which sets the pace of every tick:

    overhead(pp, L) = t_head / (Lc * t_layer + t_head)

The reference's tool reports the masked head's tax over all stages
instead, (pp-1) * t_head / (L * t_layer + pp * t_head): pp-1 of the pp
heads it runs a tick are wasted. This tool prints both, at the BASELINE
configurations' (pp, L) points; the first is the one that applies here.
The last line is one JSON record of the numbers.

  python -m megatron_tpu_torch.tools.bench_head [--iters N] [--seq N]
      [--smoke] [--device cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from megatron_tpu_torch.utils.device import resolve_device

POINTS = ((2, 32), (4, 32), (8, 32), (4, 80), (8, 80), (16, 80))
SMOKE = dict(hidden=64, ffn=128, heads=4, vocab=256, seq=32, iters=1)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_head",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the lines here")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--micro_bs", type=int, default=1)
    p.add_argument("--hidden", type=int, default=4096)
    p.add_argument("--ffn", type=int, default=11008)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes, in seconds")
    p.add_argument("--device", default=None,
                   help="cpu runs without a card (the default is the card)")
    args = p.parse_args(argv)
    if args.smoke:
        for k, v in SMOKE.items():
            setattr(args, k, v)
    return args


def measure(args, device) -> dict:
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.models import language_model as lm
    from megatron_tpu_torch.parallel import pipeline as pl
    cuda = device.type == "cuda"
    cfg = llama2_config(
        "tiny", num_layers=1, hidden_size=args.hidden,
        num_attention_heads=args.heads, num_kv_heads=args.heads,
        ffn_hidden_size=args.ffn, vocab_size=args.vocab,
        seq_length=args.seq, max_position_embeddings=args.seq,
        compute_dtype="bfloat16" if cuda else "float32",
        attention_impl="flash", recompute_granularity="none")
    model = lm.LanguageModel(cfg, device=device, trainable=True)
    rope = lm.make_rope(cfg, device=device)
    _, chunk, head = pl.gpt_1f1b_fns(cfg, rope)
    b, s, h = args.micro_bs, args.seq, args.hidden
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(b, s, h, generator=gen, device=device).to(
        lm.as_dtype(cfg.compute_dtype))
    labels = torch.randint(0, args.vocab, (b, s), generator=gen,
                           device=device)
    sl = {"position_ids": torch.arange(s, device=device).expand(b, s),
          "labels": labels,
          "loss_mask": torch.ones(b, s, device=device)}
    dy = torch.randn(b, s, h, generator=gen, device=device).to(x.dtype)

    def layer_arm():
        xi = x.detach().requires_grad_(True)
        out, _ = chunk(model["transformer"], xi, sl, 0, None)
        torch.autograd.backward(out, dy)

    def head_arm():
        xi = x.detach().requires_grad_(True)
        head(model, xi, sl, None).backward()

    def timeit(fn) -> float:
        fn()  # builds the kernels, warms the allocator
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        if cuda:
            torch.cuda.synchronize(device)
        for p in model.parameters():
            p.grad = None
        return (time.perf_counter() - t0) / args.iters * 1e3

    t_layer = timeit(layer_arm)
    t_head = timeit(head_arm)
    lines = [f"device: {device.type} "
             f"{torch.cuda.get_device_name(device) if cuda else 'cpu'}",
             f"7B-width @ seq {s}, micro_bs {b}:" if not args.smoke
             else f"smoke width h {h} @ seq {s}, micro_bs {b}:",
             f"  t_layer fwd+bwd = {t_layer:.2f} ms",
             f"  t_head  fwd+bwd = {t_head:.2f} ms  "
             f"(ratio head/layer = {t_head / t_layer:.3f})"]
    points = []
    for pp, L in POINTS:
        lc = L // pp
        ours = t_head / (lc * t_layer + t_head)
        masked = (pp - 1) * t_head / (L * t_layer + pp * t_head)
        lines.append(f"  pp={pp:2d} L={L:2d}: last-stage head overhead = "
                     f"{ours:.1%} (reference's masked-head tax "
                     f"{masked:.1%})")
        points.append({"pp": pp, "L": L, "overhead": ours,
                       "reference_masked_tax": masked})
    analytic = args.vocab / (args.vocab + 12 * args.hidden)
    lines.append("(overhead = t_head / (L/pp * t_layer + t_head); analytic "
                 f"FLOP share of head vs one layer V/(V+12h) = "
                 f"{analytic:.1%}, measured share = "
                 f"{t_head / (t_head + t_layer):.1%})")
    return {"metric": "pipeline_head_overhead", "device": str(device),
            "device_kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
            "shape": {"hidden": h, "ffn": args.ffn, "heads": args.heads,
                      "vocab": args.vocab, "seq": s, "micro_bs": b},
            "t_layer_ms": t_layer, "t_head_ms": t_head,
            "analytic_share": analytic, "points": points, "lines": lines}


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    device = resolve_device(device if device is not None else args.device)
    record = measure(args, device)
    body = {k: v for k, v in record.items() if k != "lines"}
    for line in record["lines"]:
        print(line, flush=True)
    print(json.dumps(body), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(record["lines"]) + "\n" + json.dumps(body)
                    + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
