"""Measure the 1F1B pipeline bubble against n_micro (the port of the root
tools/bench_bubble.py).

The schedule runs T = n_micro + 2(P-1) ticks (P = pp*vpp), so a step's
time should be linear in n_micro with a fill/drain intercept:

    t_step(n) = t_tick * (n + 2(P-1))

This tool times the port's pipelined forward and backward
(training/train_step.py `pipelined_lm_grads`, the 1F1B schedule of
parallel/pipeline.py) over an n_micro sweep, fits t_tick and the
intercept, and prints the reference tool's fields: each point's time, T
and predicted bubble 2(P-1)/T, the fit, and each point's measured bubble
1 - t_tick*n/t(n) against the predicted one. The last line is one JSON
record of the same numbers.

It runs as one rank of a process group of pp ranks: under torchrun (one
GPU a rank, NCCL), or, given `--ranks pp` outside one, it starts pp gloo
ranks itself, all on the one device (the card, or the CPU with `--device
cpu`). Under gloo every boundary tensor is staged through host memory, so
the intercept then includes that staging, and the output says so.

  torchrun --nproc_per_node 4 -m megatron_tpu_torch.tools.bench_bubble \\
      --n_micro 4 8 16 32
  python -m megatron_tpu_torch.tools.bench_bubble --ranks 2 [--smoke]
      [--device cpu] [--vpp 1 2] [--iters 3] [--out FILE]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from megatron_tpu_torch.utils.device import resolve_device

SMOKE = dict(layers_per_pos=1, hidden=64, seq=32, heads=4, vocab=256,
             n_micro=[2, 4], iters=1)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench_bubble",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the lines here")
    p.add_argument("--ranks", type=int, default=None,
                   help="start this many gloo ranks on the one device "
                        "(outside torchrun)")
    p.add_argument("--vpp", type=int, nargs="+", default=[1, 2])
    p.add_argument("--n_micro", type=int, nargs="+", default=[4, 8, 16, 32])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--layers_per_pos", type=int, default=2)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--micro_bs", type=int, default=1)
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes, in seconds")
    p.add_argument("--device", default=None,
                   help="cpu runs without a card (the default is the card)")
    args = p.parse_args(argv)
    if args.smoke:
        for k, v in SMOKE.items():
            setattr(args, k, v)
    return args


def _config(args, pp: int, vpp: int, device):
    from megatron_tpu_torch import config as tc
    cuda = device.type == "cuda"
    model = tc.llama2_config(
        "tiny", num_layers=args.layers_per_pos * pp * vpp,
        hidden_size=args.hidden, num_attention_heads=args.heads,
        num_kv_heads=args.heads, ffn_hidden_size=4 * args.hidden,
        vocab_size=args.vocab, seq_length=args.seq,
        max_position_embeddings=args.seq,
        compute_dtype="bfloat16" if cuda else "float32",
        attention_impl="flash")
    return tc.MegatronConfig(
        model=model, parallel=tc.ParallelConfig(
            pipeline_parallel=pp, virtual_pipeline_chunks=vpp),
        training=tc.TrainingConfig(micro_batch_size=args.micro_bs)
    ).validate(n_devices=pp)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(args, device) -> dict:
    """This rank's sweep; every rank times, rank 0's numbers are
    reported."""
    from megatron_tpu_torch.models import language_model as lm
    from megatron_tpu_torch.parallel import pipeline as pl
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training.train_step import pipelined_lm_grads
    pp = dist.get_world_size()
    gloo = dist.get_backend() == "gloo"
    lines, arms = [], []
    for vpp in args.vpp:
        cfg = _config(args, pp, vpp, device)
        mesh = build_mesh(cfg.parallel)
        model = lm.LanguageModel(cfg.model, device=device, trainable=True,
                                 mesh=mesh)
        times = {}
        for n in args.n_micro:
            gen = torch.Generator().manual_seed(n)
            batch = {"tokens": torch.randint(
                0, args.vocab, (n, args.micro_bs, args.seq + 1),
                generator=gen).to(device)}
            pipelined_lm_grads(model, batch, None, cfg)  # builds, warms
            _sync(device)
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                loss, _ = pipelined_lm_grads(model, batch, None, cfg)
            float(loss)
            _sync(device)
            times[n] = (time.perf_counter() - t0) / args.iters
            T = pl.num_ticks(n, pp, vpp)
            lines.append(f"[bubble] pp={pp} vpp={vpp} n_micro={n:3d}: "
                         f"{times[n] * 1e3:8.1f} ms/step  T={T}  "
                         "predicted_bubble="
                         f"{pl.bubble_fraction(n, pp, vpp):.3f}")
        ns = np.asarray(sorted(times), dtype=float)
        ts = np.asarray([times[n] for n in sorted(times)])
        b, a = (np.polyfit(ns, ts, 1) if len(ns) > 1
                else (ts[0] / (ns[0] + 2 * (pp * vpp - 1)), 0.0))
        P = pp * vpp
        lines.append(f"[bubble] pp={pp} vpp={vpp} fit: t_tick={b * 1e3:.2f}"
                     f" ms, intercept={a * 1e3:.2f} ms (predicted fill/drain"
                     f" 2(P-1)*t_tick={2 * (P - 1) * b * 1e3:.2f} ms)")
        points = []
        for n in sorted(times):
            measured = 1.0 - (b * n) / times[n]
            predicted = pl.bubble_fraction(n, pp, vpp)
            lines.append(f"[bubble]   n_micro={n:3d}: measured_bubble="
                         f"{measured:.3f} vs predicted {predicted:.3f}")
            points.append({"n_micro": n, "step_ms": times[n] * 1e3,
                           "ticks": pl.num_ticks(n, pp, vpp),
                           "measured_bubble": measured,
                           "predicted_bubble": predicted})
        arms.append({"pp": pp, "vpp": vpp, "t_tick_ms": b * 1e3,
                     "intercept_ms": a * 1e3,
                     "predicted_fill_drain_ms": 2 * (P - 1) * b * 1e3,
                     "points": points})
        model = None
    if gloo and device.type == "cuda":
        lines.append("[bubble] note: gloo ranks share the card; every "
                     "boundary tensor is staged through host memory, and "
                     "the intercept includes that staging")
    return {"metric": "pipeline_bubble", "backend": dist.get_backend(),
            "device": str(device), "arms": arms, "lines": lines}


def _rank(rank: int, world: int, store: str, args, device_name) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        record = _run(args, resolve_device(device_name))
        if rank == 0:
            _report(record, args.out)
    finally:
        dist.destroy_process_group()


def _run(args, device) -> dict:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return measure(args, device)


def _report(record: dict, out) -> None:
    import json
    for line in record["lines"]:
        print(line, flush=True)
    body = {k: v for k, v in record.items() if k != "lines"}
    print(json.dumps(body), flush=True)
    if out:
        with open(out, "w") as f:
            f.write("\n".join(record["lines"]) + "\n" + json.dumps(body)
                    + "\n")


def main(argv=None, *, device=None) -> int:
    args = parse(argv)
    name = device if device is not None else args.device
    joined = dist.is_available() and dist.is_initialized()
    if joined or "RANK" in os.environ:   # a rank of torchrun's group
        from megatron_tpu_torch.parallel.multihost import \
            initialize_distributed
        record = _run(args, initialize_distributed(name))
        if dist.get_rank() == 0:
            _report(record, args.out)
        if not joined:
            dist.destroy_process_group()
        return 0
    if not args.ranks:
        raise SystemExit("bench_bubble: run it under torchrun, or give "
                         "--ranks N to start N gloo ranks on one device")
    resolve_device(name)  # raises without a card unless the CPU is named
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args.ranks,
                                        os.path.join(tmp, "store"), args,
                                        name),
                           nprocs=args.ranks, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
