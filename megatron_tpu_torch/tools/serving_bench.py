"""Concurrent-load bench of the continuous-batching engine (the root
tools/serving_bench.py): offered load against sustained throughput, TTFT
percentiles and slot occupancy. One JSON record goes to stdout and to
`--out`, in the reference's schema.

Three modes:
- in-process (default): a model of the given shape (random weights from
  seed 0) behind a `ServingEngine`, driven at `--rps` offered load (0:
  everything at once);
- `--url host:port`: the same load as concurrent HTTP PUTs against a
  running server, a fleet front tier included. A whole completion shows no
  TTFT, so the record carries whole-request latency percentiles; with
  `--stream` every request is an SSE stream and the record adds TTFT
  p50/p99 and the inter-token p50 the client saw. `--vary_prompts` starts
  prompt i with its own number, so that no two prompts share a prefix
  (prefix-affinity routing then spreads them by load);
- `--overload`: the in-process engine past its slot capacity with
  per-request deadlines and early shedding: shed rate, goodput
  (completions within their deadline, a second) and p99 queue delay.

  python -m megatron_tpu_torch.tools.serving_bench [--requests N]
      [--slots N] [--rps R] [--prompt N] [--new N] [--out FILE]
      [--overload] [--deadline S] [--device cpu]
  python -m megatron_tpu_torch.tools.serving_bench --url 127.0.0.1:5000
      [--stream] [--vary_prompts]

The in-process modes run on the card unless `--device` names another.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

from megatron_tpu_torch.serving.metrics import _percentile as _sorted_pct
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def _percentile(vals, q):
    # the nearest-rank convention of the server's /metrics snapshot
    return _sorted_pct(sorted(vals), q)


def _build_workload(args, eos_id: int, device):
    """The model, Generator and prompts of both in-process modes, so the
    engine and overload arms measure one workload shape."""
    import numpy as np

    from megatron_tpu_torch.config import ModelConfig
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel

    cfg = ModelConfig(
        num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads,
        num_kv_heads=max(args.heads // 2, 1), vocab_size=args.vocab,
        seq_length=args.seq, max_position_embeddings=args.seq,
        make_vocab_size_divisible_by=64,
        compute_dtype="bfloat16").derived()
    model = LanguageModel(cfg, device=device, seed=0)
    gen = Generator(model, cfg, eos_id=eos_id, pad_id=0, device=device)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, cfg.vocab_size,
                          size=rs.randint(max(args.prompt // 2, 1),
                                          args.prompt + 1)).tolist()
               for _ in range(args.requests)]
    return gen, prompts


def _pace(args, t0: float, i: int):
    """The offered-load pacing of every mode."""
    if args.rps > 0:
        delay = t0 + i / args.rps - time.monotonic()
        if delay > 0:
            time.sleep(delay)


def _bench_engine(args, device) -> dict:
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.serving import SamplingOptions, ServingEngine

    gen, prompts = _build_workload(args, eos_id=0, device=device)
    serving = ServingConfig(num_slots=args.slots,
                            max_queue=max(args.requests, 64))
    with ServingEngine(gen, serving, device=device) as eng:
        # warm-up: the first prefill and decode step
        eng.generate(prompts[0], 2, SamplingOptions(temperature=1.0),
                     seed=0)
        t0 = time.monotonic()
        reqs = []
        for i, p in enumerate(prompts):
            _pace(args, t0, i)
            reqs.append(eng.submit(p, args.new,
                                   SamplingOptions(temperature=1.0), seed=i))
        gen_tokens = 0
        for r in reqs:
            toks, _ = r.result(timeout=600)
            gen_tokens += len(toks) - len(r.prompt)
        wall = time.monotonic() - t0
        ttfts = [r.ttft for r in reqs if r.ttft is not None]
        snap = eng.metrics.snapshot()
    return {
        "bench": "serving", "mode": "engine",
        "slots": args.slots, "requests": args.requests,
        "offered_rps": args.rps,
        "prompt_len_max": args.prompt, "new_tokens": args.new,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(gen_tokens / max(wall, 1e-9), 2),
        "ttft_p50_ms": round(_percentile(ttfts, 0.50) * 1e3, 1),
        "ttft_p95_ms": round(_percentile(ttfts, 0.95) * 1e3, 1),
        "slot_occupancy": round(snap["slot_occupancy"], 3),
        "decode_steps": int(snap["decode_steps"]),
    }


def _bench_overload(args, device) -> dict:
    """Offered load past the slot capacity: every request carries a
    deadline, the engine sheds what cannot make it (`shed_on_overload`)
    and answers 504 for what expires anyway. Goodput counts completions,
    which the engine's deadline makes completions within it."""
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.serving import (DeadlineExceededError,
                                            QueueFullError, SamplingOptions,
                                            ServingEngine)

    # eos -1: request lifetimes are max_new_tokens, so --requests/--new
    # set the load against capacity, not sampling luck
    gen, prompts = _build_workload(args, eos_id=-1, device=device)
    serving = ServingConfig(num_slots=args.slots,
                            max_queue=max(args.requests, 64),
                            shed_on_overload=True,
                            request_deadline_s=args.deadline)
    with ServingEngine(gen, serving, device=device) as eng:
        # the warm-up also seeds the shedding estimator's service time (it
        # sheds nothing before a first completion); its own deadline keeps
        # it clear of the measured arm's
        eng.submit(prompts[0], args.new, SamplingOptions(temperature=1.0),
                   seed=0, deadline_s=600.0).result(timeout=600)
        t0 = time.monotonic()
        reqs, shed = [], 0
        for i, p in enumerate(prompts):
            _pace(args, t0, i)
            try:
                reqs.append(eng.submit(p, args.new,
                                       SamplingOptions(temperature=1.0),
                                       seed=i))
            except QueueFullError:  # shed, or the bounded queue overflowed
                shed += 1
        good, expired = 0, 0
        for r in reqs:
            try:
                r.result(timeout=600)
                good += 1
            except DeadlineExceededError:
                expired += 1
        wall = time.monotonic() - t0
        snap = eng.metrics.snapshot()
    return {
        "bench": "serving", "mode": "overload",
        "slots": args.slots, "requests": args.requests,
        "offered_rps": args.rps, "deadline_s": args.deadline,
        "prompt_len_max": args.prompt, "new_tokens": args.new,
        "wall_s": round(wall, 3),
        "shed": shed, "expired_504": expired,
        "shed_rate": round(shed / max(args.requests, 1), 3),
        "goodput_rps": round(good / max(wall, 1e-9), 2),
        "goodput_frac": round(good / max(args.requests, 1), 3),
        "queue_wait_p99_ms": round(snap["queue_wait_p99_ms"], 1),
        "queue_wait_p50_ms": round(snap["queue_wait_p50_ms"], 1),
    }


def _stream_one(url: str, payload: dict, timeout: float = 600.0):
    """One SSE request: (first-token seconds, gaps between token frames in
    seconds, tokens, terminal event) timed from the PUT."""
    import http.client
    host, _, port = url.rpartition(":")
    t = time.monotonic()
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("PUT", "/api", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            resp.read()
            return None, [], 0, resp.status
        first, last, gaps, n, event = None, None, [], 0, None
        for raw in resp:
            line = raw.decode().rstrip("\r\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: ") and event == "token":
                now = time.monotonic()
                if first is None:
                    first = now - t
                else:
                    gaps.append(now - last)
                last = now
                n += 1
            elif line.startswith("data: ") and event in ("done", "error"):
                break
        return first, gaps, n, event
    finally:
        conn.close()


def _bench_url(args) -> dict:
    import urllib.error
    import urllib.request

    lat, ttfts, gaps, lock = [], [], [], threading.Lock()
    gen_tokens = [0]
    rejected = [0]  # 429s: real backpressure, reported, not hidden
    failed = [0]    # anything else (4xx, 5xx, transport)
    base_text = "the quick brown fox " * max(args.prompt // 8, 1)

    def prompt(i):
        return f"{i} {base_text}" if args.vary_prompts else base_text

    def put(payload):
        req = urllib.request.Request(
            f"http://{args.url}/api", data=json.dumps(payload).encode(),
            method="PUT", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    # segments are prompt + generated: learn each prompt's length once
    # (tokens_to_generate 0 echoes it), so tokens_per_s counts generated
    # tokens only, as the in-process mode does
    plens = {}
    for i in range(args.requests if args.vary_prompts else 1):
        plens[prompt(i)] = len(put({"prompts": [prompt(i)],
                                    "tokens_to_generate": 0})["segments"][0])

    def one(i):
        payload = {"prompts": [prompt(i)], "tokens_to_generate": args.new,
                   "temperature": 1.0, "random_seed": i}
        t = time.monotonic()
        try:
            if args.stream:
                first, g, n, end = _stream_one(args.url,
                                               dict(payload, stream=True))
                if end != "done":
                    with lock:
                        (rejected if end == 429 else failed)[0] += 1
                    return
            else:
                out = put(payload)
        except urllib.error.HTTPError as e:
            with lock:
                (rejected if e.code == 429 else failed)[0] += 1
            return
        except Exception:  # noqa: BLE001 — counted, not raised
            with lock:
                failed[0] += 1
            return
        dt = time.monotonic() - t
        with lock:
            lat.append(dt)
            if args.stream:
                gen_tokens[0] += n
                if first is not None:
                    ttfts.append(first)
                gaps.extend(g)
            else:
                gen_tokens[0] += sum(max(len(s) - plens[prompt(i)], 0)
                                     for s in out.get("segments", []))

    t0 = time.monotonic()
    threads = []
    for i in range(args.requests):
        _pace(args, t0, i)
        th = threading.Thread(target=one, args=(i,), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=600)
    wall = time.monotonic() - t0
    record = {
        "bench": "serving", "mode": "http_stream" if args.stream else "http",
        "url": args.url, "requests": args.requests, "offered_rps": args.rps,
        "completed": len(lat), "rejected_429": rejected[0],
        "failed": failed[0],
        "wall_s": round(wall, 3),
        "tokens_per_s": round(gen_tokens[0] / max(wall, 1e-9), 2),
        "latency_p50_ms": round(_percentile(lat, 0.50) * 1e3, 1),
        "latency_p95_ms": round(_percentile(lat, 0.95) * 1e3, 1),
    }
    if args.stream:
        record.update(
            ttft_p50_ms=round(_percentile(ttfts, 0.50) * 1e3, 1),
            ttft_p99_ms=round(_percentile(ttfts, 0.99) * 1e3, 1),
            itl_p50_ms=round(_percentile(gaps, 0.50) * 1e3, 1))
    return record


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("serving_bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "serving_bench.log"))
    p.add_argument("--url", default=None,
                   help="host:port of a running server; omit for the "
                        "in-process engine bench")
    p.add_argument("--stream", action="store_true",
                   help="--url: SSE streams, with TTFT and inter-token "
                        "percentiles")
    p.add_argument("--vary_prompts", action="store_true",
                   help="--url: no two prompts share a prefix")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--rps", type=float, default=0.0,
                   help="offered load, requests/s (0: all at once)")
    p.add_argument("--prompt", type=int, default=64,
                   help="max prompt length (the engine mode draws lengths "
                        "uniformly in [prompt/2, prompt])")
    p.add_argument("--new", type=int, default=32)
    p.add_argument("--overload", action="store_true",
                   help="offered load past the slot capacity with deadlines "
                        "and early shedding: shed rate, goodput, p99 queue "
                        "delay")
    p.add_argument("--deadline", type=float, default=2.0,
                   help="per-request deadline of the overload arm (s)")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="in-process modes: the device (default: the card)")
    return p


def main(argv=None, *, device: DeviceLike = None) -> int:
    args = build_parser().parse_args(argv)
    if args.url:
        record = _bench_url(args)
    else:
        dev = resolve_device(args.device if args.device is not None
                             else device)
        record = (_bench_overload(args, dev) if args.overload
                  else _bench_engine(args, dev))
    line = json.dumps(record)
    print(line, flush=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
