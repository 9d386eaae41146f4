"""Serve a checkpoint over the REST text-generation API (the port of the
root tools/run_text_generation_server.py).

  python -m megatron_tpu_torch.tools.run_text_generation_server \\
      --load ckpts/llama7b --tokenizer_type SentencePieceTokenizer \\
      --tokenizer_model tokenizer.model --port 5000 --kv_block_size 16

The architecture comes from the checkpoint's config.json. The weights load
onto the card (the caller of `main` may name another device; without a GPU
and a device it raises) in the checkpoint's dtype. By default requests go
through the continuous-batching engine; `--kv_block_size` gives it the
block pool read by the block-native decode kernel, `--num_slots` defaults to
what the card's free memory holds after the weights (up to 8,
`serving.kv_pool.fit_num_slots`), and `--serial` serves every request on the
serial route instead. `--int8_weights` and `--int8_kv` serve int8-resident
weights and an int8 KV cache. The front door: `--num_replicas N` serves N
engine replicas (the weights once, a pool each; the default slot count is
then split between them) behind the prefix-affinity router,
`--enable_prefix_cache` with `--kv_block_size` retains finished prefixes,
and `--host_kv_bytes` demotes evicted ones to a host-RAM tier of that many
bytes. `"stream": true` payloads are answered as server-sent events.

LoRA serving: `--adapter_slots N --adapter_rank R` give the engine a bank
of N adapters (`--adapter_host_bytes` of checksummed host overflow), and
`--adapter_dir DIR` registers every `DIR/*.npz` export (finetune
`--lora_rank`) at start, adapter_id = the file's stem; a payload's
`"adapter_id"` selects one. Live weights: `--watch_checkpoints` polls the
`--load` root's tracker and hot-swaps to each new publish
(`--watch_interval_s`, `--swap_timeout_s`); `PUT /admin` swaps or
registers on demand.

Remote replicas (serving/remote.py): `--replica_mode` serves the engine as
one replica process of a fleet (it also takes pre-tokenized
`prompt_tokens` payloads and answers `GET /affinity`), and `--fleet
host:port,...` runs a front tier over such processes: it loads no weights
(no `--load`), needs only the tokenizer, touches no device, and routes
through the prefix-affinity router over a `RemoteReplica` client each
(`--remote_connect_timeout_s`, `--remote_read_timeout_s`,
`--remote_max_retries`, `--remote_digest_interval_s`).

The other flags of the JAX tool parse and raise NotImplementedError naming
the ROADMAP item they wait for: `--serving_tp` and
`--disaggregate_prefill`.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import print_rank_0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--load", default=None,
                   help="checkpoint root to serve (none with --fleet: a "
                        "front tier holds no weights)")
    p.add_argument("--tokenizer_type", default="SentencePieceTokenizer")
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--merge_file", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000,
                   help="0 binds a free port")
    p.add_argument("--int8_weights", action="store_true",
                   help="serve int8-resident transformer weights "
                        "(ops/quantized.quantize_weights)")
    p.add_argument("--int8_kv", action="store_true",
                   help="serve with an int8 KV cache")
    p.add_argument("--num_slots", type=int, default=None,
                   help="engine slots (concurrently decoding requests); "
                        "default: up to 8, clamped to what the card's free "
                        "memory holds after the weights")
    p.add_argument("--max_queue", type=int, default=64,
                   help="bounded admission queue; overflow answers 429")
    p.add_argument("--serving_max_len", type=int, default=None,
                   help="per-slot KV region (prompt + generated); default "
                        "max_position_embeddings")
    p.add_argument("--request_deadline_s", type=float, default=None,
                   help="per-request wall-clock deadline (504 past it)")
    p.add_argument("--serial", action="store_true",
                   help="serve every request on the serial route, one at "
                        "a time, instead of the engine")
    p.add_argument("--kv_block_size", type=int, default=None,
                   help="block-granular KV pool, read in place by the "
                        "block-native decode kernel")
    p.add_argument("--enable_prefix_cache", action="store_true",
                   help="retain finished requests' KV and reuse the "
                        "longest cached prefix of a new prompt")
    p.add_argument("--retained_slots", type=int, default=None,
                   help="cap on retained prefixes (None: block pressure "
                        "alone evicts)")
    p.add_argument("--num_replicas", type=int, default=1,
                   help="engine replicas behind the in-process "
                        "prefix-affinity router: a request goes to the "
                        "replica whose prefix cache holds the longest "
                        "match (ties: least loaded); unhealthy replicas "
                        "are ejected and their work retries on a survivor "
                        "(1: no router)")
    p.add_argument("--router_max_retries", type=int, default=2,
                   help="failover retries a request before its error "
                        "surfaces (503 only when every replica is down)")
    p.add_argument("--router_heartbeat_timeout_s", type=float, default=5.0,
                   help="seconds without a healthy snapshot before the "
                        "router ejects a replica")
    p.add_argument("--host_kv_bytes", type=int, default=0,
                   help="host-RAM KV tier byte budget: retained prefix "
                        "block lists evicted under block pressure demote "
                        "to host memory (checksum-verified on restore) and "
                        "restore on a later hit; needs "
                        "--enable_prefix_cache and --kv_block_size "
                        "(0 disables)")
    p.add_argument("--stream_ttl_s", type=float, default=600.0,
                   help="seconds a finished SSE stream stays resumable "
                        "through Last-Event-ID")
    p.add_argument("--adapter_slots", type=int, default=0,
                   help="device-resident LoRA adapters served at once "
                        "(0: no adapter bank)")
    p.add_argument("--adapter_rank", type=int, default=8,
                   help="the bank's rank; smaller exports zero-pad up")
    p.add_argument("--adapter_host_bytes", type=int, default=0,
                   help="host-RAM budget for evicted adapters "
                        "(checksummed; 0: evictions drop)")
    p.add_argument("--adapter_dir", type=str, default=None,
                   help="directory of adapter .npz exports registered at "
                        "start; adapter_id = file stem")
    p.add_argument("--watch_checkpoints", action="store_true",
                   help="poll --load's tracker and hot-swap to every "
                        "newly published checkpoint")
    p.add_argument("--watch_interval_s", type=float, default=5.0,
                   help="tracker poll cadence for --watch_checkpoints")
    p.add_argument("--swap_timeout_s", type=float, default=120.0,
                   help="how long a hot swap waits for in-flight work "
                        "before it is refused")
    p.add_argument("--degrade_ladder", type=int, default=0,
                   help="the brownout ladder's top rung: 1 no speculation, "
                        "2 clamps best_of and max_new_tokens, 3 sheds "
                        "priority 0, 4 sheds all (0: no ladder)")
    p.add_argument("--slo_ttft_ms", type=float, default=None,
                   help="TTFT SLO: later first tokens count "
                        "slo_ttft_violations and leave goodput_tokens")
    p.add_argument("--slo_itl_p99_ms", type=float, default=None,
                   help="inter-token SLO: longer gaps count "
                        "slo_itl_violations")
    p.add_argument("--replica_mode", action="store_true",
                   help="serve as one fleet replica process: also takes "
                        "pre-tokenized prompt_tokens payloads and answers "
                        "GET /affinity, for a --fleet front tier")
    p.add_argument("--fleet", type=str, default=None,
                   help="serve as a front tier over the replica processes "
                        "at these comma-separated host:port addresses "
                        "(no weights load here)")
    p.add_argument("--remote_connect_timeout_s", type=float, default=2.0,
                   help="--fleet: connect (and health-probe read) budget "
                        "of a call to a replica")
    p.add_argument("--remote_read_timeout_s", type=float, default=30.0,
                   help="--fleet: read budget of a replica's responses "
                        "and of the gaps between SSE frames")
    p.add_argument("--remote_max_retries", type=int, default=2,
                   help="--fleet: transport retries of one call (backoff "
                        "with jitter, Retry-After honoured); failover to a "
                        "survivor is --router_max_retries")
    p.add_argument("--remote_digest_interval_s", type=float, default=2.0,
                   help="--fleet: refresh cadence of each replica's "
                        "prefix-affinity digest (GET /affinity)")
    # flags of a later slice: they parse and raise
    p.add_argument("--serving_tp", type=int, default=1)
    p.add_argument("--disaggregate_prefill", action="store_true")
    return p


def serving_config(args, num_slots: int):
    """The ServingConfig of the flags, every field of a later slice
    included, so that `validate` names the item such a flag waits for."""
    from megatron_tpu_torch.config import ServingConfig
    return ServingConfig(
        num_slots=num_slots, max_queue=args.max_queue,
        max_len=args.serving_max_len, serial_fallback=args.serial,
        request_deadline_s=args.request_deadline_s,
        kv_block_size=args.kv_block_size,
        block_native_attn=args.kv_block_size is not None,
        enable_prefix_cache=args.enable_prefix_cache,
        retained_slots=args.retained_slots,
        num_replicas=args.num_replicas,
        router_max_retries=args.router_max_retries,
        router_heartbeat_timeout_s=args.router_heartbeat_timeout_s,
        host_kv_bytes=args.host_kv_bytes, stream_ttl_s=args.stream_ttl_s,
        adapter_slots=args.adapter_slots, adapter_rank=args.adapter_rank,
        adapter_host_bytes=args.adapter_host_bytes,
        degrade_ladder=args.degrade_ladder, slo_ttft_ms=args.slo_ttft_ms,
        slo_itl_p99_ms=args.slo_itl_p99_ms,
        serving_tp=args.serving_tp,
        disaggregate_prefill=args.disaggregate_prefill,
        watch_checkpoints=args.load if args.watch_checkpoints else None,
        watch_interval_s=args.watch_interval_s,
        swap_timeout_s=args.swap_timeout_s, replica_mode=args.replica_mode,
        fleet=args.fleet,
        remote_connect_timeout_s=args.remote_connect_timeout_s,
        remote_read_timeout_s=args.remote_read_timeout_s,
        remote_max_retries=args.remote_max_retries,
        remote_digest_interval_s=args.remote_digest_interval_s)


def build_server(argv=None, *, device: DeviceLike = None):
    """Parse `argv`, load the checkpoint and build the MegatronServer (with
    `--fleet`, the front tier over the replica processes: no weights and
    no device). Returns (server, args). Flags of later slices raise before
    any weight is read."""
    import glob
    import os

    import torch

    from megatron_tpu_torch.convert.from_jax import load_npz_checkpoint
    from megatron_tpu_torch.data import build_tokenizer
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.ops.quantized import quantize_weights
    from megatron_tpu_torch.serving.kv_pool import fit_num_slots
    from megatron_tpu_torch.serving.weights import checkpoint_version
    from megatron_tpu_torch.training.checkpointing import tracked_dir

    p = build_parser()
    args = p.parse_args(argv)
    serving_config(args, 8).validate()  # later slices' flags raise here
    if args.fleet and args.load:
        p.error("--fleet is a thin front tier over remote replicas; it "
                "loads no weights (drop --load)")
    if not args.fleet and not args.load:
        p.error("--load is required (or --fleet for a front tier)")
    if args.fleet and (args.serial or args.replica_mode):
        p.error("--fleet excludes --serial and --replica_mode: the front "
                "tier routes, it does not serve an engine")
    if args.replica_mode and args.serial:
        p.error("--replica_mode requires the serving engine (drop "
                "--serial)")
    if args.fleet:
        tokenizer = build_tokenizer(
            args.tokenizer_type, vocab_file=args.vocab_file,
            merge_file=args.merge_file, tokenizer_model=args.tokenizer_model)
        return MegatronServer(None, tokenizer,
                              serving=serving_config(args, 8).validate()), \
            args
    if args.watch_checkpoints and args.int8_weights:
        p.error("--watch_checkpoints is unsupported with --int8_weights "
                "(serve fp weights to hot-swap them)")
    if args.adapter_dir and (args.serial or args.adapter_slots <= 0):
        p.error("--adapter_dir requires --adapter_slots > 0 and the "
                "serving engine (drop --serial)")
    device = resolve_device(device)

    model, mcfg = load_npz_checkpoint(args.load, device)
    version = checkpoint_version(tracked_dir(args.load))
    tokenizer = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merge_file=args.merge_file, tokenizer_model=args.tokenizer_model)
    params = model
    if args.int8_weights:
        params = quantize_weights(model)
        del model  # only the int8 tree stays resident
    kv_dtype = torch.int8 if args.int8_kv else torch.bfloat16
    gen = Generator(params, mcfg, eos_id=tokenizer.eod,
                    kv_cache_dtype=kv_dtype, device=device)
    num_slots = args.num_slots
    if num_slots is None:
        num_slots = 8
        if not args.serial:
            # each replica has its own pool: they share what fits
            reps = max(args.num_replicas, 1)
            num_slots = max(1, fit_num_slots(
                mcfg, args.serving_max_len or mcfg.max_position_embeddings,
                dtype=kv_dtype, requested=8 * reps,
                block_size=args.kv_block_size, device=device) // reps)
            print_rank_0(f"serving: auto-sized num_slots={num_slots} "
                         "(override with --num_slots)")
    serving = serving_config(args, num_slots).validate(mcfg)
    server = MegatronServer(gen, tokenizer, serving=serving, device=device,
                            weight_version=version)
    if args.adapter_dir:
        try:
            for path in sorted(glob.glob(os.path.join(args.adapter_dir,
                                                      "*.npz"))):
                aid = os.path.splitext(os.path.basename(path))[0]
                server.engine.register_adapter(aid, path=path)
                print_rank_0(f"serving: registered adapter {aid!r} ({path})")
        except BaseException:
            server.close()
            raise
    return server, args


def main(argv=None, *, device: DeviceLike = None,
         ready: Optional[Callable] = None) -> int:
    """Serve until the HTTP server is shut down (KeyboardInterrupt, or
    `httpd.shutdown()` from another thread). `ready(server, httpd)` is
    called once the socket is bound, before serving starts."""
    server, args = build_server(argv, device=device)
    try:
        httpd = server.make_http_server(args.host, args.port)
    except BaseException:
        server.close()
        raise
    try:
        host, port = httpd.server_address[:2]
        what = ("a fleet front tier over " + args.fleet if args.fleet
                else f"{args.load} "
                f"({'serial route' if args.serial else 'engine'})")
        print_rank_0(f"serving {what} on http://{host}:{port}/api")
        if ready is not None:
            ready(server, httpd)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
