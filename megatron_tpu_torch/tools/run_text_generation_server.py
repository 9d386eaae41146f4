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
weights and an int8 KV cache.

The other flags of the JAX tool parse and raise NotImplementedError naming
the ROADMAP item they wait for: `--fleet`, `--replica_mode` and the
`--remote_*` flags, the `--adapter_*` flags, `--serving_tp`,
`--disaggregate_prefill` and `--watch_checkpoints`.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import print_rank_0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--load", default=None, help="checkpoint root to serve")
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
    # flags of later slices: they parse and raise
    p.add_argument("--adapter_slots", type=int, default=0)
    p.add_argument("--adapter_rank", type=int, default=8)
    p.add_argument("--adapter_host_bytes", type=int, default=0)
    p.add_argument("--adapter_dir", type=str, default=None)
    p.add_argument("--serving_tp", type=int, default=1)
    p.add_argument("--disaggregate_prefill", action="store_true")
    p.add_argument("--watch_checkpoints", action="store_true")
    p.add_argument("--watch_interval_s", type=float, default=5.0)
    p.add_argument("--swap_timeout_s", type=float, default=120.0)
    p.add_argument("--replica_mode", action="store_true")
    p.add_argument("--fleet", type=str, default=None)
    p.add_argument("--remote_connect_timeout_s", type=float, default=2.0)
    p.add_argument("--remote_read_timeout_s", type=float, default=30.0)
    p.add_argument("--remote_max_retries", type=int, default=2)
    p.add_argument("--remote_digest_interval_s", type=float, default=2.0)
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
        adapter_slots=args.adapter_slots, adapter_rank=args.adapter_rank,
        adapter_host_bytes=args.adapter_host_bytes,
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
    """Parse `argv`, load the checkpoint and build the MegatronServer.
    Returns (server, args). Flags of later slices raise before any weight
    is read."""
    import torch

    from megatron_tpu_torch.convert.from_jax import load_npz_checkpoint
    from megatron_tpu_torch.data import build_tokenizer
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.inference.server import MegatronServer
    from megatron_tpu_torch.ops.quantized import quantize_weights
    from megatron_tpu_torch.serving.kv_pool import fit_num_slots

    p = build_parser()
    args = p.parse_args(argv)
    if args.adapter_dir is not None:
        raise NotImplementedError("--adapter_dir: LoRA adapters are ported "
                                  "in a later slice (ROADMAP Queue 1 item 6)")
    serving_config(args, 8).validate()  # later slices' flags raise here
    if not args.load:
        p.error("--load is required")
    device = resolve_device(device)

    model, mcfg = load_npz_checkpoint(args.load, device)
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
            num_slots = fit_num_slots(
                mcfg, args.serving_max_len or mcfg.max_position_embeddings,
                dtype=kv_dtype, block_size=args.kv_block_size,
                device=device)
            print_rank_0(f"serving: auto-sized num_slots={num_slots} "
                         "(override with --num_slots)")
    serving = serving_config(args, num_slots).validate(mcfg)
    server = MegatronServer(gen, tokenizer, serving=serving, device=device)
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
        print_rank_0(f"serving {args.load} on http://{host}:{port}/api "
                     f"({'serial route' if args.serial else 'engine'})")
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
