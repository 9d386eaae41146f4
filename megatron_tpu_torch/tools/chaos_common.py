"""Shared scaffolding of the port's chaos drills (the parts of the root
tools/chaos_common.py that tools/chaos_router.py uses): a tiny router over
replicas of one tiny model, a serial oracle, and the outcome resolvers
that count every future as resolved or stranded.

The reference's drills also sweep `serving/invariants.py`; the port's
invariant checker comes with a later slice (ROADMAP Queue 1 item 6), so
the port's drills assert their own scenario contracts only.
"""
from __future__ import annotations

import json
from typing import Optional

import torch

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def tiny_model_cfg(compute: str = "float32", hidden: int = 64):
    """The drills' tiny model: 2 layers, vocab 128, 128 positions."""
    from megatron_tpu_torch.config import ModelConfig
    return ModelConfig(num_layers=2, hidden_size=hidden,
                       num_attention_heads=2, num_kv_heads=1,
                       vocab_size=128, seq_length=128,
                       max_position_embeddings=128,
                       make_vocab_size_divisible_by=64,
                       compute_dtype=compute).derived()


def tiny_generator(cfg, device: DeviceLike = None, seed: int = 0):
    """Seeded random weights and a Generator whose eos no sample reaches
    (-1), so request lifetimes are their max_new_tokens. The cache is
    fp32, the dtype under which the block path matches the serial
    route's dot path token for token."""
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel
    device = resolve_device(device)
    model = LanguageModel(cfg, device=device, seed=seed)
    return Generator(model, cfg, eos_id=-1, pad_id=0, device=device,
                     kv_cache_dtype=torch.float32)


def tiny_router(serving_kwargs: dict, n_replicas: int = 2,
                heartbeat_s: float = 2.0, probe_backoff_s: float = 0.2,
                device: DeviceLike = None):
    """(router, engines, generator): N replicas over one tiny model behind
    an EngineRouter."""
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.serving import EngineRouter, ServingEngine
    device = resolve_device(device)
    cfg = tiny_model_cfg()
    gen = tiny_generator(cfg, device)
    serving = ServingConfig(**serving_kwargs).validate(cfg)
    engines = [ServingEngine(gen, serving, device=device)
               for _ in range(n_replicas)]
    router = EngineRouter(engines, max_retries=2,
                          heartbeat_timeout_s=heartbeat_s,
                          probe_backoff_s=probe_backoff_s)
    return router, engines, gen


def serial_oracle(gen):
    """The serial route's tokens, cached per (prompt, n, seed, sampling):
    `want(prompt, n, seed=0, sampling=None)`, greedy when sampling is
    None. The engine's seeding contract makes it exact for seeded sampled
    requests too."""
    from megatron_tpu_torch.inference.generation import SamplingParams
    cache = {}

    def want(prompt, n, seed=0, sampling=None):
        sp = (sampling if sampling is not None
              else SamplingParams(temperature=0.0))
        key = (tuple(prompt), n, seed, (sp.temperature, sp.top_k, sp.top_p))
        if key not in cache:
            toks, lens, _ = gen.generate([list(prompt)], n, sp, seed=seed)
            cache[key] = toks[0, :lens[0]].tolist()
        return cache[key]

    return want


def resolve_all(reqs, timeout: float = 120.0) -> dict:
    """Resolve every future and classify the outcomes; a timeout is the
    stranded future the drills exist to catch."""
    from megatron_tpu_torch.serving import (DeadlineExceededError,
                                            ServiceUnavailableError)
    out = {"ok": 0, "deadline_504": 0, "unavailable_503": 0, "error": 0,
           "stranded": 0}
    for r in reqs:
        try:
            r.result(timeout=timeout)
            out["ok"] += 1
        except DeadlineExceededError:
            out["deadline_504"] += 1
        except ServiceUnavailableError:
            out["unavailable_503"] += 1
        except TimeoutError:
            out["stranded"] += 1
        except Exception:  # noqa: BLE001 — typed enough: it resolved
            out["error"] += 1
    return out


def resolve_exact(reqs, want, timeout: float = 120.0):
    """Resolve every (request, prompt, n) future, count the outcomes and
    hold every completed one to the serial oracle."""
    out = {"ok": 0, "error": 0, "stranded": 0}
    exact = True
    for r, prompt, n in reqs:
        try:
            toks, _ = r.result(timeout=timeout)
            out["ok"] += 1
            if toks != want(prompt, n):
                exact = False
        except TimeoutError:
            out["stranded"] += 1
        except Exception:  # noqa: BLE001 — typed enough: it resolved
            out["error"] += 1
    return out, exact


def emit_record(record: dict, out: Optional[str], seed=0) -> str:
    """One JSON line on stdout (and to `out`), with the seed that
    reproduces it."""
    record.setdefault("seed", seed)
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return line
