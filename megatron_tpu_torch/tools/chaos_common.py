"""Shared scaffolding of the port's chaos drills (the root
tools/chaos_common.py): a tiny engine and a tiny router over replicas of
one tiny model, LoRA adapters for them, serial oracles, the outcome
resolvers that count every future as resolved or stranded, checkpoint
publishes (a good one and a corrupted one), the invariant sweep
(serving/invariants.py) every drill ends with, and the helpers of a fleet
of replica processes (tools/chaos_fleet.py): the integer tokenizer, free
ports, and spawning a replica and waiting until it accepts.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def tiny_model_cfg(compute: str = "float32", hidden: int = 128):
    """The drills' tiny model: 2 layers, vocab 128, 128 positions, two
    query heads over one kv head of 64 dims (a head dim the card's kernels
    take, so the drills run there as on the CPU)."""
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


def tiny_engine(serving_kwargs: dict, device: DeviceLike = None,
                gen=None):
    """(engine, generator) over the tiny model (or over `gen`, a
    Generator the caller built)."""
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.serving import ServingEngine
    device = resolve_device(device)
    if gen is None:
        gen = tiny_generator(tiny_model_cfg(), device)
    serving = ServingConfig(**serving_kwargs).validate(gen.cfg)
    return ServingEngine(gen, serving, device=device), gen


def pool_mode(block: int, kernel: bool) -> dict:
    """Serving kwargs of the drilled pool layout: the block pool (the
    production layout) with the block kernel where legal, or the
    whole-region pool with block 0."""
    kw = {}
    if block:
        kw["kv_block_size"] = int(block)
        if kernel:
            kw["block_native_attn"] = True
    return kw


def make_adapters(cfg, n_adapters: int, rank: int = 4) -> dict:
    """n random nonzero adapters (seeded) -> {adapter_id: factors}."""
    from megatron_tpu_torch.serving.adapters import random_adapter_factors
    return {f"tenant-{a}": random_adapter_factors(cfg, rank, 1000 + a)
            for a in range(n_adapters)}


def adapter_generators(gen, adapters: dict, rank: int, alpha: float):
    """{adapter_id: Generator} over the base weights with each adapter
    merged in (training/lora.py merge_lora; exact against the factored
    serving path in fp32), with None -> `gen` itself."""
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.training.lora import merge_lora
    out = {None: gen}
    for aid, factors in adapters.items():
        out[aid] = Generator(merge_lora(gen.params, factors, gen.cfg, rank,
                                        alpha),
                             gen.cfg, eos_id=gen.eos_id, pad_id=gen.pad_id,
                             device=gen.device,
                             kv_cache_dtype=gen.kv_cache_dtype)
    return out


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


def publish_checkpoint(root: str, model, cfg, iteration: int) -> str:
    """One manifest-sealed checkpoint publish of `model` (a
    LanguageModel), as a trainer would write it; returns its directory."""
    from megatron_tpu_torch.config import MegatronConfig
    from megatron_tpu_torch.training.checkpointing import save_checkpoint
    from megatron_tpu_torch.training.train_step import TrainState
    return save_checkpoint(
        root, TrainState(params=model, opt_state=None, iteration=iteration),
        MegatronConfig(model=cfg), iteration)


def corrupt_payload(ckpt_dir: str) -> str:
    """Flip one byte of the largest payload file: the torn or bit-rotted
    publish the manifest gate must refuse."""
    files = [p for p in glob.glob(os.path.join(ckpt_dir, "**"),
                                  recursive=True)
             if os.path.isfile(p) and os.path.basename(p) != "manifest.json"]
    target = max(files, key=os.path.getsize)
    with open(target, "r+b") as f:
        b0 = f.read(1)
        f.seek(0)
        f.write(bytes([b0[0] ^ 0xFF]))
    return target


def invariant_sweep(target, reqs=(), oracles=(), strict: bool = True,
                    timeout: float = 120.0) -> dict:
    """`invariants.check_all` without raising: the report (its "ok" and
    "violations"), which a drill puts in its record beside its own
    checks. The strict sweep reads engine-thread accounting, so it waits
    for the grid to go quiet first; a sweep that raises is a finding."""
    from megatron_tpu_torch.serving import invariants
    try:
        if strict:
            invariants.wait_quiesced(target, timeout=min(timeout, 30.0))
        return invariants.check_all(target, requests=reqs, oracles=oracles,
                                    strict=strict, timeout=timeout,
                                    raise_on_violation=False)
    except Exception as e:  # noqa: BLE001 — a crashed sweep is a finding
        return {"ok": False,
                "violations": [f"[sweep-crash] {type(e).__name__}: {e}"]}


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


# ---------------------------------------------------------------------
# a fleet of replica processes (tools/chaos_fleet.py)
# ---------------------------------------------------------------------
REPO_ROOT = Path(__file__).resolve().parents[2]


class IntTokenizer:
    """Space-separated integers: the tokenizer of replica processes and of
    front tiers in the drills. The wire format between them is
    `prompt_tokens`, so only `detokenize` runs on a replica, and it must
    give the same text in every process."""

    eod = 0
    bos = None

    def tokenize(self, s):
        return [int(t) for t in str(s).split()]

    def detokenize(self, ids):
        return " ".join(str(int(t)) for t in ids)


def free_port() -> int:
    """A free TCP port the OS assigned (the child binds it a moment later:
    a small race, fine for drills and tests)."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def replica_env() -> dict:
    """A replica child's environment: the parent's, with the repository
    root first on PYTHONPATH (the child runs `python -m` from the root) and
    two CPU threads unless the caller set OMP_NUM_THREADS (several
    replicas share the host's cores)."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (str(REPO_ROOT) if not path
                         else f"{REPO_ROOT}{os.pathsep}{path}")
    env.setdefault("OMP_NUM_THREADS", "2")
    return env


def spawn_replica(port: int, extra_args=(), stdout=None, stderr=None):
    """Start `python -m megatron_tpu_torch.tools.chaos_fleet
    --serve_replica` as a process serving on 127.0.0.1:port, from the
    repository root. `extra_args` choose its device and model. The
    child's output goes to DEVNULL unless given, so the parent's stdout
    keeps its one-record contract."""
    return subprocess.Popen(
        [sys.executable, "-m", "megatron_tpu_torch.tools.chaos_fleet",
         "--serve_replica", "--port", str(port), *map(str, extra_args)],
        cwd=str(REPO_ROOT), env=replica_env(),
        stdout=stdout if stdout is not None else subprocess.DEVNULL,
        stderr=stderr if stderr is not None else subprocess.DEVNULL)


def wait_replica_ready(addr: str, timeout: float = 120.0,
                       proc=None) -> None:
    """Block until the replica at host:port answers /healthz accepting.
    Raises on timeout, or when `proc` exits first."""
    from megatron_tpu_torch.serving.remote import RemoteReplica
    probe = RemoteReplica(addr, connect_timeout_s=1.0, read_timeout_s=5.0,
                          max_retries=0)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"replica {addr} exited with "
                               f"{proc.returncode} before it was ready")
        try:
            if probe.health().get("accepting"):
                return
        except Exception:  # noqa: BLE001 — not up yet
            pass
        time.sleep(0.1)
    raise TimeoutError(f"replica {addr} not ready within {timeout:.0f}s")
