"""LoRA finetuning: train low-rank adapter factors with the base frozen and
export them in the versioned `.npz` the serving bank loads
(megatron_tpu/training/lora.py; Hu et al., 2021).

The forward is the serving engine's own `adapters=` seam
(models/attention.py): training wraps the factors as a capacity-1 stacked
`LoraAdapter` with every row at index 0 and differentiates
`language_model.loss_fn` with respect to the 8 factor tensors only (the
base parameters are set `requires_grad_(False)`). So the function the
optimizer descends is the function the engine serves, and `merge_lora`
(the base with A B folded in) is the independent serial oracle that engine
outputs are held against.

The optimizer is the reference's small Adam over the factors, the same
arithmetic step for step: m and v moments, `corr = sqrt(1 - b2^t) /
(1 - b1^t)` in fp32, and `p - lr * corr * m / (sqrt(v) + eps)`.

`lora_init` draws A from a `torch.Generator`; torch cannot reproduce
`jax.random`'s bits, so a parity check feeds both packages the same numpy
factors.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.models.attention import LoraAdapter
from megatron_tpu_torch.serving.adapters import (ADAPTER_FORMAT_VERSION,
                                                 FACTOR_NAMES,
                                                 adapter_factor_shapes)
from megatron_tpu_torch.utils.logging import print_rank_0

# ms of each step of the last run_lora_finetune in this process (the
# host clock around a step that ends in a device read of the loss)
last_run: dict = {}


def lora_init(generator: torch.Generator, cfg: ModelConfig, rank: int,
              dtype: torch.dtype = torch.float32
              ) -> Dict[str, torch.Tensor]:
    """Factors {aq, bq, ...} with a leading layers dim on the generator's
    device: A gaussian times init_method_std, B zero, so the delta starts
    at exactly 0 and the first step switches it on."""
    shapes = adapter_factor_shapes(cfg, rank)
    out = {}
    for name in FACTOR_NAMES:
        if name.startswith("a"):
            out[name] = torch.randn(shapes[name], generator=generator,
                                    dtype=dtype,
                                    device=generator.device
                                    ) * cfg.init_method_std
        else:
            out[name] = torch.zeros(shapes[name], dtype=dtype,
                                    device=generator.device)
    return out


def lora_adapters(factors: Dict[str, torch.Tensor], rank: int,
                  alpha: float, batch: int):
    """The `adapters=` argument of a whole-batch single-adapter forward: a
    capacity-1 stacked bank (row 0 is the adapter) with alpha/rank folded
    into B, and an all-zero index [batch]."""
    scale = float(alpha) / float(rank)
    stacked = LoraAdapter(**{
        n: (f * scale if n.startswith("b") else f)[:, None]
        for n, f in factors.items()})
    device = stacked.aq.device
    return stacked, torch.zeros(batch, dtype=torch.long, device=device)


def _plain(node) -> dict:
    """A ParamTree subtree as nested plain dicts."""
    if isinstance(node, torch.Tensor):
        return node
    return {k: _plain(v) for k, v in node.items()}


def merge_lora(params, factors: Dict[str, np.ndarray], cfg: ModelConfig,
               rank: int, alpha: float) -> dict:
    """The base with A B (alpha/rank) folded into the attention weights in
    fp32 (training/lora.py merge_lora): the serial oracle of adapter
    serving. Returns a new parameter tree (plain dicts, the caller's
    tensors untouched except those shared unchanged). The wkv columns are
    (2, nkv, hd) flattened, so the k delta lands in the first nkv*hd
    columns and the v delta in the rest."""
    tree = _plain(lm._tree(params))
    scale = float(alpha) / float(rank)
    dkv = cfg.num_kv_heads * cfg.kv_channels
    attn = dict(tree["transformer"]["attention"])
    device = attn["wq"].device
    f = {n: torch.as_tensor(np.asarray(factors[n], np.float32),
                            device=device) for n in FACTOR_NAMES}

    def delta(a, b):
        return torch.einsum("lir,lro->lio", a, b) * scale

    with torch.no_grad():
        wq = attn["wq"]
        attn["wq"] = (wq.float() + delta(f["aq"], f["bq"])).to(wq.dtype)
        wkv = attn["wkv"].float().clone()
        wkv[:, :, :dkv] += delta(f["ak"], f["bk"])
        wkv[:, :, dkv:] += delta(f["av"], f["bv"])
        attn["wkv"] = wkv.to(attn["wkv"].dtype)
        wo = attn["wo"]
        attn["wo"] = (wo.float() + delta(f["ao"], f["bo"])).to(wo.dtype)
    tree["transformer"] = dict(tree["transformer"], attention=attn)
    return tree


def export_adapter(path: str, factors: Dict[str, np.ndarray], *,
                   rank: int, alpha: float,
                   meta: Optional[dict] = None) -> str:
    """Write the versioned `.npz` (serving/adapters.py load_adapter_npz):
    raw float32 factors, format_version, rank, alpha and a JSON meta."""
    arrays = {n: np.asarray(torch.as_tensor(factors[n]).detach().cpu(),
                            np.float32) for n in FACTOR_NAMES}
    np.savez(path, format_version=np.int64(ADAPTER_FORMAT_VERSION),
             rank=np.int64(rank), alpha=np.float64(alpha),
             meta=json.dumps(meta or {}), **arrays)
    return path


def make_lora_step(base_params, cfg: ModelConfig, rank: int, alpha: float,
                   lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, rope=None):
    """One Adam step over the factors with the base frozen. Returns
    (step_fn, init_opt): step_fn(factors, opt, tokens, loss_mask) ->
    (factors, opt, loss), with `tokens` [b, s+1] (loss_fn's shift-by-one
    layout) and factors a dict of tensors (new tensors each step)."""
    if isinstance(base_params, torch.nn.Module):
        base_params.requires_grad_(False)
    device = lm.params_device(base_params)
    if rope is None:
        rope = lm.make_rope(cfg, device=device)

    def init_opt(factors):
        return {"m": {n: torch.zeros_like(f) for n, f in factors.items()},
                "v": {n: torch.zeros_like(f) for n, f in factors.items()},
                "t": 0}

    def step(factors, opt, tokens, loss_mask):
        leaves = {n: f.detach().requires_grad_(True)
                  for n, f in factors.items()}
        adapters = lora_adapters(leaves, rank, alpha, tokens.shape[0])
        loss = lm.loss_fn(base_params, tokens, cfg, loss_mask=loss_mask,
                          rope=rope, adapters=adapters)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
        with torch.no_grad():
            t = opt["t"] + 1
            m = {n: b1 * opt["m"][n] + (1 - b1) * grads[n] for n in names}
            v = {n: b2 * opt["v"][n] + (1 - b2) * grads[n] * grads[n]
                 for n in names}
            tf = torch.tensor(float(t), dtype=torch.float32, device=device)
            corr = torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
            new = {n: leaves[n].detach()
                   - lr * corr * m[n] / (torch.sqrt(v[n]) + eps)
                   for n in names}
        return new, {"m": m, "v": v, "t": t}, loss.detach()

    return step, init_opt


def run_lora_finetune(cfg, base_params, train_it, *, rank: int,
                      alpha: float, iters: int, lr: float = 1e-3,
                      seed: int = 0, export_path: Optional[str] = None,
                      log_interval: int = 10):
    """Drive LoRA training from a BatchIterator (the `--lora_rank` path of
    finetune.py): each batch's microbatches fold into one [b, s+1] grid
    (no accumulation), and the trained factors are exported. Returns
    (factors as numpy arrays, last loss)."""
    model = cfg.model
    device = lm.params_device(base_params)
    gen = torch.Generator(device=device).manual_seed(seed)
    factors = lora_init(gen, model, rank)
    step, init_opt = make_lora_step(base_params, model, rank, alpha, lr=lr)
    opt = init_opt(factors)
    loss = float("nan")
    step_ms = []
    for it in range(iters):
        batch = next(train_it)
        toks = np.asarray(batch["tokens"])
        toks = toks.reshape(-1, toks.shape[-1])  # fold microbatches
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.from_numpy(np.asarray(
                mask, np.float32).reshape(-1, mask.shape[-1])).to(device)
        t0 = time.perf_counter()
        factors, opt, loss_t = step(
            factors, opt, torch.from_numpy(toks.astype(np.int64)).to(device),
            mask)
        loss = float(loss_t)  # the step's device work ends here
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if (it + 1) % max(log_interval, 1) == 0 or it + 1 == iters:
            print_rank_0(f"lora iter {it + 1}/{iters} loss {loss:.4f} "
                         f"(rank {rank}, alpha {alpha}, base frozen)")
    factors = {n: f.cpu().numpy() for n, f in factors.items()}
    last_run.clear()
    last_run.update(step_ms=step_ms, last_loss=loss)
    if export_path:
        export_adapter(export_path, factors, rank=rank, alpha=alpha,
                       meta={"iters": iters, "lr": lr,
                             "hidden_size": model.hidden_size,
                             "num_layers": model.num_layers})
        print_rank_0(f"lora adapter exported -> {export_path}")
    return factors, loss
