"""Transformer layer and the layer stack (megatron_tpu/models/transformer.py).

Parameters keep the reference's stacked layout: every leaf of the stack has
a leading [num_layers] dim. `stack_apply` is a host loop over the layers
where the reference scans; it takes each stacked leaf apart once per
forward with `unbind(0)`, whose backward is one `stack`, so a layer's
gradient never allocates the whole stack. Covers pre- and post-LN and
Falcon's `parallel_attn` / `parallel_layernorm`, segment ids, the flash
path's attention dropout, LoRA adapters (a stacked `LoraAdapter` bank
with a per-row index, sliced per layer like the weights) and the
Mixture-of-Experts MLP (models/moe.py) when `num_experts > 1`, whose
router loss each layer returns and the stack sums. Hidden dropout (and its
LIMA ramp), stochastic depth and activation recompute belong to later
slices and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.attention import (BlockKVCache, KVCache,
                                                 attention_apply,
                                                 attention_init)
from megatron_tpu_torch.models.mlp import mlp_apply, mlp_init
from megatron_tpu_torch.models.moe import moe_apply, moe_init
from megatron_tpu_torch.models.norms import apply_norm, norm_init
from megatron_tpu_torch.ops.quantized import W8


def layer_init(cfg: ModelConfig) -> dict:
    """Parameter specs of one layer (transformer.py layer_init): pre-LN has
    input_norm + post_attn_norm, post-LN output_norm + post_attn_norm,
    parallel_attn drops post_attn_norm, parallel_layernorm adds mlp_norm;
    `num_experts > 1` makes "mlp" an expert bank."""
    mlp = moe_init(cfg) if cfg.num_experts > 1 else mlp_init(cfg)
    specs = {"attention": attention_init(cfg), "mlp": mlp}
    norm = norm_init(cfg.norm_type, cfg.hidden_size)
    specs["output_norm" if cfg.use_post_ln else "input_norm"] = norm
    if not cfg.parallel_attn:
        specs["post_attn_norm"] = dict(norm)
    if cfg.parallel_layernorm:
        specs["mlp_norm"] = dict(norm)
    return specs


def stack_init(cfg: ModelConfig, num_layers: Optional[int] = None) -> dict:
    """Stacked specs: every leaf gains a leading layers dim."""
    n = cfg.num_layers if num_layers is None else num_layers

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        shape, init = tree
        return ((n, *shape), init)
    return stack(layer_init(cfg))


def layer_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cos=None, rope_sin=None, position_ids=None,
                kv_cache: Optional[KVCache] = None, segment_ids=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                adapters=None):
    """One transformer layer. x: [b, s, h]. Returns (x, kv_cache, aux),
    aux being the MoE router's load-balancing loss (a 0-d fp32 tensor), or
    the float 0.0 for a dense MLP, which launches nothing.
    `generator` draws the flash path's attention-dropout seed when
    `deterministic` is False; `adapters` is (this layer's LoraAdapter,
    adapter_idx [b]) or None.

      ln_out = input_norm(x)                (identity when post-LN)
      attn   = attention(ln_out)
      parallel_attn: out = x + mlp(mlp_in) + attn
      else:          ln_in = x + attn; out = ln_in + mlp(post_attn_norm(ln_in))
      out = output_norm(out)                (identity when pre-LN)
    """
    if not deterministic and (cfg.hidden_dropout > 0.0
                              or cfg.drop_path_rate > 0.0):
        raise NotImplementedError(
            "hidden dropout, LIMA dropout and drop-path are ported with the "
            "dropout module in a later slice")
    eps = cfg.norm_epsilon

    def mlp_branch(inp):
        if cfg.num_experts > 1:
            return moe_apply(params["mlp"], inp, cfg)
        return mlp_apply(params["mlp"], inp, cfg), 0.0

    residual = x
    if cfg.use_post_ln:
        ln_out = x
    else:
        ln_out = apply_norm(cfg.norm_type, params["input_norm"], x, eps)
    attn_out, kv_cache = attention_apply(
        params["attention"], ln_out, cfg, rope_cos=rope_cos,
        rope_sin=rope_sin, position_ids=position_ids, kv_cache=kv_cache,
        segment_ids=segment_ids, deterministic=deterministic,
        generator=generator, adapters=adapters)
    if cfg.parallel_attn:
        if cfg.parallel_layernorm:
            mlp_in = apply_norm(cfg.norm_type, params["mlp_norm"], residual,
                                eps)
        else:
            mlp_in = ln_out
        mlp_out, aux = mlp_branch(mlp_in)
        out = residual + (mlp_out + attn_out)
    else:
        ln_in = residual + attn_out
        ln2 = apply_norm(cfg.norm_type, params["post_attn_norm"], ln_in, eps)
        mlp_out, aux = mlp_branch(ln2)
        out = ln_in + mlp_out
    if cfg.use_post_ln:
        out = apply_norm(cfg.norm_type, params["output_norm"], out, eps)
    return out, kv_cache, aux


def unstack_layers(stacked) -> list:
    """Every layer's parameters: one `unbind(0)` per stacked leaf. Indexing
    the stack per layer instead would, under autograd, give each layer's
    grad a zero-filled buffer of the whole [L, ...] leaf."""
    if isinstance(stacked, torch.Tensor):
        return list(stacked.unbind(0))
    if isinstance(stacked, W8):  # int8 values and scales split alike
        return [W8(q, s) for q, s in zip(stacked.q.unbind(0),
                                          stacked.scale.unbind(0))]
    per_key = {k: unstack_layers(v) for k, v in stacked.items()}
    num_layers = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(num_layers)]


def stack_apply(stacked_params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cos=None, rope_sin=None, position_ids=None,
                kv_caches: Union[KVCache, BlockKVCache, None] = None,
                segment_ids=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                adapters=None):
    """Apply every layer in order. `kv_caches` is a KVCache of
    [L, b, T, nkv, hd] tensors or a BlockKVCache of [L, total_blocks, B,
    nkv, hd] arenas; either way one offset (host int or per-row tensor)
    and, for the arena, one block map serve all layers. Each layer gets
    its slice of the stacked tensors. `adapters` is (a stacked
    LoraAdapter, adapter_idx [b]): each layer gets its slice of the factors
    and the one index. Returns (x, kv_caches advanced by the step's length,
    or None, aux): aux sums the layers' MoE router losses (the float 0.0
    for a dense stack)."""
    lora = None
    if adapters is not None:
        stacked, aidx = adapters
        lora = [(lw, aidx) for lw in stacked.layers()]
    aux = 0.0
    for i, layer in enumerate(unstack_layers(stacked_params)):
        cache = None if kv_caches is None else kv_caches.layer(i)
        x, _, layer_aux = layer_apply(layer, x, cfg, rope_cos=rope_cos,
                           rope_sin=rope_sin, position_ids=position_ids,
                           kv_cache=cache, segment_ids=segment_ids,
                           deterministic=deterministic, generator=generator,
                           adapters=None if lora is None else lora[i])
        aux = aux + layer_aux
    if kv_caches is None:
        return x, None, aux
    return x, dataclasses.replace(kv_caches,
                                  offset=kv_caches.offset + x.shape[1]), aux
