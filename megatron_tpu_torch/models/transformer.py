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
router loss each layer returns and the stack sums.

`causal=False` makes the self-attention bidirectional (BERT's and T5's
encoders). A stack built with `cross_attn=True` (T5's decoder) has, per
layer, an `inter_attention` and its `post_inter_norm`: given
`encoder_output`, each layer attends it between self-attention and the
MLP, bidirectionally and with no segment ids, as the reference does.

Hidden dropout runs on the attention, cross-attention and MLP branches
before their residual adds (ops/dropout.py), at cfg.hidden_dropout for
every layer or, with `lima_dropout`, at the LIMA ramp linspace(0, p, L)
whose first layer drops nothing. `drop_path_rate` > 0 adds stochastic
depth on the attention and MLP branches at the ramp linspace(0, rate, L).
All of it runs only when `deterministic` is False and a generator is
given. Activation recompute belongs to a later slice and raises in
`loss_fn`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.attention import (BlockKVCache, KVCache,
                                                 attention_apply,
                                                 attention_init)
from megatron_tpu_torch.models.mlp import mlp_apply, mlp_init
from megatron_tpu_torch.models.moe import moe_apply, moe_init
from megatron_tpu_torch.models.norms import apply_norm, norm_init
from megatron_tpu_torch.ops.dropout import drop_path, dropout
from megatron_tpu_torch.ops.quantized import W8


def layer_init(cfg: ModelConfig, cross_attn: bool = False) -> dict:
    """Parameter specs of one layer (transformer.py layer_init): pre-LN has
    input_norm + post_attn_norm, post-LN output_norm + post_attn_norm,
    parallel_attn drops post_attn_norm, parallel_layernorm adds mlp_norm;
    `num_experts > 1` makes "mlp" an expert bank; `cross_attn` adds the
    decoder's inter_attention and post_inter_norm."""
    mlp = moe_init(cfg) if cfg.num_experts > 1 else mlp_init(cfg)
    specs = {"attention": attention_init(cfg), "mlp": mlp}
    norm = norm_init(cfg.norm_type, cfg.hidden_size)
    if cross_attn:
        specs["inter_attention"] = attention_init(cfg)
        specs["post_inter_norm"] = dict(norm)
    specs["output_norm" if cfg.use_post_ln else "input_norm"] = norm
    if not cfg.parallel_attn:
        specs["post_attn_norm"] = dict(norm)
    if cfg.parallel_layernorm:
        specs["mlp_norm"] = dict(norm)
    return specs


def stack_init(cfg: ModelConfig, num_layers: Optional[int] = None,
               cross_attn: bool = False) -> dict:
    """Stacked specs: every leaf gains a leading layers dim."""
    n = cfg.num_layers if num_layers is None else num_layers

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        shape, init = tree
        return ((n, *shape), init)
    return stack(layer_init(cfg, cross_attn=cross_attn))


def layer_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cos=None, rope_sin=None, position_ids=None,
                kv_cache: Optional[KVCache] = None, segment_ids=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                adapters=None, causal: bool = True, encoder_output=None,
                hidden_dropout: Optional[float] = None,
                drop_path_rate: Optional[float] = None):
    """One transformer layer. x: [b, s, h]. Returns (x, kv_cache, aux),
    aux being the MoE router's load-balancing loss (a 0-d fp32 tensor), or
    the float 0.0 for a dense MLP, which launches nothing.
    `generator` draws the dropout masks when `deterministic` is False;
    `hidden_dropout` (cfg.hidden_dropout when None) and `drop_path_rate`
    (none when None) are this layer's rates. `adapters` is (this layer's
    LoraAdapter, adapter_idx [b]) or None. `encoder_output` [b, t, h]
    runs the cross-attention sublayer of a layer that has one.

      ln_out = input_norm(x)                (identity when post-LN)
      attn   = attention(ln_out)
      parallel_attn: out = x + dp(drop(mlp(mlp_in) + attn))
      else:          ln_in = x + dp(drop(attn))
                     ln_in = ln_in + drop(cross(post_inter_norm(ln_in)))
                     out = ln_in + dp(drop(mlp(post_attn_norm(ln_in))))
      out = output_norm(out)                (identity when pre-LN)
    """
    eps = cfg.norm_epsilon
    if deterministic:
        generator = None
    p_drop = cfg.hidden_dropout if hidden_dropout is None else hidden_dropout

    def branch(out):
        out = dropout(generator, out, p_drop)
        if drop_path_rate is None:
            return out
        return drop_path(generator, out, drop_path_rate)

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
        generator=generator, adapters=adapters, causal=causal)
    if cfg.parallel_attn:
        if cfg.parallel_layernorm:
            mlp_in = apply_norm(cfg.norm_type, params["mlp_norm"], residual,
                                eps)
        else:
            mlp_in = ln_out
        mlp_out, aux = mlp_branch(mlp_in)
        out = residual + branch(mlp_out + attn_out)
    else:
        ln_in = residual + branch(attn_out)
        if encoder_output is not None and "inter_attention" in params:
            # no generator: the reference's cross-attention runs without
            # attention dropout
            ln_x = apply_norm(cfg.norm_type, params["post_inter_norm"],
                              ln_in, eps)
            inter_out, _ = attention_apply(
                params["inter_attention"], ln_x, cfg,
                deterministic=deterministic, causal=False,
                kv_input=encoder_output)
            ln_in = ln_in + dropout(generator, inter_out, p_drop)
        ln2 = apply_norm(cfg.norm_type, params["post_attn_norm"], ln_in, eps)
        mlp_out, aux = mlp_branch(ln2)
        out = ln_in + branch(mlp_out)
    if cfg.use_post_ln:
        out = apply_norm(cfg.norm_type, params["output_norm"], out, eps)
    return out, kv_cache, aux


def dropout_rates(cfg: ModelConfig, num_layers: int) -> tuple:
    """Per-layer (hidden dropout, drop-path) rates as Python floats: the
    LIMA ramp linspace(0, p, L) in fp32 (first layer exactly 0) or p for
    every layer, and linspace(0, drop_path_rate, L) or None for every
    layer when drop-path is off (transformer.py lima_dropout_rates,
    drop_path_rates). L is cfg.num_layers; a stack deeper than that (a
    decoder of more layers) keeps the last rate."""
    n = cfg.num_layers
    if cfg.lima_dropout:
        hidden = np.linspace(0.0, cfg.hidden_dropout, n,
                             dtype=np.float32).tolist()
    else:
        hidden = [cfg.hidden_dropout] * n
    paths = ([None] * n if cfg.drop_path_rate <= 0.0 else
             np.linspace(0.0, cfg.drop_path_rate, n,
                         dtype=np.float32).tolist())
    pad = max(num_layers - n, 0)
    return hidden + hidden[-1:] * pad, paths + paths[-1:] * pad


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
                adapters=None, causal: bool = True, encoder_output=None):
    """Apply every layer in order, each at its hidden-dropout and drop-path
    rate (`dropout_rates`). `kv_caches` is a KVCache of
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
    layers = unstack_layers(stacked_params)
    hidden, paths = dropout_rates(cfg, len(layers))
    for i, layer in enumerate(layers):
        cache = None if kv_caches is None else kv_caches.layer(i)
        x, _, layer_aux = layer_apply(layer, x, cfg, rope_cos=rope_cos,
                           rope_sin=rope_sin, position_ids=position_ids,
                           kv_cache=cache, segment_ids=segment_ids,
                           deterministic=deterministic, generator=generator,
                           adapters=None if lora is None else lora[i],
                           causal=causal, encoder_output=encoder_output,
                           hidden_dropout=hidden[i],
                           drop_path_rate=paths[i])
        aux = aux + layer_aux
    if kv_caches is None:
        return x, None, aux
    return x, dataclasses.replace(kv_caches,
                                  offset=kv_caches.offset + x.shape[1]), aux
