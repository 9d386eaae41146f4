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
given.

Activation recompute (`cfg.recompute_granularity`, the reference's
`jax.checkpoint` around its scanned layer body) wraps each layer in
`torch.utils.checkpoint` (non-reentrant) when grad is enabled and no KV
cache is written: "full" keeps only the layer's input and recomputes the
whole layer in the backward; "selective" also keeps the outputs of the
weight GEMMs (the QKV, output and MLP projections, through
`ops.quantized.GemmTape`) and the recompute hands them back in place of
the products, so it runs the norms, RoPE, core attention, activations
and dropout again but no weight GEMM, as the reference's
`dots_with_no_batch_dims_saveable` policy does (the MoE router's small
product, the experts' batched products and the LoRA products recompute).
A hand-written kernel (the flash forward) runs again in the recompute,
writing buffers the recompute allocates anew. Dropout draws from the
explicit generator, which torch's checkpoint does not replay: each layer
runs on a copy of the generator taken before its forward, the recompute
on another copy of the same state, and the caller's generator is moved
on to where the forward left its copy, so recompute draws the masks of
the forward and the layers after it draw what they draw without
recompute. The loss and grads are those of "none" bit for bit.

Under a (dp, cp, tp) mesh (`mesh=`, the sharded training step) each
layer's weights are this rank's parts and the residual stream is this
rank's dp rows and cp chunk, [b, s/tp, h] of it under sequence
parallelism; attention, the MLP and the expert bank place their
collectives (models/attention.py, mlp.py, moe.py), the cross-attention of
T5's decoder included, and every dropout draws the whole step's mask and
keeps this rank's region of it (ops/dropout.py; the zigzag positions when
the batch was pre-permuted, `cp_pre_zigzag`), so a sharded step drops what
the unsharded step drops with the same generator.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.attention import (BlockKVCache, KVCache,
                                                 attention_apply,
                                                 attention_axes,
                                                 attention_init)
from megatron_tpu_torch.models.mlp import mlp_apply, mlp_axes, mlp_init
from megatron_tpu_torch.models.moe import moe_apply, moe_axes, moe_init
from megatron_tpu_torch.models.norms import apply_norm, norm_axes, norm_init
from megatron_tpu_torch.ops.dropout import (drop_path, dropout, fold_seed,
                                            seeded)
from megatron_tpu_torch.ops.quantized import W8, GemmTape
from megatron_tpu_torch.parallel.sharding import activation_region


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


def layer_axes(cfg: ModelConfig, cross_attn: bool = False) -> dict:
    """Logical axes of one layer's parameters (transformer.py
    layer_axes)."""
    axes = {"attention": attention_axes(cfg),
            "mlp": moe_axes(cfg) if cfg.num_experts > 1 else mlp_axes(cfg)}
    if cross_attn:
        axes["inter_attention"] = attention_axes(cfg)
        axes["post_inter_norm"] = norm_axes(cfg.norm_type)
    if not cfg.use_post_ln:
        axes["input_norm"] = norm_axes(cfg.norm_type)
    else:
        axes["output_norm"] = norm_axes(cfg.norm_type)
    if not cfg.parallel_attn:
        axes["post_attn_norm"] = norm_axes(cfg.norm_type)
    if cfg.parallel_layernorm:
        axes["mlp_norm"] = norm_axes(cfg.norm_type)
    return axes


def stack_axes(cfg: ModelConfig, cross_attn: bool = False) -> dict:
    """Logical axes of the stacked leaves: "layers" prepended."""
    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        return ("layers",) + tree
    return stack(layer_axes(cfg, cross_attn=cross_attn))


def layer_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cos=None, rope_sin=None, position_ids=None,
                kv_cache: Optional[KVCache] = None, segment_ids=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                adapters=None, causal: bool = True, encoder_output=None,
                hidden_dropout: Optional[float] = None,
                drop_path_rate: Optional[float] = None, mesh=None,
                cp_pre_zigzag: bool = False):
    """One transformer layer. x: [b, s, h] ([b, s/tp, h] under a mesh with
    sequence parallelism; `mesh`: see the module's note). Returns (x, kv_cache, aux),
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

    def drop(out):
        region = (None if mesh is None
                  else activation_region(mesh, tuple(out.shape),
                                         zigzag=cp_pre_zigzag))
        return dropout(generator, out, p_drop, region)

    def branch(out):
        out = drop(out)
        if drop_path_rate is None:
            return out
        region = (None if mesh is None else activation_region(
            mesh, (out.shape[0],) + (1,) * (out.dim() - 1), per_sample=True))
        return drop_path(generator, out, drop_path_rate, region)

    def mlp_branch(inp):
        if cfg.num_experts > 1:
            return moe_apply(params["mlp"], inp, cfg, mesh=mesh)
        return mlp_apply(params["mlp"], inp, cfg, mesh=mesh), 0.0

    residual = x
    if cfg.use_post_ln:
        ln_out = x
    else:
        ln_out = apply_norm(cfg.norm_type, params["input_norm"], x, eps)
    attn_out, kv_cache = attention_apply(
        params["attention"], ln_out, cfg, rope_cos=rope_cos,
        rope_sin=rope_sin, position_ids=position_ids, kv_cache=kv_cache,
        segment_ids=segment_ids, deterministic=deterministic,
        generator=generator, adapters=adapters, causal=causal, mesh=mesh,
        cp_pre_zigzag=cp_pre_zigzag)
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
                kv_input=encoder_output, mesh=mesh)
            ln_in = ln_in + drop(inter_out)
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


def recompute(fn, x: torch.Tensor, granularity: str,
              generator: Optional[torch.Generator] = None):
    """`fn(x, generator)` under activation checkpointing at `granularity`
    ("full" or "selective"), its dropout masks drawn again in the
    recompute from a copy of the generator's state before the forward
    (see the module's note). Returns fn's outputs."""
    from torch.utils import checkpoint as ckpt
    if granularity not in ("full", "selective"):
        raise ValueError(f"recompute_granularity={granularity!r}")
    tape = GemmTape() if granularity == "selective" else None
    state = None if generator is None else generator.get_state()
    forward_generator = []

    def run(t):
        g = None
        if generator is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(state)
        with (contextlib.nullcontext() if tape is None
              else tape.active(replaying=bool(forward_generator))):
            out = fn(t, g)
        forward_generator.append(g)
        return out

    out = ckpt.checkpoint(run, x, use_reentrant=False)
    if generator is not None:
        generator.set_state(forward_generator[0].get_state())
    return out


def stack_apply(stacked_params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cos=None, rope_sin=None, position_ids=None,
                kv_caches: Union[KVCache, BlockKVCache, None] = None,
                segment_ids=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                adapters=None, causal: bool = True, encoder_output=None,
                mesh=None, cp_pre_zigzag: bool = False,
                layer_offset: int = 0, layer_seed: Optional[int] = None,
                remat: bool = True):
    """Apply every layer in order, each at its hidden-dropout and drop-path
    rate (`dropout_rates`). The stack's first layer is the model's layer
    `layer_offset` (a pipeline stage's chunk, parallel/pipeline.py): the
    rates are that layer's on, and with a `layer_seed` each layer draws
    its dropout from a generator of its own, seeded with
    `fold_seed(layer_seed, absolute layer id)`, in place of `generator`.
    `remat` False turns the layer recompute off (a pipeline chunk whose
    forward the schedule already recomputes). `kv_caches` is a KVCache of
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
    hidden, paths = dropout_rates(cfg, layer_offset + len(layers))
    hidden, paths = hidden[layer_offset:], paths[layer_offset:]
    remat = (remat and cfg.recompute_granularity != "none"
             and kv_caches is None and torch.is_grad_enabled())
    gen = None if deterministic else generator
    for i, layer in enumerate(layers):
        if layer_seed is not None and not deterministic:
            gen = seeded(fold_seed(layer_seed, layer_offset + i))
        cache = None if kv_caches is None else kv_caches.layer(i)

        def apply(h, g, layer=layer, cache=cache, i=i):
            return layer_apply(layer, h, cfg, rope_cos=rope_cos,
                               rope_sin=rope_sin, position_ids=position_ids,
                               kv_cache=cache, segment_ids=segment_ids,
                               deterministic=deterministic, generator=g,
                               adapters=None if lora is None else lora[i],
                               causal=causal, encoder_output=encoder_output,
                               hidden_dropout=hidden[i],
                               drop_path_rate=paths[i], mesh=mesh,
                               cp_pre_zigzag=cp_pre_zigzag)
        if remat:
            x, _, layer_aux = recompute(apply, x, cfg.recompute_granularity,
                                        gen)
        else:
            x, _, layer_aux = apply(x, gen)
        aux = aux + layer_aux
    if kv_caches is None:
        return x, None, aux
    return x, dataclasses.replace(kv_caches,
                                  offset=kv_caches.offset + x.shape[1]), aux
