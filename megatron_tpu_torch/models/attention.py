"""Multi-head / grouped-query / multi-query self-attention
(megatron_tpu/models/attention.py).

Parameters keep the reference's layout: wq [h, nq*hd], a fused wkv
[h, 2*nkv*hd] whose output splits as [.., 2, nkv, hd] (k at index 0, v at
index 1), and wo [nq*hd, h].

The serial serving path's KV cache holds its offset as a host int shared by
every row and layer, so the reference's `lax.cond` on "offset == 0" is a
plain branch here: an offset-0 multi-token prefill takes the flash kernel
over the fresh k/v, and decode steps and offset > 0 chunks take the dot path
over the cache's live region. The serving engine's slot grid gives the
cache a per-row int32 [b] offset tensor instead: row i writes its k/v at its
own offset and its causal mask starts there (the dot path over the whole
region). A `BlockKVCache` (the engine's block arena and per-slot block map)
takes the block-native path: the step's k/v land in the touched arena
blocks only and attention reads each slot's block chain through the map
(ops/block_attention.py, the Hopper kernel on the card). Cache writes are
in place.

An int8 cache (k/v int8 with fp32 `k_scale`/`v_scale` per (token, head))
quantizes the step's k/v over head_dim at write time (`quantize_rows`) and
reads them dequantized in the compute dtype; the block arena hands its
scales to the block kernel, which dequantizes inside. An int8 cache never
takes the offset-0 flash prefill: every cached forward then reads the same
dequantized values through the dot path, so a prefill and the decode steps
after it see the same numbers (attention.py:488-504).

A rolling cache (a sliding-window model's cache of exactly W =
`sliding_window` positions, generation.kv_region_cap) stores position p at
ring slot p % W; RoPE keeps absolute positions, only storage wraps. A
cached forward writes the last min(s, W) of its tokens, and attention masks
the ring through the slot -> position map (slot j holds the largest
p <= t_last with p % W == j; a never-written slot maps to a sentinel the
causal mask rejects). Its offset-0 multi-token prefill takes the flash
kernel with the window over the fresh k/v, which covers prompts longer than
W; an int8 rolling cache feeds the kernel the quantize -> dequantize round
trip of k/v, the values the ring holds. A multi-token step at offset > 0
on a rolling cache raises: its ring writes would evict history its own
queries need. The slot grid writes each row at offset % W (decode only:
a multi-token verify window is undefined on a ring).

The uncached (training) forward passes segment ids, and attention dropout
with its generator, to the flash path (ops/flash_attention.py, kernels on
the card); the dot path takes the segment mask too. `causal=False` makes
the attention bidirectional (BERT's and T5's encoders), and `kv_input`
makes it cross-attention (T5's decoder): k and v are projected from the
encoder output, with no rotary embedding, and sq may differ from sk. Both
take the uncached forward only.

Attention dropout on either path draws one seed from the generator and
keeps (batch, head, query, key) by the flash kernels' counter hash
(ops/flash_attention.py `_dropout_keep`), so the dot path and the flash
path drop the same weights for the same generator seed. The reference's
dot path draws its mask from `jax.random`, which torch cannot reproduce;
both apply inverted dropout to the softmax's weights, whose normalizer
keeps the undropped sum.

LoRA adapters (`adapters=`, the multi-tenant serving bank and the LoRA
finetune) add each row's low-rank delta x @ A[idx] @ B[idx] to the q, k, v
and o projections: the factors are gathered per row (`index_select`), cast
to the activation dtype, and applied as two batched products (`torch.bmm`),
as the reference computes them outside any Pallas kernel. The deltas join
before the head reshape and RoPE.

Under a (dp, cp, tp) mesh (`mesh=`, the sharded training step) the
weights are this rank's tp parts (parallel/sharding.py): wq and wo hold its
nq/tp heads, wkv its nkv/tp kv heads, or all of them when tp does not
divide nkv, and then the rank keeps the kv head of its q heads (global q
head j reads kv head j // (nq / nkv)). The input enters through
`tp_region_in` (a copy, or the sequence all-gather under sequence
parallelism), the output projection's partial sums leave through
`tp_region_out` (all-reduce, or reduce-scatter), and `bo` is added after
that. Attention dropout numbers the rank's rows by their place in the
whole step (batch offset dp coord x b, head offset tp coord x nq/tp, nq
heads in all), so a rank draws its slice of the unsharded step's mask.

With cp > 1 the rows are this rank's cp chunk of the sequence, and
attention takes the reference's `ring_branch`: `attention_impl` "ring"
(parallel/ring_attention.py; "pre_zigzag" when the loss permuted the
batch, `cp_pre_zigzag`, else the contiguous split) or "ulysses"
(parallel/ulysses.py), for causal self-attention with no segment ids, no
window and no active dropout. Everywhere else (those cases, or another
`attention_impl`) k and v, q and the segment ids are gathered over cp, the
flash kernel (the dot path for "dot") runs over the whole sequence, and
the rank keeps its rows: the unsharded call's result, dropout mask
included.

Cross-attention (`kv_input`, T5's decoder) under a mesh takes k and v from
the encoder output entered through `tp_region_in`, the sequence-gathered
output under sequence parallelism, for this rank's heads.

Left for later slices, and raising: a cached cross-attention (T5
inference), and caches and adapters under a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.rope import apply_rotary
from megatron_tpu_torch.ops.block_attention import block_native_attention
from megatron_tpu_torch.ops.flash_attention import (_dropout_keep,
                                                    draw_dropout_seed,
                                                    flash_attention)
from megatron_tpu_torch.ops.quantized import qdense, quantize_rows, wcast
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import (CONTEXT_AXIS, DATA_AXIS,
                                              TENSOR_AXIS)
from megatron_tpu_torch.parallel.ring_attention import ring_attention
from megatron_tpu_torch.parallel.sharding import cp_positions, kv_replicated
from megatron_tpu_torch.parallel.ulysses import ulysses_attention


class _Stacked:
    """What both caches share: k/v (int8 with fp32 `k_scale`/`v_scale`)
    stacked over layers."""

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def layer(self, i: int):
        """Layer i's slice of a stacked cache (views, written in place)."""
        return dataclasses.replace(
            self, k=self.k[i], v=self.v[i],
            k_scale=None if self.k_scale is None else self.k_scale[i],
            v_scale=None if self.v_scale is None else self.v_scale[i])


@dataclasses.dataclass
class KVCache(_Stacked):
    """KV cache: k/v [batch, max_seq, n_kv, head_dim] for one layer, or with
    a leading layers dim for the whole stack; `offset` tokens are filled:
    a host int shared by the rows, or an int32 [batch] tensor of per-row
    offsets (the serving engine's slot grid). An int8 cache carries fp32
    scales [batch, max_seq, n_kv, 1] (with the layers dim for the stack)."""
    k: torch.Tensor
    v: torch.Tensor
    offset: Union[int, torch.Tensor] = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclasses.dataclass
class BlockKVCache(_Stacked):
    """Block-native serving cache (attention.py BlockKVCache): the flat
    block arena and the per-slot block map, read in place by the block
    attention kernel; no contiguous [S, cap, ...] view exists.

      k/v:    [total_blocks, B, nkv, hd] for one layer, or with a leading
              layers dim for the whole stack
      offset: [num_slots] int32 per-slot live lengths
      map:    [num_slots, cap/B] int32, logical -> physical block (one map
              serves every layer)
      k_scale/v_scale: [total_blocks, B, nkv, 1] fp32 for int8 arenas
    """
    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor
    map: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class LoraAdapter(NamedTuple):
    """Batched LoRA factors of the q/k/v/o projections (attention.py
    LoraAdapter). Stacked (the bank, the finetune's factors): every leaf
    has a leading layers dim, [L, n, h, r] for A and [L, n, r, out] for B;
    per layer: [n, h, r] / [n, r, out]. `n` is the bank's capacity; the
    serving bank keeps row 0 all-zero, the identity adapter that base rows
    gather. The alpha/rank scale is folded into B at load."""
    aq: torch.Tensor  # [.., n, h, r]
    bq: torch.Tensor  # [.., n, r, nq*hd]
    ak: torch.Tensor  # [.., n, h, r]
    bk: torch.Tensor  # [.., n, r, nkv*hd]
    av: torch.Tensor  # [.., n, h, r]
    bv: torch.Tensor  # [.., n, r, nkv*hd]
    ao: torch.Tensor  # [.., n, nq*hd, r]
    bo: torch.Tensor  # [.., n, r, h]

    def layers(self) -> list:
        """Every layer's factors: one `unbind(0)` per stacked leaf (whose
        backward is one stack, as for the stacked weights)."""
        return [LoraAdapter(*fs) for fs in zip(*(f.unbind(0) for f in self))]


def _lora(inp: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
          aidx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-row low-rank delta (attention.py _lora): inp [b, s, d_in] ->
    [b, s, d_out] through each row's gathered [d_in, r] and [r, d_out]
    factors, cast to the activation dtype before the two products."""
    at = a.index_select(0, aidx).to(dtype)      # [b, d_in, r]
    bt = bmat.index_select(0, aidx).to(dtype)   # [b, r, d_out]
    return torch.bmm(torch.bmm(inp.to(dtype), at), bt)


def _cache_write(cache, index, k: torch.Tensor, v: torch.Tensor) -> None:
    """cache.k[index] = k and cache.v[index] = v in place; an int8 cache
    stores the values quantized per (token, head) with their scales."""
    if cache.quantized:
        (ki, ks), (vi, vs) = quantize_rows(k), quantize_rows(v)
        cache.k[index], cache.k_scale[index] = ki, ks
        cache.v[index], cache.v_scale[index] = vi, vs
    else:
        cache.k[index] = k.to(cache.k.dtype)
        cache.v[index] = v.to(cache.v.dtype)


def _cache_read(cache, index, dtype):
    """cache.k[index] and cache.v[index] in the compute dtype; int8 entries
    dequantized as k.astype(dtype) * k_scale.astype(dtype)."""
    k, v = cache.k[index].to(dtype), cache.v[index].to(dtype)
    if cache.quantized:
        return (k * cache.k_scale[index].to(dtype),
                v * cache.v_scale[index].to(dtype))
    return k, v


def _block_native_update_attend(q, k, v, cache: BlockKVCache, *,
                                scale: float):
    """Block-native KV append and attention for one layer.

    Append: row i's s tokens land at positions offset[i]..offset[i]+s-1, in
    physical block map[i, pos // B] at row pos % B. Positions at or past the
    region's capacity (idle rows parked at the length clamp, a verify
    window's tail at the clamp) go to the arena's last block, the pool's
    shared trash block, never onto a real block; the redirect keeps the
    index shape fixed, so the append reads nothing back to the host. Idle
    rows, whose map points every entry at the trash block, write their
    garbage there too. Read: the kernel walks each slot's block chain from
    its own offset over the post-append arena (write-before-read)."""
    S, s = q.shape[:2]
    T, B = cache.k.shape[:2]
    nb = cache.map.shape[1]
    offset = cache.offset
    pos = offset[:, None].long() + torch.arange(s, device=q.device)[None]
    rows = torch.arange(S, device=q.device)[:, None].expand(S, s)
    phys = torch.where(
        pos < nb * B,
        cache.map[rows, torch.clamp(pos // B, max=nb - 1)].long(), T - 1)
    _cache_write(cache, (phys, pos % B), k, v)
    out = block_native_attention(q, cache.k, cache.v, cache.map, offset,
                                 scale=scale, block_size=B,
                                 k_scale=cache.k_scale, v_scale=cache.v_scale)
    return out, dataclasses.replace(cache, offset=offset + s)


# a never-written ring slot's position: past every query, so the causal
# mask rejects it
RING_SENTINEL = 2 ** 30


def ring_positions(t_last: torch.Tensor, cap: int) -> torch.Tensor:
    """The slot -> position map of rolling caches whose last written
    position is `t_last` ([b, 1]): slot j holds the largest p <= t_last
    with p % cap == j, or RING_SENTINEL where that p is negative.
    Returns [b, cap]."""
    j = torch.arange(cap, device=t_last.device)[None]
    p = t_last - torch.remainder(t_last - j, cap)
    return torch.where(p >= 0, p, RING_SENTINEL)


def attention_init(cfg: ModelConfig) -> dict:
    """Parameter specs (attention.py attention_init): name -> (shape, init)."""
    h, hd = cfg.hidden_size, cfg.kv_channels
    nq, nkv = cfg.num_attention_heads, cfg.num_kv_heads
    std = cfg.init_method_std
    out_std = (std / math.sqrt(2.0 * cfg.num_layers) if cfg.use_scaled_init
               else std)
    specs = {"wq": ((h, nq * hd), ("normal", std)),
             "wkv": ((h, 2 * nkv * hd), ("normal", std)),
             "wo": ((nq * hd, h), ("normal", out_std))}
    if cfg.use_bias:
        specs["bq"] = ((nq * hd,), ("fill", 0.0))
        specs["bkv"] = ((2 * nkv * hd,), ("fill", 0.0))
        specs["bo"] = ((h,), ("fill", 0.0))
    return specs


def attention_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the parameters (attention.py attention_axes)."""
    axes = {"wq": ("embed", "heads"), "wkv": ("embed", "kv_heads"),
            "wo": ("heads", "embed")}
    if cfg.use_bias:
        axes.update({"bq": ("heads",), "bkv": ("kv_heads",),
                     "bo": ("embed",)})
    return axes


def _dot_attention(q, k, v, *, causal: bool, softmax_fp32: bool,
                   scale: float, q_offset=0,
                   sliding_window: Optional[int] = None, segment_ids=None,
                   kv_positions: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0, dropout_seed: int = 0,
                   batch_offset: int = 0, head_offset: int = 0,
                   total_heads: Optional[int] = None):
    """Unfused attention: QK^T -> mask -> softmax -> AV.

    q: [b, s, nq, hd]; k, v: [b, t, nkv, hd]. GQA reshapes q into
    [b, s, nkv, g, hd]. `q_offset` shifts the causal mask for queries that
    continue a cache: a host int, or an int [b] tensor of per-row offsets
    (the serving engine's slot grid). `kv_positions` is a rolling cache's
    slot -> position map, [t] shared or [b, t] per row (default: slot j
    holds position j). `segment_ids` [b, s] (s == t) masks attention
    block-diagonally across documents. `dropout_rate` > 0 drops weights
    after the softmax by the flash kernels' hash of `dropout_seed`, rows
    placed by the dropout index (ops/flash_attention.py)."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, s, nkv, g, hd)
    scores = torch.einsum("bsngd,btnd->bngst", qg, k) * scale
    if softmax_fp32:
        scores = scores.float()
    if causal:
        q_pos = torch.arange(s, device=q.device)
        if isinstance(q_offset, torch.Tensor):
            q_pos = q_offset.long()[:, None] + q_pos[None]  # [b, s]
        else:
            q_pos = (q_pos + q_offset)[None]  # [1, s]
        kv_pos = (torch.arange(t, device=q.device)[None]
                  if kv_positions is None else kv_positions.reshape(-1, t))
        win = q_pos[:, :, None] >= kv_pos[:, None, :]
        if sliding_window is not None:
            win = win & (q_pos[:, :, None] - kv_pos[:, None, :]
                         < sliding_window)
        scores = scores.masked_fill(~win[:, None, None],
                                    torch.finfo(scores.dtype).min)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]  # [b, s, t]
        scores = scores.masked_fill(~same[:, None, None],
                                    torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout_rate:
        dev = q.device
        heads = torch.arange(nq, device=dev).reshape(nkv, g)
        total = nq if total_heads is None else total_heads
        bh = ((torch.arange(b, device=dev)[:, None, None] + batch_offset)
              * total + head_offset + heads[None])[..., None, None]
        keep = _dropout_keep(dropout_seed, bh,
                             torch.arange(s, device=dev)[:, None],
                             torch.arange(t, device=dev)[None], dropout_rate)
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros_like(probs))
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    return out.reshape(b, s, nq, hd)


def attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                    rope_cos=None, rope_sin=None, position_ids=None,
                    kv_cache: Optional[KVCache] = None, segment_ids=None,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    adapters=None, causal: bool = True, kv_input=None,
                    mesh=None, cp_pre_zigzag: bool = False):
    """Self-attention, causal unless `causal` is False, or cross-attention
    over `kv_input` [b, t, h]. x: [b, s, h]. Returns (out [b, s, h], the
    per-layer cache advanced by s, or None without a cache). Attention
    dropout runs when `deterministic` is False and a `generator` is given,
    as the reference runs it only with an rng. `adapters` is a (per-layer
    LoraAdapter, adapter_idx int [b]) pair: row i adds the delta of bank
    row adapter_idx[i] to its projections; None runs no extra op. Under a
    `mesh` the weights are this rank's tp parts and x is [b, s/tp, h] with
    sequence parallelism, its cp chunk with cp > 1 (see the module's
    note); `cp_pre_zigzag`: the loss put the batch in the ring's zigzag
    order."""
    hd, nq, nkv = cfg.kv_channels, cfg.num_attention_heads, cfg.num_kv_heads
    cross = kv_input is not None
    # this rank's q and kv heads (all of them off a mesh) and their place
    nq_rank, nkv_rank = nq, nkv
    head_offset = batch_offset = 0
    cp = 1 if mesh is None else mesh.shape[CONTEXT_AXIS]
    if mesh is not None:
        if kv_cache is not None or adapters is not None:
            raise NotImplementedError(
                "attention under a mesh runs the uncached forward of the "
                "training step; caches and adapters are not ported under a "
                "mesh (ROADMAP Queue 1 item 7 (d))")
        if cross and cp > 1:
            raise NotImplementedError(
                "cross-attention (T5) under context parallelism is not "
                "ported (ROADMAP Queue 1 item 7 (g))")
        x = collectives.tp_region_in(x, mesh)
        if cross:
            kv_input = collectives.tp_region_in(kv_input, mesh)
        tp = mesh.shape[TENSOR_AXIS]
        nq_rank = nq // tp
        if not kv_replicated(nkv, mesh):
            nkv_rank = nkv // tp
        head_offset = mesh.coords[TENSOR_AXIS] * nq_rank
        batch_offset = mesh.coords[DATA_AXIS] * x.shape[0]
    b, s, _ = x.shape
    dtype = x.dtype
    if adapters is not None and cross:
        raise ValueError("LoRA adapters apply to self-attention "
                         "projections only; cross-attention has no adapter "
                         "path")
    if cfg.sliding_window is not None and (cross or not causal):
        raise ValueError("sliding_window requires causal self-attention")
    if kv_cache is not None and (cross or not causal):
        raise ValueError("cross and bidirectional attention take the "
                         "uncached forward (a cached T5 decoder is not "
                         "ported)")

    q = qdense(x, wcast(params["wq"], dtype), cfg.quantized_gemm)
    kv = qdense(kv_input if cross else x, wcast(params["wkv"], dtype),
                cfg.quantized_gemm)
    if cfg.use_bias:
        q = q + params["bq"].to(dtype)
        kv = kv + params["bkv"].to(dtype)
    lw = aidx = None
    if adapters is not None:
        lw, aidx = adapters
        aidx = aidx.long()
        # before the head reshape and RoPE: (W + A B) x, the merged-weights
        # semantics
        q = q + _lora(x, lw.aq, lw.bq, aidx, dtype)
    q = q.reshape(b, s, nq_rank, hd)
    kv = kv.reshape(b, kv.shape[1], 2, nkv_rank, hd)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if nq_rank < nq and nkv_rank == nkv > 1:
        # replicated kv (tp > nkv): the kv head of this rank's q heads
        kvh = head_offset // (nq // nkv)
        k, v = k[:, :, kvh:kvh + 1], v[:, :, kvh:kvh + 1]
    if lw is not None:
        k = k + _lora(x, lw.ak, lw.bk, aidx, dtype).reshape(b, s, nkv, hd)
        v = v + _lora(x, lw.av, lw.bv, aidx, dtype).reshape(b, s, nkv, hd)

    offset = 0
    per_slot = False
    if kv_cache is not None:
        offset = kv_cache.offset
        per_slot = isinstance(offset, torch.Tensor)
        if position_ids is None:
            steps = torch.arange(s, device=x.device)
            position_ids = (offset.long()[:, None] + steps[None] if per_slot
                            else (offset + steps).expand(b, s))
    if cfg.use_rotary_emb and not cross:
        if rope_cos is None or rope_sin is None:
            raise ValueError("cfg.use_rotary_emb=True requires rope_cos/"
                             "rope_sin tables (language_model.make_rope)")
        q = apply_rotary(q, rope_cos, rope_sin, position_ids)
        k = apply_rotary(k, rope_cos, rope_sin, position_ids)

    scale = 1.0 / math.sqrt(hd)
    window = cfg.sliding_window
    dropout_rate = (cfg.attention_dropout
                    if not deterministic and generator is not None else 0.0)
    if kv_cache is not None and (segment_ids is not None or dropout_rate):
        raise ValueError("segment ids and attention dropout take the "
                         "uncached (training) forward")
    rolling = (kv_cache is not None and window is not None
               and kv_cache.k.shape[-3] == window)
    if isinstance(kv_cache, BlockKVCache):
        if window is not None:
            raise ValueError("block-native attention has no sliding-window "
                             "mask (ServingConfig.validate refuses it)")
        out, new_cache = _block_native_update_attend(q, k, v, kv_cache,
                                                     scale=scale)
    elif per_slot:
        # slot grid: row i writes its tokens at offset[i].. (through the
        # ring on a rolling cache; positions past a flat region are
        # dropped, never clamped onto a live slot) and attends the whole
        # region causally from its own offset
        cap = kv_cache.k.shape[1]
        if rolling and s > 1:
            raise ValueError(
                "a multi-token slot-grid append (speculative verify) is "
                "undefined on a rolling cache: a rejected draft's ring "
                "write already evicted history (ServingConfig.validate "
                "refuses speculative_k on rolling pools)")
        pos = offset.long()[:, None] + torch.arange(s, device=x.device)
        rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
        kv_positions = None
        if rolling:
            _cache_write(kv_cache, (rows, pos % cap), k, v)
            kv_positions = ring_positions(pos[:, -1:], cap)
        else:
            live = pos < cap
            _cache_write(kv_cache, (rows[live], pos[live]), k[live],
                         v[live])
        new_cache = dataclasses.replace(kv_cache, offset=offset + s)
        kc, vc = _cache_read(kv_cache, ..., dtype)
        out = _dot_attention(
            q, kc, vc, causal=True,
            softmax_fp32=cfg.attention_softmax_in_fp32, scale=scale,
            q_offset=offset, sliding_window=window,
            kv_positions=kv_positions)
    elif kv_cache is not None:
        cap = kv_cache.k.shape[1]
        end = offset + s
        # the offset-0 flash prefill over the fresh k/v: causal attention
        # over the cache equals causal attention over them. An int8 cache
        # takes it only when rolling (a prompt longer than W has no dot
        # path), on the round trip of k/v through the int8 format
        flash_prefill = (cfg.attention_impl == "flash" and s > 1
                         and offset == 0
                         and (not kv_cache.quantized or rolling))
        kv_positions = None
        if rolling:
            if s > 1 and offset > 0:
                raise ValueError(
                    f"a {s}-token step at offset {offset} on a rolling "
                    "cache: its ring writes evict history its own queries "
                    "need (rolling caches prefill at offset 0 only)")
            if s > cap and not flash_prefill:
                raise ValueError(f"a {s}-token dot-path prefill into a "
                                 f"rolling cache of {cap}")
            keep = min(s, cap)
            slots = torch.arange(end - keep, end, device=x.device) % cap
            _cache_write(kv_cache, (slice(None), slots), k[:, s - keep:],
                         v[:, s - keep:])
            kv_positions = ring_positions(
                torch.tensor([[end - 1]], device=x.device), cap)
        else:
            if end > cap:
                raise ValueError(f"KV cache overflow: {end} positions into "
                                 f"a cache of {cap}")
            _cache_write(kv_cache, (slice(None), slice(offset, end)), k, v)
        new_cache = dataclasses.replace(kv_cache, offset=end)
        if flash_prefill:
            kr, vr = k, v
            if kv_cache.quantized:
                kr, vr = (qi.to(dtype) * qs.to(dtype) for qi, qs in
                          (quantize_rows(k), quantize_rows(v)))
            out = flash_attention(q, kr, vr, causal=True, scale=scale,
                                  sliding_window=window)
        else:
            kc, vc = _cache_read(
                kv_cache, (slice(None), slice(None, cap if rolling else end)),
                dtype)
            out = _dot_attention(
                q, kc, vc, causal=True,
                softmax_fp32=cfg.attention_softmax_in_fp32, scale=scale,
                q_offset=offset, sliding_window=window,
                kv_positions=kv_positions)
    else:
        new_cache = None
        seed = draw_dropout_seed(generator) if dropout_rate else 0
        ring_branch = (cfg.attention_impl in ("ring", "ulysses") and causal
                       and not cross and segment_ids is None
                       and window is None and not dropout_rate)
        # a pre-permuted batch must reach the ring: any drift between
        # data_zigzag_cp and this dispatch would mask the wrong rows
        if cp_pre_zigzag and not (ring_branch and cp > 1
                                  and cfg.attention_impl == "ring"):
            raise AssertionError(
                "cp_pre_zigzag=True but the ring-attention path is not "
                "taken (data_zigzag_cp and attention_apply gating drifted)")
        if ring_branch and cp > 1:
            if cfg.attention_impl == "ulysses":
                out = ulysses_attention(q, k, v, mesh, causal=True,
                                        scale=scale)
            else:
                # a batch the loss did not permute takes the contiguous
                # split: the ring then gathers nothing
                out = ring_attention(
                    q, k, v, mesh, causal=True, scale=scale,
                    layout="pre_zigzag" if cp_pre_zigzag else "contiguous")
        else:
            rows = None
            if cp > 1:
                # the whole sequence on every cp rank; this rank's rows
                rows = cp_positions(s * cp, mesh)
                q, k, v = (collectives.gather_axis(t, mesh, CONTEXT_AXIS, 1)
                           for t in (q, k, v))
                if segment_ids is not None:
                    segment_ids = collectives.all_gather(
                        segment_ids, mesh, CONTEXT_AXIS, 1)
            if cfg.attention_impl == "dot":
                out = _dot_attention(
                    q, k, v, causal=causal,
                    softmax_fp32=cfg.attention_softmax_in_fp32, scale=scale,
                    sliding_window=window, segment_ids=segment_ids,
                    dropout_rate=dropout_rate, dropout_seed=seed,
                    batch_offset=batch_offset, head_offset=head_offset,
                    total_heads=nq)
            else:
                out = flash_attention(q, k, v, causal=causal, scale=scale,
                                      sliding_window=window,
                                      segment_ids=segment_ids,
                                      dropout_rate=dropout_rate,
                                      dropout_seed=seed,
                                      batch_offset=batch_offset,
                                      head_offset=head_offset,
                                      total_heads=nq)
            if rows is not None:
                out = out[:, rows]

    out = out.reshape(b, s, nq_rank * hd)
    proj = qdense(out, wcast(params["wo"], dtype), cfg.quantized_gemm)
    if lw is not None:
        proj = proj + _lora(out, lw.ao, lw.bo, aidx, dtype)
    out = proj
    if mesh is not None:
        out = collectives.tp_region_out(out, mesh)
    if cfg.use_bias:
        out = out + params["bo"].to(dtype)
    return out, new_cache
