"""Autoregressive generation with a KV cache
(megatron_tpu/inference/generation.py).

One prefill pass over the common prompt prefix, then a per-token decode
loop on the host where the reference scans. Rows still inside their prompt
feed their prompt token; finished rows emit pad. The shapes follow the
reference: the prefill length rounds down to PREFILL_BUCKET and the cache
length up to a multiple of 64. The decode loop stops at the longest
requested length instead of running on to the bucketed cache end, which
changes no token or logprob inside any row's requested span.

`kv_cache_dtype=torch.int8` stores the cache int8 with fp32 scales per
(token, head) (models/attention.py); the model may be int8-resident
(`ops.quantized.quantize_weights`). A model whose `sliding_window` W is
below the cache length gets a rolling cache of W positions
(`kv_region_cap`): position p lives at p % W and attention masks by the
slot -> position map, so memory is O(W) for any stream length.

The serving engine's multi-token appends: `prefill_chunk` forwards one
prompt chunk through a batch-1 cache at its offset (chunked prefill, a
prefix hit's suffix, a preemption replay), `verify_tokens` a
[slots, w]-token window through the slot grid at per-row offsets (the
speculative verify round). Sharded serving belongs to a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.sampling import sample
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.models.attention import KVCache
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


class SamplingParams(NamedTuple):
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0


# Generator.generate rounds the prefill length DOWN to this multiple, as the
# reference does for its jit-cache buckets
PREFILL_BUCKET = 16


def kv_region_cap(cfg: ModelConfig, max_len: int,
                  prefill_len: Optional[int] = None) -> int:
    """Token capacity of one sequence's KV region, the one source of the
    rolling decision (`init_kv_caches` allocates it, the serving pool
    sizes from it). With `sliding_window` W < max_len the region rolls
    (holds the last W positions) when the prefill can land in W slots: the
    flash impl computes the prefill from the raw k/v, and a dot-impl
    prefill of at most W tokens overwrites nothing. A longer dot-impl
    prefill keeps the full-length region (correct, not memory-bounded)."""
    if cfg.sliding_window is not None and (
            cfg.attention_impl == "flash"
            or (prefill_len is not None
                and prefill_len <= cfg.sliding_window)):
        return min(max_len, cfg.sliding_window)
    return max_len


def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, prefill_len: Optional[int] = None,
                   per_slot_offsets: bool = False, *,
                   device=None) -> KVCache:
    """Stacked-over-layers cache [L, b, cap, nkv, hd], cap =
    `kv_region_cap(cfg, max_len, prefill_len)`: max_len, or the window W
    of a rolling cache. The offset is one host int shared by every row and
    layer, or with `per_slot_offsets` an int32 [b] tensor on the cache's
    device, shared by the layers: the serving engine's slot grid, where
    every row is a request at its own position. `dtype=torch.int8` adds
    fp32 scales [L, b, cap, nkv, 1] set to 1.0 (a zero scale would turn a
    garbage read into NaN)."""
    max_len = kv_region_cap(cfg, max_len, prefill_len)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.kv_channels)
    offset = (torch.zeros(batch, dtype=torch.int32, device=device)
              if per_slot_offsets else 0)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), offset,
                   *kv_scales(shape, dtype, device))


def kv_scales(shape, dtype, device):
    """(k_scale, v_scale) of an int8 cache or arena of k/v `shape`: ones
    [..., 1] in fp32; (None, None) for any other dtype."""
    if dtype != torch.int8:
        return None, None
    sshape = (*shape[:-1], 1)
    return (torch.ones(sshape, dtype=torch.float32, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device))


def prefill_chunk(params, tokens: torch.Tensor, cache: KVCache,
                  cfg: ModelConfig, *, rope, last_idx: int,
                  next_offset: int, adapters=None):
    """Forward one [1, s] prompt chunk through a batch-1 cache at its
    offset (generation.py prefill_chunk) and return (cache,
    logits row [padded_vocab] of the chunk's token `last_idx`). Offset 0
    is a whole prefill (the flash kernel); offset > 0 a continuation that
    takes the dot path with the causal mask starting at the offset. The
    cache's offset becomes `next_offset`, the real token count, so the
    next chunk overwrites a padded chunk's pad positions
    (write-before-read). `adapters` is the (bank, adapter_idx [1]) pair of
    the request's LoRA adapter, or None."""
    logits, cache = lm.model_forward(
        params, tokens, cfg, kv_caches=cache, rope=rope,
        head_positions=torch.tensor([last_idx], device=tokens.device),
        adapters=adapters)
    cache.offset = int(next_offset)
    return cache, logits[0, 0]


def verify_tokens(params, tokens: torch.Tensor, caches, cfg: ModelConfig,
                  *, rope, lengths: torch.Tensor, max_len: int,
                  adapters=None):
    """Forward a [slots, w]-token window through the slot grid at per-row
    offsets `lengths` (generation.py verify_tokens): row i's tokens land
    at positions lengths[i]..lengths[i]+w-1, each query causally masked
    from its row's own offset. `caches` is the slot-grid KVCache or the
    block-native BlockKVCache (the block kernel at w > 1). Positions past
    the region are dropped from the write and rope positions clamp at
    max_len - 1: garbage logits for rows at the clamp, which the caller's
    accept mask discards. The caller rewinds the offsets to the accepted
    length. `adapters` is the (bank, per-slot adapter_idx [slots]) pair:
    each row verifies under its own adapter. Returns (logits
    [slots, w, padded_vocab] fp32, caches)."""
    w = tokens.shape[1]
    caches = dataclasses.replace(caches, offset=lengths)
    positions = torch.clamp(
        lengths.long()[:, None] + torch.arange(w, device=tokens.device),
        max=max_len - 1)
    return lm.model_forward(params, tokens, cfg, kv_caches=caches,
                            position_ids=positions, rope=rope,
                            adapters=adapters)


def _decode_fn(params, tokens, lengths, generator, *, cfg: ModelConfig,
               max_len: int, min_prompt: int, end: int, sp: SamplingParams,
               eos_id: int, pad_id: int, rope, kv_dtype=torch.bfloat16):
    """tokens: [b, max_len] prompts right-padded (written in place);
    lengths: [b] prompt lengths. Prefill [0, min_prompt), then decode
    positions min_prompt..end-1. Returns (tokens, logprobs [b, max_len])."""
    b = tokens.shape[0]
    caches = init_kv_caches(cfg, b, max_len, dtype=kv_dtype,
                            prefill_len=min_prompt, device=tokens.device)
    logits, caches = lm.model_forward(params, tokens[:, :min_prompt], cfg,
                                      kv_caches=caches, rope=rope)
    last = logits[:, -1]
    done = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    logprobs = torch.zeros(b, max_len, dtype=torch.float32,
                           device=tokens.device)
    for pos in range(min_prompt, end):
        sampled = sample(generator, last, top_k=sp.top_k, top_p=sp.top_p,
                         temperature=sp.temperature,
                         vocab_size=cfg.vocab_size)
        # rows still inside their prompt keep their prompt token
        in_prompt = pos < lengths
        cur = torch.where(in_prompt, tokens[:, pos], sampled)
        cur = torch.where(done, pad_id, cur)
        tokens[:, pos] = cur
        logprobs[:, pos] = torch.log_softmax(last, dim=-1).gather(
            -1, cur[:, None])[:, 0]
        done = done | ((cur == eos_id) & ~in_prompt)
        if pos + 1 < end:
            logits, caches = lm.model_forward(params, cur[:, None], cfg,
                                              kv_caches=caches, rope=rope)
            last = logits[:, 0]
    return tokens, logprobs


class Generator:
    """Generation over one model on one device.

    `model` is a LanguageModel, or a parameter tree such as
    `quantize_weights` returns, whose weights lie on `device` (the current
    CUDA device when None; raises without one). `kv_cache_dtype` may be
    torch.int8."""

    def __init__(self, model, cfg: ModelConfig, eos_id: int,
                 pad_id: Optional[int] = None, *,
                 kv_cache_dtype=torch.bfloat16, device: DeviceLike = None):
        self.device = resolve_device(device)
        where = lm.params_device(model)
        if where != self.device:
            raise ValueError(f"model weights lie on {where}, the "
                             f"generator runs on {self.device}")
        self.params = model
        self.cfg = cfg
        self.eos_id = eos_id
        self.pad_id = pad_id if pad_id is not None else eos_id
        self.kv_cache_dtype = kv_cache_dtype
        self.rope = lm.make_rope(cfg, max_len=cfg.max_position_embeddings,
                                 device=self.device)

    @torch.inference_mode()
    def generate(self, prompts: list[list[int]], max_new_tokens: int,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0):
        """prompts: lists of token ids. Returns numpy (tokens [b, max_len],
        lengths [b] up to and including a first eos, logprobs [b, max_len])."""
        b = len(prompts)
        lengths = np.array([len(p) for p in prompts], np.int64)
        max_len = int(lengths.max()) + max_new_tokens
        max_pos = self.cfg.max_position_embeddings
        if max_len > max_pos:
            raise ValueError(
                f"prompt ({int(lengths.max())}) + max_new_tokens "
                f"({max_new_tokens}) = {max_len} exceeds "
                f"max_position_embeddings={max_pos}; positions past the RoPE "
                "table would silently clamp")
        end = max_len
        max_len = min(-(-max_len // 64) * 64, max_pos)
        min_prompt = max(
            (int(lengths.min()) // PREFILL_BUCKET) * PREFILL_BUCKET, 1)
        toks = np.full((b, max_len), self.pad_id, np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tokens, logprobs = _decode_fn(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(lengths).to(self.device), gen, cfg=self.cfg,
            max_len=max_len, min_prompt=min_prompt, end=end, sp=sampling,
            eos_id=self.eos_id, pad_id=self.pad_id, rope=self.rope,
            kv_dtype=self.kv_cache_dtype)
        tokens = tokens.cpu().numpy()
        logprobs = logprobs.cpu().numpy()
        out_lens = []
        for i in range(b):
            requested = int(lengths[i]) + max_new_tokens
            hits = np.where(tokens[i, lengths[i]:requested] == self.eos_id)[0]
            out_lens.append(int(lengths[i]) + int(hits[0]) + 1 if len(hits)
                            else requested)
        return tokens, np.asarray(out_lens, np.int64), logprobs

    @torch.inference_mode()
    def score(self, token_rows: list[list[int]]) -> np.ndarray:
        """Per-token logprobs [b, max_len - 1] of the given sequences."""
        b = len(token_rows)
        max_len = max(len(t) for t in token_rows)
        toks = np.full((b, max_len), self.pad_id, np.int64)
        for i, t in enumerate(token_rows):
            toks[i, :len(t)] = t
        tokens = torch.from_numpy(toks).to(self.device)
        logits, _ = lm.model_forward(self.params, tokens, self.cfg,
                                     rope=self.rope)
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        return lp.gather(-1, tokens[:, 1:, None])[..., 0].cpu().numpy()


@torch.inference_mode()
def beam_search(generator: Generator, prompt: list[int], beam_width: int,
                max_new_tokens: int, length_penalty: float = 1.0):
    """Beam search: the `beam_width` hypotheses run as one batch; each step
    expands to beam_width * vocab candidates and keeps the best beam_width
    by cumulative logprob (finished beams stay as single candidates), and
    the final ranking is length-penalized. Returns numpy (tokens, lengths,
    scores), best first."""
    cfg, eos, params, rope = (generator.cfg, generator.eos_id,
                              generator.params, generator.rope)
    dev = generator.device
    prompt_len = len(prompt)
    max_len = prompt_len + max_new_tokens
    bw = beam_width

    toks = np.full((bw, max_len), generator.pad_id, np.int64)
    toks[:, :prompt_len] = prompt
    tokens = torch.from_numpy(toks).to(dev)
    caches = init_kv_caches(cfg, bw, max_len, dtype=generator.kv_cache_dtype,
                            prefill_len=prompt_len, device=dev)
    logits, caches = lm.model_forward(params, tokens[:, :prompt_len], cfg,
                                      kv_caches=caches, rope=rope)
    last = logits[:, -1]
    scores = torch.tensor([0.0] + [-1e9] * (bw - 1), dtype=torch.float32,
                          device=dev)
    done = torch.zeros(bw, dtype=torch.bool, device=dev)
    for pos in range(prompt_len, max_len):
        lp = torch.log_softmax(last, dim=-1)
        V = lp.shape[-1]
        lp[:, cfg.vocab_size:] = float("-inf")
        cand = (lp.masked_fill(done[:, None], float("-inf"))
                + scores[:, None]).reshape(-1)
        keep_done = scores.masked_fill(~done, float("-inf"))
        all_scores = torch.cat([cand, keep_done])
        top = torch.topk(all_scores, bw).indices
        is_kept_done = top >= bw * V
        parent = torch.where(is_kept_done, top - bw * V, top // V)
        token = torch.where(is_kept_done, generator.pad_id, top % V)
        scores = all_scores[top]
        tokens = tokens[parent]
        caches = KVCache(
            caches.k[:, parent], caches.v[:, parent], caches.offset,
            *(None if sc is None else sc[:, parent]
              for sc in (caches.k_scale, caches.v_scale)))
        tokens[:, pos] = token
        done = done[parent] | (token == eos)
        if pos + 1 == max_len or bool(done.all()):
            break
        logits, caches = lm.model_forward(params, tokens[:, pos, None], cfg,
                                          kv_caches=caches, rope=rope)
        last = logits[:, 0]
    tokens = tokens.cpu().numpy()
    scores = scores.cpu().numpy()
    out_len = np.full((bw,), max_len)
    for i in range(bw):
        hits = np.where(tokens[i, prompt_len:] == eos)[0]
        if len(hits):
            out_len[i] = prompt_len + hits[0] + 1
    gen_len = np.maximum(out_len - prompt_len, 1)
    final = scores / (gen_len ** length_penalty)
    order = np.argsort(-final)
    return tokens[order], out_len[order], final[order]
