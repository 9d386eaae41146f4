"""Block-native decode attention: per-slot queries against K/V read through
the serving pool's block map (megatron_tpu/ops/block_attention_pallas.py).

`block_native_attention` dispatches on where q lies:

- a CUDA tensor goes to the hand-written Hopper kernel csrc/block_attn.cu
  (ops/block_attention_cuda.py), which reads the arena through the map in
  place. It launches or raises;
- a CPU tensor goes to the plain version `block_attention_reference`, the
  reference package's own test oracle (tests/test_block_attention_pallas.py
  `ref_block_attention`): gather each slot's blocks into a contiguous
  [S, cap, nkv, hd] view, dequantize with the scales if given, and take an
  fp32 masked softmax. The kernel is held against it on the card.

Layout: q [S, w, nq, hd]; arena k/v [T, B, nkv, hd] (int8 with fp32 scales
[T, B, nkv, 1]); block_map [S, nb] int32 (logical block -> physical
block); lengths [S] int32. Query j of slot s sits at position
lengths[s] + j and sees kv positions <= it, so w == 1 is decode and w > 1 a
verify window, causal within the window. The slot's own k/v for the window
must already be written into the arena (write-before-read).
"""
from __future__ import annotations

from typing import Optional

import torch

from megatron_tpu_torch.ops.block_attention_cuda import block_attention_cuda

# the TPU kernel's sentinel for masked scores
NEG_INF = -1e30


def block_attention_reference(q: torch.Tensor, k_arena: torch.Tensor,
                              v_arena: torch.Tensor, block_map: torch.Tensor,
                              lengths: torch.Tensor, *, scale: float,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain version: gather, dequantize, fp32 masked softmax. Returns
    [S, w, nq, hd] in q's dtype."""
    S, w, nq, hd = q.shape
    _, B, nkv, _ = k_arena.shape
    cap = block_map.shape[1] * B
    g = nq // nkv
    idx = block_map.long()

    def view(arena, sc):
        x = arena[idx].reshape(S, cap, nkv, hd).float()
        if sc is not None:
            x = x * sc[idx].reshape(S, cap, nkv, 1).float()
        return x

    k, v = view(k_arena, k_scale), view(v_arena, v_scale)
    qf = q.float().reshape(S, w, nkv, g, hd) * scale
    scores = torch.einsum("swngd,stnd->sngwt", qf, k)
    q_pos = lengths.long()[:, None] + torch.arange(w, device=q.device)
    keep = (torch.arange(cap, device=q.device)[None, None, :]
            <= q_pos[:, :, None])  # [S, w, cap]
    scores = scores.masked_fill(~keep[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("sngwt,stnd->swngd", probs, v)
    return out.reshape(S, w, nq, hd).to(q.dtype)


def block_native_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_map: torch.Tensor,
                           lengths: torch.Tensor, *, scale: float,
                           block_size: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Per-slot q against block-chained K/V straight out of the arena.
    Returns [S, w, nq, hd] in q's dtype."""
    if q.is_cuda:
        return block_attention_cuda(q, k_arena, v_arena, block_map, lengths,
                                    scale=scale, block_size=block_size,
                                    k_scale=k_scale, v_scale=v_scale)
    if k_arena.shape[1] != block_size:
        raise ValueError(f"block_size {block_size} does not match the "
                         f"arena's blocks of {k_arena.shape[1]}")
    return block_attention_reference(q, k_arena, v_arena, block_map,
                                     lengths, scale=scale, k_scale=k_scale,
                                     v_scale=v_scale)
