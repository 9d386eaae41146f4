"""Rotary position embeddings with linear position interpolation
(megatron_tpu/models/rope.py).

Head-dim elements (2i, 2i+1) form the rotated pair: the interleaved (Meta)
layout the reference and its checkpoints use, not the half-split one.
"""
from __future__ import annotations

from typing import Optional

import torch


def precompute_freqs(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     scaling_factor: float = 1.0, *,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape [max_seq_len, head_dim // 2], fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32,
                     device=device) / scaling_factor
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate x [batch, seq, heads, head_dim] by position; `position_ids`
    [batch, seq] indexes the tables, else positions are 0..seq-1."""
    b, s, n, d = x.shape
    if position_ids is None:
        c = cos[:s][None, :, None, :]
        sn = sin[:s][None, :, None, :]
    else:
        c = cos[position_ids][:, :, None, :]
        sn = sin[position_ids][:, :, None, :]
    xr = x.float().reshape(b, s, n, d // 2, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * c - x1 * sn, x1 * c + x0 * sn], dim=-1)
    return out.reshape(b, s, n, d).to(x.dtype)
