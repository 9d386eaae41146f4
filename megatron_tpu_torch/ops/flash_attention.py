"""Flash attention forward: blockwise online-softmax attention.

Counterpart of megatron_tpu/ops/flash_attention.py. `flash_attention`
dispatches on where its inputs lie:

- a CUDA tensor goes to the hand-written Hopper kernel
  (ops/flash_attention_cuda.py, csrc/flash_fwd.cu), which launches or
  raises;
- a CPU tensor goes to `blockwise_attention`, the plain PyTorch version: a
  port of the reference's `_blockwise_attention` that also returns the
  per-row logsumexp. It is the numerics reference the kernel is checked
  against on the card.

Layout: q [b, sq, nq, d], k/v [b, sk, nkv, d], with GQA head h reading kv
head h // (nq // nkv). Causal masking is top-left aligned (query i sees
keys 0..i) and `sliding_window` W narrows it to keys i-W+1..i. The
logsumexp comes back as [b, nq, sq] fp32; a row with no visible key gets
zeros and lse NEG_INF, like the TPU kernel.

Segment ids and attention dropout belong to the training slice and raise.
"""
from __future__ import annotations

from typing import Optional

import torch

DEFAULT_BLOCK_KV = 512
# the TPU kernel's sentinel for masked scores, and the lse of an empty row
NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    sliding_window: Optional[int] = None,
                    segment_ids=None, dropout_rate: float = 0.0):
    """Returns out [b, sq, nq, d] in q's dtype."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, scale=scale, sliding_window=sliding_window,
        segment_ids=segment_ids, dropout_rate=dropout_rate)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: Optional[float] = None,
                             sliding_window: Optional[int] = None,
                             segment_ids=None, dropout_rate: float = 0.0):
    """Returns (out [b, sq, nq, d] in q's dtype, lse [b, nq, sq] fp32)."""
    if segment_ids is not None:
        raise NotImplementedError(
            "flash_attention: segment ids are ported with the training slice")
    if dropout_rate:
        raise NotImplementedError(
            "flash_attention: attention dropout is ported with the training "
            "slice")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        from megatron_tpu_torch.ops.flash_attention_cuda import flash_fwd_cuda
        return flash_fwd_cuda(q, k, v, causal=causal, scale=scale,
                              sliding_window=sliding_window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return blockwise_attention(q, k, v, causal=causal, scale=scale,
                               sliding_window=sliding_window)


def blockwise_attention(q, k, v, *, causal: bool, scale: Optional[float],
                        block_kv: int = DEFAULT_BLOCK_KV,
                        sliding_window: Optional[int] = None):
    """Plain version: the reference's `_blockwise_attention` in fp32, as a
    host loop over kv blocks (the last block may be short). Runs on any
    device. Returns (out in q's dtype, lse [b, nq, sq] fp32)."""
    b, sq, nq, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    g = nq // nkv
    dev = q.device
    qg = (q.float() * scale).reshape(b, sq, nkv, g, d)
    q_pos = torch.arange(sq, device=dev)
    acc = torch.zeros(b, sq, nkv, g, d, dtype=torch.float32, device=dev)
    m = torch.full((b, sq, nkv, g), float("-inf"), dtype=torch.float32,
                   device=dev)
    m_safe = torch.zeros_like(m)
    l = torch.zeros_like(m)
    for j0 in range(0, skv, block_kv):
        kj = k[:, j0:j0 + block_kv].float()
        vj = v[:, j0:j0 + block_kv].float()
        s = torch.einsum("bsngd,btnd->bsngt", qg, kj)
        if causal:
            kv_pos = j0 + torch.arange(kj.shape[1], device=dev)
            win = q_pos[:, None] >= kv_pos[None, :]
            if sliding_window is not None:
                win = win & (q_pos[:, None] - kv_pos[None, :]
                             < sliding_window)
            s = s.masked_fill(~win[None, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully masked rows (m_new = -inf): exp(-inf - -inf) -> use 0
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bsngt,btnd->bsngd",
                                                    p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    lse = torch.where(l > 0, m_safe + torch.log(l),
                      torch.full_like(l, NEG_INF))
    return (out.reshape(b, sq, nq, d).to(q.dtype),
            lse.reshape(b, sq, nq).transpose(1, 2).contiguous())
