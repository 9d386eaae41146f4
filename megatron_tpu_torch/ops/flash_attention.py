"""Flash attention: blockwise online-softmax attention, forward and backward.

Counterpart of megatron_tpu/ops/flash_attention.py and the custom VJP of
megatron_tpu/ops/flash_attention_pallas.py. `flash_attention` and
`flash_attention_with_lse` run a `torch.autograd.Function` whose forward
and backward dispatch on where the inputs lie:

- a CUDA tensor goes to the hand-written Hopper kernels
  (ops/flash_attention_cuda.py): csrc/flash_fwd.cu forward, and the dQ and
  dK/dV kernels of csrc/flash_bwd.cu backward. They launch or raise;
- a CPU tensor goes to the plain PyTorch versions, `blockwise_attention`
  and `blockwise_attention_bwd`, which compute the Pallas kernels'
  formulas in fp32 and are the references the kernels are held against
  on the card.

Layout: q [b, sq, nq, d], k/v [b, sk, nkv, d], with GQA head h reading kv
head h // (nq // nkv). Causal masking is top-left aligned (query i sees
keys 0..i) and `sliding_window` W narrows it to keys i-W+1..i. The
logsumexp is [b, nq, sq] fp32; a row with no visible key gets zeros and lse
NEG_INF, like the TPU kernel.

`segment_ids` [b, s] (one row shared by q and k, so sq == sk) masks
attention block-diagonally across documents. Attention dropout is the TPU
kernel's counter hash (`_dropout_keep`), ported bit-exact: the keep bit of
(batch b, q-head h, query i, key j) depends only on the seed, b * nq + h,
i and j, so the forward and both backward passes regenerate the same mask
without storing it, at any tile size. A call over a slice of a larger
call's rows (a data-parallel rank's batch rows, a tensor-parallel rank's
heads) names its place with `batch_offset`, `head_offset` and
`total_heads`: the hash then numbers row (b, h) as (b + batch_offset) *
total_heads + head_offset + h, so the slice draws exactly its part of the
larger call's mask. The softmax normalizer keeps the
undropped sum; only P V sees z = keep / (1 - rate). The seed is an integer
in [0, 2^23), drawn from a `torch.Generator` (a CPU generator draws it
without a device sync), as the reference draws it from a JAX key.

Backward, as `_flash_bwd_core`: delta = rowsum(dO * O) is computed outside
the kernels, then with p = exp(s - max(lse, MASK_CLAMP)):
dp = dO V^T * z, ds = p * (dp - delta + dlse), dq = ds K * scale,
dk = ds^T q * scale and dv = (p * z)^T dO, summed over each GQA group.
"""
from __future__ import annotations

from typing import Optional

import torch

DEFAULT_BLOCK_KV = 512
# the TPU kernel's sentinel for masked scores, and the lse of an empty row
NEG_INF = -1e30
# exponent clamp for rows whose every score is masked (see the TPU kernel)
MASK_CLAMP = -1e20
# the dropout seed is drawn below this bound, as flash_attention.py:88-90
DROPOUT_SEED_BOUND = 1 << 23

_M32 = 0xFFFFFFFF
_FMIX_M1 = 0x85EBCA6B
_FMIX_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B1
_ROW_MIX = 0x61C88647


def _mul32(x, c: int):
    """x * c mod 2^32 for 0 <= x < 2^32 (int64 tensors or ints), split so
    that no partial product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """murmur3's finalizer on uint32 values held in int64: wrapping
    multiplies and logical shifts, as flash_attention_pallas.py `_fmix32`."""
    x = x ^ (x >> 16)
    x = _mul32(x, _FMIX_M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _FMIX_M2)
    return x ^ (x >> 16)


def _dropout_row(seed: int, bh, q_pos):
    """The per-(batch * head, query) half of the hash."""
    return _fmix32((seed & _M32) ^ _mul32(bh, _GOLDEN) ^ _mul32(q_pos, _ROW_MIX))


def _dropout_keep_from_row(row, kv_pos, rate: float):
    u = _fmix32(row ^ kv_pos)
    return (u >> 1) >= int(rate * float(2 ** 31))


def _dropout_keep(seed: int, bh, q_pos, kv_pos, rate: float):
    """Keep bit of attention dropout (flash_attention_pallas.py
    `_dropout_keep`) at absolute query position `q_pos` and key position
    `kv_pos` for `bh` = batch * nq + q-head; arguments broadcast, as int64
    tensors or Python ints."""
    return _dropout_keep_from_row(_dropout_row(seed, bh, q_pos), kv_pos, rate)


def draw_dropout_seed(generator: torch.Generator) -> int:
    """One dropout seed in [0, 2^23) from `generator`."""
    return int(torch.randint(0, DROPOUT_SEED_BOUND, (1,), generator=generator,
                             device=generator.device).item())


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    sliding_window: Optional[int] = None,
                    segment_ids=None, dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    dropout_seed: Optional[int] = None,
                    batch_offset: int = 0, head_offset: int = 0,
                    total_heads: Optional[int] = None):
    """Returns out [b, sq, nq, d] in q's dtype, differentiable."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, scale=scale, sliding_window=sliding_window,
        segment_ids=segment_ids, dropout_rate=dropout_rate,
        generator=generator, dropout_seed=dropout_seed,
        batch_offset=batch_offset, head_offset=head_offset,
        total_heads=total_heads)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: Optional[float] = None,
                             sliding_window: Optional[int] = None,
                             segment_ids=None, dropout_rate: float = 0.0,
                             generator: Optional[torch.Generator] = None,
                             dropout_seed: Optional[int] = None,
                             batch_offset: int = 0, head_offset: int = 0,
                             total_heads: Optional[int] = None):
    """Returns (out [b, sq, nq, d] in q's dtype, lse [b, nq, sq] fp32), both
    differentiable: an lse cotangent enters the backward as `dlse`. With
    `dropout_rate` > 0 the seed is `dropout_seed` or, without one, drawn
    from `generator`, and `batch_offset`, `head_offset` and `total_heads`
    (None: nq) place the call's rows in the mask of a larger call (see the
    module's note)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError("flash_attention: sliding_window must be > 0")
    if segment_ids is not None and (
            q.shape[1] != k.shape[1]
            or tuple(segment_ids.shape) != (q.shape[0], q.shape[1])):
        raise ValueError("flash_attention: segment_ids must be [b, s] with "
                         "sq == sk")
    seed = 0
    if dropout_rate:
        if not 0.0 < dropout_rate < 1.0:
            raise ValueError(f"flash_attention: dropout_rate {dropout_rate} "
                             "not in [0, 1)")
        if dropout_seed is None:
            if generator is None:
                raise ValueError("flash_attention: dropout needs a generator "
                                 "or a dropout_seed")
            dropout_seed = draw_dropout_seed(generator)
        seed = int(dropout_seed)
    total = q.shape[2] if total_heads is None else int(total_heads)
    if batch_offset < 0 or head_offset < 0 or total < head_offset + q.shape[2]:
        raise ValueError(f"flash_attention: dropout index (batch offset "
                         f"{batch_offset}, head offset {head_offset}, total "
                         f"heads {total}) does not hold {q.shape[2]} heads")
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal),
                                 float(scale), sliding_window,
                                 float(dropout_rate), seed, int(batch_offset),
                                 int(head_offset), total)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) [b, nq, sq] fp32, the backward's per-row term
    (flash_attention_pallas.py:503-505)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _device_route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"flash_attention: no kernel for device {t.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward and backward of flash attention; saves q, k, v, out and lse,
    nothing of size s^2."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale, sliding_window,
                dropout_rate, dropout_seed, batch_offset, head_offset,
                total_heads):
        kw = dict(causal=causal, scale=scale, sliding_window=sliding_window,
                  segment_ids=segment_ids, dropout_rate=dropout_rate,
                  dropout_seed=dropout_seed, batch_offset=batch_offset,
                  head_offset=head_offset, total_heads=total_heads)
        if _device_route(q) == "cuda":
            from megatron_tpu_torch.ops.flash_attention_cuda import \
                flash_fwd_cuda
            out, lse = flash_fwd_cuda(q, k, v, **kw)
        else:
            out, lse = blockwise_attention(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        kw = dict(ctx.kw, segment_ids=segment_ids)
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        if dlse is not None:
            dlse = dlse.float().contiguous()
        delta = attention_delta(out, dout)
        if _device_route(q) == "cuda":
            from megatron_tpu_torch.ops.flash_attention_cuda import (
                flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
            dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, dlse=dlse, **kw)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, dlse=dlse,
                                        **kw)
        else:
            dq, dk, dv = blockwise_attention_bwd(q, k, v, dout, lse, delta,
                                                 dlse=dlse, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None, None, None


def _block_mask(q_pos, kv_pos, *, causal, sliding_window, seg_q, seg_k):
    """Visible (query, key) pairs of one kv block: [b|1, sq, t] bool, or
    None where every pair is visible."""
    mask = None
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
        if sliding_window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < sliding_window)
        mask = mask[None]
    if seg_q is not None:
        same = seg_q[:, :, None] == seg_k[:, None, :]
        mask = same if mask is None else mask & same
    return mask


def _dropout_rows(b, sq, nkv, g, seed, device, batch_offset=0,
                  head_offset=0, total_heads=None):
    """Row halves of the hash [b, sq, nkv, g, 1] for every (batch, head,
    query), heads numbered as the kernels number them (h = n * g + i) and
    placed by the dropout index (see the module's note)."""
    nq = nkv * g
    total = nq if total_heads is None else total_heads
    bh = ((torch.arange(b, device=device)[:, None, None, None]
           + batch_offset) * total + head_offset
          + torch.arange(nq, device=device).reshape(nkv, g)[None, None])
    q_pos = torch.arange(sq, device=device)[None, :, None, None]
    return _dropout_row(seed, bh, q_pos)[..., None]


def blockwise_attention(q, k, v, *, causal: bool, scale: Optional[float],
                        block_kv: int = DEFAULT_BLOCK_KV,
                        sliding_window: Optional[int] = None,
                        segment_ids=None, dropout_rate: float = 0.0,
                        dropout_seed: int = 0, batch_offset: int = 0,
                        head_offset: int = 0,
                        total_heads: Optional[int] = None):
    """Plain forward: the reference's `_blockwise_attention` in fp32, as a
    host loop over kv blocks (the last block may be short), with the
    segment mask and the dropout hash of the TPU kernel, placed by the
    dropout index. Runs on any device. Returns (out in q's dtype, lse
    [b, nq, sq] fp32)."""
    b, sq, nq, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    g = nq // nkv
    dev = q.device
    qg = (q.float() * scale).reshape(b, sq, nkv, g, d)
    q_pos = torch.arange(sq, device=dev)
    rows = (_dropout_rows(b, sq, nkv, g, dropout_seed, dev, batch_offset,
                          head_offset, total_heads)
            if dropout_rate else None)
    acc = torch.zeros(b, sq, nkv, g, d, dtype=torch.float32, device=dev)
    m = torch.full((b, sq, nkv, g), float("-inf"), dtype=torch.float32,
                   device=dev)
    m_safe = torch.zeros_like(m)
    l = torch.zeros_like(m)
    for j0 in range(0, skv, block_kv):
        kj = k[:, j0:j0 + block_kv].float()
        vj = v[:, j0:j0 + block_kv].float()
        kv_pos = j0 + torch.arange(kj.shape[1], device=dev)
        s = torch.einsum("bsngd,btnd->bsngt", qg, kj)
        mask = _block_mask(
            q_pos, kv_pos, causal=causal, sliding_window=sliding_window,
            seg_q=segment_ids,
            seg_k=None if segment_ids is None
            else segment_ids[:, j0:j0 + block_kv])
        if mask is not None:
            s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully masked rows (m_new = -inf): exp(-inf - -inf) -> use 0
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        # l keeps the undropped sum; only P V sees the dropout mask
        l = l * alpha + p.sum(dim=-1)
        if rows is not None:
            keep = _dropout_keep_from_row(rows, kv_pos, dropout_rate)
            p = p * (keep.float() / (1.0 - dropout_rate))
        acc = acc * alpha[..., None] + torch.einsum("bsngt,btnd->bsngd",
                                                    p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    lse = torch.where(l > 0, m_safe + torch.log(l),
                      torch.full_like(l, NEG_INF))
    return (out.reshape(b, sq, nq, d).to(q.dtype),
            lse.reshape(b, sq, nq).transpose(1, 2).contiguous())


def blockwise_attention_bwd(q, k, v, dout, lse, delta, *, causal: bool,
                            scale: Optional[float],
                            block_kv: int = DEFAULT_BLOCK_KV,
                            sliding_window: Optional[int] = None,
                            segment_ids=None, dropout_rate: float = 0.0,
                            dropout_seed: int = 0, dlse=None,
                            batch_offset: int = 0, head_offset: int = 0,
                            total_heads: Optional[int] = None):
    """Plain backward: the Pallas backward kernels' formulas in fp32 over
    kv blocks. `lse`, `delta` and `dlse` are [b, nq, sq] fp32 (`dlse` None
    means zero). Runs on any device. Returns (dq in q's dtype, dk and dv in
    k's and v's dtypes), with dk and dv summed over each GQA group."""
    b, sq, nq, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    g = nq // nkv
    dev = q.device

    def rows_of(t):  # [b, nq, sq] -> [b, sq, nkv, g, 1]
        return t.float().transpose(1, 2).reshape(b, sq, nkv, g)[..., None]

    qs = (q.float() * scale).reshape(b, sq, nkv, g, d)
    do = dout.float().reshape(b, sq, nkv, g, d)
    lse_c = rows_of(lse).clamp(min=MASK_CLAMP)
    rest0 = -rows_of(delta)
    if dlse is not None:
        rest0 = rest0 + rows_of(dlse)
    q_pos = torch.arange(sq, device=dev)
    rows = (_dropout_rows(b, sq, nkv, g, dropout_seed, dev, batch_offset,
                          head_offset, total_heads)
            if dropout_rate else None)
    dq = torch.zeros(b, sq, nkv, g, d, dtype=torch.float32, device=dev)
    dk = torch.zeros(b, skv, nkv, d, dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for j0 in range(0, skv, block_kv):
        j1 = min(j0 + block_kv, skv)
        kj = k[:, j0:j1].float()
        vj = v[:, j0:j1].float()
        kv_pos = torch.arange(j0, j1, device=dev)
        s = torch.einsum("bsngd,btnd->bsngt", qs, kj)
        mask = _block_mask(
            q_pos, kv_pos, causal=causal, sliding_window=sliding_window,
            seg_q=segment_ids,
            seg_k=None if segment_ids is None else segment_ids[:, j0:j1])
        if mask is not None:
            s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
        p = torch.exp(s - lse_c)
        dp = torch.einsum("bsngd,btnd->bsngt", do, vj)
        pz = p
        if rows is not None:
            z = (_dropout_keep_from_row(rows, kv_pos, dropout_rate).float()
                 / (1.0 - dropout_rate))
            pz = p * z
            dp = dp * z
        ds = p * (dp + rest0)
        dq += torch.einsum("bsngt,btnd->bsngd", ds, kj) * scale
        dk[:, j0:j1] += torch.einsum("bsngt,bsngd->btnd", ds, qs)
        dv[:, j0:j1] += torch.einsum("bsngt,bsngd->btnd", pz, do)
    return (dq.reshape(b, sq, nq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
