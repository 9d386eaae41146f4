"""Ring attention: context parallelism over the cp mesh axis
(megatron_tpu/parallel/ring_attention.py).

The sequence is split over the cp ranks; each keeps its queries and passes
its keys and values around the ring, one hop a step (`collectives.ring_shift`,
the reference's `lax.ppermute`). Every hop attends the local queries to
the block that arrived, and the partial results merge online through their
logsumexp: out = sum_i out_i * exp(lse_i - lse), lse = logaddexp_i lse_i,
in fp32, with the reference's guards for rows that saw no key yet
(`_merge`).

The inner block is the port's `flash_attention_with_lse`: on the card the
flash forward kernel, and in the backward the dQ and dK/dV kernels with
the lse's cotangent (`dlse`), which the merge weights feed back. Autograd
runs through the blocks, the merge and the ring shifts (whose backward
shifts the other way), as `jax.grad` runs through the reference's scan of
ppermutes. `_local_block_attention` is the plain version of one block, the
reference's einsum fallback (`impl="plain"`).

Causal load balance, as the reference: with the contiguous split, rank r
attends r + 1 of the cp blocks. The zigzag layout splits the sequence into
2 cp chunks and gives rank r chunks r and 2cp - 1 - r, so every rank
attends 2cp + 1 chunk pairs (`zigzag_pair_counts`). Each (query chunk, key
chunk) pair is a full block, the causal diagonal, or skipped, and a
skipped pair launches nothing. `layout="zigzag"` permutes q, k and v in
and the output back (gathering the sequence over cp); `"pre_zigzag"`
declares the batch permuted already: the LM loss permutes tokens, labels,
mask and positions once (`data_zigzag_cp`), and the ring moves no data
besides its hops.

On the card the ring rotates k and v in the compute dtype and merges in
fp32 (the reference rotates in fp32 off its chip only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from megatron_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_with_lse)
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import CONTEXT_AXIS
from megatron_tpu_torch.parallel.sharding import cp_positions

NEG_INF = -1e30


def _local_block_attention(q, k, v, q_pos, kv_pos, *, scale: float,
                           causal: bool):
    """Plain attention of queries q [b, s, nq, d] against one key block
    k/v [b, c, nkv, d], masked causally by the global positions of their
    rows: (out [b, s, nq, d] fp32, normalized; lse [b, s, nq] fp32,
    NEG_INF where a row sees no key)."""
    b, s, nq, d = q.shape
    c, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = (q.float() * scale).reshape(b, s, nkv, g, d)
    scores = torch.einsum("bsngd,btnd->bsngt", qg, k.float())
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask[None, :, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(m[..., None] <= NEG_INF / 2, torch.zeros_like(p), p)
    l_sum = p.sum(dim=-1)
    acc = torch.einsum("bsngt,btnd->bsngd", p, v.float())
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    lse = torch.where(l_sum > 0, m + torch.log(torch.clamp(l_sum, min=1e-30)),
                      torch.full_like(m, NEG_INF))
    return out.reshape(b, s, nq, d), lse.reshape(b, s, nq)


def zigzag_permutation(S: int, cp: int):
    """Row permutation putting a length-S sequence into zigzag order: rank
    r's part is [chunk r ; chunk 2cp-1-r] of the 2cp equal chunks.
    Returns (perm, inv); x_zig = x[perm], x = x_zig[inv]."""
    c = S // (2 * cp)
    parts = []
    for r in range(cp):
        parts.append(np.arange(r * c, (r + 1) * c))
        parts.append(np.arange((2 * cp - 1 - r) * c, (2 * cp - r) * c))
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(S)
    return perm, inv


def data_zigzag_cp(cfg, seq_len: int, mesh, *, causal: bool = True,
                   segment_ids=None) -> int:
    """cp when the loss pre-permutes its batch into zigzag order (the ring
    then takes layout "pre_zigzag"), else 0. The reference's conditions:
    ring attention runs (a mesh with cp > 1, attention_impl "ring"),
    causal, no segment ids, no attention dropout and no window (both send
    attention off the ring), and 2 cp divides the sequence."""
    if (getattr(cfg, "attention_impl", None) != "ring" or not causal
            or segment_ids is not None
            or getattr(cfg, "attention_dropout", 0.0) > 0.0
            or getattr(cfg, "sliding_window", None) is not None
            or mesh is None):
        return 0
    cp = mesh.shape[CONTEXT_AXIS]
    if cp <= 1 or seq_len % (2 * cp):
        return 0
    return cp


def zigzag_pair_counts(cp: int):
    """The chunk pairs each rank attends under the zigzag schedule: q chunk
    i attends kv chunks 0..i, i full pairs and its diagonal."""
    return [(r + 1) + (2 * cp - 1 - r + 1) for r in range(cp)]


def _merge(acc, part):
    """Online (out, lse) merge of two partial attention results; `acc` may
    be None (nothing seen yet)."""
    if acc is None:
        return part
    (out_a, lse_a), (out_b, lse_b) = acc, part
    tot = torch.logaddexp(lse_a, lse_b)
    zero = torch.zeros_like(tot)
    safe = torch.where(tot <= NEG_INF / 2, zero, tot)
    alpha = torch.where(lse_a <= NEG_INF / 2, zero, torch.exp(lse_a - safe))
    beta = torch.where(lse_b <= NEG_INF / 2, zero, torch.exp(lse_b - safe))
    return out_a * alpha[..., None] + out_b * beta[..., None], tot


class _Tie(torch.autograd.Function):
    """`out`, with `kv` tied to it by a zero grad, so that every rank runs
    the backward of every ring shift (each is a collective), also where
    the causal mask left the last blocks it received unused."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv_shape = kv.shape
        ctx.kv_dtype = kv.dtype
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.kv_shape, dtype=ctx.kv_dtype)


def _pair_class(q_idx: int, kv_idx: int) -> str:
    """A (query chunk, key chunk) pair under causal masking."""
    if q_idx > kv_idx:
        return "full"
    return "diag" if q_idx == kv_idx else "skip"


def ring_attention(q, k, v, mesh, *, causal: bool = True,
                   scale: Optional[float] = None, impl: str = "flash",
                   layout: str = "auto"):
    """q [b, s, nq, d], k/v [b, s, nkv, d]: this rank's part of a sequence
    of cp * s split over cp (contiguous, or in zigzag order under
    "pre_zigzag"). Returns this rank's rows of the attention output
    [b, s, nq, d] in q's dtype, differentiable. `impl`: "flash" (the flash
    kernels on the card, their plain versions on the CPU) or "plain"
    (`_local_block_attention`). `layout`: "contiguous", "zigzag",
    "pre_zigzag" or "auto" (zigzag when causal and 2 cp divides the
    sequence)."""
    axis = CONTEXT_AXIS
    cp = mesh.shape[axis]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl not in ("flash", "plain"):
        raise ValueError(f"ring_attention: impl={impl!r}")
    if cp == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    b, s_loc, nq, _ = q.shape
    S = s_loc * cp
    if layout == "auto":
        layout = ("zigzag" if causal and S % (2 * cp) == 0
                  else "contiguous")
    if layout not in ("contiguous", "zigzag", "pre_zigzag"):
        raise ValueError(f"ring_attention: layout={layout!r}")
    zigzag = causal and layout != "contiguous"
    if zigzag and S % (2 * cp):
        raise ValueError(f"zigzag layout needs seq {S} divisible by "
                         f"2*cp={2 * cp}; use layout='contiguous'")
    runtime_permute = zigzag and layout == "zigzag"
    if runtime_permute:
        rows = cp_positions(S, mesh, zigzag=True)
        q, k, v = (collectives.gather_axis(t, mesh, axis, 1)[:, rows]
                   for t in (q, k, v))

    r = mesh.coords[axis]
    c = s_loc // 2
    # this rank's query chunks: (global chunk index, rows); a contiguous
    # or non-causal layout has one chunk, the whole part
    if zigzag:
        q_chunks = [(r, slice(0, c)), (2 * cp - 1 - r, slice(c, s_loc))]
    else:
        q_chunks = [(r, slice(0, s_loc))]

    def block(qb, kb, vb, kind):
        if impl == "flash":
            o, lse = flash_attention_with_lse(qb, kb, vb,
                                              causal=kind == "diag",
                                              scale=scale)
            return o.float(), lse.transpose(1, 2)
        pos_q = torch.arange(qb.shape[1], device=qb.device)
        pos_k = torch.arange(kb.shape[1], device=qb.device)
        return _local_block_attention(qb, kb, vb, pos_q, pos_k, scale=scale,
                                      causal=kind == "diag")

    acc = [None] * len(q_chunks)
    kv = torch.stack([k, v])
    for step in range(cp):
        # after `step` hops this rank holds the block of rank r - step
        src = (r - step) % cp
        k_cur, v_cur = kv[0], kv[1]
        if zigzag:
            kv_chunks = [(src, slice(0, c)),
                         (2 * cp - 1 - src, slice(c, s_loc))]
        else:
            kv_chunks = [(src, slice(0, s_loc))]
        for i, (qi, qrows) in enumerate(q_chunks):
            for kj, krows in kv_chunks:
                kind = _pair_class(qi, kj) if causal else "full"
                if kind == "skip":
                    continue
                acc[i] = _merge(acc[i], block(q[:, qrows], k_cur[:, krows],
                                              v_cur[:, krows], kind))
        if step < cp - 1:
            kv = collectives.ring_shift(kv, mesh, axis)
    out = torch.cat([a[0] for a in acc], dim=1).to(q.dtype)
    if kv.requires_grad:
        out = _Tie.apply(out, kv)
    if runtime_permute:
        _, inv = zigzag_permutation(S, cp)
        whole = collectives.gather_axis(out, mesh, axis, 1)[:, inv]
        out = whole[:, cp_positions(S, mesh)]
    return out
