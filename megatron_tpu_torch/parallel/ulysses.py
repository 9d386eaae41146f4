"""Ulysses attention: context parallelism by all-to-all over the cp mesh axis
(megatron_tpu/parallel/ulysses.py).

Activations live split along the sequence, [b, S/cp, n, d] a rank. One
all-to-all of each of q, k and v reshards them to [b, S, n/cp, d]: the
whole sequence for this rank's share of the heads. The flash kernel runs
there, and the inverse all-to-all brings the output back to the sequence
split (`collectives.all_to_all_axis`, whose backward is the inverse
all-to-all). Under tensor parallelism a rank's heads are its tp share
already, so the heads split over tp first and then over cp, as GSPMD lays
out the reference's. Every rank's q and kv heads must divide by cp.
"""
from __future__ import annotations

from typing import Optional

from megatron_tpu_torch.ops.flash_attention import flash_attention
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import CONTEXT_AXIS


def ulysses_attention(q, k, v, mesh, *, causal: bool = True,
                      scale: Optional[float] = None):
    """q [b, s, nq, d], k/v [b, s, nkv, d]: this rank's contiguous part of
    a sequence split over cp. Returns its rows of the attention output
    [b, s, nq, d], differentiable."""
    cp = mesh.shape[CONTEXT_AXIS]
    if cp == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    nq, nkv = q.shape[2], k.shape[2]
    if nq % cp or nkv % cp:
        raise ValueError(
            f"ulysses needs query AND kv head counts divisible by cp={cp} "
            f"(got nq={nq}, nkv={nkv}); use --context_parallel_algo ring")
    qh, kh, vh = (collectives.all_to_all_axis(t, mesh, CONTEXT_AXIS, 2, 1)
                  for t in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    return collectives.all_to_all_axis(out, mesh, CONTEXT_AXIS, 1, 2)
