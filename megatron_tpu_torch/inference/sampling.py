"""Token sampling: temperature / top-k / top-p
(megatron_tpu/inference/sampling.py `top_k_filter`, `top_p_filter`,
`sample`).

Random draws take an explicit `torch.Generator`; they cannot reproduce the
reference's `jax.random` bits, so seeded sampling is deterministic within
the port only.
"""
from __future__ import annotations

from typing import Optional

import torch


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row."""
    if k <= 0:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., -k, None]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: a sorted position is kept while the probability
    mass before it is < p, so the top token always stays."""
    if p <= 0.0 or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    min_kept = torch.where(keep_sorted, sorted_logits,
                           torch.full_like(sorted_logits, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < min_kept, float("-inf"))


def sample(generator: Optional[torch.Generator], logits: torch.Tensor, *,
           top_k: int = 0, top_p: float = 0.0, temperature: float = 1.0,
           vocab_size: Optional[int] = None) -> torch.Tensor:
    """One sampling step over [batch, vocab] logits. Returns int64 [batch].
    Greedy (argmax, first index on ties) when temperature == 0 or
    top_k == 1; the padded vocab tail is never drawn."""
    logits = logits.float()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        logits = logits.clone()
        logits[..., vocab_size:] = float("-inf")
    if temperature == 0.0 or top_k == 1:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 1e-6)
    logits = top_k_filter(logits, top_k)
    logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
