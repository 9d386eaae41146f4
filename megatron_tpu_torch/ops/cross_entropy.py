"""Cross-entropy over the padded vocabulary (megatron_tpu/ops/cross_entropy.py).

Per-token loss in fp32: logits for ids at or past the true vocab size are
set to -1e30 before the log-partition, the max shift is a constant of the
backward (detached, as the reference's stop_gradient), and label smoothing
mixes in the mean log-probability over the true vocabulary.
"""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: Optional[int] = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """logits [..., padded_vocab] (any float dtype, promoted to fp32),
    labels [...] int. Returns the per-token loss [...] fp32."""
    logits = logits.float()
    padded_vocab = logits.shape[-1]
    if vocab_size is not None and vocab_size < padded_vocab:
        ids = torch.arange(padded_vocab, device=logits.device)
        logits = logits.masked_fill(ids >= vocab_size, -1e30)
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = shifted.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - label_logit
    if label_smoothing > 0.0:
        n = vocab_size if vocab_size is not None else padded_vocab
        mean_logit = shifted[..., :n].sum(dim=-1) / n
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (
            lse - mean_logit)
    return loss
