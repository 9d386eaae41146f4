"""Cross-entropy over the padded vocabulary (megatron_tpu/ops/cross_entropy.py).

Per-token loss in fp32: logits for ids at or past the true vocab size are
set to -1e30 before the log-partition, the max shift is a constant of the
backward (detached, as the reference's stop_gradient), and label smoothing
mixes in the mean log-probability over the true vocabulary.

`vocab_parallel_cross_entropy` takes logits cut over the vocab across tp
ranks (the sharded LM head's): the max, the sum of exponentials and the
target logit are combined across tp (upstream Megatron's
vocab_parallel_cross_entropy), the pad mask goes by global id, and label
smoothing's mean over the true vocabulary is a sum across the shards. The
sums are all-reduced forward and pass their cotangent through backward,
so each rank's logits get exactly their columns' grads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import TENSOR_AXIS


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


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mesh, vocab_size: Optional[int] = None,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """logits [..., padded_vocab / tp]: this tp rank's vocab columns, the
    rank's coordinate times that width onward; labels [...] global ids.
    Returns the per-token loss [...] fp32, the same on every tp rank."""
    logits = logits.float()
    width = logits.shape[-1]
    start = mesh.coords[TENSOR_AXIS] * width
    padded_vocab = width * mesh.shape[TENSOR_AXIS]
    ids = start + torch.arange(width, device=logits.device)
    if vocab_size is not None and vocab_size < padded_vocab:
        logits = logits.masked_fill(ids >= vocab_size, -1e30)
    top = collectives.all_reduce(logits.amax(dim=-1, keepdim=True).detach(),
                                 mesh, TENSOR_AXIS, dist.ReduceOp.MAX)
    shifted = logits - top
    lse = torch.log(collectives.reduce_from_tp(
        torch.exp(shifted).sum(dim=-1), mesh))
    local = labels.long() - start
    inside = (local >= 0) & (local < width)
    picked = shifted.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
    label_logit = collectives.reduce_from_tp(
        torch.where(inside, picked, torch.zeros_like(picked)), mesh)
    loss = lse - label_logit
    if label_smoothing > 0.0:
        n = vocab_size if vocab_size is not None else padded_vocab
        real = (ids < n).to(shifted.dtype)
        mean_logit = collectives.reduce_from_tp(
            (shifted * real).sum(dim=-1), mesh) / n
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (
            lse - mean_logit)
    return loss


def mesh_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mesh,
                       vocab_size: Optional[int] = None) -> torch.Tensor:
    """The per-token loss of a model's logits: vocab-parallel when `mesh`
    cuts the vocab over tp (more than one tp rank), else whole."""
    if mesh is not None and mesh.shape[TENSOR_AXIS] > 1:
        return vocab_parallel_cross_entropy(logits, labels, mesh,
                                            vocab_size=vocab_size)
    return cross_entropy_loss(logits, labels, vocab_size=vocab_size)
