"""Supervised retriever finetuning on DPR-format NQ, the task
RET-FINETUNE-NQ (tasks/orqa/finetune.py).

The loss: scores q @ c^T over the batch's b queries and its b positive
contexts followed by the concatenated negatives (fixed slots a sample,
padded slots masked to -1e9), optionally scaled by 1 / sqrt(h), and the
mean negative log-likelihood of the diagonal. Validation reports the
in-batch top-1 accuracy and DPR's average rank of each positive among its
own negatives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from megatron_tpu_torch.config import MegatronConfig
from megatron_tpu_torch.models.biencoder import embed_text, towers
from megatron_tpu_torch.tasks.finetune_utils import to_device
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

# entries of a batch that stay on the host
HOST_KEYS = ("reference", "neg_counts")


def retrieval_scores(params, batch: dict, mcfg, *,
                     score_scaling: bool = False,
                     generator: Optional[torch.Generator] = None,
                     deterministic: bool = True) -> torch.Tensor:
    """-> [b, b + n_neg] fp32 similarities; one generator draws the query
    tower's dropout, then the context tower's."""
    q_tower, c_tower = towers(params)
    q = embed_text(q_tower, batch["query"], mcfg,
                   padding_mask=batch["query_pad_mask"],
                   tokentype_ids=batch["query_types"], generator=generator,
                   deterministic=deterministic)
    ctx = batch["context"]
    ctx_types = batch["context_types"]
    ctx_pad = batch["context_pad_mask"]
    has_negs = "neg_context" in batch and batch["neg_context"].shape[0]
    if has_negs:
        ctx = torch.cat([ctx, batch["neg_context"]])
        ctx_types = torch.cat([ctx_types, batch["neg_context_types"]])
        ctx_pad = torch.cat([ctx_pad, batch["neg_context_pad_mask"]])
    c = embed_text(c_tower, ctx, mcfg, padding_mask=ctx_pad,
                   tokentype_ids=ctx_types, generator=generator,
                   deterministic=deterministic)
    scores = q @ c.T
    if score_scaling:
        scores = scores / math.sqrt(mcfg.hidden_size)
    if has_negs and "neg_valid" in batch:
        # padded negative slots never win the softmax
        b = batch["query"].shape[0]
        neg_mask = torch.where(batch["neg_valid"] > 0, 0.0, -1e9)
        scores = torch.cat([scores[:, :b], scores[:, b:] + neg_mask[None]],
                           dim=1)
    return scores


def retrieval_ce_loss(params, batch: dict, mcfg, *,
                      score_scaling: bool = False,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = True):
    """(mean loss, count of rows whose top score is their positive)."""
    scores = retrieval_scores(params, batch, mcfg,
                              score_scaling=score_scaling,
                              generator=generator,
                              deterministic=deterministic)
    labels = torch.arange(scores.shape[0], device=scores.device)
    logprobs = torch.log_softmax(scores, dim=-1)
    loss = -logprobs[labels, labels].mean()
    correct = (scores.argmax(dim=-1) == labels).sum()
    return loss, correct


@torch.no_grad()
def average_rank(params, dataset, mcfg, batch_size: int,
                 score_scaling: bool = False) -> dict:
    """DPR's average rank (1-indexed, lower is better) of each positive
    among its own negatives, and the in-batch top-1 accuracy."""
    device = next(params.parameters()).device
    ranks, correct, total = [], 0, 0
    cap = getattr(dataset, "neg_cap", None) or 0
    for batch in dataset.batches(batch_size, drop_last=False):
        scores = retrieval_scores(
            params, to_device(batch, device, skip=HOST_KEYS), mcfg,
            score_scaling=score_scaling).cpu().numpy()
        b = batch["query"].shape[0]
        correct += int((np.argmax(scores, axis=-1) == np.arange(b)).sum())
        total += b
        # the negatives of sample i sit at b + i * cap
        if "neg_counts" in batch and cap:
            for i, n in enumerate(batch["neg_counts"]):
                pos = scores[i, i]
                negs = scores[i, b + i * cap:b + i * cap + n]
                ranks.append(1 + int((negs > pos).sum()))
    out = {"top1_accuracy": correct / max(total, 1)}
    if ranks:
        out["average_rank"] = float(np.mean(ranks))
    return out


def finetune_retriever(cfg: MegatronConfig, train_ds, valid_ds, *,
                       epochs: int = 1, score_scaling: bool = False,
                       pretrained_checkpoint: Optional[str] = None,
                       ict_head_size: Optional[int] = None,
                       shared: bool = False, seed: int = 1234,
                       device: DeviceLike = None) -> dict:
    """Train the biencoder on the in-batch objective on `device` (the
    current CUDA device when None; raises without one) and report
    `average_rank` after each epoch. The towers are random from `seed`;
    `pretrained_checkpoint` overwrites the leaves it shares with them.
    Returns {"params", "history", "final"}."""
    from megatron_tpu_torch.models.biencoder import BiencoderModel
    from megatron_tpu_torch.training.checkpointing import \
        load_pretrained_params
    from megatron_tpu_torch.training.train_step import (make_train_step,
                                                        state_from_params)
    from megatron_tpu_torch.utils.logging import print_rank_0

    device = resolve_device(device)
    mcfg = cfg.model
    model = BiencoderModel(mcfg, ict_head_size=ict_head_size, shared=shared,
                           device=device, seed=seed, trainable=True)
    if pretrained_checkpoint:
        load_pretrained_params(pretrained_checkpoint, model)

    bs = cfg.training.micro_batch_size
    steps_per_epoch = max(len(train_ds) // bs, 1)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, train_iters=max(epochs * steps_per_epoch, 1)))
    deterministic = mcfg.hidden_dropout == 0.0

    def loss_fn(m, mb, generator):
        loss, _ = retrieval_ce_loss(m, mb, mcfg, score_scaling=score_scaling,
                                    generator=generator,
                                    deterministic=deterministic)
        return loss

    step = make_train_step(cfg, loss_fn=loss_fn, device=device)
    state = state_from_params(model, cfg)
    generator = (None if deterministic
                 else torch.Generator(device=device).manual_seed(seed))
    shuffle = np.random.RandomState(seed)
    history = []
    metrics = {"lm_loss": float("nan")}  # a train set under one batch
    for epoch in range(epochs):
        for batch in train_ds.batches(bs, shuffle_rng=shuffle):
            state, metrics = step(
                state, to_device(batch, device, lead=True, skip=HOST_KEYS),
                generator)
        results = average_rank(state.params, valid_ds, mcfg, bs,
                               score_scaling=score_scaling)
        history.append(results)
        print_rank_0(f"epoch {epoch}: loss "
                     f"{float(metrics['lm_loss']):.4f} | {results}")
    return {"params": state.params, "history": history,
            "final": history[-1] if history else {}}
