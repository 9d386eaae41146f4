"""Task finetuning and accuracy evaluation (tasks/finetune_utils.py).

`finetune_and_evaluate` trains a classification or multiple-choice model
epoch by epoch through the training step's custom loss
(`make_train_step(cfg, loss_fn=...)`) and reports the validation accuracy
after each epoch, as the reference's `finetune(...)` with its accuracy
provider. Batches are drawn in the reference's order (a RandomState(seed)
shuffle an epoch, the last partial batch dropped in training and kept in
evaluation).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import MegatronConfig
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def batches(dataset, batch_size: int, shuffle_rng=None,
            drop_last: bool = True):
    """Stacked numpy batches of a dataset of dict samples."""
    idxs = np.arange(len(dataset))
    if shuffle_rng is not None:
        shuffle_rng.shuffle(idxs)
    stop = len(idxs) - batch_size + 1 if drop_last else len(idxs)
    for lo in range(0, stop, batch_size):
        items = [dataset[int(i)] for i in idxs[lo:lo + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def to_device(batch: dict, device, *, lead: bool = False,
              skip=()) -> dict:
    """numpy batch -> tensors on `device`; `lead` adds the step's leading
    microbatch dim of 1."""
    out = {}
    for k, v in batch.items():
        if k in skip:
            continue
        t = torch.from_numpy(np.asarray(v)).to(device)
        out[k] = t[None] if lead else t
    return out


@torch.no_grad()
def evaluate_accuracy(params, dataset, forward_fn: Callable,
                      batch_size: int) -> float:
    """argmax accuracy over a labelled dataset, every sample counted;
    `forward_fn(params, numpy batch)` returns the logits."""
    correct = total = 0
    for batch in batches(dataset, batch_size, drop_last=False):
        pred = forward_fn(params, batch).argmax(dim=-1).cpu().numpy()
        correct += int((pred == batch["label"]).sum())
        total += len(pred)
    return correct / max(total, 1)


def finetune_and_evaluate(
    cfg: MegatronConfig,
    train_ds,
    valid_ds,
    *,
    kind: str,                      # "classification" | "multichoice"
    num_classes: int = 2,
    epochs: int = 3,
    mesh=None,
    pretrained_checkpoint: Optional[str] = None,
    seed: int = 1234,
    device: DeviceLike = None,
) -> dict:
    """Train `epochs` epochs on `device` (the current CUDA device when
    None; raises without one) and evaluate after each. The model is the
    family's random weights from `seed`; `pretrained_checkpoint` then
    overwrites the leaves it holds (a BERT checkpoint's encoder; the head
    keeps its values). Returns {"best_accuracy", "last_accuracy",
    "params"}."""
    from megatron_tpu_torch.models import classification as cls
    from megatron_tpu_torch.training.checkpointing import \
        load_pretrained_params
    from megatron_tpu_torch.training.train_step import (make_train_step,
                                                        state_from_params)
    from megatron_tpu_torch.utils.logging import print_rank_0

    if mesh is not None:
        raise NotImplementedError("finetune_and_evaluate: a mesh is ported "
                                  "with the multi-device slice")
    device = resolve_device(device)
    mcfg = cfg.model
    if kind == "classification":
        model_cls, options = cls.ClassificationModel, {
            "num_classes": num_classes}
        loss, fwd = cls.classification_loss, cls.classification_forward
    elif kind == "multichoice":
        model_cls, options = cls.MultipleChoiceModel, {}
        loss, fwd = cls.multiple_choice_loss, cls.multiple_choice_forward
    else:
        raise ValueError(f"unknown finetune kind {kind!r}")

    model = model_cls(mcfg, device=device, seed=seed, trainable=True,
                      **options)
    if pretrained_checkpoint:
        load_pretrained_params(pretrained_checkpoint, model)
    state = state_from_params(model, cfg)
    deterministic = mcfg.hidden_dropout == 0.0

    def loss_fn(m, mb, generator):
        return loss(m, mb, mcfg, generator=generator,
                    deterministic=deterministic)

    # the lr schedule spans the finetuning's own length
    bs = cfg.training.micro_batch_size
    steps_per_epoch = max(len(train_ds) // bs, 1)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, train_iters=max(epochs * steps_per_epoch, 1)))
    step = make_train_step(cfg, loss_fn=loss_fn, device=device)

    def forward(params, batch):
        b = to_device(batch, device)
        return fwd(params, b["tokens"], mcfg,
                   tokentype_ids=b["tokentype_ids"],
                   padding_mask=b["padding_mask"])

    generator = (None if deterministic
                 else torch.Generator(device=device).manual_seed(seed))
    shuffle = np.random.RandomState(seed)
    best = last = 0.0
    metrics = {"lm_loss": float("nan")}  # an eval-only run never trains
    for epoch in range(epochs):
        for batch in batches(train_ds, bs, shuffle):
            state, metrics = step(state, to_device(batch, device, lead=True),
                                  generator)
        if valid_ds is not None:
            last = evaluate_accuracy(state.params, valid_ds, forward, bs)
            best = max(best, last)
            print_rank_0(f"epoch {epoch}: loss {float(metrics['lm_loss']):.4f}"
                         f" val accuracy {last:.4f}")
    return {"best_accuracy": best, "last_accuracy": last,
            "params": state.params}
