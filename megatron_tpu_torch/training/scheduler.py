"""Learning-rate and weight-decay schedules (megatron_tpu/training/scheduler.py).

Pure functions of the iteration on the host, returning Python floats: the
training step knows its iteration on the host, so no device scalar and no
sync is needed. Linear warmup to the max lr, then constant, linear, cosine
or inverse-square-root decay to min_lr; weight decay constant or ramped
linearly or by a cosine from its start to its end value.
"""
from __future__ import annotations

import math

from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig


def _resolve(cfg: OptimizerConfig, train: TrainingConfig):
    decay_iters = cfg.lr_decay_iters or train.train_iters
    if cfg.lr_warmup_fraction is not None:
        warmup = int(cfg.lr_warmup_fraction * decay_iters)
    else:
        warmup = cfg.lr_warmup_iters
    return decay_iters, warmup


def learning_rate(iteration: int, cfg: OptimizerConfig,
                  train: TrainingConfig) -> float:
    """lr at `iteration` (0-based)."""
    decay_iters, warmup = _resolve(cfg, train)
    it = float(iteration)
    max_lr, min_lr = cfg.lr, cfg.min_lr
    if warmup > 0 and it < warmup:
        return max_lr * (it + 1.0) / max(warmup, 1)
    ratio = min(max(max(it - warmup, 0.0) / max(decay_iters - warmup, 1),
                    0.0), 1.0)
    style = cfg.lr_decay_style
    if style == "constant":
        return max_lr
    if style == "linear":
        return max_lr - (max_lr - min_lr) * ratio
    if style == "cosine":
        return min_lr + 0.5 * (math.cos(math.pi * ratio) + 1.0) * (
            max_lr - min_lr)
    if style == "inverse-square-root":
        w = float(max(warmup, 1))
        decayed = min(max_lr, max_lr * math.sqrt(w) / math.sqrt(
            max(it + 1.0, w)))
        return max(decayed, min_lr)
    raise ValueError(f"unknown lr_decay_style {style!r}")


def weight_decay(iteration: int, cfg: OptimizerConfig,
                 train: TrainingConfig) -> float:
    """wd at `iteration`."""
    start = (cfg.start_weight_decay if cfg.start_weight_decay is not None
             else cfg.weight_decay)
    end = (cfg.end_weight_decay if cfg.end_weight_decay is not None
           else cfg.weight_decay)
    if cfg.weight_decay_incr_style == "constant" or start == end:
        return end
    decay_iters, _ = _resolve(cfg, train)
    ratio = min(max(float(iteration) / max(decay_iters, 1), 0.0), 1.0)
    if cfg.weight_decay_incr_style == "linear":
        coeff = ratio
    elif cfg.weight_decay_incr_style == "cosine":
        coeff = 0.5 * (math.cos(math.pi * (1.0 - ratio)) + 1.0)
    else:
        raise ValueError(f"unknown weight_decay_incr_style "
                         f"{cfg.weight_decay_incr_style!r}")
    return start + coeff * (end - start)
