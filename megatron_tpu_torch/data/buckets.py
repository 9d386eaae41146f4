"""Bucketed sequence-length batching for variable-length finetuning
(megatron_tpu/data/buckets.py).

Each global batch is padded to the smallest member of a fixed ladder of
lengths that holds its longest sample. Padding waste is bounded by the
ladder's spacing, and the loss mask keeps padded positions out of the
objective, so a bucketed run optimizes the same objective as a ragged one.
The port's train step reads its shapes from the batch (RoPE tables cover
max_position_embeddings; masks are built a call), so every bucket goes
through one `make_train_step` as it is.

    buckets = make_buckets(cfg.model.seq_length)       # e.g. 256..4096
    batch = collate_bucketed(samples, micro_bs, n_micro, buckets, pad_id)
    # -> {"tokens": [n_micro, b, B+1], "loss_mask": [n_micro, b, B]}
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_buckets(max_seq: int, min_seq: int = 256,
                 multiple: int = 64) -> list[int]:
    """Power-of-two ladder [min_seq, ..., max_seq], max always included.

    Every bucket stays a multiple of `multiple` (the kernels' tiles, and
    the sharding factors of a later multi-device slice)."""
    assert max_seq % multiple == 0, (
        f"max_seq {max_seq} not a multiple of {multiple}")
    assert min_seq % multiple == 0, (
        f"min_seq {min_seq} not a multiple of {multiple} — every rung "
        "would be silently skipped, degenerating to one max-size bucket")
    out = []
    b = min_seq
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return out


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; raises if none fits (caller truncates
    or filters overlong samples explicitly — silent truncation here
    would corrupt labels)."""
    for b in sorted(buckets):
        if length <= b:
            return b
    raise ValueError(f"sequence length {length} exceeds the largest "
                     f"bucket {max(buckets)}")


def collate_bucketed(samples: Sequence[np.ndarray], micro_bs: int,
                     n_micro: int, buckets: Sequence[int], pad_id: int,
                     loss_masks: Optional[Sequence[np.ndarray]] = None
                     ) -> dict:
    """Pack `n_micro * micro_bs` variable-length token sequences into one
    global batch padded to the bucket of the LONGEST sample.

    One bucket per global batch (not per microbatch): all microbatches of
    a step share a shape, as a pipelined step needs.
    Each sample is `tokens` of length L_i >= 2 (input+shifted-label form:
    the model consumes [:, :-1] and predicts [:, 1:]); optional
    `loss_masks[i]` of length L_i - 1 (defaults to all-ones). Padded
    positions get pad_id and mask 0, so the masked-mean loss equals the
    unpadded computation exactly."""
    n = micro_bs * n_micro
    assert len(samples) == n, f"need {n} samples, got {len(samples)}"
    if loss_masks is not None:
        assert len(loss_masks) == n
    longest = max(len(s) for s in samples)
    B = bucket_for(longest - 1, buckets)  # model seq dim is L-1
    tokens = np.full((n_micro, micro_bs, B + 1), pad_id, dtype=np.int32)
    mask = np.zeros((n_micro, micro_bs, B), dtype=np.float32)
    for i, s in enumerate(samples):
        m, b = divmod(i, micro_bs)
        ln = len(s)
        tokens[m, b, :ln] = np.asarray(s, dtype=np.int32)
        if loss_masks is not None:
            mask[m, b, :ln - 1] = np.asarray(loss_masks[i],
                                             dtype=np.float32)
        else:
            mask[m, b, :ln - 1] = 1.0
    return {"tokens": tokens, "loss_mask": mask}


def bucket_batches(dataset, micro_bs: int, n_micro: int,
                   buckets: Sequence[int], pad_id: int,
                   drop_last: bool = False):
    """Generator: length-sort-free streaming collation — consume the
    dataset in order, emit one bucketed global batch per n_micro*micro_bs
    samples. (Length-grouped sampling reduces padding further; that is a
    sampler concern — this keeps consumption order == sampler order so
    consumed-samples checkpoint resume stays exact.)

    A trailing partial group is padded to a full batch with dummy
    fully-masked rows (zero loss weight — the objective is untouched and
    every real sample trains), so sample accounting stays exact for
    small finetuning sets. `drop_last=True` discards it instead (the
    fixed-shape pretraining convention)."""
    group, masks = [], []

    def flush():
        lm = None if all(m is None for m in masks) else [
            m if m is not None else np.ones(len(t) - 1, np.float32)
            for m, t in zip(masks, group)]
        return collate_bucketed(group, micro_bs, n_micro, buckets,
                                pad_id, loss_masks=lm)

    for item in dataset:
        if isinstance(item, dict):
            group.append(item["tokens"])
            masks.append(item.get("loss_mask"))
        else:
            group.append(item)
            masks.append(None)
        if len(group) == micro_bs * n_micro:
            yield flush()
            group, masks = [], []
    if group and not drop_last:
        n_fill = micro_bs * n_micro - len(group)
        filler = np.full(2, pad_id, dtype=np.int32)
        group.extend([filler] * n_fill)
        masks.extend([np.zeros(1, np.float32)] * n_fill)
        yield flush()
