"""Weighted mixture of datasets.

A copy of megatron_tpu/data/blendable.py, the port of BlendableDataset
(ref: megatron/data/blendable_dataset.py:12-53), whose index assignment
comes from the C++ `build_blending_indices` (ref: megatron/data/helpers.cpp:
20-80): a greedy scheduler that, for each output index, picks the dataset
whose emitted count is furthest behind its weight target. The port takes
its own native helper (data/helpers.py) and has no numpy fallback: a failed
build raises.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def normalize_blend_weights(data_prefix: Sequence):
    """[w0, p0, w1, p1, ...] -> (prefixes, normalized weights)
    (ref: megatron/data/dataset_utils.py get_datasets_weights_and_num_samples)."""
    if len(data_prefix) % 2 != 0:
        raise ValueError("blended data_path must alternate weight, prefix "
                         f"(got {len(data_prefix)} items)")
    weights = [float(w) for w in data_prefix[0::2]]
    prefixes = [str(p) for p in data_prefix[1::2]]
    s = sum(weights)
    if s <= 0:
        raise ValueError(f"blend weights must sum > 0 (got {weights})")
    return prefixes, [w / s for w in weights]


def build_blending_indices(weights: np.ndarray, size: int):
    """Greedy weight-balancing assignment
    (ref: megatron/data/helpers.cpp:20-80). Returns (dataset_index uint8,
    dataset_sample_index int64)."""
    from megatron_tpu_torch.data.helpers import build_blending_indices_native
    return build_blending_indices_native(weights, size)


class BlendableDataset:
    def __init__(self, datasets: Sequence, weights: Sequence[float],
                 size: int):
        assert len(datasets) == len(weights)
        self.datasets = list(datasets)
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        self.size = size
        self.dataset_index, self.dataset_sample_index = \
            build_blending_indices(w, size)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        d = self.dataset_index[idx]
        s = self.dataset_sample_index[idx]
        ds = self.datasets[d]
        return ds[int(s) % len(ds)]
