"""Weight bridge from the JAX package's parameters and checkpoints.

The port keeps the reference's leaf names and its stacked [L, ...] layer
layout, so moving weights across is a renaming ("a/b/c" -> "a.b.c") plus
`torch.from_numpy`, with the keys and shapes checked against the model the
config describes. Nothing is reordered: the fused wkv splits into k and v
inside attention exactly as in the reference.

`load_npz_checkpoint` reads a checkpoint the JAX package saved with
`backend="npz"` (training/checkpointing.py): the tracker file, then
`config.json`, then `params.npz`. It needs no JAX. Orbax checkpoints are
read in a later slice.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import MegatronConfig, ModelConfig
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

TRACKER = "latest_checkpointed_iteration.txt"


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def params_from_numpy(tree_or_flat: Mapping, cfg: ModelConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX parameter tree (nested dict of arrays, or the flat "a/b/c"
    keys of checkpointing._flatten) -> the port's state_dict on `device`,
    cast to `dtype` when given. Raises on a missing, extra or misshapen
    leaf."""
    device = resolve_device(device)
    flat = _flatten(tree_or_flat)
    expected = {k: tuple(t.shape) for k, t in
                LanguageModel(cfg, device="meta").state_dict().items()}
    got = {k.replace("/", "."): v for k, v in flat.items()}
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    if missing or extra:
        raise KeyError(f"parameter tree does not match the config: missing "
                       f"{missing}, unexpected {extra}")
    state = {}
    for key, arr in got.items():
        arr = np.asarray(arr)
        if tuple(arr.shape) != expected[key]:
            raise ValueError(f"shape mismatch for {key}: got {arr.shape}, "
                             f"model {expected[key]}")
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        state[key] = t.to(device=device, dtype=dtype or t.dtype)
    return state


def read_tracker(root: str) -> Optional[str]:
    path = os.path.join(root, TRACKER)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip() or None


def load_npz_checkpoint(root: str, device: DeviceLike = None,
                        dtype: Optional[torch.dtype] = None):
    """Load the checkpoint the tracker under `root` names. Returns
    (LanguageModel, ModelConfig)."""
    tag = read_tracker(root)
    if tag is None:
        raise FileNotFoundError(f"no checkpoint tracker {TRACKER} in {root}")
    d = os.path.join(root, "release" if tag == "release"
                     else f"iter_{int(tag):07d}")
    with open(os.path.join(d, "config.json")) as f:
        cfg = MegatronConfig.from_dict(json.load(f)).model.derived()
    params_path = os.path.join(d, "params.npz")
    if not os.path.exists(params_path):
        raise NotImplementedError(
            f"{d} holds no params.npz: orbax checkpoints are read in a later "
            "slice")
    with np.load(params_path) as npz:
        state = params_from_numpy({k: npz[k] for k in npz.files}, cfg,
                                  device, dtype)
    return LanguageModel.from_state_dict(cfg, state), cfg
