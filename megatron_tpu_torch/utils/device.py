"""Device resolution for the port's entry points.

The port runs on a CUDA device unless the caller names another one. With no
device named and no GPU present, the entry points raise instead of running
on the CPU, so that a run never measures the CPU while believing it measures
the card.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the current CUDA device, and raises without one. A
    CUDA device without an index gets the current one, so that the result
    compares equal to the device of the tensors placed on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA "
                               "device is available")
        device = torch.device("cuda", torch.cuda.current_device())
    return device
