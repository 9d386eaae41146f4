"""Dropout and stochastic depth (megatron_tpu/ops/dropout.py).

Both take an explicit `torch.Generator`; None means eval mode, the
identity, as the reference's `rng=None`. torch cannot reproduce
`jax.random` bits, so the masks match the reference in law only: each
element (or sample) is kept with probability 1 - rate and scaled by
1 / (1 - rate). A generator on another device than `x` (the training
loop's CPU generator with a CUDA activation) seeds a generator on x's
device with one draw, which makes no host sync.
"""
from __future__ import annotations

from typing import Optional

import torch

# the seed drawn for a generator on another device lies below this bound
_SEED_BOUND = 1 << 62


def _on_device(generator: torch.Generator,
               device: torch.device) -> torch.Generator:
    if generator.device == device:
        return generator
    seed = int(torch.randint(0, _SEED_BOUND, (1,), generator=generator,
                             device=generator.device).item())
    return torch.Generator(device=device).manual_seed(seed)


def _keep_scaled(generator: torch.Generator, x: torch.Tensor, shape,
                 rate: float) -> torch.Tensor:
    gen = _on_device(generator, x.device)
    u = torch.rand(shape, generator=gen, device=x.device)
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(generator: Optional[torch.Generator], x: torch.Tensor,
            rate: float) -> torch.Tensor:
    """Inverted dropout of every element; the identity without a generator
    or at rate 0 (a LIMA ramp's first layer)."""
    if generator is None or rate == 0.0:
        return x
    return _keep_scaled(generator, x, x.shape, rate)


def drop_path(generator: Optional[torch.Generator], x: torch.Tensor,
              rate: float) -> torch.Tensor:
    """Stochastic depth: zero the whole residual branch of a sample, scaled
    by 1 / (1 - rate) where kept. x is [b, ...]; one draw per sample."""
    if generator is None or rate == 0.0:
        return x
    return _keep_scaled(generator, x, (x.shape[0],) + (1,) * (x.dim() - 1),
                        rate)
