"""Dropout and stochastic depth (megatron_tpu/ops/dropout.py).

Both take an explicit `torch.Generator`; None means eval mode, the
identity, as the reference's `rng=None`. torch cannot reproduce
`jax.random` bits, so the masks match the reference in law only: each
element (or sample) is kept with probability 1 - rate and scaled by
1 / (1 - rate). A generator on another device than `x` (the training
loop's CPU generator with a CUDA activation) seeds a generator on x's
device with one draw, which makes no host sync.

`region` = (whole shape, index) names where `x` lies in a larger tensor
(a rank's slice of the sharded step's activation,
parallel/sharding.py `activation_region`): the mask is drawn for the whole
shape and cut at the index, so a rank keeps exactly its slice of the mask
that the unsharded step draws from the same generator.

`fold_seed` derives a seed from another and a few integers, as the
reference's `jax.random.fold_in` derives a key: the pipelined steps
(parallel/pipeline.py) draw one seed per microbatch and seed each layer's
generator from it and the layer's absolute id, so the masks do not depend
on the order in which a stage meets its layers.
"""
from __future__ import annotations

from typing import Optional

import torch

# the seed drawn for a generator on another device lies below this bound
_SEED_BOUND = 1 << 62


_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(seed: int, *data: int) -> int:
    """A seed in [0, _SEED_BOUND) derived from `seed` and `data` in turn."""
    x = int(seed) & _MASK64
    for d in data:
        x = _mix64(x ^ _mix64(int(d) & _MASK64))
    return x % _SEED_BOUND


def draw_seeds(generator: torch.Generator, n: int) -> list:
    """`n` seeds in [0, _SEED_BOUND) drawn in order from `generator`."""
    return torch.randint(0, _SEED_BOUND, (n,), generator=generator,
                         device=generator.device).tolist()


def seeded(seed: Optional[int]) -> Optional[torch.Generator]:
    """A CPU generator seeded with `seed`; None for None."""
    return None if seed is None else torch.Generator().manual_seed(seed)


def _on_device(generator: torch.Generator,
               device: torch.device) -> torch.Generator:
    if generator.device == device:
        return generator
    seed = int(torch.randint(0, _SEED_BOUND, (1,), generator=generator,
                             device=generator.device).item())
    return torch.Generator(device=device).manual_seed(seed)


def _keep_scaled(generator: torch.Generator, x: torch.Tensor, shape,
                 rate: float, region=None) -> torch.Tensor:
    gen = _on_device(generator, x.device)
    if region is None:
        u = torch.rand(shape, generator=gen, device=x.device)
    else:
        whole, index = region
        u = torch.rand(whole, generator=gen, device=x.device)[index]
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(generator: Optional[torch.Generator], x: torch.Tensor,
            rate: float, region=None) -> torch.Tensor:
    """Inverted dropout of every element; the identity without a generator
    or at rate 0 (a LIMA ramp's first layer). `region`: see the module's
    note."""
    if generator is None or rate == 0.0:
        return x
    return _keep_scaled(generator, x, x.shape, rate, region)


def drop_path(generator: Optional[torch.Generator], x: torch.Tensor,
              rate: float, region=None) -> torch.Tensor:
    """Stochastic depth: zero the whole residual branch of a sample, scaled
    by 1 / (1 - rate) where kept. x is [b, ...]; one draw per sample
    (`region` over the [b, 1, ...] draw)."""
    if generator is None or rate == 0.0:
        return x
    return _keep_scaled(generator, x, (x.shape[0],) + (1,) * (x.dim() - 1),
                        rate, region)
