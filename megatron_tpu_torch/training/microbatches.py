"""Microbatch calculator: constant and ramped global batch size.

A copy of megatron_tpu/training/microbatches.py, which is framework-free;
the port keeps its own so that it never imports the JAX package. The batch
size starts at `start`, grows by `increment` every
`ramp_samples / ((gbs - start) / increment)` consumed samples, and stays
divisible by micro_batch_size * data_parallel.
"""
from __future__ import annotations

from typing import Optional, Sequence


class MicrobatchCalculator:
    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel: int,
                 rampup: Optional[Sequence[int]] = None):
        self.micro_batch_size = micro_batch_size
        self.data_parallel = data_parallel
        self.final_gbs = global_batch_size
        per_step = micro_batch_size * data_parallel
        if global_batch_size % per_step:
            raise ValueError(f"global_batch_size {global_batch_size} not "
                             f"divisible by micro*dp={per_step}")
        if rampup is None:
            self._ramp = None
            self._gbs = global_batch_size
        else:
            start, incr, ramp_samples = rampup
            if start % per_step or incr % per_step:
                raise ValueError("rampup start/increment must divide "
                                 "micro*dp")
            steps = (global_batch_size - start) // incr
            if steps <= 0:
                raise ValueError("rampup start must be below the global "
                                 "batch size by at least one increment")
            self._ramp = (start, incr, ramp_samples, ramp_samples // steps)
            self._gbs = start
        self.update(0)

    def update(self, consumed_samples: int) -> None:
        if self._ramp is not None:
            start, incr, ramp_samples, samples_per_incr = self._ramp
            if consumed_samples > ramp_samples:
                self._gbs = self.final_gbs
            else:
                steps = consumed_samples // samples_per_incr
                self._gbs = min(start + steps * incr, self.final_gbs)
        self._num_micro = self._gbs // (self.micro_batch_size
                                        * self.data_parallel)

    @property
    def global_batch_size(self) -> int:
        return self._gbs

    @property
    def num_microbatches(self) -> int:
        return self._num_micro
