"""Named-span wall-clock timers (megatron_tpu/utils/timers.py).

A barrier is `torch.cuda.synchronize()` on the device of the tensor passed
as `sync_on` (the JAX timer blocks on the array it is given); a CPU tensor
needs none. With `barrier_free` every barrier is dropped and the spans
measure host wall time only: the training loop times whole log windows,
whose metrics fetch already syncs.
"""
from __future__ import annotations

import time
from typing import Optional


def _sync(t) -> None:
    import torch
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class _Timer:
    def __init__(self, name: str, barrier_free: bool = False):
        self.name = name
        self.barrier_free = barrier_free
        self._elapsed = 0.0
        self._count = 0
        self._started = False
        self._start_time = 0.0

    def start(self, barrier: bool = False, sync_on=None):
        assert not self._started, f"timer {self.name} already started"
        if sync_on is not None and not self.barrier_free:
            _sync(sync_on)
        self._start_time = time.perf_counter()
        self._started = True

    def stop(self, barrier: bool = False, sync_on=None):
        assert self._started, f"timer {self.name} not started"
        if sync_on is not None and not self.barrier_free:
            _sync(sync_on)
        self._elapsed += time.perf_counter() - self._start_time
        self._count += 1
        self._started = False

    def ensure_started(self):
        """Idempotent start: the loop opens one span per log window."""
        if not self._started:
            self.start()

    def stop_if_started(self):
        if self._started:
            self.stop()

    def elapsed(self, reset: bool = True) -> float:
        was_started = self._started
        if was_started:
            self.stop()
        e = self._elapsed
        if reset:
            self._elapsed = 0.0
            self._count = 0
        if was_started:
            self.start()
        return e

    @property
    def count(self) -> int:
        return self._count


class Timers:
    """Registry of named timers with log levels 0-2 and a writer dump."""

    def __init__(self, log_level: int = 2, barrier_free: bool = False):
        self._timers: dict[str, _Timer] = {}
        self._levels: dict[str, int] = {}
        self.log_level = log_level
        self.barrier_free = barrier_free

    def __call__(self, name: str, log_level: int = 0) -> _Timer:
        if name not in self._timers:
            self._timers[name] = _Timer(name,
                                        barrier_free=self.barrier_free)
            self._levels[name] = log_level
        return self._timers[name]

    def log(self, names: Optional[list] = None, normalizer: float = 1.0,
            reset: bool = True) -> str:
        """Elapsed times in ms."""
        names = names or [n for n, lvl in self._levels.items()
                          if lvl <= self.log_level]
        parts = []
        for name in names:
            if name not in self._timers:
                continue
            t = self._timers[name].elapsed(reset=reset) * 1000.0 / normalizer
            parts.append(f"{name}: {t:.2f}")
        return "time (ms) | " + " | ".join(parts)

    def write(self, names, writer, iteration, normalizer: float = 1.0,
              reset: bool = False):
        for name in names:
            if name in self._timers:
                value = self._timers[name].elapsed(reset=reset) / normalizer
                writer.add_scalar(f"timers/{name}", value, iteration)
