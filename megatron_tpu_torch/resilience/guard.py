"""Divergence guard: skip, roll back, or abort on pathological loss.

A copy of megatron_tpu/resilience/guard.py (plain Python); the port keeps its
own so that it never imports the JAX package.

The reference's loop merely *counts* NaN iterations
(ref: megatron/training.py:700-706 `got_nan` accounting) — a run that
diverges at 3am keeps burning cluster-weeks skipping every update.
Here the loop consults a policy after every step:

- one non-finite loss / found_inf step → **SKIP** (the optimizer
  already dropped the update via its skip-as-select path; the guard
  just tracks the streak);
- `max_consecutive_nonfinite` bad steps in a row, or a finite loss
  exceeding `loss_spike_factor ×` the rolling-window mean → **ROLLBACK**
  to the last checkpoint; the loop then replays the EXACT data order
  from the checkpoint's saved iterator state and deterministically
  skips the quarantined step window — the poison batches are dodged by
  construction, never by a re-seeded order (the loop owns the
  restore/quarantine; the guard owns the decision);
- more than `max_rollbacks` rollbacks → **ABORT** with
  `TrainingDivergedError` so the supervisor sees a clean, distinct
  failure instead of an infinite crash-loop.

Pure host-side bookkeeping: no device sync beyond the loss float the
loop already pulls for its dashboard.
"""
from __future__ import annotations

import collections
import enum
import math


class TrainingDivergedError(RuntimeError):
    """Raised for a clean abort when divergence survives the rollback
    budget (or no checkpoint exists to roll back to)."""


class GuardAction(enum.Enum):
    OK = "ok"
    SKIP = "skip"          # bad step, already dropped; keep going
    ROLLBACK = "rollback"  # restore last checkpoint, quarantine window


class DivergenceGuard:
    """Per-step divergence policy. `observe()` after every step;
    `note_rollback()` when the loop actually restored (returns True
    when the rollback budget is exhausted → caller aborts)."""

    def __init__(self, max_consecutive_nonfinite: int = 3,
                 loss_spike_factor: float = None,
                 loss_spike_window: int = 32,
                 max_rollbacks: int = 2,
                 min_spike_history: int = 5):
        assert max_consecutive_nonfinite >= 0
        assert loss_spike_factor is None or loss_spike_factor > 1.0, (
            f"loss_spike_factor={loss_spike_factor} must exceed 1.0")
        assert max_rollbacks >= 0
        self.max_consecutive_nonfinite = max_consecutive_nonfinite
        self.loss_spike_factor = loss_spike_factor
        self.max_rollbacks = max_rollbacks
        self.min_spike_history = min_spike_history
        self._history = collections.deque(maxlen=max(loss_spike_window, 1))
        self.nonfinite_streak = 0
        self.rollbacks = 0

    @property
    def enabled(self) -> bool:
        return (self.max_consecutive_nonfinite > 0
                or self.loss_spike_factor is not None)

    def observe(self, loss: float, found_inf: bool) -> GuardAction:
        bad = found_inf or not math.isfinite(loss)
        if bad:
            self.nonfinite_streak += 1
            if (self.max_consecutive_nonfinite > 0
                    and self.nonfinite_streak
                    >= self.max_consecutive_nonfinite):
                return GuardAction.ROLLBACK
            return GuardAction.SKIP
        self.nonfinite_streak = 0
        if (self.loss_spike_factor is not None
                and len(self._history) >= self.min_spike_history):
            mean = sum(self._history) / len(self._history)
            if mean > 0 and loss > self.loss_spike_factor * mean:
                # spike breach: do NOT admit the spiked loss into the
                # history — after rollback the baseline must reflect
                # the healthy run, not the excursion
                return GuardAction.ROLLBACK
        self._history.append(loss)
        return GuardAction.OK

    def note_rollback(self) -> bool:
        """Record a performed rollback and reset streak/history (the
        restored run restarts the statistics). Returns True when the
        budget is now exhausted and the caller must abort."""
        self.rollbacks += 1
        self.nonfinite_streak = 0
        self._history.clear()
        return self.rollbacks > self.max_rollbacks
