"""Graceful degradation: a brownout ladder instead of a shed cliff
(megatron_tpu/serving/degrade.py, copied: the port keeps its own copy of
this stdlib module).

Without it overload handling is binary — the EWMA admission gate either
admits a request at full service or 429s it. This module inserts the
rungs in between: a controller that watches the SAME host-side
pressure signals the scheduler and placement optimizer already export
(queue depth, slot occupancy, `service_time_ewma`) and walks a
configurable ladder of service reductions under SUSTAINED overload,
one level at a time:

- **level 1** — disable speculative decoding for new decode windows.
  The draft+verify rounds reclaim their compute; the plain `_decode`
  path is already pinned bit-identical to a non-speculative engine,
  so streams switch mid-flight without a token changing.
- **level 2** — cap fan-out and length for NEW admissions: `best_of`
  clamps to `n` (the exploration samples beyond what the caller gets
  back are the first work to go) and `max_new_tokens` clamps to
  `degrade_max_new_tokens`. The clamped values become the request's
  EFFECTIVE config — its serial oracle keys off the request's own
  fields, so token-exactness holds by construction.
- **level 3** — shed only the lowest priority class (priority 0) at
  admission; higher classes still get level-2 service. A single-class
  config (priority_levels == 1) has no "lowest" class to distinguish,
  so level 3 adds nothing there and the ladder goes straight from
  2's clamps to 4's full shed.
- **level 4** — today's full shed: every new admission 429s with a
  Retry-After; queued and running work keeps draining.

Levels strictly nest: each rung keeps every restriction below it.
Degradation changes *which* work is admitted and *how it is decoded*
— never the tokens a given request's effective config produces.

The pressure signal is dimensionless backlog per slot, gated on
occupancy so a draining queue with free slots never trips it:

    pressure = (queue_depth / num_slots) * (active / num_slots)

Hysteresis on BOTH edges keeps one burst from thrashing levels: a
raise needs `dwell_up` consecutive evaluations above the level's
threshold, a lower needs `dwell_down` consecutive evaluations below
`hysteresis * threshold`, and the level moves ONE rung per decision.
The engine evaluates once per supervisor-loop iteration; the current
level rides `health()` and the `degrade_level` gauge (router
aggregate: max — the fleet reports its most-degraded replica), and
every transition counts `degrade_transitions`.

The controller is HOST state, like the scheduler queue: an engine
supervisor restart (`_restart_session`) rebuilds device state only,
so the level deliberately SURVIVES a restart — a replica that wedged
under overload would otherwise come back at level 0 and re-admit the
very flood that wedged it (tests pin this choice).

`degrade_ladder = 0` (the default) builds no controller at all: the
engine is behaviorally bit-identical to the pre-ladder code — same
tokens, same shed decisions — and only the fixed metrics schema
carries the new keys at 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

# the ladder's rungs, by effect — level numbers are the public
# contract ("Overload, degradation & SLO conformance")
LEVEL_FULL_SERVICE = 0
LEVEL_NO_SPEC = 1
LEVEL_CAP_WORK = 2
LEVEL_SHED_LOW_PRIORITY = 3
LEVEL_SHED_ALL = 4
MAX_LEVEL = LEVEL_SHED_ALL

# default raise thresholds (pressure = backlog/slot * occupancy) for
# levels 1..4: half a queued request per busy slot already means the
# next window cannot absorb the backlog on a tiny grid, and each rung
# doubles. Deliberately low-scaled so the ladder engages on the small
# slot grids the chaos tools drive; production configs override via
# `degrade_raise_at`.
DEFAULT_RAISE_AT = (0.5, 1.0, 2.0, 4.0)
# lower edge = hysteresis * raise edge; dwell counts are consecutive
# supervisor-loop evaluations (each one decode window apart), so a
# single bursty window can neither raise nor lower a level by itself
DEFAULT_HYSTERESIS = 0.5
DEFAULT_DWELL_UP = 2
DEFAULT_DWELL_DOWN = 4


class DegradeController:
    """Walks the brownout ladder from host-side pressure signals.

    Single-writer: `observe()` runs on the engine supervisor thread
    only. `level` is a plain int attribute so HTTP submit threads can
    read it without a lock (GIL-atomic read of an int)."""

    def __init__(self, max_level: int,
                 raise_at: Optional[Sequence[float]] = None,
                 hysteresis: float = DEFAULT_HYSTERESIS,
                 dwell_up: int = DEFAULT_DWELL_UP,
                 dwell_down: int = DEFAULT_DWELL_DOWN):
        assert 1 <= max_level <= MAX_LEVEL, (
            f"degrade ladder max_level must be in 1..{MAX_LEVEL}, got "
            f"{max_level} (0 disables the ladder — build no controller)")
        raise_at = tuple(raise_at) if raise_at is not None \
            else DEFAULT_RAISE_AT[:max_level]
        assert len(raise_at) == max_level, (
            f"degrade ladder needs one raise threshold per level: "
            f"max_level={max_level} but raise_at has {len(raise_at)}")
        assert all(b > a for a, b in zip(raise_at, raise_at[1:])), (
            f"degrade raise thresholds must be strictly increasing "
            f"(monotone ladder), got {raise_at}")
        assert raise_at[0] > 0.0, "degrade thresholds must be positive"
        assert 0.0 < hysteresis < 1.0, (
            f"degrade hysteresis must be a ratio in (0, 1) — the lower "
            f"edge is hysteresis * raise edge — got {hysteresis}")
        assert dwell_up >= 1 and dwell_down >= 1, "dwell counts >= 1"
        self.max_level = max_level
        self.raise_at = raise_at
        self.hysteresis = hysteresis
        self.dwell_up = dwell_up
        self.dwell_down = dwell_down
        self.level = LEVEL_FULL_SERVICE
        self.transitions = 0
        self._above = 0   # consecutive evals above the next rung's edge
        self._below = 0   # consecutive evals below the current rung's
        #                   lower edge
        self._last_pressure = 0.0

    @staticmethod
    def pressure(queue_depth: int, active_slots: int,
                 num_slots: int) -> float:
        """Dimensionless backlog-per-slot, occupancy-gated: free slots
        mean the queue drains on the next admission pass, so pressure
        only registers as the grid fills."""
        slots = max(int(num_slots), 1)
        occupancy = max(0.0, min(float(active_slots) / slots, 1.0))
        return (float(queue_depth) / slots) * occupancy

    def observe(self, queue_depth: int, active_slots: int,
                num_slots: int) -> int:
        """One evaluation (one supervisor-loop iteration). Returns the
        (possibly new) level; the caller pushes metrics on change."""
        p = self.pressure(queue_depth, active_slots, num_slots)
        self._last_pressure = p
        # raise edge: pressure above the NEXT rung's threshold
        if self.level < self.max_level and p >= self.raise_at[self.level]:
            self._above += 1
        else:
            self._above = 0
        # lower edge: pressure below the CURRENT rung's lower edge
        if (self.level > LEVEL_FULL_SERVICE
                and p <= self.raise_at[self.level - 1] * self.hysteresis):
            self._below += 1
        else:
            self._below = 0
        if self._above >= self.dwell_up:
            self.level += 1
            self.transitions += 1
            self._above = 0
            self._below = 0
        elif self._below >= self.dwell_down:
            self.level -= 1
            self.transitions += 1
            self._above = 0
            self._below = 0
        return self.level

    # -- per-level effect predicates (the submit/_step seams ask these
    #    instead of comparing level numbers inline) -------------------
    def spec_disabled(self) -> bool:
        return self.level >= LEVEL_NO_SPEC

    def cap_work(self) -> bool:
        return self.level >= LEVEL_CAP_WORK

    def shed_priority(self, priority: int, priority_levels: int) -> bool:
        """Should an admission at `priority` shed at the current level?
        Level 4 sheds everything; level 3 sheds only the lowest class,
        and only when more than one class exists to distinguish."""
        if self.level >= LEVEL_SHED_ALL:
            return True
        if self.level >= LEVEL_SHED_LOW_PRIORITY:
            return priority_levels > 1 and priority == 0
        return False

    def describe(self) -> dict:
        """The shape `health()["degrade"]` exports (the bare level also
        rides top-level `health()["degrade_level"]` for the router)."""
        return {
            "level": self.level,
            "max_level": self.max_level,
            "pressure": self._last_pressure,
            "transitions": self.transitions,
        }

    @classmethod
    def from_config(cls, serving) -> Optional["DegradeController"]:
        """Build from a `ServingConfig`, or None when the ladder is
        disabled — the None path is the bit-identical pre-ladder
        engine."""
        if not getattr(serving, "degrade_ladder", 0):
            return None
        return cls(
            max_level=serving.degrade_ladder,
            raise_at=serving.degrade_raise_at,
            hysteresis=serving.degrade_hysteresis,
            dwell_up=serving.degrade_dwell_up,
            dwell_down=serving.degrade_dwell_down,
        )
