"""Hung-step watchdog (megatron_tpu/resilience/watchdog.py).

A wedged step (a kernel that never returns, a stalled input pipeline, a
storage call that hangs) leaves the process alive but making no progress,
which no exit-code supervisor can see. `StepWatchdog` is a monitor thread
armed by a per-step `heartbeat()`: when no heartbeat lands within
`timeout_s` it

1. dumps every thread's stack via `faulthandler` (where it was stuck),
2. runs the `on_timeout` callback in a thread bounded by
   `on_timeout_budget_s` (the training loop passes a best-effort final
   checkpoint),
3. exits the process with a distinct code (default 43), so a restart
   policy can tell "hung" from "crashed" from "clean exit".

`exit_process=False` is the detection-only mode of the serving engine's
supervisor: the deadline runs `on_timeout` and latches `fired` until
`rearm()`, and the process lives on. Callers arm it only after the first
step completes: the first step builds the kernels, whose duration is
unrelated to the steady state the deadline protects.
"""
from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

# module-level exit hook: tests monkeypatch this to observe a firing
# without losing the process
_exit = os._exit

DEFAULT_EXIT_CODE = 43


class StepWatchdog:
    """Deadline monitor. `start()` arms it; `heartbeat()` resets the
    deadline; `stop()` disarms (idempotent, called from the loop's
    finally)."""

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[], None]] = None,
                 exit_code: int = DEFAULT_EXIT_CODE,
                 poll_s: Optional[float] = None,
                 dump_stacks: bool = True,
                 on_timeout_budget_s: float = 60.0,
                 exit_process: bool = True):
        assert timeout_s > 0.0, timeout_s
        self.timeout_s = float(timeout_s)
        self.on_timeout = on_timeout
        self.exit_code = int(exit_code)
        # exit_process=False: DETECTION-ONLY mode (the serving engine
        # supervisor) — on deadline run `on_timeout` and latch `fired`
        # instead of killing the process; the supervisor restarts the
        # wedged loop and `rearm()`s. Training keeps the default True:
        # a hung train step has no supervisor above it in-process.
        self.exit_process = bool(exit_process)
        self.poll_s = poll_s if poll_s is not None else min(
            self.timeout_s / 4.0, 1.0)
        self.dump_stacks = dump_stacks
        # hard bound on the final-checkpoint callback: when the hang IS
        # the storage, an unbounded save attempt would wedge the
        # watchdog itself and the exit would never happen
        self.on_timeout_budget_s = float(on_timeout_budget_s)
        self.fired = False
        self._last = time.monotonic()
        self._suspended = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def started(self) -> bool:
        return self._thread is not None

    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            return self
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="step-watchdog")
        self._thread.start()
        return self

    def heartbeat(self) -> None:
        self._last = time.monotonic()

    def rearm(self) -> None:
        """Detection-only mode: clear a latched firing and restart the
        deadline clock (called by the serving supervisor after it
        restarted the wedged loop)."""
        self.fired = False
        self._last = time.monotonic()

    def suspend(self) -> "StepWatchdog":
        """Pause deadline checking across a phase whose duration is
        unrelated to step health (eval sweep, checkpoint save):

            with watchdog.suspend(): evaluate(...)

        The deadline clock restarts at resume."""
        self._suspended = True
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._suspended = False
        self._last = time.monotonic()
        return False

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def _run(self) -> None:
        from megatron_tpu_torch.utils.logging import print_rank_0
        while not self._stop.wait(self.poll_s):
            if self._suspended:
                self._last = time.monotonic()
                continue
            if self.fired and not self.exit_process:
                continue  # latched until rearm()
            stalled = time.monotonic() - self._last
            if stalled <= self.timeout_s:
                continue
            self.fired = True
            print_rank_0(
                f"watchdog: no step progress for {stalled:.1f}s "
                f"(deadline {self.timeout_s:.1f}s); "
                + (f"dumping stacks and exiting with code "
                   f"{self.exit_code}" if self.exit_process
                   else "running the timeout callback (detection-only "
                        "mode; the supervisor restarts the loop)"))
            if self.dump_stacks:
                try:
                    faulthandler.dump_traceback(file=sys.stderr,
                                                all_threads=True)
                except Exception:  # noqa: BLE001 — never block the exit
                    pass
            if self.on_timeout is not None:
                # bounded: run the final-checkpoint attempt in a daemon
                # thread so a wedged storage stack cannot block the exit
                def _cb():
                    try:
                        self.on_timeout()
                    except Exception as e:  # noqa: BLE001
                        print_rank_0(f"watchdog: on_timeout callback "
                                     f"failed: {e!r}")
                t = threading.Thread(target=_cb, daemon=True,
                                     name="watchdog-final-checkpoint")
                t.start()
                t.join(self.on_timeout_budget_s)
                if t.is_alive():
                    print_rank_0("watchdog: final checkpoint attempt "
                                 f"exceeded {self.on_timeout_budget_s}s; "
                                 "exiting without it")
            if not self.exit_process:
                continue  # stay armed-but-latched; rearm() resets
            _exit(self.exit_code)
            return  # only reached when _exit is monkeypatched in tests
