"""Fault-injection harness (megatron_tpu/resilience/faults.py): makes
every failure path testable on demand.

`FaultInjector` is one deterministic switchboard, keyed by call counts:

- **transient I/O errors**: named fault points in the checkpoint I/O path
  (`fault_point("checkpoint_write")`, `fault_point("tracker_read")`)
  raise `InjectedFault` (an OSError) on configured calls, so the retry
  layer (resilience/retry.py) absorbs a real exception;
- **NaN batches**: `corrupt_batch` sets a batch's loss_mask to +inf, so the
  loss and the gradients of the real train step go non-finite;
- **step delays**: `maybe_delay` stalls the host before a step, the shape
  of a hung input pipeline, to trip the training watchdog;
- **on-disk corruption**: `corrupt_file`, `truncate_file`,
  `corrupt_checkpoint`, and `corrupt_dataset` with its three corpus faults
  (truncated `.bin`, garbage `.idx` header, out-of-range pointer), which
  `data/indexed_dataset.py` must catch at open
  (`dataset_corruption_drill`, tools/validate_dataset.py --smoke);
- **serving faults** (`serve_delay` / `serve_crash` / `serve_nan`): stall,
  crash or NaN-poison one slot of the serving engine's step, so the
  supervisor (watchdog restart, crash-loop breaker, per-slot non-finite
  guard, serving/engine.py) is proven through a real engine;
- **serving state corruption** (`serve_host_corrupt` /
  `serve_adapter_corrupt`): flip bytes in a demoted host-tier KV entry or
  a demoted host adapter copy. The engine's step flips a host-tier entry
  (serving/host_tier.py), whose CRC gate must turn it into a miss; the
  adapter hook keeps the reference's signature and waits for the adapter
  bank of a later slice.

Activation is process-global (`activate`/`deactivate` or the
`with use_fault_injector(...)` context) and off by default: production
paths pay one `is None` check. `FaultInjector.from_env` parses the
`MEGATRON_TPU_FAULTS` spec (the port's finetune entry point reads it), e.g.
``write_error@2,write_error@3,nan@5,nan@6,delay@4:1.5``: fail the 2nd and
3rd checkpoint writes, poison the 5th and 6th train-step calls, sleep 1.5 s
before the 4th.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional, Set

import numpy as np

# ---------------------------------------------------------------------------
# the active injector (process-global switchboard)
# ---------------------------------------------------------------------------

_ACTIVE: Optional["FaultInjector"] = None
_LOCK = threading.Lock()


def get_fault_injector() -> Optional["FaultInjector"]:
    return _ACTIVE


def activate(injector: "FaultInjector") -> "FaultInjector":
    global _ACTIVE
    with _LOCK:
        _ACTIVE = injector
    return injector


def deactivate() -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


@contextlib.contextmanager
def use_fault_injector(injector: "FaultInjector"):
    activate(injector)
    try:
        yield injector
    finally:
        deactivate()


def fault_point(name: str) -> None:
    """Named hook inside production I/O paths. No-op (one attribute
    read) unless an injector is active and armed for `name`."""
    inj = _ACTIVE
    if inj is not None:
        inj.check(name)


class InjectedFault(OSError):
    """Transient-looking failure raised at a fault point. Subclasses
    OSError so the retry layer treats it exactly like a real
    filesystem flake."""


class FaultInjector:
    """Deterministic fault schedule, keyed by per-name call counts.

    `transient_errors`: fault-point name -> set of 1-based call counts
    that raise `InjectedFault` (each fires once).
    `nan_step_calls`: 1-based train-step CALL counts (monotonic across
    rollbacks — a replayed iteration is a new call) whose batch gets
    poisoned.
    `delay_step_calls`: step call count -> seconds to sleep before it.

    Serving faults (keyed by the ENGINE-step call counter — the serving
    engine advances it once per `_step`, independently of the train
    counter):
    `serve_delay_calls`: engine-step call -> seconds to stall the loop
    (the observable shape of a wedged decode dispatch — trips the
    engine watchdog).
    `serve_crash_calls`: engine-step calls that raise `InjectedFault`
    inside the loop (the supervisor must restart, not hang).
    `serve_nan_calls`: engine-step call -> active-slot ordinal whose
    carried logits are poisoned with NaN before the dispatch, so the
    non-finite guard has a REAL poisoned slot to catch (the fault rides
    the actual sampling + forward, no metric faking).
    `serve_host_corrupt_calls`: engine-step calls at which one demoted
    host-RAM KV-tier entry's bytes are flipped (the tier's CRC gate
    must turn it into a miss — serving/host_tier.py).
    `serve_adapter_corrupt_calls`: engine-step calls at which one
    demoted host adapter copy's bytes are flipped (the bank's CRC gate
    must reload from disk — serving/adapters.py).
    """

    def __init__(self,
                 transient_errors: Optional[Dict[str, Set[int]]] = None,
                 nan_step_calls: Optional[Set[int]] = None,
                 delay_step_calls: Optional[Dict[int, float]] = None,
                 serve_delay_calls: Optional[Dict[int, float]] = None,
                 serve_crash_calls: Optional[Set[int]] = None,
                 serve_nan_calls: Optional[Dict[int, int]] = None,
                 serve_host_corrupt_calls: Optional[Set[int]] = None,
                 serve_adapter_corrupt_calls: Optional[Set[int]] = None):
        self.transient_errors = {
            k: set(v) for k, v in (transient_errors or {}).items()}
        self.nan_step_calls = set(nan_step_calls or ())
        self.delay_step_calls = dict(delay_step_calls or {})
        self.serve_delay_calls = dict(serve_delay_calls or {})
        self.serve_crash_calls = set(serve_crash_calls or ())
        self.serve_nan_calls = dict(serve_nan_calls or {})
        self.serve_host_corrupt_calls = set(
            serve_host_corrupt_calls or ())
        self.serve_adapter_corrupt_calls = set(
            serve_adapter_corrupt_calls or ())
        self._counts: Dict[str, int] = {}
        self._step_calls = 0
        self._serve_steps = 0
        self._lock = threading.Lock()
        # audit trail: (kind, detail) of every fault actually fired
        self.fired: list = []

    # ---- fault points (I/O) ------------------------------------------
    def check(self, name: str) -> None:
        with self._lock:
            n = self._counts.get(name, 0) + 1
            self._counts[name] = n
            armed = n in self.transient_errors.get(name, ())
            if armed:
                self.fired.append(("transient_error", f"{name}@{n}"))
        if armed:
            raise InjectedFault(
                f"injected transient failure at {name} (call {n})")

    # ---- train-step hooks --------------------------------------------
    def next_step_call(self) -> int:
        """Advance the step-call counter; the loop calls this once per
        executed train step (replays after rollback keep counting)."""
        with self._lock:
            self._step_calls += 1
            return self._step_calls

    def maybe_delay(self, step_call: int,
                    sleep=time.sleep) -> float:
        d = self.delay_step_calls.get(step_call, 0.0)
        if d > 0.0:
            with self._lock:
                self.fired.append(("delay", f"step@{step_call}:{d}"))
            sleep(d)
        return d

    def corrupt_batch(self, batch: dict, step_call: int) -> dict:
        """Poison the loss_mask with +inf so the REAL compiled step
        produces a non-finite loss and non-finite gradients — the
        honest end-to-end shape of a divergence, not a faked metric."""
        if step_call not in self.nan_step_calls:
            return batch
        with self._lock:
            self.fired.append(("nan", f"step@{step_call}"))
        batch = dict(batch)
        mask = np.asarray(batch.get("loss_mask"), dtype=np.float32).copy()
        mask[...] = np.inf
        batch["loss_mask"] = mask
        return batch

    # ---- serving-engine hooks ----------------------------------------
    def next_serve_step(self) -> int:
        """Advance the engine-step counter; the serving loop calls this
        once per `_step` (restarted loops keep counting — a restart is
        not a reset, so a crash-loop schedule keeps firing)."""
        with self._lock:
            self._serve_steps += 1
            return self._serve_steps

    def maybe_serve_delay(self, step_call: int, sleep=time.sleep) -> float:
        d = self.serve_delay_calls.get(step_call, 0.0)
        if d > 0.0:
            with self._lock:
                self.fired.append(("serve_delay",
                                   f"step@{step_call}:{d}"))
            sleep(d)
        return d

    def check_serve_crash(self, step_call: int) -> None:
        if step_call in self.serve_crash_calls:
            with self._lock:
                self.fired.append(("serve_crash", f"step@{step_call}"))
            raise InjectedFault(
                f"injected engine-step crash (step {step_call})")

    def serve_host_corrupt(self, step_call: int) -> bool:
        """True when this engine step is scheduled to corrupt a demoted
        host-tier KV entry (the engine then calls
        `corrupt_host_tier_entry`, which records the firing only if it
        actually flipped bytes — an empty tier is a no-op)."""
        return step_call in self.serve_host_corrupt_calls

    def serve_adapter_corrupt(self, step_call: int) -> bool:
        """True when this engine step is scheduled to corrupt a demoted
        host adapter copy (see `corrupt_adapter_host_entry`)."""
        return step_call in self.serve_adapter_corrupt_calls

    def corrupt_host_tier_entry(self, tier) -> bool:
        """Flip one byte in the LARGEST demoted host-tier entry's
        arrays (serving/host_tier.py HostKVTier). Returns True (and
        records the firing) when an entry existed to corrupt; the
        tier's CRC verify must then turn the next restore of that
        entry into a checksum MISS."""
        entries = getattr(tier, "_entries", None)
        if not entries:
            return False
        ent = max(entries.values(), key=lambda e: e.nbytes)
        name = sorted(ent.arrays)[0]
        ent.arrays[name].view(np.uint8).flat[0] ^= 0xFF
        with self._lock:
            self.fired.append(("serve_host_corrupt",
                               f"entry@{ent.key!r}"))
        return True

    def corrupt_adapter_host_entry(self, bank) -> bool:
        """Flip one byte in one demoted host adapter copy
        (serving/adapters.py AdapterBank._host). Returns True (and
        records the firing) when a demoted copy existed; the bank's
        CRC verify must then reload that adapter from its source
        instead of serving the corrupt copy."""
        host = getattr(bank, "_host", None)
        if not host:
            return False
        aid, ent = next(iter(host.items()))
        name = sorted(ent.arrays)[0]
        ent.arrays[name].view(np.uint8).flat[0] ^= 0xFF
        with self._lock:
            self.fired.append(("serve_adapter_corrupt",
                               f"adapter@{aid!r}"))
        return True

    def serve_nan_slot(self, step_call: int) -> Optional[int]:
        """Active-slot ordinal to poison with NaN logits at this engine
        step, or None. The engine maps the ordinal onto its active-slot
        list (mod), so the schedule never depends on slot layout."""
        slot = self.serve_nan_calls.get(step_call)
        if slot is not None:
            with self._lock:
                self.fired.append(("serve_nan",
                                   f"step@{step_call}:slot{slot}"))
        return slot

    # ---- on-disk corruption (static helpers) -------------------------
    @staticmethod
    def corrupt_file(path: str, offset: int = 0, nbytes: int = 8) -> None:
        """Flip `nbytes` bytes in place — simulated bit rot / torn
        write."""
        size = os.path.getsize(path)
        if size == 0:
            with open(path, "wb") as f:
                f.write(b"\xff" * nbytes)
            return
        offset = min(offset, size - 1)
        with open(path, "r+b") as f:
            f.seek(offset)
            chunk = f.read(min(nbytes, size - offset))
            f.seek(offset)
            f.write(bytes(b ^ 0xFF for b in chunk))

    @staticmethod
    def truncate_file(path: str, drop_bytes: int = 8,
                      keep_bytes: Optional[int] = None) -> int:
        """Chop the tail off a file (simulated torn copy / partial
        upload); returns the new size."""
        size = os.path.getsize(path)
        new = (keep_bytes if keep_bytes is not None
               else max(size - drop_bytes, 0))
        with open(path, "r+b") as f:
            f.truncate(new)
        return new

    DATASET_FAULTS = ("truncate_bin", "garbage_idx", "oob_pointer")

    @staticmethod
    def corrupt_dataset(prefix: str, mode: str = "truncate_bin") -> str:
        """Inject on-disk dataset corruption into a `.idx`/`.bin` pair;
        returns the path touched. The open-time validation in
        MMapIndexedDataset must catch every mode with a typed
        DatasetCorruptionError (tools/validate_dataset.py --smoke):

        - ``truncate_bin``: chop the tail off `.bin` so index pointers
          run past EOF (torn copy / disk-full write);
        - ``garbage_idx``: overwrite the `.idx` header (bad magic —
          classic wrong-file / bit-rot shape);
        - ``oob_pointer``: rewrite the LAST pointer in `.idx` to far
          beyond the `.bin` size (single flipped high byte shape).
        """
        from megatron_tpu_torch.data import indexed_dataset as idx_mod
        bin_path = idx_mod.data_file_path(prefix)
        idx_path = idx_mod.index_file_path(prefix)
        if mode == "truncate_bin":
            size = os.path.getsize(bin_path)
            FaultInjector.truncate_file(
                bin_path, drop_bytes=max(size // 2, 1))
            return bin_path
        if mode == "garbage_idx":
            with open(idx_path, "r+b") as f:
                f.write(b"\xff" * 16)
            return idx_path
        if mode == "oob_pointer":
            import struct
            with open(idx_path, "rb") as f:
                header = f.read(34)
            (n,) = struct.unpack("<Q", header[18:26])
            if n == 0:
                raise ValueError(f"{prefix}: empty index has no "
                                 "pointers to corrupt")
            last_ptr_off = 34 + 4 * n + 8 * (n - 1)
            huge = os.path.getsize(bin_path) * 2 + 4096
            with open(idx_path, "r+b") as f:
                f.seek(last_ptr_off)
                f.write(struct.pack("<q", huge))
            return idx_path
        raise ValueError(f"unknown dataset fault {mode!r} "
                         f"(valid: {FaultInjector.DATASET_FAULTS})")

    @staticmethod
    def dataset_corruption_drill(workdir: str) -> Dict[str, bool]:
        """Build → prime handle cache → corrupt → reopen, once per
        DATASET_FAULTS mode; maps mode → "reopen raised the typed
        DatasetCorruptionError". Priming the cache before corrupting
        also proves `make_dataset` re-validates on mtime/size change
        instead of serving the stale pre-corruption mmap. Used by
        tools/validate_dataset.py --smoke."""
        from megatron_tpu_torch.data.indexed_dataset import (
            DatasetCorruptionError, IndexedDatasetBuilder, make_dataset)
        detected = {}
        for mode in FaultInjector.DATASET_FAULTS:
            prefix = os.path.join(workdir, f"drill_{mode}")
            b = IndexedDatasetBuilder(prefix, dtype="int32")
            for i in range(8):
                b.add_item(list(range(i, i + 12)))
                b.end_document()
            b.finalize()
            make_dataset(prefix)
            FaultInjector.corrupt_dataset(prefix, mode)
            try:
                make_dataset(prefix)
                detected[mode] = False
            except DatasetCorruptionError:
                detected[mode] = True
        return detected

    @staticmethod
    def corrupt_checkpoint(ckpt_dir: str, nbytes: int = 8) -> str:
        """Corrupt the largest payload file under an iteration dir
        (skipping the manifest itself) and return its path."""
        from megatron_tpu_torch.resilience.integrity import MANIFEST
        victim, vsize = None, -1
        for root, _, files in os.walk(ckpt_dir):
            for fn in files:
                if fn == MANIFEST:
                    continue
                p = os.path.join(root, fn)
                s = os.path.getsize(p)
                if s > vsize:
                    victim, vsize = p, s
        if victim is None:
            raise FileNotFoundError(f"no files to corrupt in {ckpt_dir}")
        FaultInjector.corrupt_file(victim, offset=max(vsize // 2, 0),
                                   nbytes=nbytes)
        return victim

    # ---- env-driven construction -------------------------------------
    ENV_VAR = "MEGATRON_TPU_FAULTS"

    @classmethod
    def from_env(cls, spec: Optional[str] = None
                 ) -> Optional["FaultInjector"]:
        """Parse a comma-separated spec (see module docstring). Returns
        None when the spec is empty/absent. Unknown kinds raise — a
        typo'd chaos schedule must not silently test nothing."""
        spec = spec if spec is not None else os.environ.get(cls.ENV_VAR, "")
        spec = spec.strip()
        if not spec:
            return None
        transient: Dict[str, Set[int]] = {}
        nans: Set[int] = set()
        delays: Dict[int, float] = {}
        serve_delays: Dict[int, float] = {}
        serve_crashes: Set[int] = set()
        serve_nans: Dict[int, int] = {}
        serve_host_corrupts: Set[int] = set()
        serve_adapter_corrupts: Set[int] = set()
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            kind, _, arg = item.partition("@")
            if kind == "write_error":
                transient.setdefault("checkpoint_write", set()).add(
                    int(arg))
            elif kind == "tracker_error":
                transient.setdefault("tracker_read", set()).add(int(arg))
            elif kind == "nan":
                nans.add(int(arg))
            elif kind == "delay":
                n, _, secs = arg.partition(":")
                delays[int(n)] = float(secs or 1.0)
            elif kind == "serve_delay":
                n, _, secs = arg.partition(":")
                serve_delays[int(n)] = float(secs or 1.0)
            elif kind == "serve_crash":
                serve_crashes.add(int(arg))
            elif kind == "serve_nan":
                n, _, slot = arg.partition(":")
                serve_nans[int(n)] = int(slot or 0)
            elif kind == "serve_host_corrupt":
                serve_host_corrupts.add(int(arg))
            elif kind == "serve_adapter_corrupt":
                serve_adapter_corrupts.add(int(arg))
            else:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {cls.ENV_VAR} "
                    f"(valid: write_error, tracker_error, nan, delay, "
                    f"serve_delay, serve_crash, serve_nan, "
                    f"serve_host_corrupt, serve_adapter_corrupt)")
        return cls(transient_errors=transient, nan_step_calls=nans,
                   delay_step_calls=delays,
                   serve_delay_calls=serve_delays,
                   serve_crash_calls=serve_crashes,
                   serve_nan_calls=serve_nans,
                   serve_host_corrupt_calls=serve_host_corrupts,
                   serve_adapter_corrupt_calls=serve_adapter_corrupts)
