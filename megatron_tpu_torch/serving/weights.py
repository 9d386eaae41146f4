"""Live weights: host-side staging behind the manifest gate, the version
bookkeeping and the checkpoint watcher (megatron_tpu/serving/weights.py).

- `load_staged(ckpt_dir, example)` verifies checkpoint N+1 against its
  SHA-256 manifest (resilience/integrity.py) and only then reads its
  parameters into host memory (numpy; nothing touches a device). A
  corrupt, truncated or manifest-less (mid-publish: the tracker names a
  checkpoint only once its manifest is written) checkpoint is refused with
  `WeightSwapError`, and the engine serves on with its current weights.
- `place_params(staged, example, cfg, device)` builds the device tree the
  engine flips to: each leaf cast to the dtype of the example's leaf, W8
  leaves re-quantized for an int8-resident example. Every tensor exists
  before the caller flips, so the peak is two copies of the weights. The
  placed tree is cached on the staged object, so the replicas of one
  router that a rolling upgrade walks share one device copy.
- `WeightVersion` (iteration and manifest digest) threads through
  `health()`, `/healthz`, `/metrics` and every SSE start frame.
- `CheckpointWatcher` polls a training root's tracker and drives
  `rolling_upgrade` (a router) or `swap_weights` (an engine) to each newly
  published checkpoint; a refused tag is not retried until the tracker
  names a new one (or after a long backoff).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from megatron_tpu_torch.resilience import integrity
from megatron_tpu_torch.utils.logging import print_rank_0


class WeightSwapError(RuntimeError):
    """Typed refusal: the checkpoint failed the manifest gate or staging,
    or the swap could not be applied. The engine that raised it serves on
    with its current weights."""


class WeightVersion:
    """What an engine serves: the checkpoint iteration and a short digest
    of its manifest (two payloads at one iteration differ in digest)."""

    __slots__ = ("iteration", "digest")

    def __init__(self, iteration: int, digest: str):
        self.iteration = int(iteration)
        self.digest = str(digest)

    @property
    def label(self) -> str:
        return f"{self.iteration}:{self.digest}"

    def __eq__(self, other):
        return (isinstance(other, WeightVersion)
                and other.iteration == self.iteration
                and other.digest == self.digest)

    def __hash__(self):
        return hash((self.iteration, self.digest))

    def __repr__(self):
        return f"WeightVersion({self.label})"


class StagedWeights:
    """A checkpoint staged in host memory: {"a/b/c": numpy array} and its
    version, plus the timings of the gate (`verify_s`) and the read
    (`read_s`) and the bytes read."""

    __slots__ = ("params", "version", "ckpt_dir", "verify_s", "read_s",
                 "nbytes", "_placed", "_lock")

    def __init__(self, params: dict, version: WeightVersion,
                 ckpt_dir: Optional[str] = None, verify_s: float = 0.0,
                 read_s: float = 0.0):
        self.params = params
        self.version = version
        self.ckpt_dir = ckpt_dir
        self.verify_s = verify_s
        self.read_s = read_s
        self.nbytes = int(sum(a.nbytes for a in params.values()))
        self._placed: dict = {}
        self._lock = threading.Lock()


def host_params(params) -> dict:
    """A LanguageModel's or parameter tree's float weights copied to host
    memory as {"a/b/c": float32 numpy array} (the StagedWeights layout)."""
    from megatron_tpu_torch.training.checkpointing import tree_leaves
    return {k: np.array(v.detach().float().cpu())
            for k, v in tree_leaves(params).items()}


def manifest_digest(ckpt_dir: str) -> str:
    """A short digest of the checkpoint's manifest (which digests every
    payload file, so this addresses the whole checkpoint's content)."""
    with open(os.path.join(ckpt_dir, integrity.MANIFEST), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:12]


def checkpoint_version(ckpt_dir: str) -> WeightVersion:
    """The WeightVersion of a checkpoint dir (its metadata iteration and
    manifest digest; "unverified" without a manifest)."""
    with open(os.path.join(ckpt_dir, "metadata.json")) as f:
        iteration = int(json.load(f).get("iteration", 0))
    has_manifest = os.path.exists(os.path.join(ckpt_dir, integrity.MANIFEST))
    return WeightVersion(iteration, manifest_digest(ckpt_dir)
                         if has_manifest else "unverified")


def load_staged(ckpt_dir: str, example_params, *,
                require_manifest: bool = True) -> StagedWeights:
    """Verify and stage one checkpoint in host memory: the manifest first
    (every payload file re-digested), the parameters second, no device at
    any point. `example_params` gives the expected names and shapes (a
    different model is refused, not reshaped). `require_manifest=False`
    admits a pre-manifest checkpoint for startup staging; the swap path
    keeps the default, since a manifest-less dir looks like one caught
    mid-publish."""
    t0 = time.perf_counter()
    ok, why = integrity.verify_checkpoint(ckpt_dir, deep=True)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise WeightSwapError(
            f"checkpoint {ckpt_dir} refused at the manifest gate: {why} "
            "(nothing touched a device; the current weights keep serving)")
    unverified = why != "ok"
    if unverified and require_manifest:
        raise WeightSwapError(
            f"checkpoint {ckpt_dir} refused at the manifest gate: no "
            "manifest.json, so either a pre-manifest checkpoint or one "
            "still being published; the current weights keep serving")
    try:
        with open(os.path.join(ckpt_dir, "metadata.json")) as f:
            iteration = int(json.load(f).get("iteration", 0))
    except (OSError, ValueError) as e:
        raise WeightSwapError(f"checkpoint {ckpt_dir} metadata unreadable "
                              f"({e}); refused") from e
    t0 = time.perf_counter()
    try:
        from megatron_tpu_torch.training.checkpointing import \
            load_params_host
        params = load_params_host(ckpt_dir, example_params,
                                  verified=not unverified)
    except Exception as e:  # noqa: BLE001 — any staging failure refuses
        raise WeightSwapError(
            f"checkpoint {ckpt_dir} failed host-side staging "
            f"({type(e).__name__}: {e}); refused before any device "
            "transfer, the current weights keep serving") from e
    read_s = time.perf_counter() - t0
    digest = manifest_digest(ckpt_dir) if not unverified else "unverified"
    return StagedWeights(params, WeightVersion(iteration, digest),
                         ckpt_dir=ckpt_dir, verify_s=verify_s,
                         read_s=read_s)


def stage_latest(root: str, example_params) -> StagedWeights:
    """Stage the newest loadable checkpoint under `root`: the tracker's
    first, then every other `iter_*` dir newest first. Startup staging, so
    a manifest-less dir is admitted. Raises WeightSwapError when nothing
    stages."""
    from megatron_tpu_torch.training.checkpointing import (dir_for_tag,
                                                           read_tracker)
    candidates = []
    d = dir_for_tag(root, read_tracker(root))
    if d is not None:
        candidates.append(d)
    for _, d2 in integrity.list_iter_checkpoints(root):
        if d2 not in candidates:
            candidates.append(d2)
    last_err: Optional[Exception] = None
    for d in candidates:
        if not os.path.isdir(d):
            continue
        try:
            return load_staged(d, example_params, require_manifest=False)
        except WeightSwapError as e:
            last_err = e
            print_rank_0(f"weights: checkpoint {d} refused ({e}); falling "
                         "back to the previous one")
    raise WeightSwapError(
        f"no stageable checkpoint under {root}"
        + (f" (last refusal: {last_err})" if last_err else ""))


@torch.no_grad()
def place_params(staged: StagedWeights, example, cfg, device):
    """The staged weights on `device` in the example's form: a
    LanguageModel for a LanguageModel example, else a parameter tree (W8
    leaves quantized again where the example holds W8). Cached on `staged`
    per device, so replicas sharing a staged checkpoint share one device
    copy."""
    from megatron_tpu_torch.models.language_model import (LanguageModel,
                                                          params_tree)
    from megatron_tpu_torch.ops.quantized import W8, quantize_weights
    from megatron_tpu_torch.training.checkpointing import tree_leaves
    key = str(torch.device(device))
    with staged._lock:
        placed = staged._placed.get(key)
        if placed is not None:
            return placed
        leaves = tree_leaves(example)
        state = {}
        any_w8 = False
        for name, arr in staged.params.items():
            w8 = isinstance(leaves[name], W8)
            any_w8 |= w8
            t = torch.from_numpy(np.require(arr, requirements=["C"]))
            state[name.replace("/", ".")] = t.to(
                device=device,
                dtype=torch.float32 if w8 else leaves[name].dtype)
        if isinstance(example, LanguageModel):
            placed = LanguageModel.from_state_dict(cfg, state)
        else:
            placed = params_tree(state)
            if any_w8:
                placed = quantize_weights(placed)
        staged._placed[key] = placed
        return placed


class CheckpointWatcher:
    """Polls a training root's tracker and drives `target` to each newly
    published checkpoint: `rolling_upgrade` on an EngineRouter, else
    `swap_weights`. A refused or failed tag is remembered: it is retried
    only after a long backoff, and a new tag is tried at once. The
    engines count `weight_swap_failures` themselves."""

    def __init__(self, target, root: str, interval_s: float = 5.0,
                 initial_tag: Optional[str] = None):
        self.target = target
        self.root = str(root)
        self.interval_s = max(float(interval_s), 0.05)
        # the tag the target already serves (a versioned start): the first
        # poll then does not swap to the checkpoint it booted from
        self.applied: Optional[str] = initial_tag
        self.failed: Optional[str] = None
        self.failures = 0
        self._last_tried: Optional[str] = initial_tag
        self._retry_at = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-watcher")

    def start(self):
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=10)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — outlive a bad poll
                print_rank_0(f"checkpoint watcher: poll failed ({e!r})")

    def poll_once(self) -> bool:
        """One poll. True when a swap or upgrade was applied."""
        from megatron_tpu_torch.training.checkpointing import (dir_for_tag,
                                                               read_tracker)
        try:
            tag = read_tracker(self.root)
        except Exception:  # noqa: BLE001 — racing a publish; next beat
            return False
        if not tag:
            return False
        if tag == self._last_tried:
            if self.failed != tag:
                return False  # applied (or applying)
            if time.monotonic() < self._retry_at:
                return False  # a refused tag waits out its backoff
        d = dir_for_tag(self.root, tag)
        if d is None or not os.path.isdir(d):
            return False
        self._last_tried = tag
        try:
            if hasattr(self.target, "rolling_upgrade"):
                version = self.target.rolling_upgrade(d)
            else:
                version = self.target.swap_weights(d)
        except Exception as e:  # noqa: BLE001 — a refusal is safe
            self.failed = tag
            self.failures += 1
            self._retry_at = time.monotonic() + max(self.interval_s * 10,
                                                    60.0)
            print_rank_0(f"checkpoint watcher: swap to {d} refused ({e}); "
                         "the current weights keep serving until the next "
                         "publish")
            return False
        self.failed = None
        self.applied = tag
        label = version.label if version is not None else tag
        print_rank_0(f"checkpoint watcher: now serving {label} (tracker "
                     f"tag {tag})")
        return True
