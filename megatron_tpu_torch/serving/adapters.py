"""Device-resident LoRA adapter bank for multi-tenant serving
(megatron_tpu/serving/adapters.py).

Many fine-tuned variants of one base model share one slot grid (S-LoRA,
Punica): each decode row gathers its own adapter's factors by a per-slot
index and adds the low-rank delta to the base projections.

- The bank is a stacked `LoraAdapter` (models/attention.py) of the q/k/v/o
  factors, [L, n, h, r] and [L, n, r, out]; row 0 is the identity adapter
  (all zero), so base-model rows ride the same forward with a zero delta.
- The engine keeps a per-slot `adapter_idx` next to the block map; with
  `adapter_slots=0` there is no bank and the forward runs no extra op.
- The alpha/rank scale is folded into the B factors at load (in fp32), and
  an adapter exported at a smaller rank is zero-padded up to the bank's
  (a padded pair is the same delta).

Capacity follows the prefix cache's retained LRU and the host KV tier's
CRC discipline: loading an adapter into a full bank evicts the least
recently used unpinned row, whose factors (for an adapter registered by
path) demote to host RAM under a CRC32 within `adapter_host_bytes`. A
restore verifies the checksum; a corrupt copy reloads from the adapter's
`.npz` (a miss, never wrong weights). Rows pinned by running slots are
never evicted; when every row is pinned `acquire` raises
`AdapterBankFullError` and the engine requeues the request.

Row writes are in place: the engine thread issues every kernel on one
stream, so a write lands after the forwards queued before it.

Thread contract: `known`, `peek`, `ids`, `namespace` and `active_count`
may run on HTTP threads (dict reads under the bank lock, the router's
adapter-locality signal); `acquire`, `release` and `reset_pins` run on the
engine thread; `register` may run on either.

The `.npz` format (training/lora.py `export_adapter`) is the reference's:
raw (unscaled, unpadded) float32 factors `aq/bq/ak/bk/av/bv/ao/bo`, each
with a leading layers dim, plus `format_version`, `rank`, `alpha` and a
JSON `meta` string. Either package reads the other's.
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
from typing import Dict, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.attention import LoraAdapter
from megatron_tpu_torch.serving.host_tier import _checksum
from megatron_tpu_torch.serving.scheduler import AdmissionError
from megatron_tpu_torch.utils.logging import print_rank_0

ADAPTER_FORMAT_VERSION = 1

FACTOR_NAMES = LoraAdapter._fields  # ("aq","bq","ak","bk","av","bv","ao","bo")


class UnknownAdapterError(AdmissionError):
    """A request named an adapter_id nothing registered (HTTP 400)."""


class AdapterBankFullError(RuntimeError):
    """Every non-identity row is pinned by a running slot; the engine
    requeues the request until a slot frees."""


def adapter_factor_shapes(cfg: ModelConfig, rank: int) -> Dict[str, tuple]:
    """Per-adapter factor shapes (leading layers dim, no bank dim): the
    `.npz` layout and the unit the bank pads and folds."""
    L, h, r = cfg.num_layers, cfg.hidden_size, rank
    dq = cfg.num_attention_heads * cfg.kv_channels
    dkv = cfg.num_kv_heads * cfg.kv_channels
    return {"aq": (L, h, r), "bq": (L, r, dq),
            "ak": (L, h, r), "bk": (L, r, dkv),
            "av": (L, h, r), "bv": (L, r, dkv),
            "ao": (L, dq, r), "bo": (L, r, h)}


def adapter_bank_nbytes(cfg: ModelConfig, slots: int, rank: int,
                        itemsize: int = 4) -> int:
    """Device bytes of a bank of `slots` adapters plus the identity row
    (ServingConfig.validate's budget check uses the same formula)."""
    per = sum(int(np.prod(s))
              for s in adapter_factor_shapes(cfg, rank).values())
    return per * (slots + 1) * itemsize


def load_adapter_npz(path: str):
    """Read a versioned adapter export: (factors dict of float32 [L, ...]
    arrays, rank, alpha, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > ADAPTER_FORMAT_VERSION:
            raise ValueError(
                f"adapter {path}: format_version={version} is newer than "
                f"this build supports ({ADAPTER_FORMAT_VERSION})")
        missing = [n for n in FACTOR_NAMES if n not in z]
        if missing:
            raise ValueError(f"adapter {path}: missing factors {missing}")
        factors = {n: np.asarray(z[n], np.float32) for n in FACTOR_NAMES}
        rank = int(z["rank"])
        alpha = float(z["alpha"])
        meta = json.loads(str(z["meta"])) if "meta" in z else {}
    return factors, rank, alpha, meta


def fold_factors(factors: Dict[str, np.ndarray], rank: int, alpha: float,
                 cfg: ModelConfig, bank_rank: int) -> Dict[str, np.ndarray]:
    """Check raw factors against the model's geometry, fold alpha/rank into
    the B factors (fp32) and zero-pad the rank up to the bank's. Raises
    ValueError on any mismatch: a wrong adapter fails at registration."""
    if rank < 1:
        raise ValueError(f"adapter rank {rank} must be >= 1")
    if rank > bank_rank:
        raise ValueError(
            f"adapter rank {rank} exceeds the bank's adapter_rank="
            f"{bank_rank}; rebuild the engine with a larger rank")
    want = adapter_factor_shapes(cfg, rank)
    scale = float(alpha) / float(rank)
    out = {}
    for name in FACTOR_NAMES:
        a = np.asarray(factors[name], np.float32)
        if a.shape != want[name]:
            raise ValueError(
                f"adapter factor {name}: shape {a.shape} != expected "
                f"{want[name]} (model geometry or rank mismatch)")
        # B scales into a new array; A is copied, so that a caller's later
        # in-place edit never reaches the bank's reload source
        a = a * scale if name.startswith("b") else np.array(a)
        if rank < bank_rank:
            pad = bank_rank - rank
            widths = ([(0, 0), (0, 0), (0, pad)] if name.startswith("a")
                      else [(0, 0), (0, pad), (0, 0)])
            a = np.pad(a, widths)
        out[name] = np.ascontiguousarray(a)
    return out


def random_adapter_factors(cfg: ModelConfig, rank: int, seed: int,
                           scale: float = 0.05) -> Dict[str, np.ndarray]:
    """Random nonzero raw factors from a numpy generator seeded with
    `seed`, for benches, drills and tests (trained adapters come from
    training/lora.py, whose B factors start at zero)."""
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * scale).astype(np.float32)
            for name, shape in sorted(adapter_factor_shapes(cfg,
                                                            rank).items())}


class _HostAdapter:
    """A demoted adapter's folded factors in host RAM under a CRC32."""

    __slots__ = ("arrays", "crc", "nbytes")

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.arrays = arrays
        self.crc = _checksum(arrays)
        self.nbytes = int(sum(a.nbytes for a in arrays.values()))


class AdapterBank:
    """Up to `slots` LoRA adapters resident on `device` (plus the identity
    row 0), LRU-managed with checksummed host-RAM overflow. `stacked` is
    the LoraAdapter the engine passes to every forward."""

    def __init__(self, cfg: ModelConfig, slots: int, rank: int,
                 host_bytes: int = 0, metrics=None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        if slots < 1 or rank < 1:
            raise ValueError(f"an adapter bank needs slots >= 1 and rank "
                             f">= 1, got {slots} and {rank}")
        self.cfg = cfg
        self.capacity = slots + 1  # + the identity row
        self.rank = int(rank)
        self.dtype = dtype
        self.device = device
        self.metrics = metrics
        self.host_budget = int(host_bytes)
        shapes = adapter_factor_shapes(cfg, self.rank)
        self._stacked = LoraAdapter(**{
            n: torch.zeros((s[0], self.capacity) + s[1:], dtype=dtype,
                           device=device)
            for n, s in shapes.items()})
        self._ids: list = [("identity",)] + [None] * slots
        self._by_id: Dict[object, int] = {}
        self._pins = np.zeros(self.capacity, np.int64)
        # resident rows, oldest first
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # id -> ("path", str) | ("arrays", folded dict): the reload source
        # (an arrays-registered adapter keeps its folded host copy, so it
        # never demotes)
        self._sources: Dict[object, tuple] = {}
        self._host: "collections.OrderedDict[object, _HostAdapter]" = \
            collections.OrderedDict()
        self._host_used = 0
        # register(path=) validates by folding the file; the result serves
        # the first acquire instead of a second read
        self._warm: Dict[object, Dict[str, np.ndarray]] = {}
        # registration generation per id: (id, generation) is the prefix
        # cache's namespace, so KV of an earlier registration of the same
        # id never prefix-hits the new weights
        self._gen_counter = itertools.count(1)
        self._gen: Dict[object, int] = {}
        self._lock = threading.Lock()

    # ---- registry (readable from HTTP threads) -----------------------
    def known(self, adapter_id) -> bool:
        with self._lock:
            return adapter_id in self._sources

    def peek(self, adapter_id) -> int:
        """The router's locality signal: 2 device-resident, 1 registered
        (a host restore or disk load away), 0 unknown."""
        with self._lock:
            if adapter_id in self._by_id:
                return 2
            return 1 if adapter_id in self._sources else 0

    def ids(self) -> list:
        with self._lock:
            return list(self._sources)

    def active_count(self) -> int:
        """Device-resident non-identity adapters (the active_adapters
        gauge)."""
        with self._lock:
            return sum(1 for i in range(1, self.capacity)
                       if self._ids[i] is not None)

    def register(self, adapter_id, path: Optional[str] = None,
                 factors: Optional[Dict[str, np.ndarray]] = None,
                 rank: Optional[int] = None, alpha: float = 1.0):
        """Make `adapter_id` servable from a `.npz` `path` (rank and alpha
        ride in the file) or from raw `factors` with `rank`/`alpha`. The
        adapter is validated now; a re-registration unmaps the old row."""
        if adapter_id is None:
            raise ValueError("adapter_id must not be None")
        if (path is None) == (factors is None):
            raise ValueError("register: pass exactly one of path/factors")
        warm = None
        if path is not None:
            f, r, a, _ = load_adapter_npz(path)
            warm = fold_factors(f, r, a, self.cfg, self.rank)
            src = ("path", str(path))
        else:
            if rank is None:
                raise ValueError("register(factors=...) needs rank=")
            src = ("arrays", fold_factors(factors, int(rank), float(alpha),
                                          self.cfg, self.rank))
        with self._lock:
            self._sources[adapter_id] = src
            self._warm.pop(adapter_id, None)
            if warm is not None:
                self._warm[adapter_id] = warm
            self._gen[adapter_id] = next(self._gen_counter)
            self._invalidate_resident(adapter_id)
            self._host_drop(adapter_id)

    def deregister(self, adapter_id):
        """Forget an adapter: later requests 400; a pinned row keeps its
        content for the slots decoding under it, unmapped."""
        with self._lock:
            self._sources.pop(adapter_id, None)
            self._warm.pop(adapter_id, None)
            self._gen.pop(adapter_id, None)
            self._invalidate_resident(adapter_id)
            self._host_drop(adapter_id)

    def _invalidate_resident(self, adapter_id):
        """(lock held) Unmap `adapter_id`'s row: an unpinned row frees now;
        a pinned one becomes an anonymous stale row that recycles once its
        pins drain."""
        idx = self._by_id.pop(adapter_id, None)
        if idx is None:
            return
        if self._pins[idx] == 0:
            self._ids[idx] = None
            self._lru.pop(idx, None)
        else:
            self._ids[idx] = ("stale", adapter_id, next(self._gen_counter))

    def bump_generations(self) -> int:
        """The weight swap's sweep (engine `_swap_hygiene`): every
        registered adapter was trained against the old base, so its
        generation bumps (its prefix namespace changes, and a requeued
        stream pinned to the old generation fails typed at re-acquire),
        its row unmaps and its host copy drops. Sources stay registered:
        the next acquire reloads. Returns the number bumped."""
        with self._lock:
            ids = list(self._sources)
            for adapter_id in ids:
                self._gen[adapter_id] = next(self._gen_counter)
                self._invalidate_resident(adapter_id)
                self._host_drop(adapter_id)
            return len(ids)

    def namespace(self, adapter_id):
        """(id, generation) of the current registration, or None."""
        with self._lock:
            g = self._gen.get(adapter_id)
            return None if g is None else (adapter_id, g)

    # ---- device residency (engine thread) ----------------------------
    @property
    def stacked(self) -> LoraAdapter:
        return self._stacked

    def nbytes(self) -> int:
        return sum(f.numel() * f.element_size() for f in self._stacked)

    def acquire(self, adapter_id) -> int:
        """Resolve `adapter_id` to its row, loading it (host restore, else
        its source) if absent and evicting the LRU unpinned row under
        pressure, and pin it for the slot's lifetime. Raises
        UnknownAdapterError (-> 400) and AdapterBankFullError (requeue).

        The lock drops across the load (a multi-MB read, CRC and device
        write must not stall `health()` readers); a re-registration that
        raced it is caught by the generation re-check, and the load
        retries with the new source."""
        for _ in range(8):
            with self._lock:
                gen0 = self._gen.get(adapter_id)
                if adapter_id not in self._sources or gen0 is None:
                    raise UnknownAdapterError(
                        f"unknown adapter_id {adapter_id!r}: register it "
                        "before submitting requests against it")
                idx = self._by_id.get(adapter_id)
                if idx is not None:
                    self._pin(idx)
                    return idx
                idx, evicted_id = self._alloc_index()
            try:
                self._maybe_host_demote(idx, evicted_id)
                arrays = self._fetch_host(adapter_id)
                if arrays is None:
                    arrays = self._load_source(adapter_id)
                self._write(idx, arrays)
            except Exception:
                with self._lock:
                    self._ids[idx] = None  # the row returns unpublished
                raise
            with self._lock:
                if self._gen.get(adapter_id) != gen0:
                    self._ids[idx] = None
                    continue
                self._ids[idx] = adapter_id
                self._by_id[adapter_id] = idx
                self._count("adapter_loads")
                self._pin(idx)
                return idx
        raise RuntimeError(
            f"adapter {adapter_id!r} was re-registered faster than it "
            "could load, 8 times in a row; retry the request")

    def release(self, idx: int):
        """Unpin a row (slot finished, preempted or dropped)."""
        if idx <= 0:
            return
        with self._lock:
            self._pins[idx] = max(self._pins[idx] - 1, 0)

    def reset_pins(self):
        """Engine restart: every slotted request failed, so no pin
        survives (the rows' content does)."""
        with self._lock:
            self._pins[:] = 0

    # ---- internals ---------------------------------------------------
    def _pin(self, idx: int):
        self._pins[idx] += 1
        self._lru[idx] = None
        self._lru.move_to_end(idx)

    def _count(self, name: str, n: int = 1):
        if self.metrics is not None:
            self.metrics.count(name, n)

    def _alloc_index(self):
        """(lock held) A free row, else the LRU unpinned resident, unmapped
        now (its demotion runs outside the lock). Only the engine thread
        allocates, so the row stays free-looking until `acquire` publishes
        it. Returns (idx, evicted id or None)."""
        for i in range(1, self.capacity):
            if self._ids[i] is None:
                return i, None
        for i in list(self._lru):
            if self._pins[i] > 0 or self._ids[i] is None:
                continue
            old_id = self._ids[i]
            self._ids[i] = None
            self._by_id.pop(old_id, None)
            self._lru.pop(i, None)
            self._count("adapter_evictions")
            return i, old_id
        raise AdapterBankFullError(
            f"all {self.capacity - 1} adapter rows are pinned by running "
            "slots; retried when a slot frees")

    def _maybe_host_demote(self, idx: int, evicted_id):
        """Copy an evicted path-registered adapter's row to a checksummed
        host entry (an arrays-registered one keeps its folded source, and a
        stale or deregistered row must not come back)."""
        if evicted_id is None or self.host_budget <= 0:
            return
        kind, _ = self._sources.get(evicted_id, ("gone", None))
        if kind != "path":
            return
        # a copy: on a CPU bank .numpy() would alias the row the load
        # overwrites next
        arrays = {n: np.array(getattr(self._stacked, n)[:, idx].float()
                              .cpu().numpy())
                  for n in FACTOR_NAMES}
        ent = _HostAdapter(arrays)
        with self._lock:
            self._host_put(evicted_id, ent)

    def _host_put(self, adapter_id, ent: _HostAdapter):
        if ent.nbytes > self.host_budget:
            return
        self._host_drop(adapter_id)
        while self._host_used + ent.nbytes > self.host_budget and self._host:
            self._host_drop(next(iter(self._host)))
        self._host[adapter_id] = ent
        self._host_used += ent.nbytes

    def _host_drop(self, adapter_id):
        ent = self._host.pop(adapter_id, None)
        if ent is not None:
            self._host_used -= ent.nbytes

    def _fetch_host(self, adapter_id) -> Optional[Dict[str, np.ndarray]]:
        """The host copy after its CRC verifies; a corrupt copy is dropped
        and counted (`adapter_host_checksum_misses`), and the caller
        reloads from the source."""
        with self._lock:
            ent = self._host.get(adapter_id)
        if ent is None:
            return None
        ok = _checksum(ent.arrays) == ent.crc
        with self._lock:
            if not ok:
                if self._host.get(adapter_id) is ent:
                    self._host_drop(adapter_id)
                self._count("adapter_host_checksum_misses")
            else:
                if self._host.get(adapter_id) is ent:
                    self._host.move_to_end(adapter_id)
                self._count("adapter_host_hits")
        if not ok:
            print_rank_0(f"adapter bank: host copy of {adapter_id!r} failed "
                         "its checksum; reloading from source")
            return None
        return ent.arrays

    def _load_source(self, adapter_id) -> Dict[str, np.ndarray]:
        warm = self._warm.pop(adapter_id, None)
        if warm is not None:
            return warm
        entry = self._sources.get(adapter_id)
        if entry is None:
            raise UnknownAdapterError(
                f"adapter_id {adapter_id!r} was deregistered while loading")
        kind, src = entry
        if kind == "arrays":
            return src
        factors, rank, alpha, _ = load_adapter_npz(src)
        return fold_factors(factors, rank, alpha, self.cfg, self.rank)

    @torch.no_grad()
    def _write(self, idx: int, arrays: Dict[str, np.ndarray]):
        for n in FACTOR_NAMES:
            getattr(self._stacked, n)[:, idx] = torch.from_numpy(
                arrays[n]).to(self.device, self.dtype)
