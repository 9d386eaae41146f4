"""Slot-based KV-cache pool for continuous batching
(megatron_tpu/serving/kv_pool.py).

Whole-region mode (block_size None): one pre-allocated cache
[layers, num_slots, cap, kv_heads, head_dim] with per-slot offsets
(`init_kv_caches(per_slot_offsets=True)`). A slot owns a contiguous
cap-token region; admission binds a request to a free slot, prefill writes
the prompt's KV into the region, and eviction returns the slot to the free
list with no copying: stale entries past a row's offset are invisible to
the causal mask and are overwritten write-before-read during decode.

Block mode (block_size B dividing cap): the storage is a flat arena of
physical blocks [L, total_blocks, B, nkv, hd] plus a per-slot block map
[num_slots, cap / B] int32 (logical block -> physical block), read in place
by the block-native attention kernel. Physical blocks are refcounted; a row
allocates its cap / B blocks at admission and releases them at eviction.
The last physical block is the shared TRASH block: every map entry of an
idle row points at it, so the grid's garbage writes for inactive rows land
where nothing is ever read. The host map is the truth; `_sync_map` uploads
a copy (never a view of the host buffer, which later host edits would
change under a step in flight).

An int8 pool (dtype torch.int8) stores k/v int8 with fp32 scales per
(token, head) beside them, in either mode; the scales start at 1.0, never
0, so a garbage read past a row's length stays finite, and the byte
accounting counts them.

Updates are in place on the pool's tensors (the reference replaces its
arrays functionally). The prefill cache a request is prefilled into is
sized to its padded prompt, not to the region: `insert_prefill` /
`insert_blocks` write the positions it covers, and under write-before-read
nothing past a row's length is read before decode writes it.

Retention for the prefix cache (`retain`, `retain_row`, `RetainedPrefix`,
`on_reclaim`) raises NotImplementedError: it comes with the prefix-cache
slice. So does the bracketed block mode (`resolve_view`/`scatter_view`).

`fit_num_slots` sizes `num_slots` to the card's free memory (the CLI
server's default).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.generation import (init_kv_caches,
                                                     kv_region_cap, kv_scales)
from megatron_tpu_torch.models.attention import BlockKVCache, KVCache
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

_RETENTION = ("prefix-cache retention is ported with the prefix cache in a "
              "later slice (ROADMAP Queue 1 item 6)")


# the cache tensors a pool copies: k/v, and an int8 pool's scales
_PARTS = ("k", "v", "k_scale", "v_scale")


def insert_prefill(pool: KVCache, prefill: KVCache, slot: int,
                   plen: int) -> KVCache:
    """Write a batch-1 prefill cache [L, 1, n, nkv, hd] (with its scales in
    an int8 pool) into the first n positions of `slot`'s region and set the
    row's offset to `plen`, the true prompt length (bucket padding past it
    is garbage that decode overwrites before reading). In place; returns
    `pool`."""
    n = prefill.k.shape[2]
    for name in _PARTS:
        dst = getattr(pool, name)
        if dst is not None:
            dst[:, slot, :n] = getattr(prefill, name)[:, 0].to(dst.dtype)
    pool.offset[slot] = plen
    return pool


@dataclasses.dataclass
class BlockKV:
    """Device state of a block-granular pool: `arena` holds k/v as
    [L, total_blocks, B, nkv, hd] (an int8 arena its scales [..., 1]) and
    the per-slot offsets [S]; `map` is the [S, cap / B] int32 block table
    on the device."""
    arena: KVCache
    map: torch.Tensor


def block_native_cache(bkv: BlockKV) -> BlockKVCache:
    """View a BlockKV as the model-facing BlockKVCache without moving any
    data; the one [S, nb] map serves every layer."""
    a = bkv.arena
    return BlockKVCache(k=a.k, v=a.v, offset=a.offset, map=bkv.map,
                        k_scale=a.k_scale, v_scale=a.v_scale)


def pack_block_native(cache: BlockKVCache, map2d: torch.Tensor) -> BlockKV:
    """Inverse of `block_native_cache`: the forward's (updated in place)
    arena as the pool's BlockKV, with the pool's own map."""
    return BlockKV(arena=KVCache(cache.k, cache.v, cache.offset,
                                 cache.k_scale, cache.v_scale), map=map2d)


def insert_blocks(bkv: BlockKV, sub: KVCache, slot: int,
                  plen: int) -> BlockKV:
    """Land a batch-1 cache [L, 1, n, nkv, hd] (with its scales in an int8
    pool) in `slot`'s mapped blocks: position p goes to block
    map[slot, p // B], row p % B, for every p < n (the blocks covering the
    padded prompt), and the row's offset becomes `plen`. (Skipping aliased
    shared-prefix blocks comes with the prefix cache.) In place; returns
    `bkv`."""
    a = bkv.arena
    n = sub.k.shape[2]
    B = a.k.shape[2]
    pos = torch.arange(n, device=a.k.device)
    phys = bkv.map[slot, pos // B].long()
    for name in _PARTS:
        dst = getattr(a, name)
        if dst is not None:
            dst[:, phys, pos % B] = getattr(sub, name)[:, 0].to(dst.dtype)
    a.offset[slot] = plen
    return bkv


class RetainedPrefix:
    """A finished sequence's KV pinned at block granularity: comes with the
    prefix cache."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_RETENTION)


class SlotKVPool:
    """Pre-allocated slot-grid cache + host-side free bookkeeping.

    `caches` is the live device state (a KVCache with per-slot offsets, or
    a BlockKV in block mode), updated in place by the engine's forwards.
    Slot and block accounting runs on the engine thread only."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 dtype=torch.bfloat16, block_size: Optional[int] = None, *,
                 device=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else None
        self.cap = max_len
        if block_size is not None and block_size >= self.cap:
            block_size = None  # whole-region blocks ARE the regions
        self.block_size = block_size
        self._free: collections.deque = collections.deque(range(num_slots))
        if block_size is None:
            self.caches = init_kv_caches(cfg, num_slots, max_len,
                                         dtype=dtype, per_slot_offsets=True,
                                         device=device)
            return
        if self.cap % block_size:
            raise ValueError(f"kv block_size={block_size} must divide the "
                             f"region capacity ({self.cap})")
        self.blocks_per_slot = self.cap // block_size
        # one block set per slot plus the shared TRASH block (last index)
        self.total_blocks = num_slots * self.blocks_per_slot + 1
        self.TRASH = self.total_blocks - 1
        shape = (cfg.num_layers, self.total_blocks, block_size,
                 cfg.num_kv_heads, cfg.kv_channels)
        arena = KVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(num_slots, dtype=torch.int32,
                                    device=device),
                        *kv_scales(shape, dtype, device))
        self._map = np.full((num_slots, self.blocks_per_slot), self.TRASH,
                            np.int32)
        self.caches = BlockKV(arena=arena,
                              map=torch.tensor(self._map, device=device))
        self._rc = np.zeros(self.total_blocks, np.int64)
        self._rc[self.TRASH] = 1 << 60  # never freed
        self._free_blocks: collections.deque = collections.deque(
            range(self.total_blocks - 1))

    @property
    def blocks_enabled(self) -> bool:
        return self.block_size is not None

    def make_prefill_caches(self, batch: int, length: int) -> KVCache:
        """A fresh request-local cache [L, batch, length, nkv, hd] in the
        pool's dtype for the prefill pass before `insert_prefill` /
        `insert_blocks`. `length` is the padded prompt: the region beyond
        it is never read before decode writes it, so a cache of the
        region's full capacity would only cost memory."""
        return init_kv_caches(self.cfg, batch, length, dtype=self.dtype,
                              device=self.device)

    # ---- retention: the prefix-cache slice -----------------------------
    @property
    def on_reclaim(self):
        return None

    @on_reclaim.setter
    def on_reclaim(self, fn):
        raise NotImplementedError(_RETENTION)

    def retain(self, slot: int):
        raise NotImplementedError(_RETENTION)

    def retain_row(self, slot: int, length: int, tokens: List[int],
                   namespace=None):
        raise NotImplementedError(_RETENTION)

    # ---- whole-region slot bookkeeping (engine thread only) ----------
    def alloc(self) -> Optional[int]:
        """A free slot (FIFO in release order), or None."""
        if self.blocks_enabled:
            raise RuntimeError("block pools allocate with alloc_row")
        return self._free.popleft() if self._free else None

    def release(self, slot: int):
        """Free a slot (in block mode: `release_row`)."""
        if self.blocks_enabled:
            self.release_row(slot)
            return
        slot = int(slot)
        if slot in self._free:
            raise RuntimeError(f"double free of slot {slot}")
        self._free.append(slot)

    # ---- block-mode accounting (engine thread only) ------------------
    def _sync_map(self):
        # torch.tensor copies: on the CPU torch.from_numpy would share the
        # host buffer, and a later host edit would change the map under a
        # step already dispatched
        self.caches = BlockKV(self.caches.arena,
                              torch.tensor(self._map, device=self.device))

    def _unref(self, block: int):
        self._rc[block] -= 1
        if self._rc[block] < 0:
            raise RuntimeError(f"refcount underflow on block {block}")
        if self._rc[block] == 0:
            self._free_blocks.append(block)

    def map_row(self, slot: int) -> List[int]:
        return [int(b) for b in self._map[slot]]

    def alloc_row(self, sync: bool = True
                  ) -> Optional[Tuple[int, List[int]]]:
        """Allocate a grid row plus its cap / B physical blocks from the
        free pool and install them in the row's map. Returns (slot, blocks)
        or None. `sync=False` defers the device-map upload so a batched
        caller pays one upload. (Aliasing shared prefix blocks comes with
        the prefix cache.)"""
        if not self.blocks_enabled:
            raise RuntimeError("whole-region pools allocate with alloc")
        need = self.blocks_per_slot
        if not self._free or len(self._free_blocks) < need:
            return None
        blocks = [self._free_blocks.popleft() for _ in range(need)]
        for b in blocks:
            self._rc[b] = 1
        slot = self._free.popleft()
        self.install_row(slot, blocks, sync=sync)
        return slot, blocks

    def install_row(self, slot: int, blocks: Sequence[int],
                    sync: bool = True):
        """Point `slot`'s map at its blocks (refs already held)."""
        self._map[slot] = blocks
        if sync:
            self._sync_map()

    def release_row(self, slot: int):
        """Free a grid row: unref its mapped blocks, park the map on
        TRASH, return the row."""
        slot = int(slot)
        if slot in self._free:
            raise RuntimeError(f"double free of slot {slot}")
        for b in self._map[slot]:
            if b != self.TRASH:
                self._unref(int(b))
        self._map[slot] = self.TRASH
        self._sync_map()
        self._free.append(slot)

    # ---- capacity / introspection ------------------------------------
    def free_count(self) -> int:
        """Allocatable slots: free rows, and in block mode no more than the
        free blocks can back."""
        if not self.blocks_enabled:
            return len(self._free)
        return min(len(self._free),
                   len(self._free_blocks) // self.blocks_per_slot)

    def free_rows(self) -> int:
        return len(self._free)

    def nbytes(self) -> int:
        """Bytes of the pool's k/v (and int8 scales)."""
        c = self.caches.arena if self.blocks_enabled else self.caches
        return sum(t.numel() * t.element_size()
                   for t in (getattr(c, name) for name in _PARTS)
                   if t is not None)

    def bytes_per_token(self) -> int:
        """k + v (and int8 scale) bytes one cached token costs across
        layers."""
        heads = 2 * self.cfg.num_layers * self.cfg.num_kv_heads
        n = heads * self.cfg.kv_channels * self.dtype.itemsize
        if self.dtype == torch.int8:
            n += heads * 4  # fp32 scales
        return n

    def kv_gauges(self, lengths) -> Tuple[int, int, int]:
        """(kv_blocks_used, kv_blocks_retained, kv_bytes_wasted): blocks in
        use (whole-region pools count regions), retained (0 until the
        prefix cache), and reserved-minus-live bytes, the fragmentation the
        block pool shrinks."""
        lengths = np.minimum(np.asarray(lengths), self.cap)
        if self.blocks_enabled:
            used = int(self.total_blocks - 1 - len(self._free_blocks))
            B = self.block_size
            cover = np.zeros(self.total_blocks, np.int64)
            for slot in range(self.num_slots):
                n = int(lengths[slot])
                for i, b in enumerate(self._map[slot]):
                    cover[b] = max(cover[b], min(max(n - i * B, 0), B))
            cover[self.TRASH] = 0
            live = int(cover.sum())
            reserved = used * B
        else:
            used = self.num_slots - len(self._free)
            live = int(lengths.sum())
            reserved = used * self.cap
        return used, 0, max(reserved - live, 0) * self.bytes_per_token()


def slot_nbytes(cfg: ModelConfig, max_len: int, dtype=torch.bfloat16,
                block_size: Optional[int] = None) -> int:
    """Bytes one slot's cache region occupies (k + v, and an int8 pool's
    fp32 scales), without allocating. The capacity comes from
    `generation.kv_region_cap`, the helper `init_kv_caches` allocates
    from; `block_size` rounds the region up to whole blocks."""
    cap = kv_region_cap(cfg, max_len)
    if block_size is not None and block_size < cap:
        cap = -(-cap // block_size) * block_size
    elems = cfg.num_layers * cap * cfg.num_kv_heads * cfg.kv_channels
    n = 2 * elems * dtype.itemsize
    if dtype == torch.int8:
        n += 2 * (elems // cfg.kv_channels) * 4  # fp32 scales
    return n


def fit_num_slots(cfg: ModelConfig, max_len: int, dtype=torch.bfloat16,
                  requested: int = 8, headroom: float = 0.8,
                  block_size: Optional[int] = None,
                  device: DeviceLike = None) -> int:
    """Clamp `requested` slots to what the card's free memory holds once
    the weights are resident: the free bytes CUDA reports plus what PyTorch's
    allocator holds unused, times `headroom`, over `slot_nbytes`. On the
    CPU, which has no such budget, `requested` is returned unchanged."""
    device = resolve_device(device)
    if device.type != "cuda":
        return requested
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    fit = int(free * headroom) // max(
        slot_nbytes(cfg, max_len, dtype, block_size), 1)
    return max(1, min(requested, fit))
