"""Slot-based KV-cache pool for continuous batching
(megatron_tpu/serving/kv_pool.py).

Whole-region mode (block_size None): one pre-allocated cache
[layers, num_slots, cap, kv_heads, head_dim] with per-slot offsets
(`init_kv_caches(per_slot_offsets=True)`). A slot owns a contiguous
cap-token region; admission binds a request to a free slot, prefill writes
the prompt's KV into the region, and eviction returns the slot to the free
list with no copying: stale entries past a row's offset are invisible to
the causal mask and are overwritten write-before-read during decode.

A sliding-window model whose window W is below max_len gets a rolling pool
(`rolling`): each region holds exactly W positions in ring order
(generation.kv_region_cap), so the pool costs O(W) a slot for any stream
length. Its prefill caches share the ring layout (`make_prefill_caches`).

Block mode (block_size B dividing cap): the storage is a flat arena of
physical blocks [L, total_blocks, B, nkv, hd] plus a per-slot block map
[num_slots, cap / B] int32 (logical block -> physical block). With
`block_native_attn` the block kernel reads it in place; without, each
dispatch is bracketed: `resolve_view` gathers the contiguous
[L, S, cap, ...] slot-grid view through the map, the dot path runs on it,
and `scatter_view` writes it back (`slice_blocks` reads an explicit block
list as a batch-1 cache). A block size of cap or more means whole-region
blocks, which ARE the regions, except on a rolling pool, where one block a
slot stays a block pool. Physical blocks are refcounted; a row
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

Retention for the prefix cache (kv_pool.py SlotKVPool): a finished
request may be retained instead of freed. On a whole-region pool its slot
moves to an LRU of retained slots (`retain`), reclaimed lazily when `alloc`
runs out of free slots; the engine parks a retained row's decode position
at its final length, so the grid's idle writes land past every cloneable
prefix. On a block pool `retain_row` turns the row into a row-less
`RetainedPrefix` pinning only the blocks its tokens cover; the row and its
tail blocks free at once, and entries are evicted LRU-first under block
pressure (`_ensure_free_blocks`). `on_reclaim(key)` fires when retained KV
is about to be overwritten so the prefix index forgets it. A prefix hit on
a block pool aliases the shared blocks into the new row's map
(`alloc_row(alias=...)`, refcounted) and `insert_blocks` skips them
(`pfx_blocks`); a whole-region hit copies the region (`slice_slot`).
With the host KV tier (serving/host_tier.py) `on_evict_entry(entry)` fires
before an evicted entry's blocks are unreffed (never in `drop_retained`),
`gather_blocks_host` copies them to host numpy arrays and
`host_blocks_to_sub` brings them back as a batch-1 cache.

`slice_slot` and `slice_blocks` return copies, never views of the pool: a
parked preemption victim or a pending prefill's prefix must not see the
grid's later in-place writes.

`fit_num_slots` sizes `num_slots` to the card's free memory (the CLI
server's default).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.generation import (init_kv_caches,
                                                     kv_region_cap, kv_scales)
from megatron_tpu_torch.models.attention import BlockKVCache, KVCache
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import print_rank_0

# the cache tensors a pool copies: k/v, and an int8 pool's scales
_PARTS = ("k", "v", "k_scale", "v_scale")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host numpy array; bf16 as its int16 bits."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of `_to_host`: int16 bits back to bf16, bit for bit, on
    `device`."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device)


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


def slice_slot(pool: KVCache, slot: int, offset: int,
               length: Optional[int] = None) -> KVCache:
    """A copy of `slot`'s region (its first `length` positions, the whole
    region by default) as a batch-1 cache [L, 1, length, nkv, hd]
    positioned at `offset` (a host int): the read half of `clone_prefix`
    and a whole-region preemption park. Positions past `offset` are the
    source's continuation or garbage, which the causal mask never reads
    and appends overwrite."""
    n = pool.k.shape[2] if length is None else int(length)
    return KVCache(*(None if t is None else t[:, slot:slot + 1, :n].clone()
                     for t in (pool.k, pool.v)), int(offset),
                   *(None if t is None else t[:, slot:slot + 1, :n].clone()
                     for t in (pool.k_scale, pool.v_scale)))


def clone_prefix(pool: KVCache, src_slot: int, dst_slot: int,
                 plen: int) -> KVCache:
    """Copy `src_slot`'s region into `dst_slot` with its first `plen`
    tokens live, bit for bit: the prefix-hit primitive of a whole-region
    pool (the engine runs it split around the suffix forward). In place;
    returns `pool`."""
    return insert_prefill(pool, slice_slot(pool, src_slot, plen), dst_slot,
                          plen)


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


def resolve_view(bkv: BlockKV) -> KVCache:
    """Gather the arena through the block map into the contiguous
    [L, S, cap, nkv, hd] slot-grid view (with the per-slot offsets) the
    dot path consumes: the read half of the bracket. Idle rows see copies
    of the TRASH block."""
    S, nb = bkv.map.shape
    flat = bkv.map.reshape(-1).long()
    a = bkv.arena

    def g(x):
        y = x.index_select(1, flat)  # [L, S*nb, B, ...]
        return y.reshape(x.shape[0], S, nb * x.shape[2], *x.shape[3:])

    return KVCache(g(a.k), g(a.v), a.offset,
                   *(None if t is None else g(t)
                     for t in (a.k_scale, a.v_scale)))


def scatter_view(bkv: BlockKV, view: KVCache) -> BlockKV:
    """Write an updated contiguous view back through the block map, in
    place: the write half of the bracket. A live row's blocks are its own;
    the map entries of idle rows all name the TRASH block, which receives
    one of their (garbage) copies and is never read."""
    S, nb = bkv.map.shape
    flat = bkv.map.reshape(-1).long()
    a = bkv.arena
    for name in _PARTS:
        dst = getattr(a, name)
        if dst is not None:
            src = getattr(view, name)
            dst[:, flat] = src.reshape(src.shape[0], S * nb, dst.shape[2],
                                       *src.shape[3:]).to(dst.dtype)
    a.offset = view.offset
    return bkv


def slice_blocks(bkv: BlockKV, blocks, offset: int) -> KVCache:
    """Gather an explicit physical-block list (nb blocks) into a batch-1
    cache [L, 1, nb * B, nkv, hd] positioned at `offset` (a host int): a
    row's, or a row-less retained prefix's, KV as one sequence. The gather
    copies."""
    a = bkv.arena
    idx = torch.as_tensor(blocks, dtype=torch.long, device=a.k.device)

    def g(x):
        y = x.index_select(1, idx)  # [L, nb, B, ...]
        return y.reshape(x.shape[0], 1, -1, *x.shape[3:])

    return KVCache(g(a.k), g(a.v), int(offset),
                   *(None if t is None else g(t)
                     for t in (a.k_scale, a.v_scale)))


def insert_blocks(bkv: BlockKV, sub: KVCache, slot: int, plen: int,
                  pfx_blocks: int = 0) -> BlockKV:
    """Land a batch-1 cache [L, 1, n, nkv, hd] (with its scales in an int8
    pool) in `slot`'s mapped blocks: position p goes to block
    map[slot, p // B], row p % B, for every pfx_blocks * B <= p < n, and
    the row's offset becomes `plen`. The first `pfx_blocks` blocks are
    aliased shared-prefix blocks whose content the arena already holds for
    every holder (the copy-on-write boundary), so they are skipped; 0
    writes every block (a miss, a preemption resume). In place; returns
    `bkv`."""
    a = bkv.arena
    n = sub.k.shape[2]
    B = a.k.shape[2]
    lo = int(pfx_blocks) * B
    pos = torch.arange(lo, n, device=a.k.device)
    phys = bkv.map[slot, pos // B].long()
    for name in _PARTS:
        dst = getattr(a, name)
        if dst is not None:
            dst[:, phys, pos % B] = getattr(sub, name)[:, 0, lo:].to(
                dst.dtype)
    a.offset[slot] = plen
    return bkv


class RetainedPrefix:
    """A finished sequence's KV pinned at block granularity: the physical
    blocks covering its first `length` tokens (all ring blocks on a rolling
    pool, whose whole window is live) and its tokens. Holds no grid row;
    `namespace` rides into the prefix index."""

    __slots__ = ("key", "blocks", "length", "tokens", "namespace")

    def __init__(self, key, blocks: List[int], length: int,
                 tokens: List[int], namespace=None):
        self.key = key
        self.blocks = blocks
        self.length = length
        self.tokens = tokens
        self.namespace = namespace


class SlotKVPool:
    """Pre-allocated slot-grid cache + host-side free bookkeeping.

    `caches` is the live device state (a KVCache with per-slot offsets, or
    a BlockKV in block mode), updated in place by the engine's forwards.
    Slot, block and retention accounting runs on the engine thread only.

    Whole-region mode: `retain` moves a finished slot to the retained LRU
    instead of the free list, and `alloc` reclaims free slots first, then
    retained ones oldest first (`exclude` protects a prefix hit's source in
    the same admission). Block mode: rows allocate their cap / B blocks
    (`alloc_row`, optionally aliasing shared prefix blocks), release them
    on eviction, and `retain_row` converts a finished row into a row-less
    RetainedPrefix. `retained_limit` caps the retained slots or entries;
    `on_reclaim(key)` fires with a slot or entry key when retained KV is
    reclaimed."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 dtype=torch.bfloat16, block_size: Optional[int] = None, *,
                 retained_limit: Optional[int] = None, device=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else None
        self.cap = kv_region_cap(cfg, max_len)  # a rolling pool holds W
        self.rolling = (cfg.sliding_window is not None
                        and self.cap == cfg.sliding_window
                        and self.cap < max_len)
        if block_size is not None and block_size >= self.cap:
            # whole-region blocks ARE the regions, except on a rolling
            # pool, where one block a slot is still a block pool (and
            # what lets a ring retain at all)
            block_size = self.cap if self.rolling else None
        self.block_size = block_size
        self._free: collections.deque = collections.deque(range(num_slots))
        # retained state, oldest first (touch moves to the end, reclaim
        # pops from the front): slots in whole-region mode, RetainedPrefix
        # entries by key in block mode
        self._retained: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.retained_limit = retained_limit
        self.on_reclaim: Optional[Callable] = None
        # block mode: called with a dying RetainedPrefix before its blocks
        # are unreffed (the host KV tier's demotion)
        self.on_evict_entry: Optional[Callable] = None
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
        self._ret_ids = itertools.count()
        # free_count memo: the reclaimable-block walk is O(retained
        # blocks) and the engine asks every iteration
        self._acct_dirty = True
        self._free_count_cache = 0

    @property
    def blocks_enabled(self) -> bool:
        return self.block_size is not None

    def make_prefill_caches(self, batch: int, length: int) -> KVCache:
        """A fresh request-local cache in the pool's dtype for the prefill
        pass before `insert_prefill` / `insert_blocks`: [L, batch, length,
        nkv, hd] for the padded prompt `length` (the region beyond it is
        never read before decode writes it, so a cache of the region's
        full capacity would only cost memory), or on a rolling pool the
        pool's own ring of W positions, so the prefill takes the same
        rolling path and lands in ring order."""
        return init_kv_caches(self.cfg, batch,
                              self.max_len if self.rolling else length,
                              dtype=self.dtype, device=self.device)

    def live_blocks(self, length: int) -> int:
        """Blocks a sequence of `length` tokens covers: all ring blocks on
        a rolling pool (its whole window is live)."""
        if self.rolling:
            return self.blocks_per_slot
        return min(-(-int(length) // self.block_size), self.blocks_per_slot)

    # ---- whole-region slot bookkeeping (engine thread only) ----------
    def alloc(self, exclude=()) -> Optional[int]:
        """A slot: free ones first (FIFO in release order), then the
        least recently used retained one outside `exclude` (`on_reclaim`
        fires for it). None when nothing is allocatable."""
        if self.blocks_enabled:
            raise RuntimeError("block pools allocate with alloc_row")
        if self._free:
            return self._free.popleft()
        victim = next((s for s in self._retained if s not in exclude), None)
        if victim is None:
            return None
        del self._retained[victim]
        self._reclaim(victim)
        return victim

    def retain(self, slot: int):
        """Keep a finished slot's KV for prefix reuse: the slot moves to
        the retained LRU's recent end; past `retained_limit` the oldest
        retained slot is reclaimed onto the free list."""
        if self.blocks_enabled:
            raise RuntimeError("block pools retain with retain_row")
        slot = int(slot)
        if slot in self._free or slot in self._retained:
            raise RuntimeError(f"retain of non-busy slot {slot}")
        self._retained[slot] = None
        if (self.retained_limit is not None
                and len(self._retained) > max(self.retained_limit, 0)):
            old, _ = self._retained.popitem(last=False)
            self._reclaim(old)
            self._free.append(old)

    def touch(self, slot: int):
        """A prefix hit read `slot`'s KV: refresh its LRU position (no-op
        for running slots)."""
        if slot in self._retained:
            self._retained.move_to_end(slot)

    def _reclaim(self, key):
        if self.on_reclaim is not None:
            self.on_reclaim(key)

    def release(self, slot: int):
        """Free a slot without retaining it (in block mode:
        `release_row`)."""
        if self.blocks_enabled:
            self.release_row(slot)
            return
        slot = int(slot)
        if slot in self._free:
            raise RuntimeError(f"double free of slot {slot}")
        self._retained.pop(slot, None)
        self._free.append(slot)

    # ---- block-mode accounting (engine thread only) ------------------
    def _sync_map(self):
        # torch.tensor copies: on the CPU torch.from_numpy would share the
        # host buffer, and a later host edit would change the map under a
        # step already dispatched
        self.caches = BlockKV(self.caches.arena,
                              torch.tensor(self._map, device=self.device))

    def _unref(self, block: int):
        self._acct_dirty = True
        self._rc[block] -= 1
        if self._rc[block] < 0:
            raise RuntimeError(f"refcount underflow on block {block}")
        if self._rc[block] == 0:
            self._free_blocks.append(block)

    def _evict_retained(self):
        key, ent = self._retained.popitem(last=False)
        if self.on_evict_entry is not None:
            # demotion before the unref: the host tier copies the blocks
            # while the entry still pins them. A failed demotion loses
            # only the host copy; eviction proceeds
            try:
                self.on_evict_entry(ent)
            except Exception as e:  # noqa: BLE001 — the tier is best-effort
                print_rank_0(
                    f"kv_pool: on_evict_entry failed for {key}: {e!r}")
        for b in ent.blocks:
            self._unref(b)
        self._reclaim(key)

    def _ensure_free_blocks(self, n: int) -> bool:
        while len(self._free_blocks) < n and self._retained:
            self._evict_retained()
        return len(self._free_blocks) >= n

    def map_row(self, slot: int) -> List[int]:
        return [int(b) for b in self._map[slot]]

    def alloc_row(self, alias: Sequence[int] = (), install: bool = True,
                  sync: bool = True) -> Optional[Tuple[int, List[int]]]:
        """Allocate a grid row plus its cap / B physical blocks. `alias`
        (a prefix of shared blocks: a running row's or a RetainedPrefix's)
        is referenced in place; only the rest come fresh from the free
        pool, evicting retained entries LRU-first under pressure (the refs
        taken here keep aliased blocks alive). Returns (slot, blocks) or
        None. With `install=False` the map row stays on TRASH until the
        caller's `install_row` at activation, so the grid's idle writes
        never reach the blocks before the prefill lands. `sync=False`
        defers the device-map upload so a batched caller pays one."""
        if not self.blocks_enabled:
            raise RuntimeError("whole-region pools allocate with alloc")
        if not self._free:
            return None
        alias = list(alias)
        if len(alias) > self.blocks_per_slot:
            raise ValueError(f"{len(alias)} aliased blocks exceed a row's "
                             f"{self.blocks_per_slot}")
        self._acct_dirty = True
        for b in alias:
            self._rc[b] += 1  # refs first: eviction-safe
        need = self.blocks_per_slot - len(alias)
        if not self._ensure_free_blocks(need):
            for b in alias:
                self._unref(b)
            return None
        fresh = [self._free_blocks.popleft() for _ in range(need)]
        for b in fresh:
            self._rc[b] = 1
        slot = self._free.popleft()
        blocks = alias + fresh
        if install:
            self.install_row(slot, blocks, sync=sync)
        return slot, blocks

    def install_row(self, slot: int, blocks: Sequence[int],
                    sync: bool = True):
        """Point `slot`'s map at its blocks (refs already held)."""
        self._map[slot] = blocks
        if sync:
            self._sync_map()

    def drop_blocks(self, blocks: Sequence[int]):
        """Unref blocks held outside a map row (an aborted pending prefill
        whose row was never installed)."""
        for b in blocks:
            self._unref(int(b))

    def release_row(self, slot: int):
        """Free a grid row: unref its mapped blocks, park the map on
        TRASH, return the row."""
        slot = int(slot)
        if slot in self._free:
            raise RuntimeError(f"double free of slot {slot}")
        self._acct_dirty = True
        for b in self._map[slot]:
            if b != self.TRASH:
                self._unref(int(b))
        self._map[slot] = self.TRASH
        self._sync_map()
        self._free.append(slot)

    def retain_row(self, slot: int, length: int, tokens: List[int],
                   namespace=None):
        """Convert a finished row into a row-less RetainedPrefix pinning
        the blocks that cover `length` tokens; the tail blocks and the row
        free at once. Returns the entry's key (for the prefix index), or
        None when `retained_limit` is 0. Past the limit the oldest entry
        is evicted (`on_reclaim` fires with its key)."""
        if not self.blocks_enabled:
            raise RuntimeError("whole-region pools retain with retain")
        if self.retained_limit is not None and self.retained_limit <= 0:
            self.release_row(slot)
            return None
        blocks = [int(b) for b in self._map[slot][:self.live_blocks(length)]]
        if self.TRASH in blocks:
            raise RuntimeError(f"retain of an uninstalled row {slot}")
        key = ("ret", next(self._ret_ids))
        self._acct_dirty = True
        for b in blocks:
            self._rc[b] += 1  # the entry's refs, before the row drops its own
        self.release_row(slot)
        self._retained[key] = RetainedPrefix(key, blocks, int(length),
                                             list(tokens),
                                             namespace=namespace)
        if (self.retained_limit is not None
                and len(self._retained) > self.retained_limit):
            self._evict_retained()
        return key

    def entry(self, key) -> Optional[RetainedPrefix]:
        return self._retained.get(key)

    def touch_key(self, key):
        if key in self._retained:
            self._retained.move_to_end(key)

    def gather_blocks_host(self, blocks: Sequence[int]
                           ) -> Dict[str, np.ndarray]:
        """Copy an explicit physical-block list's arena content to host
        numpy arrays: the host tier's demotion read (engine thread, during
        a retained entry's eviction, while the entry still pins the
        blocks). Returns {"k", "v"[, "k_scale", "v_scale"]} shaped
        [L, nb, B, nkv, *]; a bf16 arena's blocks come as their int16 bit
        patterns (numpy has no bfloat16)."""
        if not self.blocks_enabled:
            raise RuntimeError("gather_blocks_host needs a block pool")
        a = self.caches.arena
        idx = torch.as_tensor(list(blocks), dtype=torch.long,
                              device=a.k.device)
        return {name: _to_host(getattr(a, name).index_select(1, idx))
                for name in _PARTS if getattr(a, name) is not None}

    def host_blocks_to_sub(self, arrays: Dict[str, np.ndarray], plen: int,
                           pad_to_cap: bool = True) -> KVCache:
        """Assemble host block arrays (`gather_blocks_host`'s layout) into
        a batch-1 cache in the pool's dtype, positioned at `plen`: the host
        tier's restore, which the engine hands to the normal suffix-prefill
        and insert path. Only the live blocks' bytes are uploaded; the
        positions past them are zeros built on the device (scales 1.0),
        which sit at or after the offset, where appends overwrite them
        before any read. `pad_to_cap=False` returns the [L, 1, nb * B, ...]
        layout of the live blocks alone."""
        if not self.blocks_enabled:
            raise RuntimeError("host_blocks_to_sub needs a block pool")
        L, nb, B = arrays["k"].shape[:3]
        n = self.cap if pad_to_cap else nb * B
        device = self.caches.arena.k.device

        def fill(name, fill_value, dtype):
            live = _from_host(arrays[name], dtype, device)
            live = live.reshape(L, 1, nb * B, *live.shape[3:])
            if not pad_to_cap:
                return live
            full = torch.full((L, 1, n) + tuple(live.shape[3:]), fill_value,
                              dtype=dtype, device=live.device)
            full[:, :, :nb * B] = live
            return full

        quant = "k_scale" in arrays
        return KVCache(fill("k", 0, self.dtype), fill("v", 0, self.dtype),
                       int(plen),
                       *((fill("k_scale", 1.0, torch.float32),
                          fill("v_scale", 1.0, torch.float32))
                         if quant else (None, None)))

    def drop_retained(self) -> int:
        """Reclaim every retained entry or slot (`on_reclaim` fires for
        each; `on_evict_entry` does not: a full drop invalidates the
        retained KV, so nothing demotes). Returns the count."""
        n = len(self._retained)
        if self.blocks_enabled:
            hook, self.on_evict_entry = self.on_evict_entry, None
            try:
                while self._retained:
                    self._evict_retained()
            finally:
                self.on_evict_entry = hook
        else:
            while self._retained:
                slot, _ = self._retained.popitem(last=False)
                self._reclaim(slot)
                self._free.append(slot)
        return n

    # ---- capacity / introspection ------------------------------------
    def accounting(self) -> dict:
        """A copy of the accounting state (free rows, retained entries,
        and in block mode refcounts, map, free blocks): the conservation
        laws refcount == row refs + retained refs + pending refs and
        free + used == total are checked against it. Engine-thread state:
        read it with the engine idle."""
        out = {
            "blocks_enabled": self.blocks_enabled,
            "num_slots": self.num_slots,
            "free_rows": [int(s) for s in self._free],
            "retained": {
                key: {"blocks": (list(ent.blocks)
                                 if self.blocks_enabled else None),
                      "length": (ent.length if self.blocks_enabled
                                 else None)}
                for key, ent in self._retained.items()},
            "rolling": self.rolling,
        }
        if self.blocks_enabled:
            out.update(rc=self._rc.copy(), map=self._map.copy(),
                       free_blocks=[int(b) for b in self._free_blocks],
                       total_blocks=self.total_blocks, trash=self.TRASH,
                       blocks_per_slot=self.blocks_per_slot)
        return out

    def free_count(self) -> int:
        """Allocatable slots. Whole-region: free plus retained. Block
        mode: min(free rows, the fresh-row admissions the free plus
        reclaimable blocks back). A block is reclaimable when every one of
        its refs comes from retained entries; counting only rc == 1 blocks
        would starve admission once retained entries alias each other's
        blocks (multi-turn chains)."""
        if not self.blocks_enabled:
            return len(self._free) + len(self._retained)
        if not self._acct_dirty:
            return self._free_count_cache
        retained_refs: collections.Counter = collections.Counter()
        for ent in self._retained.values():
            for b in ent.blocks:
                retained_refs[b] += 1
        avail = len(self._free_blocks) + sum(
            1 for b, n in retained_refs.items() if self._rc[b] == n)
        self._free_count_cache = min(len(self._free),
                                     avail // self.blocks_per_slot)
        self._acct_dirty = False
        return self._free_count_cache

    def free_rows(self) -> int:
        """Free grid rows: a race-free read for `health()` from HTTP
        threads (`free_count`'s memo is engine-thread only)."""
        return len(self._free)

    def retained_count(self) -> int:
        return len(self._retained)

    def shared_block_count(self) -> int:
        """Physical blocks held by more than one owner (row maps, retained
        entries, pending prefills): 0 on a whole-region pool."""
        if not self.blocks_enabled:
            return 0
        return int(np.sum(self._rc[:self.TRASH] > 1))

    def block_refcount(self, block: int) -> int:
        return int(self._rc[int(block)])

    def nbytes(self) -> int:
        """Bytes of the pool's k/v (and int8 scales)."""
        c = self.caches.arena if self.blocks_enabled else self.caches
        return sum(t.numel() * t.element_size()
                   for t in (getattr(c, name) for name in _PARTS)
                   if t is not None)

    def view_nbytes(self) -> int:
        """Bytes of one contiguous [L, S, cap, ...] view (k + v and int8
        scales): what one `resolve_view` gather or one `scatter_view`
        write-back moves."""
        return self.num_slots * self.cap * self.bytes_per_token()

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
        use and pinned by retained entries (whole-region pools count
        regions), and reserved-minus-live bytes, the fragmentation the
        block pool shrinks. An aliased block counts once, at its largest
        coverage."""
        lengths = np.minimum(np.asarray(lengths), self.cap)
        if self.blocks_enabled:
            used = int(self.total_blocks - 1 - len(self._free_blocks))
            B = self.block_size
            cover = np.zeros(self.total_blocks, np.int64)

            def _cover(blocks, ntok):
                for i, b in enumerate(blocks):
                    cover[b] = max(cover[b], min(max(ntok - i * B, 0), B))

            for slot in range(self.num_slots):
                _cover(self._map[slot], int(lengths[slot]))
            pinned = set()
            for e in self._retained.values():
                _cover(e.blocks, min(e.length, self.cap))
                pinned.update(e.blocks)
            retained = len(pinned)
            cover[self.TRASH] = 0
            live = int(cover.sum())
            reserved = used * B
        else:
            used = self.num_slots - len(self._free)
            retained = len(self._retained)
            live = int(lengths.sum())
            reserved = used * self.cap
        return (used, retained,
                max(reserved - live, 0) * self.bytes_per_token())


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
