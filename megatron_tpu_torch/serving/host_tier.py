"""Host-RAM tier for retained prefix KV (megatron_tpu/serving/host_tier.py).

The block pool bounds on-card prefix retention by blocks, and under block
pressure its LRU retained entry is reclaimed and its prefix recomputed on
the next hit. This tier catches that eviction: `SlotKVPool.on_evict_entry`
fires with the dying `RetainedPrefix` before its blocks are unreffed, the
engine copies the entry's blocks to host memory (`gather_blocks_host`) and
`demote` stores them here under a checksum; a later prompt whose longest
cached prefix lives only here restores it into a batch-1 cache
(`host_blocks_to_sub`) that lands through the normal insert path.

Host arrays are numpy. numpy has no bfloat16, so the pool hands a bf16
arena's blocks over as their int16 bit patterns and turns them back bit
for bit on restore; the tier only stores, hashes and indexes bytes.

Every entry carries a CRC32 over its arrays (names in sorted order),
verified at restore: a corrupt demotion is a miss (the entry is dropped
and the engine counts `host_tier_checksum_misses`), never wrong tokens.
The tier has its own byte budget with LRU eviction (`host_kv_bytes`); 0
keeps it off and the engine identical to the tier-less one.

Thread contract: every method runs on the engine thread except `lookup`,
which the router's `prefix_peek` may call from HTTP threads: it only reads
and swallows racy-iteration errors (affinity is a hint).
"""
from __future__ import annotations

import collections
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from megatron_tpu_torch.serving.prefix_index import PrefixIndex


def _checksum(arrays: Dict[str, np.ndarray]) -> int:
    """CRC32 chained over every array's raw bytes, in sorted name order so
    the digest does not depend on the dict's order."""
    crc = 0
    for name in sorted(arrays):
        crc = zlib.crc32(np.ascontiguousarray(arrays[name]).view(np.uint8),
                         crc)
    return crc


class _HostEntry:
    __slots__ = ("key", "tokens", "length", "arrays", "crc", "nbytes",
                 "namespace")

    def __init__(self, key, tokens: List[int], length: int,
                 arrays: Dict[str, np.ndarray], namespace=None):
        self.key = key
        self.tokens = list(tokens)
        self.length = int(length)
        self.arrays = arrays
        self.crc = _checksum(arrays)
        self.nbytes = int(sum(a.nbytes for a in arrays.values()))
        # the namespace the KV was computed under (None: the base model);
        # lookups in any other namespace miss
        self.namespace = namespace


class HostKVTier:
    """LRU of demoted `RetainedPrefix` block arrays in host memory, bounded
    by `budget_bytes` and indexed by the same block-granular `PrefixIndex`
    the engine routes hits through."""

    def __init__(self, budget_bytes: int, granularity: int):
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got "
                             f"{budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._entries: "collections.OrderedDict" = \
            collections.OrderedDict()  # key -> _HostEntry, LRU first
        self._index = PrefixIndex(granularity)
        # sequence dedup: retain keys are always fresh, so a hot prompt
        # cycling demote -> restore -> retain -> demote would otherwise
        # fill the budget with copies of one sequence and evict distinct
        # prefixes
        self._by_seq: Dict[tuple, object] = {}  # (ns, tokens) -> key
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)

    # ---- demote ------------------------------------------------------
    def demote(self, key, tokens: Sequence[int], length: int,
               arrays: Dict[str, np.ndarray], namespace=None) -> bool:
        """Store a dying retained entry's host arrays. False (nothing
        stored) when the entry alone exceeds the budget; otherwise LRU
        entries are evicted until it fits. An entry holding the same
        (namespace, sequence) is replaced, not duplicated."""
        ent = _HostEntry(key, list(tokens), length, arrays,
                         namespace=namespace)
        if ent.nbytes > self.budget_bytes:
            return False
        seq = (namespace, tuple(ent.tokens[:ent.length]))
        self.drop(self._by_seq.get(seq))
        self.drop(key)
        while self.bytes_used + ent.nbytes > self.budget_bytes \
                and self._entries:
            self.drop(next(iter(self._entries)))
        self._entries[key] = ent
        self.bytes_used += ent.nbytes
        self._by_seq[seq] = key
        self._index.insert(key, ent.tokens[:ent.length], namespace=namespace)
        return True

    def drop(self, key):
        if key is None:
            return
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.bytes_used -= ent.nbytes
            self._index.remove(key)
            seq = (ent.namespace, tuple(ent.tokens[:ent.length]))
            if self._by_seq.get(seq) == key:
                del self._by_seq[seq]

    def clear(self) -> int:
        """Drop every entry (the weight swap's version hygiene: KV demoted
        under the old weights must not restore under the new). Returns the
        count dropped."""
        n = len(self._entries)
        self._entries.clear()
        self._by_seq.clear()
        self._index = PrefixIndex(self._index.granularity)
        self.bytes_used = 0
        return n

    # ---- lookup / restore --------------------------------------------
    def lookup(self, tokens: Sequence[int], max_tokens: Optional[int] = None,
               namespace=None) -> Tuple[object, int]:
        """Longest demoted block-aligned prefix of `tokens` under
        `namespace`: the host half of the engine's prefix lookup (and of
        `prefix_peek`, which may call from another thread, so a failure is
        a missed hint, never an error)."""
        try:
            key, hit = self._index.lookup(tokens, max_tokens,
                                          namespace=namespace)
            if key is None:
                return None, 0
            ent = self._entries[key]
        except Exception:  # noqa: BLE001 — racy cross-thread peek
            return None, 0
        return key, min(hit, ent.length)

    def has(self, key) -> bool:
        return key in self._entries

    def restore(self, key) -> Optional[_HostEntry]:
        """Checksum-verified fetch for a restore. A mismatch drops the
        entry and returns None: the caller treats it as a miss and
        recomputes. A hit refreshes the entry's LRU position."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        if _checksum(ent.arrays) != ent.crc:
            self.drop(key)
            return None
        self._entries.move_to_end(key)
        return ent
