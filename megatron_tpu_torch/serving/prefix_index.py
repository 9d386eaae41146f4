"""Host-side radix index for prefix-cache KV reuse
(megatron_tpu/serving/prefix_index.py).

Keys are blocks of `granularity` tokens (the engine passes its KV block
size, or `prefill_bucket` on a whole-region pool): a hit is always a whole
number of blocks, so a block pool aliases the shared blocks into the new
row's map and the suffix forward keeps the unchunked engine's shapes.

The index maps block paths to sources: a running slot (an int) or a
retained prefix's key. Every source registers on each node along its
sequence's path, so the deepest non-empty node on a prompt's path gives
the longest reusable prefix in one walk; `lookup` prefers the most
recently indexed source at that node. Every path starts with a namespace
node (None for the base model), so entries of one namespace are invisible
to lookups in another. Engine thread only; no locking.
"""
from __future__ import annotations

import collections
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("children", "slots")

    def __init__(self):
        self.children: Dict[tuple, "_Node"] = {}
        # source -> None, insertion-ordered: the most recently indexed
        # source sits at the end (lookup's tie-break)
        self.slots: "collections.OrderedDict[Hashable, None]" = \
            collections.OrderedDict()


class PrefixIndex:
    """Block-granular trie over the token sequences whose KV the pool
    holds. Only whole blocks of `granularity` tokens are indexed."""

    def __init__(self, granularity: int):
        if granularity < 1:
            raise ValueError(f"granularity must be >= 1, got {granularity}")
        self.granularity = granularity
        self._root = _Node()
        self._blocks: Dict[Hashable, List[tuple]] = {}  # source -> path

    def __len__(self) -> int:
        return len(self._blocks)

    @staticmethod
    def _ns_key(namespace) -> tuple:
        # tagged so a namespace can never collide with a token block
        return ("ns", namespace)

    def insert(self, slot: Hashable, tokens: Sequence[int], namespace=None):
        """(Re)index `slot` as holding valid KV for `tokens` under
        `namespace`; re-inserting replaces the old path."""
        self.remove(slot)
        g = self.granularity
        blocks = [self._ns_key(namespace)] + [
            tuple(tokens[i * g:(i + 1) * g]) for i in range(len(tokens) // g)]
        node = self._root
        for b in blocks:
            node = node.children.setdefault(b, _Node())
            node.slots[slot] = None
        self._blocks[slot] = blocks

    def remove(self, slot: Hashable):
        """Forget `slot` (its KV is about to be overwritten, or its request
        failed) and prune the nodes left empty. Unindexed: a no-op."""
        blocks = self._blocks.pop(slot, None)
        if not blocks:
            return
        path = [self._root]
        node = self._root
        for b in blocks:
            node = node.children.get(b)
            if node is None:
                break
            node.slots.pop(slot, None)
            path.append(node)
        # a node with no sources has an empty subtree: every source
        # registers on its whole path
        for parent, b, child in reversed(
                list(zip(path[:-1], blocks, path[1:]))):
            if not child.slots and not child.children:
                del parent.children[b]

    def lookup(self, tokens: Sequence[int],
               max_tokens: Optional[int] = None, namespace=None
               ) -> Tuple[Optional[Hashable], int]:
        """Longest block-aligned prefix of `tokens` held by an indexed
        source in `namespace`, capped at `max_tokens` (the engine passes
        len - 1: one suffix token must forward for the logits). Returns
        (source, matched_len) or (None, 0)."""
        g = self.granularity
        limit = len(tokens) if max_tokens is None else max_tokens
        node = self._root.children.get(self._ns_key(namespace))
        if node is None or not node.slots:
            return (None, 0)
        best: Tuple[Optional[Hashable], int] = (None, 0)
        depth = 0
        while (depth + 1) * g <= limit:
            child = node.children.get(
                tuple(tokens[depth * g:(depth + 1) * g]))
            if child is None or not child.slots:
                break
            depth += 1
            node = child
            best = (next(reversed(node.slots)), depth * g)
        return best
