"""Group candidate-duplicate URLs into connected components.

The port's copy of the root tools/openwebtext/group_duplicate_url.py.

Counterpart of ref: tools/openwebtext/group_duplicate_url.py — reads
find_duplicates.py's {main: [{other: jaccard}, ...]} records, keeps edges
at or above the similarity threshold, and unions them into groups; output
is one json list of urls per group (the first url is the keeper).

Usage: python -m megatron_tpu_torch.tools.openwebtext.group_duplicate_url
    <dups.jsonl> <groups.jsonl> [thresh]
"""
from __future__ import annotations

import json
import sys

from megatron_tpu_torch.tools.openwebtext.owt_utils import iter_jsonl


class _UnionFind:
    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def group_urls(input_path: str, output_path: str,
               threshold: float = 0.7) -> int:
    """Returns the number of groups written."""
    uf = _UnionFind()
    for rec in iter_jsonl(input_path):
        for main, others in rec.items():
            for entry in others:
                for other, sim in entry.items():
                    if sim >= threshold:
                        uf.union(main, other)
    groups: dict = {}
    for url in list(uf.parent):
        groups.setdefault(uf.find(url), []).append(url)
    n = 0
    with open(output_path, "w", encoding="utf-8") as out:
        for root, members in groups.items():
            if len(members) > 1:
                ordered = [root] + [u for u in sorted(members)
                                    if u != root]
                out.write(json.dumps(ordered, ensure_ascii=False) + "\n")
                n += 1
    return n


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    assert len(argv) >= 2, __doc__
    thresh = float(argv[2]) if len(argv) > 2 else 0.7
    n = group_urls(argv[0], argv[1], thresh)
    print(f"group_duplicate_url: {n} groups")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
