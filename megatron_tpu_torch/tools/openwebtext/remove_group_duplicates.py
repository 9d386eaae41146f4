"""Drop all but the first URL of every duplicate group from a corpus.

The port's copy of the root tools/openwebtext/remove_group_duplicates.py.

Counterpart of ref: tools/openwebtext/remove_group_duplicates.py — reads
group_duplicate_url.py's per-group url lists (keeper first), builds the
removal set from positions 1.., and streams the corpus through.

Usage: python -m megatron_tpu_torch.tools.openwebtext.remove_group_duplicates
    <groups.jsonl> <corpus.jsonl>
           <deduped.jsonl>
"""
from __future__ import annotations

import json
import sys

from megatron_tpu_torch.tools.openwebtext.owt_utils import iter_jsonl


def remove_duplicates(groups_path: str, corpus_path: str,
                      output_path: str, url_key: str = "url") -> tuple:
    """Returns (written, removed)."""
    remove: set = set()
    with open(groups_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            urls = json.loads(line)
            remove.update(urls[1:])
    written = removed = 0
    with open(output_path, "w", encoding="utf-8") as out:
        for rec in iter_jsonl(corpus_path):
            if rec.get(url_key) in remove:
                removed += 1
                continue
            out.write(json.dumps(rec, ensure_ascii=False) + "\n")
            written += 1
    return written, removed


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    assert len(argv) >= 3, __doc__
    written, removed = remove_duplicates(argv[0], argv[1], argv[2])
    print(f"remove_group_duplicates: wrote {written}, removed {removed}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
