"""Clean a loose-json corpus: fix text, keep English, drop short docs.

The port's copy of the root tools/openwebtext/cleanup_dataset.py.

Counterpart of ref: tools/openwebtext/cleanup_dataset.py — same jsonl
contract ({"text": ..., "url": ...} per line) and the same three filters:
text repair (ftfy there, owt_utils.fix_text here), language detection
(langdetect there, a stopword/ascii heuristic here), and a minimum token
count (128 GPT-2-ish tokens; whitespace tokens are used when no tokenizer
is given, with the same 8-chars-per-token prefilter shortcut).

Usage: python -m megatron_tpu_torch.tools.openwebtext.cleanup_dataset
    <input.jsonl> <output.jsonl>
"""
from __future__ import annotations

import sys

from megatron_tpu_torch.tools.openwebtext.owt_utils import (
    fix_text, iter_jsonl, looks_english)

MIN_DOCUMENT_TOKENS = 128


def clean_corpus(input_path: str, output_path: str, *,
                 min_tokens: int = MIN_DOCUMENT_TOKENS,
                 tokenize=None) -> dict:
    """Returns counters {docs, written, fixed, non_english, small}."""
    tokenize = tokenize or (lambda t: t.split())
    stats = dict(docs=0, written=0, fixed=0, non_english=0, small=0)
    import json
    with open(output_path, "w", encoding="utf-8") as out:
        for rec in iter_jsonl(input_path):
            stats["docs"] += 1
            text = rec.get("text", "")
            fixed = fix_text(text)
            if fixed != text:
                stats["fixed"] += 1
            rec["text"] = fixed
            if not looks_english(fixed):
                stats["non_english"] += 1
                continue
            # ~8 chars/token upper bound: only tokenize docs short enough
            # to possibly fail the cutoff (ref: cleanup_dataset.py:63-70)
            if len(fixed) < 8 * min_tokens and \
                    len(tokenize(fixed)) < min_tokens:
                stats["small"] += 1
                continue
            out.write(json.dumps(rec, ensure_ascii=False) + "\n")
            stats["written"] += 1
    return stats


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    assert len(argv) >= 2, __doc__
    stats = clean_corpus(argv[0], argv[1])
    print("cleanup_dataset:", stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
