"""Task-selectable additional corpus cleaning.

The port's copy of the root tools/openwebtext/cleanup_fix_dataset.py.

Counterpart of ref: tools/openwebtext/cleanup_fix_dataset.py — the same
named tasks applied per doc, with kept docs to one file and filtered docs
to another:

- remove_512: drop docs under 512 characters
- remove_256_javascript: drop short docs that mention javascript (boiler
  plate "enable javascript" shells)
- remove_512_non_english: drop short non-English docs
- ftfy_fix_text: repair mojibake/control chars in place
- general_cleaning: collapse whitespace runs, strip null bytes and
  repeated punctuation runs

Usage: python -m megatron_tpu_torch.tools.openwebtext.cleanup_fix_dataset
    --input_files a.jsonl [b.jsonl ...]
           --output_file kept.jsonl --filtered_file dropped.jsonl
           --tasks remove_512 ftfy_fix_text ...
"""
from __future__ import annotations

import argparse
import json
import re

from megatron_tpu_torch.tools.openwebtext.owt_utils import (
    fix_text, iter_jsonl, looks_english)

TASKS = ("remove_512", "remove_256_javascript", "remove_512_non_english",
         "ftfy_fix_text", "general_cleaning")

_WS_RUN = re.compile(r"[ \t]{3,}")
_NL_RUN = re.compile(r"\n{4,}")
_PUNCT_RUN = re.compile(r"([!?.,-])\1{4,}")


def process_doc(rec: dict, tasks) -> tuple:
    """-> (rec, drop_reason or None)."""
    text = rec.get("text", "")
    if "remove_512" in tasks and len(text) < 512:
        return rec, "remove_512"
    if "remove_256_javascript" in tasks and len(text) < 256 and \
            "javascript" in text.lower():
        return rec, "remove_256_javascript"
    if "remove_512_non_english" in tasks and len(text) < 512 and \
            not looks_english(text):
        return rec, "remove_512_non_english"
    if "ftfy_fix_text" in tasks:
        rec["text"] = text = fix_text(text)
    if "general_cleaning" in tasks:
        text = text.replace("\x00", "")
        text = _WS_RUN.sub(" ", text)
        text = _NL_RUN.sub("\n\n\n", text)
        text = _PUNCT_RUN.sub(r"\1\1\1", text)
        rec["text"] = text
    return rec, None


def process_files(input_files, output_file, filtered_file, tasks) -> dict:
    stats = {t: 0 for t in tasks}
    stats.update(docs=0, written=0)
    with open(output_file, "w", encoding="utf-8") as kept, \
            open(filtered_file, "w", encoding="utf-8") as dropped:
        for path in input_files:
            for rec in iter_jsonl(path):
                stats["docs"] += 1
                rec, reason = process_doc(rec, tasks)
                line = json.dumps(rec, ensure_ascii=False) + "\n"
                if reason is None:
                    kept.write(line)
                    stats["written"] += 1
                else:
                    dropped.write(line)
                    stats[reason] += 1
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--input_files", nargs="+", required=True)
    p.add_argument("--output_file", required=True)
    p.add_argument("--filtered_file", required=True)
    p.add_argument("--tasks", nargs="+", default=list(TASKS),
                   choices=list(TASKS))
    args = p.parse_args(argv)
    stats = process_files(args.input_files, args.output_file,
                          args.filtered_file, args.tasks)
    print("cleanup_fix_dataset:", stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
