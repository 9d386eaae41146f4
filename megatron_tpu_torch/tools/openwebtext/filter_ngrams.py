"""Deduplicate downstream-task n-grams out of a training corpus.

The port's copy of the root tools/openwebtext/filter_ngrams.py.

Counterpart of ref: tools/openwebtext/filter_ngrams.py — task
decontamination by 13-gram matching: build the n-gram set from the task
data (lambada / squad / generic jsonl), scan each training document with a
sliding word window, and on a match cut the n-gram plus 200 characters on
each side. Split fragments shorter than 200 characters are dropped, and a
document that splits more than 10 times is dropped entirely
(ref: filter_ngrams.py:323-398 and the --max_ngram_size /
--filter_text_char_len / --splits_count / --remove_char_each_side knobs).

Usage: python -m megatron_tpu_torch.tools.openwebtext.filter_ngrams
    --tasks lambada --lambada_path test.jsonl
           --dedup_dataset train.jsonl text --output clean.jsonl
"""
from __future__ import annotations

import argparse
import json
import re
from typing import List, Set, Tuple

from megatron_tpu_torch.tools.openwebtext.owt_utils import iter_jsonl

_WORD = re.compile(r"[a-z0-9']+")


def _words_with_spans(text: str) -> Tuple[List[str], List[Tuple[int, int]]]:
    words, spans = [], []
    for m in _WORD.finditer(text.lower()):
        words.append(m.group())
        spans.append((m.start(), m.end()))
    return words, spans


def ngrams_of(text: str, n: int) -> Set[tuple]:
    words, _ = _words_with_spans(text)
    return {tuple(words[i:i + n]) for i in range(len(words) - n + 1)}


def task_ngrams(task: str, path: str, n: int, key: str = "text"
                ) -> Set[tuple]:
    """Task file -> n-gram set. lambada: jsonl with 'text'; squad: the
    official nested json (questions + answer texts); generic: jsonl with
    `key` (ref: filter_ngrams.py:189-264 process_task_lambda/process_task)."""
    grams: Set[tuple] = set()
    if task == "squad":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)["data"]
        for article in data:
            for para in article["paragraphs"]:
                for qa in para["qas"]:
                    grams |= ngrams_of(qa["question"], n)
                    for ans in qa.get("answers", []):
                        grams |= ngrams_of(ans["text"], n)
    else:  # lambada and generic jsonl tasks
        for rec in iter_jsonl(path):
            grams |= ngrams_of(rec.get(key, ""), n)
    return grams


def split_document(text: str, grams: Set[tuple], *, n: int,
                   pad_chars: int, min_chars: int) -> Tuple[List[str], int]:
    """-> (clean fragments, match count). Matched n-grams are removed with
    `pad_chars` characters on each side; fragments under `min_chars` are
    dropped."""
    words, spans = _words_with_spans(text)
    matches = []
    i = 0
    while i <= len(words) - n:
        if tuple(words[i:i + n]) in grams:
            lo = max(spans[i][0] - pad_chars, 0)
            hi = min(spans[i + n - 1][1] + pad_chars, len(text))
            if matches and lo <= matches[-1][1]:
                matches[-1] = (matches[-1][0], hi)
            else:
                matches.append((lo, hi))
            i += n
        else:
            i += 1
    if not matches:
        return [text], 0
    pieces, pos = [], 0
    for lo, hi in matches:
        pieces.append(text[pos:lo])
        pos = hi
    pieces.append(text[pos:])
    return [p for p in pieces if len(p) >= min_chars], len(matches)


def filter_corpus(dedup_path: str, text_key: str, output_path: str,
                  grams: Set[tuple], *, n: int = 13,
                  pad_chars: int = 200, min_chars: int = 200,
                  max_splits: int = 10) -> dict:
    stats = dict(docs=0, written=0, split=0, dropped=0, trimmed=0)
    with open(output_path, "w", encoding="utf-8") as out:
        for rec in iter_jsonl(dedup_path):
            stats["docs"] += 1
            pieces, n_matches = split_document(
                rec.get(text_key, ""), grams, n=n, pad_chars=pad_chars,
                min_chars=min_chars)
            if n_matches == 0:
                out.write(json.dumps(rec, ensure_ascii=False) + "\n")
                stats["written"] += 1
                continue
            if len(pieces) > max_splits or not pieces:
                stats["dropped"] += 1
                continue
            stats["split"] += 1
            stats["trimmed"] += n_matches
            for j, piece in enumerate(pieces):
                frag = dict(rec)
                frag[text_key] = piece
                if len(pieces) > 1:
                    frag["split_part"] = j
                out.write(json.dumps(frag, ensure_ascii=False) + "\n")
                stats["written"] += 1
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tasks", nargs="+", required=True,
                   help="lambada, squad, or generic jsonl paths via "
                        "--task_files")
    p.add_argument("--lambada_path")
    p.add_argument("--squad_path")
    p.add_argument("--task_files", nargs="*", default=[],
                   help="jsonl files for generic tasks (text key)")
    p.add_argument("--dedup_dataset", nargs=2, required=True,
                   metavar=("FILE", "KEY"))
    p.add_argument("--output", required=True)
    p.add_argument("--max_ngram_size", type=int, default=13)
    p.add_argument("--filter_text_char_len", type=int, default=200)
    p.add_argument("--splits_count", type=int, default=10)
    p.add_argument("--remove_char_each_side", type=int, default=200)
    args = p.parse_args(argv)

    grams: Set[tuple] = set()
    for task in args.tasks:
        if task == "lambada":
            assert args.lambada_path, "--lambada_path required"
            grams |= task_ngrams("lambada", args.lambada_path,
                                 args.max_ngram_size)
        elif task == "squad":
            assert args.squad_path, "--squad_path required"
            grams |= task_ngrams("squad", args.squad_path,
                                 args.max_ngram_size)
        else:
            for path in args.task_files:
                grams |= task_ngrams(task, path, args.max_ngram_size)
    print(f"filter_ngrams: {len(grams)} task {args.max_ngram_size}-grams")
    stats = filter_corpus(
        args.dedup_dataset[0], args.dedup_dataset[1], args.output, grams,
        n=args.max_ngram_size, pad_chars=args.remove_char_each_side,
        min_chars=args.filter_text_char_len, max_splits=args.splits_count)
    print("filter_ngrams:", stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
