"""GLUE datasets, MNLI and QQP (tasks/glue/data.py): TSV readers giving
{uid, text_a, text_b, label} rows, packed into classification samples
{tokens, tokentype_ids, padding_mask, label}.
"""
from __future__ import annotations

import numpy as np

from megatron_tpu_torch.tasks.data_utils import clean_text, pack_pair

MNLI_LABELS = {"contradiction": 0, "entailment": 1, "neutral": 2}


def read_mnli(path: str, test_label: str = "contradiction") -> list[dict]:
    """(ref: tasks/glue/mnli.py:22-67): dev/train TSV has text in columns
    8/9 and the gold label last; the 10-column test TSV has no label."""
    rows = []
    with open(path) as f:
        first = True
        is_test = False
        for line in f:
            row = line.rstrip("\n").split("\t")
            if first:
                first = False
                is_test = len(row) == 10
                continue
            label = test_label if is_test else row[-1].strip()
            rows.append({
                "uid": int(row[0].strip()),
                "text_a": clean_text(row[8].strip()),
                "text_b": clean_text(row[9].strip()),
                "label": MNLI_LABELS[label],
            })
    return rows


def read_qqp(path: str, test_label: int = 0) -> list[dict]:
    """(ref: tasks/glue/qqp.py:29-79): test TSV is (id, q1, q2); train/dev
    is (id, qid1, qid2, q1, q2, is_duplicate). Malformed lines skipped."""
    rows = []
    with open(path) as f:
        first = True
        is_test = False
        for line in f:
            row = line.rstrip("\n").split("\t")
            if first:
                first = False
                is_test = len(row) == 3
                continue
            try:
                if is_test:
                    rows.append({
                        "uid": int(row[0].strip()),
                        "text_a": clean_text(row[1].strip()),
                        "text_b": clean_text(row[2].strip()),
                        "label": int(test_label),
                    })
                else:
                    rows.append({
                        "uid": int(row[0].strip()),
                        "text_a": clean_text(row[3].strip()),
                        "text_b": clean_text(row[4].strip()),
                        "label": int(row[5].strip()),
                    })
            except (IndexError, ValueError):
                continue  # (ref: qqp.py ignore_index malformed rows)
    return rows


class GlueDataset:
    """Tokenized classification samples for one GLUE task split."""

    def __init__(self, rows: list[dict], tokenizer, max_seq_length: int):
        self.samples = []
        for r in rows:
            ids, types, mask = pack_pair(
                tokenizer.tokenize(r["text_a"]),
                tokenizer.tokenize(r["text_b"]),
                max_seq_length, tokenizer.cls, tokenizer.sep, tokenizer.pad)
            self.samples.append({
                "tokens": ids, "tokentype_ids": types,
                "padding_mask": mask,
                "label": np.int64(r["label"]),
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]
