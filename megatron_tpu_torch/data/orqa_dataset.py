"""Open-retrieval evidence and question datasets (ORQA / DPR layouts), a
copy of megatron_tpu/data/orqa_dataset.py (numpy only), so that both
packages build the same samples from the same files.

Evidence file (DPR's "psgs_w100.tsv" layout): TSV with a header row,
columns `id  text  title`. Question file: TSV rows of `question  answers`,
the answers a Python list literal (DPR's NQ layout), or JSONL rows
{"question": ..., "answers": [...]}.
"""
from __future__ import annotations

import ast
import csv
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def build_tokens_types_paddings_from_ids(text_ids: Sequence[int],
                                         max_seq_length: int, cls_id: int,
                                         sep_id: int, pad_id: int):
    """[CLS] ids [SEP] + pad -> (tokens, tokentypes, pad_mask), each
    [max_seq_length] (ref: orqa_wiki_dataset.py:68-110). pad_mask is 1 on
    real tokens, 0 on padding."""
    ids = [cls_id] + list(text_ids)[:max_seq_length - 2] + [sep_id]
    n = len(ids)
    tokens = np.full(max_seq_length, pad_id, np.int64)
    tokens[:n] = ids
    types = np.zeros(max_seq_length, np.int64)
    pad_mask = np.zeros(max_seq_length, np.int64)
    pad_mask[:n] = 1
    return tokens, types, pad_mask


class OpenRetrievalEvidenceDataset:
    """Wikipedia evidence passages for open retrieval
    (ref: megatron/data/orqa_wiki_dataset.py:16-135). Each sample is the
    tokenized `[CLS] title [SEP] text [SEP]` block plus its row id; `id2text`
    maps row id -> (text, title) for answer matching
    (ref: tasks/orqa/evaluate_utils.py evidence usage)."""

    def __init__(self, evidence_path: str, tokenizer, max_seq_length: int):
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.rows: List[Tuple[int, str, str]] = []  # (row_id, text, title)
        with open(evidence_path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f, delimiter="\t")
            for i, row in enumerate(reader):
                if i == 0 and row and row[0].strip().lower() == "id":
                    continue  # header
                if len(row) < 3:
                    continue
                self.rows.append((int(row[0]), row[1], row[2]))
        self._id2text: Optional[Dict[int, Tuple[str, str]]] = None

    @property
    def id2text(self) -> Dict[int, Tuple[str, str]]:
        """doc_id -> (text, title), built lazily: only answer matching
        (evaluation) needs it — the indexing pass over a 21M-passage DPR
        dump must not pay gigabytes for an unused dict."""
        if self._id2text is None:
            self._id2text = {rid: (text, title)
                             for rid, text, title in self.rows}
        return self._id2text

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int):
        row_id, text, title = self.rows[idx]
        ids = (self.tokenizer.tokenize(title) + [self.tokenizer.sep]
               + self.tokenizer.tokenize(text))
        tokens, types, pad_mask = build_tokens_types_paddings_from_ids(
            ids, self.max_seq_length, self.tokenizer.cls,
            self.tokenizer.sep, self.tokenizer.pad)
        return {"row_id": row_id, "context": tokens,
                "context_types": types, "context_pad_mask": pad_mask}

    def batches(self, batch_size: int, *, shard: int = 0,
                num_shards: int = 1):
        """Yield stacked batches of this dataset's `shard`-th slice (round-
        robin over `num_shards` — the dp sharding of the reference's
        IndexBuilder, ref: megatron/indexer.py:36-37,86-90). The final
        partial batch is padded by repeating the last row; `n_real` marks
        how many rows are genuine."""
        idxs = list(range(shard, len(self), num_shards))
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo:lo + batch_size]
            n_real = len(chunk)
            while len(chunk) < batch_size:
                chunk.append(chunk[-1])
            samples = [self[i] for i in chunk]
            yield {
                "row_id": np.asarray([s["row_id"] for s in samples]),
                "context": np.stack([s["context"] for s in samples]),
                "context_types": np.stack(
                    [s["context_types"] for s in samples]),
                "context_pad_mask": np.stack(
                    [s["context_pad_mask"] for s in samples]),
                "n_real": n_real,
            }


def _read_qa_rows(path: str) -> List[Tuple[str, List[str]]]:
    """DPR NQ csv/tsv (`question\\tanswers-literal`) or JSONL
    (ref: tasks/orqa/unsupervised/nq.py:118-137)."""
    rows: List[Tuple[str, List[str]]] = []
    with open(path, newline="", encoding="utf-8") as f:
        first = f.read(1)
        f.seek(0)
        if first == "{":
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                rows.append((d["question"], list(d["answers"])))
        else:
            for row in csv.reader(f, delimiter="\t"):
                if len(row) < 2:
                    continue
                try:
                    answers = ast.literal_eval(row[1])
                except (ValueError, SyntaxError):
                    answers = [row[1]]
                rows.append((row[0], [str(a) for a in answers]))
    return rows


class NQDataset:
    """Natural-Questions open-domain eval queries
    (ref: tasks/orqa/unsupervised/nq.py:84-215): tokenized question plus the
    reference answer list."""

    def __init__(self, qa_path: str, tokenizer, max_seq_length: int):
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.rows = _read_qa_rows(qa_path)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int):
        question, answers = self.rows[idx]
        ids = self.tokenizer.tokenize(question)
        tokens, types, pad_mask = build_tokens_types_paddings_from_ids(
            ids, self.max_seq_length, self.tokenizer.cls,
            self.tokenizer.sep, self.tokenizer.pad)
        return {"token_ids": tokens, "token_types": types,
                "token_mask": pad_mask, "reference": answers}

    def batches(self, batch_size: int):
        """Sequential, keep-last batches (the reference's NQ dataloader is
        explicitly non-distributed with drop_last=False,
        ref: nq.py:64-83)."""
        for lo in range(0, len(self), batch_size):
            chunk = [self[i] for i in range(lo, min(lo + batch_size,
                                                    len(self)))]
            n_real = len(chunk)
            while len(chunk) < batch_size:
                chunk.append(chunk[-1])
            yield {
                "token_ids": np.stack([s["token_ids"] for s in chunk]),
                "token_types": np.stack([s["token_types"] for s in chunk]),
                "token_mask": np.stack([s["token_mask"] for s in chunk]),
                "reference": [s["reference"] for s in chunk[:n_real]],
                "n_real": n_real,
            }
