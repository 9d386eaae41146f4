"""Supervised open-retrieval datasets for retriever finetuning
(tasks/orqa/data.py): DPR-codebase training json, rows of {question,
answers, positive_ctxs, negative_ctxs, hard_negative_ctxs}, each context a
{title, text} dict. Python-`random` draws (the sample rate's subsample,
the negatives' shuffles) are taken in the reference's order from a
Random(seed), so both packages give the same samples.
"""
from __future__ import annotations

import json
import random
from typing import List, Optional

import numpy as np

from megatron_tpu_torch.data.orqa_dataset import \
    build_tokens_types_paddings_from_ids


def normalize_question(question: str) -> str:
    """(ref: data.py:229-232)"""
    return question[:-1] if question.endswith("?") else question


def _context_ids(ctx: dict, tokenizer) -> List[int]:
    """[title] SEP [text] (ref: data.py:16-29,133-136)."""
    return (tokenizer.tokenize(ctx["title"]) + [tokenizer.sep]
            + tokenizer.tokenize(ctx["text"]))


class NQSupervisedDataset:
    """DPR-json retriever finetuning samples (ref: data.py:237-287).

    `evaluate=True` attaches up to `val_av_rank_hard_neg` hard +
    `val_av_rank_other_neg` simple negatives per sample (the av-rank
    validation pool); `train_with_neg` attaches `train_hard_neg` hard
    negatives (topped up with simple ones when DPR rows lack enough,
    ref: data.py:188-205)."""

    def __init__(self, datapaths, tokenizer, max_seq_length: int, *,
                 evaluate: bool = False, train_with_neg: bool = False,
                 train_hard_neg: int = 0, val_av_rank_hard_neg: int = 30,
                 val_av_rank_other_neg: int = 30, sample_rate: float = 1.0,
                 seed: int = 1234):
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.evaluate = evaluate
        self.train_with_neg = train_with_neg
        self.train_hard_neg = train_hard_neg
        self.val_av_rank_hard_neg = val_av_rank_hard_neg
        self.val_av_rank_other_neg = val_av_rank_other_neg
        self._rng = random.Random(seed)
        # fixed per-sample negative slot count: batches pad ragged DPR
        # negative lists to this cap so every batch has one shape
        if evaluate:
            self.neg_cap = val_av_rank_hard_neg + val_av_rank_other_neg
        elif train_with_neg:
            self.neg_cap = train_hard_neg
        else:
            self.neg_cap = None
        self.samples = []
        for path in ([datapaths] if isinstance(datapaths, str)
                     else datapaths):
            self.samples.extend(self._read(path))
        if sample_rate < 1.0:
            k = int(len(self.samples) * sample_rate)
            self.samples = self._rng.sample(self.samples, k)

    @staticmethod
    def _read(path: str):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        rows = []
        for row in data:
            if not row.get("positive_ctxs"):
                continue
            rows.append({
                "question": normalize_question(row["question"]),
                "pos_context": row["positive_ctxs"][0],
                "hard_negative_context": row.get("hard_negative_ctxs", []),
                "negative_context": row.get("negative_ctxs", []),
                "answers": row.get("answers", []),
            })
        return rows

    def __len__(self):
        return len(self.samples)

    def _pack(self, ids):
        t = self.tokenizer
        return build_tokens_types_paddings_from_ids(
            ids, self.max_seq_length, t.cls, t.sep, t.pad)

    def __getitem__(self, idx: int):
        raw = self.samples[idx]
        t = self.tokenizer
        q_ids, q_types, q_pad = self._pack(t.tokenize(raw["question"]))
        c_ids, c_types, c_pad = self._pack(
            _context_ids(raw["pos_context"], t))

        neg_ctxs: Optional[list] = None
        if self.evaluate:
            neg_ctxs = (raw["negative_context"][:self.val_av_rank_other_neg]
                        + raw["hard_negative_context"]
                        [:self.val_av_rank_hard_neg])
        elif self.train_with_neg:
            hard = list(raw["hard_negative_context"])
            simple = list(raw["negative_context"])
            self._rng.shuffle(hard)
            self._rng.shuffle(simple)
            neg_ctxs = hard[:self.train_hard_neg]
            if len(neg_ctxs) < self.train_hard_neg:  # DPR rows can be short
                neg_ctxs += simple[:self.train_hard_neg - len(neg_ctxs)]

        sample = {
            "query": q_ids, "query_types": q_types, "query_pad_mask": q_pad,
            "context": c_ids, "context_types": c_types,
            "context_pad_mask": c_pad, "reference": raw["answers"],
        }
        if neg_ctxs is not None:
            cap = self.neg_cap or 0
            L = self.max_seq_length
            ids = np.zeros((cap, L), np.int64)
            types = np.zeros((cap, L), np.int64)
            pad = np.zeros((cap, L), np.int64)
            n = min(len(neg_ctxs), cap)
            for j, c in enumerate(neg_ctxs[:n]):
                ids[j], types[j], pad[j] = self._pack(_context_ids(c, t))
            # padded slots keep all-pad rows; pad[j]=0 marks them invalid
            sample["neg_context"] = ids
            sample["neg_context_types"] = types
            sample["neg_context_pad_mask"] = pad
            sample["neg_count"] = n
        return sample

    def batches(self, batch_size: int, *, shuffle_rng=None,
                drop_last: bool = True):
        """Batch producer: queries/contexts stacked [b, L]; negatives from
        all samples concatenated [sum_negs, L] (the reference's
        task_collate_fn concat, ref: eval_utils.py:42-58)."""
        idxs = np.arange(len(self))
        if shuffle_rng is not None:
            shuffle_rng.shuffle(idxs)
        stop = len(idxs) - batch_size + 1 if drop_last else len(idxs)
        for lo in range(0, stop, batch_size):
            items = [self[int(i)] for i in idxs[lo:lo + batch_size]]
            batch = {
                k: np.stack([it[k] for it in items])
                for k in ("query", "query_types", "query_pad_mask",
                          "context", "context_types", "context_pad_mask")
            }
            batch["reference"] = [it["reference"] for it in items]
            if "neg_context" in items[0]:
                # fixed [b*cap, L] concat: shapes identical across batches
                for k in ("neg_context", "neg_context_types",
                          "neg_context_pad_mask"):
                    batch[k] = np.concatenate([it[k] for it in items])
                batch["neg_counts"] = np.asarray(
                    [it["neg_count"] for it in items])
                # per-row validity over the concatenated negatives
                cap = self.neg_cap or 0
                valid = np.zeros(len(items) * cap, np.int64)
                for i, it in enumerate(items):
                    valid[i * cap:i * cap + it["neg_count"]] = 1
                batch["neg_valid"] = valid
            yield batch
