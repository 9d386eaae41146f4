"""The RACE multiple-choice dataset (tasks/race/data.py): json-lines files
of {article, questions, options, answers}; each question becomes one sample
of NUM_CHOICES packed [article, question + option] pairs.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from megatron_tpu_torch.tasks.data_utils import clean_text, pack_pair

NUM_CHOICES = 4
MAX_QA_LENGTH = 128


def read_race(datapath: str) -> list[dict]:
    """-> rows of {context, qa: [4 strings], label}
    (ref: race/data.py:52-120). `_` in the question marks cloze style: the
    option substitutes; otherwise question and option concatenate."""
    rows = []
    for filename in sorted(glob.glob(os.path.join(datapath, "*.txt"))):
        with open(filename) as f:
            for line in f:
                data = json.loads(line)
                context = clean_text(data["article"])
                for q, opts, ans in zip(data["questions"], data["options"],
                                        data["answers"]):
                    assert len(opts) == NUM_CHOICES
                    label = ord(ans) - ord("A")
                    if "_" in q:
                        qa = [clean_text(q.replace("_", " " + o + " "))
                              for o in opts]
                    else:
                        qa = [clean_text(q + " " + o) for o in opts]
                    rows.append({"context": context, "qa": qa,
                                 "label": label})
    return rows


class RaceDataset:
    """Tokenized multiple-choice samples: tokens [4, L]."""

    def __init__(self, rows: list[dict], tokenizer, max_seq_length: int,
                 max_qa_length: int = MAX_QA_LENGTH):
        self.samples = []
        for r in rows:
            ctx_ids = tokenizer.tokenize(r["context"])
            toks, types, masks = [], [], []
            for qa in r["qa"]:
                qa_ids = tokenizer.tokenize(qa)[:max_qa_length]
                ids, ty, m = pack_pair(
                    ctx_ids, qa_ids, max_seq_length, tokenizer.cls,
                    tokenizer.sep, tokenizer.pad)
                toks.append(ids)
                types.append(ty)
                masks.append(m)
            self.samples.append({
                "tokens": np.stack(toks),
                "tokentype_ids": np.stack(types),
                "padding_mask": np.stack(masks),
                "label": np.int64(r["label"]),
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]
