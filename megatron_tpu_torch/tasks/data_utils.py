"""Shared task-data helpers (tasks/data_utils.py): text cleaning and pair
packing, [CLS] A [SEP] (B [SEP]) with token types and a padding mask,
trimmed to max_seq_length by dropping from the longer segment's tail.
"""
from __future__ import annotations

import re

import numpy as np


def clean_text(text: str) -> str:
    """(ref: tasks/data_utils.py:9-17)"""
    text = text.replace("\n", " ")
    text = re.sub(r"\s+", " ", text)
    for _ in range(3):
        text = text.replace(" . ", ". ")
    return text


def pack_pair(a_ids, b_ids, max_seq_length: int, cls_id: int, sep_id: int,
              pad_id: int):
    """-> (ids [L], types [L], padding_mask [L]) int64 arrays
    (ref: tasks/data_utils.py:49-100)."""
    a = list(a_ids)
    b = list(b_ids) if b_ids is not None else None
    budget = max_seq_length - (3 if b is not None else 2)
    if b is None:
        a = a[:budget]
    else:
        while len(a) + len(b) > budget:
            seg = a if len(a) >= len(b) else b
            seg.pop()
    ids = [cls_id] + a + [sep_id]
    types = [0] * len(ids)
    if b is not None:
        ids += b + [sep_id]
        types += [1] * (len(b) + 1)
    n = len(ids)
    pad = max_seq_length - n
    out_ids = np.asarray(ids + [pad_id] * pad, np.int64)
    out_types = np.asarray(types + [0] * pad, np.int64)
    mask = np.zeros(max_seq_length, np.int64)
    mask[:n] = 1
    return out_ids, out_types, mask
