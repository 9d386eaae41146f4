"""Sentence-pair (BERT) and inverse-cloze (ICT) block datasets over
sentence-split corpora: a copy of megatron_tpu/data/ict_dataset.py (numpy
and the native mappings of data/helpers.cpp), so that both packages draw
the same samples, bit for bit, from the same corpus and seed.

- `BertSentencePairDataset`: [CLS] A [SEP] B [SEP] MLM + NSP samples over
  the shuffled (start, end, target length) rows of `build_mapping`;
- `ICTDataset`: a pseudo-query sentence ([CLS] query [SEP]) and the block
  it came from ([CLS] title [SEP] block [SEP]) over the shuffled (start,
  end, document, block id) rows of `build_blocks_mapping`; with
  probability `query_in_block_prob` the query stays in its block.

`sentences[i]` returns the token ids of sentence i; `docs` is the
[n_docs + 1] offsets array of each document's sentences (an indexed
dataset's `doc_idx`). Each sample draws from a RandomState seeded with
seed + index.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from megatron_tpu_torch.data.helpers import (build_blocks_mapping_native,
                                       build_mapping_native)
from megatron_tpu_torch.data.masked_dataset import create_masked_lm_predictions


def _split_a_b(sents: list, rng: np.random.RandomState):
    """(ref: dataset_utils.py:95-124 get_a_and_b_segments): random split
    point, 50% A/B swap -> is_next_random."""
    n = len(sents)
    assert n > 1, "sentence-pair samples need >= 2 sentences"
    a_end = 1
    if n >= 3:
        a_end = int(rng.randint(1, n))
    a = [t for s in sents[:a_end] for t in s]
    b = [t for s in sents[a_end:] for t in s]
    is_random = False
    if rng.random() < 0.5:
        is_random = True
        a, b = b, a
    return a, b, is_random


def _truncate_pair(a: list, b: list, budget: int,
                   rng: np.random.RandomState):
    """(ref: dataset_utils.py truncate_segments): trim the longer segment
    one token at a time, from front or back at random."""
    while len(a) + len(b) > budget:
        seg = a if len(a) >= len(b) else b
        if rng.random() < 0.5:
            seg.pop(0)
        else:
            seg.pop()
    return a, b


class BertSentencePairDataset:
    """[CLS] A [SEP] B [SEP] MLM+NSP samples drawn through the native
    sentence-pair mapping (ref: bert_dataset.py:25-180)."""

    def __init__(self, sentences, docs: np.ndarray, *, num_epochs: int,
                 max_num_samples: int, max_seq_length: int,
                 short_seq_prob: float, vocab_size: int, cls_id: int,
                 sep_id: int, mask_id: int, pad_id: int, seed: int = 1234,
                 masked_lm_prob: float = 0.15, sizes=None):
        self.sentences = sentences
        self.max_seq_length = max_seq_length
        self.vocab_size = vocab_size
        self.cls_id, self.sep_id = cls_id, sep_id
        self.mask_id, self.pad_id = mask_id, pad_id
        self.seed = seed
        self.masked_lm_prob = masked_lm_prob
        # sizes: pass the indexed dataset's precomputed array at scale —
        # deriving it loads every sentence up front
        if sizes is None:
            sizes = [len(sentences[i]) for i in range(int(docs[-1]))]
        sizes = np.asarray(sizes, np.int32)
        self.mapping = build_mapping_native(
            docs, sizes, num_epochs=num_epochs,
            max_num_samples=max_num_samples,
            # -3 for [CLS] .. [SEP] .. [SEP] (ref: bert_dataset.py:47)
            max_seq_length=max_seq_length - 3,
            short_seq_prob=short_seq_prob, seed=seed)

    def __len__(self):
        return len(self.mapping)

    def __getitem__(self, idx):
        start, end, target_len = (int(x) for x in self.mapping[idx])
        rng = np.random.RandomState((self.seed + idx) % 2**32)
        sents = [list(np.asarray(self.sentences[i], np.int64))
                 for i in range(start, end)]
        a, b, is_random = _split_a_b(sents, rng)
        a, b = _truncate_pair(a, b, target_len, rng)
        if not b:
            b = [a.pop()] if len(a) > 1 else [self.sep_id]
        tokens = np.asarray([self.cls_id] + a + [self.sep_id] + b
                            + [self.sep_id], np.int64)
        tokentype = np.concatenate([np.zeros(len(a) + 2, np.int64),
                                    np.ones(len(b) + 1, np.int64)])
        masked, labels, loss_mask = create_masked_lm_predictions(
            tokens, self.vocab_size, self.mask_id, rng,
            self.masked_lm_prob, special_ids=(self.cls_id, self.sep_id))
        L = self.max_seq_length
        out = {
            "tokens": np.full(L, self.pad_id, np.int64),
            "tokentype_ids": np.zeros(L, np.int64),
            "labels": np.zeros(L, np.int64),
            "loss_mask": np.zeros(L, np.float32),
            "padding_mask": np.zeros(L, np.int64),
            "is_random": np.int64(is_random),
        }
        n = len(tokens)
        out["tokens"][:n] = masked
        out["tokentype_ids"][:n] = tokentype
        out["labels"][:n] = np.where(labels < 0, 0, labels)
        out["loss_mask"][:n] = loss_mask
        out["padding_mask"][:n] = 1
        return out


class ICTDataset:
    """Inverse-cloze-task samples: a pseudo-query sentence and the block it
    came from (ref: megatron/data/ict_dataset.py:50-137).

    `titles[d]` returns the title token ids of document d (or None to skip
    titles). Context layout: [CLS] title [SEP] block [SEP]; query layout:
    [CLS] query [SEP]."""

    def __init__(self, sentences, docs: np.ndarray, titles=None, *,
                 num_epochs: int = 1, max_num_samples: int = 2**62,
                 max_seq_length: int, query_in_block_prob: float = 0.1,
                 cls_id: int, sep_id: int, pad_id: int, seed: int = 1234,
                 use_one_sent_blocks: bool = False, sizes=None,
                 titles_sizes=None):
        self.sentences = sentences
        self.titles = titles
        self.max_seq_length = max_seq_length
        self.query_in_block_prob = query_in_block_prob
        self.cls_id, self.sep_id, self.pad_id = cls_id, sep_id, pad_id
        self.seed = seed
        # sizes: pass the indexed dataset's precomputed array at scale —
        # deriving it loads every sentence up front
        if sizes is None:
            sizes = [len(sentences[i]) for i in range(int(docs[-1]))]
        sizes = np.asarray(sizes, np.int32)
        if titles_sizes is None:
            if titles is not None:
                titles_sizes = [len(titles[d]) for d in range(len(docs) - 1)]
            else:
                titles_sizes = np.zeros(len(docs) - 1, np.int32)
        titles_sizes = np.asarray(titles_sizes, np.int32)
        self.mapping = build_blocks_mapping_native(
            docs, sizes, titles_sizes, num_epochs=num_epochs,
            max_num_samples=max_num_samples,
            # -3 for [CLS] title [SEP] ... [SEP] specials, matching the
            # sentence-pair builder's budget convention
            max_seq_length=max_seq_length - 3,
            seed=seed, use_one_sent_blocks=use_one_sent_blocks)

    def __len__(self):
        return len(self.mapping)

    def _pad(self, toks: list) -> tuple[np.ndarray, np.ndarray]:
        L = self.max_seq_length
        out = np.full(L, self.pad_id, np.int64)
        mask = np.zeros(L, np.int64)
        n = min(len(toks), L)
        out[:n] = toks[:n]
        mask[:n] = 1
        return out, mask

    def __getitem__(self, idx):
        start, end, doc, block_id = (int(x) for x in self.mapping[idx])
        rng = np.random.RandomState((self.seed + idx) % 2**32)
        block = [list(np.asarray(self.sentences[i], np.int64))
                 for i in range(start, end)]
        title = (list(np.asarray(self.titles[doc], np.int64))
                 if self.titles is not None else None)
        title_pad = 3 + len(title) if title is not None else 2

        q_idx = int(rng.randint(0, len(block)))
        if rng.random() < self.query_in_block_prob:
            query = list(block[q_idx])  # query stays in its block
        else:
            query = block.pop(q_idx)
        query = query[:self.max_seq_length - 2]
        flat = [t for s in block for t in s][:self.max_seq_length - title_pad]

        q_toks = [self.cls_id] + query + [self.sep_id]
        if title is not None:
            c_toks = [self.cls_id] + title + [self.sep_id] + flat + \
                [self.sep_id]
        else:
            c_toks = [self.cls_id] + flat + [self.sep_id]
        query_tokens, query_pad_mask = self._pad(q_toks)
        context_tokens, context_pad_mask = self._pad(c_toks)
        return {
            "query_tokens": query_tokens,
            "query_pad_mask": query_pad_mask,
            "context_tokens": context_tokens,
            "context_pad_mask": context_pad_mask,
            "block_data": np.asarray([start, end, doc, block_id], np.int64),
        }
