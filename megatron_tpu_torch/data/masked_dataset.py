"""Masked-LM datasets: BERT (MLM + NSP) and T5 (span corruption), a copy of
megatron_tpu/data/masked_dataset.py (numpy only), so that both packages
draw the same samples, bit for bit, from the same corpus and seed.

- `create_masked_lm_predictions`: 15% of the non-special tokens are picked
  for prediction; of those 80% become [MASK], 10% a random token, 10% stay;
- `BertDataset`: [CLS] A [SEP] B [SEP] pairs from document halves, B
  replaced by half of a random document with probability 1/2 (the NSP
  label `is_random`);
- `T5Dataset`: spans (Poisson lengths, mean 3) replaced by sentinel ids in
  the encoder text; the decoder emits sentinel + span ... [EOS].

Pairs and spans are drawn at `__getitem__` time from a RandomState seeded
with seed + index: deterministic given (seed, index), with no index-build
pass.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def create_masked_lm_predictions(
    tokens: np.ndarray,
    vocab_size: int,
    mask_id: int,
    rng: np.random.RandomState,
    masked_lm_prob: float = 0.15,
    max_predictions: Optional[int] = None,
    special_ids: Sequence[int] = (),
):
    """(ref: dataset_utils.py create_masked_lm_predictions). Returns
    (masked_tokens, labels, loss_mask): labels hold the original token at
    masked positions, -1 elsewhere (callers build their own loss mask)."""
    tokens = np.asarray(tokens)
    n = len(tokens)
    cand = np.asarray([i for i in range(n) if tokens[i] not in special_ids])
    num_pred = max(1, int(round(len(cand) * masked_lm_prob)))
    if max_predictions is not None:
        num_pred = min(num_pred, max_predictions)
    picked = rng.choice(cand, size=min(num_pred, len(cand)), replace=False)

    masked = tokens.copy()
    labels = np.full(n, -1, np.int64)
    loss_mask = np.zeros(n, np.float32)
    for i in picked:
        labels[i] = tokens[i]
        loss_mask[i] = 1.0
        r = rng.random()
        if r < 0.8:
            masked[i] = mask_id
        elif r < 0.9:
            masked[i] = rng.randint(0, vocab_size)
        # else keep original
    return masked, labels, loss_mask


class BertDataset:
    """Sentence-pair MLM+NSP samples (ref: megatron/data/bert_dataset.py).

    Emits {tokens, tokentype_ids, labels, loss_mask, padding_mask,
    is_random} with [CLS] A [SEP] B [SEP] packing."""

    def __init__(self, indexed, num_samples: int, max_seq_length: int,
                 vocab_size: int, cls_id: int, sep_id: int, mask_id: int,
                 pad_id: int, seed: int = 1234,
                 masked_lm_prob: float = 0.15):
        self.indexed = indexed
        self.num_samples = num_samples
        self.max_seq_length = max_seq_length
        self.vocab_size = vocab_size
        self.cls_id, self.sep_id = cls_id, sep_id
        self.mask_id, self.pad_id = mask_id, pad_id
        self.seed = seed
        self.masked_lm_prob = masked_lm_prob
        self.n_docs = len(indexed)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + int(idx))
        doc_a = int(rng.randint(self.n_docs))
        a = np.asarray(self.indexed[doc_a], np.int64)
        half = max(len(a) // 2, 1)
        is_random = int(rng.random() < 0.5)  # (ref: bert_dataset NSP 50/50)
        if is_random:
            doc_b = int(rng.randint(self.n_docs))
            b = np.asarray(self.indexed[doc_b], np.int64)
            b = b[:max(len(b) // 2, 1)]
            a = a[:half]
        else:
            b = a[half:]
            a = a[:half]
        # truncate pair to fit [CLS] A [SEP] B [SEP]
        budget = self.max_seq_length - 3
        while len(a) + len(b) > budget:
            if len(a) >= len(b):
                a = a[:-1]
            else:
                b = b[:-1]
        if len(b) == 0:
            b = np.asarray([self.sep_id])
        tokens = np.concatenate([[self.cls_id], a, [self.sep_id], b,
                                 [self.sep_id]])
        tokentype = np.concatenate([np.zeros(len(a) + 2, np.int64),
                                    np.ones(len(b) + 1, np.int64)])
        special = (self.cls_id, self.sep_id)
        masked, labels, loss_mask = create_masked_lm_predictions(
            tokens, self.vocab_size, self.mask_id, rng,
            self.masked_lm_prob, special_ids=special)
        L = self.max_seq_length
        out = {
            "tokens": np.full(L, self.pad_id, np.int64),
            "tokentype_ids": np.zeros(L, np.int64),
            "labels": np.full(L, -1, np.int64),
            "loss_mask": np.zeros(L, np.float32),
            "padding_mask": np.zeros(L, np.int64),
            "is_random": np.int64(is_random),
        }
        n = len(tokens)
        out["tokens"][:n] = masked
        out["tokentype_ids"][:n] = tokentype
        out["labels"][:n] = labels
        out["loss_mask"][:n] = loss_mask
        out["padding_mask"][:n] = 1
        # labels must be valid gather indices even where unused
        out["labels"][out["labels"] < 0] = 0
        return out


class T5Dataset:
    """Span-corruption samples (ref: megatron/data/t5_dataset.py).

    Emits {text_enc, text_dec, labels, loss_mask, enc_mask}: encoder sees
    the text with spans replaced by sentinels; decoder emits
    sentinel+span... [EOS]."""

    def __init__(self, indexed, num_samples: int, max_seq_length: int,
                 max_seq_length_dec: int, vocab_size: int,
                 sentinel_ids: Sequence[int], bos_id: int, eos_id: int,
                 pad_id: int, seed: int = 1234,
                 masked_lm_prob: float = 0.15, mean_span: int = 3):
        self.indexed = indexed
        self.num_samples = num_samples
        self.L_enc = max_seq_length
        self.L_dec = max_seq_length_dec
        self.vocab_size = vocab_size
        self.sentinels = list(sentinel_ids)
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.seed = seed
        self.masked_lm_prob = masked_lm_prob
        self.mean_span = mean_span
        self.n_docs = len(indexed)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + int(idx))
        doc = np.asarray(self.indexed[int(rng.randint(self.n_docs))],
                         np.int64)
        doc = doc[:self.L_enc - 1]
        n = len(doc)
        num_mask = max(1, int(round(n * self.masked_lm_prob)))
        # draw spans until the mask budget is spent
        spans = []
        covered = np.zeros(n, bool)
        budget = num_mask
        tries = 0
        while budget > 0 and tries < 100:
            tries += 1
            ln = max(1, int(rng.poisson(self.mean_span)))
            ln = min(ln, budget)
            start = int(rng.randint(0, max(n - ln, 1)))
            if covered[start:start + ln].any():
                continue
            covered[start:start + ln] = True
            spans.append((start, ln))
            budget -= ln
        spans.sort()

        enc, dec = [], [self.bos_id]
        prev = 0
        for si, (start, ln) in enumerate(spans[:len(self.sentinels)]):
            sentinel = self.sentinels[si]
            enc.extend(doc[prev:start])
            enc.append(sentinel)
            dec.append(sentinel)
            dec.extend(doc[start:start + ln])
            prev = start + ln
        enc.extend(doc[prev:])
        dec.append(self.eos_id)

        labels = dec[1:] + [self.pad_id]
        out = {
            "text_enc": np.full(self.L_enc, self.pad_id, np.int64),
            "text_dec": np.full(self.L_dec, self.pad_id, np.int64),
            "labels": np.full(self.L_dec, self.pad_id, np.int64),
            "loss_mask": np.zeros(self.L_dec, np.float32),
            "enc_mask": np.zeros(self.L_enc, np.int64),
        }
        ne, nd = min(len(enc), self.L_enc), min(len(dec), self.L_dec)
        out["text_enc"][:ne] = enc[:ne]
        out["enc_mask"][:ne] = 1
        out["text_dec"][:nd] = dec[:nd]
        out["labels"][:nd] = labels[:nd]
        out["loss_mask"][:nd] = 1.0
        return out
