"""Zero-shot LM evaluation datasets (tasks/zeroshot_gpt/datasets.py):
WikiText-style rolling windows and LAMBADA last-word prediction.

- LMDataset: one token stream cut into seq_len windows; with an
  overlapping stride below seq_len every window after the first scores
  only its last `stride` targets, so each token is scored once. It keeps
  num_original_tokens (words of the raw text) beside num_tokenized_tokens
  for the adjusted perplexity's token ratio.
- LambadaDataset: context tokens weigh 0 and the final word's tokens 1;
  `strict` tokenizes the last word alone with a leading space (the
  published LAMBADA protocol) instead of trusting the tokenizer's split.

numpy only; evaluate.py batches and runs the model.
"""
from __future__ import annotations

import json
import math
from typing import Iterator, Optional

import numpy as np

from megatron_tpu_torch.tasks.zeroshot_gpt.detokenizer import get_detokenizer


class LMDataset:
    def __init__(self, tokens, seq_len: int, pad_idx: int,
                 num_original_tokens: int, num_tokenized_tokens: int,
                 overlapping_eval: Optional[int] = None):
        self.tokens = list(tokens)
        self.seq_len = seq_len
        self.pad_idx = pad_idx
        self.stride = max(1, overlapping_eval or seq_len)
        self.num_original_tokens = num_original_tokens
        self.num_tokenized_tokens = num_tokenized_tokens
        targets = max(len(self.tokens) - 1 - self.stride, 0)
        self.total_sequences = max(math.ceil(targets / self.stride) + 1, 1)

    def __len__(self):
        return self.total_sequences

    def __getitem__(self, idx):
        lo = idx * self.stride
        window = self.tokens[lo:lo + self.seq_len + 1]
        n = len(window)
        mask = [1] * n + [0] * (self.seq_len + 1 - n)
        window = window + [self.pad_idx] * (self.seq_len + 1 - n)
        mask = np.array(mask[1:], dtype=np.float32)
        if self.stride != self.seq_len and idx != 0:
            mask[:-self.stride] = 0.0  # only the fresh tail counts
        return {"text": np.array(window, dtype=np.int64), "pad_mask": mask}


class LambadaDataset:
    def __init__(self, path: str, pad_idx: int, tokenizer, seq_len: int,
                 strict: bool = False):
        self.seq_len = seq_len
        self.pad_idx = pad_idx
        self.examples = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                text = json.loads(line)["text"]
                self.examples.append(self._split(text, tokenizer, strict))

    @staticmethod
    def _split(text: str, tokenizer, strict: bool):
        if not strict:
            toks = tokenizer.tokenize(text)
            return toks[:-1], [toks[-1]]
        # the last whitespace word, re-tokenized with its leading space
        last = text.split()[-1]
        cut = text.rfind(last)
        ctx = tokenizer.tokenize(text[:cut].strip())
        tgt = tokenizer.tokenize(" " + last)
        return ctx, tgt

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx):
        ctx, tgt = self.examples[idx]
        toks = list(ctx) + list(tgt)
        mask = [0] * len(ctx) + [1] * len(tgt)
        pad = self.seq_len + 1 - len(toks)
        if pad < 0:
            raise ValueError(f"lambada example {idx} longer ({len(toks)}) "
                             f"than seq {self.seq_len}")
        toks = toks + [self.pad_idx] * pad
        mask = mask + [0] * pad
        return {"text": np.array(toks, dtype=np.int64),
                "pad_mask": np.array(mask[1:], dtype=np.float32)}


def build_wikitext_dataset(path: str, tokenizer, seq_len: int,
                           overlapping_eval: Optional[int] = None
                           ) -> LMDataset:
    """The whole file as one stream, detokenized, with the token ratio's
    bookkeeping."""
    with open(path) as f:
        raw = f.read()
    detok = get_detokenizer(path)(raw)
    tokens = tokenizer.tokenize(detok)
    num_original = len(raw.strip().split(" "))
    return LMDataset(tokens, seq_len, pad_idx=0,
                     num_original_tokens=num_original,
                     num_tokenized_tokens=len(tokens),
                     overlapping_eval=overlapping_eval)


def build_lambada_dataset(path: str, tokenizer, seq_len: int,
                          strict: bool = True) -> LambadaDataset:
    return LambadaDataset(path, pad_idx=0, tokenizer=tokenizer,
                          seq_len=seq_len, strict=strict)


def iterate_batches(dataset, batch_size: int) -> Iterator[dict]:
    """Fixed-shape batches: the last one is filled by repeating the final
    example with `valid` 0 and a zeroed mask."""
    n = len(dataset)
    for lo in range(0, n, batch_size):
        idxs = list(range(lo, min(lo + batch_size, n)))
        real = len(idxs)
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        items = [dataset[i] for i in idxs]
        text = np.stack([it["text"] for it in items])
        mask = np.stack([it["pad_mask"] for it in items])
        valid = np.zeros((batch_size,), np.float32)
        valid[:real] = 1.0
        mask = mask * valid[:, None]
        yield {"text": text, "pad_mask": mask, "valid": valid}
