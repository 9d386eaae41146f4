"""A synthetic corpus for the pretraining path: a GPT-2 byte-level BPE
vocabulary of a chosen size and a jsonl of random documents, both from a
seed. `chip_smoke.py` and the tests preprocess it with
tools/preprocess_data.py and train on it.

The vocabulary holds the 256 byte tokens, merges of lowercase letters in
rank order (a leading space "Ġ" + letter, letter pairs, space + pair,
triples, ...) up to the size, and `<|endoftext|>` last; `merges.txt`
matches it. Documents are words of a fixed random lexicon drawn with
Zipf-like frequencies, with punctuation and numbers between them.

  python -m megatron_tpu_torch.tools.synthetic_corpus --out DIR \\
      --vocab_size 32000 --docs 300 --seed 0
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import string

import numpy as np

from megatron_tpu_torch.data.tokenizers import _bytes_to_unicode

EOD = "<|endoftext|>"
SPACE = "Ġ"  # GPT-2's printable stand-in for the space byte


def _merges():
    """(left, right) merges in rank order, without end."""
    letters = string.ascii_lowercase
    yield from ((SPACE, c) for c in letters)
    yield from itertools.product(letters, letters)
    yield from ((SPACE + a, b) for a, b in itertools.product(letters,
                                                             letters))
    yield from ((a + b, c) for a, b, c in itertools.product(letters, letters,
                                                            letters))
    yield from ((SPACE + a + b, c) for a, b, c in itertools.product(
        letters, letters, letters))
    # words of four letters: vocabularies past 36,788 entries (Falcon's
    # 65,024)
    yield from ((SPACE + a + b + c, d) for a, b, c, d in itertools.product(
        letters, letters, letters, letters))


def write_gpt2_vocab(out_dir: str, vocab_size: int = 32000) -> tuple:
    """Write vocab.json (exactly `vocab_size` entries) and merges.txt under
    `out_dir`; returns their paths."""
    byte_tokens = list(_bytes_to_unicode().values())
    n_merges = vocab_size - len(byte_tokens) - 1
    if n_merges < 0:
        raise ValueError(f"vocab_size {vocab_size} below the 257 byte and "
                         "end-of-text tokens")
    merges = list(itertools.islice(_merges(), n_merges))
    if len(merges) < n_merges:
        raise ValueError(f"vocab_size {vocab_size} exceeds the "
                         f"{len(byte_tokens) + len(merges) + 1} tokens this "
                         "generator makes")
    vocab = {tok: i for i, tok in enumerate(byte_tokens)}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab[EOD] = len(vocab)
    assert len(vocab) == vocab_size
    os.makedirs(out_dir, exist_ok=True)
    vocab_file = os.path.join(out_dir, "vocab.json")
    merge_file = os.path.join(out_dir, "merges.txt")
    with open(vocab_file, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(merge_file, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)
    return vocab_file, merge_file


def random_documents(n_docs: int, seed: int, min_words: int = 50,
                     max_words: int = 600, lexicon: int = 4000) -> list:
    """`n_docs` texts of min_words..max_words words each."""
    rng = np.random.RandomState(seed)
    letters = np.array(list(string.ascii_lowercase))
    words = ["".join(rng.choice(letters, size=rng.randint(1, 9)))
             for _ in range(lexicon)]
    p = 1.0 / np.arange(1, lexicon + 1)
    p /= p.sum()
    docs = []
    for _ in range(n_docs):
        n = rng.randint(min_words, max_words + 1)
        picks = rng.choice(lexicon, size=n, p=p)
        parts = []
        for i, w in enumerate(picks):
            parts.append(words[w])
            r = rng.rand()
            if r < 0.05:
                parts[-1] += "."
            elif r < 0.08:
                parts[-1] += ","
            elif r < 0.09:
                parts.append(str(rng.randint(0, 10000)))
        docs.append(" ".join(parts).capitalize())
    return docs


def write_jsonl(path: str, n_docs: int, seed: int, **kw) -> str:
    with open(path, "w", encoding="utf-8") as f:
        for text in random_documents(n_docs, seed, **kw):
            f.write(json.dumps({"text": text}) + "\n")
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--vocab_size", type=int, default=32000)
    p.add_argument("--docs", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    write_gpt2_vocab(args.out, args.vocab_size)
    write_jsonl(os.path.join(args.out, "corpus.jsonl"), args.docs,
                args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
