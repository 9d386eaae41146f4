"""Find near-duplicate documents via minhash LSH.

The port's copy of the root tools/openwebtext/find_duplicates.py.

Counterpart of ref: tools/openwebtext/find_duplicates.py — same contract:
inputs are (jsonl, url_key) pairs, output is jsonl of
{main_url: [{other_url: jaccard}, ...]} candidate-duplicate records for
group_duplicate_url.py. The minhash fingerprints + banded LSH buckets come
from owt_utils (the reference uses the external mattilyra/LSH package);
bucket members are then verified with exact shingle jaccard, same
main-vs-rest sweep semantics (ref: find_duplicates.py:44-78).

Usage: python -m megatron_tpu_torch.tools.openwebtext.find_duplicates
    --inputs a.jsonl url [b.jsonl url2 ...]
           --output dups.jsonl [--jaccard union|min|max] [--threshold 0.5]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from megatron_tpu_torch.tools.openwebtext.owt_utils import (
    LshIndex, MinHasher, iter_jsonl, jaccard, shingles)


def find_duplicates(inputs, output_path, *, jaccard_mode: str = "union",
                    threshold: float = 0.5, num_perm: int = 128,
                    num_bands: int = 16, char_ngram: int = 5,
                    seed: int = 1234) -> int:
    """Returns the number of detected duplicate urls."""
    hasher = MinHasher(num_perm=num_perm, char_ngram=char_ngram, seed=seed)
    index = LshIndex(num_perm=num_perm, num_bands=num_bands)
    url_doc: dict = {}
    for path, key in inputs:
        for rec in iter_jsonl(path):
            url, text = rec.get(key), rec.get("text", "")
            if url is None or url in url_doc:
                continue
            url_doc[url] = text
            index.add(url, hasher.fingerprint(text))

    rng = np.random.default_rng(seed)
    removed: set = set()
    n_dup = 0
    shingle_cache: dict = {}

    def doc_shingles(url):
        # memoized: a url can appear in buckets of many bands and many
        # sweep rounds; recomputing multi-KB shingle sets would dominate
        if url not in shingle_cache:
            shingle_cache[url] = shingles(url_doc[url], char_ngram)
        return shingle_cache[url]

    with open(output_path, "w", encoding="utf-8") as out:
        for members in index.candidate_buckets():
            bucket = [u for u in members if u not in removed]
            # main-vs-rest sweep: pick a random main url, claim everything
            # similar to it, repeat on the remainder
            while len(bucket) > 1:
                main = bucket[int(rng.integers(len(bucket)))]
                main_sh = doc_shingles(main)
                claimed = []
                rest = []
                for other in bucket:
                    if other == main:
                        continue
                    sim = jaccard(main_sh, doc_shingles(other),
                                  jaccard_mode)
                    if sim > threshold:
                        claimed.append({other: round(sim, 4)})
                        removed.add(other)
                        n_dup += 1
                    else:
                        rest.append(other)
                if claimed:
                    out.write(json.dumps({main: claimed},
                                         ensure_ascii=False) + "\n")
                bucket = rest
    return n_dup


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--inputs", nargs="+", required=True,
                   help="alternating: file1 key1 [file2 key2 ...]")
    p.add_argument("--output", required=True)
    p.add_argument("--jaccard", default="union",
                   choices=["union", "min", "max"])
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--num_perm", type=int, default=128)
    p.add_argument("--num_bands", type=int, default=16)
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)
    assert len(args.inputs) % 2 == 0, "--inputs wants file/key pairs"
    pairs = list(zip(args.inputs[::2], args.inputs[1::2]))
    n = find_duplicates(pairs, args.output, jaccard_mode=args.jaccard,
                        threshold=args.threshold, num_perm=args.num_perm,
                        num_bands=args.num_bands, seed=args.seed)
    print(f"find_duplicates: {n} duplicate urls")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
