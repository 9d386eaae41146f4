"""Preprocess jsonl corpora into the indexed .bin/.idx format.

The port of tools/preprocess_data.py, with the same CLI and the same output
bytes: jsonl in, one tokenized document per json line, optional EOD append,
multiprocess encoding, indexed-dataset output
(--input/--json_keys/--output_prefix/--tokenizer_type/--append_eod/--workers).

  python -m megatron_tpu_torch.tools.preprocess_data --input corpus.jsonl \
      --output_prefix data/corpus --tokenizer_type GPT2BPETokenizer \
      --vocab_file vocab.json --merge_file merges.txt --append_eod
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import time

from megatron_tpu_torch.data.indexed_dataset import (IndexedDatasetBuilder,
                                                     best_fitting_dtype)
from megatron_tpu_torch.data.tokenizers import build_tokenizer

_tok = None
_args = None


def _init_worker(args):
    global _tok, _args
    _args = args
    _tok = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merge_file=args.merge_file, tokenizer_model=args.tokenizer_model,
        vocab_extra_ids=args.vocab_extra_ids)


def _encode(line: str):
    """(ref: tools/preprocess_data.py Encoder.encode)"""
    line = line.strip()
    if not line:
        return None, 0
    data = json.loads(line)
    out = {}
    for key in _args.json_keys:
        text = data[key]
        ids = _tok.tokenize(text)
        if _args.append_eod and ids:
            ids.append(_tok.eod)
        out[key] = ids
    return out, len(line)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--json_keys", nargs="+", default=["text"])
    p.add_argument("--output_prefix", type=str, required=True)
    p.add_argument("--tokenizer_type", type=str,
                   default="SentencePieceTokenizer")
    p.add_argument("--vocab_file", type=str, default=None)
    p.add_argument("--merge_file", type=str, default=None)
    p.add_argument("--tokenizer_model", type=str, default=None)
    p.add_argument("--vocab_extra_ids", type=int, default=0)
    p.add_argument("--append_eod", action="store_true")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--log_interval", type=int, default=10000)
    args = p.parse_args(argv)

    _init_worker(args)
    vocab_size = _tok.vocab_size
    dtype = best_fitting_dtype(vocab_size)

    builders = {
        key: IndexedDatasetBuilder(
            f"{args.output_prefix}_{key}_document"
            if len(args.json_keys) > 1 else f"{args.output_prefix}_document",
            dtype=dtype)
        for key in args.json_keys
    }

    t0 = time.time()
    n = 0
    total_bytes = 0

    def consume(encoded):
        nonlocal n, total_bytes
        for doc, nbytes in encoded:
            total_bytes += nbytes
            if doc is None:
                continue
            for key, ids in doc.items():
                if ids:
                    builders[key].add_item(ids)
                    builders[key].end_document()
            n += 1
            if n % args.log_interval == 0:
                mbs = total_bytes / 1e6 / (time.time() - t0)
                print(f"processed {n} documents ({mbs:.1f} MB/s)")

    with open(args.input, encoding="utf-8") as f:
        if args.workers > 1:
            with mp.Pool(args.workers, initializer=_init_worker,
                         initargs=(args,)) as pool:
                consume(pool.imap(_encode, f, chunksize=32))
        else:
            consume(map(_encode, f))
    for b in builders.values():
        b.finalize()
    print(f"done: {n} documents in {time.time()-t0:.1f}s "
          f"-> {args.output_prefix}*.bin/.idx (dtype {dtype})")


if __name__ == "__main__":
    main()
