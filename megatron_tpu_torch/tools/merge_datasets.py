"""Merge the indexed datasets of a directory into one (the port of the root
tools/merge_datasets.py): every `.bin/.idx` pair under --input, in name
order, concatenated by `IndexedDatasetBuilder.merge_file`.

  python -m megatron_tpu_torch.tools.merge_datasets --input shards/ \\
      --output_prefix data/merged
"""
from __future__ import annotations

import argparse
import os
import sys

from megatron_tpu_torch.data.indexed_dataset import (IndexedDatasetBuilder,
                                                     MMapIndexedDataset)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", type=str, required=True,
                   help="directory containing .bin/.idx pairs")
    p.add_argument("--output_prefix", type=str, required=True)
    args = p.parse_args(argv)

    prefixes = sorted(
        os.path.join(args.input, f[:-4])
        for f in os.listdir(args.input)
        if f.endswith(".idx")
        and os.path.exists(os.path.join(args.input, f[:-4] + ".bin")))
    if not prefixes:
        raise FileNotFoundError(f"no .bin/.idx pairs in {args.input}")

    first = MMapIndexedDataset(prefixes[0])
    builder = IndexedDatasetBuilder(args.output_prefix, dtype=first.dtype)
    for prefix in prefixes:
        print(f"merging {prefix}")
        builder.merge_file(prefix)
    builder.finalize()
    out = MMapIndexedDataset(args.output_prefix)
    print(f"done: {len(out)} sequences, "
          f"{int(out.sizes.sum())} tokens -> {args.output_prefix}.bin/.idx")
    return 0


if __name__ == "__main__":
    sys.exit(main())
