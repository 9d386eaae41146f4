"""Merge every *.json / *.jsonl file in a directory into one jsonl file.

The port's copy of the root tools/openwebtext/merge_jsons.py.

Counterpart of ref: tools/openwebtext/merge_jsons.py.

Usage: python -m megatron_tpu_torch.tools.openwebtext.merge_jsons
    --json_path <dir> --output_file merged.jsonl
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from megatron_tpu_torch.tools.openwebtext.owt_utils import iter_jsonl


def merge(json_path: str, output_file: str) -> int:
    files = sorted(glob.glob(os.path.join(json_path, "*.json"))
                   + glob.glob(os.path.join(json_path, "*.jsonl")))
    n = 0
    with open(output_file, "w", encoding="utf-8") as out:
        for path in files:
            if os.path.abspath(path) == os.path.abspath(output_file):
                continue
            for rec in iter_jsonl(path):
                out.write(json.dumps(rec, ensure_ascii=False) + "\n")
                n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--json_path", default=".")
    p.add_argument("--output_file", default="merged_output.jsonl")
    args = p.parse_args(argv)
    n = merge(args.json_path, args.output_file)
    print(f"merge_jsons: {n} records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
