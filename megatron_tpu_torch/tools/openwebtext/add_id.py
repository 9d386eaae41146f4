"""Add sequential ids to a jsonl corpus.

The port's copy of the root tools/openwebtext/add_id.py.

Counterpart of ref: tools/openwebtext/add_id.py — each record gains
{"id": "<prefix>-<n>"} (prefix via --id_prefix).

Usage: python -m megatron_tpu_torch.tools.openwebtext.add_id
    --input_file in.jsonl --output_file out.jsonl
           [--id_prefix corpusname]
"""
from __future__ import annotations

import argparse
import json

from megatron_tpu_torch.tools.openwebtext.owt_utils import iter_jsonl


def add_ids(input_path: str, output_path: str, prefix: str = "") -> int:
    n = 0
    with open(output_path, "w", encoding="utf-8") as out:
        for i, rec in enumerate(iter_jsonl(input_path)):
            rec["id"] = f"{prefix}-{i}" if prefix else str(i)
            out.write(json.dumps(rec, ensure_ascii=False) + "\n")
            n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--input_file", required=True)
    p.add_argument("--output_file", required=True)
    p.add_argument("--id_prefix", default="")
    args = p.parse_args(argv)
    n = add_ids(args.input_file, args.output_file, args.id_prefix)
    print(f"add_id: {n} records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
