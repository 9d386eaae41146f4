"""Offline checker of `.idx`/`.bin` indexed-dataset pairs (the port of the
root tools/validate_dataset.py).

Runs the validation `MMapIndexedDataset` performs at open (header magic,
version and dtype code, index sizes against the file, every pointer and
size against the `.bin`, doc_idx bounds and order) without starting a
training job, so a corrupt corpus is caught before the run. The exit code
is nonzero when any prefix fails:

  python -m megatron_tpu_torch.tools.validate_dataset data/corpus_a data/b

Advisory findings beyond the open-time checks: trailing bytes in `.bin`
past the last indexed sequence, and a doc_idx whose first and last entries
do not bracket the sequence table (`--strict_advisory` fails on them).

`--smoke` builds a tiny corpus in a temporary directory, checks that it
validates clean, injects each dataset fault of
`FaultInjector.corrupt_dataset` (truncated `.bin`, garbage `.idx`,
out-of-range pointer) and requires each to be detected with a typed
`DatasetCorruptionError`; it prints one JSON record.

  python -m megatron_tpu_torch.tools.validate_dataset --smoke [--out F]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def check_prefix(prefix: str) -> list:
    """-> list of problem strings (empty = valid). The authoritative
    checks live in MMapIndexedDataset.__init__ (open == validate);
    this adds advisory findings a lenient open tolerates."""
    from megatron_tpu_torch.data.indexed_dataset import (
        DatasetCorruptionError, MMapIndexedDataset, data_file_path,
        index_file_path)

    problems = []
    for p in (index_file_path(prefix), data_file_path(prefix)):
        if not os.path.exists(p):
            problems.append(f"missing file: {p}")
    if problems:
        return problems
    try:
        ds = MMapIndexedDataset(prefix)
    except DatasetCorruptionError as e:
        return [str(e)]
    # advisory: bytes in .bin past the last sequence (harmless to train
    # on, but usually a sign of a mismatched .idx/.bin pair)
    bin_size = os.path.getsize(data_file_path(prefix))
    used = 0
    chunk = 1 << 22  # blockwise: no O(len) int64 temporaries
    for lo in range(0, len(ds), chunk):
        ends = (ds._pointers[lo:lo + chunk]
                + ds.sizes[lo:lo + chunk].astype("int64")
                * ds.dtype.itemsize)
        used = max(used, int(ends.max()))
    if bin_size > used:
        problems.append(
            f"advisory: {bin_size - used} trailing bytes in .bin past "
            "the last indexed sequence (mismatched pair?)")
    if len(ds.doc_idx):
        if int(ds.doc_idx[0]) != 0:
            problems.append(
                f"advisory: doc_idx starts at {int(ds.doc_idx[0])}, "
                "expected 0")
        if int(ds.doc_idx[-1]) != len(ds):
            problems.append(
                f"advisory: doc_idx ends at {int(ds.doc_idx[-1])}, "
                f"expected num_sequences={len(ds)}")
    return problems


def validate(prefixes: list, strict_advisory: bool = False) -> int:
    bad = 0
    for prefix in prefixes:
        problems = check_prefix(prefix)
        hard = [p for p in problems if not p.startswith("advisory:")]
        fail = hard or (strict_advisory and problems)
        status = "CORRUPT" if fail else "OK"
        print(f"{status}: {prefix}")
        for p in problems:
            print(f"  - {p}")
        bad += bool(fail)
    return bad


def run_smoke(workdir: str) -> dict:
    """Build → corrupt → detect, for every injectable dataset fault."""
    from megatron_tpu_torch.data.indexed_dataset import (
        IndexedDatasetBuilder)
    from megatron_tpu_torch.resilience.faults import FaultInjector

    clean = os.path.join(workdir, "clean")
    b = IndexedDatasetBuilder(clean, dtype="int32")
    for i in range(16):
        b.add_item(list(range(i, i + 12)))
        b.end_document()
    b.finalize()
    t0 = time.monotonic()
    clean_ok = not check_prefix(clean)

    detected = FaultInjector.dataset_corruption_drill(workdir)
    wall_s = time.monotonic() - t0
    ok = clean_ok and all(detected.values())
    return {
        "metric": "dataset_validation_smoke",
        "value": sum(detected.values()),
        "unit": f"faults detected of {len(detected)} injected",
        "vs_baseline": None,
        "completed": ok,
        "clean_validates": clean_ok,
        "detected": detected,
        "wall_s": round(wall_s, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("prefixes", nargs="*",
                    help="dataset prefixes (PATH for PATH.idx/PATH.bin)")
    ap.add_argument("--smoke", action="store_true",
                    help="self-test: inject every dataset fault into a "
                         "tiny corpus, prove each is detected")
    ap.add_argument("--strict_advisory", action="store_true",
                    help="advisory findings also fail the check")
    ap.add_argument("--out", type=str, default=None,
                    help="(--smoke) also write the JSON record here")
    args = ap.parse_args(argv)

    if args.smoke:
        workdir = tempfile.mkdtemp(prefix="validate_dataset_")
        try:
            record = run_smoke(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
        return 0 if record["completed"] else 1

    if not args.prefixes:
        ap.error("give at least one dataset prefix (or --smoke)")
    bad = validate(args.prefixes, strict_advisory=args.strict_advisory)
    if bad:
        print(f"{bad}/{len(args.prefixes)} prefixes corrupt", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
