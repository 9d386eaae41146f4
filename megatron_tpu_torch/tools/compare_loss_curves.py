"""Compare two training logs' loss curves sample for sample (the port of
the root tools/compare_loss_curves.py, standard library only).

Parses the dashboard lines that training/loop.py prints, as the reference
and the JAX package do ("iteration N | consumed samples S | ... | lm loss:
X | ..."), and aligns the two curves at equal consumed-sample counts.

  python -m megatron_tpu_torch.tools.compare_loss_curves ours.log theirs.log \
      [--rtol 0.05] [--max_points 0]

Exit code 0 when every aligned point agrees within rtol, 1 otherwise.
"""
from __future__ import annotations

import argparse
import math
import re
import sys

_LINE = re.compile(
    r"iteration\s+(\d+)(?:\s*/\s*\d+)?\s*\|\s*consumed samples[:]?"
    r"\s*(\d+).*?lm loss[:]?\s*([0-9.eE+-]+|nan|-?inf)", re.IGNORECASE)


def parse_log(path: str) -> dict[int, float]:
    """-> {consumed_samples: lm_loss} (later lines win on duplicates)."""
    out: dict[int, float] = {}
    with open(path, errors="replace") as f:
        for line in f:
            m = _LINE.search(line)
            if m:
                out[int(m.group(2))] = float(m.group(3))
    return out


def compare(a: dict[int, float], b: dict[int, float], rtol: float,
            max_points: int = 0):
    """-> (aligned, worst_rel, n_bad, report_lines)."""
    keys = sorted(set(a) & set(b))
    if max_points:
        keys = keys[:max_points]
    worst, n_bad, lines = 0.0, 0, []
    for s in keys:
        la, lb = a[s], b[s]
        if not (math.isfinite(la) and math.isfinite(lb)):
            # a nan/inf loss anywhere is divergence, never a match
            rel = float("inf")
        else:
            rel = abs(la - lb) / max(abs(lb), 1e-9)
        worst = max(worst, rel)
        flag = ""
        if rel > rtol:
            n_bad += 1
            flag = "  <-- DIVERGED"
        lines.append(f"samples {s:>12}: {la:.6f} vs {lb:.6f} "
                     f"(rel {rel:.4f}){flag}")
    return len(keys), worst, n_bad, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser("compare_loss_curves", description=__doc__)
    p.add_argument("ours")
    p.add_argument("theirs")
    p.add_argument("--rtol", type=float, default=0.05)
    p.add_argument("--max_points", type=int, default=0)
    p.add_argument("--quiet", action="store_true",
                   help="summary line only")
    args = p.parse_args(argv)

    a, b = parse_log(args.ours), parse_log(args.theirs)
    if not a or not b:
        print(f"no dashboard lines parsed ({len(a)} vs {len(b)} points)")
        return 1
    n, worst, n_bad, lines = compare(a, b, args.rtol, args.max_points)
    if not args.quiet:
        for line in lines:
            print(line)
    print(f"{n} aligned points | worst rel diff {worst:.4f} | "
          f"{n_bad} beyond rtol={args.rtol}")
    if n == 0:
        print("no common consumed-sample points — different batch sizes?")
        return 1
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
