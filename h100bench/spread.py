"""The spread of a cell's end-to-end metrics over sets of runs, as a bound
is set from it:

    python3 h100bench/spread.py SET_A.jsonl [SET_B.jsonl ...]

Each file holds the result lines (run.py's last line) of one set of runs.
For each metric and set: the median, the quartiles (``statistics.quantiles``,
n=4), the spread (interquartile distance over the median) and the spread
with the run farthest from the median left out; then the widest spread
over the sets and five times it, the bound it suggests (never under 1%).
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(vals):
    q1, _, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / statistics.median(vals)


def trimmed(vals):
    med = statistics.median(vals)
    far = max(range(len(vals)), key=lambda i: abs(vals[i] - med))
    rest = vals[:far] + vals[far + 1:]
    return min(spread(vals), spread(rest)) if len(rest) >= 2 else spread(vals)


def main(paths) -> int:
    sets = []
    for p in paths:
        runs = [json.loads(line) for line in open(p) if line.strip()]
        by = defaultdict(list)
        for r in runs:
            if not r.get("correct"):
                print(f"{p}: a run is not correct: {r.get('compared')}")
            for k, v in r["metrics"].items():
                by[k].append(v["value"])
        sets.append(by)
    for k in sorted({k for s in sets for k in s}):
        widest = 0.0
        for p, s in zip(paths, sets):
            vals = s.get(k, [])
            if len(vals) < 2:
                continue
            q1, _, q3 = statistics.quantiles(vals, n=4)
            sp = spread(vals)
            widest = max(widest, sp)
            print(f"{k:16s} {p}: n={len(vals)}"
                  f" median={statistics.median(vals)!r}"
                  f" q1={q1!r} q3={q3!r} spread={sp:.5f}"
                  f" trimmed={trimmed(vals):.5f}")
        print(f"{k:16s} widest spread {widest:.5f} -> 5x = "
              f"{max(5 * widest, 0.01):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
