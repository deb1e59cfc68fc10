"""Medians and spreads of result lines, the readings bounds are set from.

    python3 -m shufflebench.spread <file> ...

Each file holds a run's standard output (its last line is the result);
files are grouped by cell (``<cell>.<set>.<seed>.out``, as the runs'
outputs are named) and set. For each cell, set and metric: the values
in seed order, the median and the spread (first to third quartile over
the median, ``statistics.quantiles(values, n=4)``).
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

from shufflebench.stats import quartile_spread


def main(paths) -> int:
    runs = defaultdict(list)
    for p in map(Path, paths):
        lines = p.read_text().strip().splitlines()
        if not lines:
            continue
        cell, st, seed = p.name.rsplit(".", 3)[:3]
        line = json.loads(lines[-1])
        runs[(cell, st)].append((int(seed), line))
    for (cell, st), got in sorted(runs.items()):
        got.sort(key=lambda x: x[0])
        print(f"{cell} {st}: {len(got)} runs, correct {[g['correct'] for _, g in got]}")
        names = sorted({k for _, g in got for k in g["metrics"]})
        for name in names:
            vals = [g["metrics"][name]["value"] for _, g in got if name in g["metrics"]]
            med = statistics.median(vals)
            sp = quartile_spread(vals) if len(vals) >= 2 else float("nan")
            print(f"  {name}: median {med!r} spread {sp:.6f} values {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
