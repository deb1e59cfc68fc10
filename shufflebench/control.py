"""The control of a cell's check, at the cell's own size, on the card.

    python3 -m shufflebench.control --workload <cell> --seeds 1 2 3

For each seed: the cell's inputs, the reference at the next width down
(16-bit keys: ``control`` of the cell's check module) put in the
program's place, and the cell's comparison of it. Every line printed
gives each number beside its limit; the control has to fail at least
one. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from shufflebench import cells, generator


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m shufflebench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("shufflebench.control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = cells.load_cell(args.workload)
    check = cells.check_module(cell.check)
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        inputs = generator.make(cell.traffic, cell.config, seed, device)
        judged, counts = check.control(inputs, cell.config)
        numbers, _ = check.compare(judged, [counts], inputs, cell.config)
        del judged, inputs
        torch.cuda.empty_cache()
        failed = any(numbers[k] > v for k, v in cell.limits.items())
        failed_all &= failed
        print(json.dumps({"workload": cell.name, "seed": seed, "control_failed": failed,
                          "checks": {k: {"value": numbers[k], "limit": v}
                                     for k, v in cell.limits.items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
