#!/usr/bin/env python3
"""Time the engine job of ``chip_smoke.py`` phase 14 (b) with the driver's
telemetry hub on and off, in turns, in one process on one machine.

    python3 scripts/ab_telemetry.py [--records N] [--pairs N] [--filler 0,8000]

The job is HiBench TeraSort small through ``TpuContext(2 executors, 4
task threads)`` (``chip_smoke._en_terasort``: 3,200,000 records of an
int key and 90 bytes, keys from ``default_rng(0)``, the whole output
checked against ``np.sort``). For each ``--filler`` count, that many
counter series without a ``role`` label are first added to the process
registry (a role-filtered heartbeat snapshot carries every series that
lacks the label, so they ride every beat into the hub, as a long-lived
process's series do); then ``--pairs`` pairs run with
``obs.telemetry.enabled`` on and off, the order alternating (on, off,
off, on, ...). Each run's job wall is host clock around ``run_job``.

Prints the card's name and power limit, one JSON line per run (with the
registry's series count and the time of one heartbeat snapshot), and a
last JSON line with each filler's median wall on each side. Run from the
checkout root, on the machine whose card the numbers stand beside;
exits nonzero without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snapshot_ms(reg, n=20):
    t = time.perf_counter()
    for _ in range(n):
        reg.snapshot({"role": "exec-0"})
    return (time.perf_counter() - t) * 1e3 / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=3_200_000)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--filler", default="0,8000",
                    help="comma-separated counts of role-less series to add first")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    import chip_smoke as cs
    from sparkrdma_tpu_torch.obs import get_registry

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    keys = np.random.default_rng(cs.EN_SEED).integers(0, 1 << 32, args.records,
                                                       dtype=np.uint64)
    reg = get_registry()
    walls = {}
    added = 0
    for filler in (int(x) for x in args.filler.split(",")):
        for i in range(added, filler):
            reg.counter("transport.read_bytes", purpose=f"filler-{i}").inc()
        added = max(added, filler)
        series = sum(len(v) for v in reg.snapshot().values())
        for pair in range(args.pairs):
            order = (True, False) if pair % 2 == 0 else (False, True)
            for on in order:
                knobs = {"tpu.shuffle.obs.telemetry.enabled": str(on).lower()}
                run = cs._en_terasort(keys, knobs)
                walls.setdefault((filler, on), []).append(run["wall_s"])
                hub = run["telemetry_hub"]
                print(json.dumps({
                    "filler": filler, "registry_series": series, "hub": on,
                    "pair": pair, "wall_s": run["wall_s"],
                    "snapshot_ms": _snapshot_ms(reg),
                    "hub_windows": hub["executors"] if hub else None,
                    "card": smi}), flush=True)
    print(json.dumps({"card": smi, "records": args.records, "medians": {
        f"filler={f} hub={'on' if on else 'off'}": statistics.median(w)
        for (f, on), w in sorted(walls.items())}}), flush=True)


if __name__ == "__main__":
    main()
