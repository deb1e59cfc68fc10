"""One run of one cell, start to result line.

1. Find the cell's files (``cells.py``); fail, printing no result, when
   the process sees no CUDA device or fewer than the cell asks for.
2. Set-up: the inputs from ``--seed`` on the card (``generator.py``),
   the entry's own set-up, ``WARM_STAGES`` stages at the cell's shapes.
   ``setup_s`` runs from the start of the process to here.
3. The window: stages back to back for ``--seconds`` (the last one
   started before the close runs to its end), the peak device memory
   reset at its start. Each stage is timed on the host clock and by
   CUDA events from its issue to its last device work. The output of
   one stage, drawn from the seed among the first ``SAMPLE_BELOW``, is
   kept for the check; every stage's counts are kept.
4. With ``--trace 1``: two traced stretches of ``TRACE_STAGES`` stages
   after the window: one with host and CUDA activity (busy time, idle
   share, top device ops), one with the package's Python frames as
   annotations besides (device time by the package module that
   launched it, idle gaps by what the host was doing).
5. The program's state is freed, the reference (``reference/``)
   judges the kept output and the counts, every number compared is
   printed beside its limit, and the result line comes last on
   standard output. A run in whose process ``jax``, ``jaxlib``,
   ``flax`` or ``sparkrdma_tpu`` was loaded prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from shufflebench import cells, generator, trace

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sparkrdma_tpu"})
EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 5
WARM_STAGES = 2  # the first stage allocates and picks kernels; the second runs warm
SAMPLE_BELOW = 8  # the checked stage is one of the window's first 8
TRACE_STAGES = 24  # stages in each traced stretch (20 or more, as the layers need)


def log(msg: str) -> None:
    print(f"shufflebench: {msg}", file=sys.stderr, flush=True)


def forbidden_loaded() -> List[str]:
    """Top-level names of ``sys.modules`` that the run must not load,
    compared whole (``sparkrdma_tpu_torch`` is not ``sparkrdma_tpu``)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FORBIDDEN)


def pin_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's
    own library builds into ``build/torch_kernels/`` by itself)."""
    base = cells.CHECKOUT / "build" / "shufflebench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


@dataclass
class Stage:
    wall_s: float  # host clock, issue to the return after the sync
    device_s: Optional[float]  # CUDA events, issue to the last device work
    enqueue_s: float
    ok: bool
    bytes: int
    counts: list


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: cells.Cell
    seed: int
    setup_s: float
    window_s: float
    stages: List[Stage]
    peak_bytes: Optional[int]
    device_kind: Optional[str]
    stage_bytes: int
    traced: Optional[dict] = None
    notes: Dict[str, object] = field(default_factory=dict)


def window(entry, seconds: float, sample_at: int, timed: bool):
    """Stages back to back for ``seconds``; returns ``(stages, kept
    output, window seconds)``."""
    import torch

    stages: List[Stage] = []
    held = None
    t_w0 = time.perf_counter()
    stop = t_w0 + seconds
    while True:
        start = end = None
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = entry.stage(end)
        t1 = time.perf_counter()
        stages.append(Stage(
            wall_s=t1 - t0,
            device_s=start.elapsed_time(end) / 1e3 if timed else None,
            enqueue_s=out.enqueue_s, ok=out.ok,
            bytes=entry.stage_bytes if out.ok else 0,
            counts=out.counts))
        if len(stages) - 1 <= sample_at:
            held = out.output
        del out
        if t1 >= stop:
            break
    return stages, held, time.perf_counter() - t_w0


def stretches(entry, sync: Callable[[], None]) -> dict:
    """The two traced stretches after the window (step 4)."""
    def one():
        entry.stage(None)

    a = trace.capture(one, TRACE_STAGES, frames=False, sync=sync)
    b = trace.capture(one, TRACE_STAGES, frames=True, sync=sync)
    return {"a": a, "b": b, "by_module_ns": trace.by_module(b.events)}


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device``. Returns ``{"run", "numbers",
    "correct", "attempted", "failed"}``; the CLI prints it, the tests
    read it (on the CPU, with no device timing)."""
    import torch

    timed = device.type == "cuda"

    def sync():
        if timed:
            torch.cuda.synchronize(device)

    check = cells.check_module(cell.check)
    t0 = time.perf_counter()
    inputs = generator.make(cell.traffic, cell.config, seed, device)
    sync()
    t1 = time.perf_counter()
    entry = cells.entry_module(cell.entry).Entry(cell, inputs, device)
    try:
        sync()
        t2 = time.perf_counter()
        for _ in range(WARM_STAGES):
            entry.stage(None)
        sync()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.6f} s: to the first input {t0 - t_start:.6f} (imports, "
            f"CUDA), inputs {t1 - t0:.6f}, entry {t2 - t1:.6f}, "
            f"{WARM_STAGES} warm stages {t_start + setup_s - t2:.6f}")
        sample_at = random.Random(seed).randrange(SAMPLE_BELOW)
        if timed:
            torch.cuda.reset_peak_memory_stats(device)
        stages, held, window_s = window(entry, seconds, sample_at, timed)
        sync()
        peak = torch.cuda.max_memory_allocated(device) if timed else None
        kind = torch.cuda.get_device_name(device) if timed else None
        run = Run(cell=cell, seed=seed, setup_s=setup_s, window_s=window_s,
                  stages=stages, peak_bytes=peak, device_kind=kind,
                  stage_bytes=entry.stage_bytes)
        run.notes["sample_stage"] = min(sample_at, len(stages) - 1)
        if traced and timed:
            run.traced = stretches(entry, sync)
        judged = entry.judged(held)
    finally:
        entry.close()
    numbers, failed_stages = check.compare(
        judged, [s.counts for s in stages if s.ok], inputs, cell.config)
    correct = bool(stages) and all(
        name in numbers and numbers[name] <= limit for name, limit in cell.limits.items())
    return {"run": run, "numbers": numbers, "correct": correct,
            "attempted": len(stages),
            "failed": sum(not s.ok for s in stages) + int(failed_stages)}


def metric_values(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = cells.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m shufflebench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(res: dict, cell: cells.Cell, traced: bool) -> dict:
    """The result line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (the cell's end-to-end metrics, or with ``traced`` its
    per-layer ones), ``device``, with ``traced`` ``breakdown``, and last
    ``checks``: each number compared beside its limit."""
    run: Run = res["run"]
    device_info = {"platform": "gpu", "kind": run.device_kind, "count": cell.chips,
                   "memory_peak_bytes": run.peak_bytes}
    result = {"correct": res["correct"], "attempted": res["attempted"],
              "failed": res["failed"],
              "metrics": metric_values(run, cell.per_layer if traced else cell.end_to_end),
              "device": device_info}
    if run.traced is not None:
        a, b = run.traced["a"], run.traced["b"]
        device_info["busy_s"] = trace.union_ns(a.events) / 1e9
        device_info["window_s"] = a.stretch_s
        mods = run.traced["by_module_ns"]
        total = sum(mods.values()) or 1
        log("traced device time by module (ms a stage): " + ", ".join(
            f"{k} {v / 1e6 / b.stages:.4f}"
            for k, v in sorted(mods.items(), key=lambda kv: -kv[1])))
        log(f"share of device time with no package frame ('other'): "
            f"{mods.get(trace.OTHER, 0) / total:.6f}")
        result["breakdown"] = {"device_ops": trace.top_device_ops(a.events),
                               "idle_gaps": trace.gaps_by_host(b.events)}
    result["checks"] = {k: {"value": res["numbers"].get(k), "limit": v}
                        for k, v in cell.limits.items()}
    return result


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    cell = cells.load_cell(args.workload)
    pin_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this process sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return EXIT_NO_CARD
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    run: Run = res["run"]
    walls = [s.wall_s for s in run.stages]
    log(f"{cell.name} seed {args.seed}: {len(run.stages)} stages in {run.window_s:.6f} s "
        f"(stage walls {min(walls):.6f}..{max(walls):.6f} s), set-up {run.setup_s:.6f} s, "
        f"sample stage {run.notes['sample_stage']}, card {power_limit()}")
    result = result_line(res, cell, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        log(f"modules that must not load were loaded: {', '.join(bad)}: no result")
        return EXIT_FORBIDDEN
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
