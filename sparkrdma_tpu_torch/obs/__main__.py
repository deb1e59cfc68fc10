"""``python -m sparkrdma_tpu_torch.obs`` — dump the unified metrics registry.

Without flags this prints the process-wide registry snapshot as JSON
(empty unless something in this process has run shuffle code first,
which is why ``--demo`` exists: it drives a small in-process cluster
shuffle — driver + two executors over real TCP, wrapper writer method
— so every layer's counters populate). ``--trace-out PATH`` also
exports the span trace as Chrome trace-event JSON (open in Perfetto or
chrome://tracing).

Telemetry-plane egress: ``--openmetrics [DEST]`` renders the
OpenMetrics text exposition instead of the JSON dump ('-' or no value
= stdout), from the live registry or — with ``--from-snapshot FILE`` —
from a registry snapshot saved inside a bench/workload artifact JSON.
``--flight-recorder FILE`` pretty-prints a flight-record artifact
(obs/telemetry.py) and exits. ``--critical-path FILE`` replays the
critical-path attribution (obs/critpath.py) over a saved Chrome trace,
or prints the ``breakdown`` stored in a bench/flight artifact.
``--diagnose FILE`` renders SLO breach diagnoses (obs/diagnose.py)
from a standalone diagnosis artifact, a flight record's ``slo``
section, or a soak ledger's ``slo.diagnosis_records``.
``--timeline FILE`` renders the causally-ordered incident timeline
(obs/journal.py) from any artifact carrying journal events — a flight
record, a soak ledger, a live snapshot, or a bare event list.

Continuous profiling (obs/profiler.py): ``--demo`` runs under the
default sampling profiler, and ``--flamegraph [DEST]`` /
``--folded [DEST]`` render the merged samples as a self-contained HTML
flamegraph / collapsed-stack text ('-' = stdout). Saved flight records
carry per-executor profile windows, so both flags also accept
``--from-snapshot FLIGHT.json`` as their sample source.

The demo exercises the host shuffle planes (transport, rpc, writer,
mempool, reader) only.

A copy of the JAX package's ``obs/__main__.py``, its imports rewritten
to this package (the flamegraph's title still names ``sparkrdma_tpu``,
as the OpenMetrics ``# HELP`` text does, so both CLIs render alike). Run
as ``python -m sparkrdma_tpu_torch.obs``. No flag loads the device
plane: the CLI never initialises CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys

from sparkrdma_tpu_torch.obs import export_chrome_trace, get_registry
from sparkrdma_tpu_torch.obs.export import extract_snapshot, render_openmetrics
from sparkrdma_tpu_torch.obs.profiler import ProfileHub


def _run_demo() -> "ProfileHub":
    from sparkrdma_tpu_torch.obs import journal as journal_mod
    from sparkrdma_tpu_torch.obs.capacity import CapacityPlane
    from sparkrdma_tpu_torch.obs.journal import render_timeline
    from sparkrdma_tpu_torch.obs.metrics import get_registry as _get_registry
    from sparkrdma_tpu_torch.obs.profiler import acquire_profiler, release_profiler
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    conf = TpuShuffleConf(
        {
            "tpu.shuffle.shuffleWriteMethod": "wrapper",
            "tpu.shuffle.shuffleWriteBlockSize": "65536",
            "tpu.shuffle.shuffleReadBlockSize": "65536",
            # sample fast enough that even this sub-second demo folds a
            # non-trivial profile (default 19 Hz targets long-lived jobs)
            "tpu.shuffle.obs.profile.hz": "199",
        }
    )
    profiler = acquire_profiler(conf, role="proc")
    # arm the event journal before the shuffle so every control-plane
    # transition site that fires lands in the demo timeline
    journal_mod.configure(conf, role="proc")
    driver = TpuShuffleManager(conf, is_driver=True)
    ex0 = TpuShuffleManager(conf, is_driver=False, executor_id="exec-0")
    ex1 = TpuShuffleManager(conf, is_driver=False, executor_id="exec-1")
    try:
        handle = BaseShuffleHandle(
            shuffle_id=0, num_maps=2, partitioner=HashPartitioner(2)
        )
        driver.register_shuffle(handle)
        records = [(f"key-{i % 97}", i) for i in range(500)]
        for map_id, ex in [(0, ex0), (1, ex1)]:
            w = ex.get_writer(handle, map_id)
            w.write(iter(records))
            w.stop(True)
        ex0.finalize_maps(0)
        ex1.finalize_maps(0)
        for ex, (lo, hi) in [(ex0, (0, 1)), (ex1, (1, 2))]:
            for _ in ex.get_reader(handle, lo, hi).read():
                pass
        if profiler is not None:
            profiler.sample_once()  # at least one sample, however fast
    finally:
        ex0.stop()
        ex1.stop()
        driver.stop()
    # exercise the PR-20 planes: one USE evaluation (capacity.* gauges
    # land in the registry dump below) and the incident timeline —
    # stderr only, the stdout contract is still pure JSON
    cap = CapacityPlane(conf, _get_registry(), role="proc")
    cap.evaluate()
    rep = cap.capacity_report(refresh=False)
    binding = rep.get("binding") or {}
    if binding:
        print(
            f"capacity: binding={binding.get('resource')} "
            f"headroom={binding.get('headroom', 1.0):.0%} over "
            f"{len(rep.get('resources', {}))} resources",
            file=sys.stderr,
        )
    j = journal_mod.active_journal()
    if j is not None and j.events():
        print(render_timeline(j.events(), limit=20), file=sys.stderr)
    hub = ProfileHub()
    hub.ingest_local(profiler, "proc")
    release_profiler(profiler)
    return hub


def _print_flight(path: str) -> int:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("kind") != "sparkrdma_flight_record":
        print(f"{path}: not a flight record (kind={doc.get('kind')!r})",
              file=sys.stderr)
        return 2
    print(f"flight record v{doc.get('version')} — {doc.get('reason')} "
          f"(role {doc.get('role')}, wall {doc.get('generated_wall_ms')} ms)")
    err = doc.get("error")
    if err:
        print(f"  error: {err.get('type')}: {err.get('message')}")
    failed = doc.get("failed_group")
    if failed:
        inner = ", ".join(f"{k}={v}" for k, v in sorted(failed.items()))
        print(f"  failed group: {inner}")
    stragglers = (doc.get("stragglers") or {}).get("stragglers") or []
    if stragglers:
        print(f"  stragglers: {', '.join(stragglers)}")
    health = doc.get("source_health") or {}
    for peer, state in sorted(health.items()):
        print(f"  circuit[{peer}]: {state}")
    execs = doc.get("executors") or {}
    print(f"  executors: {len(execs)} "
          f"(interval {doc.get('interval_ms')} ms)")
    for eid in sorted(execs):
        wins = execs[eid]
        gaps = sum(1 for w in wins if w.get("gap"))
        span = ""
        if wins:
            span = f", wall {wins[0]['wall_ms']}..{wins[-1]['wall_ms']}"
        print(f"    {eid}: {len(wins)} windows, {gaps} gaps{span}")
    profiles = doc.get("profiles") or {}
    if profiles:
        print("  last profile window per executor (obs/profiler.py):")
        for eid in sorted(profiles):
            win = profiles[eid]
            rows = sorted(win.get("rows") or [], key=lambda r: -r[3])
            total = sum(r[3] for r in rows)
            hz = win.get("hz") or 0
            print(f"    {eid}: {total} samples @ {hz:g} Hz")
            for tenant, cat, stack, n in rows[:3]:
                leaf = ";".join(stack.split(";")[-2:])
                print(f"      {n:6d}  [{tenant}|{cat}] {leaf}")
    print(f"  spans captured: {len(doc.get('spans') or [])}")
    return 0


def _print_diagnosis(path: str) -> int:
    """Render every diagnosis artifact reachable from ``path``: a
    standalone ``sparkrdma_diagnosis`` JSON, a flight record (its
    ``slo`` section), or a soak/bench ledger (``["slo"]``)."""
    from sparkrdma_tpu_torch.obs.diagnose import render

    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        print(f"{path}: not a JSON object", file=sys.stderr)
        return 2
    if doc.get("kind") == "sparkrdma_diagnosis":
        print(render(doc))
        return 0
    slo = doc.get("slo") or {}
    breaches = slo.get("breach_records") or []
    diagnoses = slo.get("diagnosis_records") or []
    if not breaches and not diagnoses and "slo" not in doc:
        print(f"{path}: no 'slo' section and not a diagnosis artifact "
              "(kind=sparkrdma_diagnosis)", file=sys.stderr)
        return 2
    print(f"{path}: {slo.get('objectives', 0)} objectives, "
          f"{slo.get('breach_count', len(breaches))} breaches, "
          f"{len(diagnoses)} diagnoses")
    for b in breaches:
        where = f" executor={b['executor']}" if b.get("executor") else ""
        print(f"  breach: {b.get('objective')} [{b.get('severity')}]"
              f"{where} at wall {b.get('wall_ms')} ms")
    for diag in diagnoses:
        print()
        print(render(diag))
    return 0


def _print_timeline(path: str) -> int:
    """Render the causally-ordered incident timeline from any artifact
    carrying journal events (obs/journal.py)."""
    from sparkrdma_tpu_torch.obs.journal import extract_events, render_timeline

    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    events = extract_events(doc)
    if not events:
        print(f"{path}: no journal events found (expected a flight "
              "record, soak ledger, snapshot with a 'journal' key, or "
              "a bare event list)", file=sys.stderr)
        return 2
    print(render_timeline(events))
    return 0


def _hub_from_flight(doc: dict) -> ProfileHub:
    """Rebuild a ProfileHub from a flight record's profile windows."""
    hub = ProfileHub()
    for eid, win in (doc.get("profiles") or {}).items():
        hub.ingest(eid, {"hz": win.get("hz"), "rows": win.get("rows")},
                   wall_ms=win.get("wall_ms"))
    return hub


def _print_critical_path(path: str, top: int = 12) -> int:
    from sparkrdma_tpu_torch.obs.attr import attribute
    from sparkrdma_tpu_torch.obs.critpath import extract, spans_from_chrome

    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "traceEvents" in doc:
        spans = spans_from_chrome(doc)
        if not spans:
            print(f"{path}: no spans carry args.span_id — exported by an "
                  "older to_chrome_trace?", file=sys.stderr)
            return 2
        jobs = [p for p in spans if p.name == "job.run"]
        if jobs:
            job = max(jobs, key=lambda p: p.t1)
            t0, t1, exclude = job.t0, job.t1, {job.span_id}
            print(f"window: job.run span {job.span_id}")
        else:
            t0 = min(p.t0 for p in spans)
            t1 = max(p.t1 for p in spans)
            exclude = set()
            print("window: full trace extent (no job.run span found)")
        cp = extract(spans, t0, t1, exclude=exclude)
        print(attribute(cp, top_segments=top).render())
        print("top segments:")
        for seg in cp.top_segments(top):
            label = seg.name if seg.kind == "span" else "(idle/untraced)"
            role = f" [{seg.role}]" if seg.role else ""
            print(f"  {seg.dur_s * 1e3:10.3f} ms  {label}{role}")
        return 0
    bd = doc.get("breakdown") if isinstance(doc, dict) else None
    if bd:
        print(f"stored breakdown: wall {bd.get('wall_ms')} ms, "
              f"coverage {float(bd.get('coverage', 0.0)) * 100:.1f}%")
        cats = bd.get("categories_ms") or {}
        for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
            print(f"  {cat:<16} {ms:10.3f} ms")
        segs = bd.get("critical_path") or []
        if segs:
            print("top segments:")
            for seg in segs[:top]:
                label = seg.get("name") or "(idle/untraced)"
                print(f"  {seg.get('ms', 0.0):10.3f} ms  {label}")
        return 0
    print(f"{path}: neither a Chrome trace (traceEvents) nor an artifact "
          "with a stored 'breakdown'", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkrdma_tpu_torch.obs",
        description="dump the unified metrics registry as JSON",
    )
    ap.add_argument(
        "--demo", action="store_true",
        help="run a small in-process cluster shuffle first so every "
        "layer's counters populate",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="also export the span trace as Chrome trace-event JSON",
    )
    ap.add_argument(
        "--prefix", default=None,
        help="only include metrics whose name starts with this prefix "
        "(e.g. 'transport.')",
    )
    ap.add_argument("--indent", type=int, default=2)
    ap.add_argument(
        "--openmetrics", nargs="?", const="-", default=None, metavar="DEST",
        help="render the OpenMetrics text exposition instead of the JSON "
        "dump; DEST is a file path or '-' for stdout (default)",
    )
    ap.add_argument(
        "--from-snapshot", default=None, metavar="FILE",
        help="with --openmetrics: read the registry snapshot from a saved "
        "JSON (raw snapshot, metrics_snapshot(), or bench artifact with "
        "an 'obs_registry' key) instead of the live registry",
    )
    ap.add_argument(
        "--flight-recorder", default=None, metavar="FILE",
        help="pretty-print a flight-record JSON artifact and exit",
    )
    ap.add_argument(
        "--critical-path", default=None, metavar="FILE",
        help="print the critical-path TimeBreakdown and top segments from "
        "a saved Chrome trace (traceEvents) or from the 'breakdown' stored "
        "in a bench/flight artifact, then exit",
    )
    ap.add_argument(
        "--diagnose", default=None, metavar="FILE",
        help="render SLO breach diagnoses from a diagnosis artifact, a "
        "flight record, or a soak ledger with an 'slo' section, then exit",
    )
    ap.add_argument(
        "--timeline", default=None, metavar="FILE",
        help="render the causally-ordered journal event timeline from a "
        "flight record, soak ledger, snapshot, or bare event list, then "
        "exit",
    )
    ap.add_argument(
        "--flamegraph", nargs="?", const="-", default=None, metavar="DEST",
        help="render the merged profile samples (from --demo, or the "
        "profile windows of a flight record given via --from-snapshot) as "
        "a self-contained HTML flamegraph; DEST is a file path or '-'",
    )
    ap.add_argument(
        "--folded", nargs="?", const="-", default=None, metavar="DEST",
        help="like --flamegraph but emit flamegraph.pl collapsed-stack "
        "text (executor;tenant:..;span:..;frames count)",
    )
    args = ap.parse_args(argv)

    if args.flight_recorder:
        return _print_flight(args.flight_recorder)
    if args.critical_path:
        return _print_critical_path(args.critical_path)
    if args.diagnose:
        return _print_diagnosis(args.diagnose)
    if args.timeline:
        return _print_timeline(args.timeline)
    hub = None
    if args.demo:
        hub = _run_demo()
    if args.flamegraph is not None or args.folded is not None:
        if hub is None and args.from_snapshot:
            with open(args.from_snapshot, "r", encoding="utf-8") as f:
                hub = _hub_from_flight(json.load(f))
        if hub is None or not hub.total_samples:
            print("no profile samples: run with --demo, or point "
                  "--from-snapshot at a flight record with profile "
                  "windows", file=sys.stderr)
            return 2
        for dest, text in (
            (args.folded, hub.folded()),
            (args.flamegraph,
             hub.flamegraph_html(title="sparkrdma_tpu profile")),
        ):
            if dest is None:
                continue
            if dest == "-":
                sys.stdout.write(text)
            else:
                with open(dest, "w", encoding="utf-8") as f:
                    f.write(text)
                print(f"wrote {dest} ({hub.total_samples} samples, "
                      f"{len(hub.merged_rows())} stacks)")
        return 0
    if args.trace_out:
        export_chrome_trace(args.trace_out)
    if args.openmetrics is not None:
        if args.from_snapshot:
            with open(args.from_snapshot, "r", encoding="utf-8") as f:
                snap = extract_snapshot(json.load(f))
        else:
            snap = get_registry().snapshot(prefix=args.prefix)
        text = render_openmetrics(snap)
        if args.openmetrics == "-":
            sys.stdout.write(text)
        else:
            with open(args.openmetrics, "w", encoding="utf-8") as f:
                f.write(text)
            print(f"wrote {args.openmetrics}")
        return 0
    print(get_registry().to_json(prefix=args.prefix, indent=args.indent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
