"""Perf-trend engine over the committed bench ledgers.

Every benchmark round leaves a JSON ledger in the repo root (``BENCH_r01.json``,
``WORKLOADS_r04.json``, ``SOAK_r01.json``, ...).  Those ledgers were written by
different generations of ``bench.py`` and therefore do not share a schema: early
rounds record a single ``terasort_speedup_vs_host_sort`` row, later rounds nest
A/B sections, io_uring probes, and per-workload throughput arrays.  This module
normalizes all of them into one per-metric trajectory:

* every numeric leaf becomes a named series (``bench.native_read_samehost_gbps``,
  ``workloads.pagerank.records_per_s``, ``soak.checks.hwm_flat``, ...),
* booleans are folded to 0/1 so invariant checks chart as step functions,
* known string/list metadata is skipped *loudly* (each skip is recorded with a
  reason in the output), and anything unrecognized is an error — a new ledger
  field must either chart or be explicitly classified, never vanish silently.

Output is ``TREND.json`` (full trajectories + deltas + skip log) and
``TREND.md`` (a markdown table per family).  With ``--check`` the tool exits
nonzero when any tracked throughput row (``gbps`` series from the bench family)
drops, or any tracked latency row (``p99`` series from the soak/workloads
families) *rises*, by more than the regression threshold vs the previous round
it appeared in — or when a ledger row cannot be classified.  CI runs
``--check`` so a perf regression or a schema drift fails the build the same way
a broken test does.

Bench rounds are not all measured on the same machine, so absolute GB/s is
only comparable when the rig is: when both rounds of a bench throughput
series carry the rig probe (``exchange_loopback_gbps`` — a bare loopback
``device_put`` with no shuffle code in it), the gate judges the
roofline-NORMALIZED delta (series value / same-round probe).  A host that
got slower moves every series and the probe together; that is a fact about
the machine, not a code regression.  The probe series itself charts but
never gates, for the same reason.  Rounds without the probe gate on raw
deltas as before.

Run as ``python -m sparkrdma_tpu_torch.obs.trend``.
A copy of the JAX package's ``obs/trend.py``, its imports rewritten to
this package. One cut: the port's CLI writes ``TREND.json`` /
``TREND.md`` only where ``--out`` / ``--md`` name a path; by default it
reads the ledgers and prints the summary.

"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

# Keys whose string values are descriptive metadata, never metrics.  They are
# skipped with reason "string-metadata"; a string under any other key is an
# error so schema drift cannot slip through unseen.
STRING_METADATA_KEYS = {
    "metric",
    "unit",
    "device",
    "note",
    "label",
    "cmd",
    "tail",
    "backend",
    "platform",
    "workload",
    "transport",
    "attn",
    "trace_file",
    "telemetry_timeline",
    "verified",
    "executor_id",
    "map_sorter",
    "gate_skip_reason",
    "resource",  # capacity_report binding/row names (obs/capacity.py)
}

# Numeric keys that describe the run rather than measure it (round index,
# return code, wall-clock stamp, problem size knobs).  Skipped loudly so the
# trajectory only contains rows where "down" can mean "regression".
NUMERIC_METADATA_KEYS = {
    "n",
    "rc",
    "generated_unix",
    "scale",
    "n_keys",
    "read_block_bytes",
    "num_blocks",
    "block_bytes",
    "num_partitions",
    "total_bytes_per_stage",
    "reps",
    "cores",
    "nproc",
    "b",
    "s",
    "d_model",
    "heads",
    "keys",
    "devices",
    "e2e_gb",
}

_LEDGER_RE = re.compile(r"^(BENCH|WORKLOADS|SOAK)_r(\d+)\.json$")

# Gate: a tracked series regressing by more than this fraction vs the previous
# round it appeared in fails --check.  Tracked series are bench.* rows
# containing "gbps" (regression = drop) and soak.*/workloads.* rows containing
# "p99" (regression = rise — latency climbing is the failure mode).
REGRESSION_THRESHOLD = 0.15
NOISE_FLOOR_MIN = 0.05

# The rig probe: a loopback device_put round-trip measured by the bench on
# the machine it ran on.  No shuffle code is in its path, so per-round it
# measures the RIG; bench throughput series gate on values normalized by it
# when both rounds carry it, and the probe itself charts without gating.
RIG_PROBE_SERIES = "bench.exchange_loopback_gbps"


class LedgerError(ValueError):
    """A ledger row could not be classified as metric or known metadata."""


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)


class _Flattener:
    def __init__(self) -> None:
        self.rows: Dict[str, float] = {}
        self.skipped: List[Dict[str, str]] = []
        self.errors: List[str] = []

    def skip(self, path: str, reason: str) -> None:
        self.skipped.append({"row": path, "reason": reason})

    def put(self, path: str, value: float) -> None:
        self.rows[path] = float(value)

    def walk(self, prefix: str, obj: Any) -> None:
        if isinstance(obj, bool):
            self.put(prefix, 1.0 if obj else 0.0)
        elif _is_number(obj):
            self.put(prefix, float(obj))
        elif isinstance(obj, str):
            key = prefix.rsplit(".", 1)[-1]
            if key in STRING_METADATA_KEYS or key.endswith("note"):
                self.skip(prefix, "string-metadata")
            else:
                self.errors.append(f"unclassifiable string row {prefix!r}={obj!r}")
        elif isinstance(obj, list):
            self.skip(prefix, "list-valued")
        elif isinstance(obj, dict):
            for k, v in obj.items():
                key = str(k)
                if _is_number(v) and key in NUMERIC_METADATA_KEYS:
                    self.skip(f"{prefix}.{key}" if prefix else key, "numeric-metadata")
                    continue
                self.walk(f"{prefix}.{key}" if prefix else key, v)
        elif obj is None:
            self.skip(prefix, "null")
        else:
            self.errors.append(f"unclassifiable row {prefix!r} of type {type(obj).__name__}")


def flatten_ledger(family: str, doc: Any, fname: str) -> _Flattener:
    """Turn one ledger document into ``series -> value`` rows."""
    fl = _Flattener()
    if not isinstance(doc, dict):
        fl.errors.append(f"{fname}: top-level document is {type(doc).__name__}, expected object")
        return fl
    if family == "bench":
        for k, v in doc.items():
            if k == "parsed":
                fl.walk("bench", v)
            else:
                fl.skip(f"bench.{k}", "run-metadata")
    elif family == "workloads":
        for entry in doc.get("workloads") or []:
            name = entry.get("workload", "unknown")
            for k, v in entry.items():
                if k == "workload":
                    continue
                fl.walk(f"workloads.{name}.{k}", v)
        for k in doc:
            if k != "workloads":
                fl.skip(f"workloads.{k}", "run-metadata")
    elif family == "soak":
        for k, v in doc.items():
            if k == "args":
                fl.skip("soak.args", "run-config")
            else:
                fl.walk(f"soak.{k}", v)
    else:  # pragma: no cover - discover() only yields the three families
        fl.errors.append(f"{fname}: unknown ledger family {family!r}")
    return fl


def discover(root: str) -> List[Tuple[str, int, str]]:
    """Find ledgers in *root*; returns (family, round, path) sorted by round."""
    out: List[Tuple[str, int, str]] = []
    for fname in sorted(os.listdir(root)):
        m = _LEDGER_RE.match(fname)
        if m:
            out.append((m.group(1).lower(), int(m.group(2)), os.path.join(root, fname)))
    out.sort(key=lambda t: (t[0], t[1]))
    return out


def _median(vals: List[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def build_trend(root: str) -> Dict[str, Any]:
    """Scan *root* and build the full trend document (pure; no I/O but reads)."""
    ledgers = discover(root)
    if not ledgers:
        raise LedgerError(f"no BENCH_r*/WORKLOADS_r*/SOAK_r* ledgers found under {root}")

    series: Dict[str, List[Tuple[int, float]]] = {}
    skipped: List[Dict[str, str]] = []
    errors: List[str] = []
    rounds_by_family: Dict[str, List[int]] = {}
    for family, rnd, path in ledgers:
        try:
            with open(path, "r") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            errors.append(f"{os.path.basename(path)}: unreadable ledger ({e})")
            continue
        fl = flatten_ledger(family, doc, os.path.basename(path))
        for item in fl.skipped:
            skipped.append(dict(item, ledger=os.path.basename(path)))
        for msg in fl.errors:
            errors.append(f"{os.path.basename(path)}: {msg}")
        for name, value in fl.rows.items():
            series.setdefault(name, []).append((rnd, value))
        rounds_by_family.setdefault(family, []).append(rnd)

    trajectories: Dict[str, Any] = {}
    all_rel_deltas: List[float] = []
    for name, pts in sorted(series.items()):
        pts.sort(key=lambda p: p[0])
        deltas: List[Optional[float]] = [None]
        for (r0, v0), (r1, v1) in zip(pts, pts[1:]):
            deltas.append((v1 - v0) / abs(v0) if v0 else None)
        # Noise is learned from *historical* transitions only; the latest
        # delta is the one under judgment and must not raise its own bar.
        for d in deltas[:-1]:
            if d is not None:
                all_rel_deltas.append(abs(d))
        trajectories[name] = {
            "points": [{"round": r, "value": v} for r, v in pts],
            "latest": pts[-1][1],
            "latest_round": pts[-1][0],
            "rel_delta_latest": deltas[-1] if len(pts) > 1 else None,
        }

    # Noise floor: how much series wiggle round-over-round across the whole
    # ledger history.  A regression must clear both the hard threshold and the
    # observed noise to fail the gate.
    noise_floor = max(NOISE_FLOOR_MIN, 1.5 * _median(all_rel_deltas))
    gate_threshold = max(REGRESSION_THRESHOLD, noise_floor)

    # The gate protects the *newest* round of each family.  A tracked series
    # whose last sample is from an older round is stale — the bench schema
    # moved past it — and charts without gating (a drop between two historical
    # rounds is a fact, not an actionable regression).
    latest_round = {fam: max(rs) for fam, rs in rounds_by_family.items()}
    probe_by_round = {
        p["round"]: p["value"]
        for p in trajectories.get(RIG_PROBE_SERIES, {}).get("points", [])
        if p["value"] > 0
    }
    regressions: List[Dict[str, Any]] = []
    for name, traj in trajectories.items():
        # Two tracked shapes: throughput rows (bench gbps series, regress DOWN)
        # and latency rows (soak/workloads p99 series, regress UP).  Both share
        # the same noise-floored gate threshold and stale-series exemption.
        if name.startswith("bench.") and "gbps" in name:
            if name == RIG_PROBE_SERIES:
                traj["rig_probe"] = True
                continue
            direction = "down"
        elif name.startswith(("soak.", "workloads.")) and "p99" in name:
            direction = "up"
        else:
            continue
        traj["tracked"] = True
        family = name.split(".", 1)[0]
        if traj["latest_round"] != latest_round.get(family):
            traj["stale"] = True
            continue
        d = traj["rel_delta_latest"]
        if d is None:
            continue
        pts = traj["points"]
        normalized = False
        if direction == "down":
            # rig normalization: judge the roofline FRACTION when both
            # rounds measured the probe on their own machine
            p0 = probe_by_round.get(pts[-2]["round"])
            p1 = probe_by_round.get(pts[-1]["round"])
            if p0 and p1 and pts[-2]["value"]:
                v0n = pts[-2]["value"] / p0
                v1n = pts[-1]["value"] / p1
                d = (v1n - v0n) / abs(v0n)
                traj["rel_delta_normalized"] = d
                normalized = True
        regressed = d < -gate_threshold if direction == "down" else d > gate_threshold
        if regressed:
            regressions.append(
                {
                    "series": name,
                    "direction": direction,
                    "prev_round": pts[-2]["round"],
                    "prev_value": pts[-2]["value"],
                    "round": pts[-1]["round"],
                    "value": pts[-1]["value"],
                    "rel_delta": d,
                    "rig_normalized": normalized,
                }
            )

    return {
        "root": os.path.abspath(root),
        "rounds": {fam: sorted(set(rs)) for fam, rs in rounds_by_family.items()},
        "noise_floor": round(noise_floor, 4),
        "gate_threshold": round(gate_threshold, 4),
        "num_series": len(trajectories),
        "series": trajectories,
        "regressions": regressions,
        "skipped": skipped,
        "errors": errors,
    }


def render_markdown(trend: Dict[str, Any]) -> str:
    lines = [
        "# Perf trend",
        "",
        "Generated by `python -m sparkrdma_tpu_torch.obs.trend` from the committed",
        "`BENCH_r*` / `WORKLOADS_r*` / `SOAK_r*` ledgers. Do not edit by hand.",
        "",
        f"- rounds scanned: "
        + ", ".join(f"{fam} {rs}" for fam, rs in sorted(trend["rounds"].items())),
        f"- series: {trend['num_series']}, noise floor: {trend['noise_floor']:.1%},"
        f" gate threshold: ±{trend['gate_threshold']:.1%}"
        " (gbps rows gate on drops, p99 rows gate on rises; bench gbps"
        " gates rig-normalized when the loopback probe covers both rounds)",
        f"- regressions: {len(trend['regressions'])},"
        f" skipped rows: {len(trend['skipped'])}, errors: {len(trend['errors'])}",
        "",
    ]
    if trend["regressions"]:
        lines += ["## Regressions", ""]
        for r in trend["regressions"]:
            what = "latency rose" if r.get("direction") == "up" else "throughput dropped"
            lines.append(
                f"- **{r['series']}**: {r['prev_value']:g} (r{r['prev_round']:02d})"
                f" -> {r['value']:g} (r{r['round']:02d}), {r['rel_delta']:+.1%} ({what})"
            )
        lines.append("")
    for family in ("bench", "workloads", "soak"):
        rows = [
            (name, t)
            for name, t in trend["series"].items()
            if name.startswith(family + ".")
        ]
        if not rows:
            continue
        lines += [f"## {family}", "", "| series | trajectory | latest | Δ vs prev |", "|---|---|---|---|"]
        for name, t in rows:
            traj = " → ".join(f"{p['value']:g}" for p in t["points"])
            d = t["rel_delta_latest"]
            delta = f"{d:+.1%}" if d is not None else "—"
            mark = " ⚠" if any(r["series"] == name for r in trend["regressions"]) else ""
            lines.append(f"| `{name}` | {traj} | {t['latest']:g} | {delta}{mark} |")
        lines.append("")
    return "\n".join(lines) + "\n"


def _record_metrics(trend: Dict[str, Any]) -> None:
    try:
        from sparkrdma_tpu_torch.obs.metrics import get_registry
    except Exception:
        return
    reg = get_registry()
    for fam, rs in trend["rounds"].items():
        reg.gauge("trend.rounds", family=fam).set(len(rs))
    reg.gauge("trend.series").set(trend["num_series"])
    reg.counter("trend.regressions").inc(len(trend["regressions"]))
    reg.counter("trend.skipped_rows").inc(len(trend["skipped"]))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkrdma_tpu_torch.obs.trend",
        description="Normalize bench ledgers into per-metric trajectories and gate on regressions.",
    )
    ap.add_argument("--dir", default=".", help="directory holding the *_rNN.json ledgers (default: cwd)")
    ap.add_argument("--out", default=None, help="output JSON path (default: none written)")
    ap.add_argument("--md", default=None, help="output markdown path (default: none written)")
    ap.add_argument(
        "--check",
        action="store_true",
        help="exit 1 on a tracked-series regression, 2 on unclassifiable ledger rows",
    )
    args = ap.parse_args(argv)

    try:
        trend = build_trend(args.dir)
    except LedgerError as e:
        print(f"trend: {e}", file=sys.stderr)
        return 2

    _record_metrics(trend)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(trend, f, indent=1, sort_keys=False)
            f.write("\n")
    if args.md:
        with open(args.md, "w") as f:
            f.write(render_markdown(trend))
    written = ", ".join(p for p in (args.out, args.md) if p) or "nothing written"

    print(
        f"trend: {trend['num_series']} series across rounds {trend['rounds']};"
        f" {len(trend['regressions'])} regression(s), {len(trend['skipped'])} skipped row(s),"
        f" {len(trend['errors'])} error(s) -> {written}"
    )
    for msg in trend["errors"]:
        print(f"trend: ERROR {msg}", file=sys.stderr)
    for r in trend["regressions"]:
        what = "latency rose" if r.get("direction") == "up" else "throughput dropped"
        print(
            f"trend: REGRESSION {r['series']} {r['prev_value']:g} -> {r['value']:g}"
            f" ({r['rel_delta']:+.1%}, {what}) at round r{r['round']:02d}",
            file=sys.stderr,
        )
    if args.check:
        if trend["errors"]:
            return 2
        if trend["regressions"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
