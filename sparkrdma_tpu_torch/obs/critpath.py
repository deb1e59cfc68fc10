"""Critical-path extraction over the causal span DAG.

``obs/trace.py`` gives every span explicit causal edges: ``parent_id``
(contextvar nesting) and ``follows`` (queue/wire hand-offs, the
``SpanHandle`` seams catalogued in docs/OBSERVABILITY.md). This module
turns one job's span set into its **critical path** — the single
backward chain of spans that bounded the job's wall time — so
``obs/attr.py`` can fold the chain into a per-category
:class:`~sparkrdma_tpu_torch.obs.attr.TimeBreakdown` verdict ("this job was
62% host-read, 20% decode, 8% rpc, 10% untraced").

Algorithm (backward walk, latest-ending-predecessor):

1. take every span overlapping the job window ``[t0, t1]`` (times on
   the merged wall-clock timeline — per-tracer epochs applied, so
   cross-process merges walk one axis);
2. start at the window end; repeatedly attribute ``[pred_end, cursor]``
   to the current span and jump to its best predecessor: an explicit
   causal edge (``follows`` origin, else the enclosing parent) when one
   ends at-or-before the cursor, else the latest-ending span that was
   running at the cursor (time containment — the fallback that keeps
   the walk alive across span-dark layers);
3. when the best predecessor ends strictly before the cursor, the
   uncovered interval becomes an explicit **gap segment** — the
   idle/untraced bucket that the ≥90% coverage acceptance gate bounds.

Loadable from live tracers (:func:`job_breakdown`, wired into
``TpuContext.run_job``) or from a saved Chrome-trace export
(:func:`spans_from_chrome`).

A copy of the JAX package's ``obs/critpath.py``, its imports rewritten
to this package. ``python -m sparkrdma_tpu_torch.obs --critical-path``
replays it over saved exports.

Stdlib-only and jax-free, like the rest of ``obs/``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

from sparkrdma_tpu_torch.obs.metrics import get_registry

# Attribution ignores intervals shorter than this (float jitter between
# adjacent queue hand-offs, not real idle time).
_EPS = 1e-6


class PSpan:
    """Placed span: a span projected onto the merged wall timeline.

    Mirrors the :class:`~sparkrdma_tpu_torch.obs.trace.Span` attributes the
    walk needs, with ``t0``/``t1`` already epoch-rebased — one shape
    for live spans, heartbeat-merged remote spans, and spans
    reconstructed from a Chrome-trace file."""

    __slots__ = ("name", "role", "span_id", "parent_id", "follows",
                 "t0", "t1", "args")

    def __init__(self, name: str, role: str, span_id: int, parent_id: int,
                 t0: float, t1: float, follows: Optional[List[int]] = None,
                 args: Optional[Dict[str, object]] = None):
        self.name = name
        self.role = role
        self.span_id = int(span_id)
        self.parent_id = int(parent_id)
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.follows = follows or []
        self.args = args or {}


def place_spans(spans: Iterable,
                epochs: Optional[Mapping[str, float]] = None) -> List[PSpan]:
    """Project ``Span`` objects (or ``(span, epoch)`` pairs) onto one
    timeline. With plain spans and no ``epochs`` map the raw
    ``perf_counter`` axis is kept — correct whenever every span came
    from this process (all tracers share the module anchor)."""
    epochs = epochs or {}
    out: List[PSpan] = []
    for item in spans:
        sp, ep = item if isinstance(item, tuple) else (item, 0.0)
        ep = epochs.get(sp.role, ep)
        out.append(PSpan(
            sp.name, sp.role, sp.span_id, sp.parent_id,
            ep + sp.start, ep + sp.end,
            [origin_id for _, origin_id in (sp.follows or ())],
            dict(sp.args),
        ))
    return out


class Seg:
    """One critical-path segment: ``[t0, t1]`` attributed to one span
    (``kind == "span"``) or to nothing (``kind == "gap"``).

    Gap segments may carry ``frames`` — the dominant leaf frames the
    sampling profiler observed inside the gap interval
    (``obs/profiler.py::annotate_gaps``), as ``[[frame, count], ...]``
    — turning "idle-untraced" into "what the CPU was actually doing".
    """

    __slots__ = ("kind", "name", "role", "span_id", "t0", "t1", "frames")

    def __init__(self, kind: str, name: str, role: str, span_id: int,
                 t0: float, t1: float):
        self.kind = kind
        self.name = name
        self.role = role
        self.span_id = span_id
        self.t0 = t0
        self.t1 = t1
        self.frames: Optional[List[list]] = None

    @property
    def dur_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_dict(self) -> dict:
        out = {
            "kind": self.kind, "name": self.name, "role": self.role,
            "span_id": self.span_id,
            "ms": round(self.dur_s * 1e3, 3),
        }
        if self.frames:
            out["frames"] = self.frames
        return out


class CriticalPath:
    """The extracted path over one window: segments in time order."""

    __slots__ = ("t0", "t1", "segments")

    def __init__(self, t0: float, t1: float, segments: List[Seg]):
        self.t0 = t0
        self.t1 = t1
        self.segments = segments

    @property
    def wall_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    @property
    def traced_s(self) -> float:
        return sum(s.dur_s for s in self.segments if s.kind == "span")

    @property
    def coverage(self) -> float:
        """Fraction of the window attributed to real spans (0..1)."""
        wall = self.wall_s
        return (self.traced_s / wall) if wall > _EPS else 1.0

    def top_segments(self, n: int = 10) -> List[Seg]:
        return sorted(self.segments, key=lambda s: -s.dur_s)[:n]

    def to_dict(self) -> dict:
        return {
            "wall_ms": round(self.wall_s * 1e3, 3),
            "coverage": round(self.coverage, 4),
            "segments": [s.to_dict() for s in self.segments],
        }


def extract(spans: Sequence, t0: float, t1: float,
            exclude: Iterable[int] = (),
            epochs: Optional[Mapping[str, float]] = None) -> CriticalPath:
    """Walk the longest causal chain backward across ``[t0, t1]``.

    ``spans`` may be ``Span`` objects, ``(span, epoch)`` pairs, or
    pre-placed :class:`PSpan` — anything overlapping the window joins
    the DAG. ``exclude`` drops span ids (the enclosing job span itself,
    which would otherwise trivially cover the whole window)."""
    excluded = set(exclude)
    if spans and not isinstance(spans[0], PSpan):
        placed = place_spans(spans, epochs)
    else:
        placed = list(spans)
    pool = [
        p for p in placed
        if p.span_id not in excluded and p.t1 > t0 + _EPS and p.t0 < t1 - _EPS
    ]
    by_id: Dict[int, PSpan] = {p.span_id: p for p in pool}
    # time-containment fallback index: spans sorted by end descending,
    # scanned for "latest end at-or-before cursor, still running"
    by_end = sorted(pool, key=lambda p: -p.t1)

    def fallback_at(cursor: float) -> Optional[PSpan]:
        best: Optional[PSpan] = None
        for p in by_end:
            eff = min(p.t1, cursor)
            if p.t0 >= cursor - _EPS or eff <= t0 + _EPS:
                continue
            if best is None or eff > min(best.t1, cursor):
                best = p
            if p.t1 <= cursor and best is p:
                break  # by_end is end-sorted: nothing later can beat it
        return best

    segments: List[Seg] = []
    cursor = t1
    current = fallback_at(cursor)
    if current is not None and min(current.t1, cursor) < cursor - _EPS:
        # nothing was running at the window end: the tail is untraced
        segments.append(Seg("gap", "", "", 0, min(current.t1, cursor), cursor))
        cursor = min(current.t1, cursor)
    steps = 0
    limit = 2 * len(pool) + 64
    while cursor > t0 + _EPS and steps < limit:
        steps += 1
        if current is None:
            segments.append(Seg("gap", "", "", 0, t0, cursor))
            break
        lo = max(current.t0, t0)
        hi = min(current.t1, cursor)
        if hi > lo + _EPS:
            segments.append(Seg(
                "span", current.name, current.role, current.span_id, lo, hi,
            ))
        cursor = lo
        if cursor <= t0 + _EPS:
            break
        # explicit causal predecessors first: follows origins, then the
        # enclosing parent; both must have been live before the cursor
        nxt: Optional[PSpan] = None
        for oid in current.follows:
            cand = by_id.get(oid)
            if cand is not None and cand.t0 < cursor - _EPS:
                if nxt is None or min(cand.t1, cursor) > min(nxt.t1, cursor):
                    nxt = cand
        if nxt is None:
            parent = by_id.get(current.parent_id)
            if parent is not None and parent.t0 < cursor - _EPS:
                nxt = parent
        if nxt is None:
            nxt = fallback_at(cursor)
        if nxt is not None and min(nxt.t1, cursor) < cursor - _EPS:
            # predecessor ends before the hand-off: untraced interval
            gap_lo = min(nxt.t1, cursor)
            segments.append(Seg("gap", "", "", 0, max(gap_lo, t0), cursor))
            cursor = max(gap_lo, t0)
        current = nxt
    segments.reverse()
    return CriticalPath(t0, t1, segments)


# ----------------------------------------------------------------------
# Chrome-trace reconstruction (CLI over saved artifacts)
# ----------------------------------------------------------------------
def spans_from_chrome(doc: Mapping) -> List[PSpan]:
    """Rebuild placed spans from a ``to_chrome_trace`` export.

    Complete events (``ph:"X"``) carry ``args.span_id`` /
    ``args.parent_span``; the causal edges ride the flow events'
    ``args.from_span`` / ``args.to_span`` pairs. Events without a
    ``span_id`` (foreign traces) are skipped."""
    events = doc.get("traceEvents") or []
    pid_names: Dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev.get("pid", 0)] = (ev.get("args") or {}).get("name", "")
    spans: Dict[int, PSpan] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        sid = args.get("span_id")
        if not sid:
            continue
        t0 = float(ev.get("ts", 0.0)) / 1e6
        t1 = t0 + float(ev.get("dur", 0.0)) / 1e6
        spans[int(sid)] = PSpan(
            str(ev.get("name", "")),
            pid_names.get(ev.get("pid", 0), str(ev.get("pid", ""))),
            int(sid), int(args.get("parent_span", 0) or 0),
            t0, t1, args=dict(args),
        )
    for ev in events:
        if ev.get("ph") != "s" or ev.get("cat") != "critpath":
            continue
        args = ev.get("args") or {}
        follower = spans.get(int(args.get("to_span", 0) or 0))
        origin_id = int(args.get("from_span", 0) or 0)
        if follower is not None and origin_id:
            follower.follows.append(origin_id)
    return list(spans.values())


# ----------------------------------------------------------------------
# the engine's entry point: one finished job span -> TimeBreakdown
# ----------------------------------------------------------------------
def job_breakdown(job_span, spans: Optional[Sequence] = None,
                  role: str = "driver"):
    """Build the critical path across ``job_span``'s window and fold it
    into a :class:`~sparkrdma_tpu_torch.obs.attr.TimeBreakdown`. Registers
    the ``critpath.*`` build metrics. ``spans`` defaults to every live
    tracer's spans (in-process cluster)."""
    from sparkrdma_tpu_torch.obs.attr import attribute, publish_breakdown
    from sparkrdma_tpu_torch.obs.profiler import annotate_gaps
    from sparkrdma_tpu_torch.obs.trace import collect_spans

    t_build0 = time.perf_counter()
    if spans is None:
        spans = collect_spans()
    path = extract(spans, job_span.start, job_span.end,
                   exclude={job_span.span_id})
    # gap segments get their dominant sampled frames BEFORE attribution
    # folds segments into dicts (no-op without a live process profiler)
    annotate_gaps(path)
    verdict = attribute(path)
    # feedback seam: attribution-driven controllers (the wave
    # self-tuner, shuffle/autotune.py) read the latest verdict here
    publish_breakdown(verdict)
    reg = get_registry()
    reg.counter("critpath.builds", role=role).inc()
    reg.histogram("critpath.build_ms", role=role).observe(
        (time.perf_counter() - t_build0) * 1e3
    )
    reg.gauge("critpath.coverage_pct").set(int(round(verdict.coverage * 100)))
    return verdict
