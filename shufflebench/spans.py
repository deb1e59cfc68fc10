"""The program's own spans in a traced stretch.

The steps of ``sparkrdma_tpu_torch`` open profiler ranges named for
their phases (``terasort.local_sort``, ``hashjoin.pack``,
``exchange.a2a``, ...; ``obs/trace.py`` ``span`` in the package). In a
trace they are host events (``op``) on the thread that ran the step.
From them:

- :func:`device_ns_by_span`: each device event's time goes to the
  innermost program span open on the launching thread at its launch.
  The launch is the CUDA runtime call of the event's ``corr``, or else
  the op it is linked to; ``None`` collects what no span encloses;
- :func:`syncs`: the CUDA runtime calls named ``*Synchronize*`` that
  start inside a step span on its thread, their number and host time.

Stretch ``a`` (``run.traced["a"]``, traced without the frame
annotations) is read. A trace of a program without these spans holds
none of them, and every reader then returns None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from shufflebench.trace import Ev, _sweep

PREFIXES = ("terasort.", "hashjoin.", "exchange.")


def program_spans(events: Sequence[Ev]) -> List[Ev]:
    return [e for e in events if e.kind == "op" and e.name.startswith(PREFIXES)]


def _innermost(events: Sequence[Ev], spans: Sequence[Ev], kinds: Tuple[str, ...]
               ) -> Dict[str, Dict[int, Optional[str]]]:
    """For the events of ``kinds``, by kind and correlation: the
    innermost span open at the event's start on its thread."""
    by_thread: Dict[int, List[Ev]] = defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    queries: Dict[int, List[Tuple[int, object]]] = defaultdict(list)
    for e in events:
        if e.kind in kinds:
            queries[e.thread].append((e.start_ns, (e.kind, e.corr)))
    out: Dict[str, Dict[int, Optional[str]]] = {k: {} for k in kinds}
    for thread, qs in queries.items():
        for (kind, corr), name in _sweep(by_thread.get(thread, []), qs).items():
            out[kind][corr] = name
    return out


def device_ns_by_span(events: Sequence[Ev]) -> Dict[Optional[str], int]:
    """Device nanoseconds by the innermost program span open at each
    device event's launch (``None``: no span)."""
    spans = program_spans(events)
    at = _innermost(events, spans, ("runtime", "op"))
    runtime, ops = at["runtime"], at["op"]
    out: Dict[Optional[str], int] = defaultdict(int)
    for e in events:
        if e.kind != "device":
            continue
        if e.corr in runtime:
            name = runtime[e.corr]
        else:
            name = ops.get(e.linked) if e.linked else None
        out[name] += e.end_ns - e.start_ns
    return dict(out)


def syncs(events: Sequence[Ev], step: str) -> Optional[Tuple[int, int]]:
    """``(count, host ns)`` of the CUDA runtime calls named
    ``*Synchronize*`` whose start falls inside a ``step`` span on the
    same thread; None where the trace has no ``step`` span."""
    steps = [s for s in program_spans(events) if s.name == step]
    if not steps:
        return None
    calls = [e for e in events if e.kind == "runtime" and "Synchronize" in e.name]
    inside = _innermost(calls, steps, ("runtime",))["runtime"]
    hit = [e for e in calls if inside.get(e.corr) == step]
    return len(hit), sum(e.end_ns - e.start_ns for e in hit)


def _stretch(run):
    return None if run.traced is None else run.traced["a"]


def _by_span(run) -> Optional[Dict[Optional[str], int]]:
    a = _stretch(run)
    if a is None:
        return None
    key = "program_span_device_ns"
    if key not in run.notes:
        run.notes[key] = device_ns_by_span(a.events)
    return run.notes[key]


def phase_ms(run, name: str) -> Optional[float]:
    """Device ms a stage launched under span ``name`` (innermost), in
    stretch ``a``; None where no such span was traced."""
    a = _stretch(run)
    if a is None or not any(s.name == name for s in program_spans(a.events)):
        return None
    return _by_span(run).get(name, 0) / 1e6 / a.stages


def sync_count(run, step: str) -> Optional[float]:
    """Synchronising CUDA calls a stage inside span ``step``."""
    a = _stretch(run)
    got = None if a is None else syncs(a.events, step)
    return None if got is None else got[0] / a.stages


def sync_ms(run, step: str) -> Optional[float]:
    """Host ms a stage in synchronising CUDA calls inside span ``step``."""
    a = _stretch(run)
    got = None if a is None else syncs(a.events, step)
    return None if got is None else got[1] / 1e6 / a.stages
