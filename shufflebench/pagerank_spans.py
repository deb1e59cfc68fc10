"""The PageRank step's spans, read as ``spans.py`` reads the sort's and
the join's.

``spans.py`` finds the program's spans by the prefixes in its
``PREFIXES`` (``terasort.``, ``hashjoin.``, ``exchange.``), which do not
name ``pagerank.``. Here the same arithmetic (``spans._innermost``) runs
over those spans and the ``pagerank.*`` ones: a kernel goes to the
innermost span open at its launch, ``pagerank.gather`` say, where
``spans.py`` would leave it to no span. Stretch ``a`` is read, and a
trace without a ``pagerank.step`` span reads None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from shufflebench import spans
from shufflebench.trace import Ev

PREFIXES = spans.PREFIXES + ("pagerank.",)
STEP = "pagerank.step"


def program_spans(events: Sequence[Ev]) -> List[Ev]:
    return [e for e in events if e.kind == "op" and e.name.startswith(PREFIXES)]


def device_ns_by_span(events: Sequence[Ev]) -> Dict[Optional[str], int]:
    """Device nanoseconds by the innermost program span, ``pagerank.*``
    included, open at each device event's launch (``None``: no span)."""
    at = spans._innermost(events, program_spans(events), ("runtime", "op"))
    runtime, ops = at["runtime"], at["op"]
    out: Dict[Optional[str], int] = defaultdict(int)
    for e in events:
        if e.kind != "device":
            continue
        name = runtime[e.corr] if e.corr in runtime else (
            ops.get(e.linked) if e.linked else None)
        out[name] += e.end_ns - e.start_ns
    return dict(out)


def _stepped(run):
    """Stretch ``a`` where it holds a ``pagerank.step`` span, else None."""
    a = None if run.traced is None else run.traced["a"]
    if a is None or not any(e.kind == "op" and e.name == STEP for e in a.events):
        return None
    return a


def phase_ms(run, name: str) -> Optional[float]:
    """Device ms a stage launched under span ``name`` (innermost)."""
    a = _stepped(run)
    if a is None:
        return None
    key = "pagerank_span_device_ns"
    if key not in run.notes:
        run.notes[key] = device_ns_by_span(a.events)
    return run.notes[key].get(name, 0) / 1e6 / a.stages


def sync_count(run) -> Optional[float]:
    """CUDA runtime calls named ``*Synchronize*`` a stage that start
    inside a ``pagerank.step`` span on its thread."""
    a = _stepped(run)
    if a is None:
        return None
    steps = [s for s in program_spans(a.events) if s.name == STEP]
    calls = [e for e in a.events if e.kind == "runtime" and "Synchronize" in e.name]
    inside = spans._innermost(calls, steps, ("runtime",))["runtime"]
    return sum(inside.get(e.corr) == STEP for e in calls) / a.stages
