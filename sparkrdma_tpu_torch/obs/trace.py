"""Dapper-style span tracer with cross-executor trace correlation.

A 64-bit trace id is minted when the driver registers a shuffle
(``TpuShuffleManager.register_shuffle``) and rides inside the
``PublishPartitionLocationsMsg`` / ``FetchPartitionLocationsMsg`` wire
frames, so the publish → resolve → fetch spans of one shuffle share an
id across every process role that touched it. Spans nest through a
``contextvars`` context variable (thread- and task-local), and export
as Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable in
Perfetto / chrome://tracing.

Timestamps: spans record ``time.perf_counter()`` internally and are
rebased to wall-clock microseconds at export via a per-tracer epoch
(default: this process's module-load anchor), so spans from every
tracer in the process share one timeline — and spans merged from
OTHER processes can be aligned by handing the exporter each remote
role's wall-clock anchor (carried in the telemetry heartbeat as
``epoch_ms``, see obs/telemetry.py).

Causal edges (critical-path attribution, docs/OBSERVABILITY.md): a
span can declare that it *follows* another span — a hand-off across a
queue, a thread pool, or a wire frame — via ``follows=`` on
``span()``/``record()`` or ``Span.add_follows``. The reference is a
:class:`SpanHandle` (two ints, trivially serializable), so it rides
pipeline queue tuples and RPC trailing extensions. The exporter emits
each edge as a Perfetto flow event pair (``ph:"s"`` at the origin's
end, ``ph:"f"`` at the follower's start), and ``obs/critpath.py``
walks the same edges to extract the per-job critical path.

The profiler bridge (this package only): while ``torch.profiler``
records, every span also opens a profiler range of the same name
(``torch._C._profiler._RecordFunctionFast``, a function-scope range),
so it lands on the device trace's clock beside the kernels and CUDA
runtime calls it encloses. A span is in one of three states:

- off (no profiler recording, no enabled tracer's span open on the
  thread): :func:`span` and a disabled :meth:`Tracer.span` return one
  shared ``contextlib.nullcontext``: a check of the current span and
  of the profiler's module flag, no generator, no ``Span``, no range;
- profiler recording: a profiler range of the span's name. Every
  ``Tracer.span`` (``engine.task``, ``shuffle.fetch``, ...) opens it
  while a profiler records, enabled or not;
- tracer: :func:`span` inside an open span of an enabled ``Tracer``
  records into that tracer, nested under it, as ``Tracer.span`` does
  (Chrome export, critical path).

:func:`span` is the form for the device steps' hot paths. Each span's
name is documented where it is opened: the step spans in the docstrings
of ``models/terasort.py``, ``models/hashjoin.py`` and
``models/pagerank.py``, ``exchange.a2a`` in ``ops/exchange.py``. A span
adds no sync, no ``.item()`` and no host read. To see them, profile any
step (``torch.profiler.profile`` with the CPU and CUDA activities) and
export a Chrome trace. Span names never start with ``cu`` and never look
like a Python frame (``file.py(N): name``): the benchmark harness
(``shufflebench/trace.py``) sorts trace events by those patterns.

Otherwise a copy of the JAX package's ``obs/trace.py``, its imports
rewritten to this package; merged journal events (``obs/journal.py``)
draw as instant markers on a ``journal`` track, as in JAX.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

# Wall-clock anchor for the perf_counter timeline (export-time rebase).
_EPOCH = time.time() - time.perf_counter()

_current_span: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "sparkrdma_tpu_obs_span", default=None
)

# Thread-ident → innermost OPEN span, maintained by ``Tracer.span()``
# only while a watcher (the sampling profiler, obs/profiler.py) has
# asked for it via ``set_span_watch(True)``: a contextvar can't be read
# cross-thread, and the profiler's timer thread must tag each sampled
# thread with its active span. Plain dict ops are atomic under the GIL;
# the gate keeps the disabled cost at one module-global load per span.
_span_watch = False
_active_by_ident: Dict[int, "Span"] = {}


def set_span_watch(enabled: bool) -> None:
    """Turn the thread-ident → active-span side table on/off (profiler
    lifecycle hook). Turning it off clears the table."""
    global _span_watch
    _span_watch = bool(enabled)
    if not enabled:
        _active_by_ident.clear()


def active_span_of_ident(ident: int) -> "Optional[Span]":
    """Innermost open span on thread ``ident`` — readable from any
    thread, None when the thread has no open span (or the watch is
    off). Spans opened before the watch was enabled are not visible."""
    return _active_by_ident.get(ident)


# The profiler bridge. ``torch.autograd.profiler._is_profiler_enabled``
# is a plain module flag that the profiler sets while it records. It is
# looked up through sys.modules, so importing obs/ never imports torch:
# no profiler can record before torch is imported.
_PROFILER_MODULE = "torch.autograd.profiler"
_NULL = contextlib.nullcontext()


def _recording() -> bool:
    prof = sys.modules.get(_PROFILER_MODULE)
    return prof is not None and prof._is_profiler_enabled


def _profiler_range(name: str):
    """A profiler range named ``name``: a function-scope range, which
    puts no GPU-side annotation events on the device trace. Only called
    while a profiler records, so torch is imported."""
    return sys.modules["torch"]._C._profiler._RecordFunctionFast(name)


def span(name: str):
    """The hot path's span, in three states:

    - inside an open span of an enabled tracer on this thread: a span of
      that tracer, bridged to the profiler as :meth:`Tracer.span` is;
    - else, while a profiler records: a profiler range named ``name``;
    - else: one shared null context, built once.

    ``with span(...) as sp`` gives the ``Span`` in the first state and
    None in the others."""
    parent = _current_span.get()  # only Tracer._span sets it, with its tracer
    if parent is not None and parent.tracer.enabled:
        return parent.tracer._span(name, None, 0, None, {})
    if _recording():
        return _profiler_range(name)
    return _NULL


_span_ids = itertools.count(1)
_tracers_lock = threading.Lock()
_tracers: "List[Tracer]" = []
_named_lock = threading.Lock()
_named: Dict[str, "Tracer"] = {}


def now() -> float:
    """Monotonic timestamp compatible with ``Tracer.record``."""
    return time.perf_counter()


def epoch_anchor() -> float:
    """This process's wall-clock anchor for the span timeline (seconds):
    ``epoch_anchor() + span.start`` is a wall-clock time. Carried in
    the telemetry heartbeat as ``epoch_ms`` so cross-process trace
    merges rebase every role onto one timeline (obs/telemetry.py)."""
    return _EPOCH


def mint_trace_id() -> int:
    """Random nonzero 63-bit trace id (0 means "unknown" on the wire)."""
    return (int.from_bytes(os.urandom(8), "big") & 0x7FFFFFFFFFFFFFFF) | 1


class SpanHandle:
    """Serializable causal reference to a span.

    Two ints — small enough to ride a pipeline queue tuple, a task-
    protocol dict, or an 8-byte wire extension. ``span_id`` 0 is the
    null handle (``bool(handle)`` is False), the wire's "no origin".
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int = 0, span_id: int = 0):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)

    def __bool__(self) -> bool:
        return bool(self.span_id)

    def __repr__(self) -> str:
        return f"SpanHandle(trace_id={self.trace_id:#x}, span_id={self.span_id})"

    @classmethod
    def of(cls, span: "Optional[Span]") -> "Optional[SpanHandle]":
        return None if span is None else cls(span.trace_id, span.span_id)


class Span:
    __slots__ = ("name", "role", "trace_id", "span_id", "parent_id",
                 "start", "end", "tid", "args", "follows", "tracer")

    def __init__(self, name: str, role: str, trace_id: int, parent_id: int,
                 start: float, args: Dict[str, object]):
        self.name = name
        self.role = role
        self.trace_id = trace_id
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.start = start
        self.end = start
        self.tid = threading.get_ident()
        self.args = args
        # causal predecessors: list of (trace_id, span_id), lazily built
        self.follows: Optional[List[tuple]] = None
        # the tracer that opened it as the current span (:func:`span`
        # records the hot path's spans there); None for retroactive ones
        self.tracer: "Optional[Tracer]" = None

    def handle(self) -> SpanHandle:
        return SpanHandle(self.trace_id, self.span_id)

    def add_follows(self, origin) -> None:
        """Record a causal edge: this span's work was handed off from
        ``origin`` (a Span, SpanHandle, or None). Null/zero origins are
        ignored so callers can pass handles through unconditionally."""
        if origin is None:
            return
        sid = getattr(origin, "span_id", 0)
        if not sid:
            return
        if self.follows is None:
            self.follows = []
        self.follows.append((getattr(origin, "trace_id", 0), int(sid)))


def _link(sp: Span, follows) -> None:
    if follows is None:
        return
    if isinstance(follows, (Span, SpanHandle)):
        sp.add_follows(follows)
        return
    try:
        for origin in follows:
            sp.add_follows(origin)
    except TypeError:
        pass


class Tracer:
    """Per-role span recorder (one per shuffle manager / process role).

    Spans live in a bounded deque (``max_spans``); ``bind_shuffle``
    records the shuffle→trace-id association learned from the wire so
    spans opened before the binding arrived (the reducer's fetch span)
    can resolve their trace id at close time.
    """

    def __init__(self, role: str = "proc", max_spans: int = 20000,
                 enabled: bool = True, epoch: Optional[float] = None):
        self.role = role
        self.enabled = enabled
        # wall-clock anchor for this tracer's perf_counter timeline; a
        # remote role's spans are merged by constructing the local
        # stand-in tracer with the anchor from its telemetry heartbeat
        self.epoch = _EPOCH if epoch is None else float(epoch)
        self._spans: "deque[Span]" = deque(maxlen=max(1, int(max_spans)))
        self._lock = threading.Lock()
        self._bindings: Dict[int, int] = {}
        with _tracers_lock:
            _tracers.append(self)

    # -- shuffle → trace-id bindings --------------------------------------
    def bind_shuffle(self, shuffle_id: int, trace_id: int) -> None:
        if trace_id:
            with self._lock:
                self._bindings[shuffle_id] = trace_id

    def trace_for(self, shuffle_id: Optional[int]) -> int:
        if shuffle_id is None:
            return 0
        with self._lock:
            return self._bindings.get(shuffle_id, 0)

    # -- span recording ---------------------------------------------------
    def _resolve_trace(self, trace_id: int, shuffle_id: Optional[int],
                       parent: Optional[Span]) -> int:
        if trace_id:
            return trace_id
        bound = self.trace_for(shuffle_id)
        if bound:
            return bound
        return parent.trace_id if parent is not None else 0

    def span(self, name: str, shuffle_id: Optional[int] = None,
             trace_id: int = 0, follows=None, **args):
        """Context-managed span; nests under the current contextvar span.

        The trace id is resolved eagerly at open (explicit arg, else the
        shuffle binding, else the parent's id) so nested spans inherit
        it, and re-resolved at close if still unknown — the binding may
        arrive over the wire while the span is open. ``follows`` adds
        causal edges (Span / SpanHandle / iterable thereof).

        While a profiler records, the span is also a profiler range of
        the same name. Disabled, it yields None: a profiler range while
        a profiler records, else the shared null context."""
        if not self.enabled:
            return _profiler_range(name) if _recording() else _NULL
        return self._span(name, shuffle_id, trace_id, follows, args)

    @contextlib.contextmanager
    def _span(self, name: str, shuffle_id: Optional[int], trace_id: int,
              follows, args: Dict[str, object]):
        with _profiler_range(name) if _recording() else _NULL:
            parent = _current_span.get()
            if shuffle_id is not None:
                args.setdefault("shuffle_id", shuffle_id)
            sp = Span(name, self.role,
                      self._resolve_trace(trace_id, shuffle_id, parent),
                      parent.span_id if parent is not None else 0,
                      now(), args)
            sp.tracer = self
            _link(sp, follows)
            token = _current_span.set(sp)
            if _span_watch:
                _active_by_ident[sp.tid] = sp
            try:
                yield sp
            finally:
                _current_span.reset(token)
                if _span_watch:
                    if parent is not None:
                        _active_by_ident[sp.tid] = parent
                    else:
                        _active_by_ident.pop(sp.tid, None)
                sp.end = now()
                if not sp.trace_id:
                    sp.trace_id = self._resolve_trace(trace_id, shuffle_id, parent)
                with self._lock:
                    self._spans.append(sp)

    def record(self, name: str, start: float, end: float,
               shuffle_id: Optional[int] = None, trace_id: int = 0,
               follows=None, **args) -> Optional[Span]:
        """Retroactive span from already-measured ``now()`` timestamps
        (hot paths that keep their own timers). Nests under the current
        contextvar span like ``span()`` does, so retroactive hot-path
        spans stay attached to the causal DAG."""
        if not self.enabled:
            return None
        parent = _current_span.get()
        if shuffle_id is not None:
            args.setdefault("shuffle_id", shuffle_id)
        sp = Span(name, self.role, 0,
                  parent.span_id if parent is not None else 0,
                  start, args)
        sp.end = end
        sp.trace_id = self._resolve_trace(trace_id, shuffle_id, parent)
        _link(sp, follows)
        with self._lock:
            self._spans.append(sp)
        return sp

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._bindings.clear()


def get_tracer(role: str = "proc") -> Tracer:
    """Named-tracer convenience for code without a manager (benches)."""
    with _named_lock:
        t = _named.get(role)
        if t is None:
            t = Tracer(role=role)
            _named[role] = t
        return t


def all_tracers() -> List[Tracer]:
    with _tracers_lock:
        return list(_tracers)


def collect_spans(tracers: Optional[Iterable[Tracer]] = None) -> List[Span]:
    out: List[Span] = []
    for t in (tracers if tracers is not None else all_tracers()):
        out.extend(t.spans())
    out.sort(key=lambda s: s.start)
    return out


def collect_spans_with_epochs(
        tracers: Optional[Iterable[Tracer]] = None,
        epochs: Optional[Dict[str, float]] = None) -> List[tuple]:
    """``(span, epoch)`` pairs sorted on the merged wall-clock timeline.

    ``epochs`` maps role → wall-clock anchor and overrides the owning
    tracer's epoch — how cluster-mode merges align spans from remote
    processes (anchors from the telemetry heartbeat's ``epoch_ms``)."""
    epochs = epochs or {}
    out: List[tuple] = []
    for t in (tracers if tracers is not None else all_tracers()):
        ep = epochs.get(t.role, t.epoch)
        out.extend((sp, ep) for sp in t.spans())
    out.sort(key=lambda pair: pair[1] + pair[0].start)
    return out


def to_chrome_trace(tracers: Optional[Iterable[Tracer]] = None,
                    epochs: Optional[Dict[str, float]] = None,
                    journal_events: Optional[Iterable[Dict]] = None) -> Dict:
    """Chrome trace-event JSON dict: one complete event ("ph": "X") per
    span, one pid per tracer role (with process_name metadata), tids
    mapped to small ints per role, and one Perfetto flow-event pair
    (``ph:"s"`` / ``ph:"f"``) per causal ``follows`` edge whose origin
    span is part of this export. ``journal_events`` (merged cluster
    journal dicts, obs/journal.py) draw as instant markers (``ph:"i"``)
    on the same wall-clock timeline — spans already use wall-anchored
    timestamps, so the two align without translation."""
    events: List[Dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    # span_id → (span, epoch, pid, tid) for flow-event origin lookup
    placed: Dict[int, tuple] = {}
    pairs = collect_spans_with_epochs(tracers, epochs)
    for sp, ep in pairs:
        pid = pids.setdefault(sp.role, len(pids) + 1)
        tid = tids.setdefault((sp.role, sp.tid), len(tids) + 1)
        placed[sp.span_id] = (sp, ep, pid, tid)
        args = dict(sp.args)
        args["span_id"] = sp.span_id
        if sp.trace_id:
            args["trace_id"] = f"{sp.trace_id:#x}"
        if sp.parent_id:
            args["parent_span"] = sp.parent_id
        events.append({
            "name": sp.name,
            "cat": "shuffle",
            "ph": "X",
            "ts": (ep + sp.start) * 1e6,
            "dur": max(0.0, (sp.end - sp.start) * 1e6),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    flow_ids = itertools.count(1)
    flows: List[Dict] = []
    for sp, ep in pairs:
        if not sp.follows:
            continue
        _, _, pid, tid = placed[sp.span_id]
        for _tid_unused, origin_id in sp.follows:
            origin = placed.get(origin_id)
            if origin is None:
                continue  # origin fell off a bounded deque or lives remote
            osp, oep, opid, otid = origin
            fid = next(flow_ids)
            flows.append({
                "name": "critpath", "cat": "critpath", "ph": "s",
                "id": fid, "ts": (oep + osp.end) * 1e6,
                "pid": opid, "tid": otid,
                "args": {"from_span": osp.span_id, "to_span": sp.span_id},
            })
            flows.append({
                "name": "critpath", "cat": "critpath", "ph": "f",
                "bp": "e", "id": fid, "ts": (ep + sp.start) * 1e6,
                "pid": pid, "tid": tid,
                "args": {"from_span": osp.span_id, "to_span": sp.span_id},
            })
    instants: List[Dict] = []
    if journal_events:
        from sparkrdma_tpu_torch.obs.journal import events_to_chrome

        jpid = len(pids) + 1
        instants = events_to_chrome(journal_events, pid=jpid)
        pids["journal"] = jpid
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": role}}
        for role, pid in sorted(pids.items(), key=lambda kv: kv[1])
    ]
    return {"traceEvents": meta + events + flows + instants,
            "displayTimeUnit": "ms"}


def export_chrome_trace(path: str,
                        tracers: Optional[Iterable[Tracer]] = None,
                        epochs: Optional[Dict[str, float]] = None,
                        journal_events: Optional[Iterable[Dict]] = None
                        ) -> Dict:
    """Write the Chrome trace JSON to ``path`` and return the dict."""
    doc = to_chrome_trace(tracers, epochs, journal_events=journal_events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc
