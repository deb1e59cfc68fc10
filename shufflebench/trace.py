"""From a ``torch.profiler`` trace to the harness's device numbers.

A traced stretch runs a number of stages under the profiler and keeps
its events in memory as plain tuples (:class:`Ev`); nothing is written
to disk. Everything after :func:`capture` is plain arithmetic on those
tuples, so the tests drive it with synthetic events:

- :func:`union_ns` / :func:`gaps`: device activity (kernels, copies,
  fills) merged into busy intervals, and the idle gaps between them;
- :func:`by_module`: each device event's time attributed to the
  innermost ``sparkrdma_tpu_torch/`` frame of the Python stack that
  launched it. The launching op is found by the kernel's link to its
  PyTorch op, or else by its CUDA runtime launch (kernels of the
  package's own library are launched through ``ctypes``, with no op
  around them); the stack is the nest of :class:`PackageFrames`'
  annotations open on that thread at the launch;
- :func:`top_device_ops` / :func:`gaps_by_host`: the ``breakdown`` of a
  traced run's result line.
"""

from __future__ import annotations

import re
import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

PACKAGE = "sparkrdma_tpu_torch/"
OTHER = "other"


class Ev(NamedTuple):
    """One profiler event. ``kind``: ``device`` (kernel, copy, fill on
    the card), ``python`` (a package function's frame), ``op``
    (a PyTorch op or other host event) or ``runtime`` (a CUDA runtime or
    driver call on the host, ``cu*``). A device event's ``linked`` is
    the correlation of the op that launched it (0: none), its ``corr``
    that of its runtime launch."""

    name: str
    kind: str
    start_ns: int
    end_ns: int
    corr: int
    linked: int
    thread: int


class Trace(NamedTuple):
    events: List[Ev]
    stages: int
    stretch_s: float  # host clock over the traced stages, ending in a sync


FRAME = re.compile(r"^.*\.py\(\d+\): ")  # how PackageFrames names a frame


def _kind(e, cuda_type) -> str:
    if e.device_type() == cuda_type:
        return "device"
    name = e.name()
    if FRAME.match(name):
        return "python"
    return "runtime" if name.startswith("cu") else "op"


class PackageFrames:
    """While active, each call of a function defined in the package
    opens a profiler annotation named as the Python tracer names a frame
    (``.../sparkrdma_tpu_torch/ops/sort.py(107): device_sort``), and its
    return, yield or unwind closes it. Built on ``sys.monitoring``:
    every other code location is switched off at its first event, so
    the cost falls on the package's own calls. (The profiler's own
    Python tracer, ``with_stack=True``, records no frames under some
    PyTorch versions.)"""

    EVENTS = ("PY_START", "PY_RESUME", "PY_RETURN", "PY_YIELD", "PY_UNWIND")

    def __init__(self, package: str = PACKAGE):
        self.package = package
        self.tool = None
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, code, offset):
        if self.package not in code.co_filename:
            return sys.monitoring.DISABLE
        rf = self._record(f"{code.co_filename}({code.co_firstlineno}): {code.co_qualname}")
        rf.__enter__()
        self._stack().append((code, rf))
        return None

    def _close(self, code, offset, arg):
        if self.package not in code.co_filename:
            return sys.monitoring.DISABLE
        self._pop(code)
        return None

    def _unwind(self, code, offset, exc):
        if self.package in code.co_filename:
            self._pop(code)

    def _pop(self, code) -> None:
        st = self._stack()
        if not any(c is code for c, _ in st):
            return
        while st:
            c, rf = st.pop()
            rf.__exit__(None, None, None)
            if c is code:
                return

    def __enter__(self):
        import torch

        fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
        self._record = fast or torch.autograd.profiler.record_function
        mon = sys.monitoring
        self.tool = next(t for t in range(2, 6) if mon.get_tool(t) is None)
        mon.use_tool_id(self.tool, "shufflebench")
        handlers = {"PY_START": self._open, "PY_RESUME": self._open,
                    "PY_RETURN": self._close, "PY_YIELD": self._close,
                    "PY_UNWIND": self._unwind}
        mask = 0
        for name, fn in handlers.items():
            event = getattr(mon.events, name)
            mon.register_callback(self.tool, event, fn)
            mask |= event
        mon.restart_events()
        mon.set_events(self.tool, mask)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        mon.set_events(self.tool, 0)
        for name in self.EVENTS:
            mon.register_callback(self.tool, getattr(mon.events, name), None)
        mon.free_tool_id(self.tool)
        st = self._stack()
        while st:
            st.pop()[1].__exit__(None, None, None)
        return False


def capture(stage: Callable[[], None], stages: int, frames: bool,
            sync: Callable[[], None]) -> Trace:
    """Run ``stage`` ``stages`` times under the profiler (host and CUDA
    activity; with ``frames``, the package's Python frames as
    annotations, :class:`PackageFrames`) and keep the events."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with PackageFrames() if frames else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(stages):
                stage()
            sync()
            stretch = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [Ev(e.name(), _kind(e, cuda), int(e.start_ns()), int(e.end_ns()),
                 int(e.correlation_id()), int(e.linked_correlation_id()),
                 int(e.start_thread_id()))
              for e in prof.profiler.kineto_results.events()]
    return Trace(events, stages, stretch)


# ----------------------------------------------------------------------
# busy time and idle gaps
def merged_intervals(events: Sequence[Ev]) -> List[Tuple[int, int]]:
    """The device events' intervals, merged where they overlap."""
    spans = sorted((e.start_ns, e.end_ns) for e in events if e.kind == "device")
    out: List[List[int]] = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def union_ns(events: Sequence[Ev]) -> int:
    """Nanoseconds in which at least one device activity ran."""
    return sum(t - s for s, t in merged_intervals(events))


def gaps(events: Sequence[Ev]) -> List[Tuple[int, int]]:
    """The idle gaps between the device's busy intervals."""
    iv = merged_intervals(events)
    return [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]


# ----------------------------------------------------------------------
# attribution to the package's modules
def module_of(frame: str) -> Optional[str]:
    """``ops/sort.py`` for a Python tracer frame such as
    ``.../sparkrdma_tpu_torch/ops/sort.py(107): device_sort``; None for
    a frame outside the package."""
    at = frame.find(PACKAGE)
    if at < 0:
        return None
    return frame[at + len(PACKAGE):].split("(", 1)[0]


def _sweep(frames: Sequence[Ev], queries: Sequence[Tuple[int, object]]
           ) -> Dict[object, Optional[str]]:
    """For each ``(time, key)`` query, the innermost frame open at that
    time on ``frames``' thread (None where none is). Frames of one
    thread nest, so one sweep with a stack answers every query."""
    items = [(f.start_ns, 0, -f.end_ns, i) for i, f in enumerate(frames)]
    items += [(t, 1, 0, i) for i, (t, _) in enumerate(queries)]
    items.sort()
    stack: List[Tuple[int, str]] = []  # (end, frame)
    out: Dict[object, Optional[str]] = {}
    for t, typ, _, i in items:
        while stack and stack[-1][0] < t:
            stack.pop()
        if typ == 0:
            stack.append((frames[i].end_ns, frames[i].name))
        else:
            out[queries[i][1]] = stack[-1][1] if stack else None
    return out


def _launch_modules(events: Sequence[Ev]) -> Tuple[Dict[int, str], Dict[int, str]]:
    """For every op and runtime call, the module of the innermost package
    frame open at its start: ``(by op correlation, by runtime
    correlation)``."""
    frames: Dict[int, List[Ev]] = defaultdict(list)
    queries: Dict[int, List[Tuple[int, object]]] = defaultdict(list)
    for e in events:
        if e.kind == "python":
            frames[e.thread].append(e)
        elif e.kind in ("op", "runtime"):
            queries[e.thread].append((e.start_ns, (e.kind, e.corr)))
    ops: Dict[int, str] = {}
    runtime: Dict[int, str] = {}
    for thread, qs in queries.items():
        for (kind, corr), frame in _sweep(frames.get(thread, []), qs).items():
            if frame is not None:
                (ops if kind == "op" else runtime)[corr] = module_of(frame)
    return ops, runtime


def by_module(events: Sequence[Ev]) -> Dict[str, int]:
    """Device nanoseconds by launching module (``other`` where no
    package frame is found)."""
    ops, runtime = _launch_modules(events)
    out: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.kind == "device":
            mod = (e.linked and ops.get(e.linked)) or runtime.get(e.corr) or OTHER
            out[mod] += e.end_ns - e.start_ns
    return dict(out)


# ----------------------------------------------------------------------
# the breakdown
def top_device_ops(events: Sequence[Ev], k: int = 10) -> List[list]:
    """The ``k`` device operations that took most time: ``[[name,
    seconds], ...]``."""
    tot: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.kind == "device":
            tot[e.name] += e.end_ns - e.start_ns
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:120], ns / 1e9] for name, ns in top]


def _short(frame: str) -> str:
    mod = module_of(frame)
    return frame if mod is None else mod + frame[frame.find("("):]


def gaps_by_host(events: Sequence[Ev], k: int = 10) -> List[list]:
    """Idle gaps summed by the innermost package frame open on the
    launching thread at each gap's middle (``[[frame, seconds], ...]``,
    the ``k`` largest). The launching thread is the one that started
    most ops."""
    counts: Dict[int, int] = defaultdict(int)
    for e in events:
        if e.kind == "op":
            counts[e.thread] += 1
    if not counts:
        return []
    main = max(counts, key=counts.get)
    frames = [e for e in events if e.kind == "python" and e.thread == main]
    idle = gaps(events)
    seen = _sweep(frames, [((s + t) // 2, i) for i, (s, t) in enumerate(idle)])
    tot: Dict[str, int] = defaultdict(int)
    for i, (s, t) in enumerate(idle):
        frame = seen.get(i)
        label = "host (no package frame open)" if frame is None else _short(frame)
        tot[label[:160]] += t - s
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[label, ns / 1e9] for label, ns in top]
