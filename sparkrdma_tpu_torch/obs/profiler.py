"""Continuous profiling plane: span-correlated wall-clock sampling.

The third telemetry pillar next to metrics (obs/metrics.py) and spans
(obs/trace.py): an always-on, low-overhead **sampling profiler** that
answers the question the critical-path walk cannot — *what was the CPU
actually doing* during the intervals no span explains.

:class:`SamplingProfiler` is a timer thread over
``sys._current_frames()``: every ``1/hz`` seconds it snapshots every
thread's stack (bounded depth), tags each sample with the sampled
thread's

- **tenant** (``tenancy.tenant_of_ident`` — the cross-thread view of
  the ``tenant_scope`` thread-local),
- **active span category** (``trace.active_span_of_ident`` → the
  innermost open span, classified by ``attr.classify`` into the fixed
  attribution vocabulary; ``untraced`` when no span is open), and
- **role** (the executor id / process role, as a metric label),

and folds samples into a collapsed-stack table (root-first
``mod:func;mod:func`` keys). Tables ride the existing telemetry plane:
``Heartbeater.beat()`` drains the fold into the heartbeat payload's
``"profile"`` field, and the driver-side :class:`TelemetryHub` routes
it into a :class:`ProfileHub` that merges cluster-wide and renders
folded-stack text or a self-contained HTML flamegraph.

A bounded recent-sample ring (timestamped on the ``perf_counter``
axis) additionally lets ``obs/critpath.py`` annotate critical-path
**gap segments** with the dominant frames observed inside each gap
(:func:`annotate_gaps`), so ``last_breakdown`` shows idle-untraced
intervals as "blocked in ``socket.recv``" rather than a blank.

The sampler's own self-time accrues to ``profile.overhead_ms``.

A copy of the JAX package's ``obs/profiler.py``, its imports rewritten
to this package. The driver's ``TelemetryHub`` merges the executors'
tables (``ProfileHub``); the obs CLI's ``--flamegraph`` and
``--folded`` render them (``python -m sparkrdma_tpu_torch.obs``). The
engine's contexts and workers run the sampler, and ``job_breakdown``
annotates gap segments from it.

Stdlib-only and jax-free, like the rest of ``obs/``.
"""

from __future__ import annotations

import html
import json
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from sparkrdma_tpu_torch.obs import trace as _trace
from sparkrdma_tpu_torch.obs.attr import classify
from sparkrdma_tpu_torch.obs.metrics import get_registry

# span-category tag for samples on threads with no open span
UNTRACED = "untraced"


def _tenant_of_ident(ident: int) -> str:
    # lazy: tenancy's submodules import the obs package, so a module-
    # level import here would close a cycle through obs/__init__
    from sparkrdma_tpu_torch.tenancy import tenant_of_ident

    return tenant_of_ident(ident)

# modules whose frames are pure profiler/telemetry plumbing; stacks
# that bottom out here are the plane observing itself, not workload
_SELF_MODULE = __name__


class SamplingProfiler:
    """Wall-clock sampling profiler for one process.

    One daemon timer thread; ``sample_once`` walks
    ``sys._current_frames()`` (excluding itself), folds each stack into
    the per-window collapsed table, and appends to the recent-sample
    ring used for gap annotation. All hot structures are plain dicts
    under one short-lived lock — the sampler never calls back into
    workload code and never holds a named (lock-order-tracked) lock.
    """

    def __init__(self, registry=None, *, role: str = "proc", hz: int = 19,
                 max_frames: int = 48, window_ms: int = 2000,
                 max_stacks: int = 4000, recent_samples: int = 8192):
        self.registry = registry if registry is not None else get_registry()
        self.role = role
        self.hz = max(1, int(hz))
        self.max_frames = max(4, int(max_frames))
        self.window_ms = max(100, int(window_ms))
        self.max_stacks = max(16, int(max_stacks))
        self._fold: Dict[Tuple[str, str, str], int] = {}
        self._fold_lock = threading.Lock()
        # (perf_counter_t, tenant, category, stack) — bounded ring for
        # time-windowed queries (gap annotation, flight-record window)
        self._recent: "deque[Tuple[float, str, str, str]]" = deque(
            maxlen=max(256, int(recent_samples))
        )
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._c_samples = self.registry.counter("profile.samples", role=role)
        self._c_dropped = self.registry.counter("profile.dropped", role=role)
        self._c_overhead = self.registry.counter(
            "profile.overhead_ms", role=role
        )
        self._g_stacks = self.registry.gauge("profile.stacks", role=role)

    # -- lifecycle --------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        _trace.set_span_watch(True)
        self._stop_ev.clear()
        t = threading.Thread(
            target=self._run, name="sparkrdma-profiler", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        _trace.set_span_watch(False)

    def _run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop_ev.wait(period):
            try:
                self.sample_once()
            except Exception:
                # a torn frame walk (thread exiting mid-snapshot) is a
                # dropped sample, never a crashed profiler
                self._c_dropped.inc()

    # -- sampling ---------------------------------------------------------
    def _fold_stack(self, frame) -> str:
        parts: List[str] = []
        depth = 0
        f = frame
        while f is not None and depth < 4 * self.max_frames:
            code = f.f_code
            parts.append(f"{f.f_globals.get('__name__', '?')}:{code.co_name}")
            f = f.f_back
            depth += 1
        parts.reverse()  # root-first, flamegraph.pl folded convention
        if len(parts) > self.max_frames:
            parts = ["..."] + parts[-self.max_frames:]
        return ";".join(parts)

    def sample_once(self) -> int:
        """One snapshot of every thread; returns samples recorded."""
        t0 = time.perf_counter()
        frames = sys._current_frames()
        own = threading.get_ident()
        rows: List[Tuple[str, str, str]] = []
        for ident, frame in frames.items():
            if ident == own:
                continue
            stack = self._fold_stack(frame)
            if not stack:
                continue
            tenant = _tenant_of_ident(ident)
            sp = _trace.active_span_of_ident(ident)
            category = classify(sp.name) if sp is not None else UNTRACED
            rows.append((tenant, category, stack))
        del frames  # drop the frame refs before doing anything else
        t_sample = time.perf_counter()
        n = 0
        dropped = 0
        with self._fold_lock:
            for key in rows:
                cnt = self._fold.get(key)
                if cnt is not None:
                    self._fold[key] = cnt + 1
                elif len(self._fold) < self.max_stacks:
                    self._fold[key] = 1
                else:
                    dropped += 1
                    continue
                n += 1
        for tenant, category, stack in rows:
            self._recent.append((t_sample, tenant, category, stack))
        if n:
            self._c_samples.inc(n)
        if dropped:
            self._c_dropped.inc(dropped)
        self._g_stacks.set(len(self._fold))
        self._c_overhead.inc((time.perf_counter() - t0) * 1e3)
        return n

    # -- table export -----------------------------------------------------
    def drain(self) -> Optional[dict]:
        """Swap out the collapsed-stack table folded since the last
        drain — the heartbeat's ``"profile"`` payload. None when no
        samples landed (so idle beats stay small)."""
        with self._fold_lock:
            if not self._fold:
                return None
            fold, self._fold = self._fold, {}
        rows = [[t, c, s, n] for (t, c, s), n in fold.items()]
        return {"hz": self.hz, "rows": rows}

    def window_rows(self, window_ms: Optional[int] = None) -> List[list]:
        """Collapsed rows for the trailing ``window_ms`` only (from the
        recent-sample ring) — the flight recorder's last-window view."""
        win_s = (window_ms if window_ms is not None else self.window_ms) / 1e3
        cutoff = time.perf_counter() - win_s
        fold: Dict[Tuple[str, str, str], int] = {}
        for t, tenant, category, stack in list(self._recent):
            if t >= cutoff:
                key = (tenant, category, stack)
                fold[key] = fold.get(key, 0) + 1
        return [[t, c, s, n] for (t, c, s), n in fold.items()]

    def frames_between(self, t0: float, t1: float,
                       top: int = 3) -> List[list]:
        """Dominant leaf frames sampled inside ``[t0, t1]`` as
        ``[[frame, count], ...]``. The interval may be on either time
        axis: raw ``perf_counter`` (in-process critical paths) or
        wall-clock seconds (epoch-rebased merges) — wall-clock inputs
        are shifted back by the process epoch anchor."""
        if t1 <= t0:
            return []
        if t0 > 1e8:  # wall-clock axis (perf_counter is process uptime)
            shift = _trace.epoch_anchor()
            t0, t1 = t0 - shift, t1 - shift
        counts: Dict[str, int] = {}
        for t, _tenant, _category, stack in list(self._recent):
            if t0 <= t <= t1:
                leaf = stack.rsplit(";", 1)[-1]
                counts[leaf] = counts.get(leaf, 0) + 1
        ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return [[frame, cnt] for frame, cnt in ranked[:max(1, top)]]


# ----------------------------------------------------------------------
# process-wide profiler (refcounted: contexts/workers share one)
# ----------------------------------------------------------------------
_proc_lock = threading.Lock()
_proc_profiler: Optional[SamplingProfiler] = None
_proc_refs = 0


def acquire_profiler(conf=None, *, role: str = "proc",
                     registry=None) -> Optional[SamplingProfiler]:
    """Refcounted process-wide sampler. Returns None when
    ``tpu.shuffle.obs.profile.enabled`` is off; otherwise starts (or
    shares) the singleton — one timer thread per process no matter how
    many contexts/managers are live. Pair with :func:`release_profiler`.
    """
    global _proc_profiler, _proc_refs
    if conf is not None and not conf.profile_enabled:
        return None
    with _proc_lock:
        if _proc_profiler is None:
            kwargs = {}
            if conf is not None:
                kwargs = dict(
                    hz=conf.profile_hz,
                    max_frames=conf.profile_max_frames,
                    window_ms=conf.profile_window_ms,
                )
            _proc_profiler = SamplingProfiler(
                registry, role=role, **kwargs
            ).start()
            _proc_refs = 0
        _proc_refs += 1
        return _proc_profiler


def release_profiler(profiler: Optional[SamplingProfiler]) -> None:
    """Drop one reference; the last release stops the sampler thread."""
    global _proc_profiler, _proc_refs
    if profiler is None:
        return
    with _proc_lock:
        if profiler is not _proc_profiler:
            profiler.stop()  # a privately constructed sampler
            return
        _proc_refs -= 1
        if _proc_refs > 0:
            return
        _proc_profiler = None
        _proc_refs = 0
    profiler.stop()


def get_profiler() -> Optional[SamplingProfiler]:
    """The live process-wide sampler, or None."""
    return _proc_profiler


def annotate_gaps(path, top: int = 3) -> int:
    """Attach ``frames`` ([[frame, count], ...]) to every gap segment
    of a :class:`~sparkrdma_tpu_torch.obs.critpath.CriticalPath` from the
    process profiler's recent samples. No-op (0) without a live
    profiler; returns the number of gaps annotated."""
    profiler = _proc_profiler
    if profiler is None:
        return 0
    n = 0
    for seg in path.segments:
        if seg.kind != "gap":
            continue
        frames = profiler.frames_between(seg.t0, seg.t1, top=top)
        if frames:
            seg.frames = frames
            n += 1
    return n


# ----------------------------------------------------------------------
# driver-side cluster merge
# ----------------------------------------------------------------------
class ProfileHub:
    """Merges per-executor collapsed-stack tables cluster-wide.

    Fed by ``TelemetryHub.ingest`` with each heartbeat's ``"profile"``
    payload; keeps (a) the bounded cluster-wide fold keyed
    ``(executor, tenant, category, stack)``, (b) the last non-empty
    window per executor (flight recorder), and (c) per-executor sample
    rates so counts convert to self-time.
    """

    def __init__(self, max_stacks: int = 20000, clock=time.time):
        self._lock = threading.Lock()
        self._merged: Dict[Tuple[str, str, str, str], int] = {}
        self._hz: Dict[str, float] = {}
        self._last_window: Dict[str, dict] = {}
        self._samples = 0
        self._dropped = 0
        self.max_stacks = max(16, int(max_stacks))
        self._clock = clock

    def ingest(self, executor_id: str, profile: Optional[dict],
               wall_ms: Optional[float] = None) -> int:
        """Fold one executor's drained table in; returns rows merged."""
        if not profile:
            return 0
        rows = profile.get("rows") or []
        hz = float(profile.get("hz") or 0.0)
        if not rows:
            return 0
        with self._lock:
            if hz > 0:
                self._hz[executor_id] = hz
            for tenant, category, stack, n in rows:
                key = (executor_id, str(tenant), str(category), str(stack))
                cnt = self._merged.get(key)
                if cnt is not None:
                    self._merged[key] = cnt + int(n)
                elif len(self._merged) < self.max_stacks:
                    self._merged[key] = int(n)
                else:
                    self._dropped += int(n)
                    continue
                self._samples += int(n)
            self._last_window[executor_id] = {
                "wall_ms": float(wall_ms if wall_ms is not None
                                 else self._clock() * 1e3),
                "hz": hz,
                "rows": [list(r) for r in rows],
            }
        return len(rows)

    def ingest_local(self, profiler: Optional[SamplingProfiler],
                     executor_id: Optional[str] = None) -> int:
        """Drain a same-process sampler straight into the merge (no
        heartbeat hop) — the CLI demo / driver-role path."""
        if profiler is None:
            return 0
        return self.ingest(executor_id or profiler.role, profiler.drain())

    # -- views ------------------------------------------------------------
    @property
    def total_samples(self) -> int:
        with self._lock:
            return self._samples

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def executors(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in self._merged})

    def merged_rows(self) -> List[list]:
        """``[[executor, tenant, category, stack, count], ...]`` —
        descending by count."""
        with self._lock:
            items = sorted(self._merged.items(), key=lambda kv: -kv[1])
        return [[e, t, c, s, n] for (e, t, c, s), n in items]

    def category_self_ms(self) -> Dict[str, float]:
        """Per-span-category self-time (ms) implied by sample counts at
        each executor's sampling rate."""
        out: Dict[str, float] = {}
        with self._lock:
            for (executor, _t, category, _s), n in self._merged.items():
                hz = self._hz.get(executor) or 1.0
                out[category] = out.get(category, 0.0) + n * 1e3 / hz
        return {k: round(v, 3) for k, v in sorted(out.items())}

    def last_windows(self, top_rows: int = 40) -> Dict[str, dict]:
        """Last non-empty profile window per executor, rows trimmed to
        the ``top_rows`` hottest — the flight recorder attachment."""
        with self._lock:
            out = {}
            for executor, win in self._last_window.items():
                rows = sorted(win["rows"], key=lambda r: -r[3])[:top_rows]
                out[executor] = {
                    "wall_ms": win["wall_ms"], "hz": win["hz"], "rows": rows,
                }
            return out

    def summary(self) -> dict:
        with self._lock:
            return {
                "samples": self._samples,
                "stacks": len(self._merged),
                "dropped": self._dropped,
                "executors": sorted({k[0] for k in self._merged}),
            }

    # -- rendering --------------------------------------------------------
    def folded(self, tags: bool = True) -> str:
        """flamegraph.pl collapsed-stack text: one
        ``frame;frame;... count`` line per stack. With ``tags`` the
        executor / ``tenant:`` / ``span:`` tags lead the stack as
        synthetic frames, so any folded-stack tool groups by them."""
        lines = []
        for executor, tenant, category, stack, n in self.merged_rows():
            if tags:
                prefix = f"{executor};tenant:{tenant};span:{category};"
            else:
                prefix = ""
            lines.append(f"{prefix}{stack} {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    def flamegraph_html(self, title: str = "sparkrdma_tpu_torch profile",
                        tags: bool = True) -> str:
        """Self-contained HTML flamegraph (no external assets)."""
        stacks: List[Tuple[List[str], int]] = []
        for executor, tenant, category, stack, n in self.merged_rows():
            frames = stack.split(";")
            if tags:
                frames = [executor, f"tenant:{tenant}",
                          f"span:{category}"] + frames
            stacks.append((frames, n))
        return render_flamegraph_html(stacks, title=title)


# ----------------------------------------------------------------------
# self-contained HTML flamegraph renderer
# ----------------------------------------------------------------------
def _fold_tree(stacks: Sequence[Tuple[Sequence[str], int]]) -> dict:
    root: dict = {"n": "all", "v": 0, "c": {}}
    for frames, count in stacks:
        root["v"] += count
        node = root
        for frame in frames:
            child = node["c"].get(frame)
            if child is None:
                child = {"n": frame, "v": 0, "c": {}}
                node["c"][frame] = child
            child["v"] += count
            node = child
    def _listify(node: dict) -> dict:
        return {
            "n": node["n"], "v": node["v"],
            "c": [_listify(ch) for ch in sorted(
                node["c"].values(), key=lambda d: -d["v"])],
        }
    return _listify(root)


_FLAME_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { font: 12px monospace; margin: 12px; background: #fff; }
 #hdr { margin-bottom: 8px; }
 #status { color: #555; margin-top: 6px; min-height: 1.2em; }
 .fr { position: absolute; box-sizing: border-box; height: 17px;
       overflow: hidden; white-space: nowrap; cursor: pointer;
       border: 1px solid #fff; border-radius: 2px; padding: 0 3px;
       color: #222; }
 .fr:hover { border-color: #000; }
 #flame { position: relative; width: 100%; }
 a { color: #36c; cursor: pointer; }
</style></head><body>
<div id="hdr"><b>__TITLE__</b> — <span id="total"></span> samples
 · click a frame to zoom · <a id="reset">reset</a>
 <div id="status"></div></div>
<div id="flame"></div>
<script>
var DATA = __DATA__;
var flame = document.getElementById('flame');
var status_ = document.getElementById('status');
document.getElementById('total').textContent = DATA.v;
function color(name, depth) {
  if (name.indexOf('tenant:') === 0) return '#c8e6c9';
  if (name.indexOf('span:') === 0) return '#bbdefb';
  var h = 0;
  for (var i = 0; i < name.length; i++) h = (h * 31 + name.charCodeAt(i)) >>> 0;
  return 'hsl(' + (20 + h % 35) + ',' + (60 + h % 30) + '%,' +
         (62 + (h >> 8) % 14) + '%)';
}
function render(root) {
  flame.innerHTML = '';
  var W = flame.clientWidth || 960;
  var maxDepth = 0;
  function walk(node, x, depth, scale) {
    var w = node.v * scale;
    if (w < 1) return;
    if (depth > maxDepth) maxDepth = depth;
    var d = document.createElement('div');
    d.className = 'fr';
    d.style.left = x + 'px';
    d.style.top = (depth * 17) + 'px';
    d.style.width = Math.max(1, w - 1) + 'px';
    d.style.background = color(node.n, depth);
    d.textContent = node.n;
    d.title = node.n + ' — ' + node.v + ' samples (' +
              (100 * node.v / DATA.v).toFixed(1) + '%)';
    d.onclick = function (ev) { ev.stopPropagation(); zoom(node); };
    flame.appendChild(d);
    var cx = x;
    for (var i = 0; i < node.c.length; i++) {
      walk(node.c[i], cx, depth + 1, scale);
      cx += node.c[i].v * scale;
    }
  }
  walk(root, 0, 0, W / root.v);
  flame.style.height = ((maxDepth + 1) * 17 + 4) + 'px';
}
function zoom(node) {
  status_.textContent = (node === DATA) ? '' :
    'zoomed: ' + node.n + ' (' + node.v + ' samples)';
  render(node);
}
document.getElementById('reset').onclick = function () { zoom(DATA); };
window.onresize = function () { render(DATA); };
render(DATA);
</script></body></html>
"""


def render_flamegraph_html(stacks: Sequence[Tuple[Sequence[str], int]],
                           title: str = "profile") -> str:
    """Render collapsed stacks (``(frames_root_first, count)`` pairs)
    as one fully inline HTML document — no network, no external JS."""
    tree = _fold_tree(stacks)
    return (_FLAME_TEMPLATE
            .replace("__TITLE__", html.escape(title))
            .replace("__DATA__", json.dumps(tree)))
