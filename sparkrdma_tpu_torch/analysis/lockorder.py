"""Runtime lock-order detector — cycle and held-lock-blocking checks.

The shuffle stack's deadlock freedom rests on documented acquisition
orders (manager: shuffle lock OUTER / state lock inner; hbm arena:
buffer lock OUTER / manager lock inner) that nothing enforced. This
module provides :func:`named_lock`, a drop-in ``threading.Lock`` /
``RLock`` wrapper that, while a detector is enabled:

- maintains a per-thread stack of held locks,
- records the global acquisition-order graph keyed by lock NAME (two
  per-shuffle locks are the same vertex — order violations between
  instances of one role are exactly the interesting ones),
- flags a cycle in that graph the moment the closing edge is recorded
  (the canonical AB/BA deadlock, caught even when the interleaving
  that would actually deadlock never fires in the run),
- flags nesting two *different instances* under one name (self
  deadlock risk) unless the name opts in via ``allow_self_nest``,
- flags blocking calls (``time.sleep``, ``socket.create_connection``)
  made while holding a lock marked ``hot`` — hot-path locks must
  never be held across I/O.

When no detector is enabled the wrapper costs one attribute load and
one branch per acquire/release; tier-1 runs it permanently. The pytest
plugin (:mod:`.pytest_plugin`) enables the default detector when
``SPARKRDMA_LOCK_ORDER=1`` and fails the session on violations.

``named_lock`` works inside ``threading.Condition`` — the Condition
falls back to the wrapper's plain ``acquire``/``release``, so waits
correctly pop/push the held stack.

A copy of the JAX package's ``analysis/lockorder.py``, its imports
rewritten to this package (the model-checker hook reads the port's
``analysis/modelcheck/sched.py`` ``active`` at every acquire and
release, as the JAX module reads its package's), with one change: the
blocking-call probes chain. Both packages' detectors may be armed
  in one process (a test session loads both pytest plugins), and each
  patches ``time.sleep`` and ``socket.create_connection``. The port's
  probe calls whatever it replaced (the JAX probe, or the real
  function), and puts it back on disarm only while the patched
  attribute is still its own probe. What it puts back may be a probe of
  another detector module of the same layout (the JAX package's) whose
  detectors are all disarmed, because that module left the patch alone
  while the port's probe sat on top: such an inert probe is unwound to
  what it stands on, so both disarmed leave the real functions. The
  JAX probe calls the function it saw at its import and never the
  port's, so the port's detector sees blocking calls only when it is
  armed after the JAX package's, as a pytest session arms them
  (``pytest_plugin.py``).
"""

from __future__ import annotations

import socket
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

from sparkrdma_tpu_torch.analysis.modelcheck import sched as _sched

__all__ = ["LockOrderDetector", "OrderedLock", "named_lock", "default"]


class LockOrderDetector:
    """Acquisition-graph recorder; one global default + test instances."""

    def __init__(self) -> None:
        self.enabled = False
        self._meta = threading.Lock()  # guards edges/violations
        # name -> set of names acquired WHILE name was held
        self.edges: Dict[str, Set[str]] = {}
        self.edge_sites: Dict[Tuple[str, str], str] = {}
        self.violations: List[str] = []
        self._tls = threading.local()

    # -- held stack -------------------------------------------------------
    def _held(self) -> List["OrderedLock"]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def held_names(self) -> List[str]:
        return [loc.name for loc in self._held()]

    # -- lifecycle --------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True
        _activate(self)

    def disable(self) -> None:
        self.enabled = False
        _deactivate(self)

    def reset(self) -> None:
        with self._meta:
            self.edges.clear()
            self.edge_sites.clear()
            self.violations.clear()

    # -- recording --------------------------------------------------------
    def _site(self) -> str:
        # two frames above the wrapper: the `with lock:` caller
        for f in reversed(traceback.extract_stack(limit=8)[:-3]):
            if "lockorder" not in f.filename:
                return f"{f.filename}:{f.lineno}"
        return "?"

    def _violate(self, msg: str) -> None:
        with self._meta:
            self.violations.append(msg)

    def on_acquire(self, lock: "OrderedLock") -> None:
        held = self._held()
        if any(h is lock for h in held):
            # re-entrant acquire of the same instance (RLock): no new
            # ordering information
            held.append(lock)
            return
        for h in held:
            if h.name == lock.name:
                if not lock.allow_self_nest:
                    self._violate(
                        f"same-name lock nesting: {lock.name!r} acquired "
                        f"while another {h.name!r} instance is held "
                        f"(thread {threading.current_thread().name}, "
                        f"at {self._site()})"
                    )
                continue
            self._add_edge(h.name, lock.name)
        held.append(lock)

    def on_release(self, lock: "OrderedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def on_blocking_call(self, what: str) -> None:
        for h in self._held():
            if h.hot:
                self._violate(
                    f"blocking call {what} while holding hot-path lock "
                    f"{h.name!r} (thread "
                    f"{threading.current_thread().name}, at {self._site()})"
                )

    def _add_edge(self, a: str, b: str) -> None:
        with self._meta:
            succ = self.edges.setdefault(a, set())
            if b in succ:
                return
            succ.add(b)
            self.edge_sites[(a, b)] = self._site()
            path = self._find_path(b, a)
        if path is not None:
            cycle = " -> ".join([a, *path])
            sites = "; ".join(
                f"{x}->{y} at {self.edge_sites.get((x, y), '?')}"
                for x, y in zip([a, *path][:-1], [a, *path][1:])
                if (x, y) in self.edge_sites
            )
            self._violate(
                f"lock-order cycle: {cycle} (edges: {sites})"
            )

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src..dst in the edge graph (caller holds _meta)."""
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


class OrderedLock:
    """Named Lock/RLock wrapper feeding a :class:`LockOrderDetector`."""

    __slots__ = ("name", "hot", "allow_self_nest", "_det", "_lock")

    def __init__(
        self,
        name: str,
        *,
        hot: bool = False,
        recursive: bool = False,
        allow_self_nest: bool = False,
        detector: Optional[LockOrderDetector] = None,
    ):
        self.name = name
        self.hot = hot
        self.allow_self_nest = allow_self_nest or recursive
        self._det = detector or default
        self._lock = threading.RLock() if recursive else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # model-checker seam (analysis/modelcheck/sched.py): one module
        # attr-load + branch when no scheduler is active, mirroring the
        # detector's enabled flag. Non-blocking try-locks never park.
        sim = _sched.active
        if sim is not None and blocking:
            sim.before_lock_acquire(self)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            if self._det.enabled:
                self._det.on_acquire(self)
            if sim is not None:
                sim.after_lock_acquire(self)
        return ok

    def release(self) -> None:
        if self._det.enabled:
            self._det.on_release(self)
        self._lock.release()
        sim = _sched.active
        if sim is not None:
            sim.after_lock_release(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<OrderedLock {self.name!r} hot={self.hot}>"


#: process-wide default detector; library locks bind to it
default = LockOrderDetector()


def named_lock(
    name: str,
    *,
    hot: bool = False,
    recursive: bool = False,
    allow_self_nest: bool = False,
    detector: Optional[LockOrderDetector] = None,
) -> OrderedLock:
    """An instrumented lock. ``name`` keys the acquisition graph; use
    one name per lock ROLE (``manager.shuffle``), not per instance.
    ``hot`` marks locks that must never be held across blocking calls."""
    return OrderedLock(
        name,
        hot=hot,
        recursive=recursive,
        allow_self_nest=allow_self_nest,
        detector=detector,
    )


# -- blocking-call probes --------------------------------------------------
# patched once while any detector is active; each probe fans out to the
# active detectors so test-local instances compose with the default. The
# probes call what they replaced (``_prev_*``), which may be another
# package's probe: with both packages' detectors armed, a blocking call
# reaches both, and each package restores only its own patch.
_active: List[LockOrderDetector] = []
_patch_lock = threading.Lock()
_real_sleep = time.sleep
_real_create_connection = socket.create_connection
_prev_sleep = _real_sleep
_prev_create_connection = _real_create_connection


def _probed_sleep(secs):
    for det in list(_active):
        det.on_blocking_call("time.sleep")
    return _prev_sleep(secs)


def _probed_create_connection(*a, **kw):
    for det in list(_active):
        det.on_blocking_call("socket.create_connection")
    return _prev_create_connection(*a, **kw)


def _activate(det: LockOrderDetector) -> None:
    global _prev_sleep, _prev_create_connection
    with _patch_lock:
        if det not in _active:
            _active.append(det)
        if time.sleep is not _probed_sleep:
            _prev_sleep = time.sleep
            time.sleep = _probed_sleep
        if socket.create_connection is not _probed_create_connection:
            _prev_create_connection = socket.create_connection
            socket.create_connection = _probed_create_connection


def _unwound(fn, probe_attr: str, real_attr: str):
    """``fn``, or what it stands on while it is the probe of another
    detector module of this layout that has no active detector."""
    while True:
        mod = sys.modules.get(getattr(fn, "__module__", None) or "")
        if (
            mod is None
            or mod is sys.modules[__name__]
            or getattr(mod, probe_attr, None) is not fn
            or getattr(mod, "_active", True)
        ):
            return fn
        fn = getattr(mod, real_attr)


def _deactivate(det: LockOrderDetector) -> None:
    with _patch_lock:
        if det in _active:
            _active.remove(det)
        if _active:
            return
        if time.sleep is _probed_sleep:
            time.sleep = _unwound(_prev_sleep, "_probed_sleep", "_real_sleep")
        if socket.create_connection is _probed_create_connection:
            socket.create_connection = _unwound(
                _prev_create_connection,
                "_probed_create_connection",
                "_real_create_connection",
            )
