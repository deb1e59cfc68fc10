"""Inert seams for the JAX package's planes that the port has not reached.

The host-plane modules the port copies call into four planes that have
no port module yet: the lock-order detector (``analysis/lockorder.py``),
the model checker's schedule points (``analysis/modelcheck``), the
cluster event journal (``obs/journal.py``) and the fault-injection plan
(``testing/faults.py``). Each gets a stand-in here with the same name
and call shape, so the copies keep the JAX call sites line for line and
the real plane drops in later without touching them:

- ``named_lock`` / ``OrderedLock``: plain ``threading`` locks that keep
  their names (ROADMAP M8, the analysis passes pointed at the port);
- ``schedule_point``: does nothing (ROADMAP M8, with the analysis
  passes);
- ``journal_emit``: does nothing (ROADMAP M8, the operations planes);
- ``faults.active()``: returns None; ``faults.ensure_installed`` raises
  on a non-empty plan, so a fault plan is never silently ignored
  (ROADMAP M4, with ``testing/faults.py``).
"""

from __future__ import annotations

import threading


class OrderedLock:
    """A named lock. The JAX package's version feeds a lock-order
    detector that reads its flags; this one only keeps the name (ROADMAP
    M8)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, *, recursive: bool = False):
        self.name = name
        self._lock = threading.RLock() if recursive else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> bool:
        return self._lock.acquire()

    def __exit__(self, *exc) -> None:
        self._lock.release()


def named_lock(name: str, *, hot: bool = False, recursive: bool = False,
               allow_self_nest: bool = False) -> OrderedLock:
    """A named lock (the JAX ``analysis.lockorder.named_lock`` signature;
    ``hot`` and ``allow_self_nest`` are the detector's flags)."""
    return OrderedLock(name, recursive=recursive)


def schedule_point(kind: str, label: str) -> None:
    """A model-checker interleaving seam; inert until the model checker
    is pointed at the port (ROADMAP M8)."""


def journal_emit(event: str, **fields) -> None:
    """An event for the cluster journal; dropped until the journal is
    ported (ROADMAP M8)."""


class _Faults:
    """The fault-injection plan's two entry points (ROADMAP M4)."""

    @staticmethod
    def active():
        """The installed fault plan: none can be installed yet."""
        return None

    @staticmethod
    def ensure_installed(spec: str, seed: int = 0) -> None:
        """Install ``spec`` (``tpu.shuffle.faultPlan``). An empty spec is
        the default and a no-op; any other raises, so a chaos run never
        silently runs without its faults."""
        if spec:
            raise NotImplementedError(
                "fault plans (tpu.shuffle.faultPlan) need testing/faults.py, "
                "which the port brings with ROADMAP item M4"
            )


faults = _Faults()
