"""Inert seams for the JAX package's analysis planes that the port has
not reached.

The host-plane modules the port copies call into two planes that have
no port module yet: the lock-order detector (``analysis/lockorder.py``)
and the model checker's schedule points (``analysis/modelcheck``). Each
gets a stand-in here with the same name and call shape, so the copies
keep the JAX call sites line for line and the real plane drops in later
without touching them:

- ``named_lock`` / ``OrderedLock``: plain ``threading`` locks that keep
  their names (ROADMAP M8c, the analysis passes pointed at the port);
- ``schedule_point``: does nothing (ROADMAP M8c, with the analysis
  passes).

The cluster event journal is ``obs/journal.py``; its emitters import
``emit`` from there, as in the JAX package.
"""

from __future__ import annotations

import threading


class OrderedLock:
    """A named lock. The JAX package's version feeds a lock-order
    detector that reads its flags; this one only keeps the name (ROADMAP
    M8c)."""

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
    is pointed at the port (ROADMAP M8c)."""
