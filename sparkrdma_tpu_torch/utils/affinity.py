"""CPU-vector allocation for completion threads.

Reference behavior: RdmaNode shuffles the configured ``cpuList`` and
round-robins each channel's CQ thread onto a CPU vector
(RdmaNode.java:221-277); RdmaThread pins itself via
``NativeAffinity.setAffinity`` (RdmaThread.java:44-46). Here the pin is
``os.sched_setaffinity`` on the completion thread. An empty ``cpuList``
means no pinning (the scheduler decides) — the right default on small
hosts.

A copy of the JAX package's ``utils/affinity.py``, its imports rewritten
to this package.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import List, Optional

logger = logging.getLogger(__name__)


def parse_cpu_list(spec: str) -> List[int]:
    """Parse "0-3,7,9-10" into [0,1,2,3,7,9,10]; invalid entries dropped."""
    cpus: List[int] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            if "-" in part:
                lo, hi = part.split("-", 1)
                cpus.extend(range(int(lo), int(hi) + 1))
            else:
                cpus.append(int(part))
        except ValueError:
            logger.warning("ignoring invalid cpuList entry %r", part)
    avail = None
    try:
        avail = os.sched_getaffinity(0)
    except (AttributeError, OSError):
        pass
    if avail is not None:
        cpus = [c for c in cpus if c in avail]
    return cpus


class CpuVectorAllocator:
    """Round-robin CPU vectors from a shuffled cpuList (reference
    shuffles before round-robin, RdmaNode.java:233)."""

    def __init__(self, cpu_list: str, seed: Optional[int] = None):
        self._cpus = parse_cpu_list(cpu_list)
        if self._cpus:
            random.Random(seed).shuffle(self._cpus)
        self._next = 0
        self._lock = threading.Lock()

    def next_vector(self) -> Optional[int]:
        with self._lock:
            if not self._cpus:
                return None
            cpu = self._cpus[self._next % len(self._cpus)]
            self._next += 1
            return cpu


def pin_current_thread(cpu: Optional[int]) -> bool:
    """Pin the calling thread to one CPU; False if unsupported/declined."""
    if cpu is None:
        return False
    try:
        os.sched_setaffinity(0, {cpu})
        return True
    except (AttributeError, OSError) as e:
        logger.debug("could not pin thread to cpu %d: %s", cpu, e)
        return False
