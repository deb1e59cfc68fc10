"""Seams between the host-plane modules and the analysis planes.

The host-plane modules the port copies call into two analysis planes of
the JAX package: the lock-order detector (``analysis/lockorder.py``)
and the model checker's schedule points (``analysis/modelcheck``). The
copies import both from here, so they keep the JAX call sites line for
line:

- ``named_lock`` / ``OrderedLock``: the port's lock-order detector
  (``sparkrdma_tpu_torch/analysis/lockorder.py``), re-exported;
- ``schedule_point`` and ``active``: the model checker's seam, inert
  until the model checker is pointed at the port (ROADMAP M8c-b).
  ``active`` stands for the JAX ``modelcheck.sched.active`` scheduler,
  which ``OrderedLock`` reads on every acquire; it stays ``None`` here.

The cluster event journal is ``obs/journal.py``; its emitters import
``emit`` from there, as in the JAX package.
"""

from __future__ import annotations

#: the model checker's active scheduler; ``None`` until ROADMAP M8c-b
active = None


def schedule_point(kind: str, label: str) -> None:
    """A model-checker interleaving seam; inert until the model checker
    is pointed at the port (ROADMAP M8c-b)."""


def __getattr__(name: str):
    # ``named_lock`` / ``OrderedLock`` resolve on first use: lockorder
    # imports this module for ``active``, so neither may import the
    # other at the top
    if name in ("named_lock", "OrderedLock"):
        from sparkrdma_tpu_torch.analysis import lockorder

        return getattr(lockorder, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["OrderedLock", "active", "named_lock", "schedule_point"]
