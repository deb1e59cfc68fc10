"""Completion callback interface for transport work requests.

Analogue of RdmaCompletionListener (reference: RdmaCompletionListener.java:24-27).
Contract preserved: ``on_failure`` may be invoked more than once (e.g. a
failed WR plus a channel-wide error fan-out) and must tolerate it.

A copy of the JAX package's ``transport/completion.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

from typing import Callable, Optional


class CompletionListener:
    def on_success(self, payload=None) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def on_failure(self, exc: Exception) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class FnListener(CompletionListener):
    """Adapter from a pair of callables."""

    def __init__(
        self,
        on_success: Optional[Callable] = None,
        on_failure: Optional[Callable[[Exception], None]] = None,
    ):
        self._ok = on_success
        self._err = on_failure

    def on_success(self, payload=None) -> None:
        if self._ok is not None:
            self._ok(payload)

    def on_failure(self, exc: Exception) -> None:
        if self._err is not None:
            self._err(exc)
