"""pytest plugin: run the suite under the lock-order detector.

Loaded with ``-p sparkrdma_tpu_torch.analysis.pytest_plugin``; armed
only when ``SPARKRDMA_LOCK_ORDER`` is truthy in the environment, so a
run without the flag pays nothing. Under the flag, every ``named_lock`` in the
library records acquisition-order edges while the tests exercise the
real concurrency paths, and any violation — order cycle, same-name
nesting, blocking call under a hot lock — fails the session even when
every individual test passed.

A copy of the JAX package's ``analysis/pytest_plugin.py`` for the
port's detector. ``tests/conftest.py`` registers the JAX package's
plugin, and the same flag arms both. This one arms last
(``trylast``), so the port's blocking-call probes sit on top of the JAX
package's and chain to them (``lockorder.py``), and its summary section
names the package, so the two verdicts stay apart.
"""

from __future__ import annotations

import os

import pytest

from sparkrdma_tpu_torch.analysis import lockorder

_armed = False


def _flag() -> bool:
    return os.environ.get("SPARKRDMA_LOCK_ORDER", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


@pytest.hookimpl(trylast=True)
def pytest_configure(config):
    global _armed
    if _flag() and not _armed:
        _armed = True
        lockorder.default.reset()
        lockorder.default.enable()


def pytest_terminal_summary(terminalreporter):
    if not _armed:
        return
    det = lockorder.default
    tr = terminalreporter
    if det.violations:
        tr.section("lock-order violations: sparkrdma_tpu_torch")
        for v in det.violations:
            tr.line(v)
    else:
        edges = sum(len(s) for s in det.edges.values())
        tr.section("lock-order: sparkrdma_tpu_torch")
        tr.line(
            f"clean: {len(det.edges)} lock names, {edges} order edges, "
            "0 violations"
        )


def pytest_sessionfinish(session, exitstatus):
    if _armed and lockorder.default.violations:
        # mutate the session's exit status so CI fails even when every
        # individual test passed
        session.exitstatus = 1
