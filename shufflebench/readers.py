"""Arithmetic the metric readers share (``metrics/<name>.py`` each
pick one quantity from a :class:`shufflebench.run.Run`). A reader that
finds nothing to read returns None and the metric is left out."""

from __future__ import annotations

from typing import Optional

from shufflebench import stats, trace


def completed_gbps(run) -> Optional[float]:
    """Bytes of every completed stage over the window's seconds, in GB/s."""
    r = stats.rate_per_s(sum(s.bytes for s in run.stages), run.window_s)
    return None if not r else r / 1e9


def device_p95_ms(run) -> Optional[float]:
    """95th percentile of every stage's CUDA-event time, in ms."""
    times = [s.device_s for s in run.stages if s.device_s is not None]
    p = stats.percentile(times, 95)
    return None if p is None else p * 1e3


def mean_ms(values) -> Optional[float]:
    vals = list(values)
    return sum(vals) / len(vals) * 1e3 if vals else None


def module_ms(run, module: str) -> Optional[float]:
    """Device ms a stage launched from ``sparkrdma_tpu_torch/<module>``,
    in the stretch traced with the Python tracer."""
    if run.traced is None:
        return None
    ns = run.traced["by_module_ns"].get(module)
    return None if not ns else ns / 1e6 / run.traced["b"].stages


def idle_share(run) -> Optional[float]:
    """1 - (union of device activity) / (traced stretch), in the
    stretch traced without the Python tracer."""
    if run.traced is None:
        return None
    a = run.traced["a"]
    busy = trace.union_ns(a.events) / 1e9
    return None if busy <= 0 or a.stretch_s <= 0 else 1.0 - busy / a.stretch_s
