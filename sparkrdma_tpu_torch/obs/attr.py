"""Per-job time attribution: critical-path segments -> category verdict.

Folds a :class:`~sparkrdma_tpu_torch.obs.critpath.CriticalPath` into a
:class:`TimeBreakdown` — the "where did this job's wall time actually
go" answer, in a fixed category vocabulary (docs/OBSERVABILITY.md
"Critical path & attribution"):

- ``device-compute`` — device sort / merge / exchange kernels, the
                       device steps' phases,
- ``dma-wave``       — collective DMA waves and the device fetch plane,
- ``host-read``      — one-sided READ service, fetch groups, native
                       submit→complete intervals,
- ``decode``         — frame parse / checksum / deserialize,
- ``rpc``            — control-plane publish/resolve/fetch-request and
                       push/seal messaging,
- ``queue-wait``     — fair-share DRR submit→dispatch parking,
- ``other``          — traced spans outside the vocabulary,
- ``idle-untraced``  — critical-path gaps (nothing traced was running).

Categories are assigned by longest-matching span-name prefix, so new
span families degrade to ``other`` rather than silently vanishing.

A copy of the JAX package's ``obs/attr.py``, its imports rewritten to
this package, with the port's device-step span prefixes (``terasort.``,
``hashjoin.``, ``pagerank.``) added to ``device-compute``.

Stdlib-only and jax-free, like the rest of ``obs/``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.obs.critpath import CriticalPath

DEVICE_COMPUTE = "device-compute"
DMA_WAVE = "dma-wave"
HOST_READ = "host-read"
DECODE = "decode"
RPC = "rpc"
QUEUE_WAIT = "queue-wait"
OTHER = "other"
IDLE = "idle-untraced"

CATEGORIES: Tuple[str, ...] = (
    DEVICE_COMPUTE, DMA_WAVE, HOST_READ, DECODE, RPC, QUEUE_WAIT, OTHER, IDLE,
)

# span-name prefix -> category; longest prefix wins (so
# ``shuffle.collective.wave`` beats ``shuffle.collective``).
PREFIX_CATEGORIES: Dict[str, str] = {
    "engine.task": DEVICE_COMPUTE,  # task compute (sort/combine/user fns)
    "writer.pipeline.sort": DEVICE_COMPUTE,
    "reader.pipeline.merge": DEVICE_COMPUTE,
    "reader.pipeline.stage": DEVICE_COMPUTE,
    "writer.pipeline.stage": DEVICE_COMPUTE,
    "exchange.": DEVICE_COMPUTE,
    "terasort.": DEVICE_COMPUTE,  # the device steps' spans (models/)
    "hashjoin.": DEVICE_COMPUTE,
    "pagerank.": DEVICE_COMPUTE,
    "shuffle.collective.wave": DMA_WAVE,
    "shuffle.collective": DMA_WAVE,
    "device_fetch.": DMA_WAVE,
    "shuffle.fetch": HOST_READ,  # fetch group (NOT fetch_request: see RPC)
    "transport.native_read": HOST_READ,
    "reader.pipeline.fetch": HOST_READ,
    "shuffle.read": HOST_READ,
    "reader.pipeline.decode": DECODE,
    "shuffle.fetch_request": RPC,
    "shuffle.publish": RPC,
    "shuffle.resolve": RPC,
    "shuffle.register": RPC,
    "writer.pipeline.publish": RPC,
    "shuffle.push": RPC,
    "shuffle.merge_seal": RPC,
    "tenant.queue_wait": QUEUE_WAIT,
}
_PREFIXES_BY_LEN = sorted(PREFIX_CATEGORIES, key=len, reverse=True)


def classify(name: str) -> str:
    """Category for one span name (longest matching prefix, else other)."""
    for prefix in _PREFIXES_BY_LEN:
        if name.startswith(prefix):
            return PREFIX_CATEGORIES[prefix]
    return OTHER


class TimeBreakdown:
    """One job's attribution verdict: wall, per-category ms, coverage.

    ``gap_frames`` aggregates the sampling profiler's dominant frames
    across every gap segment (``obs/profiler.py::annotate_gaps``) —
    empty when no profiler was live for the job."""

    __slots__ = ("wall_ms", "categories", "coverage", "critical_path",
                 "gap_frames")

    def __init__(self, wall_ms: float, categories: Dict[str, float],
                 coverage: float, critical_path: List[dict],
                 gap_frames: Optional[Dict[str, int]] = None):
        self.wall_ms = wall_ms
        self.categories = categories
        self.coverage = coverage
        self.critical_path = critical_path
        self.gap_frames = gap_frames or {}

    def to_dict(self) -> dict:
        out = {
            "wall_ms": round(self.wall_ms, 3),
            "coverage": round(self.coverage, 4),
            "categories_ms": {
                k: round(v, 3) for k, v in self.categories.items()
            },
            "critical_path": self.critical_path,
        }
        if self.gap_frames:
            out["gap_frames"] = dict(sorted(
                self.gap_frames.items(), key=lambda kv: -kv[1]))
        return out

    def render(self) -> str:
        """Fixed-width table for CLIs and logs."""
        lines = [f"wall {self.wall_ms:10.3f} ms   "
                 f"coverage {self.coverage * 100:5.1f}%"]
        wall = self.wall_ms or 1.0
        for cat in CATEGORIES:
            ms = self.categories.get(cat, 0.0)
            if ms <= 0.0:
                continue
            lines.append(f"  {cat:<16} {ms:10.3f} ms  {ms / wall * 100:5.1f}%")
        if self.gap_frames:
            top = sorted(self.gap_frames.items(), key=lambda kv: -kv[1])[:3]
            lines.append("  gap frames: " + ", ".join(
                f"{frame} ({n})" for frame, n in top))
        return "\n".join(lines)


# ----------------------------------------------------------------------
# process-local feedback seam: the last breakdown any producer built.
# ``critpath.job_breakdown`` publishes here so consumers that close a
# loop on attribution evidence — today the wave self-tuner
# (shuffle/autotune.py) — read the verdict without holding a reference
# to whichever engine/context produced it. Advisory by design: a stale
# or missing breakdown only makes the consumer more conservative.
# ----------------------------------------------------------------------
_last_breakdown: Optional[TimeBreakdown] = None

# transfer-plane frame markers in profiler gap aggregates: any of
# these dominating a gap segment says the untraced wall was the data
# mover, not user compute
TRANSFER_GAP_FRAMES: Tuple[str, ...] = (
    "device_put", "block_until_ready", "remote_copy", "stage_view",
    "put_array",
)


def publish_breakdown(bd: TimeBreakdown) -> None:
    """Record ``bd`` as the process's latest attribution verdict."""
    global _last_breakdown
    _last_breakdown = bd


def last_breakdown() -> Optional[TimeBreakdown]:
    """The most recent published verdict (None before the first job)."""
    return _last_breakdown


def dma_wave_signal(bd: TimeBreakdown) -> Tuple[float, bool]:
    """How loudly ``bd`` implicates the DMA-wave plane: the fraction
    of wall attributed to ``dma-wave``, and whether the profiler's gap
    frames point at the transfer path (``device_put`` and friends
    dominating idle-untraced time). The wave self-tuner acts only when
    one of the two says re-cutting waves can move the job."""
    wall = bd.wall_ms or 1.0
    fraction = bd.categories.get(DMA_WAVE, 0.0) / wall
    transfer = any(
        any(marker in frame for marker in TRANSFER_GAP_FRAMES)
        for frame in bd.gap_frames
    )
    return fraction, transfer


def attribute(path: CriticalPath, top_segments: int = 12) -> TimeBreakdown:
    """Fold a critical path into the category verdict."""
    cats: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
    gap_frames: Dict[str, int] = {}
    for seg in path.segments:
        cat = IDLE if seg.kind == "gap" else classify(seg.name)
        cats[cat] += seg.dur_s * 1e3
        for frame, n in (getattr(seg, "frames", None) or ()):
            gap_frames[frame] = gap_frames.get(frame, 0) + int(n)
    # traced-category coverage: everything except the idle bucket,
    # normalized to wall — the ≥90% acceptance gate reads this
    wall_ms = path.wall_s * 1e3
    traced_ms = sum(v for k, v in cats.items() if k != IDLE)
    coverage = (traced_ms / wall_ms) if wall_ms > 1e-3 else 1.0
    return TimeBreakdown(
        wall_ms,
        {k: v for k, v in cats.items() if v > 0.0},
        min(1.0, coverage),
        [s.to_dict() for s in path.top_segments(top_segments)],
        gap_frames,
    )
