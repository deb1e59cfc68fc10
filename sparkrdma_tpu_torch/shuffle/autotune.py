"""Wave self-tuning for the schedule compiler.

The PyTorch counterpart of the JAX package's ``shuffle/autotune.py``:
the compiler's one load-bearing sizing choice, the effective
``collective.waveBytes``, is re-derived per (schedule, stage-shape)
signature from the wave stats of the stage that just ran, so the second
identical stage runs with the adjusted cut. The tuned budget never
drops below the stage's largest partition group (fusion needs a
partition's rows in one wave) nor rises above the configured cap.

As in JAX, the tuner consults the last job's critical-path breakdown
(``obs/attr.py``): when ``dma-wave`` carries under
``MIN_DMA_WAVE_FRACTION`` of the job's wall and the profiler's gap
frames do not implicate the transfer plane, re-cutting cannot move the
job and the tuner holds still; no breakdown means no veto. Each re-cut
emits an ``autotune.adjust`` event into the journal (``obs/journal.py``).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs.journal import emit as journal_emit
from sparkrdma_tpu_torch.ops.exchange import round_bucket

logger = logging.getLogger(__name__)

# fraction of job wall the dma-wave category must carry before the
# tuner will re-cut a stage on breakdown evidence; below this the
# shuffle is not the job's problem and re-cutting is churn
MIN_DMA_WAVE_FRACTION = 0.05


def stage_signature(schedule: str, lanes: int, rows_class: int,
                    bucket_class: int, dtype_name: str) -> Tuple:
    """Stable identity of a stage SHAPE: two stages with one signature
    run the same wave program classes."""
    return (schedule, lanes, rows_class, bucket_class, dtype_name)


class WaveReport:
    """One executed stage's wave stats, fed back by ``execute()``."""

    __slots__ = ("stage_bytes", "min_group_bytes", "waves", "depth",
                 "dispatch_ms", "wave_ms", "overlap_ms")

    def __init__(self, stage_bytes: int, min_group_bytes: int, waves: int,
                 depth: int, dispatch_ms: float, wave_ms: float,
                 overlap_ms: float):
        self.stage_bytes = stage_bytes
        # largest single partition group (bucketed) — the fusion floor
        self.min_group_bytes = min_group_bytes
        self.waves = waves
        self.depth = depth
        self.dispatch_ms = dispatch_ms
        self.wave_ms = wave_ms
        self.overlap_ms = overlap_ms


class WaveAutoTuner:
    """Per-compiler controller: observe a stage, choose the next cut.
    The choice is a pure function of (stage bytes, depth, fusion floor),
    so a second observation of one signature converges."""

    def __init__(self, conf, executor_id: str):
        self._conf = conf
        self._executor_id = executor_id
        self._lock = threading.Lock()
        self._choices: Dict[Tuple, int] = {}
        reg = get_registry()
        self._m_adjust = reg.counter(
            "collective.autotune_adjustments", role=executor_id
        )
        self._m_tuned = reg.gauge(
            "collective.tuned_wave_bytes", role=executor_id
        )

    def wave_bytes_for(self, sig: Tuple) -> Optional[int]:
        """The remembered cut for this stage shape, or None for the
        configured default."""
        if not self._conf.collective_auto_tune:
            return None
        with self._lock:
            return self._choices.get(sig)

    def observe(self, sig: Tuple, report: WaveReport) -> None:
        """Fold one executed stage into the per-signature choice."""
        if not self._conf.collective_auto_tune:
            return
        if report.stage_bytes <= 0 or report.waves <= 0:
            return
        if not self._breakdown_allows():
            return
        target = self._target_budget(report)
        if target is None:
            return
        with self._lock:
            prev = self._choices.get(sig)
            if prev == target:
                return  # converged for this shape
            self._choices[sig] = target
        self._m_adjust.inc()
        self._m_tuned.set(target)
        journal_emit(
            "autotune.adjust", role=self._executor_id,
            prev=prev or 0, wave_bytes=target, waves=report.waves,
        )
        logger.debug(
            "autotune: stage %r waveBytes %s -> %d (waves=%d depth=%d "
            "dispatch=%.2fms wall=%.2fms overlap=%.2fms)",
            sig, prev, target, report.waves, report.depth,
            report.dispatch_ms, report.wave_ms, report.overlap_ms,
        )

    def _target_budget(self, report: WaveReport) -> Optional[int]:
        """The cut the NEXT run of this shape should use: about two
        waves per pipeline slot; a dispatch-bound stage coarsens toward
        the same count."""
        depth = max(1, report.depth)
        target_waves = 2 * depth
        configured = self._conf.collective_wave_bytes
        dispatch_frac = (
            report.dispatch_ms / report.wave_ms
            if report.wave_ms > 1e-6 else 0.0
        )
        if report.waves > target_waves * 2 and dispatch_frac > 0.5:
            ideal = -(-report.stage_bytes // target_waves)
        elif report.waves < target_waves:
            ideal = -(-report.stage_bytes // target_waves)
        else:
            return None  # already in band — hold
        budget = round_bucket(max(1, ideal))
        budget = max(budget, report.min_group_bytes)
        budget = min(budget, configured)
        budget = max(budget, 1 << 16)
        return budget

    def _breakdown_allows(self) -> bool:
        """Attribution gate: when the last job's TimeBreakdown says the
        wall went elsewhere (and its gap frames don't implicate the
        transfer plane), hold still. No breakdown (critpath off, first
        job) means no veto — wave stats alone are enough to act."""
        try:
            from sparkrdma_tpu_torch.obs.attr import dma_wave_signal, last_breakdown

            bd = last_breakdown()
            if bd is None:
                return True
            fraction, transfer_gaps = dma_wave_signal(bd)
            return fraction >= MIN_DMA_WAVE_FRACTION or transfer_gaps
        except Exception:
            logger.exception("autotune breakdown gate failed; allowing")
            return True
