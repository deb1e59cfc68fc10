"""TpuShuffleConf — the tunables of the device reduce stage, range-clamped.

A copy of the part of the JAX package's ``utils/config.py`` that this
package reads: the same ``tpu.shuffle.*`` keys, defaults and clamping
(every getter falls back to its default, silently, when a value is
malformed or out of range), for the HBM arena (``hbm.*``), the device
fetch plane (``deviceFetch.*``) and the whole-stage collective compiler
(``collective.*``). Keys of other families are kept as given, so one
conf dict serves both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

from sparkrdma_tpu_torch.utils.units import parse_bytes

PREFIX = "tpu.shuffle."

# The keys this package reads, by suffix; a subset of the JAX package's
# declared-knobs registry, with the same descriptions.
DECLARED_KNOBS: Dict[str, str] = {
    "hbm.slabBytes": "HBM staging slab size",
    "hbm.maxBytes": "HBM shuffle-staging budget",
    "hbm.hostSpillMaxBytes": "host-RAM cap for spilled slabs",
    "hbm.spillDir": "disk-tier spill directory",
    "deviceFetch.enabled": "HBM->HBM device fetch plane",
    "deviceFetch.minBlockBytes": "device-plane minimum block size",
    "collective.enabled": "whole-stage collective shuffle compiler",
    "collective.minBlocks": "device blocks needed to engage the compiler",
    "collective.schedule": "collective schedule: auto|ring|a2a",
    "collective.waveBytes": "max payload bytes per DMA wave",
    "collective.fusedMerge": "allow fetch+merge fusion in one epoch",
    "collective.laneBalance": "planner balances DMA lanes, not just bytes",
    "collective.pipelineDepth": "in-flight DMA waves in the double-buffered pipeline",
    "collective.autoTune": "attribution-driven per-stage waveBytes self-tuning",
}


class TpuShuffleConf:
    """Dict-backed configuration with clamped typed getters."""

    def __init__(self, conf: Optional[Dict[str, object]] = None):
        self._conf: Dict[str, str] = {}
        if conf:
            for k, v in conf.items():
                self._conf[str(k)] = str(v)

    # -- raw access -------------------------------------------------------
    def set(self, key: str, value: object) -> "TpuShuffleConf":
        self._conf[key] = str(value)
        return self

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._conf.get(key, default)

    # -- clamped typed getters --------------------------------------------
    def _int(self, key: str, default: int, lo: int, hi: int) -> int:
        raw = self._conf.get(PREFIX + key)
        if raw is None:
            return default
        try:
            v = int(raw)
        except ValueError:
            return default
        return v if lo <= v <= hi else default

    def _bytes(self, key: str, default: str, lo: int, hi: int) -> int:
        raw = self._conf.get(PREFIX + key, default)
        try:
            v = parse_bytes(raw)
        except ValueError:
            v = parse_bytes(default)
        if not (lo <= v <= hi):
            v = parse_bytes(default)
        return v

    def _bool(self, key: str, default: bool) -> bool:
        raw = self._conf.get(PREFIX + key)
        if raw is None:
            return default
        return raw.strip().lower() in ("1", "true", "yes", "on")

    # -- HBM arena ----------------------------------------------------------
    @property
    def hbm_slab_bytes(self) -> int:
        """Size of each HBM staging slab owned by the device buffer manager."""
        return self._bytes("hbm.slabBytes", "64m", 1 << 16, 1 << 33)

    @property
    def hbm_max_bytes(self) -> int:
        """Device-memory budget for shuffle staging."""
        return self._bytes("hbm.maxBytes", "2g", 0, 1 << 40)

    @property
    def hbm_host_spill_max_bytes(self) -> int:
        """Host-RAM cap for slabs spilled out of device memory; overflow
        cascades to disk. 0 = unbounded host tier."""
        return self._bytes("hbm.hostSpillMaxBytes", "0", 0, 1 << 44)

    @property
    def hbm_spill_dir(self) -> str:
        """Directory for the disk tier's spill files ("" = the system
        temp dir)."""
        return str(self.get(PREFIX + "hbm.spillDir", "") or "")

    # -- device fetch plane ---------------------------------------------------
    @property
    def device_fetch_enabled(self) -> bool:
        """Let reduce tasks pull arena-resident blocks device to device
        (shuffle/device_fetch.py, shuffle/collective.py)."""
        return self._bool("deviceFetch.enabled", True)

    @property
    def device_fetch_min_block_bytes(self) -> int:
        """Blocks smaller than this skip the device plane."""
        return self._bytes("deviceFetch.minBlockBytes", "16k", 0, 1 << 33)

    # -- whole-stage collective compiler ----------------------------------------
    @property
    def collective_enabled(self) -> bool:
        """Compile a reduce stage's device-resident location set into
        batched waves instead of per-block pulls."""
        return self._bool("collective.enabled", True)

    @property
    def collective_min_blocks(self) -> int:
        """Device-resident blocks a stage must publish before the
        compiler engages."""
        return self._int("collective.minBlocks", 2, 1, 1 << 20)

    @property
    def collective_schedule(self) -> str:
        """Wave schedule: ``ring`` (lane-major), ``a2a`` or ``auto``
        (a2a when the stage spans more than two source lanes)."""
        raw = (self.get(PREFIX + "collective.schedule", "auto") or "auto").lower()
        return raw if raw in ("auto", "ring", "a2a") else "auto"

    @property
    def collective_wave_bytes(self) -> int:
        """Payload cap per wave: bounds the stacked landing buffer."""
        return self._bytes("collective.waveBytes", "64m", 1 << 16, 1 << 33)

    @property
    def collective_fused_merge(self) -> bool:
        """Global off-switch for fetch->merge fusion (callers opt in
        per fetch)."""
        return self._bool("collective.fusedMerge", True)

    @property
    def collective_lane_balance(self) -> bool:
        """Adaptive planner balances per-lane DMA bytes, not just totals."""
        return self._bool("collective.laneBalance", True)

    @property
    def collective_pipeline_depth(self) -> int:
        """Waves kept in flight at once; ``1`` disables pipelining. Every
        depth is byte-identical, only the overlap changes."""
        return self._int("collective.pipelineDepth", 2, 1, 8)

    @property
    def collective_auto_tune(self) -> bool:
        """Let the compiler's wave controller re-derive the effective
        ``collective.waveBytes`` per stage shape (shuffle/autotune.py)."""
        return self._bool("collective.autoTune", True)
