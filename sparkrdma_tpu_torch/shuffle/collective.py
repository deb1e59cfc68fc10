"""Whole-stage collective shuffle — the pipelined shuffle-schedule compiler.

The PyTorch counterpart of the JAX package's ``shuffle/collective.py``.
A reduce stage's whole device-resident location set is compiled into
batched *waves* — fixed-shape ``[rows_b, bucket_elems]`` stacks moved by
one mover launch — with both axes power-of-two bucketed, ordered over a
ring or all-to-all schedule, and run as a double-buffered pipeline
(``collective.pipelineDepth`` entries in flight: entry N+1 is issued
before entry N is waited on and adopted). ``plan`` gives the same
schedule as the JAX compiler for the same locations.

Movers, by where the reducer's arena lives:

- CUDA: the hand-written wave-pull kernel (``ops/remote_copy.py``,
  ``csrc/wave_pull.cu``). The issue half builds only a row table —
  source slab, ``arena_offset``, payload bytes — from the pinned
  sources, and the kernel reads the arena slabs directly into a landed
  stack that stays on the device. Consecutive same-class waves coalesce
  into one ``srt_pipelined_wave_pull`` launch; a lone wave is one
  ``srt_wave_pull``. One CUDA event recorded behind each launch is the
  entry's completion (the Pallas DMA semaphores' role); the source pins
  stay held until it has fired.
- CPU: the emulated issue/consume halves, as in the JAX package off
  TPU: fast-lane rows copied whole, fused rows read from views of the
  pinned sources, the rest assembled into a host stack.

Fusion: a partition whose every block rides in one wave lands as ONE
merged slab (valid prefixes concatenated in deterministic source
order); callers opt in per fetch.

Degrade ladder. Only residency misses degrade, silently and
byte-identically (the caller host-fetches the degraded locations):

| condition                                   | outcome             |
|---------------------------------------------|---------------------|
| ``collective.enabled`` off                   | per-block planner   |
| < ``collective.minBlocks`` device blocks     | per-block planner   |
| block fails eligibility (size/dtype/arena)   | per-block planner   |
| slab evicted/spilled between plan and pin    | host triple, degrade++ |
| reducer arena budget exhausted at adoption   | host triple, degrade++ |
| abort unwinds with waves in flight           | pins closed, rows degrade |

A kernel that does not build or launch is an error and propagates out
of ``execute`` (the JAX compiler's transfer-engine fallbacks are gone).

Tracing: given a ``tracer`` (``obs/trace.py``), ``execute`` opens the
``shuffle.collective`` span and records one ``shuffle.collective.wave``
span per adopted wave under it, the JAX compiler's span names.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from contextlib import ExitStack, nullcontext
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.locations import PartitionLocation
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops import remote_copy
from sparkrdma_tpu_torch.ops.exchange import round_bucket, round_rows
from sparkrdma_tpu_torch.ops.hbm_arena import (
    DeviceBuffer,
    DeviceBufferManager,
    _size_class,
)
from sparkrdma_tpu_torch.shuffle.autotune import (
    WaveAutoTuner,
    WaveReport,
    stage_signature,
)
from sparkrdma_tpu_torch.shuffle.device_fetch import visible_arena
from sparkrdma_tpu_torch.utils.torch_compat import dtype_name, torch_dtype
from sparkrdma_tpu_torch.utils.torch_compat import itemsize as dtype_itemsize

logger = logging.getLogger(__name__)


def merge_order_key(loc: PartitionLocation) -> Tuple:
    """Deterministic within-partition merge order — the order fused
    slabs concatenate in."""
    return (
        loc.manager_id.executor_id,
        loc.block.mkey,
        loc.block.address,
        loc.block.arena_handle,
    )


def _movable(t: torch.Tensor) -> torch.Tensor:
    """uint32 data as int32 bits: gathers run on the bit pattern."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _compaction_program(stacked: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor) -> torch.Tensor:
    """Fetch->merge compaction: gather every row's valid prefix of a
    landed ``[rows_b, bucket_elems]`` wave into one flat lane. Position
    ``j`` belongs to the row whose element span covers it, looked up
    against the inclusive end-offsets lane; the gather stays on the
    landed stack's device. Positions past the last valid element hold
    clamped filler that no caller reads."""
    rows_b, bucket_elems = stacked.shape
    dev = stacked.device
    starts = torch.as_tensor(starts, device=dev)
    ends = torch.as_tensor(ends, device=dev)
    j = torch.arange(rows_b * bucket_elems, dtype=torch.int32, device=dev)
    row = torch.searchsorted(ends, j, right=True).clamp_(max=rows_b - 1)
    col = (j - starts[row]).clamp_(0, bucket_elems - 1)
    flat = _movable(stacked)[row, col]
    return flat.view(stacked.dtype)


class _Row:
    """One device-resident block scheduled into a wave."""

    __slots__ = ("loc", "elems", "live")

    def __init__(self, loc: PartitionLocation, elems: int):
        self.loc = loc
        self.elems = elems
        self.live = True


class CollectiveWave:
    """One batched mover dispatch: ``rows`` blocks of one bucket class."""

    __slots__ = ("rows", "bucket_elems", "rows_b", "lane")

    def __init__(self, rows: List[_Row], bucket_elems: int, lane: str):
        self.rows = rows
        self.bucket_elems = bucket_elems
        self.rows_b = round_rows(len(rows))
        self.lane = lane  # primary source executor (ring ordering key)


class CollectivePlan:
    """A compiled reduce-stage fetch schedule. ``passthrough`` locations
    never entered the schedule; the caller runs them per block."""

    __slots__ = ("schedule", "waves", "passthrough", "fusable_pids",
                 "device_blocks", "sig", "stage_bytes", "max_group_bytes")

    def __init__(self, schedule: str, waves: List[CollectiveWave],
                 passthrough: List[PartitionLocation],
                 fusable_pids: frozenset, device_blocks: int,
                 sig: Optional[Tuple] = None, stage_bytes: int = 0,
                 max_group_bytes: int = 0):
        self.schedule = schedule
        self.waves = waves
        self.passthrough = passthrough
        self.fusable_pids = fusable_pids
        self.device_blocks = device_blocks
        self.sig = sig
        self.stage_bytes = stage_bytes
        self.max_group_bytes = max_group_bytes


class CollectiveResult:
    """One landed slab: a single block, or a fused per-partition merge
    (``locs`` then lists every covered block in merge order and
    ``dev.length`` is their summed payload)."""

    __slots__ = ("pid", "dev", "locs", "fused")

    def __init__(self, pid: int, dev: DeviceBuffer,
                 locs: List[PartitionLocation], fused: bool):
        self.pid = pid
        self.dev = dev
        self.locs = locs
        self.fused = fused


class _InflightWave:
    """One pipeline entry: a wave (or a same-class run of them) whose
    copies are in flight. Pins stay held from issue to consume."""

    __slots__ = ("waves", "pins", "t0", "dead", "all_dead", "row_arrs",
                 "row_views", "stacked_hosts", "landed", "events", "nbytes",
                 "live")

    def __init__(self, waves: List[CollectiveWave], pins: ExitStack,
                 t0: float):
        self.waves = waves
        self.pins = pins
        self.t0 = t0
        self.dead: List[_Row] = []
        self.all_dead = False
        # CPU movers, per wave: fast-lane copies (row index -> tensor),
        # views of pinned sources (fused rows) and the assembled stack
        self.row_arrs: List[Dict[int, torch.Tensor]] = []
        self.row_views: List[Dict[int, torch.Tensor]] = []
        self.stacked_hosts: List[Optional[torch.Tensor]] = []
        # kernel mover: the landed [waves, rows_b, bucket_elems] stack
        # and the (start, done) CUDA events around its launch
        self.landed: Optional[torch.Tensor] = None
        self.events = None
        self.nbytes = 0
        self.live = 0

    def close(self) -> None:
        self.pins.close()


class ShuffleScheduleCompiler:
    """Compile + execute whole-stage device fetch schedules."""

    def __init__(self, conf, dev: DeviceBufferManager, executor_id: str,
                 tracer=None):
        self._conf = conf
        self._dev = dev
        self._executor_id = executor_id
        self._tracer = tracer
        # program-shape bookkeeping for the compile-churn metrics
        self._seen_programs: set = set()
        self._cache_lock = named_lock("collective.compiler")
        self._tuner = WaveAutoTuner(conf, executor_id)
        # device time of each recent kernel launch, in ms (CUDA events)
        self.kernel_ms: Deque[float] = deque(maxlen=4096)
        reg = get_registry()
        role = executor_id
        self._m_plans = reg.counter("collective.plans", role=role)
        self._m_blocks = reg.counter("collective.blocks", role=role)
        self._m_bytes = reg.counter("collective.bytes", role=role)
        self._m_fused = reg.counter("collective.fused_merges", role=role)
        self._m_degrades = reg.counter("collective.degrades", role=role)
        self._m_compiles = reg.counter("collective.compiles", role=role)
        self._m_cache_hits = reg.counter("collective.cache_hits", role=role)
        self._m_plan_ms = reg.histogram("collective.plan_ms", role=role)
        self._m_overlap = reg.counter(
            "collective.wave_overlap_ms", role=role
        )
        self._m_inflight = reg.histogram(
            "collective.wave_inflight", role=role
        )
        self._m_plane_pulls = reg.counter(
            "device_fetch.plane.pulls", role=role
        )
        self._m_plane_bytes = reg.counter(
            "device_fetch.plane.bytes", role=role
        )
        self._m_plane_fallbacks = reg.counter(
            "device_fetch.plane.fallbacks", role=role
        )

    def _kernel_path(self) -> bool:
        """Waves move through the wave-pull kernel iff the reducer's
        arena lives on CUDA (the JAX compiler's TPU-mesh gate)."""
        return self._dev.device.type == "cuda"

    # ------------------------------------------------------------------
    # plan
    # ------------------------------------------------------------------
    def plan(self, locations: Sequence[PartitionLocation],
             dtype=np.uint8) -> CollectivePlan:
        """Compile the stage's location set into a wave schedule.

        Eligibility: device extension present, above minBlockBytes,
        source arena visible, and element-aligned length and offset;
        residency and dtype are re-checked under the pin at execute
        time, where a miss degrades."""
        t0 = time.perf_counter()
        conf = self._conf
        itemsize = dtype_itemsize(dtype)
        if not conf.collective_enabled or not conf.device_fetch_enabled:
            return CollectivePlan("off", [], list(locations), frozenset(), 0)
        min_bytes = conf.device_fetch_min_block_bytes
        eligible: List[PartitionLocation] = []
        passthrough: List[PartitionLocation] = []
        per_pid_total: Dict[int, int] = {}
        for loc in locations:
            per_pid_total[loc.partition_id] = (
                per_pid_total.get(loc.partition_id, 0) + 1
            )
            b = loc.block
            if (
                b.has_device
                and b.length >= min_bytes
                and b.length % itemsize == 0
                and b.arena_offset % itemsize == 0
                and visible_arena(loc.manager_id.executor_id) is not None
            ):
                eligible.append(loc)
            else:
                passthrough.append(loc)
        if len(eligible) < conf.collective_min_blocks:
            return CollectivePlan(
                "off", [], list(locations), frozenset(), 0
            )

        # partition-major so a fused pid's rows are contiguous,
        # source-ordered within the partition
        eligible.sort(key=lambda loc: (loc.partition_id, merge_order_key(loc)))
        per_pid_eligible: Dict[int, int] = {}
        per_pid_bytes: Dict[int, int] = {}
        stage_bytes = 0
        max_len = 0
        for loc in eligible:
            pid = loc.partition_id
            per_pid_eligible[pid] = per_pid_eligible.get(pid, 0) + 1
            bucketed = round_bucket(loc.block.length)
            per_pid_bytes[pid] = per_pid_bytes.get(pid, 0) + bucketed
            stage_bytes += bucketed
            max_len = max(max_len, loc.block.length)
        max_group_bytes = max(per_pid_bytes.values())

        lanes = sorted({loc.manager_id.executor_id for loc in eligible})
        schedule = conf.collective_schedule
        if schedule == "auto":
            schedule = "a2a" if len(lanes) > 2 else "ring"

        sig = stage_signature(
            schedule, len(lanes), round_rows(len(eligible)),
            round_bucket(max_len), dtype_name(dtype),
        )
        wave_budget = conf.collective_wave_bytes
        tuned = self._tuner.wave_bytes_for(sig)
        if tuned:
            wave_budget = min(max(tuned, max_group_bytes), wave_budget)

        # pid-group granularity (fusion needs a pid's rows in ONE wave),
        # split only when a single pid alone overflows the budget
        waves: List[CollectiveWave] = []
        fusable: set = set()
        cur_rows: List[_Row] = []
        cur_max_len = 0

        def seal():
            nonlocal cur_rows, cur_max_len
            if cur_rows:
                bucket = round_bucket(cur_max_len)
                waves.append(CollectiveWave(
                    cur_rows, bucket // itemsize,
                    cur_rows[0].loc.manager_id.executor_id,
                ))
                cur_rows, cur_max_len = [], 0

        i = 0
        n = len(eligible)
        while i < n:
            pid = eligible[i].partition_id
            j = i
            group_max = 0
            while j < n and eligible[j].partition_id == pid:
                group_max = max(group_max, eligible[j].block.length)
                j += 1
            group = eligible[i:j]
            group_bytes = per_pid_bytes[pid]
            if group_bytes > wave_budget and len(group) > 1:
                # oversized pid: stream it through dedicated waves,
                # unfusable
                seal()
                for loc in group:
                    cur_rows.append(_Row(loc, loc.block.length // itemsize))
                    cur_max_len = max(cur_max_len, loc.block.length)
                    if sum(round_bucket(r.loc.block.length)
                           for r in cur_rows) >= wave_budget:
                        seal()
                seal()
            else:
                cur_bytes = sum(
                    round_bucket(r.loc.block.length) for r in cur_rows
                )
                if cur_rows and cur_bytes + group_bytes > wave_budget:
                    seal()
                for loc in group:
                    cur_rows.append(_Row(loc, loc.block.length // itemsize))
                cur_max_len = max(cur_max_len, group_max)
                # fusable iff every published block of the pid made it
                # into the schedule and they share this wave
                if per_pid_eligible[pid] == per_pid_total[pid]:
                    fusable.add(pid)
            i = j
        seal()

        if schedule == "ring":
            # lane-major wave order: one source lane in flight at a time
            lane_index = {lane: k for k, lane in enumerate(lanes)}
            waves.sort(key=lambda w: lane_index[w.lane])
        self._m_plan_ms.observe((time.perf_counter() - t0) * 1e3)
        return CollectivePlan(
            schedule, waves, passthrough, frozenset(fusable), len(eligible),
            sig=sig, stage_bytes=stage_bytes,
            max_group_bytes=max_group_bytes,
        )

    # ------------------------------------------------------------------
    # execute
    # ------------------------------------------------------------------
    def execute(
        self,
        shuffle_id: int,
        plan: CollectivePlan,
        dtype=np.uint8,
        fused: bool = False,
        drain=None,
    ) -> Tuple[List[CollectiveResult], List[PartitionLocation]]:
        """Run the compiled schedule as a double-buffered pipeline;
        returns ``(results, degraded)``.

        Up to ``collective.pipelineDepth`` entries stay in flight: entry
        N+1 is issued before entry N is waited on and adopted. ``drain``,
        when given, is called between pipeline steps. ``degraded`` lists
        every scheduled block that missed residency or adoption (the
        caller host-fetches them; a miss also unfuses its partition). If
        an exception unwinds, every in-flight entry's pins are closed on
        the way out."""
        if not plan.waves:
            return [], []
        fused = bool(fused) and self._conf.collective_fused_merge
        depth = max(1, self._conf.collective_pipeline_depth)
        self._schedule_label = plan.schedule
        reg = get_registry()
        results: List[CollectiveResult] = []
        degraded: List[PartitionLocation] = []
        self._m_plans.inc()
        stats = {"dispatch_ms": 0.0, "wave_ms": 0.0, "overlap_ms": 0.0}
        span = (
            self._tracer.span(
                "shuffle.collective", shuffle_id=shuffle_id,
                schedule=plan.schedule, waves=len(plan.waves),
                blocks=plan.device_blocks, depth=depth,
            )
            if self._tracer is not None
            else nullcontext()
        )
        with span:
            unfusable: set = set()
            inflight: Deque[_InflightWave] = deque()

            def _degrade_rows(rows: List[_Row]) -> None:
                if not rows:
                    return
                for row in rows:
                    degraded.append(row.loc)
                    unfusable.add(row.loc.partition_id)
                self._m_degrades.inc(len(rows))
                self._m_plane_fallbacks.inc(len(rows))

            def _consume_next() -> None:
                entry = inflight.popleft()
                self._consume_entry(
                    entry, dtype, fused, plan.fusable_pids, unfusable, results,
                    _degrade_rows, reg, overlapped=bool(inflight), stats=stats,
                    shuffle_id=shuffle_id,
                )
                if drain is not None:
                    drain()

            try:
                for group in self._coalesce(plan.waves, depth):
                    while len(inflight) >= depth:
                        _consume_next()
                    entry = self._issue_entry(
                        group, dtype, fused, plan.fusable_pids, reg,
                        overlapped=bool(inflight), stats=stats,
                    )
                    _degrade_rows(entry.dead)
                    if entry.all_dead:
                        continue
                    inflight.append(entry)
                    self._m_inflight.observe(float(len(inflight)))
                    if drain is not None:
                        drain()
                while inflight:
                    _consume_next()
            finally:
                # abort drain: release every in-flight entry's pins and
                # degrade its unadopted rows
                while inflight:
                    entry = inflight.popleft()
                    entry.close()
                    _degrade_rows(
                        [r for w in entry.waves for r in w.rows if r.live]
                    )
        # feed the stage's wave stats back into the per-shape cut
        if plan.sig is not None:
            self._tuner.observe(plan.sig, WaveReport(
                stage_bytes=plan.stage_bytes,
                min_group_bytes=plan.max_group_bytes,
                waves=len(plan.waves),
                depth=depth,
                dispatch_ms=stats["dispatch_ms"],
                wave_ms=stats["wave_ms"],
                overlap_ms=stats["overlap_ms"],
            ))
        return results, degraded

    # ------------------------------------------------------------------
    def _program_key_seen(self, key) -> None:
        with self._cache_lock:
            if key in self._seen_programs:
                self._m_cache_hits.inc()
            else:
                self._seen_programs.add(key)
                self._m_compiles.inc()

    def _coalesce(
        self, waves: List[CollectiveWave], depth: int
    ) -> List[List[CollectiveWave]]:
        """Group consecutive same-class waves into depth-bounded kernel
        runs, each ONE ``srt_pipelined_wave_pull`` launch. Off the kernel
        path every wave is its own pipeline entry."""
        if depth <= 1 or not self._kernel_path():
            return [[w] for w in waves]
        groups: List[List[CollectiveWave]] = []
        i = 0
        while i < len(waves):
            j = i + 1
            while (
                j < len(waves)
                and j - i < depth
                and waves[j].rows_b == waves[i].rows_b
                and waves[j].bucket_elems == waves[i].bucket_elems
            ):
                j += 1
            groups.append(list(waves[i:j]))
            i = j
        return groups

    def _issue_entry(
        self, waves: List[CollectiveWave], dtype, fused: bool,
        fusable_pids: frozenset, reg, overlapped: bool,
        stats: Dict[str, float],
    ) -> _InflightWave:
        """Pin, describe and DISPATCH one pipeline entry without waiting.
        Rows that fail the under-pin residency re-check come back in
        ``entry.dead``. The pins stay held until the entry's consume."""
        t0 = time.perf_counter()
        t_dtype = torch_dtype(dtype)
        itemsize = dtype_itemsize(dtype)
        kernel = self._kernel_path()
        pins = ExitStack()
        entry = _InflightWave(waves, pins, t0)
        try:
            # kernel path: one (source, byte offset, nbytes) per stack
            # row, wave-major; a dead or pad row pulls nothing
            table: List[Tuple[Optional[torch.Tensor], int, int]] = []
            for wave in waves:
                arrs: Dict[int, torch.Tensor] = {}
                views: Dict[int, torch.Tensor] = {}
                stacked: Optional[torch.Tensor] = None
                for i, row in enumerate(wave.rows):
                    blk = row.loc.block
                    arena = visible_arena(row.loc.manager_id.executor_id)
                    src = None
                    if arena is not None:
                        src = pins.enter_context(
                            arena.pinned_if_resident(blk.arena_handle)
                        )
                    if (
                        src is None
                        or blk.arena_offset + blk.length > src.capacity
                        or src.array.dtype != t_dtype
                    ):
                        row.live = False
                        entry.dead.append(row)
                        if kernel:
                            table.append((None, 0, 0))
                        continue
                    if kernel:
                        table.append(
                            (src.array, blk.arena_offset, row.elems * itemsize)
                        )
                        continue
                    fuse_row = fused and row.loc.partition_id in fusable_pids
                    if (
                        not fuse_row
                        and blk.arena_offset == 0
                        and src.capacity == _size_class(blk.length)
                    ):
                        # fast lane: copy the row's whole slab now and
                        # adopt it at consume
                        arrs[i] = remote_copy.emulated_row_pull_start(
                            src.array, self._dev.device
                        )
                        continue
                    off = blk.arena_offset // itemsize
                    host = src.array[off : off + row.elems]
                    if fuse_row:
                        # the merge at consume concatenates straight from
                        # this view (the pin keeps it valid)
                        views[i] = host
                        continue
                    if stacked is None:
                        stacked = torch.zeros(
                            (wave.rows_b, wave.bucket_elems), dtype=t_dtype
                        )
                    stacked[i, : row.elems] = host
                if kernel:
                    table.extend([(None, 0, 0)] * (wave.rows_b - len(wave.rows)))
                entry.row_arrs.append(arrs)
                entry.row_views.append(views)
                entry.stacked_hosts.append(stacked)
            live_rows = [r for w in waves for r in w.rows if r.live]
            if not live_rows:
                pins.close()
                entry.all_dead = True
                return entry
            if kernel:
                self._dispatch_kernel(waves, entry, table, t_dtype)
        except BaseException:
            pins.close()
            raise
        if len(waves) > 1:
            self._program_key_seen(("wave-pipe", len(waves), waves[0].rows_b,
                                    waves[0].bucket_elems,
                                    dtype_name(dtype)))
        else:
            self._program_key_seen(("wave", waves[0].rows_b,
                                    waves[0].bucket_elems,
                                    dtype_name(dtype)))
        entry.live = len(live_rows)
        entry.nbytes = sum(r.elems * itemsize for r in live_rows)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        reg.histogram(
            "collective.wave_dispatch_ms", role=self._executor_id,
            schedule=self._schedule_label,
        ).observe(dispatch_ms)
        stats["dispatch_ms"] += dispatch_ms
        if overlapped:
            # issued while earlier waves were still in flight
            stats["overlap_ms"] += dispatch_ms
            self._m_overlap.inc(dispatch_ms)
        return entry

    def _dispatch_kernel(self, waves: List[CollectiveWave],
                         entry: _InflightWave, table, t_dtype) -> None:
        """Launch the entry's pulls as one kernel (the pipelined form for
        a same-class run) without waiting; an event recorded behind the
        launch marks its completion."""
        device = self._dev.device
        srcs = [t[0] for t in table]
        offs = [t[1] for t in table]
        nbs = [t[2] for t in table]
        rows_b, b_elems = waves[0].rows_b, waves[0].bucket_elems
        start = done = None
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        if len(waves) == 1:
            landed = remote_copy.wave_pull(
                srcs, offs, nbs, rows_b, b_elems, t_dtype, device=device,
            )[None]
        else:
            landed = remote_copy.pipelined_wave_pull(
                srcs, offs, nbs, rows_b, b_elems, t_dtype, len(waves),
                device=device,
            )
        if start is not None:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            entry.events = (start, done)
        entry.landed = landed

    def _consume_entry(
        self, entry: _InflightWave, dtype, fused: bool,
        fusable_pids: frozenset, unfusable: set, results, _degrade_rows,
        reg, overlapped: bool, stats: Dict[str, float], shuffle_id: int = 0,
    ) -> None:
        """Wait for one entry's copies, adopt its rows into arena slabs,
        then release its pins. An adoption failure degrades the affected
        rows; the pipeline keeps flowing."""
        t0 = time.perf_counter()
        role = self._executor_id
        if entry.events is not None:
            start, done = entry.events
            done.synchronize()
            self.kernel_ms.append(start.elapsed_time(done))
        else:
            remote_copy.emulated_wave_wait(
                [a for arrs in entry.row_arrs for a in arrs.values()]
            )
        itemsize = dtype_itemsize(dtype)
        now = time.perf_counter()
        try:
            for d, wave in enumerate(entry.waves):
                live = [r for r in wave.rows if r.live]
                if not live:
                    continue
                nbytes = sum(r.elems * itemsize for r in live)
                self._m_blocks.inc(len(live))
                self._m_bytes.inc(nbytes)
                self._m_plane_pulls.inc(len(live))
                self._m_plane_bytes.inc(nbytes)
                reg.counter(
                    "collective.waves", role=role,
                    schedule=self._schedule_label,
                ).inc()
                kernel = entry.landed is not None
                out, failed = self._adopt_wave(
                    wave,
                    entry.landed[d] if kernel else None,
                    dtype, fused, fusable_pids - unfusable,
                    stacked_host=None if kernel else entry.stacked_hosts[d],
                    row_arrs=None if kernel else entry.row_arrs[d],
                    row_views=None if kernel else entry.row_views[d],
                )
                results.extend(out)
                _degrade_rows(failed)
                reg.histogram(
                    "collective.wave_ms", role=role,
                    schedule=self._schedule_label,
                ).observe((now - entry.t0) * 1e3)
                stats["wave_ms"] += (now - entry.t0) * 1e3
                if self._tracer is not None:
                    # per-wave span, nested under execute()'s
                    # shuffle.collective span through the contextvar
                    self._tracer.record(
                        "shuffle.collective.wave",
                        entry.t0,
                        time.perf_counter(),
                        shuffle_id=shuffle_id,
                        rows=len(live),
                        bytes=nbytes,
                    )
        finally:
            entry.close()
        consume_ms = (time.perf_counter() - t0) * 1e3
        if overlapped:
            # this merge ran with later waves already in flight
            stats["overlap_ms"] += consume_ms
            self._m_overlap.inc(consume_ms)

    # conf-resolved schedule of the plan currently executing
    _schedule_label = "ring"

    def _adopt_wave(self, wave, stacked_dev, dtype, fused, fusable_pids,
                    stacked_host=None, row_arrs=None, row_views=None):
        """Adopt a landed wave into arena slabs: fused partitions land as
        one merged slab, everything else per block. Returns ``(results,
        failed_rows)``.

        Kernel path: rows are sliced from the landed device stack, and a
        fused partition comes out of the compaction gather on the same
        device. CPU movers: fast-lane copies adopt whole, fused rows
        concatenate from views of the still-pinned sources, assembled
        rows stage their exact payload."""
        t_dtype = torch_dtype(dtype)
        itemsize = dtype_itemsize(dtype)
        row_arrs = row_arrs or {}
        row_views = row_views or {}
        out: List[CollectiveResult] = []
        failed: List[_Row] = []
        flat = None
        starts_e = None
        if fused:
            counts = np.array(
                [r.elems if r.live else 0 for r in wave.rows]
                + [0] * (wave.rows_b - len(wave.rows)),
                dtype=np.int32,
            )
            ends_e = np.cumsum(counts, dtype=np.int32)
            starts_e = ends_e - counts
            need = any(
                r.live and r.loc.partition_id in fusable_pids
                for r in wave.rows
            )
            if need and stacked_dev is not None:
                self._program_key_seen(("compact", wave.rows_b,
                                        wave.bucket_elems,
                                        dtype_name(dtype)))
                flat = _compaction_program(
                    stacked_dev, torch.from_numpy(starts_e),
                    torch.from_numpy(ends_e),
                )
            elif need:
                parts = [
                    row_views[i] if i in row_views
                    else stacked_host[i, : r.elems]
                    for i, r in enumerate(wave.rows) if r.live
                ]
                flat = (torch.cat(parts) if parts
                        else torch.empty(0, dtype=t_dtype))

        i = 0
        n = len(wave.rows)
        while i < n:
            pid = wave.rows[i].loc.partition_id
            j = i
            while j < n and wave.rows[j].loc.partition_id == pid:
                j += 1
            group = [r for r in wave.rows[i:j] if r.live]
            if not group:
                i = j
                continue
            try:
                if fused and flat is not None and pid in fusable_pids:
                    lo = int(starts_e[i])
                    hi = lo + sum(r.elems for r in group)
                    dev = self._adopt(flat[lo:hi])
                    out.append(CollectiveResult(
                        pid, dev, [r.loc for r in group], True
                    ))
                    self._m_fused.inc()
                else:
                    for k, r in enumerate(wave.rows[i:j]):
                        if not r.live:
                            continue
                        nbytes = r.elems * itemsize
                        idx = i + k
                        if stacked_dev is not None:
                            dev = self._adopt(stacked_dev[idx, : r.elems])
                        elif idx in row_arrs:
                            # the whole source slab class swaps in
                            dev = self._adopt(row_arrs[idx])
                            dev.length = nbytes
                        elif idx in row_views:
                            # fused-pid row whose partition unfused
                            dev = self._dev.stage_view(
                                row_views[idx].numpy(), nbytes, dtype,
                            )
                        else:
                            dev = self._dev.stage_view(
                                stacked_host[idx, : r.elems].numpy(),
                                nbytes, dtype,
                            )
                        out.append(
                            CollectiveResult(pid, dev, [r.loc], False)
                        )
            except MemoryError:
                # the reducer's arena budget, not the mover: degrade
                logger.exception(
                    "wave adoption failed for partition %d; degrading", pid
                )
                failed.extend(group)
            i = j
        return out, failed

    def _adopt(self, arr: torch.Tensor) -> DeviceBuffer:
        """Write ``arr`` into a fresh slab of the reducer's arena."""
        dev = self._dev.get(arr.numel() * arr.element_size())
        try:
            return dev.put_array(arr)
        except BaseException:
            dev.free()
            raise
