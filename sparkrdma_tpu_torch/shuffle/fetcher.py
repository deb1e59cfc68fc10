"""TpuShuffleFetcherIterator — the read-path engine.

Analogue of RdmaShuffleFetcherIterator.scala (reference: RdmaShuffleFetcherIterator.scala). Semantics preserved:

- async location fetch from the driver for ``[start, end)`` with a
  timeout wrapper (:108-122, 220-320),
- local partitions short-circuit to streams, never looping through the
  network (:328-339; SURVEY.md §5.1 #2),
- remote blocks are grouped **per source manager** into
  ``AggregatedPartitionGroup``s capped at ``shuffle_read_block_size``
  (:252-275),
- one one-sided READ per group pulls all its blocks into one pooled
  registered buffer, sliced per block (:132-218),
- ``max_bytes_in_flight`` throttle with a pending-fetch queue drained
  as results are consumed (:279-284, 369-379),
- the blocking results queue carries Success/Failure/FailureMetadata
  and a sentinel "+1 block" protocol keeps ``has_next`` truthful until
  all fetches are enqueued (:47-50, 124-130, 288, 434-448),
- failures walk the resilience retry ladder BEFORE surfacing
  (docs/RESILIENCE.md): retry the same source with backoff, re-resolve
  locations from the driver (stale mkeys / respawned writers), split
  the aggregated group into per-block fetches — and only after
  exhaustion (or an open circuit breaker, or a blown deadline) raise
  FetchFailedError / MetadataFetchFailedError for stage recompute
  (:203, 381-391 — the reference's ONLY move, now the last resort),
- delivered blocks are validated against their published checksum; a
  mismatch is a retryable fault like any other READ failure,
- streams release their registered buffer slice on close
  (BufferReleasingInputStream, :399-429),
- per-fetch latency histogram hook (:186-189).

A copy of the JAX package's ``shuffle/fetcher.py``, its imports
rewritten to this package (the lock-order and model-checker calls go to the
port's ``analysis/lockorder.py`` and ``analysis/modelcheck``). The native plane's
branches run on ``NativeTpuNode``: the read-completion ring drain
(``drain_read_ring``) and mapped delivery (``mapped_delivery_enabled``
is True on a ``NativeTpuChannel`` with ``mappedFetch`` on).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.tenancy import quota as _tquota
from sparkrdma_tpu_torch.locations import BlockLocation, PartitionLocation, ShuffleManagerId
from sparkrdma_tpu_torch.memory.registered_buffer import RegisteredBuffer
from sparkrdma_tpu_torch.memory.streams import MemoryviewInputStream
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs import now as obs_now
from sparkrdma_tpu_torch.resilience import CircuitOpenError, RetryPolicy
from sparkrdma_tpu_torch.shuffle import merge as _merge
from sparkrdma_tpu_torch.shuffle.errors import (
    ChecksumError,
    FetchFailedError,
    MetadataFetchFailedError,
)
from sparkrdma_tpu_torch.testing import faults as _faults
from sparkrdma_tpu_torch.transport import FnListener, mapped_delivery_enabled
from sparkrdma_tpu_torch.utils import checksum as _checksum

logger = logging.getLogger(__name__)


@dataclass
class ShuffleMetrics:
    """TaskMetrics stand-in (reference Spark metrics integration)."""

    local_blocks: int = 0
    remote_blocks: int = 0
    local_bytes: int = 0
    remote_bytes: int = 0
    fetch_wait_ms: float = 0.0
    records_read: int = 0
    sort_spills: int = 0  # external-sorter runs spilled to scratch
    merged_blocks: int = 0  # merged segments read in place of originals


@dataclass
class AggregatedPartitionGroup:
    """Blocks from one source manager read in one one-sided READ (:71-74).

    ``fallbacks`` rides only on groups carrying a MERGED segment
    (shuffle/merge.py): the partition's suppressed original locations,
    re-issued by ``_fallback_refetch`` if the merged read fails."""

    total_length: int = 0
    blocks: List[Tuple[int, BlockLocation]] = field(default_factory=list)  # (pid, loc)
    fallbacks: Dict[int, List[PartitionLocation]] = field(default_factory=dict)


@dataclass
class _Success:
    streams: List[Tuple[int, BinaryIO]]  # (partition_id, stream)
    in_flight: int = 0


@dataclass
class _Failure:
    manager_id: Optional[ShuffleManagerId]
    partition_id: int
    error: Exception
    in_flight: int = 0


class _Dummy:
    in_flight = 0


@dataclass
class _PendingFetch:
    """One group READ plus its position on the retry ladder.

    ``attempt`` is the next attempt number to issue (0 = initial);
    ``deadline`` is the group's wall budget across ALL its retries
    (monotonic seconds; +inf when resilience.fetchDeadlineMs is 0).
    """

    manager_id: ShuffleManagerId
    group: AggregatedPartitionGroup
    attempt: int = 0
    deadline: float = float("inf")


class TpuShuffleFetcherIterator:
    """Iterator of (partition_id, stream) over local + remote blocks."""

    def __init__(self, manager, handle, start_partition: int, end_partition: int):
        self._manager = manager
        self._handle = handle
        self.start_partition = start_partition
        self.end_partition = end_partition
        self.metrics = ShuffleMetrics()

        # registry mirrors of ShuffleMetrics, pre-resolved per iterator
        role = manager.executor_id
        reg = get_registry()
        self._m_local_blocks = reg.counter("reader.local_blocks", role=role)
        self._m_local_bytes = reg.counter("reader.local_bytes", role=role)
        self._m_remote_blocks = reg.counter("reader.remote_blocks", role=role)
        self._m_remote_bytes = reg.counter("reader.remote_bytes", role=role)
        self._m_fetch_wait_ms = reg.counter("reader.fetch_wait_ms", role=role)
        self._h_fetch_ms = reg.histogram("reader.fetch_ms", role=role)

        # resilience: retry policy, per-peer circuit breakers (shared
        # with the manager), and the resilience.* counter family
        self._retry_policy = RetryPolicy.from_conf(manager.conf)
        self._health = manager.health
        # captured once: breaker calls and retries land on completion
        # and timer threads that carry no tenant scope of their own
        self._tenant = tenancy.current_tenant()
        self._m_retries = reg.counter("resilience.retries", role=role)
        self._m_checksum_failures = reg.counter(
            "resilience.checksum_failures", role=role
        )
        self._m_failovers = reg.counter("resilience.failovers", role=role)
        self._m_splits = reg.counter("resilience.splits", role=role)
        self._m_fail_fast = reg.counter("resilience.circuit_fail_fast", role=role)
        # push/merge plane: merged segments chosen over originals, and
        # merged reads that degraded back to the originals
        self._m_merged_reads = reg.counter("reader.merged_reads", role=role)
        self._m_merged_fallbacks = reg.counter("push.fallbacks", role=role)

        self._results: "queue.Queue" = queue.Queue()
        # hot: in-flight accounting and pending-queue bookkeeping only
        self._lock = named_lock("fetcher.state", hot=True)
        # sentinel "+1": keeps has_next true until enumeration completes
        self._total_results = 1
        self._processed_results = 0
        self._bytes_in_flight = 0
        self._pending: List[_PendingFetch] = []
        self._buffered: List[Tuple[int, BinaryIO]] = []
        self._closed = False

        self._start()

    # ------------------------------------------------------------------
    def _start(self) -> None:
        # the resolver thread allocates destination buffers and posts
        # the initial READs: run it under the owning tenant's scope so
        # quota charges and fault/breaker attribution stay correct
        threading.Thread(
            target=tenancy.scoped(self._tenant, self._resolve_and_fetch),
            name="fetcher-locations",
            daemon=True,
        ).start()

    def _resolve_and_fetch(self) -> None:
        """Async location resolution + group construction (:220-320)."""
        t0 = time.monotonic()
        future = self._manager.fetch_remote_partition_locations(
            self._handle.shuffle_id, self.start_partition, self.end_partition
        )
        try:
            locations: List[PartitionLocation] = future.result(
                timeout=self._manager.conf.fetch_location_timeout_ms / 1000.0
            )
        except Exception as e:
            self._results.put(
                _Failure(
                    None,
                    self.start_partition,
                    MetadataFetchFailedError(
                        self._handle.shuffle_id, self.start_partition, str(e)
                    ),
                )
            )
            return
        logger.debug(
            "fetched %d locations in %.1f ms",
            len(locations),
            (time.monotonic() - t0) * 1e3,
        )

        # merged-else-original (shuffle/merge.py): a partition whose
        # merged segment covers ALL its originals is read as ONE
        # sequential block; its originals stay attached as fallbacks
        my_id = self._manager.executor_id
        locations, merged_fallbacks = _merge.plan_reads(locations)
        if merged_fallbacks:
            self._m_merged_reads.inc(len(merged_fallbacks))
            self.metrics.merged_blocks += len(merged_fallbacks)
        merged_local = [
            loc
            for loc in locations
            if loc.block.merged_cover and loc.manager_id.executor_id == my_id
        ]
        if merged_local:
            locations = [loc for loc in locations if loc not in merged_local]
        for loc in merged_local:
            streams = self._read_local_merged(loc)
            if streams is None:
                # local merged segment unusable: restore the originals
                # into the ordinary plan (locals short-circuit below)
                locations.extend(merged_fallbacks.pop(loc.partition_id, ()))
                continue
            self.metrics.local_blocks += 1
            self.metrics.local_bytes += loc.block.length
            self._m_local_blocks.inc()
            self._m_local_bytes.inc(loc.block.length)
            with self._lock:
                self._total_results += 1
            self._put_success(streams, 0)

        # Local partitions short-circuit to streams (:328-339) — served
        # HERE, after the driver's barrier-gated reply, not at iterator
        # construction: a snapshot taken earlier would race local map
        # tasks that finish after the reader starts and silently drop
        # their records. The reply is complete by construction, so the
        # resolver now holds every local block the reply names.
        #
        # Replica blocks this executor HOLDS (promoted by the driver
        # after their source died) are excluded from the pid set: the
        # resolver's local streams cover only this executor's own
        # committed map outputs, while replica bytes live in the
        # ReplicaStore's registered segment — they are served by direct
        # resolve below, never by the stream short-circuit.
        my_id = self._manager.executor_id
        resolver = self._manager.resolver
        local_pids = sorted(
            {
                loc.partition_id
                for loc in locations
                if loc.manager_id.executor_id == my_id
                and not loc.block.replica_of
            }
        )
        local_streams: List[Tuple[int, BinaryIO]] = []
        for pid in local_pids:
            for stream in resolver.get_local_partition_streams(
                self._handle.shuffle_id, pid
            ):
                local_streams.append((pid, stream))
                self.metrics.local_blocks += 1
        # local bytes from the published block lengths (the streams
        # themselves are opaque); mirrors remote_bytes accounting
        local_bytes = sum(
            loc.block.length
            for loc in locations
            if loc.manager_id.executor_id == my_id
            and not loc.block.replica_of
        )
        unreadable_replicas: List[PartitionLocation] = []
        for loc in locations:
            if loc.manager_id.executor_id != my_id or not loc.block.replica_of:
                continue
            streams = self._read_local_replica(loc)
            if streams is None:
                # segment gone (store teardown race): let the remote
                # ladder re-resolve and fail over to another holder
                unreadable_replicas.append(loc)
                continue
            local_streams.extend(streams)
            local_bytes += loc.block.length
            self.metrics.local_blocks += 1
        self.metrics.local_bytes += local_bytes
        self._m_local_blocks.inc(len(local_streams))
        self._m_local_bytes.inc(local_bytes)
        if local_streams:
            with self._lock:
                self._total_results += 1
            # via _put_success: a close() racing this thread must sweep
            # (or be handed) these streams, never strand them
            self._put_success(local_streams, 0)

        by_manager: Dict[ShuffleManagerId, List[Tuple[int, BlockLocation]]] = {}
        for loc in locations:
            if loc.manager_id.executor_id == my_id:
                if loc not in unreadable_replicas:
                    continue  # served locally above
            by_manager.setdefault(loc.manager_id, []).append((loc.partition_id, loc.block))

        # pack per-manager groups ≤ read_block_size (:252-275)
        read_block_size = self._manager.conf.shuffle_read_block_size
        deadline = time.monotonic() + self._retry_policy.deadline_s()
        fetches: List[_PendingFetch] = []
        for mid, blocks in by_manager.items():
            group = AggregatedPartitionGroup()
            for pid, block in blocks:
                if group.blocks and group.total_length + block.length > read_block_size:
                    fetches.append(_PendingFetch(mid, group, deadline=deadline))
                    group = AggregatedPartitionGroup()
                group.blocks.append((pid, block))
                group.total_length += block.length
                if block.merged_cover and pid in merged_fallbacks:
                    group.fallbacks[pid] = merged_fallbacks[pid]
            if group.blocks:
                fetches.append(_PendingFetch(mid, group, deadline=deadline))

        max_in_flight = self._manager.conf.max_bytes_in_flight
        start_now: List[_PendingFetch] = []
        with self._lock:
            self._total_results += len(fetches)
            if self._closed:
                # closed while resolving: never launch READs for a
                # dead task (accounting is moot — has_next is False)
                fetches = []
            for fetch in fetches:
                if self._bytes_in_flight < max_in_flight:
                    self._bytes_in_flight += fetch.group.total_length
                    start_now.append(fetch)
                else:
                    self._pending.append(fetch)
        # resolve the sentinel now that enumeration is complete (:124-130)
        self._results.put(_Dummy())
        for fetch in start_now:
            self._fetch_blocks(fetch)

    def _group_failure(self, fetch: _PendingFetch, cleanup=None):
        """Once-only failure handler for one group READ attempt
        (on_failure may legally fire more than once; ``cleanup``
        releases the attempt's destination resources, if any). The
        failure enters the retry ladder instead of surfacing directly."""
        failed_once = threading.Event()

        def on_failure(e: Exception) -> None:
            if failed_once.is_set():
                return
            failed_once.set()
            if cleanup is not None:
                cleanup()
            self._retry_or_fail(fetch, e)

        return on_failure

    # ------------------------------------------------------------------
    # resilience: the retry ladder (docs/RESILIENCE.md)
    # ------------------------------------------------------------------
    def _surface_failure(self, fetch: _PendingFetch, error: Exception) -> None:
        self._results.put(
            _Failure(
                fetch.manager_id,
                fetch.group.blocks[0][0],
                error,
                in_flight=fetch.group.total_length,
            )
        )

    def _retry_or_fail(self, fetch: _PendingFetch, error: Exception) -> None:
        """One attempt failed: schedule the next ladder rung, or give up.

        Gives up — surfacing _Failure for FetchFailedError / stage
        recompute — when the policy's attempts are exhausted, the
        group's wall deadline has passed, the error is non-retryable
        (an open circuit IS the fail-fast decision), or the iterator
        closed. Otherwise the retry is scheduled on a timer after the
        policy's deterministic backoff; no completion thread sleeps.
        """
        if fetch.group.fallbacks:
            # a merged-segment group: never walk the ladder — the
            # merged-else-original contract's else branch re-issues the
            # partition's original locations immediately
            self._fallback_refetch(fetch, error)
            return
        mid, group = fetch.manager_id, fetch.group
        failed_attempt = fetch.attempt
        retryable = not isinstance(error, CircuitOpenError)
        if retryable:
            self._health.record_failure(mid.executor_id, tenant=self._tenant)
        with self._lock:
            closed = self._closed
        if (
            not retryable
            or closed
            or not self._retry_policy.allows(failed_attempt + 1)
            or time.monotonic() >= fetch.deadline
        ):
            self._surface_failure(fetch, error)
            return
        fetch.attempt = failed_attempt + 1
        self._m_retries.inc()
        delay = self._retry_policy.backoff_s(
            failed_attempt,
            self._handle.shuffle_id,
            mid.executor_id,
            group.blocks[0][0],
        )
        logger.info(
            "fetch group from %s failed (attempt %d: %s); retrying in %.0f ms",
            mid.executor_id,
            failed_attempt,
            error,
            delay * 1e3,
        )
        t = threading.Timer(delay, self._retry_fetch, args=(fetch,))
        t.daemon = True
        t.start()

    def _retry_fetch(self, fetch: _PendingFetch) -> None:
        """Issue the next rung: 1 = same source, 2 = re-resolve and
        failover, 3+ = split the group into per-block fetches.

        Runs on a bare timer thread: re-enter the owning tenant's
        scope so re-issued IO (fault plans, quota charges, downstream
        allocations) stays attributed to the tenant that started it."""
        with self._lock:
            if self._closed:
                return  # dead task; the attempt holds no resources
        with tenancy.tenant_scope(self._tenant):
            if fetch.attempt >= 3 and len(fetch.group.blocks) > 1:
                self._split_and_refetch(fetch)
            elif fetch.attempt >= 2:
                self._failover_refetch(fetch)
            else:
                self._fetch_blocks(fetch)

    def _failover_refetch(self, fetch: _PendingFetch) -> None:
        """Re-resolve locations from the driver and re-aim the group.

        Handles stale mkeys and respawned writers: a re-published block
        of the same (partition, length) on the same executor identity
        replaces the stale handle, and the fresh ShuffleManagerId
        carries the respawned endpoint's host:port. Blocks never
        migrate across executor identities without a stage recompute,
        so matching stays within ``mid.executor_id`` — the one sanctioned
        exception is a location whose ``replica_of`` IS that identity
        (elastic replication / service handoff): that block is a
        byte-identical copy of the same map output published under a
        surviving holder, so failing over to it is still an
        identity-preserving retarget. Primaries outrank replicas when
        both are live. Runs on a retry timer thread, so blocking on the
        location future is fine."""
        mid, group = fetch.manager_id, fetch.group
        try:
            future = self._manager.fetch_remote_partition_locations(
                self._handle.shuffle_id, self.start_partition, self.end_partition
            )
            fresh: List[PartitionLocation] = future.result(
                timeout=self._manager.conf.fetch_location_timeout_ms / 1000.0
            )
        except Exception as e:
            logger.warning(
                "failover re-resolve failed (%s); retrying stale locations", e
            )
            self._fetch_blocks(fetch)
            return
        self._m_failovers.inc()
        pool: Dict[Tuple[int, int], List[PartitionLocation]] = {}
        replicas: List[PartitionLocation] = []
        for loc in fresh:
            if loc.manager_id.executor_id != mid.executor_id:
                if loc.block.replica_of == mid.executor_id:
                    replicas.append(loc)
                continue
            pool.setdefault((loc.partition_id, loc.block.length), []).append(loc)
        for loc in replicas:  # appended after ALL primaries: lower rank
            pool.setdefault((loc.partition_id, loc.block.length), []).append(loc)
        new_mid = mid
        new_blocks: List[Tuple[int, BlockLocation]] = []
        for pid, block in group.blocks:
            cands = pool.get((pid, block.length), [])
            # prefer the exact published handle (unchanged block); else
            # any re-published sibling of the same length
            pick = next((loc for loc in cands if loc.block == block), None)
            if pick is None and cands:
                pick = cands[0]
            if pick is not None:
                cands.remove(pick)
                block = pick.block
                new_mid = pick.manager_id
            new_blocks.append((pid, block))
        fetch.manager_id = new_mid
        fetch.group = AggregatedPartitionGroup(
            total_length=group.total_length, blocks=new_blocks
        )
        self._fetch_blocks(fetch)

    def _split_and_refetch(self, fetch: _PendingFetch) -> None:
        """Break the aggregated group into single-block fetches so one
        poisoned block no longer fails its groupmates. Each sub-fetch
        keeps the parent's attempt number and deadline; the result
        accounting grows by k-1 (each sub-result carries its own
        in_flight share, summing to the parent's)."""
        mid, group = fetch.manager_id, fetch.group
        subs = [
            _PendingFetch(
                mid,
                AggregatedPartitionGroup(
                    total_length=block.length, blocks=[(pid, block)]
                ),
                attempt=fetch.attempt,
                deadline=fetch.deadline,
            )
            for pid, block in group.blocks
        ]
        with self._lock:
            if self._closed:
                return
            self._total_results += len(subs) - 1
        self._m_splits.inc()
        logger.info(
            "splitting %d-block group from %s for per-block retry",
            len(subs),
            mid.executor_id,
        )
        for sub in subs:
            self._fetch_blocks(sub)

    def _read_local_merged(self, loc: PartitionLocation):
        """Serve a merged segment sealed on THIS executor: resolve the
        registered bytes directly — and verify the publish-time
        checksum HERE, because the local path bypasses the remote
        READ's checksum gate and a corrupted merged segment must fall
        back to the originals, never reach the deserializer. Returns
        the (pid, stream) list, or None to fall back."""
        block = loc.block
        try:
            view = self._manager.node.pd.resolve(
                block.mkey, block.address, block.length
            )
            if not _checksum.verify(view, block.checksum, block.checksum_algo):
                raise ChecksumError(
                    self._handle.shuffle_id,
                    loc.partition_id,
                    f"merged segment of {block.length} bytes (local)",
                )
        except Exception as e:
            self._m_checksum_failures.inc()
            self._m_merged_fallbacks.inc()
            logger.warning(
                "local merged segment for pid %d unusable (%s); "
                "falling back to originals",
                loc.partition_id,
                e,
            )
            return None
        return [(loc.partition_id, MemoryviewInputStream(view))]

    def _read_local_replica(self, loc: PartitionLocation):
        """Serve a promoted replica block held by THIS executor. Its
        bytes sit in the local ReplicaStore's registered segment, which
        the resolver's local-stream path (own map outputs only) cannot
        see — resolve the registered memory directly, with the same
        local checksum gate as ``_read_local_merged``. Returns the
        (pid, stream) list, or None to route through the remote ladder."""
        block = loc.block
        try:
            view = self._manager.node.pd.resolve(
                block.mkey, block.address, block.length
            )
            if not _checksum.verify(view, block.checksum, block.checksum_algo):
                raise ChecksumError(
                    self._handle.shuffle_id,
                    loc.partition_id,
                    f"replica block of {block.length} bytes (local)",
                )
        except Exception as e:
            self._m_checksum_failures.inc()
            logger.warning(
                "local replica block for pid %d unusable (%s); "
                "routing through remote refetch",
                loc.partition_id,
                e,
            )
            return None
        return [(loc.partition_id, MemoryviewInputStream(view))]

    def _fallback_refetch(self, fetch: _PendingFetch, error: Exception) -> None:
        """A merged-segment read failed (checksum mismatch, dead peer,
        dropped buffer): re-issue the partitions' ORIGINAL per-map
        locations, kept attached as the group's fallbacks — the
        merged-else-original contract's else branch. Accounting mirrors
        ``_split_and_refetch``: the parent result slot is replaced by
        the replacements' and their in_flight shares sum to the
        parent's total (a merged segment's length equals the sum of
        its originals')."""
        group = fetch.group
        self._m_merged_fallbacks.inc()
        logger.info(
            "merged read from %s failed (%s); falling back to originals "
            "for %d partition(s)",
            fetch.manager_id.executor_id,
            error,
            len(group.fallbacks),
        )
        my_id = self._manager.executor_id
        resolver = self._manager.resolver
        local_streams: List[Tuple[int, BinaryIO]] = []
        served_local = set()
        by_manager: Dict[ShuffleManagerId, List[Tuple[int, BlockLocation]]] = {}
        for pid, block in group.blocks:
            originals = group.fallbacks.get(pid) if block.merged_cover else None
            if originals is None:
                # non-merged groupmate: re-fetch as-is from the source
                by_manager.setdefault(fetch.manager_id, []).append((pid, block))
                continue
            for loc in originals:
                if loc.manager_id.executor_id == my_id:
                    if pid not in served_local:
                        served_local.add(pid)
                        for stream in resolver.get_local_partition_streams(
                            self._handle.shuffle_id, pid
                        ):
                            local_streams.append((pid, stream))
                else:
                    by_manager.setdefault(loc.manager_id, []).append(
                        (pid, loc.block)
                    )
        read_block_size = self._manager.conf.shuffle_read_block_size
        subs: List[_PendingFetch] = []
        for mid, blocks in by_manager.items():
            g = AggregatedPartitionGroup()
            for pid, block in blocks:
                if g.blocks and g.total_length + block.length > read_block_size:
                    subs.append(_PendingFetch(mid, g, deadline=fetch.deadline))
                    g = AggregatedPartitionGroup()
                g.blocks.append((pid, block))
                g.total_length += block.length
            if g.blocks:
                subs.append(_PendingFetch(mid, g, deadline=fetch.deadline))
        remote_sum = sum(s.group.total_length for s in subs)
        local_share = max(0, group.total_length - remote_sum)
        put_local = bool(local_streams) or local_share > 0 or not subs
        n_new = len(subs) + (1 if put_local else 0)
        with self._lock:
            closed = self._closed
            if not closed:
                self._total_results += n_new - 1
        if closed:
            for _pid, stream in local_streams:
                try:
                    stream.close()
                except Exception:
                    logger.exception("closing fallback stream failed")
            return
        if put_local:
            self.metrics.local_blocks += len(local_streams)
            self.metrics.local_bytes += local_share
            self._m_local_blocks.inc(len(local_streams))
            self._m_local_bytes.inc(local_share)
            self._put_success(local_streams, local_share)
        for sub in subs:
            self._fetch_blocks(sub)

    def _bad_block(self, group: AggregatedPartitionGroup, views) -> Optional[int]:
        """Index of the first checksum-mismatched block, else None."""
        plan = _faults.active()
        if plan is not None:
            # block-format seam: the plan may flip a byte inside a landed
            # columnar frame's header span — BEFORE the verify loop below
            plan.on_block(views)
        for i, ((_pid, block), view) in enumerate(zip(group.blocks, views)):
            if not _checksum.verify(view, block.checksum, block.checksum_algo):
                return i
        return None

    def _deliver_group(self, mid, group, streams, t0) -> None:
        """Shared success epilogue: histogram, metrics, closed-aware
        enqueue — ONE definition for both delivery flavors."""
        t1 = obs_now()
        latency_ms = (t1 - t0) * 1e3
        stats = self._manager.reader_stats
        if stats is not None:
            stats.update_remote_fetch_histogram(mid, latency_ms)
        self.metrics.remote_blocks += len(streams)
        self.metrics.remote_bytes += group.total_length
        self._m_remote_blocks.inc(len(streams))
        self._m_remote_bytes.inc(group.total_length)
        self._h_fetch_ms.observe(latency_ms)
        # fetch span: the trace id arrived with the location reply, so
        # the binding is resolvable by now; it causally follows the
        # driver resolve span whose reply named these locations
        fsp = self._manager.tracer.record(
            "shuffle.fetch",
            t0,
            t1,
            shuffle_id=self._handle.shuffle_id,
            follows=self._manager.resolve_origin(
                self._handle.shuffle_id, self.start_partition
            ),
            peer=mid.executor_id,
            bytes=group.total_length,
            blocks=len(streams),
        )
        # native submission plane: drain the node's read-completion
        # timestamp ring into transport.native_read spans, so the
        # submit→complete interval inside this fetch window is traced
        # (host-read attribution, obs/attr.py)
        drain = getattr(getattr(self._manager, "node", None),
                        "drain_read_ring", None)
        if drain is not None:
            for rt0, rt1, nbytes in drain():
                self._manager.tracer.record(
                    "transport.native_read",
                    rt0,
                    rt1,
                    shuffle_id=self._handle.shuffle_id,
                    follows=fsp,
                    bytes=nbytes,
                )
        self._put_success(streams, group.total_length)

    def _fetch_blocks(self, fetch: _PendingFetch) -> None:
        """Issue one one-sided READ attempt for a group (:132-218)."""
        mid, group = fetch.manager_id, fetch.group
        if not self._health.allow(mid.executor_id, tenant=self._tenant):
            # open circuit: no READ, no retry ladder — the breaker IS
            # the fail-fast decision for a peer presumed dead, so this
            # surfaces immediately as a FetchFailedError / recompute
            self._m_fail_fast.inc()
            err = CircuitOpenError(
                f"circuit to {mid.executor_id} is open (peer unhealthy)"
            )
            if group.fallbacks:
                # merged segment behind an open circuit: its originals
                # (on other, possibly healthy peers) are the answer
                self._fallback_refetch(fetch, err)
                return
            self._surface_failure(fetch, err)
            return
        t0 = obs_now()
        try:
            # bulk READ payloads ride the data-flavor channel so an 8 MiB
            # in-flight group never head-of-line blocks a location fetch
            # on the rpc channel (RdmaChannel.java:110-154)
            channel = self._manager.get_channel_to(mid, purpose="data")
            if mapped_delivery_enabled(self._manager.conf, channel):
                self._fetch_blocks_mapped(fetch, channel, t0)
                return
            reg = RegisteredBuffer(self._manager.buffer_manager, group.total_length)
            # each slice holds one refcount; buffer returns to the pool
            # when the last stream closes (:399-429)
            slices = [reg.slice(block.length) for _, block in group.blocks]
        except Exception as e:
            # connect/allocation failures walk the same ladder as READ
            # completions: a refused connection to a restarting peer is
            # exactly what same-source retry + failover exist for
            self._retry_or_fail(fetch, e)
            return

        fail = self._group_failure(
            fetch, cleanup=lambda: [sl.release() for sl in slices]
        )

        def on_success(_) -> None:
            bad = self._bad_block(group, [sl.view for sl in slices])
            if bad is not None:
                pid, block = group.blocks[bad]
                self._m_checksum_failures.inc()
                fail(
                    ChecksumError(
                        self._handle.shuffle_id,
                        pid,
                        f"block of {block.length} bytes from {mid.executor_id}",
                    )
                )
                return
            self._health.record_success(mid.executor_id, tenant=self._tenant)
            streams: List[Tuple[int, BinaryIO]] = [
                (pid, MemoryviewInputStream(sl.view, on_close=sl.release))
                for (pid, _block), sl in zip(group.blocks, slices)
            ]
            self._deliver_group(mid, group, streams, t0)

        channel.read_in_queue(
            FnListener(on_success, fail),
            [sl.view for sl in slices],
            [(block.mkey, block.address, block.length) for _, block in group.blocks],
        )

    def _fetch_blocks_mapped(self, fetch: _PendingFetch, channel, t0) -> None:
        """Mapped-delivery flavor of the group READ (native transport):
        no pooled destination buffer — same-host blocks stream straight
        from page-cache mappings, remote ones from one malloc'd blob.
        The delivery releases when the LAST of its block streams
        closes, exactly like the registered buffer's refcounted
        slices (:399-429).

        Mapped bytes never touch the mempool, so the tenant's quota
        ledger would be blind to them: the group's length is charged
        against the ``pagecache`` broker through the submission plane's
        single charge seam (``tenancy.quota.charge_pagecache``,
        DESIGN.md §24) for exactly the life of the delivery (released
        once — on failure cleanup or when the last stream closes)."""
        mid, group = fetch.manager_id, fetch.group
        release_charge = _tquota.charge_pagecache(
            self._tenant, group.total_length
        )

        fail = self._group_failure(fetch, cleanup=release_charge)

        def on_success(delivery) -> None:
            bad = self._bad_block(group, delivery.views)
            if bad is not None:
                pid, block = group.blocks[bad]
                self._m_checksum_failures.inc()
                delivery.release()
                fail(
                    ChecksumError(
                        self._handle.shuffle_id,
                        pid,
                        f"block of {block.length} bytes from {mid.executor_id}",
                    )
                )
                return
            self._health.record_success(mid.executor_id, tenant=self._tenant)
            remaining = [len(delivery.views)]
            lock = named_lock("fetcher.mapped_release", allow_self_nest=True)

            def release_one() -> None:
                with lock:
                    remaining[0] -= 1
                    last = remaining[0] == 0
                if last:
                    delivery.release()
                    release_charge()

            streams: List[Tuple[int, BinaryIO]] = [
                (pid, MemoryviewInputStream(view, on_close=release_one))
                for (pid, _block), view in zip(group.blocks, delivery.views)
            ]
            self._deliver_group(mid, group, streams, t0)

        channel.read_mapped_in_queue(
            FnListener(on_success, fail),
            [(block.mkey, block.address, block.length)
             for _, block in group.blocks],
        )

    # ------------------------------------------------------------------
    def _put_success(self, streams, in_flight: int) -> None:
        """Enqueue delivered streams — unless the iterator has been
        closed, in which case the delivery's resources (registered
        slices or mapped page-cache windows) are released RIGHT HERE:
        a late arrival must never wait for the garbage collector."""
        with self._lock:
            # the put happens INSIDE the closed-flag lock: a put racing
            # close() must either land before the drain (swept there)
            # or observe _closed and release here — never fall between
            if not self._closed:
                self._results.put(_Success(streams, in_flight=in_flight))
                return
        for _pid, stream in streams:
            try:
                stream.close()
            except Exception:
                logger.exception("closing late-delivered stream failed")

    def close(self) -> None:
        """Release every delivered-but-unconsumed stream: buffered ones
        and results still queued; in-flight deliveries release on
        arrival via `_put_success`. The reference runs the same sweep
        as a task-completion callback
        (RdmaShuffleFetcherIterator.scala:90-106). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._pending.clear()  # never launch new READs for a dead task
        leftovers = list(self._buffered)
        self._buffered.clear()
        while True:
            try:
                r = self._results.get_nowait()
            except queue.Empty:
                break
            if isinstance(r, _Success):
                leftovers.extend(r.streams)
        for _pid, stream in leftovers:
            try:
                stream.close()
            except Exception:
                logger.exception("closing unconsumed stream failed")
        # wake a next() blocked on the results queue (the pipelined
        # reader's fetch thread waits there while ANOTHER thread closes;
        # the serial path always closed from the consuming thread): the
        # dummy makes it re-check has_next, now False. Posted AFTER the
        # sweep so the sweep can't consume it; if nothing is waiting it
        # sits in the dead queue — later next() calls see has_next
        # False before ever blocking.
        self._results.put(_Dummy())

    def _drain_pending(self) -> None:
        """Start queued fetches now under the in-flight cap (:369-379)."""
        max_in_flight = self._manager.conf.max_bytes_in_flight
        start_now: List[_PendingFetch] = []
        with self._lock:
            while self._pending and self._bytes_in_flight < max_in_flight:
                fetch = self._pending.pop(0)
                self._bytes_in_flight += fetch.group.total_length
                start_now.append(fetch)
        # runs on a completion-callback thread with no scope of its own
        with tenancy.tenant_scope(self._tenant):
            for fetch in start_now:
                self._fetch_blocks(fetch)

    def has_next(self) -> bool:
        if self._buffered:
            return True
        with self._lock:
            # a closed iterator is exhausted: pending fetches were
            # dropped and late deliveries release without enqueueing,
            # so waiting on the result count would hang forever
            if self._closed:
                return False
            return self._processed_results < self._total_results

    def next(self) -> Tuple[int, BinaryIO]:
        while not self._buffered:
            if not self.has_next():
                raise StopIteration
            t0 = time.monotonic()
            result = self._results.get()
            waited_ms = (time.monotonic() - t0) * 1e3
            self.metrics.fetch_wait_ms += waited_ms
            self._m_fetch_wait_ms.inc(waited_ms)
            with self._lock:
                self._processed_results += 1
                self._bytes_in_flight -= result.in_flight
            if isinstance(result, _Failure):
                # the task will abandon this iterator: sweep every
                # already-delivered stream (and drop queued pending
                # fetches — launching fresh READs for a dead task,
                # which the pre-close drain did, is pure waste) before
                # surfacing the error
                self.close()
                err = result.error
                if isinstance(err, (FetchFailedError, MetadataFetchFailedError)):
                    raise err
                raise FetchFailedError(
                    result.manager_id,
                    self._handle.shuffle_id,
                    -1,
                    result.partition_id,
                    str(err),
                )
            # only successful progress starts the next queued fetches
            self._drain_pending()
            if isinstance(result, _Success):
                self._buffered.extend(result.streams)
        return self._buffered.pop(0)

    def __iter__(self):
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()
