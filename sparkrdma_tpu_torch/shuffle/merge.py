"""Push-based merge plane: map-side pushes into per-reducer merge buffers.

The reduce side of a shuffle classically pays M×R small random reads.
Magnet (LinkedIn, VLDB 2020) inverted the flow: the *map* side pushes
sealed blocks toward the executor expected to reduce them, where they
accumulate into one sequential *merged segment* per partition — reduce
reads become R sequential ones. This module is that plane for the TPU
framework, kept strictly **best-effort** behind the existing
resolver/locations API (DESIGN.md §18):

- :class:`PushClient` rides the map pipeline (chunked-agg writer,
  writer/chunked_agg.py): every time ``PartitionWriter.sealed_count()``
  advances, the freshly sealed blocks' payloads ship to the partition's
  destination executor — a direct call when the destination's
  :class:`MergeEndpoint` lives in this process (in-process contexts), a
  ``{"kind": "push_blocks"}`` task-protocol request otherwise
  (engine/worker.py). Map finalize pushes the remainder and a *final
  marker* carrying the per-partition block counts.
- :class:`MergeEndpoint` runs on every executor: pushed blocks dedup by
  ``(source, partition, seq)`` and buffer under a byte budget. A
  partition **seals** only under *complete coverage* — final markers
  from sources totalling the shuffle's full map count, and every block
  they enumerate present. The sealed segment (payload concatenation in
  (source, seq) order — frames never span writer blocks, so it is a
  valid frame stream) lands in registered memory, gets a publish-time
  checksum, and registers with the driver as a merged location
  (``BlockLocation.merged_cover`` = originals covered, riding the
  0xFFFD wire extension, rpc.py).
- :func:`plan_reads` is the reduce planner's *merged-else-original*
  rule (fetcher.py / device_io.py): a merged location substitutes for
  ALL the partition's originals only when ``merged_cover`` equals
  their count; the originals stay attached as the fallback, so a
  dropped push, an over-budget buffer, or a corrupted merged segment
  (caught by the ordinary checksum gate) silently degrades to the
  original per-map reads — never duplicated, never lost.

A copy of the JAX package's ``shuffle/merge.py``, its imports
rewritten to this package (the lock-order and model-checker calls go to the
port's ``analysis/lockorder.py`` and ``analysis/modelcheck``).
"""

from __future__ import annotations

import logging
import re
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.analysis.modelcheck import schedule_point
from sparkrdma_tpu_torch.locations import BlockLocation, PartitionLocation
from sparkrdma_tpu_torch.obs import SpanHandle, get_registry
from sparkrdma_tpu_torch.shuffle.writer.blocks import MemoryWriterBlock
from sparkrdma_tpu_torch.testing import faults as _faults
from sparkrdma_tpu_torch.utils import checksum as _checksum

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")


def _natural(executor_id: str):
    """Sort key treating digit runs numerically (exec-10 after exec-2)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", executor_id)]


# ----------------------------------------------------------------------
# process-local endpoint registry (the device_fetch arena-registry idiom):
# in-process clusters push by direct call; keyed by (driver_port,
# executor_id) so two live contexts in one process never cross wires.
# ----------------------------------------------------------------------
_endpoints: Dict[Tuple[int, str], "MergeEndpoint"] = {}
_endpoints_lock = threading.Lock()


def register_endpoint(ep: "MergeEndpoint") -> None:
    with _endpoints_lock:
        _endpoints[ep.key] = ep


def unregister_endpoint(ep: "MergeEndpoint") -> None:
    with _endpoints_lock:
        if _endpoints.get(ep.key) is ep:
            del _endpoints[ep.key]


def endpoint_for(driver_port: int, executor_id: str) -> Optional["MergeEndpoint"]:
    with _endpoints_lock:
        return _endpoints.get((driver_port, executor_id))


# ----------------------------------------------------------------------
# merged-else-original read planning (the reduce side's ONE new rule)
# ----------------------------------------------------------------------
def plan_reads(
    locations: Sequence[PartitionLocation],
) -> Tuple[List[PartitionLocation], Dict[int, List[PartitionLocation]]]:
    """Select, per partition, the merged segment OR the originals.

    Returns ``(selected, fallbacks)``: ``selected`` replaces the input
    for fetch planning; ``fallbacks[pid]`` holds the suppressed
    original locations of every partition whose merged segment was
    chosen (the read path re-issues them if the merged read fails).
    A merged location is chosen only when its ``merged_cover`` equals
    the partition's original-location count — anything else (partial
    coverage, duplicate publish, foreign writer in the mix) keeps the
    originals authoritative and drops the merged candidate.
    """
    originals: Dict[int, List[PartitionLocation]] = {}
    merged: Dict[int, List[PartitionLocation]] = {}
    for loc in locations:
        bucket = merged if loc.block.merged_cover else originals
        bucket.setdefault(loc.partition_id, []).append(loc)
    if not merged:
        return list(locations), {}
    selected: List[PartitionLocation] = []
    fallbacks: Dict[int, List[PartitionLocation]] = {}
    for pid in sorted(set(originals) | set(merged)):
        origs = originals.get(pid, [])
        chosen = next(
            (
                m
                for m in merged.get(pid, ())
                if origs and m.block.merged_cover == len(origs)
            ),
            None,
        )
        if chosen is not None:
            selected.append(chosen)
            fallbacks[pid] = origs
        else:
            selected.extend(origs)
    return selected, fallbacks


class _ShuffleMergeState:
    """One shuffle's accumulation on one endpoint."""

    __slots__ = ("blocks", "markers", "sealed", "abandoned", "push_origins")

    def __init__(self):
        # pid -> (source, seq) -> payload bytes
        self.blocks: Dict[int, Dict[Tuple[str, int], bytes]] = {}
        # source -> (counts: pid -> total blocks, committed maps, num_maps)
        self.markers: Dict[str, Tuple[Dict[int, int], int, int]] = {}
        # pid -> registered segment block (None while sealing)
        self.sealed: Dict[int, Optional[MemoryWriterBlock]] = {}
        self.abandoned: Set[int] = set()
        # source -> handle of the map-side push span (obs/trace.py):
        # seal spans causally follow every contributing source's push
        self.push_origins: Dict[str, SpanHandle] = {}


class MergeEndpoint:
    """Per-executor receiver of pushed blocks; seals merged segments."""

    def __init__(self, manager):
        self._manager = manager
        self.key = (manager.conf.driver_port, manager.executor_id)
        self._budget = manager.conf.push_max_buffer_bytes
        self._buffered = 0
        self._shuffles: Dict[int, _ShuffleMergeState] = {}
        # named (PR 12): the endpoint's ingest/seal critical sections are
        # schedule-point seams for the protocol model checker, and the
        # lock-order detector tracks it against manager.state
        self._lock = named_lock("push.endpoint")
        self._stopped = False
        role = manager.executor_id
        reg = get_registry()
        self._m_segments = reg.counter("push.merge_segments", role=role)
        self._m_merged_bytes = reg.counter("push.merged_bytes", role=role)
        self._m_dedup = reg.counter("push.dedup_drops", role=role)
        self._m_budget_drops = reg.counter("push.budget_drops", role=role)

    # -- ingest ---------------------------------------------------------
    def push_blocks(
        self,
        shuffle_id: int,
        source: str,
        blocks: Sequence[Tuple[int, int, bytes]],
        final: Optional[dict] = None,
        origin_span: int = 0,
        origin_trace: int = 0,
    ) -> int:
        """Accept pushed ``(pid, seq, payload)`` blocks from ``source``.

        ``final`` (the source's finalize marker) carries
        ``{"counts": {pid: total}, "committed": n, "num_maps": m}``;
        seal checks run once markers account for every map output.
        ``origin_span``/``origin_trace`` identify the sender's
        ``shuffle.push`` span (the push→merge-seal causal seam,
        obs/trace.py); 0 for legacy or untraced senders. Returns the
        number of newly buffered blocks (dedup/budget drops
        excluded) — purely informational, pushes are fire-and-forget.
        """
        accepted = 0
        schedule_point("proto", "merge.push")
        to_seal: List[Tuple[int, List[Tuple[str, int]], Dict]] = []
        with self._lock:
            if self._stopped:
                return 0
            st = self._shuffles.setdefault(shuffle_id, _ShuffleMergeState())
            if origin_span:
                st.push_origins[source] = SpanHandle(origin_trace, origin_span)
            for pid, seq, payload in blocks or ():
                if self._closed_locked(st, pid):
                    self._m_dedup.inc()
                    continue
                per = st.blocks.setdefault(pid, {})
                if self._dup_locked(per, source, seq):
                    self._m_dedup.inc()
                    continue
                n = len(payload)
                if self._buffered + n > self._budget:
                    # over budget: this partition falls back to its
                    # original locations; free what it buffered so far
                    self._abandon_locked(st, pid)
                    self._m_budget_drops.inc()
                    continue
                per[(source, seq)] = bytes(payload)
                self._buffered += n
                accepted += 1
            if final is not None:
                st.markers[source] = (
                    {int(p): int(n) for p, n in (final.get("counts") or {}).items()},
                    int(final.get("committed", 0)),
                    int(final.get("num_maps", 0)),
                )
            if st.markers:
                to_seal = self._sealable_locked(st)
            origins = list(st.push_origins.values()) if to_seal else []
        for pid, need, payloads in to_seal:
            self._seal(shuffle_id, pid, need, payloads, origins)
        return accepted

    def _closed_locked(self, st: _ShuffleMergeState, pid: int) -> bool:
        """Sealed/abandoned pids accept no further blocks: no buffer
        re-entry after a seal popped the payloads, no ledger churn after
        an abandon freed them. Named predicates (this and
        :meth:`_dup_locked`) so the modelcheck mutation gate can disarm
        exactly one guard at a time."""
        return pid in st.sealed or pid in st.abandoned

    @staticmethod
    def _dup_locked(per: Dict[Tuple[str, int], bytes], source: str, seq: int) -> bool:
        """Redelivery dedup: pushes are fire-and-forget and the task
        protocol may retry, so ``(source, seq)`` must be idempotent."""
        return (source, seq) in per

    def _abandon_locked(self, st: _ShuffleMergeState, pid: int) -> None:
        per = st.blocks.pop(pid, None)
        if per:
            self._buffered -= sum(len(v) for v in per.values())
        st.abandoned.add(pid)

    def _sealable_locked(
        self, st: _ShuffleMergeState
    ) -> List[Tuple[int, List[Tuple[str, int]], Dict]]:
        """Complete-coverage check: a pid seals only when final markers
        account for EVERY map output of the shuffle and every block
        they enumerate for the pid arrived here. Any dropped push or
        divergent routing (sources disagreeing on the destination)
        leaves at least one block missing — no seal, originals win."""
        num_maps = max((nm for (_, _, nm) in st.markers.values()), default=0)
        committed = sum(c for (_, c, _) in st.markers.values())
        if num_maps <= 0 or committed < num_maps:
            return []
        out = []
        all_pids: Set[int] = set()
        for counts, _, _ in st.markers.values():
            all_pids.update(p for p, n in counts.items() if n)
        for pid in sorted(all_pids):
            if pid in st.sealed or pid in st.abandoned:
                continue
            need = [
                (src, seq)
                for src, (counts, _, _) in sorted(st.markers.items())
                for seq in range(counts.get(pid, 0))
            ]
            have = st.blocks.get(pid, {})
            if not need or not all(k in have for k in need):
                continue
            payloads = st.blocks.pop(pid)
            self._buffered -= sum(len(v) for v in payloads.values())
            st.sealed[pid] = None  # sealing placeholder: no late re-entry
            need.sort(key=lambda k: (_natural(k[0]), k[1]))
            out.append((pid, need, payloads))
        return out

    def _seal(
        self,
        shuffle_id: int,
        pid: int,
        need: List[Tuple[str, int]],
        payloads: Dict[Tuple[str, int], bytes],
        origins: Optional[List[SpanHandle]] = None,
    ) -> None:
        """Concatenate coverage into one registered segment + publish."""
        schedule_point("proto", "merge.seal")
        t_seal0 = time.perf_counter()
        manager = self._manager
        total = sum(len(payloads[k]) for k in need)
        admitted = total > 0 and manager.resolver.reserve_inmemory_bytes(total)
        if not admitted:
            with self._lock:
                st = self._shuffles.get(shuffle_id)
                if st is not None:
                    st.sealed.pop(pid, None)
                    st.abandoned.add(pid)
            self._m_budget_drops.inc()
            return
        try:
            manager.start_node_if_missing()
            block = MemoryWriterBlock(manager.node.pd, total)
            block.reserved_bytes = total
            for k in need:
                block.append(payloads[k])
            mkey = block.location().mkey
            view = manager.node.pd.resolve(mkey, 0, total)
            algo, crc = _checksum.compute(view)
            plan = _faults.active()
            if plan is not None:
                # the push:corrupt seam: flip a byte AFTER the checksum
                # tag is computed, so the reduce path's ordinary gate
                # must detect it and fall back to the originals
                plan.on_push("seal", [view], peer=manager.executor_id)
        except Exception:
            logger.exception("sealing merged segment for pid %d failed", pid)
            manager.resolver.release_inmemory_bytes(total)
            with self._lock:
                st = self._shuffles.get(shuffle_id)
                if st is not None:
                    st.sealed.pop(pid, None)
                    st.abandoned.add(pid)
            return
        keep = False
        with self._lock:
            st = self._shuffles.get(shuffle_id)
            if st is not None and not self._stopped:
                st.sealed[pid] = block
                keep = True
        if not keep:
            block.dispose()
            manager.resolver.release_inmemory_bytes(total)
            return
        self._m_segments.inc()
        self._m_merged_bytes.inc(total)
        loc = PartitionLocation(
            manager.local_manager_id,
            pid,
            BlockLocation(
                0,
                total,
                mkey,
                checksum=crc,
                checksum_algo=algo,
                merged_cover=len(need),
            ),
        )
        # the seal span causally follows every contributing source's
        # push span (push→merge-seal seam, obs/trace.py flow events);
        # manager is duck-typed (modelcheck sinks carry no tracer)
        tracer = getattr(manager, "tracer", None)
        if tracer is not None:
            tracer.record(
                "shuffle.merge_seal",
                t_seal0,
                time.perf_counter(),
                shuffle_id=shuffle_id,
                follows=origins,
                pid=pid,
                bytes=total,
                cover=len(need),
            )
        # location-only publish: merged segments never touch the
        # map-output barrier; they only ADD a location class
        manager.publish_partition_locations(shuffle_id, -1, [loc], num_map_outputs=0)

    # -- lifecycle ------------------------------------------------------
    def drop_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            st = self._shuffles.pop(shuffle_id, None)
            if st is None:
                return
            for per in st.blocks.values():
                self._buffered -= sum(len(v) for v in per.values())
            blocks = [b for b in st.sealed.values() if b is not None]
        for b in blocks:
            reserved = getattr(b, "reserved_bytes", 0)
            b.dispose()
            if reserved:
                self._manager.resolver.release_inmemory_bytes(reserved)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            shuffle_ids = list(self._shuffles)
        for sid in shuffle_ids:
            self.drop_shuffle(sid)


class PushClient:
    """Map-side push sender: routes sealed blocks to their reducer's
    executor, in-process (endpoint registry) or over the engine task
    protocol (routes shipped by the driver in ``map_batch``)."""

    def __init__(self, manager):
        self._manager = manager
        self.routes: Dict[str, Tuple[str, int]] = {}
        role = manager.executor_id
        reg = get_registry()
        self._m_pushed_blocks = reg.counter("push.pushed_blocks", role=role)
        self._m_pushed_bytes = reg.counter("push.pushed_bytes", role=role)
        self._m_dropped = reg.counter("push.dropped", role=role)
        self._m_skipped = reg.counter("push.skipped", role=role)
        self._m_errors = reg.counter("push.send_errors", role=role)

    def set_routes(self, routes: Optional[Dict[str, Tuple[str, int]]]) -> None:
        self.routes = {k: tuple(v) for k, v in (routes or {}).items()}

    def _candidates(self) -> List[str]:
        if self.routes:
            ids = set(self.routes) | {self._manager.executor_id}
        else:
            ids = set(self._manager.known_executor_ids())
        return sorted(ids, key=_natural)

    @staticmethod
    def route_for(pid: int, num_partitions: int, candidates: Sequence[str]) -> str:
        """Contiguous-range routing: matches the engine's default
        contiguous reduce assignment so the merged segment usually
        seals on the executor that reads it. Purely a locality
        heuristic — a mismatch still yields ONE sequential (remote)
        merged read."""
        k = len(candidates)
        return candidates[min(k - 1, pid * k // max(1, num_partitions))]

    def push_window(
        self,
        shuffle_id: int,
        blocks: Sequence[Tuple[int, int, bytes]],
        num_partitions: int,
        final: Optional[dict] = None,
    ) -> None:
        """Ship ``(pid, seq, payload)`` blocks toward their reducers;
        a ``final`` marker additionally goes to EVERY candidate so
        endpoints can complete their coverage accounting."""
        cands = self._candidates()
        if not cands:
            if blocks:
                self._m_skipped.inc(len(blocks))
            return
        by_dest: Dict[str, List[Tuple[int, int, bytes]]] = {}
        for item in blocks or ():
            dest = self.route_for(item[0], num_partitions, cands)
            by_dest.setdefault(dest, []).append(item)
        dests = set(by_dest)
        if final is not None:
            dests.update(cands)
        with self._manager.tracer.span(
            "shuffle.push",
            shuffle_id=shuffle_id,
            blocks=len(blocks or ()),
            final=final is not None,
        ) as sp:
            for dest in sorted(dests, key=_natural):
                self._send(
                    dest,
                    {
                        "shuffle_id": shuffle_id,
                        "source": self._manager.executor_id,
                        "blocks": by_dest.get(dest, []),
                        "final": final,
                        # push→merge-seal causal seam (obs/trace.py):
                        # the endpoint's seal span follows this span
                        "origin_span": sp.span_id if sp is not None else 0,
                        "origin_trace": sp.trace_id if sp is not None else 0,
                    },
                )

    def _send(self, dest: str, payload: dict) -> None:
        blocks = payload["blocks"]
        plan = _faults.active()
        if plan is not None and plan.on_push("send", None, peer=dest):
            # injected loss: the message silently never arrives — the
            # destination's coverage stays incomplete, originals win
            self._m_dropped.inc(max(1, len(blocks)))
            return
        ep = endpoint_for(self._manager.conf.driver_port, dest)
        try:
            if ep is not None:
                ep.push_blocks(
                    payload["shuffle_id"],
                    payload["source"],
                    blocks,
                    payload["final"],
                    payload.get("origin_span", 0),
                    payload.get("origin_trace", 0),
                )
            elif dest in self.routes:
                self._send_staged(self.routes[dest], payload)
            else:
                self._m_skipped.inc(max(1, len(blocks)))
                return
        except Exception:
            # best-effort by contract: a failed push is a silent miss
            logger.debug("push to %s failed", dest, exc_info=True)
            self._m_errors.inc()
            return
        if blocks:
            self._m_pushed_blocks.inc(len(blocks))
            self._m_pushed_bytes.inc(sum(len(p) for _, _, p in blocks))

    def _send_staged(self, addr: Tuple[str, int], payload: dict) -> None:
        """Cluster-mode send: block BYTES ride the data plane.

        The payloads are registered in this node's ProtectionDomain and
        only ``(pid, seq, mkey, length)`` descriptors travel the task
        protocol; the receiving worker pulls the bytes with a one-sided
        READ before merging (transport/staging.py). The synchronous
        task reply doubles as the release signal for the
        registrations."""
        from sparkrdma_tpu_torch.transport.staging import stage_payloads

        node = self._manager.node
        blocks = list(payload.get("blocks") or ())
        if node is None or not blocks:
            # no data plane up (or a pure `final` marker): the inline
            # path is already control-plane sized
            self._send_socket(addr, payload)
            return
        data_addr, descs, release = stage_payloads(
            node, [p for _, _, p in blocks]
        )
        try:
            self._send_socket(addr, dict(
                payload,
                blocks=[],
                blocks_rd=[
                    (pid, seq, mkey, length)
                    for (pid, seq, _), (mkey, length) in zip(blocks, descs)
                ],
                data_addr=data_addr,
            ))
        finally:
            release()

    @staticmethod
    def _send_socket(addr: Tuple[str, int], payload: dict) -> None:
        import cloudpickle

        data = cloudpickle.dumps(dict(payload, kind="push_blocks"))
        with socket.create_connection(addr, timeout=10.0) as s:
            s.settimeout(10.0)
            s.sendall(_LEN.pack(len(data)) + data)
            # wait for the reply: the endpoint seals (and SENDS its
            # merged publish) before answering, so a finalize that
            # pushed synchronously precedes the barrier-completing
            # location publish — merged locations beat fetch replies
            hdr = b""
            while len(hdr) < 4:
                chunk = s.recv(4 - len(hdr))
                if not chunk:
                    raise ConnectionError("push peer closed")
                hdr += chunk
            (n,) = _LEN.unpack(hdr)
            got = 0
            while got < n:
                chunk = s.recv(min(1 << 20, n - got))
                if not chunk:
                    raise ConnectionError("push peer closed")
                got += len(chunk)
