"""Map-output replication: best-effort copies on peer executors.

The durability pillar of the elastic layer (docs/DESIGN.md §21). After
a wrapper writer commits a map output, its executor's
:class:`ReplicaClient` ships the non-empty partition payloads to the
next ``tpu.shuffle.elastic.replicas`` peers in ring order — in-process
by direct call (the merge plane's endpoint-registry idiom), across
processes over the engine task protocol (``replicate_blocks``, routed
like pushes). The receiving :class:`ReplicaStore` copies the bytes
into ONE registered segment and publishes the locations with the
lineage tag set (``replica_of`` = source executor, ``source_map`` =
map id, ``num_map_outputs`` = 0): the driver diverts such publishes
into its replica registry, so a replica can never double-serve a
partition while its primary is alive. Everything here is best-effort
by contract — a failed or skipped replication costs durability, never
a write failure.

A copy of the JAX package's ``elastic/replication.py``, its imports
rewritten to this package. The store's lock is the port's
``named_lock("elastic.store")`` (``analysis/lockorder.py``), so the
lock-order detector sees it.
"""

from __future__ import annotations

import logging
import re
import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.locations import BlockLocation, PartitionLocation
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.shuffle.writer.blocks import MemoryWriterBlock

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")


def _natural(executor_id: str):
    """Sort key treating digit runs numerically (exec-10 after exec-2)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", executor_id)]


# ----------------------------------------------------------------------
# process-local store registry (the merge plane's endpoint idiom): in-
# process clusters replicate by direct call; keyed by (driver_port,
# executor_id) so two live contexts in one process never cross wires.
# ----------------------------------------------------------------------
_stores: Dict[Tuple[int, str], "ReplicaStore"] = {}
_stores_lock = threading.Lock()


def register_store(store: "ReplicaStore") -> None:
    with _stores_lock:
        _stores[store.key] = store


def unregister_store(store: "ReplicaStore") -> None:
    with _stores_lock:
        if _stores.get(store.key) is store:
            del _stores[store.key]


def store_for(driver_port: int, executor_id: str) -> Optional["ReplicaStore"]:
    with _stores_lock:
        return _stores.get((driver_port, executor_id))


def local_store_ids(driver_port: int) -> List[str]:
    """Executor ids with an in-process store for this driver port."""
    with _stores_lock:
        return [eid for (port, eid) in _stores if port == driver_port]


def ring_targets(
    self_id: str, candidates: Sequence[str], n: int
) -> List[str]:
    """The ``n`` peers after ``self_id`` in natural ring order."""
    ordered = sorted(set(candidates) | {self_id}, key=_natural)
    i = ordered.index(self_id)
    ring = [p for p in ordered[i + 1 :] + ordered[:i] if p != self_id]
    return ring[: max(0, n)]


class ReplicaStore:
    """Per-executor receiver of replicated map outputs."""

    def __init__(self, manager):
        self._manager = manager
        self.key = (manager.conf.driver_port, manager.executor_id)
        self._lock = named_lock("elastic.store")
        # shuffle_id -> [(registered segment, reserved bytes)]
        self._segments: Dict[int, List[Tuple[MemoryWriterBlock, int]]] = {}
        # shuffle_id -> replica locations published from this store:
        # the re-adoption ladder re-publishes these (lineage tags
        # intact) after a hub wipe, so a pre-crash executor death still
        # promotes instead of recomputing (sparkrdma_tpu_torch/metastore)
        self._published: Dict[int, List[PartitionLocation]] = {}
        self._stopped = False
        reg = get_registry()
        role = manager.executor_id
        self._m_accepts = reg.counter("elastic.replica_accepts", role=role)
        self._m_drops = reg.counter("elastic.replica_drops", role=role)

    def accept(
        self,
        shuffle_id: int,
        source: str,
        map_id: int,
        blocks: Sequence[Tuple[int, bytes]],
    ) -> int:
        """Copy one map's partition payloads into registered memory and
        publish them as replicas of ``source``. Returns the number of
        locations published (0 = dropped: empty, over budget, or the
        store is stopping)."""
        manager = self._manager
        blocks = [(pid, payload) for pid, payload in blocks if len(payload)]
        total = sum(len(p) for _, p in blocks)
        if total == 0:
            return 0
        # replicas ride the same in-memory staging budget as merged
        # segments: durability must not OOM the executor
        if not manager.resolver.reserve_inmemory_bytes(total):
            self._m_drops.inc()
            return 0
        try:
            manager.start_node_if_missing()
            seg = MemoryWriterBlock(manager.node.pd, total)
            offsets: List[Tuple[int, int, int]] = []
            off = 0
            for pid, payload in blocks:
                seg.append(payload)
                offsets.append((pid, off, len(payload)))
                off += len(payload)
            mkey = seg.location().mkey
        except Exception:
            logger.exception("staging replica of %s map %d failed", source, map_id)
            manager.resolver.release_inmemory_bytes(total)
            self._m_drops.inc()
            return 0
        keep = False
        with self._lock:
            if not self._stopped:
                self._segments.setdefault(shuffle_id, []).append((seg, total))
                keep = True
        if not keep:
            seg.dispose()
            manager.resolver.release_inmemory_bytes(total)
            self._m_drops.inc()
            return 0
        locs = [
            PartitionLocation(
                manager.local_manager_id,
                pid,
                BlockLocation(
                    addr,
                    length,
                    mkey,
                    replica_of=source,
                    source_map=map_id,
                ),
            )
            for pid, addr, length in offsets
        ]
        with self._lock:
            if not self._stopped:
                self._published.setdefault(shuffle_id, []).extend(locs)
        manager.publish_partition_locations(shuffle_id, -1, locs, num_map_outputs=0)
        self._m_accepts.inc()
        return len(locs)

    def republish(self, meta_epoch: int = 0) -> int:
        """Re-publish every parked replica location (lineage tags
        intact) toward a wiped hub — the replica half of the
        re-adoption sweep. The segments themselves never moved; only
        the registry forgot them. Returns locations re-published."""
        with self._lock:
            parked = {sid: list(locs) for sid, locs in self._published.items()}
        count = 0
        for shuffle_id, locs in sorted(parked.items()):
            if not locs:
                continue
            self._manager.publish_partition_locations(
                shuffle_id, -1, locs, num_map_outputs=0, meta_epoch=meta_epoch
            )
            count += len(locs)
        return count

    def drop_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            segments = self._segments.pop(shuffle_id, [])
            self._published.pop(shuffle_id, None)
        for seg, reserved in segments:
            seg.dispose()
            self._manager.resolver.release_inmemory_bytes(reserved)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            shuffle_ids = list(self._segments)
        for sid in shuffle_ids:
            self.drop_shuffle(sid)


class ReplicaClient:
    """Map-side replication sender (one per executor manager)."""

    def __init__(self, manager):
        self._manager = manager
        self.routes: Dict[str, Tuple[str, int]] = {}
        reg = get_registry()
        role = manager.executor_id
        self._m_maps = reg.counter("elastic.replicated_maps", role=role)
        self._m_bytes = reg.counter("elastic.replicated_bytes", role=role)
        self._m_errors = reg.counter("elastic.replica_errors", role=role)

    def set_routes(self, routes: Optional[Dict[str, Tuple[str, int]]]) -> None:
        """{executor_id: (host, task_port)} — where replicate_blocks
        requests reach peer task servers (shipped by the driver in
        ``map_batch``, exactly like push routes)."""
        self.routes = {k: tuple(v) for k, v in (routes or {}).items()}

    def _peers(self) -> List[str]:
        # routes (shipped by the cluster driver in map_batch) name the
        # cross-process peers; the process-local store registry names
        # the in-process ones — it is populated at manager construction
        # and therefore complete before the first map commits, unlike
        # announced membership, which races early map tasks
        ids = set(self.routes)
        ids.update(local_store_ids(self._manager.conf.driver_port))
        if not ids:
            ids = set(self._manager.known_executor_ids())
        ids.discard(self._manager.executor_id)
        return sorted(ids, key=_natural)

    def replicate_map(self, shuffle_id: int, map_id: int, mapped_file) -> int:
        """Ship one committed map output to the configured number of
        ring peers. Returns how many peers accepted."""
        n = self._manager.conf.elastic_replicas
        if n <= 0:
            return 0
        targets = ring_targets(self._manager.executor_id, self._peers(), n)
        if not targets:
            return 0
        blocks = [
            (pid, bytes(mapped_file.get_partition_view(pid)))
            for pid in range(mapped_file.partition_count())
            if mapped_file.get_partition_location(pid).length > 0
        ]
        total = sum(len(p) for _, p in blocks)
        if total == 0:
            return 0
        payload = {
            "shuffle_id": shuffle_id,
            "source": self._manager.executor_id,
            "map_id": map_id,
            "blocks": blocks,
        }
        sent = 0
        # cluster mode: replica BYTES ride the data plane. The blocks
        # are registered once in this node's ProtectionDomain and every
        # socket target gets only (pid, mkey, length) descriptors over
        # the task protocol, pulling the bytes with a one-sided READ
        # before accepting (transport/staging.py); the synchronous task
        # replies are the release signal for the registrations
        staged = None
        try:
            for dest in targets:
                store = store_for(self._manager.conf.driver_port, dest)
                try:
                    if store is not None:
                        store.accept(
                            shuffle_id, payload["source"], map_id, blocks
                        )
                    elif dest in self.routes:
                        if staged is None and self._manager.node is not None:
                            from sparkrdma_tpu_torch.transport.staging import (
                                stage_payloads,
                            )

                            data_addr, descs, release = stage_payloads(
                                self._manager.node, [p for _, p in blocks]
                            )
                            staged = (
                                dict(
                                    payload,
                                    blocks=[],
                                    blocks_rd=[
                                        (pid, mkey, length)
                                        for (pid, _), (mkey, length) in zip(
                                            blocks, descs
                                        )
                                    ],
                                    data_addr=data_addr,
                                ),
                                release,
                            )
                        self._send_socket(
                            self.routes[dest],
                            staged[0] if staged is not None else payload,
                        )
                    else:
                        continue
                    sent += 1
                except Exception:
                    # best-effort by contract: a failed replica is a
                    # silent durability miss, never a write failure
                    logger.debug(
                        "replicating to %s failed", dest, exc_info=True
                    )
                    self._m_errors.inc()
        finally:
            if staged is not None:
                staged[1]()
        if sent:
            self._m_maps.inc()
            self._m_bytes.inc(total * sent)
        return sent

    @staticmethod
    def _send_socket(addr: Tuple[str, int], payload: dict) -> None:
        import cloudpickle

        data = cloudpickle.dumps(dict(payload, kind="replicate_blocks"))
        with socket.create_connection(addr, timeout=10.0) as s:
            s.settimeout(10.0)
            s.sendall(_LEN.pack(len(data)) + data)
            # wait for the reply: the store publishes its replica
            # locations before answering, so by the time the map task
            # reports success its replicas are already registered
            hdr = b""
            while len(hdr) < 4:
                chunk = s.recv(4 - len(hdr))
                if not chunk:
                    raise ConnectionError("replica peer closed")
                hdr += chunk
            (nbytes,) = _LEN.unpack(hdr)
            got = 0
            while got < nbytes:
                chunk = s.recv(min(1 << 20, nbytes - got))
                if not chunk:
                    raise ConnectionError("replica peer closed")
                got += len(chunk)
