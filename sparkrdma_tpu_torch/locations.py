"""Wire types for block/partition locations and manager identity.

A copy of the JAX package's ``locations`` module (the port keeps its own
copies of the jax-free modules it needs): the same fields and the same
fixed-width frames, byte for byte, so a location serialized on either
side resolves on the other.

TPU-native analogue of RdmaPartitionLocation.scala (reference:
/root/reference/src/main/scala/org/apache/spark/shuffle/rdma/
RdmaPartitionLocation.scala:25-147).

A *block location* is the one-sided-read handle triple: in the reference
it is ``(address: Long, length: Int, mKey: Int)`` — a raw virtual address
plus the RDMA memory-region key. Here ``address`` is an offset within a
registered buffer and ``mkey`` is the process-wide registry handle of
that buffer (see sparkrdma_tpu.memory.buffer). The passive peer resolves
``(mkey, address, length)`` without involving its application layer,
exactly like an RDMA NIC resolves ``(rkey, addr, len)``.

Serialization is fixed-width big-endian, mirroring the reference's
DataOutputStream layout so sizes are predictable for RPC segmentation.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from io import BytesIO
from typing import BinaryIO, List

_BLOCK = struct.Struct(">QII")  # address(8) length(4) mkey(4)


@dataclass(frozen=True)
class BlockLocation:
    """(address, length, mkey) — reference RdmaBlockLocation, :25.

    ``checksum``/``checksum_algo`` are the resilience layer's integrity
    tag over the staged bytes (utils/checksum.py), computed at publish
    time. They are NOT part of the legacy 16-byte serialization below —
    they travel in the PublishPartitionLocations frame's trailing
    checksum extension (rpc.py) so legacy parsers
    (examples/foreign_client.c) keep working. algo 0 = no checksum.

    ``device_coords``/``arena_handle``/``arena_offset`` are the device
    fetch plane's HBM-side address of the same bytes: the publisher's
    mesh device id, its HBM-arena slab handle (ops/hbm_arena.py) and
    byte offset within it. Like the checksum tag they ride a trailing
    frame extension (rpc.py), never the legacy 16-byte form. An
    ``arena_handle`` of 0 means no device copy exists (arena handles
    start at 1); the host triple above is always the durable fallback.

    ``merged_cover`` marks a *merged* location (push-based merge plane,
    shuffle/merge.py): the block is one sequential segment holding the
    concatenated payloads of ``merged_cover`` original per-map blocks
    of its partition. 0 = a plain per-map block. Readers choose
    merged-else-original: a merged location substitutes for ALL the
    partition's originals only when ``merged_cover`` equals their
    count, and the originals always remain the durable fallback. Rides
    a trailing frame extension (rpc.py), never the legacy 16-byte form.

    ``block_format`` names the payload encoding of the staged bytes:
    0 = pickle frame stream (the universal default), 1 = every frame
    in the block is fixed-width columnar (shuffle/columnar.py) — the
    collective compiler may admit such blocks into DMA waves and the
    reduce side decodes them as memoryview column slices. Rides the
    trailing format extension (rpc.py), never the legacy 16-byte form:
    legacy frames stay byte-identical when every block is pickle.

    ``replica_of``/``source_map`` are the elastic layer's lineage tag
    (sparkrdma_tpu/elastic/): ``source_map`` names the map task that
    produced the bytes (-1 = unattributed, e.g. chunked-agg finalize
    segments), ``replica_of`` names the executor whose primary copy
    these bytes duplicate ("" = a primary). Replica locations never
    enter fetch replies directly — the driver diverts them into its
    replica registry and promotes them only when the primary's
    executor is lost. Both ride a trailing frame extension (rpc.py),
    never the legacy 16-byte form.
    """

    address: int
    length: int
    mkey: int
    checksum: int = 0
    checksum_algo: int = 0
    device_coords: int = -1
    arena_handle: int = 0
    arena_offset: int = 0
    merged_cover: int = 0
    replica_of: str = ""
    source_map: int = -1
    block_format: int = 0

    SERIALIZED_SIZE = _BLOCK.size

    FORMAT_PICKLE = 0
    FORMAT_COLUMNAR = 1

    @property
    def is_columnar(self) -> bool:
        """True when the staged payload is the columnar block format."""
        return self.block_format == self.FORMAT_COLUMNAR

    @property
    def has_device(self) -> bool:
        """True when a device-resident copy is advertised."""
        return self.arena_handle != 0

    @property
    def is_merged(self) -> bool:
        """True when this is a merged segment (covers >= 1 originals)."""
        return self.merged_cover != 0

    @property
    def is_replica(self) -> bool:
        """True when this duplicates another executor's primary copy."""
        return bool(self.replica_of)

    def write(self, out: BinaryIO) -> None:
        out.write(_BLOCK.pack(self.address, self.length, self.mkey))

    @classmethod
    def read(cls, inp: BinaryIO) -> "BlockLocation":
        addr, length, mkey = _BLOCK.unpack(inp.read(_BLOCK.size))
        return cls(addr, length, mkey)


def _write_str(out: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    out.write(struct.pack(">H", len(b)))
    out.write(b)


def _read_str(inp: BinaryIO) -> str:
    (n,) = struct.unpack(">H", inp.read(2))
    return inp.read(n).decode("utf-8")


@dataclass(frozen=True)
class ShuffleManagerId:
    """Identity of one shuffle endpoint (host, port, executor_id).

    Reference RdmaShuffleManagerId(host, port, blockManagerId), :61-147.
    Equality/hash are on ``executor_id`` alone, mirroring the reference's
    equality on blockManagerId (:128-137) so a restarted endpoint with a
    new port replaces rather than duplicates its registry entries.
    """

    host: str
    port: int
    executor_id: str

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ShuffleManagerId)
            and self.executor_id == other.executor_id
        )

    def __hash__(self) -> int:
        return hash(self.executor_id)

    def serialized_size(self) -> int:
        return 2 + len(self.host.encode()) + 4 + 2 + len(self.executor_id.encode())

    def write(self, out: BinaryIO) -> None:
        _write_str(out, self.host)
        out.write(struct.pack(">I", self.port))
        _write_str(out, self.executor_id)

    @classmethod
    def read(cls, inp: BinaryIO) -> "ShuffleManagerId":
        host = _read_str(inp)
        (port,) = struct.unpack(">I", inp.read(4))
        executor_id = _read_str(inp)
        return cls(host, port, executor_id)

    def to_bytes(self) -> bytes:
        buf = BytesIO()
        self.write(buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ShuffleManagerId":
        return cls.read(BytesIO(data))


@dataclass(frozen=True)
class PartitionLocation:
    """One reducer-visible block of one partition on one endpoint.

    Reference RdmaPartitionLocation(rdmaShuffleManagerId, partitionId,
    rdmaBlockLocation), :27-59.
    """

    manager_id: ShuffleManagerId
    partition_id: int
    block: BlockLocation

    def serialized_size(self) -> int:
        return self.manager_id.serialized_size() + 4 + BlockLocation.SERIALIZED_SIZE

    def write(self, out: BinaryIO) -> None:
        self.manager_id.write(out)
        out.write(struct.pack(">i", self.partition_id))
        self.block.write(out)

    @classmethod
    def read(cls, inp: BinaryIO) -> "PartitionLocation":
        mgr = ShuffleManagerId.read(inp)
        (pid,) = struct.unpack(">i", inp.read(4))
        block = BlockLocation.read(inp)
        return cls(mgr, pid, block)


def write_locations(out: BinaryIO, locs: List[PartitionLocation]) -> None:
    out.write(struct.pack(">I", len(locs)))
    for loc in locs:
        loc.write(out)


def read_locations(inp: BinaryIO) -> List[PartitionLocation]:
    (n,) = struct.unpack(">I", inp.read(4))
    return [PartitionLocation.read(inp) for _ in range(n)]
