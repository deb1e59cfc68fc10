"""Control-plane RPC protocol: 4 message types, segmented framing.

TPU-native analogue of RdmaRpcMsg.scala (reference: RdmaRpcMsg.scala).

Framing (reference :42-64): a message serializes into one or more
*segments*, each at most ``recv_wr_size`` bytes, each prefixed with a
4-byte segment length and 4-byte message type so a receiver with fixed
preposted receive buffers can parse every segment independently. Large
messages (PublishPartitionLocations, AnnounceManagers) are split with a
per-segment ``is_last`` flag; receivers accumulate until the last
segment arrives (reference :91-161).

Message types (reference RdmaRpcMsgType, :30-34):
  - PublishPartitionLocations — writer→driver and driver→reducer pushes
    of ``PartitionLocation`` lists.
  - FetchPartitionLocations — reducer→driver request for one shuffle
    partition range.
  - ManagerHello — executor→driver introduction carrying its identity.
  - AnnounceManagers — driver→all broadcast of full membership.

A copy of the JAX package's ``rpc.py``, its imports rewritten to this
package. The four message types and every trailing extension (0xFFFB to
0xFFFF) frame byte for byte as the JAX package's, so a JAX node and a
port node share one driver.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field, replace
from io import BytesIO
from typing import List

from sparkrdma_tpu_torch.locations import (
    PartitionLocation,
    ShuffleManagerId,
)

SEG_HEADER = struct.Struct(">iI")  # msg_type(4) payload_len(4)


class RpcMsgType(enum.IntEnum):
    PUBLISH_PARTITION_LOCATIONS = 0
    FETCH_PARTITION_LOCATIONS = 1
    MANAGER_HELLO = 2
    ANNOUNCE_MANAGERS = 3


class RpcMsg:
    """Base: a message knows how to cut itself into ≤seg_size segments."""

    msg_type: RpcMsgType

    def to_segments(self, seg_size: int) -> List[bytes]:
        raise NotImplementedError

    @staticmethod
    def frame(msg_type: RpcMsgType, payload: bytes) -> bytes:
        return SEG_HEADER.pack(int(msg_type), len(payload)) + payload

    @staticmethod
    def parse_segment(segment: bytes) -> "RpcMsg":
        """Parse one framed segment into its message object.

        Multi-segment messages come back as partial objects; the caller
        accumulates via ``is_last`` (reference parse loop, :70-88).
        """
        msg_type, payload_len = SEG_HEADER.unpack_from(segment, 0)
        payload = segment[SEG_HEADER.size : SEG_HEADER.size + payload_len]
        t = RpcMsgType(msg_type)
        if t == RpcMsgType.PUBLISH_PARTITION_LOCATIONS:
            return PublishPartitionLocationsMsg.from_payload(payload)
        if t == RpcMsgType.FETCH_PARTITION_LOCATIONS:
            return FetchPartitionLocationsMsg.from_payload(payload)
        if t == RpcMsgType.MANAGER_HELLO:
            return ManagerHelloMsg.from_payload(payload)
        if t == RpcMsgType.ANNOUNCE_MANAGERS:
            return AnnounceManagersMsg.from_payload(payload)
        raise ValueError(f"unknown rpc message type {msg_type}")


@dataclass
class PublishPartitionLocationsMsg(RpcMsg):
    """Segmented list of partition locations for one shuffle.

    Reference :91-161. ``partition_id`` is the *request* partition this
    publish answers (driver→reducer); writers publishing their map output
    to the driver use the sentinel -1 and the driver re-keys each
    location by its own ``partition_id`` (reference quirk documented at
    SURVEY.md §5.1 — preserved deliberately because the driver-side
    re-keying makes it sound).
    """

    msg_type = RpcMsgType.PUBLISH_PARTITION_LOCATIONS

    shuffle_id: int
    partition_id: int  # -1 = writer publish; else the fetched partition
    locations: List[PartitionLocation] = field(default_factory=list)
    is_last: bool = True
    # writer→driver publishes carry how many map outputs this message
    # completes so the driver can act as the map-output tracker and
    # defer fetch replies until the shuffle is complete (the reference
    # relies on Spark's own MapOutputTracker for this barrier; here the
    # control plane owns it). 0 on driver→reducer replies.
    num_map_outputs: int = 0
    # observability: the shuffle's trace id (minted at register_shuffle,
    # obs/trace.py) rides the frame so spans correlate across roles.
    # 0 = unknown (e.g. writer publishes before learning the id). It is
    # appended as a trailing 8-byte extension AFTER the locations so
    # parsers of the original layout (examples/foreign_client.c) skip
    # it: a PartitionLocation is >= 28 bytes, so an 8-byte residue is
    # unambiguously the extension, never a truncated location.
    trace_id: int = 0
    # observability: span id of the sender-side span this message hands
    # off from (obs/trace.py SpanHandle; 0 = none). Carried in the
    # 0xFFFB follows extension so the receiver can add a causal
    # ``follows`` edge — the publish→record and resolve→fetch legs of
    # the cross-role critical path (docs/OBSERVABILITY.md).
    origin_span: int = 0
    # control-plane HA (sparkrdma_tpu_torch/metastore): the metastore
    # generation this publish routed against. Nonzero only on
    # re-adoption sweeps after a driver crash — the receiving hub
    # fences sweeps started under an older takeover. Carried in the
    # 0xFFFA epoch extension; 0 emits no bytes (legacy frames stay
    # byte-identical).
    meta_epoch: int = 0

    # is_last(1) shuffle_id(4) partition_id(4) num_map_outputs(4)
    _HDR = struct.Struct(">Biii")
    _TRACE_EXT = struct.Struct(">Q")
    # ONE header shape for every trailing extension: marker(2) count(4).
    # The parser peeks exactly this many bytes to dispatch, so all
    # extensions MUST share it — encoder and parser both go through
    # _EXT_HDR (the wire-markers analysis pass enforces the pairing).
    _EXT_HDR = struct.Struct(">HI")
    # per-segment checksum extension (resilience layer): written AFTER
    # the locations, BEFORE the trace extension. The marker 0xFFFF is
    # impossible as a ShuffleManagerId host length (a 64 KiB hostname
    # cannot fit a 4 KiB segment), so a parser peeking two bytes
    # distinguishes "next location" from "checksum extension"
    # unambiguously; examples/foreign_client.c's bounds check
    # (``o + hl + 4 + 2 > n``) makes the marker terminate its parse
    # loop safely. Layout: _EXT_HDR, then per location
    # algo(1) crc(4) — algo-tagged so mixed publishers coexist
    # (utils/checksum.py).
    _CK_MARKER = 0xFFFF
    _CK_ITEM = struct.Struct(">BI")
    # per-segment device-location extension (device fetch plane):
    # written AFTER the checksum extension, BEFORE the trace extension.
    # Same marker trick with 0xFFFE — equally impossible as a host
    # length. Layout: _EXT_HDR, then per location
    # device_coords(i4) arena_handle(u4) arena_offset(u8); handle 0 =
    # that location has no device copy (arena handles start at 1).
    _DEV_MARKER = 0xFFFE
    _DEV_ITEM = struct.Struct(">iIQ")
    # per-segment merged-location extension (push-based merge plane,
    # shuffle/merge.py): written AFTER the device extension, BEFORE the
    # trace extension. Same impossible-host-length marker trick with
    # 0xFFFD. Layout: _EXT_HDR, then per location merged_cover(u4);
    # cover 0 = a plain per-map block. Publishes with no merged
    # location emit zero extension bytes — legacy frames stay
    # byte-identical.
    _MRG_MARKER = 0xFFFD
    _MRG_ITEM = struct.Struct(">I")
    # per-segment elastic lineage extension (sparkrdma_tpu_torch/elastic/):
    # written AFTER the merged extension, BEFORE the trace extension.
    # Same impossible-host-length marker trick with 0xFFFC. Layout:
    # _EXT_HDR, then per location source_map(i4) replica_len(u2)
    # followed by replica_len utf-8 bytes naming the executor whose
    # primary copy the block duplicates (0 bytes = a primary block,
    # source_map -1 = unattributed). Publishes with no lineage tag emit
    # zero extension bytes — legacy frames stay byte-identical.
    _ELA_MARKER = 0xFFFC
    _ELA_ITEM = struct.Struct(">iH")
    # message-level follows extension (critical-path attribution):
    # written AFTER the elastic extension, BEFORE the trace extension.
    # Same impossible-host-length marker trick with 0xFFFB. Layout:
    # _EXT_HDR with count 1, then one origin_span(u8) — the sender-side
    # span id this message causally follows. Messages with no origin
    # span emit zero extension bytes — legacy frames stay byte-identical.
    _FLW_MARKER = 0xFFFB
    _FLW_ITEM = struct.Struct(">Q")
    # message-level metastore-epoch extension (control-plane HA,
    # sparkrdma_tpu_torch/metastore): written AFTER the follows extension,
    # BEFORE the trace extension. Same impossible-host-length marker
    # trick with 0xFFFA. Layout: _EXT_HDR with count 1, then one
    # meta_epoch(u8) — the metastore generation a re-adoption publish
    # routed against, so a sweep started under an older takeover is
    # fenced whole at the hub. Messages with epoch 0 emit zero
    # extension bytes — legacy frames stay byte-identical.
    _EPO_MARKER = 0xFFFA
    _EPO_ITEM = struct.Struct(">Q")
    # per-segment block-format extension (columnar block format,
    # shuffle/columnar.py): written AFTER the elastic extension, BEFORE
    # the follows extension. Same impossible-host-length marker trick
    # with 0xFFF9. Layout: _EXT_HDR, then per location block_format(u1);
    # 0 = pickle frame stream (the default). Publishes where every
    # block is pickle emit zero extension bytes — legacy frames stay
    # byte-identical.
    _FMT_MARKER = 0xFFF9
    _FMT_ITEM = struct.Struct(">B")

    def to_segments(self, seg_size: int) -> List[bytes]:
        has_ck = any(loc.block.checksum_algo for loc in self.locations)
        ck_fixed = self._EXT_HDR.size if has_ck else 0
        ck_per_loc = self._CK_ITEM.size if has_ck else 0
        has_dev = any(loc.block.arena_handle for loc in self.locations)
        dev_fixed = self._EXT_HDR.size if has_dev else 0
        dev_per_loc = self._DEV_ITEM.size if has_dev else 0
        has_mrg = any(loc.block.merged_cover for loc in self.locations)
        mrg_fixed = self._EXT_HDR.size if has_mrg else 0
        mrg_per_loc = self._MRG_ITEM.size if has_mrg else 0
        has_ela = any(
            loc.block.replica_of or loc.block.source_map >= 0
            for loc in self.locations
        )
        ela_fixed = self._EXT_HDR.size if has_ela else 0
        has_fmt = any(loc.block.block_format for loc in self.locations)
        fmt_fixed = self._EXT_HDR.size if has_fmt else 0
        fmt_per_loc = self._FMT_ITEM.size if has_fmt else 0
        flw_fixed = (
            self._EXT_HDR.size + self._FLW_ITEM.size if self.origin_span else 0
        )
        epo_fixed = (
            self._EXT_HDR.size + self._EPO_ITEM.size if self.meta_epoch else 0
        )
        budget = (
            seg_size
            - SEG_HEADER.size
            - self._HDR.size
            - self._TRACE_EXT.size
            - ck_fixed
            - dev_fixed
            - mrg_fixed
            - ela_fixed
            - fmt_fixed
            - flw_fixed
            - epo_fixed
        )
        if budget <= 0:
            raise ValueError(f"segment size {seg_size} too small")
        groups: List[List[PartitionLocation]] = [[]]
        used = 0
        for loc in self.locations:
            sz = (
                loc.serialized_size()
                + ck_per_loc + dev_per_loc + mrg_per_loc + fmt_per_loc
            )
            if has_ela:
                # variable per-loc cost: fixed item + the replica id bytes
                sz += self._ELA_ITEM.size + len(loc.block.replica_of.encode())
            if sz > budget:
                raise ValueError(
                    f"partition location ({sz} bytes) exceeds segment budget {budget}"
                )
            if used + sz > budget and groups[-1]:
                groups.append([])
                used = 0
            groups[-1].append(loc)
            used += sz
        segments = []
        for i, group in enumerate(groups):
            is_last = i == len(groups) - 1
            buf = BytesIO()
            buf.write(
                self._HDR.pack(
                    1 if is_last else 0,
                    self.shuffle_id,
                    self.partition_id,
                    self.num_map_outputs,
                )
            )
            for loc in group:
                loc.write(buf)
            if has_ck and group:
                buf.write(self._EXT_HDR.pack(self._CK_MARKER, len(group)))
                for loc in group:
                    buf.write(
                        self._CK_ITEM.pack(
                            loc.block.checksum_algo & 0xFF,
                            loc.block.checksum & 0xFFFFFFFF,
                        )
                    )
            if has_dev and group:
                buf.write(self._EXT_HDR.pack(self._DEV_MARKER, len(group)))
                for loc in group:
                    buf.write(
                        self._DEV_ITEM.pack(
                            loc.block.device_coords,
                            loc.block.arena_handle & 0xFFFFFFFF,
                            loc.block.arena_offset,
                        )
                    )
            if has_mrg and group:
                buf.write(self._EXT_HDR.pack(self._MRG_MARKER, len(group)))
                for loc in group:
                    buf.write(
                        self._MRG_ITEM.pack(loc.block.merged_cover & 0xFFFFFFFF)
                    )
            if has_ela and group:
                buf.write(self._EXT_HDR.pack(self._ELA_MARKER, len(group)))
                for loc in group:
                    rep = loc.block.replica_of.encode("utf-8")
                    buf.write(self._ELA_ITEM.pack(loc.block.source_map, len(rep)))
                    buf.write(rep)
            if has_fmt and group:
                buf.write(self._EXT_HDR.pack(self._FMT_MARKER, len(group)))
                for loc in group:
                    buf.write(self._FMT_ITEM.pack(loc.block.block_format & 0xFF))
            if self.origin_span:
                buf.write(self._EXT_HDR.pack(self._FLW_MARKER, 1))
                buf.write(self._FLW_ITEM.pack(self.origin_span))
            if self.meta_epoch:
                buf.write(self._EXT_HDR.pack(self._EPO_MARKER, 1))
                buf.write(self._EPO_ITEM.pack(self.meta_epoch))
            buf.write(self._TRACE_EXT.pack(self.trace_id))
            segments.append(self.frame(self.msg_type, buf.getvalue()))
        return segments

    @classmethod
    def from_payload(cls, payload: bytes) -> "PublishPartitionLocationsMsg":
        inp = BytesIO(payload)
        is_last, shuffle_id, partition_id, num_maps = cls._HDR.unpack(
            inp.read(cls._HDR.size)
        )
        locs = []
        origin_span = 0
        meta_epoch = 0
        end = len(payload)
        # locations are each >= 28 bytes, so a residue of exactly 8 is
        # the trailing trace-id extension (absent from legacy senders);
        # a 0xFFFF two-byte peek is the checksum extension, a 0xFFFE
        # peek the device-location extension, a 0xFFFD peek the merged
        # extension — all sit between the locations and the trace id,
        # in any order
        while end - inp.tell() > cls._TRACE_EXT.size:
            pos = inp.tell()
            peek = inp.read(cls._EXT_HDR.size)
            if len(peek) == cls._EXT_HDR.size:
                marker, count = cls._EXT_HDR.unpack(peek)
                if marker == cls._CK_MARKER:
                    if count == len(locs):
                        for i in range(count):
                            algo, crc = cls._CK_ITEM.unpack(
                                inp.read(cls._CK_ITEM.size)
                            )
                            if algo:
                                locs[i] = replace(
                                    locs[i],
                                    block=replace(
                                        locs[i].block,
                                        checksum=crc,
                                        checksum_algo=algo,
                                    ),
                                )
                    else:
                        # count mismatch (corrupt/foreign ext): skip it
                        inp.read(count * cls._CK_ITEM.size)
                    continue
                if marker == cls._DEV_MARKER:
                    if count == len(locs):
                        for i in range(count):
                            coords, handle, offset = cls._DEV_ITEM.unpack(
                                inp.read(cls._DEV_ITEM.size)
                            )
                            if handle:
                                locs[i] = replace(
                                    locs[i],
                                    block=replace(
                                        locs[i].block,
                                        device_coords=coords,
                                        arena_handle=handle,
                                        arena_offset=offset,
                                    ),
                                )
                    else:
                        inp.read(count * cls._DEV_ITEM.size)
                    continue
                if marker == cls._MRG_MARKER:
                    if count == len(locs):
                        for i in range(count):
                            (cover,) = cls._MRG_ITEM.unpack(
                                inp.read(cls._MRG_ITEM.size)
                            )
                            if cover:
                                locs[i] = replace(
                                    locs[i],
                                    block=replace(
                                        locs[i].block, merged_cover=cover
                                    ),
                                )
                    else:
                        inp.read(count * cls._MRG_ITEM.size)
                    continue
                if marker == cls._ELA_MARKER:
                    # items are variable width (fixed header + replica id
                    # bytes), so even the count-mismatch skip must walk
                    # them item by item
                    for i in range(count):
                        source_map, rep_len = cls._ELA_ITEM.unpack(
                            inp.read(cls._ELA_ITEM.size)
                        )
                        rep = inp.read(rep_len).decode("utf-8")
                        if count != len(locs):
                            continue  # corrupt/foreign ext: discard
                        if rep or source_map >= 0:
                            locs[i] = replace(
                                locs[i],
                                block=replace(
                                    locs[i].block,
                                    replica_of=rep,
                                    source_map=source_map,
                                ),
                            )
                    continue
                if marker == cls._FMT_MARKER:
                    if count == len(locs):
                        for i in range(count):
                            (fmt,) = cls._FMT_ITEM.unpack(
                                inp.read(cls._FMT_ITEM.size)
                            )
                            if fmt:
                                locs[i] = replace(
                                    locs[i],
                                    block=replace(
                                        locs[i].block, block_format=fmt
                                    ),
                                )
                    else:
                        inp.read(count * cls._FMT_ITEM.size)
                    continue
                if marker == cls._FLW_MARKER:
                    for _ in range(count):
                        (span,) = cls._FLW_ITEM.unpack(
                            inp.read(cls._FLW_ITEM.size)
                        )
                        if span:
                            origin_span = span
                    continue
                if marker == cls._EPO_MARKER:
                    for _ in range(count):
                        (epoch,) = cls._EPO_ITEM.unpack(
                            inp.read(cls._EPO_ITEM.size)
                        )
                        if epoch:
                            meta_epoch = epoch
                    continue
            inp.seek(pos)
            locs.append(PartitionLocation.read(inp))
        trace_id = 0
        if end - inp.tell() == cls._TRACE_EXT.size:
            (trace_id,) = cls._TRACE_EXT.unpack(inp.read(cls._TRACE_EXT.size))
        return cls(shuffle_id, partition_id, locs, bool(is_last), num_maps,
                   trace_id, origin_span, meta_epoch)


@dataclass
class FetchPartitionLocationsMsg(RpcMsg):
    """Reducer→driver request for locations of partitions [start, end).

    Reference :163-215 fetches a single partitionId per message; the
    range form is a strict superset that collapses the reference's
    per-partition request loop (RdmaShuffleFetcherIterator.scala:220-320)
    into one message per reduce task.
    """

    msg_type = RpcMsgType.FETCH_PARTITION_LOCATIONS

    requester: ShuffleManagerId
    shuffle_id: int
    start_partition: int
    end_partition: int
    # observability: propagated shuffle trace id (0 = unknown). Sent as
    # a trailing 8-byte extension after the legacy 12-byte body; legacy
    # senders (examples/foreign_client.c) omit it and parse as trace 0.
    trace_id: int = 0
    # observability: span id of the reducer-side fetch-request span
    # (0 = none), a second trailing 8-byte extension after trace_id, so
    # the driver's resolve span can causally follow the request. Legacy
    # and trace-only senders omit it and parse as 0.
    origin_span: int = 0

    def to_segments(self, seg_size: int) -> List[bytes]:
        buf = BytesIO()
        self.requester.write(buf)
        buf.write(
            struct.pack(
                ">iiiQQ",
                self.shuffle_id,
                self.start_partition,
                self.end_partition,
                self.trace_id,
                self.origin_span,
            )
        )
        seg = self.frame(self.msg_type, buf.getvalue())
        if len(seg) > seg_size:
            raise ValueError("fetch message exceeds one segment")
        return [seg]

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchPartitionLocationsMsg":
        inp = BytesIO(payload)
        requester = ShuffleManagerId.read(inp)
        rest = inp.read()
        shuffle_id, start, end = struct.unpack_from(">iii", rest, 0)
        trace_id = struct.unpack_from(">Q", rest, 12)[0] if len(rest) >= 20 else 0
        origin = struct.unpack_from(">Q", rest, 20)[0] if len(rest) >= 28 else 0
        return cls(requester, shuffle_id, start, end, trace_id, origin)


@dataclass
class ManagerHelloMsg(RpcMsg):
    """Executor→driver introduction (reference :217-246)."""

    msg_type = RpcMsgType.MANAGER_HELLO

    manager_id: ShuffleManagerId

    def to_segments(self, seg_size: int) -> List[bytes]:
        seg = self.frame(self.msg_type, self.manager_id.to_bytes())
        if len(seg) > seg_size:
            raise ValueError("hello message exceeds one segment")
        return [seg]

    @classmethod
    def from_payload(cls, payload: bytes) -> "ManagerHelloMsg":
        return cls(ShuffleManagerId.from_bytes(payload))


@dataclass
class AnnounceManagersMsg(RpcMsg):
    """Driver→all broadcast of the full membership (reference :248-307)."""

    msg_type = RpcMsgType.ANNOUNCE_MANAGERS

    manager_ids: List[ShuffleManagerId] = field(default_factory=list)
    is_last: bool = True

    def to_segments(self, seg_size: int) -> List[bytes]:
        budget = seg_size - SEG_HEADER.size - 1
        if budget <= 0:
            raise ValueError(f"segment size {seg_size} too small")
        groups: List[List[ShuffleManagerId]] = [[]]
        used = 0
        for mid in self.manager_ids:
            sz = mid.serialized_size()
            if sz > budget:
                raise ValueError(
                    f"manager id ({sz} bytes) exceeds segment budget {budget}"
                )
            if used + sz > budget and groups[-1]:
                groups.append([])
                used = 0
            groups[-1].append(mid)
            used += sz
        segments = []
        for i, group in enumerate(groups):
            is_last = i == len(groups) - 1
            buf = BytesIO()
            buf.write(struct.pack(">B", 1 if is_last else 0))
            for mid in group:
                mid.write(buf)
            segments.append(self.frame(self.msg_type, buf.getvalue()))
        return segments

    @classmethod
    def from_payload(cls, payload: bytes) -> "AnnounceManagersMsg":
        inp = BytesIO(payload)
        (is_last,) = struct.unpack(">B", inp.read(1))
        mids = []
        end = len(payload)
        while inp.tell() < end:
            mids.append(ShuffleManagerId.read(inp))
        return cls(mids, bool(is_last))
