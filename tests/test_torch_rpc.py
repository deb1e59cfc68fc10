"""The port's control-plane frames against the JAX package's: every RPC
message type and every trailing publish extension (0xFFF9 to 0xFFFF),
built from the same seeded fields in both packages, must frame byte for
byte the same, and each package must decode the other's frames. Block
checksums agree on seeded buffers."""

import dataclasses

import numpy as np
import pytest
import torch

from sparkrdma_tpu import locations as jloc
from sparkrdma_tpu import rpc as jrpc
from sparkrdma_tpu.utils import checksum as jck
from sparkrdma_tpu_torch import locations as tloc
from sparkrdma_tpu_torch import rpc as trpc
from sparkrdma_tpu_torch.utils import checksum as tck

torch.set_num_threads(1)

SEG = 4096  # recvWrSize's default


def _mid(mod, rng, k):
    return mod.ShuffleManagerId(
        f"10.0.{k}.{int(rng.integers(1, 255))}", int(rng.integers(1, 65535)),
        f"exec-{k}-{int(rng.integers(0, 1 << 20))}",
    )


def _block(mod, rng, ext):
    """A block with the fields of extension ``ext`` set (or none)."""
    kw = {}
    if ext in ("ck", "all"):
        kw.update(checksum=int(rng.integers(0, 1 << 32)), checksum_algo=2)
    if ext in ("dev", "all"):
        kw.update(device_coords=int(rng.integers(0, 8)),
                  arena_handle=int(rng.integers(1, 1 << 31)),
                  arena_offset=int(rng.integers(0, 1 << 40)))
    if ext in ("merged", "all"):
        kw.update(merged_cover=int(rng.integers(1, 64)))
    if ext in ("replica", "all"):
        kw.update(replica_of=f"exec-{int(rng.integers(0, 9))}",
                  source_map=int(rng.integers(0, 1000)))
    if ext in ("format", "all"):
        kw.update(block_format=1)
    return mod.BlockLocation(
        int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 31)),
        int(rng.integers(1, 1 << 31)), **kw,
    )


def _publish(mod, rpc, seed, ext, n_locs):
    rng = np.random.default_rng(seed)
    locs = [
        mod.PartitionLocation(_mid(mod, rng, k % 3), int(rng.integers(0, 512)),
                              _block(mod, rng, ext))
        for k in range(n_locs)
    ]
    return rpc.PublishPartitionLocationsMsg(
        int(rng.integers(0, 1 << 20)), -1, locs,
        num_map_outputs=int(rng.integers(0, 4)),
        trace_id=int(rng.integers(0, 1 << 63)),
        origin_span=int(rng.integers(0, 1 << 63)) if ext in ("follows", "all") else 0,
        meta_epoch=int(rng.integers(1, 1 << 31)) if ext in ("epoch", "all") else 0,
    )


def _fields(loc):
    return (dataclasses.astuple(loc.manager_id), loc.partition_id,
            dataclasses.astuple(loc.block))


# none, then each extension alone (0xFFFF checksum, 0xFFFE device,
# 0xFFFD merged, 0xFFFC elastic, 0xFFFB follows, 0xFFFA epoch, 0xFFF9
# format), then all at once; 300 locations span several segments
EXTS = ["none", "ck", "dev", "merged", "replica", "follows", "epoch",
        "format", "all"]


@pytest.mark.parametrize("n_locs", [0, 3, 300])
@pytest.mark.parametrize("ext", EXTS)
def test_publish_frames_are_byte_identical(ext, n_locs):
    jm = _publish(jloc, jrpc, 11, ext, n_locs)
    tm = _publish(tloc, trpc, 11, ext, n_locs)
    jseg = jm.to_segments(SEG)
    tseg = tm.to_segments(SEG)
    assert tseg == jseg
    if n_locs == 300:
        assert len(tseg) > 1
    # each package decodes the other's frames to the same message
    back = [trpc.RpcMsg.parse_segment(s) for s in jseg]
    jback = [jrpc.RpcMsg.parse_segment(s) for s in tseg]
    assert all(isinstance(b, trpc.PublishPartitionLocationsMsg) for b in back)
    assert [[_fields(x) for x in b.locations] for b in back] == [
        [_fields(x) for x in b.locations] for b in jback
    ]
    sent = [_fields(x) for x in tm.locations]
    assert [_fields(x) for b in back for x in b.locations] == sent
    assert [
        (b.shuffle_id, b.partition_id, b.is_last, b.num_map_outputs,
         b.trace_id, b.origin_span, b.meta_epoch) for b in back
    ] == [
        (b.shuffle_id, b.partition_id, b.is_last, b.num_map_outputs,
         b.trace_id, b.origin_span, b.meta_epoch) for b in jback
    ]
    assert sum(len(b.locations) for b in back) == n_locs


def _others(mod, rpc, seed):
    """A fetch, a hello and an announce long enough to split."""
    rng = np.random.default_rng(seed)
    req = _mid(mod, rng, 0)
    return [
        rpc.FetchPartitionLocationsMsg(
            req, int(rng.integers(0, 1 << 20)), 3, 11,
            trace_id=int(rng.integers(0, 1 << 63)),
            origin_span=int(rng.integers(0, 1 << 63)),
        ),
        rpc.ManagerHelloMsg(_mid(mod, rng, 1)),
        rpc.AnnounceManagersMsg([_mid(mod, rng, k) for k in range(200)]),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fetch_hello_announce_frames_are_byte_identical(seed):
    jsegs = [m.to_segments(SEG) for m in _others(jloc, jrpc, seed)]
    tsegs = [m.to_segments(SEG) for m in _others(tloc, trpc, seed)]
    assert tsegs == jsegs
    assert len(tsegs[2]) > 1
    for segs in jsegs:
        for seg in segs:
            t = trpc.RpcMsg.parse_segment(seg)
            j = jrpc.RpcMsg.parse_segment(seg)
            assert t.msg_type == j.msg_type
            assert t.to_segments(1 << 30) == j.to_segments(1 << 30)


@pytest.mark.parametrize("n", [0, 1, 4095, 1 << 16, (1 << 20) + 3])
def test_checksums_agree(n):
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert tck.compute(buf) == jck.compute(buf)
    algo, crc = jck.compute(buf)
    assert tck.verify(buf, crc, algo)
    if n:
        flipped = buf.copy()
        flipped[n // 2] ^= 1
        assert not tck.verify(flipped, crc, algo) or algo == tck.ALGO_NONE
    # each algorithm id (0 none, 1 crc32c, 2 crc32) computes the same
    # value in both packages
    assert (tck.ALGO_NONE, tck.ALGO_CRC32C, tck.ALGO_CRC32) == (0, 1, 2)
    for a in (tck.ALGO_NONE, tck.ALGO_CRC32C, tck.ALGO_CRC32):
        assert tck.compute(buf, a) == jck.compute(buf, a)
