"""Low-level socket framing for the host transport.

The host path carries two verb types, mirroring the reference's use of
the NIC (SURVEY.md §2.4): two-sided SEND for RPC segments
(IBV_WR_SEND, RdmaChannel.java:395-424) and one-sided READ for data
(IBV_WR_RDMA_READ, RdmaChannel.java:360-393). A READ request names
``(mkey, address, length)`` triples; the passive side answers from its
ProtectionDomain without touching application code.

Frames (all big-endian):
  SEND      = op(1) payload_len(4) payload
  READ_REQ  = op(1) req_id(8) n(4) then n × [mkey(4) addr(8) len(4)]
  READ_RESP = op(1) req_id(8) total_len(8) payload
  READ_ERR  = op(1) req_id(8) msg_len(4) msg
  HELLO     = op(1) port(4) id_len(2) executor_id   (connection preamble)
  GOODBYE   = op(1)                                  (graceful disconnect)

A copy of the JAX package's ``transport/wire.py``, its imports rewritten
to this package.
"""

from __future__ import annotations

import socket
import struct
from typing import List, Tuple

OP_SEND = 1
OP_READ_REQ = 2
OP_READ_RESP = 3
OP_READ_ERR = 4
OP_HELLO = 5
OP_GOODBYE = 6
# READ_REQ2 (native plane): identical layout to READ_REQ, but announces
# the requester can pread the server's backing files directly (same-host
# fast path). A pure-Python server treats it exactly like READ_REQ and
# streams a READ_RESP — never OP_READ_FILE — preserving wire interop.
OP_READ_REQ2 = 9
OP_READ_FILE = 10

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_BLOCK = struct.Struct(">IQI")  # mkey(4) addr(8) len(4)


def read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed connection")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


def read_into(sock: socket.socket, view: memoryview) -> None:
    remaining = len(view)
    pos = 0
    while remaining > 0:
        n = sock.recv_into(view[pos:], remaining)
        if n == 0:
            raise ConnectionError("peer closed connection")
        pos += n
        remaining -= n


def pack_send(payload: bytes) -> bytes:
    return bytes([OP_SEND]) + _U32.pack(len(payload)) + payload


def pack_read_req(req_id: int, blocks: List[Tuple[int, int, int]]) -> bytes:
    parts = [bytes([OP_READ_REQ]), _U64.pack(req_id), _U32.pack(len(blocks))]
    for mkey, addr, length in blocks:
        parts.append(_BLOCK.pack(mkey, addr, length))
    return b"".join(parts)


def unpack_read_req(sock: socket.socket) -> Tuple[int, List[Tuple[int, int, int]]]:
    req_id = _U64.unpack(read_exact(sock, 8))[0]
    n = _U32.unpack(read_exact(sock, 4))[0]
    raw = read_exact(sock, n * _BLOCK.size)
    blocks = [_BLOCK.unpack_from(raw, i * _BLOCK.size) for i in range(n)]
    return req_id, blocks


def pack_read_resp_header(req_id: int, total_len: int) -> bytes:
    return bytes([OP_READ_RESP]) + _U64.pack(req_id) + _U64.pack(total_len)


def pack_read_err(req_id: int, msg: str) -> bytes:
    b = msg.encode("utf-8")
    return bytes([OP_READ_ERR]) + _U64.pack(req_id) + _U32.pack(len(b)) + b


# channel kinds carried in the HELLO preamble (reference channel roles,
# RdmaChannel.java:110-154: RPC vs DATA flavors per peer). The kind
# rides in the otherwise-unused high byte of the 4-byte port field, so
# legacy encoders (which store 0 there) parse as KIND_RPC.
KIND_RPC = 0
KIND_DATA = 1

def kind_of(purpose: str) -> int:
    """Wire kind for a channel purpose; raises on unknown values so a
    typo'd purpose can't silently create an RPC-tagged data channel.

    ``data`` sub-purposes (``data-0``, ``data-1``, ...) all map to
    KIND_DATA: the channel cache keys on the full purpose string, so
    distinct sub-purposes are distinct CONNECTIONS to the same peer —
    the striping lever (reference: rdma_channel_conn_count QP striping,
    RdmaChannel.java:54-56; here bench.py's 1-vs-M A/B pairs)."""
    if purpose == "rpc":
        return KIND_RPC
    if purpose == "data" or purpose.startswith("data-"):
        return KIND_DATA
    raise ValueError(f"unknown channel purpose {purpose!r} (rpc|data[-N])")


def index_of(purpose: str) -> int:
    """Channel index within a (peer, kind): ``data-N`` sub-purposes
    carry N so the acceptor can keep N striped connections from one
    peer alive side by side instead of stale-replacing them. ``rpc``
    and plain ``data`` are index 0 (the legacy encoding, bit-for-bit)."""
    if purpose.startswith("data-"):
        try:
            return int(purpose[5:]) & 0xFF
        except ValueError:
            pass
    return 0


def pack_hello(port: int, executor_id: str, kind: int = KIND_RPC,
               index: int = 0) -> bytes:
    b = executor_id.encode("utf-8")
    word = (kind << 24) | ((index & 0xFF) << 16) | (port & 0xFFFF)
    return bytes([OP_HELLO]) + _U32.pack(word) + struct.pack(">H", len(b)) + b


def split_hello_word(word: int) -> Tuple[int, int, int]:
    """(port, kind, index) from the 4-byte hello word — the single
    definition of its bit layout, shared with the native plane's ACCEPT
    aux. Byte 2 (bits 23-16) is the striping index, 0 from legacy
    encoders which always stored 0 there."""
    return word & 0xFFFF, (word >> 24) & 0xFF, (word >> 16) & 0xFF


def unpack_hello(sock: socket.socket) -> Tuple[int, str, int, int]:
    word = _U32.unpack(read_exact(sock, 4))[0]
    (n,) = struct.unpack(">H", read_exact(sock, 2))
    port, kind, index = split_hello_word(word)
    return port, read_exact(sock, n).decode("utf-8"), kind, index
