"""Record serialization + stream compression, applied symmetrically.

The reference delegates both to Spark (serializerManager.wrapStream on
read, the serializer instance inside the sort writer) and applies them
symmetrically on write and read (SURVEY.md §5.1 #8; reflected
wrapStream at RdmaShuffleReader.scala:116-126). Here the same contract:
a :class:`Serializer` turns an iterator of (key, value) records into a
byte stream and back, and an optional zlib compression codec wraps both
sides.

Wire format per record: 4-byte length + pickled (k, v) tuple. A zero
length marks end-of-stream (so concatenated partition segments from
different map outputs can be framed independently and read back to
exhaustion of the underlying stream).

A copy of the JAX package's ``engine/serializer.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import pickle
import struct
import zlib
from typing import BinaryIO, Iterator, Tuple

_LEN = struct.Struct(">I")

# shuffle/columnar.py MAGIC_BYTES, duplicated because the engine layer
# must not import the shuffle package (circular: shuffle.manager imports
# this module). Pinned equal by tests/test_columnar.py.
_COLUMNAR_MAGIC = b"\xa7\xc1"


class Serializer:
    name = "base"

    def dump_stream(self, records: Iterator[Tuple], out: BinaryIO) -> None:
        raise NotImplementedError

    def load_stream(self, inp: BinaryIO) -> Iterator[Tuple]:
        raise NotImplementedError


class PickleSerializer(Serializer):
    name = "pickle"

    def dump_stream(self, records, out: BinaryIO) -> None:
        pack = _LEN.pack
        dumps = pickle.dumps
        for rec in records:
            data = dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
            out.write(pack(len(data)))
            out.write(data)

    def load_stream(self, inp: BinaryIO):
        unpack = _LEN.unpack
        loads = pickle.loads
        read = inp.read
        while True:
            header = read(4)
            if len(header) < 4:
                return
            (n,) = unpack(header)
            if n == 0:
                return
            data = read(n)
            if len(data) < n:
                raise EOFError("truncated record stream")
            yield loads(data)

    def load_buffer(self, buf):
        """Zero-copy ``load_stream`` over an in-memory buffer
        (bytes/bytearray/memoryview): records deserialize straight from
        slices of ``buf`` — no BytesIO wrapper, no per-record ``read``
        copies. ``pickle.loads`` accepts buffer objects, so the only
        materialization is the record tuples themselves."""
        view = buf if isinstance(buf, memoryview) else memoryview(buf)
        unpack_from = _LEN.unpack_from
        loads = pickle.loads
        pos, end = 0, len(view)
        while end - pos >= 4:
            (n,) = unpack_from(view, pos)
            pos += 4
            if n == 0:
                return
            if end - pos < n:
                raise EOFError("truncated record stream")
            yield loads(view[pos : pos + n])
            pos += n


class CompressionCodec:
    """zlib stream codec (Spark's lz4 role). Level 1: shuffle wants speed."""

    def __init__(self, enabled: bool = True, level: int = 1):
        self.enabled = enabled
        self.level = level

    def compress(self, data: bytes) -> bytes:
        if not self.enabled:
            return data
        return zlib.compress(data, self.level)

    def decompress(self, data) -> bytes:
        """Accepts bytes OR a memoryview (zlib reads any buffer): the
        read path hands wire slices straight in without copying. With
        compression off the input passes through unchanged — consumers
        must treat the result as a buffer, not assume ``bytes``."""
        if not self.enabled:
            return data
        return zlib.decompress(data)


def frame_compressed(codec: CompressionCodec, raw: bytes) -> bytes:
    """Compress one block and length-prefix it — THE wire frame format."""
    block = codec.compress(raw)
    return _LEN.pack(len(block)) + block


def frame_columnar(payload: bytes) -> bytes:
    """Length-prefix one columnar payload, UNCOMPRESSED.

    Columnar blocks skip the codec on both sides: compression would
    force a decompress copy on read, destroying the zero-copy column
    views, and the payload's magic (shuffle/columnar.py: 0xA7C1 —
    impossible as a zlib header byte or a sane record length) lets
    ``iter_compressed_blocks`` tell the two frame kinds apart, so
    pickle and columnar frames interleave freely in one block."""
    return _LEN.pack(len(payload)) + payload


class CompressedBlockWriter:
    """Accumulates serialized bytes, emits one compressed block on flush.

    Write side of the symmetric contract: each map task's bytes for one
    partition become one length-prefixed compressed block, so the read
    side can frame blocks from many map outputs concatenated back to
    back.
    """

    def __init__(self, codec: CompressionCodec, sink):
        self._codec = codec
        self._sink = sink  # callable(bytes) → None
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf.extend(data)
        return len(data)

    @property
    def pending(self) -> int:
        """Bytes accumulated since the last flush_block."""
        return len(self._buf)

    def flush_block(self) -> int:
        """Compress and emit the accumulated block; returns emitted size."""
        if not self._buf:
            return 0
        framed = frame_compressed(self._codec, bytes(self._buf))
        self._sink(framed)
        self._buf.clear()
        return len(framed)


def iter_compressed_blocks(inp: BinaryIO, codec: CompressionCodec) -> Iterator[bytes]:
    """Read side: yield decompressed blocks until the stream is exhausted.

    Streams exposing ``read_view`` (MemoryviewInputStream: registered
    slices, mapped page-cache windows) are sliced zero-copy — the
    compressed frame never materializes as a bytes object. Yielded
    blocks derived from such views are only valid until the stream
    closes; consumers decode fully before closing.

    Columnar frames (first payload bytes = the 0xA7C1 magic,
    shuffle/columnar.py) are framed uncompressed and yielded as-is —
    the raw view passes straight through to the column decoder, never
    touching the codec. Callers sniff the magic per yielded block to
    pick the decode path.
    """
    read_block = getattr(inp, "read_view", inp.read)
    magic = _COLUMNAR_MAGIC
    while True:
        header = inp.read(4)
        if len(header) < 4:
            return
        (n,) = _LEN.unpack(header)
        if n == 0:
            return
        block = read_block(n)
        if len(block) < n:
            raise EOFError("truncated compressed block")
        if n > 2 and bytes(block[:2]) == magic:
            yield block
        else:
            yield codec.decompress(block)
