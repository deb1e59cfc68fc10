"""Fixed-width columnar block encoding — the zero-copy record plane.

An Arrow-style record-batch layout negotiated per shuffle alongside the
pickle stream format (DESIGN.md §25): a batch of same-arity tuples of
fixed-width numpy scalars serializes into one contiguous typed region
per column, prefixed by a fixed header carrying the dtype codes, row
count, and column offsets. The payload rides the existing block frame
(``serializer.frame_columnar``) UNCOMPRESSED, so on the reduce side

- decode degenerates to header validation + ``np.frombuffer`` view
  construction: every column ALIASES the fetched buffer (registered
  slice, mapped page-cache window, or HBM-pulled slab) — no per-block
  ``bytes()`` materialization anywhere between transport landing and
  consume (the PR 4 ``read_view`` contract extended to the record
  plane), and
- device staging is a raw byte copy — the on-device sorter/planner
  (``models/terasort.py``, ``ops/sort.py``) consume columns straight
  through ``np.frombuffer`` + ``device_put``.

Layout (all integers big-endian, column data little-endian):

    magic(2)=0xA7C1 version(1) flags(1) rows(4) cols(2)
    cols x [dtype_code(1) offset(4) nbytes(4)]
    ...8-aligned column regions...
    tail padding

Offsets are relative to the payload start and 8-aligned. The payload is
padded so ``(4 + len(payload)) % 8 == 0``: framed columnar blocks — and
therefore whole columnar partitions — have lengths divisible by 8, which
is exactly what ``ShuffleScheduleCompiler``'s elem-alignment eligibility
check needs. Ragged pickle partitions fail ``length % itemsize`` for
4/8-byte dtypes and drop to the host passthrough; columnar partitions
ride the DMA waves (ROADMAP item 3's collective-coverage lever).

Magic collision safety inside a mixed frame stream: zlib frames start
0x78; an uncompressed pickle frame starts with a 4-byte record length,
so a 0xA7 first byte would claim a ~2.8 GiB record — blocks flush at
256 KiB. The first payload byte is therefore unambiguous.

Pickle remains the universal fallback: ``encode_batch`` returns ``None``
for any batch this layout cannot carry (non-tuple records, ragged
arity, non-numpy or non-fixed-width values, mixed dtypes per position)
and the writer frames that batch as a pickle stream instead — the two
frame kinds interleave freely within one partition block.

A copy of the JAX package's ``shuffle/columnar.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0xA7C1
MAGIC_BYTES = b"\xa7\xc1"
VERSION = 1

_HDR = struct.Struct(">HBBIH")  # magic, version, flags, rows, cols
_COL = struct.Struct(">BII")  # dtype_code, offset, nbytes

# fixed-width scalar dtypes the layout carries; column data is stored
# little-endian so the wire bytes are host-independent (numpy scalars
# are native-order — identical on every rig this runs on, but the
# explicit tag keeps the format self-describing)
_CODE_TO_DTYPE = {
    1: np.dtype("u1"),
    2: np.dtype("<u2"),
    3: np.dtype("<u4"),
    4: np.dtype("<u8"),
    5: np.dtype("i1"),
    6: np.dtype("<i2"),
    7: np.dtype("<i4"),
    8: np.dtype("<i8"),
    9: np.dtype("<f4"),
    10: np.dtype("<f8"),
    11: np.dtype("?"),
}
# kind/itemsize identifies a dtype independent of byte order
_KIND_TO_CODE = {
    (dt.kind, dt.itemsize): code for code, dt in _CODE_TO_DTYPE.items()
}


def _code_for(dtype: np.dtype) -> Optional[int]:
    return _KIND_TO_CODE.get((dtype.kind, dtype.itemsize))


def _align8(n: int) -> int:
    return (n + 7) & ~7


def is_columnar(buf) -> bool:
    """True when ``buf`` starts with the columnar frame magic."""
    if len(buf) < _HDR.size:
        return False
    view = buf if isinstance(buf, (bytes, bytearray)) else memoryview(buf)
    return bytes(view[:2]) == MAGIC_BYTES


def header_span(buf) -> int:
    """Byte length of the header + column descriptor table (the region
    the ``block:corrupt_header`` fault seam is allowed to flip in)."""
    _magic, _ver, _flags, _rows, ncols = _HDR.unpack_from(
        buf if isinstance(buf, (bytes, bytearray, memoryview)) else memoryview(buf), 0
    )
    return _HDR.size + ncols * _COL.size


# ----------------------------------------------------------------------
# encode
# ----------------------------------------------------------------------
def encode_columns(cols: Sequence[np.ndarray]) -> bytes:
    """Serialize 1-D column arrays (equal lengths) into one payload."""
    if not cols:
        raise ValueError("columnar payload needs at least one column")
    rows = len(cols[0])
    descs: List[Tuple[int, int, int]] = []
    off = _align8(_HDR.size + len(cols) * _COL.size)
    for col in cols:
        if col.ndim != 1 or len(col) != rows:
            raise ValueError("columns must be 1-D and equal-length")
        code = _code_for(col.dtype)
        if code is None:
            raise ValueError(f"dtype {col.dtype} not columnar-encodable")
        descs.append((code, off, col.nbytes))
        off = _align8(off + col.nbytes)
    # +4 keeps the FRAMED length (4-byte prefix + payload) a multiple
    # of 8 — the collective eligibility invariant (module docstring)
    total = off + 4
    out = bytearray(total)
    _HDR.pack_into(out, 0, MAGIC, VERSION, 0, rows, len(cols))
    pos = _HDR.size
    for (code, coff, nbytes), col in zip(descs, cols):
        _COL.pack_into(out, pos, code, coff, nbytes)
        pos += _COL.size
        le = col.astype(col.dtype.newbyteorder("<"), copy=False)
        out[coff : coff + nbytes] = le.tobytes()
    return bytes(out)


def encode_batch(records: Sequence[Tuple]) -> Optional[bytes]:
    """Encode a record batch, or ``None`` when it does not conform.

    Conformance: every record a tuple of the same nonzero arity, every
    value a numpy fixed-width scalar, and each position's dtype uniform
    across the batch. Anything else pickles (the universal fallback).
    """
    if not records:
        return None
    first = records[0]
    if type(first) is not tuple or not first:
        return None
    arity = len(first)
    codes: List[int] = []
    for v in first:
        if not isinstance(v, np.generic):
            return None
        code = _code_for(v.dtype)
        if code is None:
            return None
        codes.append(code)
    for rec in records:
        if type(rec) is not tuple or len(rec) != arity:
            return None
        for v, code in zip(rec, codes):
            if not isinstance(v, np.generic) or _code_for(v.dtype) != code:
                return None
    cols = [
        np.array([rec[j] for rec in records], dtype=_CODE_TO_DTYPE[codes[j]])
        for j in range(arity)
    ]
    return encode_columns(cols)


# ----------------------------------------------------------------------
# decode — views over the landed buffer, never copies
# ----------------------------------------------------------------------
def decode_columns(buf) -> List[np.ndarray]:
    """Header validation + view construction: each returned array
    ALIASES ``buf`` (``np.frombuffer`` at the column offset). Views are
    valid only while the backing buffer (registered slice / mapped
    window / pulled slab) stays open — same lifetime contract as
    ``read_view`` blocks."""
    view = buf if isinstance(buf, memoryview) else memoryview(buf)
    if len(view) < _HDR.size:
        raise ValueError("columnar block shorter than its header")
    magic, version, _flags, rows, ncols = _HDR.unpack_from(view, 0)
    if magic != MAGIC:
        raise ValueError(f"bad columnar magic 0x{magic:04X}")
    if version != VERSION:
        raise ValueError(f"unsupported columnar version {version}")
    if ncols == 0:
        raise ValueError("columnar block with zero columns")
    end = len(view)
    if _HDR.size + ncols * _COL.size > end:
        raise ValueError("columnar descriptor table out of bounds")
    cols: List[np.ndarray] = []
    pos = _HDR.size
    for _ in range(ncols):
        code, off, nbytes = _COL.unpack_from(view, pos)
        pos += _COL.size
        dt = _CODE_TO_DTYPE.get(code)
        if dt is None:
            raise ValueError(f"unknown columnar dtype code {code}")
        if nbytes != rows * dt.itemsize or off + nbytes > end:
            raise ValueError("columnar column extent out of bounds")
        cols.append(np.frombuffer(view, dtype=dt, count=rows, offset=off))
    return cols


def iter_records(buf) -> Iterator[Tuple]:
    """Row iterator over a columnar payload: tuples of numpy scalars,
    byte-identical in value and dtype to the pickle path's records."""
    cols = decode_columns(buf)
    return zip(*cols)
