"""The port's columnar block format (``shuffle/columnar.py``), its writers
(``shuffle/writer/columnar.py``, ``sort_file.py``) and device consumers
(``ops/sort.py`` ``device_put_columns``, ``MapShardSorter.
sort_columnar_partition``) against the JAX package's on the same numpy
inputs: the same bytes, the same decode errors, the same negotiation.

One deliberate difference, ``device_put_columns``' 64-bit columns: the
port keeps each column's numpy dtype (a uint64 column is
``torch.uint64``), while JAX narrows 64-bit columns to 32 bits unless
``jax.enable_x64`` is on. Under x64 the values are equal."""

import io
import pickle
import struct
import warnings

import jax
import numpy as np
import pytest
import torch

from sparkrdma_tpu.engine.serializer import CompressionCodec as JaxCodec
from sparkrdma_tpu.models.terasort import MapShardSorter as JaxSorter
from sparkrdma_tpu.ops.sort import device_put_columns as jax_put_columns
from sparkrdma_tpu.shuffle import columnar as jcol
from sparkrdma_tpu.shuffle.handle import BaseShuffleHandle as JaxHandle
from sparkrdma_tpu.shuffle.handle import HashPartitioner as JaxPartitioner
from sparkrdma_tpu.shuffle.writer.columnar import ColumnarPartitionWriter as JaxCPW
from sparkrdma_tpu.shuffle.writer.sort_file import write_sorted_file as jax_write_sorted
from sparkrdma_tpu.testing.faults import FaultPlan as JaxFaultPlan
from sparkrdma_tpu_torch.engine import serializer
from sparkrdma_tpu_torch.engine.serializer import (
    CompressionCodec,
    frame_columnar,
    frame_compressed,
    iter_compressed_blocks,
)
from sparkrdma_tpu_torch.locations import BlockLocation
from sparkrdma_tpu_torch.models.terasort import MapShardSorter
from sparkrdma_tpu_torch.ops.sort import device_put_columns
from sparkrdma_tpu_torch.shuffle import columnar
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
from sparkrdma_tpu_torch.shuffle.writer.columnar import ColumnarPartitionWriter
from sparkrdma_tpu_torch.shuffle.writer.sort_file import write_sorted_file
from sparkrdma_tpu_torch.testing.faults import FaultPlan

torch.set_num_threads(1)

CODES = sorted(columnar._CODE_TO_DTYPE)


def _column(dt, rows, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dt)
    if dt == np.bool_:
        return rng.integers(0, 2, rows).astype(dt)
    if dt.kind == "f":
        return rng.standard_normal(rows).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, rows, dtype=dt)


def _np_records(n, num_keys=97):
    return [(np.uint32(i % num_keys), np.int64(i * 3)) for i in range(n)]


# ----------------------------------------------------------------------
# codec: the same bytes for every dtype code
# ----------------------------------------------------------------------
def test_codec_tables_equal_jax():
    assert columnar.MAGIC_BYTES == jcol.MAGIC_BYTES == serializer._COLUMNAR_MAGIC
    assert columnar._CODE_TO_DTYPE == jcol._CODE_TO_DTYPE
    assert (columnar._HDR.format, columnar._COL.format) == (jcol._HDR.format,
                                                            jcol._COL.format)


@pytest.mark.parametrize("code", CODES)
def test_encode_bytes_equal_jax_for_every_dtype_code(code):
    dt = columnar._CODE_TO_DTYPE[code]
    rows = 257  # not a multiple of anything
    cols = [_column(dt, rows, code), _column(np.uint32, rows, 100 + code)]
    payload = columnar.encode_columns(cols)
    assert payload == jcol.encode_columns(cols)
    records = [tuple(c[i] for c in cols) for i in range(rows)]
    batch = columnar.encode_batch(records)
    assert batch == jcol.encode_batch(records) == payload
    assert (4 + len(payload)) % 8 == 0
    decoded = list(columnar.iter_records(payload))
    assert pickle.dumps(decoded) == pickle.dumps(list(jcol.iter_records(payload)))
    assert pickle.dumps(decoded) == pickle.dumps(records)


def test_decode_views_alias_the_buffer():
    keys = np.arange(100, dtype=np.uint32)
    vals = np.arange(100, dtype=np.float64) * 1.5
    frame = bytearray(columnar.encode_columns([keys, vals]))
    view = memoryview(frame)
    cols = columnar.decode_columns(view)
    base = np.frombuffer(view, dtype=np.uint8)
    assert all(np.shares_memory(c, base) for c in cols)
    off = columnar._COL.unpack_from(view, columnar._HDR.size)[1]
    frame[off] = 0x7F
    assert cols[0][0] == 0x7F


def _corrupt(kind):
    frame = bytearray(columnar.encode_columns([np.arange(8, dtype=np.uint32)]))
    if kind == "magic":
        frame[0] ^= 0xFF
    elif kind == "version":
        frame[2] ^= 0xFF
    elif kind == "truncated_header":
        frame = frame[: columnar._HDR.size - 1]
    elif kind == "zero_columns":
        struct.pack_into(">H", frame, 8, 0)
    elif kind == "descriptors_out_of_bounds":
        struct.pack_into(">H", frame, 8, 1000)
    elif kind == "dtype_code":
        frame[columnar._HDR.size] = 99
    elif kind == "extent":
        struct.pack_into(">I", frame, columnar._HDR.size + 1, 1 << 20)
    return bytes(frame)


@pytest.mark.parametrize("kind", ["magic", "version", "truncated_header", "zero_columns",
                                  "descriptors_out_of_bounds", "dtype_code", "extent"])
def test_corrupt_headers_raise_the_same_errors(kind):
    frame = _corrupt(kind)
    with pytest.raises(ValueError) as want:
        jcol.decode_columns(frame)
    with pytest.raises(ValueError) as got:
        columnar.decode_columns(frame)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("batch", [
    [], [(1, 2)], [("k", np.uint32(1))], [[np.uint32(1), np.uint32(1)]],
    [(np.uint32(1), np.uint32(1)), (np.uint32(1),)],
    [(np.uint32(1),), (np.int64(1),)], [(np.str_("x"),)],
    [(np.uint32(1), np.int64(2))],
], ids=["empty", "python_ints", "string_key", "list", "ragged", "mixed",
        "non_fixed", "conforming"])
def test_batch_conformance_equals_jax(batch):
    assert columnar.encode_batch(batch) == jcol.encode_batch(batch)


def test_interleaved_frames_in_one_stream():
    codec = CompressionCodec(enabled=True)
    col_payload = columnar.encode_batch(_np_records(10))
    pkl_raw = b"".join(struct.pack(">I", len(d)) + d
                       for d in (pickle.dumps(("k", i)) for i in range(3)))
    stream = io.BytesIO(frame_columnar(col_payload) + frame_compressed(codec, pkl_raw)
                        + frame_columnar(col_payload))
    blocks = list(iter_compressed_blocks(stream, codec))
    assert [columnar.is_columnar(b) for b in blocks] == [True, False, True]
    assert len(list(columnar.iter_records(blocks[0]))) == 10


# ----------------------------------------------------------------------
# writers: the same frames, the same fallbacks, the same files
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tail", ["none", "python_tuple", "other_dtype"])
def test_columnar_partition_writer_frames_equal_jax(tail):
    records = _np_records(20)
    if tail == "python_tuple":
        records.append(("python", "tuple"))
    elif tail == "other_dtype":
        records.append((np.uint32(5), np.float32(1.5)))
    outs = []
    for cls, codec in ((ColumnarPartitionWriter, CompressionCodec(enabled=True)),
                       (JaxCPW, JaxCodec(enabled=True))):
        out = []
        w = cls(codec, out.append, batch_rows=8)
        for rec in records:
            w.write_record(rec)
        w.flush_batch()
        outs.append((out, w.columnar_frames, w.pickle_fallbacks, w.columnar_bytes,
                     w.all_columnar))
    assert outs[0] == outs[1]
    frames, n_col, n_pkl = outs[0][:3]
    # two full batches of 8, then the tail of 4 (+1): columnar unless poisoned
    assert (n_col, n_pkl) == ((3, 0) if tail == "none" else (2, 1))
    assert n_col + n_pkl == len(frames)


@pytest.mark.parametrize("records, block_format, want_format", [
    ("np", "auto", BlockLocation.FORMAT_COLUMNAR),
    ("np", "columnar", BlockLocation.FORMAT_COLUMNAR),
    ("np", "pickle", BlockLocation.FORMAT_PICKLE),
    ("py", "auto", BlockLocation.FORMAT_PICKLE),
    ("py", "columnar", BlockLocation.FORMAT_PICKLE),
    ("py", "pickle", BlockLocation.FORMAT_PICKLE),
])
def test_write_sorted_file_negotiates_and_writes_as_jax(tmp_path, records, block_format,
                                                       want_format):
    recs = _np_records(1000) if records == "np" else [(f"k{i % 7}", i) for i in range(500)]
    got = write_sorted_file(
        iter(recs), BaseShuffleHandle(shuffle_id=0, num_maps=1,
                                      partitioner=HashPartitioner(3)),
        CompressionCodec(enabled=True), str(tmp_path / "port.tmp"),
        block_format=block_format, batch_rows=64)
    want = jax_write_sorted(
        iter(recs), JaxHandle(shuffle_id=0, num_maps=1, partitioner=JaxPartitioner(3)),
        JaxCodec(enabled=True), str(tmp_path / "jax.tmp"),
        block_format=block_format, batch_rows=64)
    assert tuple(got) == tuple(want)
    assert (tmp_path / "port.tmp").read_bytes() == (tmp_path / "jax.tmp").read_bytes()
    assert got.formats == [want_format] * 3
    if want_format == BlockLocation.FORMAT_COLUMNAR:
        assert all(n % 8 == 0 for n in got.lengths if n)


# ----------------------------------------------------------------------
# device consumers
# ----------------------------------------------------------------------
def _landed(payload):
    """The frame as the fetch path hands it on: a read-only view four
    bytes into a landed stream (behind its length prefix), so the 8-byte
    columns sit off their alignment."""
    return memoryview(frame_columnar(payload))[4:]


@pytest.mark.parametrize("code", CODES)
def test_device_put_columns_cpu_equals_jax(code):
    dt = columnar._CODE_TO_DTYPE[code]
    cols = [_column(np.uint32, 300, 1), _column(dt, 300, code)]
    frame = _landed(columnar.encode_columns(cols))
    assert frame.readonly
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no non-writable-buffer warning
        got = device_put_columns(frame, "cpu")
    assert [t.device.type for t in got] == ["cpu", "cpu"]
    assert [t.dtype for t in got] == [torch.uint32,
                                     getattr(torch, str(dt) if dt != np.bool_ else "bool")]
    for t, c in zip(got, cols):
        np.testing.assert_array_equal(t.numpy(), c)
    with jax.enable_x64(True):
        want = jax_put_columns(frame)
        for t, w in zip(got, want):
            assert t.numpy().tobytes() == np.asarray(w).tobytes()
    if dt.itemsize == 8:
        # without x64 the JAX side narrows what the port keeps whole
        assert np.asarray(jax_put_columns(frame)[1]).dtype.itemsize == 4


def test_device_put_columns_copies_and_defaults_to_cuda():
    keys = np.arange(64, dtype=np.uint32)
    frame = bytearray(columnar.encode_columns([keys]))
    (t,) = device_put_columns(memoryview(frame), "cpu")
    off = columnar._COL.unpack_from(frame, columnar._HDR.size)[1]
    frame[off] = 0x7F
    assert int(t[0]) == 0  # a copy, not a view of the frame
    empty = columnar.encode_columns([np.zeros(0, np.uint64)])
    (e,) = device_put_columns(empty, "cpu")
    assert e.dtype == torch.uint64 and e.numel() == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            device_put_columns(bytes(frame))


def test_sort_columnar_partition_equals_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    frame = columnar.encode_columns([keys, np.arange(2048, dtype=np.int64)])
    edges = np.asarray([1 << 30, 1 << 31, 3 << 30], dtype=np.uint32)
    sorter = MapShardSorter("cpu")
    s, b = sorter.sort_columnar_partition(_landed(frame), edges)
    ws, wb = JaxSorter().sort_columnar_partition(frame, edges)
    assert s.tobytes() == np.asarray(ws).tobytes()
    np.testing.assert_array_equal(b, wb)
    ps, pb = sorter.sort_partition(keys, edges)
    assert s.tobytes() == ps.tobytes() and np.array_equal(b, pb)
    wrong = columnar.encode_columns([keys.astype(np.int64)])
    with pytest.raises(TypeError, match="expected uint32"):
        sorter.sort_columnar_partition(wrong, edges)
    with pytest.raises(TypeError, match="expected uint32"):
        JaxSorter().sort_columnar_partition(wrong, edges)


@pytest.mark.parametrize("seed", [0, 17])
def test_block_corrupt_header_flips_the_same_byte_as_jax(seed):
    framed = frame_columnar(columnar.encode_batch(_np_records(50)))
    got, want = bytearray(framed), bytearray(framed)
    plan, jplan = (FaultPlan.parse("block:corrupt_header:1", seed=seed),
                   JaxFaultPlan.parse("block:corrupt_header:1", seed=seed))
    plan.on_block([memoryview(got)])
    jplan.on_block([memoryview(want)])
    assert got == want != bytearray(framed)
    span = columnar.header_span(memoryview(framed)[4:])
    diff = [i for i in range(len(framed)) if got[i] != framed[i]]
    assert len(diff) == 1 and 4 <= diff[0] < 4 + span
