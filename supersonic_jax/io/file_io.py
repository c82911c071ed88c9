"""Binary columnar file format (host-side, native-accelerated).

Reference: cursor/infrastructure/file_io.cc — spill/interchange format:
data is written in chunks of at most 8192 rows (file_io.cc:33); each chunk
stores the row count, then per column the raw fixed-width value bytes, a
byte-per-row is_null vector for nullable columns (:56-75), and
variable-length payloads as lengths-then-concatenated-bytes (:77-101).

This engine keeps the same chunked layout (schema header added, since the
reference exchanges schemas out of band) so tables round-trip through
files.  The reference's writer/reader are C++ row loops; here the hot
paths are numpy block copies plus the native C++ kernels in
supersonic_jax/native (payload gather on write, dictionary encode on
read) — no per-row Python work.  Disk spill is not used for execution
(HBM is the memory budget; SURVEY.md §7.1) — this is the interchange and
test-golden format.
"""
from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from .. import native
from ..batch import Table
from ..dictionary import Dictionary
from ..schema import Attribute, EnumDefinition, TupleSchema
from ..types import DataType, physical_dtype

MAX_CHUNK_ROWS = 8192  # reference: file_io.cc:33
MAGIC = b"SSTP1\n"


def _write_schema(f: BinaryIO, schema: TupleSchema) -> None:
    f.write(struct.pack("<I", len(schema)))
    for a in schema:
        name = a.name.encode()
        f.write(struct.pack("<I", len(name)))
        f.write(name)
        t = a.type.value.encode()
        f.write(struct.pack("<I", len(t)))
        f.write(t)
        f.write(struct.pack("<B", 1 if a.nullable else 0))
        if a.type == DataType.ENUM:
            f.write(struct.pack("<I", len(a.enum.names)))
            for nm in a.enum.names:
                b = nm.encode()
                f.write(struct.pack("<I", len(b)))
                f.write(b)


def _read_schema(f: BinaryIO) -> TupleSchema:
    (n,) = struct.unpack("<I", f.read(4))
    attrs = []
    for _ in range(n):
        (ln,) = struct.unpack("<I", f.read(4))
        name = f.read(ln).decode()
        (lt,) = struct.unpack("<I", f.read(4))
        t = DataType(f.read(lt).decode())
        (nullable,) = struct.unpack("<B", f.read(1))
        enum = None
        if t == DataType.ENUM:
            (ne,) = struct.unpack("<I", f.read(4))
            names = []
            for _ in range(ne):
                (le,) = struct.unpack("<I", f.read(4))
                names.append(f.read(le).decode())
            enum = EnumDefinition(tuple(names))
        attrs.append(Attribute(name, t, bool(nullable), enum))
    return TupleSchema(attrs)


def _dict_blob(d: Dictionary, binary: bool):
    """(blob bytes, int64 offsets[len+1], int64 lengths[len]) of a
    dictionary's payloads."""
    payloads = [v if binary else v.encode() for v in d.values]
    lengths = np.fromiter((len(p) for p in payloads), dtype=np.int64,
                          count=len(payloads)) if payloads else \
        np.zeros(0, dtype=np.int64)
    offsets = np.zeros(len(payloads) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return b"".join(payloads), offsets, lengths


def write_table(f: BinaryIO, table: Table) -> None:
    """Write a Table in the chunked columnar format (no per-row Python
    work: block copies from the device arrays + native payload gather)."""
    f.write(MAGIC)
    _write_schema(f, table.schema)
    n = int(table.num_rows)
    # materialize raw arrays once
    raw_vals: dict[str, np.ndarray] = {}
    raw_valid: dict[str, np.ndarray] = {}
    dict_info: dict[str, tuple] = {}
    for a in table.schema:
        c = table.columns[a.name]
        raw_vals[a.name] = np.asarray(c.values)[:n]
        raw_valid[a.name] = (np.ones(n, dtype=bool) if c.valid is None
                             else np.asarray(c.valid)[:n])
        if a.type in (DataType.STRING, DataType.BINARY):
            dict_info[a.name] = _dict_blob(
                table.dicts[a.name], a.type == DataType.BINARY)
    for start in range(0, max(n, 1), MAX_CHUNK_ROWS):
        count = min(MAX_CHUNK_ROWS, n - start)
        if count <= 0:
            break
        f.write(struct.pack("<I", count))
        for a in table.schema:
            vals = raw_vals[a.name][start:start + count]
            valid = raw_valid[a.name][start:start + count]
            if a.type in (DataType.STRING, DataType.BINARY):
                if a.nullable:
                    f.write((~valid).astype(np.uint8).tobytes())
                blob, offsets, dlens = dict_info[a.name]
                codes = np.clip(vals.astype(np.int64), 0,
                                max(len(dlens) - 1, 0))
                lengths = (dlens[codes] if len(dlens) else
                           np.zeros(count, dtype=np.int64))
                lengths = np.where(valid, lengths, 0)
                f.write(lengths.astype(np.uint32).tobytes())
                total = int(lengths.sum())
                out = native.gather_blob_bytes(
                    blob, offsets, codes.astype(np.int32), valid, total)
                if out is None:  # pure-python fallback
                    parts = []
                    for i in range(count):
                        if valid[i]:
                            c0 = int(codes[i])
                            parts.append(blob[offsets[c0]:offsets[c0 + 1]])
                    out = b"".join(parts)
                f.write(out)
            else:
                if a.nullable:
                    f.write((~valid).astype(np.uint8).tobytes())
                    vals = np.where(valid, vals, np.zeros(1, vals.dtype))
                f.write(np.ascontiguousarray(vals).tobytes())
    f.write(struct.pack("<I", 0xFFFFFFFF))  # end marker


def _decode_strings(blobs: list[bytes], lengths: np.ndarray,
                    valid: np.ndarray, binary: bool):
    """All string payloads of a column -> (codes int32, Dictionary)."""
    blob = b"".join(blobs)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths.astype(np.int64), out=offsets[1:])
    res = native.dict_encode_bytes(blob, offsets, valid)
    if res is not None:
        codes, dict_rows = res
        vals = []
        for r in dict_rows:
            b = blob[offsets[int(r)]:offsets[int(r) + 1]]
            vals.append(b if binary else b.decode())
        return codes, Dictionary(tuple(vals))
    # fallback: python decode + dictionary.encode
    from .. import dictionary as dict_mod

    out = []
    for i in range(len(lengths)):
        if not valid[i]:
            out.append(None)
            continue
        b = blob[offsets[i]:offsets[i + 1]]
        out.append(b if binary else b.decode())
    codes, _, d = dict_mod.encode(out)
    return codes, d


def read_table(f: BinaryIO, capacity: int | None = None) -> Table:
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise IOError("bad file magic")
    schema = _read_schema(f)
    val_chunks: dict[str, list] = {a.name: [] for a in schema}
    valid_chunks: dict[str, list] = {a.name: [] for a in schema}
    len_chunks: dict[str, list] = {a.name: [] for a in schema}
    total = 0
    while True:
        raw = f.read(4)
        if len(raw) < 4:
            break
        (count,) = struct.unpack("<I", raw)
        if count == 0xFFFFFFFF:
            break
        total += count
        for a in schema:
            if a.type in (DataType.STRING, DataType.BINARY):
                is_null = (np.frombuffer(f.read(count), dtype=np.uint8)
                           if a.nullable else np.zeros(count, np.uint8))
                lengths = np.frombuffer(f.read(4 * count), dtype=np.uint32)
                blob = f.read(int(lengths.sum()))
                val_chunks[a.name].append(blob)
                len_chunks[a.name].append(lengths)
                valid_chunks[a.name].append(is_null == 0)
            else:
                dtype = physical_dtype(a.type)
                is_null = (np.frombuffer(f.read(count), dtype=np.uint8)
                           if a.nullable else np.zeros(count, np.uint8))
                vals = np.frombuffer(f.read(dtype.itemsize * count),
                                     dtype=dtype)
                val_chunks[a.name].append(vals)
                valid_chunks[a.name].append(is_null == 0)
    values: dict[str, np.ndarray] = {}
    valids: dict[str, np.ndarray] = {}
    dicts: dict[str, Dictionary] = {}
    for a in schema:
        valid = (np.concatenate(valid_chunks[a.name])
                 if valid_chunks[a.name] else np.zeros(0, dtype=bool))
        if a.type in (DataType.STRING, DataType.BINARY):
            lengths = (np.concatenate(len_chunks[a.name])
                       if len_chunks[a.name] else np.zeros(0, np.uint32))
            codes, d = _decode_strings(
                val_chunks[a.name], lengths, valid,
                a.type == DataType.BINARY)
            values[a.name] = codes
            dicts[a.name] = d
        else:
            values[a.name] = (np.concatenate(val_chunks[a.name])
                              if val_chunks[a.name]
                              else np.zeros(0, physical_dtype(a.type)))
        valids[a.name] = valid
    return Table.from_arrays(schema, values, valids, total, dicts,
                             capacity=capacity)


def iter_chunks(path: str):
    """Stream a file's chunks as small Tables (≤MAX_CHUNK_ROWS rows each)
    without loading the whole file — the reading half of the reference's
    spill-run streaming (FileInputCursor, file_io.cc:319).  Each chunk
    carries its own (per-chunk) string dictionaries."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise IOError("bad file magic")
        schema = _read_schema(f)
        while True:
            raw = f.read(4)
            if len(raw) < 4:
                break
            (count,) = struct.unpack("<I", raw)
            if count == 0xFFFFFFFF:
                break
            values: dict[str, np.ndarray] = {}
            valids: dict[str, np.ndarray] = {}
            dicts: dict[str, Dictionary] = {}
            for a in schema:
                if a.type in (DataType.STRING, DataType.BINARY):
                    is_null = (np.frombuffer(f.read(count), dtype=np.uint8)
                               if a.nullable else np.zeros(count, np.uint8))
                    lengths = np.frombuffer(f.read(4 * count),
                                            dtype=np.uint32)
                    blob = f.read(int(lengths.sum()))
                    codes, d = _decode_strings(
                        [blob], lengths, is_null == 0,
                        a.type == DataType.BINARY)
                    values[a.name] = codes
                    dicts[a.name] = d
                    valids[a.name] = is_null == 0
                else:
                    dtype = physical_dtype(a.type)
                    is_null = (np.frombuffer(f.read(count), dtype=np.uint8)
                               if a.nullable else np.zeros(count, np.uint8))
                    values[a.name] = np.frombuffer(
                        f.read(dtype.itemsize * count), dtype=dtype)
                    valids[a.name] = is_null == 0
            yield Table.from_arrays(schema, values, valids, count, dicts)


# --- Reference-engine wire format (headerless) -----------------------------
#
# The reference's FileSink/FileInput (file_io.cc:194,319) exchange schemas
# out of band: a file is just chunks until EOF, each chunk being
#   uint64 row_count
#   per column:
#     [nullable] row_count bytes of is_null byte-bools (1 = NULL;
#                the byte-bool representation is the compiled-in choice,
#                bit_pointers.h:514-533)
#     fixed-width: row_count * sizeof(type) raw native-endian bytes
#     var-length:  row_count uint64 lengths (0 for NULL/empty), then the
#                  concatenated bytes of all non-null non-empty values
# These readers/writers interoperate with files produced/consumed by the
# actual C++ engine (refbuild/golden_dump.cc) — the transport for the
# bit-exactness golden tests (tests/test_golden.py).

_FIXED_SIZES = {
    DataType.INT32: 4, DataType.UINT32: 4, DataType.FLOAT: 4,
    DataType.DATE: 4, DataType.INT64: 8, DataType.UINT64: 8,
    DataType.DOUBLE: 8, DataType.DATETIME: 8, DataType.BOOL: 1,
    DataType.ENUM: 4,  # int32 value number (tuple_schema.h:42)
}


def read_reference_file(schema: TupleSchema, path: str,
                        capacity: int | None = None) -> Table:
    """Read a file written by the reference engine's FileSink
    (file_io.cc:194) given its out-of-band schema."""
    val_chunks: dict[str, list] = {a.name: [] for a in schema}
    valid_chunks: dict[str, list] = {a.name: [] for a in schema}
    len_chunks: dict[str, list] = {a.name: [] for a in schema}
    total = 0
    with open(path, "rb") as f:
        while True:
            raw = f.read(8)
            if len(raw) < 8:
                break
            (count,) = struct.unpack("<Q", raw)
            total += count
            for a in schema:
                if a.nullable:
                    is_null = np.frombuffer(f.read(count), dtype=np.uint8)
                    valid = is_null == 0
                else:
                    valid = np.ones(count, dtype=bool)
                valid_chunks[a.name].append(valid)
                if a.type in (DataType.STRING, DataType.BINARY):
                    lengths = np.frombuffer(f.read(8 * count),
                                            dtype=np.uint64)
                    blob = f.read(int(lengths.sum()))
                    val_chunks[a.name].append(blob)
                    len_chunks[a.name].append(lengths)
                else:
                    size = _FIXED_SIZES[a.type]
                    dtype = physical_dtype(a.type)
                    data = f.read(size * count)
                    if a.type == DataType.BOOL:
                        vals = np.frombuffer(data, dtype=np.uint8) != 0
                    else:
                        vals = np.frombuffer(data, dtype=dtype)
                    val_chunks[a.name].append(vals)
    values: dict[str, np.ndarray] = {}
    valids: dict[str, np.ndarray] = {}
    dicts: dict[str, Dictionary] = {}
    for a in schema:
        valid = (np.concatenate(valid_chunks[a.name])
                 if valid_chunks[a.name] else np.zeros(0, dtype=bool))
        if a.type in (DataType.STRING, DataType.BINARY):
            lengths = (np.concatenate(len_chunks[a.name])
                       if len_chunks[a.name] else np.zeros(0, np.uint64))
            codes, d = _decode_strings(
                val_chunks[a.name], lengths, valid,
                a.type == DataType.BINARY)
            values[a.name] = codes
            dicts[a.name] = d
        else:
            values[a.name] = (np.concatenate(val_chunks[a.name])
                              if val_chunks[a.name]
                              else np.zeros(0, physical_dtype(a.type)))
        valids[a.name] = valid
    return Table.from_arrays(schema, values, valids, total, dicts,
                             capacity=capacity)


def write_reference_file(table: Table, path: str) -> None:
    """Write a Table in the reference engine's FileSink wire format so the
    C++ FileInputCursor (file_io.cc:319) can read it (schema passed out of
    band, as the reference requires)."""
    n = int(table.num_rows)
    with open(path, "wb") as f:
        for start in range(0, n, MAX_CHUNK_ROWS):
            count = min(MAX_CHUNK_ROWS, n - start)
            f.write(struct.pack("<Q", count))
            for a in table.schema:
                c = table.columns[a.name]
                vals = np.asarray(c.values)[start:start + count]
                valid = (np.ones(count, dtype=bool) if c.valid is None
                         else np.asarray(c.valid)[start:start + count])
                if a.nullable:
                    f.write((~valid).astype(np.uint8).tobytes())
                if a.type in (DataType.STRING, DataType.BINARY):
                    blob, offsets, dlens = _dict_blob(
                        table.dicts[a.name], a.type == DataType.BINARY)
                    codes = np.clip(vals.astype(np.int64), 0,
                                    max(len(dlens) - 1, 0))
                    lengths = (dlens[codes] if len(dlens) else
                               np.zeros(count, dtype=np.int64))
                    lengths = np.where(valid, lengths, 0)
                    f.write(lengths.astype(np.uint64).tobytes())
                    total_b = int(lengths.sum())
                    out = native.gather_blob_bytes(
                        blob, offsets, codes.astype(np.int32), valid,
                        total_b)
                    if out is None:
                        parts = []
                        for i in range(count):
                            if valid[i] and lengths[i]:
                                c0 = int(codes[i])
                                parts.append(blob[offsets[c0]:offsets[c0 + 1]])
                        out = b"".join(parts)
                    f.write(out)
                elif a.type == DataType.BOOL:
                    v = np.where(valid, vals, False)
                    f.write(v.astype(np.uint8).tobytes())
                else:
                    if a.nullable:
                        vals = np.where(valid, vals, np.zeros(1, vals.dtype))
                    f.write(np.ascontiguousarray(vals).tobytes())


def save(path: str, table: Table) -> None:
    with open(path, "wb") as f:
        write_table(f, table)


def load(path: str, capacity: int | None = None) -> Table:
    with open(path, "rb") as f:
        return read_table(f, capacity)
