"""External (disk-spilling) merge sort.

Reference: cursor/core/sort.cc external path — ``BufferingSorter``
(:467) accumulates input into a memory-quota Table, flushes sorted runs
through ``UnbufferedSorter`` (:406) to temp files (``BasicMerger::
AddSorted`` :332-362), and the final ``Merge`` (:366-392) k-way-merges
the run files plus the last in-memory run.

Device redesign: each run sorts *on device* (one multi-operand ``lax.sort``
via ops/sort.sort_table) and spills through the chunked columnar file
format (io/file_io.py); the final merge streams run files chunk-at-a-time
on the host (memory = O(runs x 8192 rows)), using the same key semantics
as the device sort (NULL-first ascending / NULL-last descending,
sort.cc:44-47).  In-engine queries never spill — HBM is the budget
(SURVEY.md §7.1); this is the beyond-memory ingest/ETL path.
"""
from __future__ import annotations

import heapq
import os
import tempfile
from typing import Iterator, Optional, Sequence

import numpy as np

from ..batch import Table
from ..schema import TupleSchema
from ..types import DataType
from ..ops.sort import SortOrder, sort_table
from . import file_io

MERGE_CHUNK_ROWS = file_io.MAX_CHUNK_ROWS


def _host_code_lanes(vals: np.ndarray, valid: Optional[np.ndarray],
                     type_: DataType, asc: bool) -> list[np.ndarray]:
    """Monotone uint64 code lanes for one sort key on host numpy —
    ascending u64 lexicographic order over the lanes == the device sort's
    comparator (ops/keys.py): NULL == NULL, NULL first ascending / last
    descending, -0.0 == +0.0, NaN last in ascending total order."""
    one63 = np.uint64(1 << 63)
    if type_ in (DataType.FLOAT, DataType.DOUBLE):
        f = vals.astype(np.float64, copy=True)
        f[f == 0] = 0.0  # -0.0 -> +0.0
        bits = f.view(np.uint64)
        code = np.where(bits >> np.uint64(63) == 1, ~bits, bits | one63)
    elif type_ == DataType.UINT64:
        code = vals.astype(np.uint64)
    else:  # signed ints, uint32/bool widen, date/datetime, dict/enum codes
        code = vals.astype(np.int64).view(np.uint64) ^ one63
    lanes: list[np.ndarray] = []
    if valid is not None:
        code = np.where(valid, code, np.uint64(0))
        rank = (valid if asc else ~valid).astype(np.uint64)
        lanes.append(rank)
    if not asc:
        code = ~code
    lanes.append(code)
    return lanes


class _Rev:
    """Order-reversing comparison wrapper for DESC keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def _row_key(order: SortOrder, schema: TupleSchema):
    """Host-row sort key matching ops/keys.py semantics: NULL == NULL,
    NULL first ascending / last descending (reference: sort.cc:44-47)."""
    idx = [(schema.names().index(k.name), k.ascending) for k in order.keys]

    def key(row):
        parts = []
        for i, asc in idx:
            v = row[i]
            if asc:
                parts.append((0, 0) if v is None else (1, v))
            else:
                parts.append((1, 0) if v is None else (0, _Rev(v)))
        return tuple(parts)

    return key


def _iter_rows(path: str) -> Iterator[tuple]:
    for chunk in file_io.iter_chunks(path):
        yield from chunk.to_pylist()


class ExternalSorter:
    """Memory-bounded sorter: feed tables/rows, get sorted output back
    (reference: Sorter interface, sort.h:134-173).

    ``memory_limit_rows`` plays the reference's ``buffer_memory_limit``
    (sort.h:89-98): once the buffered input exceeds it, the buffer is
    sorted on device and spilled as a run file under ``temporary_
    directory_prefix``."""

    def __init__(self, schema: TupleSchema, order: SortOrder | Sequence,
                 memory_limit_rows: int = 1 << 20,
                 temporary_directory_prefix: Optional[str] = None):
        self.schema = schema
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        for k in self.order.keys:
            schema.lookup(k.name)
        self.limit = max(int(memory_limit_rows), 1)
        self._tmpdir = tempfile.mkdtemp(prefix="sstp_sort_",
                                        dir=temporary_directory_prefix)
        self._runs: list[str] = []
        self._buffer: list[dict] = []
        self._raw: list[tuple] = []
        self._buffered = 0

    # -- write side (reference: SorterSink / Writer) -----------------------
    def write(self, table: Table) -> None:
        """Feed a Table's live rows.  Raw columnar path: values/validity
        buffer as numpy arrays (no per-row Python boxing — the spill path
        exists for large inputs).  STRING/BINARY columns keep their codes;
        dictionaries merge at flush."""
        n = int(table.num_rows)
        if n == 0:
            return
        piece: dict = {}
        for attr in self.schema:
            c = table.columns[attr.name]
            vals = np.asarray(c.values)[:n]
            valid = (None if c.valid is None
                     else np.asarray(c.valid)[:n].astype(bool))
            piece[attr.name] = (vals, valid)
        self.write_arrays(piece, dict(table.dicts), n)

    def write_arrays(self, cols: dict, dicts: dict, n: int) -> None:
        """Low-level raw feed: ``cols[name] = (values, valid_or_None)``
        numpy arrays of length ``n``; ``dicts`` the dictionary objects for
        any STRING/BINARY columns (codes interpreted against them)."""
        if n == 0:
            return
        self._raw.append((n, cols, dicts))
        self._buffered += n
        if self._buffered >= self.limit:
            self._flush()

    def write_rows(self, data: dict) -> None:
        self._buffer.append({n: list(data[n]) for n in self.schema.names()})
        self._buffered += len(next(iter(data.values()))) if data else 0
        if self._buffered >= self.limit:
            self._flush()

    def _buffer_table(self) -> Optional[Table]:
        if not self._buffered:
            return None
        from .. import dictionary as dict_mod

        tables: list[Table] = []
        if self._raw:
            # merge dictionaries across raw pieces (identical objects --
            # the common case: every piece from one source table -- merge
            # as identity)
            merged_dicts: dict = {}
            remaps: list[dict] = [dict() for _ in self._raw]
            for attr in self.schema:
                if attr.type not in (DataType.STRING, DataType.BINARY):
                    continue
                base = self._raw[0][2][attr.name]
                maps: list = [None]
                for _, _, dicts in self._raw[1:]:
                    d = dicts[attr.name]
                    if d is base and all(m is None for m in maps):
                        maps.append(None)
                        continue
                    base, ra, rb = dict_mod.merge(base, d)
                    ra = np.asarray(ra)
                    maps = [ra if m is None else ra[m] for m in maps]
                    maps.append(np.asarray(rb))
                merged_dicts[attr.name] = base
                for i, m in enumerate(maps):
                    if m is not None:
                        remaps[i][attr.name] = m
            import jax.numpy as jnp

            from ..batch import Column

            total = sum(n for n, _, _ in self._raw)
            cols: dict = {}
            for attr in self.schema:
                vparts, vldparts = [], []
                for i, (n, piece, _) in enumerate(self._raw):
                    v, vld = piece[attr.name]
                    if attr.name in remaps[i]:
                        r = remaps[i][attr.name]
                        v = r[np.clip(v, 0, len(r) - 1)]
                    vparts.append(np.asarray(v))
                    if attr.nullable:
                        vldparts.append(np.ones(n, bool) if vld is None
                                        else vld)
                vals = jnp.asarray(np.concatenate(vparts))
                valid = (jnp.asarray(np.concatenate(vldparts))
                         if attr.nullable else None)
                cols[attr.name] = Column(vals, valid)
            tables.append(Table(self.schema, cols, total, merged_dicts))
        if self._buffer:
            merged = {n: [] for n in self.schema.names()}
            for part in self._buffer:
                for n in merged:
                    merged[n].extend(part[n])
            tables.append(Table.from_data(self.schema, merged))
        if len(tables) == 1:
            return tables[0]
        from ..batch import concat_tables

        return concat_tables(tables)

    def _flush(self) -> None:
        t = self._buffer_table()
        self._buffer, self._raw, self._buffered = [], [], 0
        if t is None:
            return
        sorted_t = sort_table(t, self.order)  # one device lax.sort
        path = os.path.join(self._tmpdir, f"run_{len(self._runs)}.sst")
        file_io.save(path, sorted_t)
        self._runs.append(path)

    # -- read side (reference: Sorter::GetResultCursor) --------------------
    def result_chunks(self) -> Iterator[Table]:
        """Sorted output as a stream of ≤8192-row Tables (k-way heap merge
        of run files + the last in-memory run; reference: sort.cc:366-392
        BoundMergeUnionAll over file cursors)."""
        last = self._buffer_table()
        self._buffer, self._raw, self._buffered = [], [], 0
        if not self._runs:
            if last is not None:
                yield sort_table(last, self.order)
            return
        streams = [_iter_rows(p) for p in self._runs]
        if last is not None:
            streams.append(iter(sort_table(last, self.order).to_pylist()))
        key = _row_key(self.order, self.schema)
        names = self.schema.names()
        buf: list[tuple] = []
        for row in heapq.merge(*streams, key=key):
            buf.append(row)
            if len(buf) >= MERGE_CHUNK_ROWS:
                yield Table.from_data(
                    self.schema, {n: [r[i] for r in buf]
                                  for i, n in enumerate(names)})
                buf = []
        if buf:
            yield Table.from_data(
                self.schema, {n: [r[i] for r in buf]
                              for i, n in enumerate(names)})

    def result(self, capacity: Optional[int] = None) -> Table:
        """Fully-merged single Table (must fit in memory).  Uses the
        native C++ k-way heap merge over monotone row codes when the
        library is built (reference: the final Merge of sort.cc:366-392
        is likewise native); falls back to the streaming python merge."""
        t = self._native_result(capacity)
        if t is not None:
            return t
        chunks = list(self.result_chunks())
        if not chunks:
            return Table.empty(self.schema)
        if len(chunks) == 1:
            return chunks[0]
        # chunks arrive globally sorted; plain order-preserving concat
        names = self.schema.names()
        merged: dict[str, list] = {n: [] for n in names}
        for c in chunks:
            cols = c.to_numpy()
            for n in names:
                merged[n].extend(list(cols[n]))
        return Table.from_data(self.schema, merged, capacity=capacity)

    def _native_result(self, capacity: Optional[int]) -> Optional[Table]:
        from .. import dictionary as dict_mod
        from .. import native

        if not native.available() or not self._runs:
            return None
        last = self._buffer_table()
        self._buffer, self._raw, self._buffered = [], [], 0
        runs = [file_io.load(p) for p in self._runs]
        if last is not None:
            runs.append(sort_table(last, self.order))
        counts = [int(t.num_rows) for t in runs]
        starts = np.zeros(len(runs) + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        total = int(starts[-1])
        if total == 0:
            return Table.empty(self.schema)
        # unify dictionary space per STRING/BINARY column across runs
        # (each run file carries its own dictionary)
        remapped: dict[str, list[np.ndarray]] = {}
        merged_dicts: dict[str, dict_mod.Dictionary] = {}
        for attr in self.schema:
            if attr.type not in (DataType.STRING, DataType.BINARY):
                continue
            per_run = [np.asarray(t.columns[attr.name].values)[:c]
                       for t, c in zip(runs, counts)]
            merged = runs[0].dicts[attr.name]
            remaps: list[Optional[np.ndarray]] = [None]  # None == identity
            for t in runs[1:]:
                merged, r_old, r_new = dict_mod.merge(merged,
                                                      t.dicts[attr.name])
                r_old = np.asarray(r_old)
                remaps = [r_old if r is None else r_old[r] for r in remaps]
                remaps.append(np.asarray(r_new))
            codes = []
            for arr, r in zip(per_run, remaps):
                codes.append(arr if r is None else
                             r[np.clip(arr, 0, len(r) - 1)])
            remapped[attr.name] = codes
            merged_dicts[attr.name] = merged
        # monotone u64 code lanes per sort key (NULL rank + value code;
        # same semantics as ops/keys.py: NULL first asc / last desc)
        lanes: list[np.ndarray] = []
        for k in self.order.keys:
            attr = self.schema.lookup(k.name)
            if attr.name in remapped:
                vals = np.concatenate(remapped[attr.name])
            else:
                vals = np.concatenate(
                    [np.asarray(t.columns[attr.name].values)[:c]
                     for t, c in zip(runs, counts)])
            valid = None
            if attr.nullable:
                valid = np.concatenate(
                    [np.ones(c, bool)
                     if t.columns[attr.name].valid is None
                     else np.asarray(t.columns[attr.name].valid)[:c]
                     for t, c in zip(runs, counts)])
            lanes.extend(_host_code_lanes(vals, valid, attr.type,
                                          k.ascending))
        order = native.kway_merge(np.column_stack(lanes), starts)
        if order is None:
            return None
        values: dict[str, np.ndarray] = {}
        valids: dict[str, Optional[np.ndarray]] = {}
        for attr in self.schema:
            if attr.name in remapped:
                vals = np.concatenate(remapped[attr.name])
            else:
                vals = np.concatenate(
                    [np.asarray(t.columns[attr.name].values)[:c]
                     for t, c in zip(runs, counts)])
            values[attr.name] = vals[order]
            if attr.nullable:
                valid = np.concatenate(
                    [np.ones(c, bool)
                     if t.columns[attr.name].valid is None
                     else np.asarray(t.columns[attr.name].valid)[:c]
                     for t, c in zip(runs, counts)])
                valids[attr.name] = valid[order]
            else:
                valids[attr.name] = None
        return Table.from_arrays(self.schema, values, valids, total,
                                 dicts=merged_dicts, capacity=capacity)

    def close(self) -> None:
        for p in self._runs:
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            os.rmdir(self._tmpdir)
        except OSError:
            pass
        self._runs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def external_sort(tables, order, memory_limit_rows: int = 1 << 20,
                  temporary_directory_prefix: Optional[str] = None) -> Table:
    """One-shot helper: sort an iterable of same-schema Tables under a
    row-count memory bound, spilling runs to disk as needed."""
    tables = list(tables) if not hasattr(tables, "__next__") else tables
    first = None
    sorter = None
    for t in tables:
        if sorter is None:
            first = t
            sorter = ExternalSorter(t.schema, order, memory_limit_rows,
                                    temporary_directory_prefix)
        sorter.write(t)
    if sorter is None:
        raise ValueError("external_sort needs at least one table")
    try:
        return sorter.result()
    finally:
        sorter.close()
