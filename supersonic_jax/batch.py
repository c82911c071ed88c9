"""Columnar device batches: Column and Table.

This is the device-native replacement for the reference's Block/View/Column
trio (reference: base/infrastructure/block.h:55-489).  Design mapping
(SURVEY.md §7.1):

  * ``Column``       = one dense jax value array + optional bool validity
                       mask (the reference's ``is_null`` inverted; byte-bool
                       representation per bit_pointers.h:43-46).
  * ``Table``        = schema + dict of Columns + dynamic ``num_rows``.
                       Plays both roles of Block (owned storage) and View
                       (window): arrays have a *static capacity* (shape[0])
                       and a possibly-traced ``num_rows`` scalar says how
                       many leading rows are live.  Padding rows are
                       meaningless and must be masked via ``row_mask()``.
  * STRING/BINARY    = int32 code columns + host-side order-preserving
                       Dictionary (supersonic_jax/dictionary.py).

Table is a registered pytree: schema, capacity and dictionaries are static
(aux) data; value/validity arrays and num_rows are traced leaves — so whole
query plans jit-compile over Tables.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import dictionary as dict_mod
from .schema import Attribute, SchemaError, TupleSchema
from .types import DataType, physical_dtype


class Column(NamedTuple):
    """One device column: values[capacity] (+ valid[capacity] if nullable)."""

    values: jnp.ndarray
    valid: Optional[jnp.ndarray]  # bool array, None => all rows valid

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    def valid_or_true(self) -> jnp.ndarray:
        if self.valid is None:
            return jnp.ones(self.values.shape[0], dtype=jnp.bool_)
        return self.valid


def _as_dtype(data, dtype) -> np.ndarray:
    arr = np.asarray(data)
    if arr.dtype == object or arr.dtype.kind in "UO":
        raise SchemaError("raw python strings must go through dictionary encoding")
    return arr.astype(dtype, copy=False)


@jax.tree_util.register_pytree_node_class
class Table:
    """Schema-carrying columnar batch (Block+View analogue)."""

    __slots__ = ("schema", "columns", "num_rows", "dicts", "_cap_hint")

    def __init__(self, schema: TupleSchema, columns: dict[str, Column],
                 num_rows, dicts: Optional[dict[str, dict_mod.Dictionary]] = None,
                 cap_hint: Optional[int] = None):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows  # python int or traced int32 scalar
        self.dicts = dicts or {}
        self._cap_hint = cap_hint  # capacity for zero-column tables (Generate)

    # -- pytree protocol ------------------------------------------------------
    def tree_flatten(self):
        names = self.schema.names()
        leaves = tuple(self.columns[n] for n in names) + (self.num_rows,)
        aux = (self.schema, tuple(sorted(self.dicts.items())), self._cap_hint)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        schema, dict_items, cap_hint = aux
        names = schema.names()
        columns = {n: leaves[i] for i, n in enumerate(names)}
        return cls(schema, columns, leaves[len(names)], dict(dict_items), cap_hint)

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_data(schema: TupleSchema, data: dict, capacity: Optional[int] = None,
                  dicts: Optional[dict] = None) -> "Table":
        """Build a Table from host data.

        ``data[name]`` may be a numeric sequence (None entries = NULL) or,
        for STRING/BINARY columns, a sequence of str/bytes/None which gets
        dictionary-encoded (unless pre-encoded codes are passed along with
        an entry in ``dicts``).
        """
        n = None
        for name in schema.names():
            if name not in data:
                raise SchemaError(f"column {name!r} missing from data")
            m = len(data[name])
            if n is None:
                n = m
            elif m != n:
                raise SchemaError("ragged columns")
        n = 0 if n is None else n
        cap = capacity or max(n, 1)
        if cap < n:
            raise SchemaError("capacity < row count")

        columns: dict[str, Column] = {}
        out_dicts: dict[str, dict_mod.Dictionary] = dict(dicts or {})
        for attr in schema:
            raw = data[attr.name]
            dtype = physical_dtype(attr.type)
            if attr.type in (DataType.STRING, DataType.BINARY) and attr.name not in out_dicts:
                codes, valid_np, d = dict_mod.encode(list(raw))
                out_dicts[attr.name] = d
                vals_np = codes
            elif attr.type == DataType.ENUM and any(
                    isinstance(v, str) for v in raw):
                # ENUM given by value names -> codes via the schema's map
                lst = list(raw)
                valid_np = np.array([v is not None for v in lst], dtype=bool)
                vals_np = np.array(
                    [attr.enum.code_of(v) if isinstance(v, str)
                     else (v if v is not None else 0) for v in lst],
                    dtype=dtype)
            else:
                if isinstance(raw, np.ndarray) and raw.dtype != object:
                    vals_np = raw.astype(dtype, copy=False)
                    valid_np = np.ones(n, dtype=bool)
                else:
                    lst = list(raw)
                    valid_np = np.array([v is not None for v in lst], dtype=bool)
                    vals_np = np.array(
                        [v if v is not None else 0 for v in lst], dtype=dtype
                    )
            # pad to capacity
            pad = cap - n
            if pad:
                vals_np = np.concatenate([vals_np, np.zeros(pad, dtype=vals_np.dtype)])
                valid_np = np.concatenate([valid_np, np.zeros(pad, dtype=bool)])
            values = jnp.asarray(vals_np)
            if attr.nullable:
                columns[attr.name] = Column(values, jnp.asarray(valid_np))
            else:
                if not valid_np[:n].all():
                    raise SchemaError(f"NULL in non-nullable column {attr.name!r}")
                columns[attr.name] = Column(values, None)
        return Table(schema, columns, n, out_dicts)

    @staticmethod
    def from_arrays(schema: TupleSchema, values: dict[str, np.ndarray],
                    valids: dict[str, Optional[np.ndarray]], num_rows: int,
                    dicts: Optional[dict] = None,
                    capacity: Optional[int] = None) -> "Table":
        """Build a Table from already-physical host arrays (no per-row
        python work): ``values[name]`` is the physical-dtype value array,
        ``valids[name]`` an optional bool mask.  STRING/BINARY columns must
        be pre-encoded codes with an entry in ``dicts``.  This is the
        native-ingest constructor (fast file reads, C++ encoders)."""
        cap = capacity or max(num_rows, 1)
        if cap < num_rows:
            raise SchemaError("capacity < row count")
        columns: dict[str, Column] = {}
        for attr in schema:
            vals_np = np.ascontiguousarray(
                values[attr.name], dtype=physical_dtype(attr.type))
            valid_np = valids.get(attr.name)
            if vals_np.shape[0] != num_rows:
                raise SchemaError("array length != num_rows")
            pad = cap - num_rows
            if pad:
                vals_np = np.concatenate(
                    [vals_np, np.zeros(pad, dtype=vals_np.dtype)])
            if attr.nullable:
                if valid_np is None:
                    valid_np = np.ones(num_rows, dtype=bool)
                valid_np = np.ascontiguousarray(valid_np, dtype=bool)
                if pad:
                    valid_np = np.concatenate(
                        [valid_np, np.zeros(pad, dtype=bool)])
                columns[attr.name] = Column(jnp.asarray(vals_np),
                                            jnp.asarray(valid_np))
            else:
                if valid_np is not None and not np.asarray(
                        valid_np)[:num_rows].all():
                    raise SchemaError(
                        f"NULL in non-nullable column {attr.name!r}")
                columns[attr.name] = Column(jnp.asarray(vals_np), None)
        return Table(schema, columns, num_rows, dict(dicts or {}))

    @staticmethod
    def empty(schema: TupleSchema, capacity: int = 1) -> "Table":
        cols = {}
        for a in schema:
            vals = jnp.zeros(capacity, dtype=physical_dtype(a.type))
            valid = jnp.zeros(capacity, dtype=jnp.bool_) if a.nullable else None
            cols[a.name] = Column(vals, valid)
        return Table(schema, cols, 0, {})

    # -- inspection -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        names = self.schema.names()
        if not names:
            return self._cap_hint if self._cap_hint is not None else 1
        return self.columns[names[0]].capacity

    def row_mask(self) -> jnp.ndarray:
        """bool[capacity]: True for live rows."""
        # i32 positions (x64 mode would make a bare arange i64)
        return (jnp.arange(self.capacity, dtype=jnp.int32)
                < jnp.asarray(self.num_rows, jnp.int32))

    def column(self, name: str) -> Column:
        return self.columns[name]

    def attribute(self, name: str) -> Attribute:
        return self.schema.lookup(name)

    # -- host materialization (test/debug path) -------------------------------
    def to_numpy(self) -> dict[str, np.ndarray]:
        """Decode live rows to host numpy (object arrays for nullable/str)."""
        n = int(self.num_rows)
        out: dict[str, np.ndarray] = {}
        for attr in self.schema:
            col = self.columns[attr.name]
            vals = np.asarray(col.values)[:n]
            valid = (
                np.ones(n, dtype=bool)
                if col.valid is None
                else np.asarray(col.valid)[:n]
            )
            if attr.type in (DataType.STRING, DataType.BINARY):
                decoded = self.dicts[attr.name].decode(vals)
                decoded[~valid] = None
                out[attr.name] = decoded
            elif attr.type == DataType.ENUM:
                obj = np.empty(n, dtype=object)
                for i in range(n):
                    obj[i] = (attr.enum.name_of(int(vals[i]))
                              if valid[i] else None)
                out[attr.name] = obj
            elif attr.nullable:
                obj = np.empty(n, dtype=object)
                for i in range(n):
                    obj[i] = vals[i].item() if valid[i] else None
                out[attr.name] = obj
            else:
                out[attr.name] = vals
        return out

    def to_pylist(self) -> list[tuple]:
        """Live rows as python tuples (None = NULL) — golden-compare format."""
        cols = self.to_numpy()
        names = self.schema.names()
        n = int(self.num_rows)
        rows = []
        for i in range(n):
            rows.append(tuple(
                (cols[c][i].item() if isinstance(cols[c][i], np.generic) else cols[c][i])
                for c in names
            ))
        return rows

    def __repr__(self) -> str:
        return f"Table({self.schema!r}, num_rows={self.num_rows}, capacity={self.capacity})"


def take_clipped(src: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``src[clip(idx, 0, len(src) - 1)]`` on 1-D arrays: a lookup-table
    gather that clamps out-of-range indices."""
    return jnp.take(src, jnp.clip(idx, 0, src.shape[0] - 1))


def gather_arrays(arrays: Sequence[jnp.ndarray],
                  safe_indices: jnp.ndarray) -> list:
    """Gather rows of several equal-length 1-D arrays at the same indices.

    Same-width arrays are packed into one (cap, k) matrix and gathered
    with a single XLA gather instead of k of them, so each index is
    resolved once.  32-bit arrays (i32/u32/f32) are bitcast to a common
    u32; 64-bit arrays group by exact dtype; bools group as a bool
    matrix.  ``safe_indices`` must already be in-range.
    """
    groups: dict = {}
    for i, a in enumerate(arrays):
        if a.dtype in (jnp.int32, jnp.uint32, jnp.float32):
            groups.setdefault("u32", []).append(i)
        else:
            groups.setdefault(str(a.dtype), []).append(i)
    out: list = [None] * len(arrays)
    for key, idxs in groups.items():
        if len(idxs) == 1:
            out[idxs[0]] = jnp.take(arrays[idxs[0]], safe_indices, axis=0)
            continue
        if key == "u32":
            packed = jnp.stack(
                [jax.lax.bitcast_convert_type(arrays[i], jnp.uint32)
                 for i in idxs], axis=1)
        else:
            packed = jnp.stack([arrays[i] for i in idxs], axis=1)
        g = jnp.take(packed, safe_indices, axis=0)
        for j, i in enumerate(idxs):
            col = g[:, j]
            if key == "u32":
                col = jax.lax.bitcast_convert_type(col, arrays[i].dtype)
            out[i] = col
    return out


def gather_table(table: Table, indices: jnp.ndarray, num_rows,
                 fill_invalid: bool = False) -> Table:
    """Build a new Table by gathering rows of ``table`` at ``indices``.

    This is the device equivalent of the reference's SelectiveViewCopier
    (base/infrastructure/view_copier.h:37): selection vectors become int32
    gather index arrays.  ``indices`` may contain out-of-range sentinels
    when ``fill_invalid`` — those rows come out as NULL (used for LEFT_OUTER
    padding, hash_join.cc:801-806).  All same-width columns (and validity
    masks) move in one packed gather (see gather_arrays).
    """
    cap = indices.shape[0]
    in_cap = table.capacity
    oob = (indices < 0) | (indices >= in_cap)
    safe = jnp.where(oob, 0, indices)
    jobs: list = []
    col_slot: dict[str, int] = {}
    valid_slot: dict[str, int] = {}
    for attr in table.schema:
        col = table.columns[attr.name]
        col_slot[attr.name] = len(jobs)
        jobs.append(col.values)
        if fill_invalid:
            valid_slot[attr.name] = len(jobs)
            jobs.append(col.valid_or_true())
        elif col.valid is not None:
            valid_slot[attr.name] = len(jobs)
            jobs.append(col.valid)
    gathered = gather_arrays(jobs, safe)
    cols: dict[str, Column] = {}
    new_schema_attrs = []
    for attr in table.schema:
        vals = gathered[col_slot[attr.name]]
        valid = None
        nullable = attr.nullable
        if fill_invalid:
            nullable = True
            valid = gathered[valid_slot[attr.name]] & ~oob
        elif attr.name in valid_slot:
            valid = gathered[valid_slot[attr.name]]
        new_schema_attrs.append(Attribute(attr.name, attr.type, nullable, attr.enum))
        cols[attr.name] = Column(vals, valid)
    return Table(TupleSchema(new_schema_attrs), cols, num_rows, dict(table.dicts))


def concat_tables(tables: Sequence[Table]) -> Table:
    """Concatenate same-schema tables (schemas must match; dictionaries are
    merged and codes remapped)."""
    assert tables
    schema = tables[0].schema
    for t in tables[1:]:
        if t.schema.names() != schema.names():
            raise SchemaError("concat over mismatched schemas")
    # merge dictionaries per string column
    dicts: dict[str, dict_mod.Dictionary] = {}
    remaps: list[dict[str, jnp.ndarray]] = [dict() for _ in tables]
    for attr in schema:
        if attr.type in (DataType.STRING, DataType.BINARY):
            merged = tables[0].dicts[attr.name]
            maps = [None] * len(tables)
            maps[0] = np.arange(max(len(merged), 1), dtype=np.int32)
            for i, t in enumerate(tables[1:], start=1):
                merged, ra, rb = dict_mod.merge(merged, t.dicts[attr.name])
                # previous remaps compose through ra
                for j in range(i):
                    maps[j] = ra[maps[j]] if len(maps[j]) else maps[j]
                maps[i] = rb
            dicts[attr.name] = merged
            for j in range(len(tables)):
                remaps[j][attr.name] = jnp.asarray(maps[j])
    cols = {}
    num_rows = sum(t.num_rows for t in tables)
    for attr in schema:
        vals_parts, valid_parts = [], []
        nullable = any(t.schema.lookup(attr.name).nullable for t in tables)
        for i, t in enumerate(tables):
            col = t.columns[attr.name]
            v = col.values
            if attr.name in remaps[i] and len(remaps[i][attr.name]):
                v = jnp.take(remaps[i][attr.name], jnp.clip(v, 0, None), axis=0)
            vals_parts.append(v)
            valid_parts.append(col.valid_or_true() & t.row_mask())
        vals = jnp.concatenate(vals_parts)
        valid = jnp.concatenate(valid_parts) if nullable else None
        cols[attr.name] = Column(vals, valid)
    attrs = [Attribute(a.name, a.type,
                       any(t.schema.lookup(a.name).nullable for t in tables), a.enum)
             for a in schema]
    # Concatenated padding rows sit interleaved between live blocks; compact.
    out = Table(TupleSchema(attrs), cols, num_rows, dicts or dict(tables[0].dicts))
    live = jnp.concatenate([t.row_mask() for t in tables])
    from .ops.filter import compact_by_mask  # local import to avoid cycle
    return compact_by_mask(out, live, out.capacity)
