"""Leaf operations: scan a materialized Table / view-with-selection.

Reference: cursor/infrastructure/view_cursor.h:22-28 (CreateCursorOverView,
CreateCursorOverViewWithSelection), cursor/core/scan_view.h:24-40, and
Table-as-Operation (cursor/infrastructure/table.h:49).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..batch import Table, gather_table
from .base import BindContext, BoundOperation, Operation, RunContext


class ScanTable(Operation):
    """Scan a materialized Table (the leaf of every plan)."""

    def __init__(self, table: Table):
        self.table = table

    def bind(self, ctx: BindContext) -> BoundOperation:
        idx = ctx.register_leaf(self.table)
        schema = self.table.schema
        dicts = dict(self.table.dicts)
        cap = self.table.capacity

        def fn(rctx: RunContext) -> Table:
            return rctx.leaf_tables[idx]

        stats = table_stats(self.table)
        return BoundOperation(schema, dicts, fn, cap, stats=stats,
                              rowid=table_rowid_cols(self.table, stats))


def table_stats(table: Table) -> dict:
    """Planner statistics from a concrete leaf: per-integer-column (min,
    max) over live rows (the same role as classic DB table stats)."""
    import numpy as np

    from ..types import DataType

    int_types = (DataType.INT32, DataType.INT64, DataType.UINT32,
                 DataType.DATE, DataType.DATETIME, DataType.ENUM)
    stats: dict = {}
    try:
        n = int(table.num_rows)
    except TypeError:
        return stats  # traced num_rows: not a concrete leaf
    if n == 0:
        return stats
    for a in table.schema:
        if a.type not in int_types:
            continue
        c = table.columns[a.name]
        if isinstance(c.values, jax.core.Tracer):
            continue
        vals = np.asarray(c.values)[:n]
        if c.valid is not None:
            mask = np.asarray(c.valid)[:n]
            if not mask.any():
                continue
            vals = vals[mask]
        stats[a.name] = (int(vals.min()), int(vals.max()))
    return stats


def table_rowid_cols(table: Table, stats: dict) -> set:
    """Columns whose live values are exactly ``min + row position`` — dense
    ascending primary keys (the reference's row-id join precondition,
    rowid_merge_join.h:24-40).  Detected at ingest like the (min, max)
    stats; joins use it to probe the table directly with no index build
    (runtime range-guarded, like every stats-driven plan choice)."""
    import numpy as np

    rowid: set = set()
    try:
        n = int(table.num_rows)
    except TypeError:
        return rowid
    for name, (mn, mx) in stats.items():
        if mx - mn + 1 != n:
            continue  # range can't be a permutation of n rows, let alone id
        c = table.columns[name]
        if c.valid is not None:
            mask = np.asarray(c.valid)[:n]
            if not mask.all():
                continue
        vals = np.asarray(c.values)[:n]
        if np.array_equal(vals, np.arange(mn, mn + n, dtype=vals.dtype)):
            rowid.add(name)
    return rowid


class ScanTableWithSelection(Operation):
    """Scan a table through a row-id selection vector (gather-on-read).

    Reference: view_cursor.cc:77 — backs sorted output and tests.
    """

    def __init__(self, table: Table, selection, num_rows=None):
        self.table = table
        self.selection = jnp.asarray(selection)
        self.num_rows = (
            num_rows if num_rows is not None else self.selection.shape[0]
        )

    def bind(self, ctx: BindContext) -> BoundOperation:
        idx = ctx.register_leaf(self.table)
        sel = self.selection
        n = self.num_rows

        def fn(rctx: RunContext) -> Table:
            t = rctx.leaf_tables[idx]
            return gather_table(t, sel, n)

        return BoundOperation(self.table.schema, dict(self.table.dicts), fn,
                              sel.shape[0])


# reference naming (scan_view.h:24-40): a caller-owned View == a Table here
ScanView = ScanTable
ScanViewWithSelection = ScanTableWithSelection
