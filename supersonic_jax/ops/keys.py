"""Sortable/groupable key encoding.

The reference sorts with per-type inlined comparators (sort.cc:150-161) and
groups with per-type hash + equality functors (types_infrastructure.h).
Device redesign: every key column is mapped to a *monotone integer code* —
signed-int order on the code equals the reference comparator order on the
values — so multi-key sort becomes one ``lax.sort`` over code operands and
grouping becomes code equality.  NULL ordering (NULL == NULL, NULL <
non-NULL ascending; sort.cc:44-47) rides in a separate null-rank operand.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..batch import Column, Table
from ..types import DataType


def monotone_code(values: jnp.ndarray, type_: DataType) -> jnp.ndarray:
    """Map a value array to a comparison-key array: ``lax.sort`` / ``<`` /
    ``==`` on the code equal the reference comparator on the values.

    Integers map to order-preserving signed ints.  Floats stay floats —
    XLA sorts them with a total order — with -0.0 normalized to +0.0 so
    the two compare equal like C++ ``<``.
    STRING/BINARY codes are already order-preserving (sorted dictionary).
    """
    if type_ in (DataType.FLOAT, DataType.DOUBLE):
        return jnp.where(values == 0, jnp.zeros_like(values), values)
    if type_ == DataType.UINT64:
        # shift into signed range: subtract 2^63 (wrapping)
        return (values + jnp.uint64(1 << 63)).astype(jnp.int64)
    if type_ == DataType.UINT32:
        return values.astype(jnp.int64)
    if type_ == DataType.BOOL:
        return values.astype(jnp.int32)
    # signed ints, DATE/DATETIME, STRING/BINARY/ENUM codes: already ordered
    return values


def descending_code(code: jnp.ndarray) -> jnp.ndarray:
    """Monotone-reversing transform (DESC keys): bitwise-not for ints,
    negation for floats (NaNs keep sorting last either way, matching the
    reference's unspecified NaN order under C++ ``<``)."""
    if jnp.issubdtype(code.dtype, jnp.floating):
        return -code
    return ~code


def _check_keyable(table: Table, name: str) -> None:
    """Sort/group/join keys need order-preserving (or at least
    value-unique) codes; a CONCAT result's deferred dictionary is
    neither — its codes are group ids assigned before the strings exist."""
    from ..dictionary import DeferredDictionary
    from ..schema import SchemaError

    d = table.dicts.get(name)
    if isinstance(d, DeferredDictionary):
        raise SchemaError(
            f"column {name!r} holds a runtime-resolved CONCAT result; it "
            "cannot be used as a sort/group/join key (codes are not "
            "order-preserving). Materialize the result first.")


def key_operands(table: Table, names: list[str], ascendings: list[bool],
                 pad_mask=None):
    """Build the lax.sort operand list for the given key columns.

    Returns (operands, num_keys): [pad_rank] + per-key [null_rank?, code]
    — the null-rank operand is emitted only for nullable columns (it is a
    constant otherwise; every dropped operand shrinks the sort's HBM
    traffic).  Ascending signed order over the operand tuple == the
    reference's multi-column comparator with NULL-first-ascending
    semantics; padding rows always sort last.  ``pad_mask`` overrides the
    default rows-past-num_rows padding (used for filter fusion).
    """
    cap = table.capacity
    if pad_mask is None:
        pad_mask = (jnp.arange(cap, dtype=jnp.int32)
                    >= jnp.asarray(table.num_rows, jnp.int32))
    pad = pad_mask.astype(jnp.int32)
    operands = [pad]
    for name, asc in zip(names, ascendings):
        _check_keyable(table, name)
        attr = table.schema.lookup(name)
        colm = table.columns[name]
        code = monotone_code(colm.values, attr.type)
        if colm.valid is None:
            if not asc:
                code = descending_code(code)
            operands.append(code)
            continue
        valid = colm.valid
        if asc:
            null_rank = jnp.where(valid, 1, 0).astype(jnp.int32)  # NULL first
        else:
            null_rank = jnp.where(valid, 0, 1).astype(jnp.int32)  # NULL last
            code = descending_code(code)
        code = jnp.where(valid, code, jnp.zeros_like(code))
        operands.extend([null_rank, code])
    return operands, len(operands)


def group_code_columns(table: Table, names: list[str]):
    """Per-key (null_rank_or_None, code) pairs for equality-based grouping.
    Equal pairs == reference key equality (NULL == NULL); null_rank is
    None for non-nullable columns (code equality suffices)."""
    pairs = []
    for name in names:
        _check_keyable(table, name)
        attr = table.schema.lookup(name)
        colm = table.columns[name]
        code = monotone_code(colm.values, attr.type)
        if colm.valid is None:
            pairs.append((None, code))
        else:
            null_rank = jnp.where(colm.valid, 1, 0).astype(jnp.int32)
            pairs.append((null_rank,
                          jnp.where(colm.valid, code, jnp.zeros_like(code))))
    return pairs
