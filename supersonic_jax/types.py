"""Type system for the query engine.

Mirrors the behavioral contract of the reference type system
(reference: supersonic/proto/supersonic.proto:5-22 ``DataType``;
supersonic/base/infrastructure/types.h:37-357 ``TypeTraits``), redesigned
for JAX: every DataType maps to a fixed-width jnp dtype so columns are
dense device arrays.  Variable-length types (STRING/BINARY) are
dictionary-encoded: the device column holds int32 codes and the host holds
the dictionary (see supersonic_jax/dictionary.py).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


class DataType(enum.Enum):
    """The 13 logical column types (reference: proto/supersonic.proto:5-22)."""

    INT32 = "INT32"
    INT64 = "INT64"
    UINT32 = "UINT32"
    UINT64 = "UINT64"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BOOL = "BOOL"
    DATE = "DATE"          # int32 days since epoch
    DATETIME = "DATETIME"  # int64 microseconds since epoch
    STRING = "STRING"      # dictionary-encoded: int32 codes on device
    BINARY = "BINARY"      # dictionary-encoded: int32 codes on device
    ENUM = "ENUM"          # int32 codes with a schema-attached value map
    DATA_TYPE = "DATA_TYPE"  # meta: a DataType-valued column (int32 codes)


# Convenience aliases matching the reference enum spelling.
INT32 = DataType.INT32
INT64 = DataType.INT64
UINT32 = DataType.UINT32
UINT64 = DataType.UINT64
FLOAT = DataType.FLOAT
DOUBLE = DataType.DOUBLE
BOOL = DataType.BOOL
DATE = DataType.DATE
DATETIME = DataType.DATETIME
STRING = DataType.STRING
BINARY = DataType.BINARY
ENUM = DataType.ENUM


@dataclass(frozen=True)
class TypeTraits:
    """Runtime traits for one DataType (reference: types.h:226 TypeInfo)."""

    dtype: np.dtype          # physical device dtype of the value array
    is_numeric: bool
    is_integer: bool
    is_floating: bool
    is_variable_length: bool  # dictionary-encoded on device
    is_signed: bool


_TRAITS: dict[DataType, TypeTraits] = {
    DataType.INT32: TypeTraits(np.dtype(np.int32), True, True, False, False, True),
    DataType.INT64: TypeTraits(np.dtype(np.int64), True, True, False, False, True),
    DataType.UINT32: TypeTraits(np.dtype(np.uint32), True, True, False, False, False),
    DataType.UINT64: TypeTraits(np.dtype(np.uint64), True, True, False, False, False),
    DataType.FLOAT: TypeTraits(np.dtype(np.float32), True, False, True, False, True),
    DataType.DOUBLE: TypeTraits(np.dtype(np.float64), True, False, True, False, True),
    DataType.BOOL: TypeTraits(np.dtype(np.bool_), False, False, False, False, False),
    DataType.DATE: TypeTraits(np.dtype(np.int32), False, False, False, False, True),
    DataType.DATETIME: TypeTraits(np.dtype(np.int64), False, False, False, False, True),
    DataType.STRING: TypeTraits(np.dtype(np.int32), False, False, False, True, True),
    DataType.BINARY: TypeTraits(np.dtype(np.int32), False, False, False, True, True),
    DataType.ENUM: TypeTraits(np.dtype(np.int32), False, False, False, False, True),
    DataType.DATA_TYPE: TypeTraits(np.dtype(np.int32), False, False, False, False, True),
}


def traits(t: DataType) -> TypeTraits:
    return _TRAITS[t]


def physical_dtype(t: DataType) -> np.dtype:
    """The jnp dtype of the on-device value array for a DataType."""
    return _TRAITS[t].dtype


def jnp_dtype(t: DataType):
    return jnp.dtype(_TRAITS[t].dtype)


def is_numeric(t: DataType) -> bool:
    return _TRAITS[t].is_numeric


def is_integer(t: DataType) -> bool:
    return _TRAITS[t].is_integer


def is_floating(t: DataType) -> bool:
    return _TRAITS[t].is_floating


def is_variable_length(t: DataType) -> bool:
    return _TRAITS[t].is_variable_length


# ---------------------------------------------------------------------------
# Numeric type promotion (reference: expression/templated/bound_expression_
# factory.cc numeric coercion rules; cast_bound_expression.cc implicit casts)
# ---------------------------------------------------------------------------

# Partial order of implicit numeric promotions. An (a, b) pair promotes to
# the smallest type both can implicitly convert to. Matches the reference's
# C++ arithmetic conversion behavior on its 6 numeric types.
_NUMERIC_RANK = {
    DataType.INT32: 0,
    DataType.UINT32: 1,
    DataType.INT64: 2,
    DataType.UINT64: 3,
    DataType.FLOAT: 4,
    DataType.DOUBLE: 5,
}

# Promotion lattice for binary numeric ops. Signed/unsigned mixes widen to
# the signed type that can hold both where possible (int32+uint32 -> int64),
# mirroring the reference's safe cross-sign arithmetic.
_PROMOTION_TABLE: dict[frozenset, DataType] = {}


def _fill_promotions() -> None:
    N = [DataType.INT32, DataType.UINT32, DataType.INT64, DataType.UINT64,
         DataType.FLOAT, DataType.DOUBLE]
    for a in N:
        _PROMOTION_TABLE[frozenset([a])] = a
    def put(a, b, r):
        _PROMOTION_TABLE[frozenset([a, b])] = r
    put(DataType.INT32, DataType.UINT32, DataType.INT64)
    put(DataType.INT32, DataType.INT64, DataType.INT64)
    put(DataType.INT32, DataType.UINT64, DataType.INT64)   # best effort (ref does signed math)
    put(DataType.INT32, DataType.FLOAT, DataType.FLOAT)
    put(DataType.INT32, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.UINT32, DataType.INT64, DataType.INT64)
    put(DataType.UINT32, DataType.UINT64, DataType.UINT64)
    put(DataType.UINT32, DataType.FLOAT, DataType.FLOAT)
    put(DataType.UINT32, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.INT64, DataType.UINT64, DataType.INT64)   # best effort
    put(DataType.INT64, DataType.FLOAT, DataType.FLOAT)
    put(DataType.INT64, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.UINT64, DataType.FLOAT, DataType.FLOAT)
    put(DataType.UINT64, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.FLOAT, DataType.DOUBLE, DataType.DOUBLE)


_fill_promotions()


class TypeError_(Exception):
    """Bind-time type error (reference: ERROR_ATTRIBUTE_TYPE_MISMATCH)."""


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    if not (is_numeric(a) and is_numeric(b)):
        raise TypeError_(f"no numeric promotion between {a} and {b}")
    return _PROMOTION_TABLE[frozenset([a, b])]


def is_implicitly_convertible(src: DataType, dst: DataType) -> bool:
    """Whether src promotes to dst without an explicit cast."""
    if src == dst:
        return True
    if is_numeric(src) and is_numeric(dst):
        return _PROMOTION_TABLE[frozenset([src, dst])] == dst
    if src == DataType.DATE and dst == DataType.DATETIME:
        return True
    return False
