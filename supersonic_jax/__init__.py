"""supersonic_jax — a columnar query-execution engine in JAX.

A from-scratch JAX/XLA/Pallas redesign with the capabilities of
google/supersonic (reference: supersonic/supersonic.h:20-69 enumerates the
public API surface this package mirrors).  See SURVEY.md for the design
mapping.

The engine requires 64-bit types (INT64/UINT64/DOUBLE columns), so x64
mode is enabled at import.
"""
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .types import (BINARY, BOOL, DATE, DATETIME, DOUBLE, ENUM, FLOAT, INT32,
                    INT64, STRING, UINT32, UINT64, DataType, TypeError_)
from .schema import Attribute, EnumDefinition, SchemaError, TupleSchema
from .batch import Column, Table, concat_tables, gather_table
from .dictionary import Dictionary
from . import exprs
from .exprs import *  # noqa: F401,F403 — expression factory surface
from .ops import *    # noqa: F401,F403 — operator surface

__version__ = "0.1.0"
