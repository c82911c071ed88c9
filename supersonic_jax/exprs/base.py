"""Expression engine core: symbolic trees, bind, traced evaluation.

Reference contract: ``Expression`` -> ``Bind(schema, allocator, max_rows)``
-> ``BoundExpressionTree`` -> ``Evaluate(View) -> EvaluationResult``
(reference: expression/base/expression.h:42-158).

Device redesign (SURVEY.md §2.5): a bound expression is a *traced jax
function* over (values, valid) column pairs.  The reference's skip-vectors
and short-circuiting (expression.h:56-60) are an evaluation-order
optimization for scalar CPUs; on a data-parallel machine both branches are
computed and merged with masks — results (including NULL semantics) are
identical, evaluation order is not observable.  Signaling error policies
(divide-by-zero etc.) become device error flags reduced per evaluation
(exception at the host sync point), replacing THROW/PROPAGATE_ON_FAILURE
(base/exception/exception_macros.h:42-100).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import jax.numpy as jnp

from ..batch import Table
from ..dictionary import Dictionary
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType, TypeError_, jnp_dtype


class ExprValue(NamedTuple):
    """One evaluated column: values[capacity] + optional validity mask."""

    values: jnp.ndarray
    valid: Optional[jnp.ndarray]  # None => non-nullable / all valid

    def valid_or_true(self) -> jnp.ndarray:
        if self.valid is None:
            return jnp.ones(self.values.shape[0], dtype=jnp.bool_)
        return self.valid


class EvaluationError(Exception):
    """Raised at host sync when a signaling expression hit a failure row
    (reference: ERROR_EVALUATION_ERROR, signaling operator variants)."""


@dataclass
class EvalContext:
    """Per-evaluation state threaded through the bound tree."""

    table: Table
    # (flag_name, traced bool scalar) pairs; reduced & checked at the host
    # boundary by the executing operator (signaling ops).
    error_flags: list = field(default_factory=list)
    # host-materialization records (deferred string rendering: ToString /
    # Format / DateFormat of unbounded numerics, CONCAT assembly); each
    # entry carries an ``aux`` dict of traced arrays that become extra
    # program outputs resolved by ops/base.py::execute after the run
    deferred: list = field(default_factory=list)

    def flag_error(self, name: str, per_row_flag: jnp.ndarray) -> None:
        live = per_row_flag & self.table.row_mask()
        self.error_flags.append((name, jnp.any(live)))

    def defer(self, entry) -> None:
        self.deferred.append(entry)


@dataclass
class DeferredRender:
    """Host-rendering record for a string-producing expression whose
    value space is unbounded (ToString / Format / DateFormat without a
    domain bound — reference renders in-engine per row,
    types_infrastructure.h:464-506, math_evaluators.h:39-59,
    date_evaluators.cc:227-265).

    The device column carries ROW-POSITION codes into a
    DeferredDictionary; ``aux`` captures the numeric values (+ render
    mask) as extra program outputs, and ``execute()`` renders the
    strings after the run (ops/host.py::resolve_deferred).  The codes
    survive any downstream row movement — they index the dictionary,
    not the table — but are not order-preserving, so such a column is
    rejected as a sort/group/join key (ops/keys.py)."""

    name: str
    dict_obj: "object"          # DeferredDictionary created at bind
    kind: str                   # "tostring" | "format" | "dateformat"
    input_type: "object"        # DataType of the numeric input
    fmt: "object" = None        # strftime format (dateformat)
    precision: int = 0          # %.*f precision (format)
    aux: dict = None            # traced: vals, ok


def defer_render(ctx: EvalContext, dict_obj, name: str, kind: str,
                 input_type, vals, ok, fmt=None, precision: int = 0):
    """Emit a deferred-rendered STRING column: registers the aux capture
    on ``ctx`` and returns row-position codes.  ``dict_obj`` is the
    DeferredDictionary created at BIND (the bound expression's
    dictionary identity is fixed; re-evaluation re-resolves it)."""
    entry = DeferredRender(name=name, dict_obj=dict_obj, kind=kind,
                           input_type=input_type, fmt=fmt,
                           precision=precision,
                           aux={"vals": vals, "ok": ok})
    ctx.defer(entry)
    return jnp.arange(vals.shape[0], dtype=jnp.int32)


class BoundExpression:
    """A bound (typed, schema-resolved) expression node."""

    def __init__(self, attr: Attribute, fn: Callable[[EvalContext], ExprValue],
                 dictionary: Optional[Dictionary] = None,
                 is_constant: bool = False):
        self.attr = attr
        self._fn = fn
        self.dictionary = dictionary  # for STRING/BINARY-valued results
        self.is_constant = is_constant

    @property
    def name(self) -> str:
        return self.attr.name

    @property
    def type(self) -> DataType:
        return self.attr.type

    @property
    def nullable(self) -> bool:
        return self.attr.nullable

    def evaluate(self, ctx: EvalContext) -> ExprValue:
        return self._fn(ctx)


class Expression:
    """Symbolic expression node; ``bind`` resolves types against a schema.

    Subclasses implement ``do_bind``.  Operator overloads provide sugar:
    ``col("a") + 1 < col("b")``.
    """

    def bind(self, schema: TupleSchema,
             dicts: Optional[dict[str, Dictionary]] = None) -> BoundExpression:
        return self.do_bind(schema, dicts or {})

    def do_bind(self, schema: TupleSchema, dicts: dict) -> BoundExpression:
        raise NotImplementedError

    def as_(self, name: str) -> "Expression":
        return Alias(name, self)

    # -- sugar ----------------------------------------------------------------
    def __add__(self, other):  from .arithmetic import Plus; return Plus(self, wrap(other))
    def __radd__(self, other): from .arithmetic import Plus; return Plus(wrap(other), self)
    def __sub__(self, other):  from .arithmetic import Minus; return Minus(self, wrap(other))
    def __rsub__(self, other): from .arithmetic import Minus; return Minus(wrap(other), self)
    def __mul__(self, other):  from .arithmetic import Multiply; return Multiply(self, wrap(other))
    def __rmul__(self, other): from .arithmetic import Multiply; return Multiply(wrap(other), self)
    def __truediv__(self, other): from .arithmetic import DivideSignaling; return DivideSignaling(self, wrap(other))
    def __mod__(self, other):  from .arithmetic import ModulusSignaling; return ModulusSignaling(self, wrap(other))
    def __neg__(self):         from .arithmetic import Negate; return Negate(self)
    def __lt__(self, other):   from .comparison import Less; return Less(self, wrap(other))
    def __le__(self, other):   from .comparison import LessOrEqual; return LessOrEqual(self, wrap(other))
    def __gt__(self, other):   from .comparison import Greater; return Greater(self, wrap(other))
    def __ge__(self, other):   from .comparison import GreaterOrEqual; return GreaterOrEqual(self, wrap(other))
    def __and__(self, other):  from .logic import And; return And(self, wrap(other))
    def __or__(self, other):   from .logic import Or; return Or(self, wrap(other))
    def __invert__(self):      from .logic import Not; return Not(self)
    def eq(self, other):       from .comparison import Equal; return Equal(self, wrap(other))
    def ne(self, other):       from .comparison import NotEqual; return NotEqual(self, wrap(other))


def wrap(value) -> Expression:
    """Lift a python literal to a Const expression."""
    if isinstance(value, Expression):
        return value
    from .terminal import Const
    return Const(value)


class Alias(Expression):
    def __init__(self, name: str, child: Expression):
        self.alias = name
        self.child = child

    def do_bind(self, schema, dicts):
        b = self.child.do_bind(schema, dicts)
        return BoundExpression(
            Attribute(self.alias, b.type, b.nullable, b.attr.enum),
            b.evaluate, b.dictionary, b.is_constant,
        )


class NamedAttribute(Expression):
    """Column reference (reference: projecting_bound_expressions.h:40
    InputAttributeProjection)."""

    def __init__(self, name: str):
        self.name = name

    def do_bind(self, schema, dicts):
        attr = schema.lookup(self.name)
        name = self.name

        def fn(ctx: EvalContext) -> ExprValue:
            colref = ctx.table.columns[name]
            return ExprValue(colref.values, colref.valid)

        return BoundExpression(attr, fn, dicts.get(name))


class AttributeAt(Expression):
    """Positional column reference (reference: projector.h:376
    ProjectAttributeAt)."""

    def __init__(self, position: int):
        self.position = position

    def do_bind(self, schema, dicts):
        attr = schema.attribute(self.position)
        return NamedAttribute(attr.name).do_bind(schema, dicts)


def col(name: str) -> NamedAttribute:
    return NamedAttribute(name)


# ---------------------------------------------------------------------------
# Shared helpers for operator implementations
# ---------------------------------------------------------------------------

def merge_valid(*valids: Optional[jnp.ndarray]) -> Optional[jnp.ndarray]:
    """AND of validity masks; None means 'all valid'."""
    present = [v for v in valids if v is not None]
    if not present:
        return None
    out = present[0]
    for v in present[1:]:
        out = out & v
    return out


def cast_values(values: jnp.ndarray, src: DataType, dst: DataType) -> jnp.ndarray:
    return values.astype(jnp_dtype(dst))


def bind_children(schema: TupleSchema, dicts: dict,
                  children: Sequence[Expression]) -> list[BoundExpression]:
    return [c.do_bind(schema, dicts) for c in children]


def expr_name(op: str, children: Sequence[BoundExpression]) -> str:
    return f"{op}({', '.join(c.name for c in children)})"


def InputAttributeProjection(projector):
    """Expressions projecting the input through a single-source projector
    (reference: projecting_expressions.h:46; multi-attribute results are
    the engine's expression LISTS — Compute accepts them directly).
    Accepts an ops.project.Projector, an attribute name, or a sequence of
    names; returns one Expression per projected attribute (a bare
    Expression for the single-attribute case)."""
    if isinstance(projector, str):
        return NamedAttribute(projector)
    if isinstance(projector, (list, tuple)):
        return [NamedAttribute(n) for n in projector]
    exprs = []
    for src, dst in projector.items:
        e = (AttributeAt(src) if isinstance(src, int)
             else NamedAttribute(src))
        exprs.append(e if dst is None else Alias(dst, e))
    return exprs[0] if len(exprs) == 1 else exprs


def Projection(sources, projector):
    """Rename/reorder a list of sub-expressions through a projector
    (reference: projecting_expressions.h:71-74).  ``sources`` is a
    sequence of Expressions; positional projector entries select from it,
    named renames apply by output name."""
    sources = list(sources)
    out = []
    for src, dst in projector.items:
        e = sources[src] if isinstance(src, int) else NamedAttribute(src)
        out.append(e if dst is None else Alias(dst, e))
    return out[0] if len(out) == 1 else out
