"""String expressions over dictionary-encoded columns.

Reference: expression/core/string_expressions.h (Length, Trim family,
ToUpper/ToLower, Substring, Concat, StringOffset, StringReplace, ...).

Device redesign (SURVEY.md §2.5): the device sees int32 codes; per-value
string transforms run once over the *dictionary* on the host at bind
time, and evaluation is a single device gather through the resulting
remap/property LUT.  O(|dict|) host work replaces O(rows) device-hostile
byte shuffling.  Expressions whose non-constant inputs are more than one
string column (general Concat of two columns, etc.) have no dense device
encoding and raise at bind; materialize intermediate tables to re-encode
when needed.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..dictionary import Dictionary, property_lut, transform
from ..schema import Attribute
from ..types import DataType, TypeError_
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   merge_valid, wrap)
from .terminal import Const
from ..batch import take_clipped


def _require_string(b: BoundExpression, op: str) -> Dictionary:
    if b.type not in (DataType.STRING, DataType.BINARY):
        raise TypeError_(f"{op} requires STRING input, got {b.type}")
    if b.dictionary is None:
        raise TypeError_(f"{op}: input has no bound dictionary")
    return b.dictionary


def _dict_transform_expr(op_name: str, fn: Callable[[str], str]):
    """Unary string->string op as a bind-time dictionary transform."""

    class _Op(Expression):
        def __init__(self, child, *args):
            self.child = wrap(child)
            self.args = args

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            d = _require_string(cb, op_name)
            f = (lambda v: fn(v, *self.args)) if self.args else fn
            nd, remap = transform(d, f)
            lut = jnp.asarray(remap)

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                codes = take_clipped(lut, v.values)
                return ExprValue(codes, v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", cb.type, cb.nullable),
                g, nd)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


ToUpper = _dict_transform_expr("TO_UPPER", lambda s: s.upper())
ToLower = _dict_transform_expr("TO_LOWER", lambda s: s.lower())
Ltrim = _dict_transform_expr("LTRIM", lambda s: s.lstrip())
Rtrim = _dict_transform_expr("RTRIM", lambda s: s.rstrip())
Trim = _dict_transform_expr("TRIM", lambda s: s.strip())


def _property_expr(op_name: str, fn: Callable, out_type: DataType, np_dtype):
    """Unary string->scalar op as a property LUT gather."""

    class _Op(Expression):
        def __init__(self, child, *args):
            self.child = wrap(child)
            self.args = args

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            d = _require_string(cb, op_name)
            f = (lambda v: fn(v, *self.args)) if self.args else fn
            lut = jnp.asarray(property_lut(d, f, np_dtype))

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                out = take_clipped(lut, v.values)
                return ExprValue(out, v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", out_type, cb.nullable), g)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


Length = _property_expr("LENGTH", lambda s: len(s), DataType.UINT32,
                        np.uint32)


def _resolve_const(expr, name: str):
    e = wrap(expr)
    if not isinstance(e, Const):
        raise TypeError_(
            f"{name} argument must be a constant (dictionary transforms "
            "are bind-time; see module docstring)")
    return e.value


class Substring(Expression):
    """SUBSTRING(str, pos[, len]) — 1-based pos like the reference; pos and
    len must be constants (bind-time dictionary transform)."""

    def __init__(self, child, pos, length=None):
        self.child = wrap(child)
        self.pos = _resolve_const(pos, "SUBSTRING pos")
        self.length = None if length is None else _resolve_const(
            length, "SUBSTRING len")

    def do_bind(self, schema, dicts):
        pos, length = self.pos, self.length

        def sub(s: str) -> str:
            # reference semantics: 1-based; negative pos counts from end
            n = len(s)
            if pos > 0:
                start = pos - 1
            elif pos < 0:
                start = max(n + pos, 0)
            else:
                return s[:0]
            end = n if length is None else min(start + max(length, 0), n)
            return s[start:end]

        return _dict_transform_expr("SUBSTRING", sub)(self.child).do_bind(
            schema, dicts)


PAIR_CROSS_MAX = 1 << 20


def _pair_property_expr(op_name: str, fn: Callable, out_type: DataType,
                        np_dtype):
    """Binary (string, string) -> scalar op over two non-constant columns:
    the |da| x |db| property table is computed on the host at bind and
    evaluation is one device gather (same design as Concat's cross
    dictionaries).  Budget-guarded like dictionary.cross."""

    class _Op(Expression):
        def __init__(self, a, b):
            self.a = wrap(a)
            self.b = wrap(b)

        def do_bind(self, schema, dicts):
            ab = self.a.do_bind(schema, dicts)
            bb = self.b.do_bind(schema, dicts)
            da = _require_string(ab, op_name)
            db = _require_string(bb, op_name)
            na, nb = max(len(da), 1), max(len(db), 1)
            if na * nb > PAIR_CROSS_MAX:
                raise TypeError_(
                    f"{op_name}: pair table {len(da)}x{len(db)} exceeds "
                    f"budget {PAIR_CROSS_MAX}; materialize and re-encode")
            av = da.values or ("",)
            bv = db.values or ("",)
            lut_np = np.empty(na * nb, dtype=np_dtype)
            for i, x in enumerate(av):
                base = i * nb
                for j, y in enumerate(bv):
                    lut_np[base + j] = fn(x, y)
            lut = jnp.asarray(lut_np)

            def g(ctx: EvalContext) -> ExprValue:
                va = ab.evaluate(ctx)
                vb = bb.evaluate(ctx)
                ca = jnp.clip(va.values, 0, na - 1).astype(jnp.int32)
                cb2 = jnp.clip(vb.values, 0, nb - 1).astype(jnp.int32)
                out = take_clipped(lut, ca * nb + cb2)
                return ExprValue(out, merge_valid(va.valid, vb.valid))

            return BoundExpression(
                Attribute(f"{op_name}({ab.name}, {bb.name})", out_type,
                          ab.nullable or bb.nullable), g)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


class StringReplace(Expression):
    """STRING_REPLACE(haystack, needle, substitute); needle may be a
    column (pair cross dictionary); substitute must be constant."""

    def __init__(self, haystack, needle, substitute):
        self.haystack = wrap(haystack)
        self.needle = wrap(needle)
        self.substitute = _resolve_const(substitute, "STRING_REPLACE sub")

    def do_bind(self, schema, dicts):
        sub = self.substitute
        if isinstance(self.needle, Const):
            needle = self.needle.value
            return _dict_transform_expr(
                "STRING_REPLACE", lambda s: s.replace(needle, sub)
            )(self.haystack).do_bind(schema, dicts)
        from ..dictionary import CrossSizeError, cross

        hb = self.haystack.do_bind(schema, dicts)
        nb_ = self.needle.do_bind(schema, dicts)
        dh = _require_string(hb, "STRING_REPLACE")
        dn = _require_string(nb_, "STRING_REPLACE")
        try:
            nd, lut_np = cross(dh, dn,
                               fn=lambda s, n: s.replace(n, sub) if n else s,
                               max_size=PAIR_CROSS_MAX)
        except CrossSizeError as e:
            raise TypeError_(f"STRING_REPLACE: {e}") from None
        lut = jnp.asarray(lut_np)
        lb = max(len(dn), 1)
        lh = max(len(dh), 1)

        def g(ctx: EvalContext) -> ExprValue:
            vh = hb.evaluate(ctx)
            vn = nb_.evaluate(ctx)
            ch = jnp.clip(vh.values, 0, lh - 1).astype(jnp.int32)
            cn = jnp.clip(vn.values, 0, lb - 1).astype(jnp.int32)
            out = take_clipped(lut, ch * lb + cn)
            return ExprValue(out, merge_valid(vh.valid, vn.valid))

        return BoundExpression(
            Attribute(f"STRING_REPLACE({hb.name}, {nb_.name})", hb.type,
                      hb.nullable or nb_.nullable), g, nd)


class StringOffset(Expression):
    """STRING_OFFSET(haystack, needle): 1-based position, 0 if absent
    (reference: string_expressions.h StringOffset).  Needle may be a
    constant (property LUT) or a string column (pair cross LUT)."""

    def __init__(self, haystack, needle):
        self.haystack = wrap(haystack)
        self.needle = wrap(needle)

    def do_bind(self, schema, dicts):
        if isinstance(self.needle, Const):
            needle = self.needle.value
            return _property_expr(
                "STRING_OFFSET", lambda s: s.find(needle) + 1,
                DataType.INT32, np.int32
            )(self.haystack).do_bind(schema, dicts)
        return _pair_property_expr(
            "STRING_OFFSET", lambda s, n: s.find(n) + 1,
            DataType.INT32, np.int32
        )(self.haystack, self.needle).do_bind(schema, dicts)


class StringContains(Expression):
    def __init__(self, haystack, needle):
        self.haystack = wrap(haystack)
        self.needle = wrap(needle)

    def do_bind(self, schema, dicts):
        if isinstance(self.needle, Const):
            needle = self.needle.value
            return _property_expr(
                "CONTAINS", lambda s: needle in s, DataType.BOOL, np.bool_
            )(self.haystack).do_bind(schema, dicts)
        return _pair_property_expr(
            "CONTAINS", lambda s, n: n in s, DataType.BOOL, np.bool_
        )(self.haystack, self.needle).do_bind(schema, dicts)


class Concat(Expression):
    """CONCAT(args...): variadic string concatenation (reference:
    string_bound_expressions.cc BoundConcatExpression; output NULL iff any
    input is NULL, nullability = OR of inputs).

    Device design: non-constant string pieces are combined through
    cross-product dictionaries built on the host at bind time
    (`dictionary.cross`): for pieces with dictionaries da, db the combined
    code is one gather through a |da|x|db| LUT, so evaluation stays a pure
    device program.  Constant pieces fold into the neighbouring transform.
    When the cross-product would exceed the size budget (1M entries) there
    is no dense encoding and bind fails, pointing at the host
    materialization path (ops/host.py::concat_columns)."""

    CROSS_MAX = 1 << 20

    def __init__(self, *args):
        self.args = [wrap(a) for a in args]

    def do_bind(self, schema, dicts):
        from ..dictionary import CrossSizeError, cross

        bounds = [a.do_bind(schema, dicts) for a in self.args]

        def const_text(i: int) -> str:
            v = self.args[i].value if isinstance(self.args[i], Const) else None
            if v is None:
                raise TypeError_("CONCAT constant argument must be Const")
            if isinstance(v, bool):
                return "true" if v else "false"
            return v if isinstance(v, (str, bytes)) else str(v)

        var_idx = [i for i, b in enumerate(bounds) if not b.is_constant]
        for i in var_idx:
            b = bounds[i]
            if b.type not in (DataType.STRING, DataType.BINARY):
                raise TypeError_(
                    "CONCAT of a non-constant numeric column requires "
                    "ToString (no dense device encoding)")
            _require_string(b, "CONCAT")
        if not var_idx:
            text = "".join(const_text(i) for i in range(len(bounds)))
            return Const(text).do_bind(schema, dicts)

        is_bytes = bounds[var_idx[0]].type == DataType.BINARY

        def norm(t):
            if is_bytes and isinstance(t, str):
                return t.encode()
            if not is_bytes and isinstance(t, bytes):
                return t.decode()
            return t

        empty = b"" if is_bytes else ""
        # Fold pieces left-to-right: `state` is (dict, eval_fn) of the
        # accumulated prefix; constant text buffers into `pending` and is
        # spliced into the next transform/cross.
        state_dict = None
        state_eval = None
        state_valids: list = []
        pending = empty
        for i, b in enumerate(bounds):
            if b.is_constant:
                pending = pending + norm(const_text(i))
                continue
            d = b.dictionary
            if state_dict is None:
                if pending != empty:
                    pre = pending
                    nd, remap = transform(d, lambda s, pre=pre: pre + s)
                    lut = jnp.asarray(remap)

                    def ev(ctx, b=b, lut=lut):
                        v = b.evaluate(ctx)
                        c = take_clipped(lut, v.values)
                        return c, v.valid

                    state_dict, state_eval = nd, ev
                else:
                    def ev(ctx, b=b):
                        v = b.evaluate(ctx)
                        return v.values, v.valid

                    state_dict, state_eval = d, ev
            else:
                sep = pending
                try:
                    nd, lut_np = cross(
                        state_dict, d,
                        fn=lambda x, y, sep=sep: x + sep + y,
                        max_size=self.CROSS_MAX)
                except CrossSizeError as e:
                    raise TypeError_(
                        f"CONCAT: {e}; materialize and re-encode via "
                        "ops/host.py::concat_columns") from None
                lut = jnp.asarray(lut_np)
                lb = max(len(d), 1)

                def ev(ctx, prev=state_eval, b=b, lut=lut, lb=lb,
                       sd=max(len(state_dict), 1)):
                    pc, pv = prev(ctx)
                    v = b.evaluate(ctx)
                    c2 = jnp.clip(v.values, 0, lb - 1)
                    pc = jnp.clip(pc, 0, sd - 1)
                    idx = pc.astype(jnp.int32) * lb + c2.astype(jnp.int32)
                    return jnp.take(lut, idx), merge_valid(pv, v.valid)

                state_dict, state_eval = nd, ev
            state_valids.append(b.nullable)
            pending = empty
        if pending != empty:
            post = pending
            nd, remap = transform(state_dict, lambda s, post=post: s + post)
            lut = jnp.asarray(remap)

            def ev(ctx, prev=state_eval, lut=lut):
                c, v = prev(ctx)
                return jnp.take(lut, jnp.clip(c, 0, lut.shape[0] - 1)), v

            state_dict, state_eval = nd, ev

        nullable = any(state_valids)
        out_type = DataType.BINARY if is_bytes else DataType.STRING
        final_eval = state_eval

        def g(ctx: EvalContext) -> ExprValue:
            c, v = final_eval(ctx)
            return ExprValue(c, v)

        name = f"CONCAT({', '.join(b.name for b in bounds)})"
        return BoundExpression(
            Attribute(name, out_type, nullable), g, state_dict)


class ToString(Expression):
    """TOSTRING (reference: string_expressions.h:29; printer formats from
    types_infrastructure.cc:45-110 — ints decimal, BOOL "TRUE"/"FALSE",
    DATE "%Y/%m/%d", DATETIME "%Y/%m/%d-%H:%M:%S").

    Device encoding exists when the output string space is bounded:
    STRING/BINARY (identity), ENUM (value-map dictionary), BOOL (2-entry
    dictionary), and integer/DATE/DATETIME columns with a ``domain=(lo,
    hi)`` bound (inclusive; builds the dictionary at bind, evaluation is
    one LUT gather, out-of-domain live rows raise via the runtime guard
    flag).  Unbounded numeric columns (incl. FLOAT/DOUBLE) render via a
    DEFERRED dictionary: the device column carries row-position codes
    and execute() renders the strings after the run with the reference's
    PrintTyped formats — in-plan composable, but not usable as a
    sort/group/join key (codes are not order-preserving; a ``domain``
    bound gives the keyable LUT encoding instead).
    """

    DOMAIN_MAX = 1 << 20

    def __init__(self, child, domain: Optional[tuple] = None):
        self.child = wrap(child)
        self.domain = domain

    def do_bind(self, schema, dicts):
        import datetime

        cb = self.child.do_bind(schema, dicts)
        t = cb.type
        if t in (DataType.STRING, DataType.BINARY):
            return cb
        if t == DataType.BOOL:
            d = Dictionary(("FALSE", "TRUE"))

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                return ExprValue(v.values.astype(jnp.int32), v.valid)

            return BoundExpression(
                Attribute(f"TOSTRING({cb.name})", DataType.STRING,
                          cb.nullable), g, d)
        if t == DataType.ENUM:
            enum = cb.attr.enum
            if enum is None:
                raise TypeError_("TOSTRING of ENUM without a value map")
            d = Dictionary(tuple(enum.names))

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                return ExprValue(v.values.astype(jnp.int32), v.valid)

            return BoundExpression(
                Attribute(f"TOSTRING({cb.name})", DataType.STRING,
                          cb.nullable), g, d)
        int_types = (DataType.INT32, DataType.INT64, DataType.UINT32,
                     DataType.UINT64, DataType.DATE, DataType.DATETIME)
        if t in int_types and self.domain is not None:
            lo, hi = int(self.domain[0]), int(self.domain[1])
            size = hi - lo + 1
            if size <= 0 or size > self.DOMAIN_MAX:
                raise TypeError_(
                    f"TOSTRING domain [{lo}, {hi}] outside the "
                    f"{self.DOMAIN_MAX}-entry dictionary budget")
            if t == DataType.DATE:
                epoch = datetime.date(1970, 1, 1)
                values = tuple(
                    (epoch + datetime.timedelta(days=x)).strftime("%Y/%m/%d")
                    for x in range(lo, hi + 1))
            elif t == DataType.DATETIME:
                epoch_dt = datetime.datetime(1970, 1, 1)
                values = tuple(
                    (epoch_dt + datetime.timedelta(microseconds=x))
                    .strftime("%Y/%m/%d-%H:%M:%S")
                    for x in range(lo, hi + 1))
            else:
                values = tuple(str(x) for x in range(lo, hi + 1))
            d = Dictionary(values)

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                codes = (v.values.astype(jnp.int64) - lo)
                live = v.valid_or_true()
                ctx.flag_error(
                    f"TOSTRING({cb.name}) value outside declared domain",
                    live & ((codes < 0) | (codes >= size)))
                return ExprValue(
                    jnp.clip(codes, 0, size - 1).astype(jnp.int32),
                    v.valid)

            return BoundExpression(
                Attribute(f"TOSTRING({cb.name})", DataType.STRING,
                          cb.nullable), g, d)
        # unbounded numerics (incl. FLOAT/DOUBLE): deferred-dictionary
        # rendering — the device column carries
        # row-position codes; execute() renders the strings post-run via
        # the reference's PrintTyped formats (ops/host.py::_ref_print)
        num_types = int_types + (DataType.FLOAT, DataType.DOUBLE)
        if t in num_types:
            from ..dictionary import DeferredDictionary
            from .base import defer_render

            d = DeferredDictionary()
            nm = f"TOSTRING({cb.name})"

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                ok = ctx.table.row_mask() & v.valid_or_true()
                codes = defer_render(ctx, d, nm, "tostring", t,
                                     v.values, ok)
                return ExprValue(codes, v.valid)

            return BoundExpression(
                Attribute(nm, DataType.STRING, cb.nullable), g, d)
        raise TypeError_(
            f"TOSTRING of {t} has no device encoding")


Concatenate = Concat  # reference: OPERATOR_CONCATENATE
SubstringSignaling = Substring  # reference: OPERATOR_SUBSTRING_SIGNALING


def TrailingSubstring(child, pos):
    """SUBSTRING(str, pos) to end of string (reference:
    string_expressions.cc:132 BoundTrailingSubstring)."""
    return Substring(child, pos)


# ConcatWithSeparator (string_expressions.h:41) is declared "Currently
# not implemented" in the reference and is omitted here for the same
# surface (like ParseDateTime and RIGHT/FULL outer joins).


class StringContainsCI(Expression):
    """Case-insensitive CONTAINS (reference: string_expressions.h:94-98 —
    implemented there by lowercasing both sides)."""

    def __init__(self, haystack, needle):
        self.haystack = wrap(haystack)
        self.needle = wrap(needle)

    def do_bind(self, schema, dicts):
        if isinstance(self.needle, Const):
            needle = str(self.needle.value).lower()
            return _property_expr(
                "CONTAINS_CI", lambda s: needle in s.lower(),
                DataType.BOOL, np.bool_
            )(self.haystack).do_bind(schema, dicts)
        return _pair_property_expr(
            "CONTAINS_CI", lambda s, n: n.lower() in s.lower(),
            DataType.BOOL, np.bool_
        )(self.haystack, self.needle).do_bind(schema, dicts)


def ConcatWithSeparator(separator: str, *args):
    """CONCAT with a separator between the arguments (reference:
    string_expressions.h:36-41 — declared "Currently not implemented"
    there; implemented here as Concat with interleaved constants, same
    NULL semantics as Concat)."""
    parts = []
    for i, a in enumerate(args):
        if i:
            parts.append(Const(separator))
        parts.append(a)
    return Concat(*parts)
