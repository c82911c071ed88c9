"""Regexp expressions (reference: expression/core/regexp_expressions.h —
RE2-backed RegexpPartialMatch / RegexpFullMatch / RegexpExtract /
RegexpReplace; optional dependency, configure.ac:74-77).

Device redesign: the pattern is a bind-time constant, so each is a host-side
dictionary pass (python ``re``) producing a property/remap LUT — one
device gather at evaluation (same scheme as exprs/string.py).  Python
``re`` syntax is a superset of RE2 for the constructs the reference's
tests exercise; pathological-pattern performance differs (RE2 is linear),
which only affects bind time here, not device execution.
"""
from __future__ import annotations

import re

import numpy as np

from ..types import DataType
from .base import Expression
from .string import _dict_transform_expr, _property_expr, _resolve_const


class RegexpPartialMatch(Expression):
    """TRUE if the pattern matches anywhere in the string."""

    def __init__(self, child, pattern):
        self.child = child
        self.pattern = re.compile(_resolve_const(pattern, "REGEXP pattern"))

    def do_bind(self, schema, dicts):
        pat = self.pattern
        return _property_expr(
            "REGEXP_PARTIAL_MATCH", lambda s: pat.search(s) is not None,
            DataType.BOOL, np.bool_)(self.child).do_bind(schema, dicts)


class RegexpFullMatch(Expression):
    def __init__(self, child, pattern):
        self.child = child
        self.pattern = re.compile(_resolve_const(pattern, "REGEXP pattern"))

    def do_bind(self, schema, dicts):
        pat = self.pattern
        return _property_expr(
            "REGEXP_FULL_MATCH", lambda s: pat.fullmatch(s) is not None,
            DataType.BOOL, np.bool_)(self.child).do_bind(schema, dicts)


class RegexpReplace(Expression):
    """Replace every match with the substitute (reference: RegexpReplace)."""

    def __init__(self, child, pattern, substitute):
        self.child = child
        self.pattern = re.compile(_resolve_const(pattern, "REGEXP pattern"))
        self.substitute = _resolve_const(substitute, "REGEXP substitute")

    def do_bind(self, schema, dicts):
        pat, sub = self.pattern, self.substitute
        return _dict_transform_expr(
            "REGEXP_REPLACE", lambda s: pat.sub(sub, s)
        )(self.child).do_bind(schema, dicts)


class RegexpExtract(Expression):
    """First capture group of the first match; NULL when no match
    (reference: RegexpExtract is nulling)."""

    def __init__(self, child, pattern):
        self.child = child
        self.pattern = re.compile(_resolve_const(pattern, "REGEXP pattern"))

    def do_bind(self, schema, dicts):
        import jax.numpy as jnp

        from ..dictionary import transform
        from ..schema import Attribute
        from .base import BoundExpression, ExprValue, merge_valid
        from .string import _require_string

        from .base import wrap
        cb = wrap(self.child).do_bind(schema, dicts)
        d = _require_string(cb, "REGEXP_EXTRACT")
        pat = self.pattern

        def extract(s):
            m = pat.search(s)
            if m is None:
                return None
            return m.group(1) if pat.groups else m.group(0)

        extracted = [extract(v) for v in d.values]
        nd, remap = transform(
            d, lambda v: extract(v) if extract(v) is not None else "")
        ok = np.array([e is not None for e in extracted], dtype=bool)
        if ok.size == 0:
            ok = np.zeros(1, dtype=bool)
        lut_ok = jnp.asarray(ok)
        lut = jnp.asarray(remap)

        def fn(ctx):
            v = cb.evaluate(ctx)
            codes = jnp.clip(v.values, 0, lut.shape[0] - 1)
            out_codes = jnp.take(lut, codes)
            matched = jnp.take(lut_ok, codes)
            return ExprValue(out_codes, merge_valid(v.valid, matched))

        return BoundExpression(
            Attribute(f"REGEXP_EXTRACT({cb.name})", cb.type, True), fn, nd)
