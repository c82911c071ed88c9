"""Date/time expressions.

Reference: expression/core/date_expressions.h, date_evaluators.cc.
Representation matches the reference: DATE = int32 days since the Unix
epoch; DATETIME = int64 **microseconds** since the epoch, UTC.  The
``*Local`` variants match the reference's localtime_r semantics against
the engine's configured timezone (exprs/tz.py: TZ env /
``set_local_timezone``; default UTC): bind compiles the IANA zone into a
day-granular offset LUT and evaluation shifts to local-civil
microseconds with one packed gather, then reuses the UTC field math.

Civil-calendar math uses Howard Hinnant's days<->civil algorithms as pure
integer arithmetic — branch-free and vectorizable on the VPU.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..schema import Attribute
from ..types import DataType, TypeError_, jnp_dtype
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   merge_valid, wrap)

US_PER_SEC = 1_000_000
US_PER_DAY = 86_400 * US_PER_SEC


def _civil_from_days(z):
    """days since epoch -> (year, month, day), vectorized (Hinnant)."""
    z = z.astype(jnp.int64) + 719468
    era = jnp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097                       # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153                    # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1            # [1, 31]
    m = jnp.where(mp < 10, mp + 3, mp - 9)       # [1, 12]
    y = jnp.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    y = y.astype(jnp.int64)
    m = m.astype(jnp.int64)
    d = d.astype(jnp.int64)
    y = jnp.where(m <= 2, y - 1, y)
    era = jnp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _to_us(b: BoundExpression, values: jnp.ndarray) -> jnp.ndarray:
    """DATE or DATETIME column -> microseconds since epoch (int64)."""
    if b.type == DataType.DATE:
        return values.astype(jnp.int64) * US_PER_DAY
    if b.type == DataType.DATETIME:
        return values.astype(jnp.int64)
    raise TypeError_(f"expected DATE/DATETIME, got {b.type}")


def _floordiv(a, b):
    return a // b  # jnp // floors, matching time-before-epoch semantics


def _field_expr(op_name: str, compute, out_type=DataType.INT32):
    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                us = _to_us(cb, v.values)
                return ExprValue(
                    compute(us).astype(jnp_dtype(out_type)), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", out_type, cb.nullable), f)

    _Op.__name__ = op_name.title()
    return _Op


def _days(us):
    return _floordiv(us, US_PER_DAY)


Year = _field_expr("YEAR", lambda us: _civil_from_days(_days(us))[0])
Month = _field_expr("MONTH", lambda us: _civil_from_days(_days(us))[1])
Day = _field_expr("DAY", lambda us: _civil_from_days(_days(us))[2])
Quarter = _field_expr(
    "QUARTER", lambda us: (_civil_from_days(_days(us))[1] + 2) // 3)
# reference weekday: 0 = Monday .. 6 = Sunday (date_evaluators.cc); epoch
# day 0 (1970-01-01) was a Thursday (=3).
Weekday = _field_expr("WEEKDAY", lambda us: (_days(us) + 3) % 7)
YearDay = _field_expr(
    "YEARDAY",
    lambda us: _days(us) - _days_from_civil(
        _civil_from_days(_days(us))[0],
        jnp.ones_like(_days(us)), jnp.ones_like(_days(us))) + 1)
Hour = _field_expr(
    "HOUR", lambda us: _floordiv(us, 3600 * US_PER_SEC) % 24)
Minute = _field_expr(
    "MINUTE", lambda us: _floordiv(us, 60 * US_PER_SEC) % 60)
Second = _field_expr("SECOND", lambda us: _floordiv(us, US_PER_SEC) % 60)
Microsecond = _field_expr("MICROSECOND", lambda us: us % US_PER_SEC)

def _field_expr_local(op_name: str, compute, out_type=DataType.INT32):
    """``*Local`` field extraction (reference: date_evaluators.cc
    localtime_r operators).  Bind captures the compiled local timezone
    (exprs/tz.py); evaluation shifts to local-civil microseconds with one
    packed day-LUT gather and reuses the UTC field math — POSIX localtime
    IS gmtime(t + utcoff(t)).  Under TZ=UTC this is exactly the UTC op."""

    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            from . import tz as _tz

            cb = self.child.do_bind(schema, dicts)
            tzt = _tz.current_tables()

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                us = _to_us(cb, v.values)
                if tzt is not None:
                    us = _tz.local_shift(us, tzt)
                return ExprValue(
                    compute(us).astype(jnp_dtype(out_type)), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", out_type, cb.nullable), f)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


# Local variants: genuine localtime_r semantics against the engine's
# configured timezone (tz.set_local_timezone / TZ env; default UTC).
YearLocal = _field_expr_local("YEAR_LOCAL", lambda us: _civil_from_days(_days(us))[0])
MonthLocal = _field_expr_local("MONTH_LOCAL", lambda us: _civil_from_days(_days(us))[1])
DayLocal = _field_expr_local("DAY_LOCAL", lambda us: _civil_from_days(_days(us))[2])
QuarterLocal = _field_expr_local(
    "QUARTER_LOCAL", lambda us: (_civil_from_days(_days(us))[1] + 2) // 3)
WeekdayLocal = _field_expr_local(
    "WEEKDAY_LOCAL", lambda us: (_days(us) + 3) % 7)
YearDayLocal = _field_expr_local(
    "YEARDAY_LOCAL",
    lambda us: _days(us) - _days_from_civil(
        _civil_from_days(_days(us))[0],
        jnp.ones_like(_days(us)), jnp.ones_like(_days(us))) + 1)
HourLocal = _field_expr_local(
    "HOUR_LOCAL", lambda us: _floordiv(us, 3600 * US_PER_SEC) % 24)
MinuteLocal = _field_expr_local(
    "MINUTE_LOCAL", lambda us: _floordiv(us, 60 * US_PER_SEC) % 60)
SecondLocal = _field_expr_local(
    "SECOND_LOCAL", lambda us: _floordiv(us, US_PER_SEC) % 60)
MicrosecondLocal = _field_expr_local(
    "MICROSECOND_LOCAL", lambda us: us % US_PER_SEC)


class UnixTimestamp(Expression):
    """DATETIME -> seconds since epoch (INT64)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            us = _to_us(cb, v.values)
            return ExprValue(_floordiv(us, US_PER_SEC), v.valid)

        return BoundExpression(
            Attribute(f"UNIXTIMESTAMP({cb.name})", DataType.INT64,
                      cb.nullable), f)


class FromUnixTime(Expression):
    """seconds since epoch -> DATETIME."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(v.values.astype(jnp.int64) * US_PER_SEC,
                             v.valid)

        return BoundExpression(
            Attribute(f"FROMUNIXTIME({cb.name})", DataType.DATETIME,
                      cb.nullable), f)


def _makedate_us(y, m, d):
    """Reference mkgmtime_int64 semantics (date_evaluators.cc:36-58):
    month is NORMALIZED over any integer (month 13 -> next January) and
    day extrapolates linearly (Feb 30 -> Mar 2; day 0 -> last of prior
    month); _days_from_civil is linear in the day argument, so the two
    computations agree for every (normalized-month, any-day) input."""
    y64 = y.astype(jnp.int64)
    m64 = m.astype(jnp.int64)
    real_y = y64 + (m64 - 1) // 12  # jnp // floors, like the +12 adjust
    real_m = (m64 - 1) % 12 + 1
    return _days_from_civil(real_y, real_m, d) * US_PER_DAY


class MakeDate(Expression):
    """MAKEDATE(year, month, day) -> DATETIME at UTC 0:00 of that date
    (reference: date_expressions.h:53-56; mkgmtime_int64 normalization,
    date_evaluators.cc:36-68).  A pre-1970 result signals an evaluation
    failure (MakeDateFailer, date_evaluators.cc:271-287; can_fail trait,
    expression_traits.h:1772) — here the device error flag raised at host
    sync.  No new NULLs (can_return_null=false)."""

    def __init__(self, year, month, day):
        self.year = wrap(year)
        self.month = wrap(month)
        self.day = wrap(day)

    def do_bind(self, schema, dicts):
        yb = self.year.do_bind(schema, dicts)
        mb = self.month.do_bind(schema, dicts)
        db = self.day.do_bind(schema, dicts)
        nullable = yb.nullable or mb.nullable or db.nullable

        def f(ctx):
            y = yb.evaluate(ctx)
            m = mb.evaluate(ctx)
            d = db.evaluate(ctx)
            us = _makedate_us(y.values, m.values,
                              d.values.astype(jnp.int64))
            valid = merge_valid(y.valid, m.valid, d.valid)
            live = (jnp.ones(us.shape[0], jnp.bool_) if valid is None
                    else valid)
            ctx.flag_error("MAKEDATE result before the epoch",
                           live & (us < 0))
            return ExprValue(us, valid)

        return BoundExpression(
            Attribute("MAKEDATE", DataType.DATETIME, nullable), f)


class MakeDatetime(Expression):
    """MAKEDATETIME(y, mo, d, h, mi, s) -> DATETIME (reference:
    date_bound_expressions.cc:61-142): the date part uses the MakeDate
    normalization; a pre-1970 date part makes the row NULL (not a
    failure); hour/minute/second are added unchecked (hour 25 simply
    rolls into the next day).  Output is always NULLABLE."""

    def __init__(self, year, month, day, hour, minute, second):
        self.parts = [wrap(x) for x in (year, month, day, hour, minute,
                                        second)]

    def do_bind(self, schema, dicts):
        bs = [p.do_bind(schema, dicts) for p in self.parts]

        def f(ctx):
            vs = [b.evaluate(ctx) for b in bs]
            y, m, d, hh, mm, ss = [v.values.astype(jnp.int64) for v in vs]
            date_us = _makedate_us(y, m, d)
            us = date_us + (hh * 3600 + mm * 60 + ss) * US_PER_SEC
            valid = merge_valid(*(v.valid for v in vs), date_us >= 0)
            return ExprValue(us, valid)

        return BoundExpression(
            Attribute("MAKEDATETIME", DataType.DATETIME, True), f)


class AddDays(Expression):
    def __init__(self, child, days):
        self.child = wrap(child)
        self.days = wrap(days)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        db = self.days.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            d = db.evaluate(ctx)
            us = _to_us(cb, v.values) + d.values.astype(jnp.int64) * US_PER_DAY
            return ExprValue(us, merge_valid(v.valid, d.valid))

        return BoundExpression(
            Attribute(f"ADD_DAYS({cb.name})", DataType.DATETIME,
                      cb.nullable or db.nullable), f)


class AddMinutes(Expression):
    def __init__(self, child, minutes):
        self.child = wrap(child)
        self.minutes = wrap(minutes)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        mb = self.minutes.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            m = mb.evaluate(ctx)
            us = _to_us(cb, v.values) + \
                m.values.astype(jnp.int64) * 60 * US_PER_SEC
            return ExprValue(us, merge_valid(v.valid, m.valid))

        return BoundExpression(
            Attribute(f"ADD_MINUTES({cb.name})", DataType.DATETIME,
                      cb.nullable or mb.nullable), f)


class AddMonths(Expression):
    """ADD_MONTHS (reference: date_evaluators.cc:71-83): the day-of-month
    is NOT clamped — mkgmtime_int64 extrapolates linearly, so
    2020-01-31 + 1 month = 2020-03-02 (Feb 31).  The time-of-day offset
    is preserved; a pre-epoch date part collapses to mkgmtime's -1s
    sentinel, quietly (ArithmeticExpressionTraits: no failer/nuller)."""

    def __init__(self, child, months):
        self.child = wrap(child)
        self.months = wrap(months)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        mb = self.months.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            mm = mb.evaluate(ctx)
            us = _to_us(cb, v.values)
            days = _days(us)
            tod = us - days * US_PER_DAY
            y, m, d = _civil_from_days(days)
            md = _makedate_us(y, m + mm.values.astype(jnp.int64), d)
            md = jnp.where(md < 0, -US_PER_SEC, md)  # mkgmtime -1 sentinel
            return ExprValue(md + tod, merge_valid(v.valid, mm.valid))

        return BoundExpression(
            Attribute(f"ADD_MONTHS({cb.name})", DataType.DATETIME,
                      cb.nullable or mb.nullable), f)


class DateToDatetime(Expression):
    """DATE -> DATETIME at midnight (reference: OPERATOR_DATE_TO_DATETIME,
    base/infrastructure/operators.h:54; also the implicit DATE->DATETIME
    promotion)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        if cb.type == DataType.DATETIME:
            return cb
        if cb.type != DataType.DATE:
            raise TypeError_(f"DATE_TO_DATETIME requires DATE, got {cb.type}")

        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(v.values.astype(jnp.int64) * US_PER_DAY,
                             v.valid)

        return BoundExpression(
            Attribute(f"DATE_TO_DATETIME({cb.name})", DataType.DATETIME,
                      cb.nullable), f)


# --- DateFormat --------------------------------------------------------------

# finest strftime directive -> bucket granularity in seconds; directives
# not listed (and thus unknown extensions) conservatively get 1s
_FMT_GRANULE = {
    'S': 1, 'T': 1, 'X': 1, 'c': 1, 's': 1, 'r': 1,
    'M': 60, 'R': 60,
    'H': 3600, 'I': 3600, 'p': 3600, 'P': 3600, 'k': 3600, 'l': 3600,
}
for _c in "aAbBCdDeFgGjmuUVwWxyYnt" + "zZ":  # date-only fields; %z/%Z are
    _FMT_GRANULE[_c] = 86_400  # constant under gmtime (UTC path; the
#                                local path rejects %z/%Z at bind)


def _format_granule_sec(fmt: str) -> int:
    """Seconds per output bucket: two instants in the same bucket render
    identically under ``fmt`` (gmtime fields at or above the granule)."""
    g = 86_400
    i = 0
    while i < len(fmt):
        if fmt[i] == '%' and i + 1 < len(fmt):
            c = fmt[i + 1]
            if c in ('E', 'O') and i + 2 < len(fmt):  # glibc modifiers
                c = fmt[i + 2]
                i += 1
            if c != '%':
                g = min(g, _FMT_GRANULE.get(c, 1))
            i += 2
        else:
            i += 1
    return g


class DateFormat(Expression):
    """DATEFORMAT(datetime, format) (reference: date_expressions.h:157-176,
    date_evaluators.cc:227-265 — strftime of gmtime_r into a 33-byte
    buffer, so a rendering longer than 32 chars becomes the empty string;
    DATE input means 00:00:00 of that date).

    Device encoding: the constant format string has a *bucket granularity*
    (day/hour/minute/second by its finest strftime directive), so with a
    ``domain=(lo, hi)`` bound on the input (DATE: days; DATETIME:
    microseconds; lo >= 0) the output string space is the bucket range —
    built as a bind-time dictionary via the C library's own strftime,
    evaluation is one LUT gather, out-of-domain live rows raise via the
    runtime guard.  ``local=True`` (DateFormatLocal) first shifts to
    local-civil microseconds through the compiled timezone day-LUT
    (exprs/tz.py); %z/%Z are rejected there (the shifted rendering is
    civil-naive).  Without a ``domain`` the column renders via a
    DEFERRED dictionary (row-position codes on device, per-row strftime
    at execute(); not keyable).  Non-constant formats -> bind fails
    pointing at the host path (ops/host.py::to_string).
    """

    DOMAIN_MAX = 1 << 20

    def __init__(self, child, format, domain=None, local=False):
        from .terminal import Const

        self.child = wrap(child)
        if isinstance(format, Const):
            format = format.value
        if not isinstance(format, str):
            raise TypeError_(
                "DATEFORMAT: format must be a constant string on device "
                "(non-constant formats: ops/host.py::to_string per row)")
        self.format = format
        self.domain = domain
        self.local = local

    def do_bind(self, schema, dicts):
        import time as _time

        from ..dictionary import Dictionary
        from ..batch import take_clipped
        from . import tz as _tz

        cb = self.child.do_bind(schema, dicts)
        if cb.type not in (DataType.DATE, DataType.DATETIME):
            raise TypeError_(
                f"DATEFORMAT requires DATE/DATETIME, got {cb.type}")
        fmt = self.format
        tzt = _tz.current_tables() if self.local else None
        if tzt is not None and any(
                fmt[i] == '%' and i + 1 < len(fmt) and fmt[i + 1] in 'zZ'
                for i in range(len(fmt))):
            raise TypeError_(
                "DATEFORMAT_LOCAL with %z/%Z has no device encoding "
                "(zone names need per-row rendering: ops/host.py)")
        if self.domain is None:
            # unbounded: deferred-dictionary rendering —
            # row-position codes on device; execute() strftime's
            # each row after the run.  A ``domain`` bound gives the
            # bucket-LUT device encoding instead (keyable, no host work).
            from ..dictionary import DeferredDictionary
            from .base import defer_render

            d = DeferredDictionary()

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                ok = ctx.table.row_mask() & v.valid_or_true()
                raw = v.values.astype(jnp.int64)
                if cb.type == DataType.DATETIME and tzt is not None:
                    raw = _tz.local_shift(raw, tzt)
                codes = defer_render(
                    ctx, d, f"DATEFORMAT({cb.name})", "dateformat",
                    cb.type, raw, ok, fmt=fmt)
                return ExprValue(codes, v.valid)

            return BoundExpression(
                Attribute(f"DATEFORMAT({cb.name})", DataType.STRING,
                          cb.nullable), g, d)
        lo, hi = int(self.domain[0]), int(self.domain[1])
        if lo < 0:
            raise TypeError_(
                "DATEFORMAT device path requires domain lo >= 0 "
                "(the reference truncates pre-epoch instants toward zero)")
        if cb.type == DataType.DATE:
            g_in, g_sec = 1, 86_400           # bucket == day value
        else:
            g_sec = _format_granule_sec(fmt)
            g_in = g_sec * US_PER_SEC         # bucket == us // g_in
        if tzt is not None:
            # local shift moves an instant by at most +-15h
            pad = (15 * 3600 * US_PER_SEC) // g_in + 1
        else:
            pad = 0
        blo, bhi = lo // g_in - pad, hi // g_in + pad
        size = bhi - blo + 1
        if size <= 0 or size > self.DOMAIN_MAX:
            raise TypeError_(
                f"DATEFORMAT domain needs {size} dictionary entries, over "
                f"the {self.DOMAIN_MAX} budget — coarsen the format or "
                f"materialize via ops/host.py::to_string")

        def _render(bucket: int) -> str:
            s = _time.strftime(fmt, _time.gmtime(bucket * g_sec))
            return s if len(s) <= 32 else ""  # reference 33-byte buffer

        # dedup the renderings (a "%H:%M" over a year has 1440 distinct
        # strings across 525k buckets) into a sorted — order-preserving —
        # dictionary + a bucket->code remap LUT
        import numpy as _np

        rendered = [_render(b) for b in range(blo, bhi + 1)]
        uniq = sorted(set(rendered))
        code_of = {s: i for i, s in enumerate(uniq)}
        remap = jnp.asarray(
            _np.fromiter((code_of[s] for s in rendered), dtype=_np.int32,
                         count=size))
        d = Dictionary(tuple(uniq))
        lut_name = f"DATEFORMAT{'_LOCAL' if self.local else ''}"

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            live = v.valid_or_true()
            raw = v.values.astype(jnp.int64)
            if cb.type == DataType.DATE:
                bucket = raw
            else:
                us = _tz.local_shift(raw, tzt) if tzt is not None else raw
                bucket = us // g_in
            idx = jnp.clip(bucket - blo, 0, size - 1).astype(jnp.int32)
            oob = live & ((raw < lo) | (raw > hi))
            ctx.flag_error(
                f"{lut_name}({cb.name}) value outside declared domain", oob)
            return ExprValue(take_clipped(remap, idx), v.valid)

        return BoundExpression(
            Attribute(f"{lut_name}({cb.name})", DataType.STRING,
                      cb.nullable), f, d)


def DateFormatLocal(child, format, domain=None):
    """Reference: date_expressions.h:175 (localtime_r rendering)."""
    return DateFormat(child, format, domain=domain, local=True)


# --- singular add + const/Now factories (date_expressions.h:55-150) ---------

def AddDay(child):
    """Add one day (reference: date_expressions.h AddDay)."""
    from .terminal import Const

    return AddDays(child, Const(1))


def AddMinute(child):
    """Add one minute (reference: date_expressions.h AddMinute)."""
    from .terminal import Const

    return AddMinutes(child, Const(1))


def AddMonth(child):
    """Add one month (reference: date_expressions.h AddMonth)."""
    from .terminal import Const

    return AddMonths(child, Const(1))


def ConstDateTimeFromMicrosecondsSinceEpoch(value):
    """reference: date_expressions.h:36-39."""
    from .terminal import Const

    return Const(int(value), DataType.DATETIME)


def ConstDateTimeFromSecondsSinceEpoch(value):
    """reference: date_expressions.h:32-35 (whole seconds)."""
    from .terminal import Const

    return Const(int(value) * US_PER_SEC, DataType.DATETIME)


def Now():
    """DATETIME constant from the current time — the time Now() is
    CALLED, not evaluation time (reference: date_expressions.h:41-43)."""
    import time as _time

    from .terminal import Const

    return Const(int(_time.time() * US_PER_SEC), DataType.DATETIME)


def ParseDateTime(format, e):
    """Declared at date_expressions.h:80 but UNIMPLEMENTED in the
    reference (no definition is linked); rejected here for the same
    surface.  Datetime parsing from strings: exprs.ParseStringNulling to
    DATETIME (the types_infrastructure parser path)."""
    raise TypeError_(
        "ParseDateTime is unimplemented in the reference engine; use "
        "ParseStringNulling/ParseStringQuiet with output type DATETIME")
