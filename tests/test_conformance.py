"""Expression conformance sweep over the full operator catalog.

Walks every device-evaluable operator the deserialization catalog maps
(io/serialization.py — the reference's OperatorId set,
expression/proto/operators.proto) and checks each against a row-wise
pure-Python golden on one canonical NULL-laced block, evaluated three
ways (the reference's expression_test_helper.h:70-91 pattern):

  * whole block
  * 1-row splits (re-concatenated)
  * 16x replicated block

Value AND null-mask behavior is asserted for every operator, killing the
"mapped but never evaluated" gap for the long tail (trig, bitwise,
nulling/quiet math variants, date extraction, string kit).
"""
from __future__ import annotations

import datetime
import math

import numpy as np
import pytest

import supersonic_jax as E
from supersonic_jax import (Compute, Const, DataType, ScanTable, Table,
                            TupleSchema, col, execute)

# --------------------------------------------------------------------------
# canonical block: every type, NULLs interleaved at varying positions
# --------------------------------------------------------------------------

N = 12

DATA = {
    # INT32 nullable: negatives, zero, odd/even
    "i32": [3, None, -7, 0, 12, -1, 100, None, 25, -128, 7, 2],
    # INT32 non-null: incl. one zero (nulling/quiet divisor behavior)
    "j32": [2, 5, 3, 1, -4, 7, 0, 6, 5, 2, 3, 4],
    # INT32 non-null, no zero, small positive (shift counts, signaling div)
    "k32": [1, 2, 3, 4, 5, 6, 7, 8, 2, 3, 4, 5],
    "i64": [None, 2**40, -(2**35), 17, -1, 0, 123456789012, 5, -9,
            2**33, None, 1],
    "u32": [0, 1, 2**31, 7, 2**32 - 1, 13, 255, 1024, 3, 2**20, 42, 9],
    "u64": [2**63, 1, None, 2**40, 0, 5, None, 77, 2**32, 6, 1, 3],
    # FLOAT nullable, exactly-representable values
    "f32": [1.5, -0.25, None, 3.75, 0.0, -2.5, 10.0, 0.5, None, -0.125,
            7.25, 2.0],
    "d64": [0.81, -1.44, 2.25, None, 0.0, 16.0, -0.5, 3.0, 100.0, None,
            0.36, 1.0],
    # DOUBLE non-null strictly positive (ln/log/sqrt signaling-safe)
    "dpos": [0.81, 1.44, 2.25, 0.04, 4.0, 16.0, 0.5, 3.0, 100.0, 9.0,
             0.36, 1.0],
    # DOUBLE non-null in (-1, 1) for asin/acos/atanh
    "dunit": [0.5, -0.5, 0.25, -0.25, 0.0, 0.75, -0.75, 0.125, 0.9,
              -0.9, 0.3, -0.1],
    "b1": [True, False, None, True, False, True, None, False, True, True,
           False, None],
    "b2": [False, False, True, None, True, True, False, None, True, False,
           True, True],
    "s1": ["Hello", "", None, "  pad  ", "banana", "ABC", "mixedCase",
           None, "x", "longer string here", "123", "-45"],
    "s2": ["an", "b", "c", "pad", "na", "B", "Case", "q", "x", "here",
           "2", "5"],
    "snum": ["12", "-3", "45", "junk", "0", "7", "", "1000", "-1", "8",
             "3", "99"],
    # DATE non-null (days since epoch): epoch, leap years, far future
    "dt": [0, 1, 59, 60, 365, 10957, 11016, 20000, 737, 18262, 4748, 25],
    # DATETIME non-null (microseconds since epoch)
    "ts": [0, 1_000_000, 86_400_000_000, 123_456_789,
           946_684_800_000_000, 1_234_567_890_123_456,
           59_000_000, 3_600_000_000, 7_200_000_000 + 61_000_000,
           86_399_000_000, 1_000_000_000_000_000, 500_000],
}

SCHEMA = TupleSchema.of(
    ("i32", DataType.INT32, True), ("j32", DataType.INT32, False),
    ("k32", DataType.INT32, False), ("i64", DataType.INT64, True),
    ("u32", DataType.UINT32, False), ("u64", DataType.UINT64, True),
    ("f32", DataType.FLOAT, True), ("d64", DataType.DOUBLE, True),
    ("dpos", DataType.DOUBLE, False), ("dunit", DataType.DOUBLE, False),
    ("b1", DataType.BOOL, True), ("b2", DataType.BOOL, True),
    ("s1", DataType.STRING, True), ("s2", DataType.STRING, False),
    ("snum", DataType.STRING, False),
    ("dt", DataType.DATE, False), ("ts", DataType.DATETIME, False))


def table_for(rows):
    return Table.from_data(SCHEMA, {k: [v[i] for i in rows]
                                    for k, v in DATA.items()})


WHOLE = table_for(range(N))


def rowdicts(rows=range(N)):
    return [{k: DATA[k][i] for k in DATA} for i in rows]


# --------------------------------------------------------------------------
# golden helpers (reference semantics)
# --------------------------------------------------------------------------

def nullif(*args):
    """Standard null propagation: any NULL argument -> NULL result."""
    return any(a is None for a in args)


def wrap(v, bits=32, signed=True):
    v &= (1 << bits) - 1
    if signed and v >= (1 << (bits - 1)):
        v -= 1 << bits
    return v


def date_of(days):
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))


def dt_of(micros):
    return (datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
            + datetime.timedelta(microseconds=int(micros)))


def cdiv(a, b):
    """C++ integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def cmod(a, b):
    """C++ % (sign of the dividend)."""
    return a - cdiv(a, b) * b


# --------------------------------------------------------------------------
# the catalog: (operator id, expression builder, row golden, options)
# options: approx=float tolerance, whole_only=skip split/replicated
# (stateful ops carry cross-row state)
# --------------------------------------------------------------------------

def unary(fac, c, fn):
    return (lambda: fac(col(c)),
            lambda r: None if r[c] is None else fn(r[c]))


def binary(fac, c1, c2, fn):
    return (lambda: fac(col(c1), col(c2)),
            lambda r: None if nullif(r[c1], r[c2]) else fn(r[c1], r[c2]))


CASES: dict[str, tuple] = {}


def case(name, builder, golden, **opts):
    assert name not in CASES, name
    CASES[name] = (builder, golden, opts)


def ucase(name, fac, c, fn, **opts):
    b, g = unary(fac, c, fn)
    case(name, b, g, **opts)


def bcase(name, fac, c1, c2, fn, **opts):
    b, g = binary(fac, c1, c2, fn)
    case(name, b, g, **opts)


# ---- arithmetic ----
bcase("ADD", E.Plus, "i32", "j32", lambda a, b: wrap(a + b))
bcase("SUBTRACT", E.Minus, "i32", "j32", lambda a, b: wrap(a - b))
bcase("MULTIPLY", E.Multiply, "i32", "j32", lambda a, b: wrap(a * b))
bcase("ADD_I64", E.Plus, "i64", "i64", lambda a, b: wrap(a + b, 64))
ucase("NEGATE", E.Negate, "i32", lambda a: wrap(-a))
# DIVIDE is double division regardless of input types (golden_dump
# manifest: DivideNulling(INT32,INT32) -> DOUBLE)
bcase("DIVIDE_NULLING", E.DivideNulling, "i32", "j32",
      lambda a, b: None if b == 0 else a / b, approx=1e-12)
bcase("DIVIDE_SIGNALING", E.DivideSignaling, "i32", "k32",
      lambda a, b: a / b, approx=1e-12)
bcase("DIVIDE_QUIET", E.DivideQuiet, "d64", "dpos",
      lambda a, b: a / b, approx=1e-12)
bcase("CPP_DIVIDE_NULLING", E.CppDivideNulling, "i32", "j32",
      lambda a, b: None if b == 0 else cdiv(a, b))
bcase("CPP_DIVIDE_SIGNALING", E.CppDivideSignaling, "i32", "k32", cdiv)
bcase("MODULUS_NULLING", E.ModulusNulling, "i32", "j32",
      lambda a, b: None if b == 0 else cmod(a, b))
bcase("MODULUS_SIGNALING", E.ModulusSignaling, "i32", "k32", cmod)

# ---- comparison ----
bcase("EQUAL", E.Equal, "i32", "j32", lambda a, b: a == b)
bcase("NOT_EQUAL", E.NotEqual, "i32", "j32", lambda a, b: a != b)
bcase("LESS", E.Less, "i32", "j32", lambda a, b: a < b)
bcase("LESS_OR_EQUAL", E.LessOrEqual, "i32", "j32", lambda a, b: a <= b)
bcase("GREATER", E.Greater, "i32", "j32", lambda a, b: a > b)
bcase("GREATER_OR_EQUAL", E.GreaterOrEqual, "i32", "j32",
      lambda a, b: a >= b)
# cross-signedness safety: INT32 vs UINT32 compares by value
bcase("LESS_CROSS_SIGN", E.Less, "i32", "u32", lambda a, b: a < b)
bcase("EQUAL_STRING", E.Equal, "s1", "s2", lambda a, b: a == b)
case("IN", lambda: E.In(col("i32"), Const(3), Const(-7), Const(25)),
     lambda r: None if r["i32"] is None else r["i32"] in (3, -7, 25))
ucase("IS_ODD", E.IsOdd, "i32", lambda a: a % 2 != 0)
ucase("IS_EVEN", E.IsEven, "i32", lambda a: a % 2 == 0)

# ---- ternary logic (elementary_expressions.h:47-60) ----
case("AND", lambda: E.And(col("b1"), col("b2")),
     lambda r: (False if r["b1"] is False or r["b2"] is False
                else (None if nullif(r["b1"], r["b2"])
                      else True)))
case("OR", lambda: E.Or(col("b1"), col("b2")),
     lambda r: (True if r["b1"] is True or r["b2"] is True
                else (None if nullif(r["b1"], r["b2"]) else False)))
case("AND_NOT", lambda: E.AndNot(col("b1"), col("b2")),
     lambda r: (False if r["b1"] is True or r["b2"] is False
                else (None if nullif(r["b1"], r["b2"]) else True)))
bcase("XOR", E.Xor, "b1", "b2", lambda a, b: a != b)
ucase("NOT", E.Not, "b1", lambda a: not a)

# ---- bitwise ----
bcase("BITWISE_AND", E.BitwiseAnd, "i32", "j32", lambda a, b: wrap(a & b))
bcase("BITWISE_OR", E.BitwiseOr, "i32", "j32", lambda a, b: wrap(a | b))
bcase("BITWISE_XOR", E.BitwiseXor, "i32", "j32", lambda a, b: wrap(a ^ b))
ucase("BITWISE_NOT", E.BitwiseNot, "i32", lambda a: wrap(~a))
bcase("SHIFT_LEFT", E.ShiftLeft, "i32", "k32",
      lambda a, b: wrap(a << b))
bcase("SHIFT_RIGHT", E.ShiftRight, "i32", "k32",
      lambda a, b: a >> b)  # arithmetic shift for signed

# ---- control ----
# IF treats a NULL condition as false (MySQL behavior,
# elementary_expressions.h:55-58); NULLING_IF yields NULL instead
case("IF", lambda: E.If(col("b2"), col("j32"), col("k32")),
     lambda r: r["j32"] if r["b2"] is True else r["k32"])
case("NULLING_IF",
     lambda: E.NullingIf(col("b2"), col("j32"), col("k32")),
     lambda r: None if r["b2"] is None
     else (r["j32"] if r["b2"] else r["k32"]))
case("CASE", lambda: E.Case(col("j32"), Const(-1), Const(2), Const(20),
                            Const(5), Const(50)),
     lambda r: {2: 20, 5: 50}.get(r["j32"], -1))
case("IF_NULL", lambda: E.IfNull(col("i32"), Const(-99)),
     lambda r: -99 if r["i32"] is None else r["i32"])
case("IS_NULL", lambda: E.IsNull(col("i32")),
     lambda r: r["i32"] is None)
ucase("COPY", E.Copy, "i32", lambda a: a)

# ---- casts / parsing ----
case("CAST_I32_F64",
     lambda: E.CastTo(DataType.DOUBLE, col("i32")),
     lambda r: None if r["i32"] is None else float(r["i32"]))
case("CAST_F64_I32_EXPLICIT",
     lambda: E.CastNulling(DataType.INT32, col("d64")),
     lambda r: None if r["d64"] is None else int(r["d64"]))
case("PARSE_STRING_NULLING",
     lambda: E.ParseStringNulling(DataType.INT32, col("snum")),
     lambda r: (int(r["snum"])
                if r["snum"].lstrip("-").isdigit() else None))
case("PARSE_STRING_QUIET",
     lambda: E.ParseStringQuiet(DataType.INT32, Const("42")),
     lambda r: 42)

# ---- math ----
ucase("EXP", E.Exp, "d64", math.exp, approx=1e-13)
ucase("LN", E.LnNulling, "dpos", math.log, approx=1e-13)
ucase("LN_QUIET", E.LnQuiet, "dpos", math.log, approx=1e-13)
ucase("LN_SIGNALING", E.LnSignaling, "dpos", math.log, approx=1e-13)
case("LN_NULLING_NEG", lambda: E.LnNulling(col("d64")),
     lambda r: (None if r["d64"] is None or r["d64"] <= 0
                else math.log(r["d64"])), approx=1e-13)
ucase("LOG10", E.Log10Nulling, "dpos", math.log10, approx=1e-13)
ucase("LOG10_QUIET", E.Log10Quiet, "dpos", math.log10, approx=1e-13)
ucase("LOG10_SIGNALING", E.Log10Signaling, "dpos", math.log10,
      approx=1e-13)
ucase("LOG2", E.Log2Nulling, "dpos", math.log2, approx=1e-13)
ucase("LOG2_QUIET", E.Log2Quiet, "dpos", math.log2, approx=1e-13)
ucase("LOG2_SIGNALING", E.Log2Signaling, "dpos", math.log2, approx=1e-13)
bcase("LOG", E.LogNulling, "dpos", "k32",
      lambda a, b: math.log(b, a) if a not in (1.0,) else None,
      approx=1e-12)
bcase("POWER", E.PowQuiet, "dpos", "k32", lambda a, b: a ** b,
      approx=1e-12)
bcase("POWER_SIGNALING", E.PowSignaling, "dpos", "k32",
      lambda a, b: a ** b, approx=1e-12)
bcase("POWER_NULLING", E.PowNulling, "dpos", "k32",
      lambda a, b: a ** b, approx=1e-12)
ucase("SQRT", E.Sqrt, "dpos", math.sqrt, approx=1e-13)
ucase("SQRT_NULLING", E.SqrtNulling, "dpos", math.sqrt, approx=1e-13)
case("SQRT_NULLING_NEG", lambda: E.SqrtNulling(col("d64")),
     lambda r: (None if r["d64"] is None or r["d64"] < 0
                else math.sqrt(r["d64"])), approx=1e-13)
ucase("SQRT_SIGNALING", E.SqrtSignaling, "dpos", math.sqrt, approx=1e-13)
ucase("ROUND", E.Round, "d64",
      lambda a: math.floor(a + 0.5) if a >= 0 else math.ceil(a - 0.5),
      approx=1e-13)  # C round(): halves away from zero
ucase("ROUND_TO_INT", E.RoundToInt, "d64",
      lambda a: int(math.floor(a + 0.5)) if a >= 0
      else int(math.ceil(a - 0.5)))
ucase("CEIL", E.Ceil, "d64", math.ceil, approx=0)
ucase("CEIL_TO_INT", E.CeilToInt, "d64", lambda a: int(math.ceil(a)))
ucase("FLOOR", E.Floor, "d64", math.floor, approx=0)
ucase("FLOOR_TO_INT", E.FloorToInt, "d64", lambda a: int(math.floor(a)))
ucase("TRUNC", E.Trunc, "d64", math.trunc, approx=0)
ucase("TRUNC_TO_INT", E.TruncToInt, "d64", lambda a: int(math.trunc(a)))
case("ROUND_WITH_PRECISION",
     lambda: E.RoundWithPrecision(col("d64"), 1),
     lambda r: None if r["d64"] is None
     else math.floor(abs(r["d64"]) * 10 + 0.5) / 10
     * (1 if r["d64"] >= 0 else -1), approx=1e-12)
case("ROUND_WITH_MULTIPLIER",
     lambda: E.RoundWithMultiplier(col("d64"), Const(2.0)),
     lambda r: None if r["d64"] is None
     else (math.floor(r["d64"] * 2.0 + 0.5) if r["d64"] >= 0
           else math.ceil(r["d64"] * 2.0 - 0.5)) / 2.0, approx=1e-12)
ucase("ABS", E.Abs, "i32", abs)
ucase("ABS_F", E.Abs, "d64", abs, approx=0)
ucase("IS_NAN", E.IsNaN, "d64", lambda a: False)
ucase("IS_INF", E.IsInf, "d64", lambda a: False)
ucase("IS_FINITE", E.IsFinite, "d64", lambda a: True)
ucase("IS_NORMAL", E.IsNormal, "d64", lambda a: a != 0.0)
case("IS_NAN_TRUE", lambda: E.IsNaN(E.DivideQuiet(Const(0.0), Const(0.0))),
     lambda r: True)
case("IS_INF_TRUE", lambda: E.IsInf(E.DivideQuiet(Const(1.0), Const(0.0))),
     lambda r: True)

# ---- trig / hyperbolic ----
ucase("SIN", E.Sin, "d64", math.sin, approx=1e-13)
ucase("COS", E.Cos, "d64", math.cos, approx=1e-13)
ucase("TAN", E.Tan, "d64", math.tan, approx=1e-13)
ucase("COT", E.Cot, "dpos", lambda a: 1.0 / math.tan(a), approx=1e-12)
ucase("ASIN", E.Asin, "dunit", math.asin, approx=1e-13)
ucase("ACOS", E.Acos, "dunit", math.acos, approx=1e-13)
ucase("ATAN", E.Atan, "d64", math.atan, approx=1e-13)
bcase("ATAN2", E.Atan2, "dunit", "dpos", math.atan2, approx=1e-13)
ucase("SINH", E.Sinh, "dunit", math.sinh, approx=1e-13)
ucase("COSH", E.Cosh, "dunit", math.cosh, approx=1e-13)
ucase("TANH", E.Tanh, "dunit", math.tanh, approx=1e-13)
ucase("ASINH", E.Asinh, "d64", math.asinh, approx=1e-13)
case("ACOSH", lambda: E.Acosh(E.Plus(col("dpos"), Const(1.0))),
     lambda r: math.acosh(r["dpos"] + 1.0), approx=1e-13)
ucase("ATANH", E.Atanh, "dunit", math.atanh, approx=1e-13)

# ---- string (device via dictionary transforms) ----
ucase("LENGTH", E.Length, "s1", len)
ucase("LTRIM", E.Ltrim, "s1", lambda s: s.lstrip(" "))
ucase("RTRIM", E.Rtrim, "s1", lambda s: s.rstrip(" "))
ucase("TRIM", E.Trim, "s1", lambda s: s.strip(" "))
ucase("TO_UPPER", E.ToUpper, "s1", str.upper)
ucase("TO_LOWER", E.ToLower, "s1", str.lower)
case("SUBSTRING",
     lambda: E.Substring(col("s1"), Const(2), Const(3)),
     lambda r: None if r["s1"] is None else r["s1"][1:4])
case("SUBSTRING_NEG",
     lambda: E.Substring(col("s1"), Const(-3)),
     lambda r: None if r["s1"] is None
     else (r["s1"][-3:] if len(r["s1"]) >= 3 else r["s1"]))
case("CONCATENATE",
     lambda: E.Concat(Const("<"), col("s1"), Const("|"), col("s2"),
                      Const(">")),
     lambda r: None if r["s1"] is None
     else "<" + r["s1"] + "|" + r["s2"] + ">")
bcase("STRING_OFFSET", E.StringOffset, "s1", "s2",
      lambda s, n: s.find(n) + 1)
case("STRING_REPLACE",
     lambda: E.StringReplace(col("s1"), Const("a"), Const("@")),
     lambda r: None if r["s1"] is None else r["s1"].replace("a", "@"))
bcase("STRING_CONTAINS", E.StringContains, "s1", "s2",
      lambda s, n: n in s)
case("REGEXP_PARTIAL",
     lambda: E.RegexpPartialMatch(col("s1"), "an"),
     lambda r: None if r["s1"] is None else ("an" in r["s1"]))
case("REGEXP_FULL",
     lambda: E.RegexpFullMatch(col("s1"), "[a-z]*"),
     lambda r: None if r["s1"] is None
     else all(c.islower() for c in r["s1"]))
case("REGEXP_EXTRACT",
     lambda: E.RegexpExtract(col("s1"), "([0-9]+)"),
     lambda r: None if r["s1"] is None else (
         __import__("re").search("([0-9]+)", r["s1"]).group(1)
         if __import__("re").search("([0-9]+)", r["s1"]) else None))
case("REGEXP_REPLACE",
     lambda: E.RegexpReplace(col("s1"), "[0-9]+", Const("#")),
     lambda r: None if r["s1"] is None
     else __import__("re").sub("[0-9]+", "#", r["s1"]))

# ---- date/time (*Local cases run under the conftest TZ=UTC pin, where
# Local == UTC by definition; non-UTC zones: tests/test_tz.py + the
# date_local golden case) --
ucase("YEAR", E.Year, "dt", lambda d: date_of(d).year)
ucase("QUARTER", E.Quarter, "dt",
      lambda d: (date_of(d).month - 1) // 3 + 1)
ucase("MONTH", E.Month, "dt", lambda d: date_of(d).month)
ucase("DAY", E.Day, "dt", lambda d: date_of(d).day)
ucase("WEEKDAY", E.Weekday, "dt", lambda d: date_of(d).weekday())
ucase("YEARDAY", E.YearDay, "dt",
      lambda d: date_of(d).timetuple().tm_yday)
ucase("YEAR_TS", E.Year, "ts", lambda t: dt_of(t).year)
ucase("HOUR", E.Hour, "ts", lambda t: dt_of(t).hour)
ucase("MINUTE", E.Minute, "ts", lambda t: dt_of(t).minute)
ucase("SECOND", E.Second, "ts", lambda t: dt_of(t).second)
ucase("MICROSECOND", E.Microsecond, "ts", lambda t: dt_of(t).microsecond)
ucase("YEAR_LOCAL", E.YearLocal, "ts", lambda t: dt_of(t).year)
ucase("QUARTER_LOCAL", E.QuarterLocal, "ts",
      lambda t: (dt_of(t).month - 1) // 3 + 1)
ucase("MONTH_LOCAL", E.MonthLocal, "ts", lambda t: dt_of(t).month)
ucase("DAY_LOCAL", E.DayLocal, "ts", lambda t: dt_of(t).day)
ucase("WEEKDAY_LOCAL", E.WeekdayLocal, "ts",
      lambda t: dt_of(t).weekday())
ucase("YEARDAY_LOCAL", E.YearDayLocal, "ts",
      lambda t: dt_of(t).timetuple().tm_yday)
ucase("HOUR_LOCAL", E.HourLocal, "ts", lambda t: dt_of(t).hour)
ucase("MINUTE_LOCAL", E.MinuteLocal, "ts", lambda t: dt_of(t).minute)
ucase("SECOND_LOCAL", E.SecondLocal, "ts", lambda t: dt_of(t).second)
ucase("UNIXTIMESTAMP", E.UnixTimestamp, "ts", lambda t: t // 1_000_000)
case("FROMUNIXTIME",
     lambda: E.FromUnixTime(E.UnixTimestamp(col("ts"))),
     lambda r: (r["ts"] // 1_000_000) * 1_000_000)
case("MAKEDATE",
     lambda: E.MakeDate(Const(2001), Const(3), Const(7)),
     lambda r: (datetime.date(2001, 3, 7)
                - datetime.date(1970, 1, 1)).days * 86_400_000_000)
case("MAKEDATETIME",
     lambda: E.MakeDatetime(Const(2001), Const(3), Const(7), Const(4),
                            Const(5), Const(6)),
     lambda r: int((datetime.datetime(2001, 3, 7, 4, 5, 6,
                                      tzinfo=datetime.timezone.utc)
                    .timestamp()) * 1_000_000))
case("ADD_DAY",
     lambda: E.Day(E.AddDays(col("ts"), Const(1))),
     lambda r: (dt_of(r["ts"]) + datetime.timedelta(days=1)).day)
case("ADD_MINUTE",
     lambda: E.Minute(E.AddMinutes(col("ts"), Const(90))),
     lambda r: (dt_of(r["ts"]) + datetime.timedelta(minutes=90)).minute)
case("ADD_MONTH",
     lambda: E.Month(E.AddMonths(col("ts"), Const(2))),
     lambda r: (dt_of(r["ts"]).month + 1) % 12 + 1)
case("DATE_TO_DATETIME",
     lambda: E.DateToDatetime(col("dt")),
     lambda r: r["dt"] * 86_400_000_000)

# ---- hashing (values are engine-defined; golden checks determinism &
# null contract instead of exact values) ----
case("HASH", lambda: E.Hash(col("i32")), None, deterministic=True)
case("FINGERPRINT", lambda: E.Fingerprint(col("s1")), None,
     deterministic=True)

# ---- terminal ----
case("SEQUENCE", lambda: E.Sequence(), lambda r: None, sequence=True)
case("TOSTRING", lambda: E.ToString(col("b1")),
     lambda r: None if r["b1"] is None else ("TRUE" if r["b1"] else "FALSE"))
case("TOSTRING_INT",
     lambda: E.ToString(col("j32"), domain=(-10, 10)),
     lambda r: str(r["j32"]))
case("TOSTRING_DATE",
     lambda: E.ToString(col("dt"), domain=(0, 26000)),
     lambda r: date_of(r["dt"]).strftime("%Y/%m/%d"))
case("CONST_PI", lambda: E.ConstDouble(3.141592653589793),
     lambda r: 3.141592653589793, approx=0)
case("NULL_CONST", lambda: E.Plus(E.Null(DataType.INT32), col("j32")),
     lambda r: None)

# ---- stateful (order-dependent whole-column scans; whole block only) ----
case("CHANGED", lambda: E.Changed(col("j32")),
     ["changed"], whole_only=True)
case("RUNNING_SUM", lambda: E.RunningSum(col("i32")),
     ["running_sum"], whole_only=True)
case("SMUDGE", lambda: E.Smudge(col("i32")), ["smudge"], whole_only=True)
case("SMUDGE_IF", lambda: E.SmudgeIf(col("j32"), col("b2")),
     ["smudge_if"], whole_only=True)
# flush must be a non-nullable BOOL (stateful_expressions.h:59-61)
case("RUNNING_MIN_WITH_FLUSH",
     lambda: E.RunningMinWithFlush(E.IsEven(col("k32")), col("i32")),
     ["running_min"], whole_only=True)


def _stateful_golden(kind, rows):
    out = []
    if kind == "changed":
        prev = object()
        for r in rows:
            out.append(r["j32"] != prev)
            prev = r["j32"]
    elif kind == "running_sum":
        acc, seen = 0, False
        for r in rows:
            if r["i32"] is None:
                out.append(acc if seen else None)
            else:
                acc += r["i32"]
                seen = True
                out.append(acc)
    elif kind == "smudge":
        last = None
        for r in rows:
            if r["i32"] is not None:
                last = r["i32"]
            out.append(last)
    elif kind == "smudge_if":
        last = None
        for r in rows:
            # copy previous value down when condition is true
            if r["b2"] is True and last is not None:
                out.append(last)
            else:
                out.append(r["j32"])
            last = out[-1]
    elif kind == "running_min":
        # reference loop (stateful_bound_expressions.cc:266-281): non-null
        # input updates the min; output = state (NULL while uninitialized);
        # a TRUE flush resets the state AFTER emitting this row
        cur = None
        for r in rows:
            if r["i32"] is not None:
                cur = r["i32"] if cur is None else min(cur, r["i32"])
            out.append(cur)
            if r["k32"] % 2 == 0:
                cur = None
    return out


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------

def eval_on(table, builder):
    out = execute(Compute(builder().as_("out"), ScanTable(table)))
    return [row[0] for row in out.to_pylist()]


def compare(got, want, approx):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None or g is None:
            assert g is None and w is None, \
                f"row {i}: null mismatch got={g!r} want={w!r}"
        elif approx and isinstance(w, float):
            assert g == pytest.approx(w, rel=approx or 1e-15, abs=1e-300), \
                f"row {i}: got={g!r} want={w!r}"
        else:
            assert g == w or (isinstance(w, float) and g == w), \
                f"row {i}: got={g!r} want={w!r}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_conformance(name):
    builder, golden, opts = CASES[name]
    rows = rowdicts()
    got_whole = eval_on(WHOLE, builder)

    if opts.get("deterministic"):
        # engine-defined values: same input -> same hash; NULL handling is
        # engine-defined too (reference hashes NULL as 0xdeadbabe) — only
        # require per-row determinism across evaluations
        again = eval_on(WHOLE, builder)
        assert got_whole == again
        return
    if opts.get("sequence"):
        assert got_whole == list(range(N))
        return

    if isinstance(golden, list):   # stateful marker
        want = _stateful_golden(golden[0], rows)
    else:
        want = [golden(r) for r in rows]
    compare(got_whole, want, opts.get("approx"))

    if opts.get("whole_only"):
        return

    # 1-row splits: each row evaluated alone must equal the whole-block row
    got_split = []
    for i in range(N):
        got_split.extend(eval_on(table_for([i]), builder))
    compare(got_split, want, opts.get("approx"))

    # replicated block (16x)
    reps = list(range(N)) * 16
    got_rep = eval_on(table_for(reps), builder)
    compare(got_rep, [want[i] for i in reps], opts.get("approx"))


def test_catalog_coverage():
    """Every device-evaluable operator in the deserialization catalog has
    a conformance case above (host-side and reference-unimplemented ids
    excluded and documented in io/serialization.py)."""
    from supersonic_jax.io import serialization as S

    covered = set(CASES)
    # ids exercised under a different case name here
    alias = {
        "DIVIDE": "DIVIDE_NULLING", "CPP_DIVIDE": "CPP_DIVIDE_NULLING",
        "MODULUS": "MODULUS_NULLING", "IFNULL": "IF_NULL",
        "SQRT_QUIET": "SQRT", "POWER_QUIET": "POWER",
        "PI": "CONST_PI", "TOUPPER": "TO_UPPER", "TOLOWER": "TO_LOWER",
        "REPLACE": "STRING_REPLACE", "LOG10_SIGNALING": "LOG10_SIGNALING",
        "YEAR_UTC": "YEAR", "QUARTER_UTC": "QUARTER", "MONTH_UTC": "MONTH",
        "DAY_UTC": "DAY", "WEEKDAY_UTC": "WEEKDAY",
        "YEARDAY_UTC": "YEARDAY", "HOUR_UTC": "HOUR",
        "MINUTE_UTC": "MINUTE", "RANDOM_INT32": None, "SEQUENCE": "SEQUENCE",
        "FORMAT": None,  # FORMAT -> host-backed Format; covered in
        # tests/test_exprs_extended.py::test_format
        "EXP_QUIET": "EXP",
        "UNIXTIMESTAMP": "UNIXTIMESTAMP",
    }
    missing = []
    for op in list(S._OPERATORS) + list(S._PROTO_EXTRA_OPS):
        if op in covered:
            continue
        if op in alias:
            continue
        missing.append(op)
    assert not missing, f"catalog operators without conformance: {missing}"
