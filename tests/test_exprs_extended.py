"""Math, string, date, stateful expression tests (reference analogues:
math/string/date/stateful *_test.cc and *_evaluators_test.cc)."""
import math

import pytest

from supersonic_jax import (BOOL, DOUBLE, INT64, STRING, Abs, AddDays,
                            AddMonths, Ceil, Changed, Compute, Concat, Const,
                            DataType, Day, EvaluationError, Exp, Floor,
                            FromUnixTime, Hour, IsFinite, IsNaN, Length, Ln,
                            LnNulling, LnSignaling, Log10, MakeDate,
                            MakeDatetime, Minute, Month, Pow, Quarter, Round,
                            RoundToInt, RunningMinWithFlush, RunningSum,
                            ScanTable, Second, Smudge, SmudgeIf, Sqrt,
                            SqrtNulling, StringContains, StringOffset,
                            StringReplace, Substring, Table, ToLower, ToUpper,
                            Trim, TupleSchema, UnixTimestamp, Weekday, Year,
                            YearDay, col, execute)


def eval_expr(expr, data, schema):
    t = Table.from_data(schema, data)
    out = execute(Compute(expr, ScanTable(t)))
    return [r[0] for r in out.to_pylist()]


NUM = TupleSchema.of(("x", DOUBLE),)
STR = TupleSchema.of(("s", STRING),)


def test_math_basics():
    data = {"x": [1.0, math.e, None]}
    assert eval_expr(Ln(col("x")), data, NUM)[:2] == pytest.approx([0.0, 1.0])
    assert eval_expr(Ln(col("x")), data, NUM)[2] is None
    assert eval_expr(Exp(Const(0.0)), data, NUM) == [1.0] * 3
    assert eval_expr(Sqrt(Const(9.0)), data, NUM) == [3.0] * 3


def test_ln_policies():
    data = {"x": [-1.0, 4.0]}
    assert eval_expr(LnNulling(col("x")), data, NUM)[0] is None
    with pytest.raises(EvaluationError):
        eval_expr(LnSignaling(col("x")), data, NUM)
    v = eval_expr(Ln(col("x")), data, NUM)  # quiet: nan
    assert math.isnan(v[0])


def test_sqrt_nulling():
    assert eval_expr(SqrtNulling(col("x")), {"x": [-4.0, 4.0]}, NUM) == \
        [None, 2.0]


def test_rounding():
    data = {"x": [2.5, -2.5, 1.4, None]}
    assert eval_expr(Round(col("x")), data, NUM) == [3.0, -3.0, 1.0, None]
    assert eval_expr(RoundToInt(col("x")), data, NUM) == [3, -3, 1, None]
    assert eval_expr(Ceil(col("x")), data, NUM) == [3.0, -2.0, 2.0, None]
    assert eval_expr(Floor(col("x")), data, NUM) == [2.0, -3.0, 1.0, None]


def test_abs_pow_classify():
    assert eval_expr(Abs(col("x")), {"x": [-2.0, 3.0]}, NUM) == [2.0, 3.0]
    assert eval_expr(Pow(Const(2.0), Const(10.0)), {"x": [0.0]}, NUM) == \
        [1024.0]
    assert eval_expr(IsNaN(col("x")), {"x": [float("nan"), 1.0]}, NUM) == \
        [True, False]
    assert eval_expr(IsFinite(col("x")), {"x": [float("inf"), 1.0]}, NUM) == \
        [False, True]


def test_string_case_trim():
    data = {"s": ["  Hello ", "WORLD", None]}
    assert eval_expr(ToUpper(col("s")), data, STR) == ["  HELLO ", "WORLD",
                                                       None]
    assert eval_expr(ToLower(col("s")), data, STR) == ["  hello ", "world",
                                                       None]
    assert eval_expr(Trim(col("s")), data, STR) == ["Hello", "WORLD", None]


def test_string_length_substring():
    data = {"s": ["hello", "", None]}
    assert eval_expr(Length(col("s")), data, STR) == [5, 0, None]
    assert eval_expr(Substring(col("s"), Const(2), Const(3)), data, STR) == \
        ["ell", "", None]
    assert eval_expr(Substring(col("s"), Const(-3)), data, STR) == \
        ["llo", "", None]


def test_string_search_replace():
    data = {"s": ["banana", "apple"]}
    assert eval_expr(StringOffset(col("s"), Const("an")), data, STR) == [2, 0]
    assert eval_expr(StringContains(col("s"), Const("pp")), data, STR) == \
        [False, True]
    assert eval_expr(StringReplace(col("s"), Const("an"), Const("AN")),
                     data, STR) == ["bANANa", "apple"]


def test_concat():
    data = {"s": ["x", "y"]}
    assert eval_expr(Concat(Const("<"), col("s"), Const(">")), data, STR) == \
        ["<x>", "<y>"]
    assert eval_expr(Concat(Const("a"), Const(1), Const("b")), data, STR) == \
        ["a1b"] * 2


DT = TupleSchema.of(("t", DataType.DATETIME),)


def us(y, mo, d, h=0, mi=0, s=0):
    import datetime
    epoch = datetime.datetime(1970, 1, 1)
    return int((datetime.datetime(y, mo, d, h, mi, s) - epoch)
               .total_seconds()) * 1_000_000


def test_date_fields():
    data = {"t": [us(2001, 9, 9, 1, 46, 40), us(1969, 12, 31, 23, 0, 0)]}
    assert eval_expr(Year(col("t")), data, DT) == [2001, 1969]
    assert eval_expr(Month(col("t")), data, DT) == [9, 12]
    assert eval_expr(Day(col("t")), data, DT) == [9, 31]
    assert eval_expr(Hour(col("t")), data, DT) == [1, 23]
    assert eval_expr(Minute(col("t")), data, DT) == [46, 0]
    assert eval_expr(Second(col("t")), data, DT) == [40, 0]
    assert eval_expr(Quarter(col("t")), data, DT) == [3, 4]
    # 2001-09-09 was a Sunday (weekday 6, Monday=0); 1969-12-31 a Wednesday
    assert eval_expr(Weekday(col("t")), data, DT) == [6, 2]
    assert eval_expr(YearDay(col("t")), data, DT) == [252, 365]


def test_unix_roundtrip():
    data = {"t": [us(2001, 9, 9, 1, 46, 40)]}
    assert eval_expr(UnixTimestamp(col("t")), data, DT) == [1_000_000_000]
    assert eval_expr(UnixTimestamp(FromUnixTime(Const(123))),
                     {"t": [0]}, DT) == [123]


def test_makedate():
    S = TupleSchema.of(("y", INT64), ("m", INT64), ("d", INT64))
    # mkgmtime_int64 normalization (date_evaluators.cc:36-58): month 13
    # rolls into the next year, day past month-end extrapolates linearly
    data = {"y": [2020, 2020, 2021, 2021], "m": [2, 13, 2, 1],
            "d": [29, 1, 30, 0]}
    vals = eval_expr(MakeDate(col("y"), col("m"), col("d")), data, S)
    # MAKEDATE returns a DATETIME at UTC 0:00 (date_expressions.h:53-56)
    assert vals[0] == us(2020, 2, 29)
    assert vals[1] == us(2021, 1, 1)   # month 13 -> next January
    assert vals[2] == us(2021, 3, 2)   # Feb 30 -> Mar 2
    assert vals[3] == us(2020, 12, 31)  # day 0 -> last of prior month


def test_makedate_pre_epoch_signals():
    from supersonic_jax import Compute, ScanTable, Table, execute
    from supersonic_jax.ops.base import EvaluationError

    S = TupleSchema.of(("y", INT64), ("m", INT64), ("d", INT64))
    t = Table.from_data(S, {"y": [1969], "m": [12], "d": [31]})
    # reference: MakeDateFailer fails the evaluation on pre-1970 results
    # (date_evaluators.cc:271-287)
    import pytest

    with pytest.raises(EvaluationError):
        execute(Compute([MakeDate(col("y"), col("m"), col("d")).as_("x")],
                        ScanTable(t)))
    # ... while MakeDatetime turns the row into a NULL instead
    # (date_bound_expressions.cc:123-126)
    out = eval_expr(MakeDatetime(col("y"), col("m"), col("d"), Const(0),
                                 Const(0), Const(0)),
                    {"y": [1969], "m": [12], "d": [31]}, S)
    assert out == [None]


def test_add_days_months():
    data = {"t": [us(2020, 1, 31), us(2021, 1, 31)]}
    assert eval_expr(Day(AddDays(col("t"), Const(1))), data, DT) == [1, 1]
    out = eval_expr(AddMonths(col("t"), Const(1)), data, DT)
    # reference mkgmtime extrapolates, it does NOT clamp
    # (date_evaluators.cc:71-83): Jan 31 + 1mo = "Feb 31" = Mar 2/3
    assert out == [us(2020, 3, 2), us(2021, 3, 3)]


ST = TupleSchema.of(("v", INT64), ("f", BOOL))


def test_changed():
    data = {"v": [1, 1, 2, None, None, 2], "f": [False] * 6}
    assert eval_expr(Changed(col("v")), data, ST) == \
        [True, False, True, True, False, True]


def test_running_sum():
    # NULL inputs are ignored; output NULL only before the first non-NULL
    # value (reference: stateful_expressions.h:41-45)
    data = {"v": [None, 1, None, 2, 3], "f": [False] * 5}
    assert eval_expr(RunningSum(col("v")), data, ST) == [None, 1, 1, 3, 6]


def test_smudge():
    data = {"v": [None, 5, None, None, 7], "f": [False] * 5}
    assert eval_expr(Smudge(col("v")), data, ST) == [None, 5, 5, 5, 7]


def test_smudge_if():
    data = {"v": [1, 2, 3, 4], "f": [False, True, True, False]}
    assert eval_expr(SmudgeIf(col("v"), col("f")), data, ST) == [1, 1, 1, 4]


def test_running_min_with_flush():
    data = {"v": [5, 3, 7, 4, 9], "f": [False, False, True, False, False]}
    # flush after row 2 -> running min resets at row 3
    assert eval_expr(RunningMinWithFlush(col("f"), col("v")), data, ST) == \
        [5, 3, 3, 4, 4]


def test_stateful_multi_tile():
    # cross the 2048 segscan tile boundary (regression: carry poisoning)
    import numpy as np
    n = 5000
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 100, n).tolist()
    schema = TupleSchema.of(("v", INT64),)
    t = Table.from_data(schema, {"v": vals})
    out = execute(Compute(RunningSum(col("v")), ScanTable(t)))
    got = [r[0] for r in out.to_pylist()]
    import itertools
    exp = list(itertools.accumulate(vals))
    assert got == exp
    # smudge across tiles
    vals2 = [None if i % 7 else i for i in range(n)]
    t2 = Table.from_data(schema, {"v": vals2})
    out2 = execute(Compute(Smudge(col("v")), ScanTable(t2)))
    got2 = [r[0] for r in out2.to_pylist()]
    last = None
    exp2 = []
    for v in vals2:
        last = v if v is not None else last
        exp2.append(last)
    assert got2 == exp2


S2 = TupleSchema.of(("a", STRING), ("b", STRING))


def test_concat_two_columns():
    # reference: string_bound_expressions.cc BoundConcatExpression —
    # general concat of two non-constant columns (cross dictionary)
    data = {"a": ["x", "y", "x", None], "b": ["1", "2", "2", "1"]}
    assert eval_expr(Concat(col("a"), col("b")), data, S2) == \
        ["x1", "y2", "x2", None]


def test_concat_columns_with_separators():
    data = {"a": ["ab", "a"], "b": ["c", "bc"]}
    # overlapping combined values must dedupe to one code ("ab-c" twice
    # would be wrong here, but "ab"+""+"c" == "a"+""+"bc" must collapse)
    assert eval_expr(Concat(col("a"), col("b")), data, S2) == ["abc", "abc"]
    assert eval_expr(
        Concat(Const("<"), col("a"), Const("-"), col("b"), Const(">")),
        data, S2) == ["<ab-c>", "<a-bc>"]


def test_concat_three_columns_and_nulls():
    S3 = TupleSchema.of(("a", STRING), ("b", STRING), ("c", STRING))
    data = {"a": ["p", None, "q"], "b": ["1", "2", None], "c": ["u", "v", "w"]}
    assert eval_expr(Concat(col("a"), col("b"), col("c")), data, S3) == \
        ["p1u", None, None]


def test_concat_sort_on_result():
    # the cross dictionary must stay order-preserving: ORDER BY on the
    # concat output codes == ORDER BY on the strings
    from supersonic_jax import Sort, SortKey
    data = {"a": ["b", "a", "ab"], "b": ["c", "c", "b"]}
    t = Table.from_data(S2, data)
    out = execute(Sort([SortKey("cc")],
                       Compute(Concat(col("a"), col("b")).as_("cc"),
                               ScanTable(t))))
    assert [r[0] for r in out.to_pylist()] == ["abb", "ac", "bc"]


def test_format():
    from supersonic_jax import Format
    from supersonic_jax.types import TypeError_
    data = {"x": [1.0]}
    assert eval_expr(Format(Const(3.14159), Const(3)), data, NUM) == ["3.142"]
    assert eval_expr(Format(Const(2.5), Const(0)), data, NUM) == ["2"] or \
        eval_expr(Format(Const(2.5), Const(0)), data, NUM) == ["3"]
    # non-constant column: deferred-dictionary rendering (r4) — used to
    # raise TypeError_ pointing at the host path
    out = execute(Compute(Format(col("x"), Const(2)),
                          ScanTable(Table.from_data(NUM, data))))
    assert [r[0] for r in out.to_pylist()] == ["1.00"]


def test_host_format_number():
    from supersonic_jax.ops.host import format_number
    t = Table.from_data(NUM, {"x": [1.5, None, -0.25]})
    out = format_number(t, "x", 2, "fx")
    assert [r[-1] for r in out.to_pylist()] == ["1.50", None, "-0.25"]


def test_host_concat_columns():
    from supersonic_jax.ops.host import concat_columns
    t = Table.from_data(S2, {"a": ["x", None], "b": ["y", "z"]})
    out = concat_columns(t, ["a", "b"], "ab", separator="/")
    assert [r[-1] for r in out.to_pylist()] == ["x/y", None]


def test_long_tail_math():
    from supersonic_jax import (Atan2, CeilToInt, Cot, FloorToInt,
                                LogNulling, RoundWithMultiplier, TruncToInt)
    data = {"x": [2.5, -2.5, None]}
    assert eval_expr(CeilToInt(col("x")), data, NUM) == [3, -2, None]
    assert eval_expr(FloorToInt(col("x")), data, NUM) == [2, -3, None]
    assert eval_expr(TruncToInt(col("x")), data, NUM) == [2, -2, None]
    assert eval_expr(RoundWithMultiplier(col("x"), Const(2.0)), data,
                     NUM) == [2.5, -2.5, None]
    got = eval_expr(Atan2(col("x"), Const(1.0)), data, NUM)
    assert got[0] == pytest.approx(math.atan2(2.5, 1.0))
    got = eval_expr(Cot(Const(1.0)), {"x": [0.0]}, NUM)
    assert got[0] == pytest.approx(1 / math.tan(1.0))
    # LogNulling: domain errors -> NULL
    assert eval_expr(LogNulling(Const(2.0), col("x")), data, NUM) == \
        [pytest.approx(math.log2(2.5)), None, None]


def test_cast_policies():
    from supersonic_jax import CastNulling, CastSignaling, DataType
    from supersonic_jax import EvaluationError
    data = {"x": [100.0, 1e12, None]}
    # nulling: overflow of INT32 -> NULL
    assert eval_expr(CastNulling(DataType.INT32, col("x")), data, NUM) == \
        [100, None, None]
    with pytest.raises(EvaluationError):
        eval_expr(CastSignaling(DataType.INT32, col("x")), data, NUM)


def test_bitwise_andnot_and_date_to_datetime():
    from supersonic_jax import BitwiseAndNot, DataType, DateToDatetime
    I = TupleSchema.of(("a", INT64), ("b", INT64))
    assert eval_expr(BitwiseAndNot(col("a"), col("b")),
                     {"a": [0b1100], "b": [0b1010]}, I) == [0b0100]
    D = TupleSchema.of(("d", DataType.DATE),)
    # 2 days after epoch -> 1970-01-03T00:00:00 in microseconds
    assert eval_expr(DateToDatetime(col("d")), {"d": [2]}, D) == \
        [2 * 86_400 * 1_000_000]


def test_pow_policies():
    """Reference POW policies (expression_traits.h:1329-1370): the domain
    violation is negative base with NON-integer exponent."""
    from supersonic_jax import (Compute, PowNulling, PowQuiet, PowSignaling,
                                ScanTable, Table, execute)
    from supersonic_jax.ops.base import EvaluationError

    S = TupleSchema.of(("b", DOUBLE), ("e", DOUBLE))
    data = {"b": [2.0, -2.0, -2.0], "e": [3.0, 2.0, 0.5]}
    q = eval_expr(PowQuiet(col("b"), col("e")), data, S)
    assert q[0] == 8.0 and q[1] == 4.0 and math.isnan(q[2])
    n = eval_expr(PowNulling(col("b"), col("e")), data, S)
    assert n == [8.0, 4.0, None]
    t = Table.from_data(S, data)
    with pytest.raises(EvaluationError):
        execute(Compute([PowSignaling(col("b"), col("e")).as_("s")],
                        ScanTable(t)))


# --- deferred-dictionary rendering ------------------------------------------

def test_deferred_tostring_float_and_double():
    import numpy as np

    from supersonic_jax import (Compute, DataType, ScanTable, Table,
                                ToString, TupleSchema, col, execute)
    from supersonic_jax.ops.host import _fmt_double, _fmt_float

    rng = np.random.default_rng(0)
    f = np.concatenate([rng.random(40, dtype=np.float32) * 100,
                        np.float32([0.1, 2.0, 1e-7, -0.0, 1e30])])
    d = np.concatenate([rng.random(40) * 100,
                        np.array([0.1, 2.0, 1e-17, -0.0, 1e300])])
    t = Table.from_data(
        TupleSchema.of(("f", DataType.FLOAT, False),
                       ("d", DataType.DOUBLE, False)),
        {"f": f, "d": d})
    out = execute(Compute([ToString(col("f")).as_("sf"),
                           ToString(col("d")).as_("sd")], ScanTable(t)))
    rows = out.to_pylist()
    assert [r[0] for r in rows] == [_fmt_float(v) for v in f]
    assert [r[1] for r in rows] == [_fmt_double(v) for v in d]


def test_deferred_tostring_survives_downstream_row_movement():
    """Row-position codes index the dictionary, not the table: filtering
    and sorting AFTER the ToString must keep value<->string pairing."""
    import numpy as np

    from supersonic_jax import (Compute, Const, DataType, Filter,
                                ScanTable, Sort, Table, ToString,
                                TupleSchema, col, execute)

    rng = np.random.default_rng(1)
    v = rng.integers(-10**12, 10**12, 200)
    k = rng.integers(0, 50, 200).astype(np.int32)
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT32, False),
                       ("v", DataType.INT64, False)), {"k": k, "v": v})
    out = execute(Sort(
        [("k", True)],
        Filter(col("k") > Const(10, DataType.INT32),
               Compute([col("k").as_("k"), col("v").as_("v"),
                        ToString(col("v")).as_("sv")], ScanTable(t)))))
    for kk, vv, sv in out.to_pylist():
        assert sv == str(vv)


def test_deferred_format_column():
    import numpy as np

    from supersonic_jax import (Compute, DataType, Format, ScanTable,
                                Table, TupleSchema, col, execute)

    d = np.array([1.23456, -2.5, 0.0, 1e6, 0.125])
    t = Table.from_data(
        TupleSchema.of(("d", DataType.DOUBLE, False)), {"d": d})
    out = execute(Compute([Format(col("d"), 3).as_("s")], ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == \
        ["%.3f" % x for x in d]


def test_deferred_dateformat_matches_domain_lut():
    import numpy as np

    from supersonic_jax import (Compute, DataType, DateFormat, ScanTable,
                                Table, TupleSchema, col, execute)

    rng = np.random.default_rng(2)
    us = rng.integers(0, 2_000_000_000, 50) * np.int64(1_000_000)
    t = Table.from_data(
        TupleSchema.of(("t", DataType.DATETIME, False)), {"t": us})
    lut = execute(Compute(
        [DateFormat(col("t"), "%Y-%m-%d %H",
                    domain=(0, int(us.max()))).as_("s")], ScanTable(t)))
    deferred = execute(Compute(
        [DateFormat(col("t"), "%Y-%m-%d %H").as_("s")], ScanTable(t)))
    assert ([r[0] for r in deferred.to_pylist()]
            == [r[0] for r in lut.to_pylist()])


def test_makedate_signals_makedatetime_nulls():
    """Signaling parity: MAKEDATE of a pre-epoch
    date raises an evaluation failure (can_fail trait,
    expression_traits.h:1772; MakeDateFailer, date_evaluators.cc:271-287)
    while MAKEDATETIME sets the row NULL instead (the reference's
    BoundMakeDatetimeExpression folds the failure into the skip vector,
    date_bound_expressions.cc:123-131)."""
    import pytest

    from supersonic_jax import (Compute, DataType, ScanTable, Table,
                                TupleSchema, execute, col)
    from supersonic_jax.exprs import MakeDate, MakeDatetime
    from supersonic_jax.exprs.base import EvaluationError

    t = Table.from_data(
        TupleSchema.of(("y", DataType.INT64, False),
                       ("m", DataType.INT64, False),
                       ("d", DataType.INT64, False)),
        {"y": [1960, 2001], "m": [1, 3], "d": [1, 7]})
    with pytest.raises(EvaluationError, match="MAKEDATE"):
        execute(Compute([MakeDate(col("y"), col("m"), col("d")).as_("x")],
                        ScanTable(t)))
    out = execute(Compute(
        [MakeDatetime(col("y"), col("m"), col("d"),
                      col("m"), col("m"), col("m")).as_("x")],
        ScanTable(t)))
    rows = out.to_pylist()
    assert rows[0] == (None,)
    assert rows[1][0] is not None
