"""Local-timezone date expressions and device DateFormat.

Reference semantics: *Local operators and DateFormatLocal render through
localtime_r in the process timezone (date_evaluators.cc:204-210,249-265);
DateFormat renders through gmtime_r+strftime into a 33-byte buffer
(:227-247).  The oracle here is Python zoneinfo, which reads the same
/usr/share/zoneinfo database glibc uses; engine-vs-real-C++ agreement is
additionally golden-tested in test_golden.py (date_local case).
"""
import datetime
import zoneinfo

import numpy as np
import pytest

from supersonic_jax import (Compute, DataType, DateFormat, DateFormatLocal,
                            HourLocal, MinuteLocal, MonthLocal, ScanTable,
                            SecondLocal, Table, TupleSchema, WeekdayLocal,
                            YearDayLocal, YearLocal, col, execute,
                            set_local_timezone)
from supersonic_jax.exprs import tz
from supersonic_jax.ops.base import EvaluationError
from supersonic_jax.types import TypeError_


@pytest.fixture
def local_tz():
    """Set a timezone for the test, restore the default afterwards."""

    def setter(name):
        set_local_timezone(name)
        return name

    yield setter
    set_local_timezone(None)


def _rows(res):
    names = [a.name for a in res.schema]
    return [dict(zip(names, r)) for r in res.to_pylist()]


def _dt_table(ts_sec):
    return Table.from_data(
        TupleSchema.of(("t", DataType.DATETIME)),
        {"t": [int(s) * 1_000_000 for s in ts_sec]})


# DST spring-forward/fall-back instants (2024, America/New_York) plus
# pre-epoch, LMT-era (1906: -4:56:02!), and far-future POSIX-rule times.
NY_PROBES = [0, -1, -2_000_000_000, 1710050399, 1710050400, 1710053999,
             1710054000, 1730613599, 1730613600, 2145916800]


@pytest.mark.parametrize("zone,probes", [
    ("America/New_York", NY_PROBES),
    ("Asia/Kathmandu", [0, 504901800 - 1, 504901800, 1700000000]),  # +5:45
    ("Australia/Lord_Howe", [1712417400 - 1, 1712417400,
                             1759595400 - 1, 1759595400]),  # 30-min DST
])
def test_local_fields_match_zoneinfo(local_tz, zone, probes):
    local_tz(zone)
    z = zoneinfo.ZoneInfo(zone)
    rng = np.random.default_rng(7)
    secs = list(probes) + list(rng.integers(-10**9, 2**31, 64))
    res = execute(Compute(
        [YearLocal(col("t")).as_("y"), MonthLocal(col("t")).as_("mo"),
         HourLocal(col("t")).as_("h"), MinuteLocal(col("t")).as_("mi"),
         SecondLocal(col("t")).as_("s"), WeekdayLocal(col("t")).as_("wd"),
         YearDayLocal(col("t")).as_("yd")],
        ScanTable(_dt_table(secs))))
    for sec, r in zip(secs, _rows(res)):
        loc = datetime.datetime.fromtimestamp(int(sec), z)
        assert (r["y"], r["mo"], r["h"], r["mi"], r["s"]) == (
            loc.year, loc.month, loc.hour, loc.minute, loc.second), sec
        assert r["wd"] == loc.weekday(), sec
        assert r["yd"] == loc.timetuple().tm_yday, sec


def test_local_is_utc_by_default(local_tz):
    local_tz("UTC")
    assert tz.current_tables() is None  # zero-cost alias path
    res = execute(Compute([HourLocal(col("t")).as_("h")],
                          ScanTable(_dt_table([3600 * 5]))))
    assert _rows(res)[0]["h"] == 5


def test_dateformat_utc_formats(local_tz):
    secs = [0, 86399, 86400, 1700000000]
    lo, hi = 0, 1700000000 * 1_000_000
    res = execute(Compute(
        [DateFormat(col("t"), "%Y/%m/%d", domain=(lo, hi)).as_("d"),
         DateFormat(col("t"), "%Y-%m-%d %H", domain=(lo, hi)).as_("h")],
        ScanTable(_dt_table(secs))))
    for sec, r in zip(secs, _rows(res)):
        utc = datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=sec)
        assert r["d"] == utc.strftime("%Y/%m/%d")
        assert r["h"] == utc.strftime("%Y-%m-%d %H")


def test_dateformat_granule_inference():
    from supersonic_jax.exprs.date import _format_granule_sec

    assert _format_granule_sec("%Y/%m/%d") == 86_400
    assert _format_granule_sec("%H o'clock") == 3600
    assert _format_granule_sec("%R") == 60
    assert _format_granule_sec("%T") == 1
    assert _format_granule_sec("100%% %d") == 86_400  # %% is literal


def test_dateformat_dictionary_dedups():
    # minute-granularity "%H:%M" over 3 days -> 1440 distinct strings
    e = DateFormat(col("t"), "%H:%M",
                   domain=(0, 3 * 86400 * 1_000_000))
    b = e.bind(TupleSchema.of(("t", DataType.DATETIME)), {})
    assert len(b.dictionary) == 1440
    assert b.dictionary.is_sorted()


def test_dateformat_over_32_chars_is_empty():
    # reference renders into a 33-byte buffer; longer output -> ""
    fmt = "the %Y year of %B the month of it"  # > 32 chars rendered
    res = execute(Compute(
        [DateFormat(col("t"), fmt, domain=(0, 86400 * 1_000_000)).as_("f")],
        ScanTable(_dt_table([100]))))
    assert _rows(res)[0]["f"] == ""


def test_dateformat_local_dst(local_tz):
    local_tz("America/New_York")
    z = zoneinfo.ZoneInfo("America/New_York")
    secs = [1710050399, 1710054000, 1730613599, 1730613600]
    lo, hi = min(secs) * 1_000_000, max(secs) * 1_000_000
    res = execute(Compute(
        [DateFormatLocal(col("t"), "%Y-%m-%d %H:%M",
                         domain=(lo, hi)).as_("f")],
        ScanTable(_dt_table(secs))))
    for sec, r in zip(secs, _rows(res)):
        loc = datetime.datetime.fromtimestamp(sec, z)
        assert r["f"] == loc.strftime("%Y-%m-%d %H:%M"), sec


def test_dateformat_date_input():
    t = Table.from_data(TupleSchema.of(("d", DataType.DATE)),
                        {"d": [0, 11016, None]})
    res = execute(Compute(
        [DateFormat(col("d"), "%a %Y-%j", domain=(0, 24800)).as_("f")],
        ScanTable(t)))
    rows = _rows(res)
    assert rows[0]["f"] == "Thu 1970-001"
    assert rows[1]["f"] == (datetime.date(1970, 1, 1)
                            + datetime.timedelta(days=11016)
                            ).strftime("%a %Y-%j")
    assert rows[2]["f"] is None


def test_dateformat_out_of_domain_raises():
    res_plan = Compute(
        [DateFormat(col("t"), "%Y", domain=(0, 86400 * 1_000_000)).as_("f")],
        ScanTable(_dt_table([2 * 86400])))
    with pytest.raises(EvaluationError):
        execute(res_plan)


def test_dateformat_rejects_nonconst_and_over_budget():
    schema = TupleSchema.of(("t", DataType.DATETIME))
    # unbounded (no domain) now binds via the deferred-dictionary path
    # (r4); only non-constant formats and over-budget domains reject
    b = DateFormat(col("t"), "%Y").bind(schema, {})
    assert b.type == DataType.STRING
    with pytest.raises(TypeError_):
        DateFormat(col("t"), col("t"))
    with pytest.raises(TypeError_):  # budget: seconds over 100 years
        DateFormat(col("t"), "%T",
                   domain=(0, 2**31 * 1_000_000)).bind(schema, {})


def test_dateformat_local_rejects_zone_directives(local_tz):
    local_tz("America/New_York")
    with pytest.raises(TypeError_):
        DateFormatLocal(col("t"), "%H %Z", domain=(0, 10**9)).bind(
            TupleSchema.of(("t", DataType.DATETIME)), {})


def test_tz_tables_cover_32bit_time_t():
    tt = tz._compile("America/New_York")
    assert tt is not None
    assert len(tt.off_before) == tz.NDAYS
    # transitions found, and at most one per day by construction
    assert (tt.switch_sec != 86400).sum() > 100


def test_local_shift_host_matches_device(local_tz):
    local_tz("Australia/Lord_Howe")
    tt = tz.current_tables()
    rng = np.random.default_rng(3)
    secs = rng.integers(-10**9, 2**31, 32)
    import jax.numpy as jnp

    dev = np.asarray(tz.local_shift(
        jnp.asarray(secs * 1_000_000, dtype=jnp.int64), tt))
    for s, d in zip(secs, dev):
        assert int(d) == tz.local_shift_host(int(s) * 1_000_000, tt)
