"""Bind-time timezone compilation for the ``*Local`` date expressions.

Reference semantics: the ``*Local`` operators (YearLocal .. SecondLocal,
DateFormatLocal) call ``localtime_r`` — i.e. they render in the process's
local timezone, selected by the TZ environment variable
(reference: expression/core/date_evaluators.cc:204-210,249-265).

Device redesign: a timezone is *compiled at bind time* into day-granular
LUTs from IANA tzdata (Python ``zoneinfo`` reads the same
/usr/share/zoneinfo database glibc's localtime_r uses), and the local
shift on device is one packed 3-lane int32 gather plus a select:

    local_us(us)   = us + utc_offset(us) * 1_000_000
    utc_offset(us) = off_after[day]  if us_in_day >= switch_sec[day]*1e6
                     off_before[day] otherwise

POSIX defines localtime exactly this way (gmtime of ``t + utcoff(t)``),
so every UTC field/format operator applied to ``local_us`` reproduces
localtime_r bit-for-bit.  The LUT spans the full 32-bit time_t range the
reference can represent (65536 days: 1901-12-13 .. 2081-05-29); days
outside clamp to the edge rule, matching zoneinfo's POSIX-rule
extrapolation for future dates.  At most one UTC-offset transition per
civil day is supported — true of the entire tzdata database (DST shifts
happen at most once a day).
"""
from __future__ import annotations

import datetime
import functools
import os
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

US_PER_SEC = 1_000_000
US_PER_DAY = 86_400 * US_PER_SEC
SEC_PER_DAY = 86_400

# Full signed-32-bit time_t coverage, 65536 days (fits the small-LUT
# gather kernel's entry cap exactly): day -24855 == 1901-12-13.
DAY0 = -24855
NDAYS = 65536


class TzTables(NamedTuple):
    """Compiled timezone: per-day offset rule (host numpy arrays)."""

    name: str
    off_before: np.ndarray  # int32 [NDAYS] seconds east of UTC at day start
    off_after: np.ndarray   # int32 [NDAYS] seconds after the day's switch
    switch_sec: np.ndarray  # int32 [NDAYS] sec-of-day of the switch
    #                         (SEC_PER_DAY when the day has no transition)


_local_tz_name: Optional[str] = None  # None -> TZ env var, else "UTC"


def set_local_timezone(name: Optional[str]) -> None:
    """Select the timezone the ``*Local`` expressions bind against
    (None restores the default: the TZ environment variable, else UTC —
    the reference's localtime_r contract)."""
    global _local_tz_name
    if name is not None:
        _compile(name)  # validate eagerly
    _local_tz_name = name


def get_local_timezone() -> str:
    if _local_tz_name is not None:
        return _local_tz_name
    return os.environ.get("TZ") or "UTC"


def _offset_at(tz, ts: int) -> int:
    dt = datetime.datetime.fromtimestamp(ts, tz)
    return int(dt.utcoffset().total_seconds())


@functools.lru_cache(maxsize=8)
def _compile(name: str) -> Optional[TzTables]:
    """Compile tzdata into per-day LUTs; None for fixed-zero zones."""
    import zoneinfo

    if name.upper() in ("UTC", "GMT", "UTC0", "GMT0"):
        return None
    tz = zoneinfo.ZoneInfo(name)
    # UTC offset at the start of each LUT day (+1 for the final boundary)
    starts = (np.arange(DAY0, DAY0 + NDAYS + 1, dtype=np.int64)
              * SEC_PER_DAY)
    offs = np.fromiter((_offset_at(tz, int(t)) for t in starts),
                       dtype=np.int64, count=NDAYS + 1)
    if not offs.any():
        return None  # fixed-zero alias (Etc/UTC, ...)
    off_before = offs[:-1].astype(np.int32)
    off_after = off_before.copy()
    switch_sec = np.full(NDAYS, SEC_PER_DAY, dtype=np.int32)
    for i in np.nonzero(offs[:-1] != offs[1:])[0]:
        # binary-search the transition instant within day i (1s grain;
        # tzdata transitions are whole-second aligned)
        lo, hi = int(starts[i]), int(starts[i + 1])
        pre = int(offs[i])
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if _offset_at(tz, mid) == pre:
                lo = mid
            else:
                hi = mid
        if _offset_at(tz, hi) != int(offs[i + 1]):
            raise ValueError(
                f"timezone {name}: more than one UTC-offset transition "
                f"in day {DAY0 + i} — unsupported")
        off_after[i] = np.int32(offs[i + 1])
        switch_sec[i] = np.int32(hi - int(starts[i]))
    return TzTables(name, off_before, off_after, switch_sec)


def current_tables() -> Optional[TzTables]:
    """The compiled timezone the next ``*Local`` bind captures
    (None == UTC: the Local op is the plain UTC op).  An unresolvable TZ
    environment value (e.g. a raw POSIX rule string, which zoneinfo does
    not parse) falls back to UTC; explicitly-set zones raise."""
    try:
        return _compile(get_local_timezone())
    except Exception:
        if _local_tz_name is not None:
            raise
        return None


def local_shift(us: jnp.ndarray, tzt: TzTables) -> jnp.ndarray:
    """Device computation: UTC microseconds -> local-civil microseconds.
    One packed 3-lane gather over the day LUT + one select."""
    from ..batch import gather_arrays

    day = jnp.floor_divide(us.astype(jnp.int64), US_PER_DAY)
    idx = jnp.clip(day - DAY0, 0, NDAYS - 1).astype(jnp.int32)
    ob, oa, sw = gather_arrays(
        [jnp.asarray(tzt.off_before), jnp.asarray(tzt.off_after),
         jnp.asarray(tzt.switch_sec)], idx)
    us_in_day = us.astype(jnp.int64) - day * US_PER_DAY
    off = jnp.where(us_in_day >= sw.astype(jnp.int64) * US_PER_SEC,
                    oa, ob)
    return us.astype(jnp.int64) + off.astype(jnp.int64) * US_PER_SEC


def local_shift_host(us: int, tzt: Optional[TzTables]) -> int:
    """Host mirror of local_shift (differential tests, host fallbacks)."""
    if tzt is None:
        return int(us)
    day = us // US_PER_DAY
    i = min(max(day - DAY0, 0), NDAYS - 1)
    sec = (us - day * US_PER_DAY) // US_PER_SEC
    off = (int(tzt.off_after[i]) if sec >= int(tzt.switch_sec[i])
           else int(tzt.off_before[i]))
    return int(us) + off * US_PER_SEC
