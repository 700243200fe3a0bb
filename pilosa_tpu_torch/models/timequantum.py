"""Time quantum: decompose timestamps into per-granularity views.

Copy of pilosa_tpu/models/timequantum.py.  A quantum is a subset of
"YMDH"; a write at time t lands in one view per enabled unit
(time.go:91 viewsByTime), and a range query computes the minimal set of
views covering [start, end) by walking up unit granularities then back
down (time.go:104-180 viewsByTimeRange).
"""

from __future__ import annotations

import datetime as _dt

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}

# Reference wire format for timestamps (pilosa.go TimeFormat).
TIME_FORMAT = "%Y-%m-%dT%H:%M"


class TimeQuantum(str):
    """A time granularity string: subset of 'YMDH' in order."""

    def __new__(cls, value: str = ""):
        if value not in VALID_QUANTUMS:
            raise ValueError(f"invalid time quantum: {value!r}")
        return super().__new__(cls, value)

    @property
    def has_year(self) -> bool:
        return "Y" in self

    @property
    def has_month(self) -> bool:
        return "M" in self

    @property
    def has_day(self) -> bool:
        return "D" in self

    @property
    def has_hour(self) -> bool:
        return "H" in self


_UNIT_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def view_by_time_unit(name: str, t: _dt.datetime, unit: str) -> str:
    """View name for one quantum unit, e.g. standard_2017 / standard_201701."""
    return f"{name}_{t.strftime(_UNIT_FMT[unit])}"


def views_by_time(name: str, t: _dt.datetime, q: TimeQuantum) -> list[str]:
    """All views a write at time t lands in (one per enabled unit)."""
    return [view_by_time_unit(name, t, u) for u in q]


def _add_month(t: _dt.datetime) -> _dt.datetime:
    # For day > 28, first snap to the 1st so adding a month never skips one
    # (the reference's addMonth edge case, time.go:180-189).
    if t.day > 28:
        t = t.replace(day=1)
    if t.month == 12:
        return t.replace(year=t.year + 1, month=1)
    return t.replace(month=t.month + 1)


def _add_year(t: _dt.datetime) -> _dt.datetime:
    return t.replace(year=t.year + 1)


def _next_year_gte(t: _dt.datetime, end: _dt.datetime) -> bool:
    nxt = _add_year(t)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: _dt.datetime, end: _dt.datetime) -> bool:
    nxt = _true_add_month(t)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _true_add_month(t: _dt.datetime) -> _dt.datetime:
    # Go's AddDate(0,1,0) with normalization (Jan 31 + 1mo = Mar 2/3).
    y, m = t.year, t.month + 1
    if m > 12:
        y, m = y + 1, 1
    # days overflow normalizes into the following month, like Go.
    try:
        return t.replace(year=y, month=m)
    except ValueError:
        first = _dt.datetime(y, m, 1, t.hour, t.minute, t.second)
        return first + _dt.timedelta(days=t.day - 1)


def _next_day_gte(t: _dt.datetime, end: _dt.datetime) -> bool:
    nxt = t + _dt.timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) or end > nxt


def views_by_time_range(
    name: str, start: _dt.datetime, end: _dt.datetime, q: TimeQuantum
) -> list[str]:
    """Minimal view cover of [start, end): coarse views in the middle,
    fine views at the ragged edges (reference time.go:104-180)."""
    t = start
    results: list[str] = []

    # Walk up from smallest units to largest.
    if q.has_hour or q.has_day or q.has_month:
        while t < end:
            if q.has_hour:
                if not _next_day_gte(t, end):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += _dt.timedelta(hours=1)
                    continue
            if q.has_day:
                if not _next_month_gte(t, end):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t += _dt.timedelta(days=1)
                    continue
            if q.has_month:
                if not _next_year_gte(t, end):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk back down from largest units to smallest.
    while t < end:
        if q.has_year and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_year(t)
        elif q.has_month and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif q.has_day and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t += _dt.timedelta(days=1)
        elif q.has_hour:
            results.append(view_by_time_unit(name, t, "H"))
            t += _dt.timedelta(hours=1)
        else:
            break

    return results


def parse_time(value) -> _dt.datetime:
    """Parse a PQL timestamp: 'YYYY-MM-DDTHH:MM' string or unix seconds int
    (reference time.go parseTime)."""
    if isinstance(value, _dt.datetime):
        return value
    if isinstance(value, str):
        try:
            return _dt.datetime.strptime(value, TIME_FORMAT)
        except ValueError as e:
            raise ValueError(f"cannot parse string time: {value!r}") from e
    if isinstance(value, int):
        return _dt.datetime.fromtimestamp(value, _dt.timezone.utc).replace(tzinfo=None)
    raise ValueError(f"cannot parse time from {type(value).__name__}")
