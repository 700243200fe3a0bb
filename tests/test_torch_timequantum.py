"""The port's time quantum module against the JAX package's, on the same
seeded timestamps and ranges, for every valid quantum: the views a write
lands in (``views_by_time``), the minimal view cover of a range
(``views_by_time_range``, which walks up the units and back down), the
quantum's validation and ``parse_time``.  No tolerance: view names are
strings."""

from __future__ import annotations

import datetime as dt

import numpy as np
import pytest

from pilosa_tpu.models import timequantum as jtq
from pilosa_tpu_torch.models import timequantum as ttq

_T0 = dt.datetime(2019, 11, 28)


def _stamp(rng) -> dt.datetime:
    """Hours over three years, with a bias to month ends and year ends,
    where the cover's edge cases are."""
    if rng.random() < 0.3:
        day = dt.datetime(int(rng.integers(2019, 2023)),
                          int(rng.integers(1, 13)), 1)
        return day - dt.timedelta(hours=int(rng.integers(0, 80)))
    return _T0 + dt.timedelta(hours=int(rng.integers(0, 3 * 366 * 24)),
                              minutes=int(rng.integers(0, 60)))


def _outcome(fn, start, end, q):
    """A cover, or the error it raises (the reference's year step raises
    from Feb 29)."""
    try:
        return "ok", fn("standard", start, end, q)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("quantum", sorted(jtq.VALID_QUANTUMS))
def test_views_and_covers_match_the_reference(quantum):
    rng = np.random.default_rng(sum(map(ord, quantum)) + 17)
    jq, tq = jtq.TimeQuantum(quantum), ttq.TimeQuantum(quantum)
    assert (tq, tq.has_year, tq.has_month, tq.has_day, tq.has_hour) == (
        jq, jq.has_year, jq.has_month, jq.has_day, jq.has_hour)
    for _ in range(200):
        t = _stamp(rng)
        assert ttq.views_by_time("standard", t, tq) == jtq.views_by_time(
            "standard", t, jq)
    # an hour quantum lists a view per hour: keep its spans short
    span_h = 45 * 24 if "H" in quantum else 3 * 366 * 24
    covers = 0
    for _ in range(300):
        a = _stamp(rng)
        b = a + dt.timedelta(hours=int(rng.integers(0, span_h)),
                             minutes=int(rng.integers(0, 60)))
        if rng.random() < 0.3:  # whole days, months and years
            a = a.replace(hour=0, minute=0)
            b = b.replace(day=1, hour=0, minute=0) if rng.random() < 0.5 \
                else b.replace(hour=0, minute=0)
        for start, end in ((a, b), (b, a), (a, a)):
            want = _outcome(jtq.views_by_time_range, start, end, jq)
            assert _outcome(ttq.views_by_time_range, start, end,
                            tq) == want
            covers += bool(want[1])
    assert covers > 0 or quantum == ""
    for s in ("2024-02-29T13:45", 1706745600, _T0):
        assert ttq.parse_time(s) == jtq.parse_time(s)
    for bad in ("2024-02-30T00:00", 3.5):
        with pytest.raises(ValueError) as want:
            jtq.parse_time(bad)
        with pytest.raises(ValueError) as got:
            ttq.parse_time(bad)
        assert str(got.value) == str(want.value)
    for bad in ("YD", "HY", "x"):
        with pytest.raises(ValueError):
            jtq.TimeQuantum(bad)
        with pytest.raises(ValueError):
            ttq.TimeQuantum(bad)
