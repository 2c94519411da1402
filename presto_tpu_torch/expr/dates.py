"""Civil-date arithmetic on device tensors.

DATE is int32 days since 1970-01-01. These are branch-free integer
algorithms (Howard Hinnant's civil_from_days) over int64 tensors, so
they run as element-wise kernels on whatever device the input lives
on. (Reference surface: presto-main operator/scalar/
DateTimeFunctions.java — year/month/day/quarter/extract.)

torch's `//` floors and `%` takes the divisor's sign, as jnp's do, so
the formulas carry over from the JAX package unchanged.
"""

from __future__ import annotations

import datetime

import torch

EPOCH = datetime.date(1970, 1, 1).toordinal()


def date_to_days(d: datetime.date) -> int:
    return d.toordinal() - EPOCH


def days_to_date(days: int) -> datetime.date:
    """Physical epoch-days value -> datetime.date (the one wire-format
    decoder)."""
    return datetime.date.fromordinal(days + EPOCH)


def parse_date_literal(text: str) -> int:
    return date_to_days(datetime.date.fromisoformat(text.strip()))


def _i64(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, int):
        return torch.full_like(like, x, dtype=torch.int64)
    return x.to(torch.int64)


def civil_from_days(z: torch.Tensor):
    """days since epoch -> (year, month, day), vectorized."""
    z = z.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    year = torch.where(m <= 2, y + 1, y)
    return year, m, d


def extract_year(days):
    return civil_from_days(days)[0]


def extract_month(days):
    return civil_from_days(days)[1]


def extract_day(days):
    return civil_from_days(days)[2]


def extract_quarter(days):
    return (civil_from_days(days)[1] - 1) // 3 + 1


def extract_dow(days):
    """ISO day of week 1=Monday..7=Sunday (Presto day_of_week)."""
    return (days.to(torch.int64) + 3) % 7 + 1


def extract_doy(days):
    y, _, _ = civil_from_days(days)
    jan1 = days_from_civil(y, 1, 1)
    return days.to(torch.int64) - jan1 + 1


def days_from_civil(y, m, d):
    """(year, month, day) -> days since epoch, vectorized inverse.
    At least one argument is a tensor; plain ints broadcast."""
    like = next(t for t in (y, m, d) if not isinstance(t, int))
    y, m, d = _i64(y, like), _i64(m, like), _i64(d, like)
    y = y - (m <= 2).to(torch.int64)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _is_leap(y):
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


def days_in_month(y, m):
    table = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         dtype=torch.int64, device=m.device)
    base = table[m - 1]
    return torch.where((m == 2) & _is_leap(y), torch.full_like(base, 29),
                       base)


def add_months(days, n):
    """DATE + n months, day-of-month clamped to the target month's
    length (Presto date_add('month', ...) semantics)."""
    y, m, d = civil_from_days(days)
    total = y * 12 + (m - 1) + _i64(n, y)
    y2 = total // 12
    m2 = total - y2 * 12 + 1
    d2 = torch.minimum(d, days_in_month(y2, m2))
    return days_from_civil(y2, m2, d2)


def last_day_of_month(days):
    y, m, _ = civil_from_days(days)
    return days_from_civil(y, m, days_in_month(y, m))


def extract_day_of_month(days):
    return extract_day(days)


def _iso_week_parts(days):
    """(iso_year, iso_week): ISO-8601 week containing this date (the
    week of its Thursday)."""
    z = days.to(torch.int64)
    thursday = z - (extract_dow(z) - 1) + 3
    y = civil_from_days(thursday)[0]
    jan1 = days_from_civil(y, 1, 1)
    week = (thursday - jan1) // 7 + 1
    return y, week


def extract_week(days):
    return _iso_week_parts(days)[1]


def extract_year_of_week(days):
    return _iso_week_parts(days)[0]


def months_between(a, b, a_tie=None, b_tie=None):
    """Truncating month difference b - a (Presto date_diff('month')).

    Day-of-month comparisons CLAMP to the target month's length (Jan 31
    -> Feb 29 counts as one full month); `a_tie`/`b_tie` are optional
    same-unit tie-breakers (time of day for timestamps) that decide the
    partial-month test when the clamped days are equal."""
    ya, ma, da = civil_from_days(a)
    yb, mb, db = civil_from_days(b)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    if a_tie is None:
        a_tie = torch.zeros_like(da)
        b_tie = torch.zeros_like(db)
    # forward: not a full month if b's (clamped) day falls short of a's
    da_c = torch.minimum(da, days_in_month(yb, mb))
    short_fwd = (db < da_c) | ((db == da_c) & (b_tie < a_tie))
    months = months - ((months > 0) & short_fwd).to(torch.int64)
    # backward symmetric
    db_c = torch.minimum(db, days_in_month(ya, ma))
    short_bwd = (da < db_c) | ((da == db_c) & (a_tie < b_tie))
    months = months + ((months < 0) & short_bwd).to(torch.int64)
    return months
