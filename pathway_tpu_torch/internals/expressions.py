"""Expression method namespaces: ``.dt``, ``.str``, ``.num``.

Capability parity with reference ``python/pathway/internals/expressions/``
(datetime 1613 LoC, string 931, numerical 212) in a compact functional form:
each method builds a :class:`MethodCallExpression` over the wrapped
expression.
"""

from __future__ import annotations

import datetime as _dtm
import math
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    MethodCallExpression,
    _wrap,
)


class _Namespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _m(self, name: str, fun: Any, ret: Any, *extra: Any, propagate_none: bool = True) -> ColumnExpression:
        return MethodCallExpression(
            name, fun, ret, self._expr, *[_wrap(e) for e in extra], propagate_none=propagate_none
        )


class StringNamespace(_Namespace):
    """``expr.str`` methods (reference ``expressions/string.py``).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... s
    ... Hello
    ... World
    ... ''')
    >>> out = t.select(up=t.s.str.upper(), n=t.s.str.len())
    >>> pw.debug.compute_and_print(out, include_id=False)
    up      | n
    'HELLO' | 5
    'WORLD' | 5
    """

    def lower(self) -> ColumnExpression:
        return self._m("str.lower", lambda s: s.lower(), dt.STR)

    def upper(self) -> ColumnExpression:
        return self._m("str.upper", lambda s: s.upper(), dt.STR)

    def reversed(self) -> ColumnExpression:
        return self._m("str.reversed", lambda s: s[::-1], dt.STR)

    def len(self) -> ColumnExpression:
        return self._m("str.len", len, dt.INT)

    # NOTE: optional arguments with a None default are baked into the lambda
    # instead of passed as operands — MethodCallExpression propagates None
    # operands to a None result, which would wipe out every row.
    def strip(self, chars: Any = None) -> ColumnExpression:
        if chars is None:
            return self._m("str.strip", lambda s: s.strip(), dt.STR)
        return self._m("str.strip", lambda s, c: s.strip(c), dt.STR, chars)

    def lstrip(self, chars: Any = None) -> ColumnExpression:
        if chars is None:
            return self._m("str.lstrip", lambda s: s.lstrip(), dt.STR)
        return self._m("str.lstrip", lambda s, c: s.lstrip(c), dt.STR, chars)

    def rstrip(self, chars: Any = None) -> ColumnExpression:
        if chars is None:
            return self._m("str.rstrip", lambda s: s.rstrip(), dt.STR)
        return self._m("str.rstrip", lambda s, c: s.rstrip(c), dt.STR, chars)

    def count(self, sub: Any) -> ColumnExpression:
        return self._m("str.count", lambda s, x: s.count(x), dt.INT, sub)

    def find(self, sub: Any, start: Any = 0, end: Any = None) -> ColumnExpression:
        if end is None:
            return self._m("str.find", lambda s, x, a: s.find(x, a), dt.INT, sub, start)
        return self._m("str.find", lambda s, x, a, b: s.find(x, a, b), dt.INT, sub, start, end)

    def rfind(self, sub: Any, start: Any = 0, end: Any = None) -> ColumnExpression:
        if end is None:
            return self._m("str.rfind", lambda s, x, a: s.rfind(x, a), dt.INT, sub, start)
        return self._m("str.rfind", lambda s, x, a, b: s.rfind(x, a, b), dt.INT, sub, start, end)

    def startswith(self, prefix: Any) -> ColumnExpression:
        return self._m("str.startswith", lambda s, p: s.startswith(p), dt.BOOL, prefix)

    def endswith(self, suffix: Any) -> ColumnExpression:
        return self._m("str.endswith", lambda s, p: s.endswith(p), dt.BOOL, suffix)

    def swapcase(self) -> ColumnExpression:
        return self._m("str.swapcase", lambda s: s.swapcase(), dt.STR)

    def title(self) -> ColumnExpression:
        return self._m("str.title", lambda s: s.title(), dt.STR)

    def replace(self, old: Any, new: Any, count: Any = -1) -> ColumnExpression:
        return self._m("str.replace", lambda s, o, n, c: s.replace(o, n, c), dt.STR, old, new, count)

    def split(self, sep: Any = None, maxsplit: Any = -1) -> ColumnExpression:
        if sep is None:
            return self._m(
                "str.split", lambda s, m: tuple(s.split(None, m)), dt.List(dt.STR), maxsplit
            )
        return self._m(
            "str.split", lambda s, p, m: tuple(s.split(p, m)), dt.List(dt.STR), sep, maxsplit
        )

    def slice(self, start: Any, end: Any) -> ColumnExpression:
        return self._m("str.slice", lambda s, a, b: s[a:b], dt.STR, start, end)

    # NOTE: the ``_opt`` method-name suffix and the extra const operands
    # (true/false value sets, datetime format, timestamp scale) exist so
    # the expression VM can lower these by (name, arity) — see
    # expr_vm._METHOD_IDS; the lambdas remain the semantic ground truth.
    def parse_int(self, optional: bool = False) -> ColumnExpression:
        def parse(s: str) -> int | None:
            try:
                return int(s)
            except ValueError:
                if optional:
                    return None
                raise

        name = "str.parse_int_opt" if optional else "str.parse_int"
        return self._m(name, parse, dt.Optional(dt.INT) if optional else dt.INT)

    def parse_float(self, optional: bool = False) -> ColumnExpression:
        def parse(s: str) -> float | None:
            try:
                return float(s)
            except ValueError:
                if optional:
                    return None
                raise

        name = "str.parse_float_opt" if optional else "str.parse_float"
        return self._m(name, parse, dt.Optional(dt.FLOAT) if optional else dt.FLOAT)

    def parse_bool(self, true_values: Any = ("on", "true", "yes", "1"), false_values: Any = ("off", "false", "no", "0"), optional: bool = False) -> ColumnExpression:
        tv = tuple(v.lower() for v in true_values)
        fv = tuple(v.lower() for v in false_values)

        def parse(s: str, tvs: tuple, fvs: tuple) -> bool | None:
            low = s.lower()
            if low in tvs:
                return True
            if low in fvs:
                return False
            if optional:
                return None
            raise ValueError(f"Cannot parse {s!r} as bool")

        name = "str.parse_bool_opt" if optional else "str.parse_bool"
        return self._m(name, parse, dt.Optional(dt.BOOL) if optional else dt.BOOL, tv, fv)

    def parse_datetime(self, fmt: str, contains_timezone: bool = False) -> ColumnExpression:
        return self._m(
            "str.parse_datetime",
            lambda s, f: _dtm.datetime.strptime(s, f),
            dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE,
            fmt,
        )


class NumericalNamespace(_Namespace):
    """``expr.num`` methods (reference ``expressions/numerical.py``).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... x
    ... -3
    ... 2
    ... ''')
    >>> pw.debug.compute_and_print(t.select(a=t.x.num.abs()), include_id=False)
    a
    2
    3
    """

    def abs(self) -> ColumnExpression:
        return self._m("num.abs", abs, self._expr._dtype)

    def round(self, decimals: Any = 0) -> ColumnExpression:
        return self._m("num.round", lambda x, d: round(x, d), self._expr._dtype, decimals)

    def fill_na(self, default_value: Any) -> ColumnExpression:
        def fill(x: Any, d: Any) -> Any:
            if x is None:
                return d
            if isinstance(x, float) and math.isnan(x):
                return d
            return x

        return self._m("num.fill_na", fill, dt.unoptionalize(self._expr._dtype), default_value, propagate_none=False)


_UTC = _dtm.timezone.utc


class DateTimeNamespace(_Namespace):
    """``expr.dt`` methods over datetimes and durations (reference
    ``expressions/date_time.py``).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... ts
    ... 2024-05-01T12:30:45
    ... ''')
    >>> d = t.select(d=t.ts.str.parse_datetime("%Y-%m-%dT%H:%M:%S"))
    >>> out = d.select(h=d.d.dt.hour(), dow=d.d.dt.day_of_week())
    >>> pw.debug.compute_and_print(out, include_id=False)
    h  | dow
    12 | 2
    """

    def nanosecond(self) -> ColumnExpression:
        return self._m("dt.nanosecond", lambda d: d.microsecond * 1000, dt.INT)

    def microsecond(self) -> ColumnExpression:
        return self._m("dt.microsecond", lambda d: d.microsecond, dt.INT)

    def millisecond(self) -> ColumnExpression:
        return self._m("dt.millisecond", lambda d: d.microsecond // 1000, dt.INT)

    def second(self) -> ColumnExpression:
        return self._m("dt.second", lambda d: d.second, dt.INT)

    def minute(self) -> ColumnExpression:
        return self._m("dt.minute", lambda d: d.minute, dt.INT)

    def hour(self) -> ColumnExpression:
        return self._m("dt.hour", lambda d: d.hour, dt.INT)

    def day(self) -> ColumnExpression:
        return self._m("dt.day", lambda d: d.day, dt.INT)

    def month(self) -> ColumnExpression:
        return self._m("dt.month", lambda d: d.month, dt.INT)

    def year(self) -> ColumnExpression:
        return self._m("dt.year", lambda d: d.year, dt.INT)

    def day_of_week(self) -> ColumnExpression:
        return self._m("dt.day_of_week", lambda d: d.weekday(), dt.INT)

    def day_of_year(self) -> ColumnExpression:
        return self._m("dt.day_of_year", lambda d: d.timetuple().tm_yday, dt.INT)

    def timestamp(self, unit: str = "s") -> ColumnExpression:
        scale = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]

        def ts(d: _dtm.datetime, sc: float) -> float:
            if d.tzinfo is None:
                d = d.replace(tzinfo=_UTC)
            return d.timestamp() * sc

        return self._m("dt.timestamp", ts, dt.FLOAT, scale)

    def strftime(self, fmt: Any) -> ColumnExpression:
        return self._m("dt.strftime", lambda d, f: d.strftime(f), dt.STR, fmt)

    def strptime(self, fmt: Any, contains_timezone: bool = False) -> ColumnExpression:
        return self._m(
            "dt.strptime",
            lambda s, f: _dtm.datetime.strptime(s, f),
            dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE,
            fmt,
        )

    def to_utc(self, from_timezone: str) -> ColumnExpression:
        from zoneinfo import ZoneInfo

        from pathway_tpu_torch.internals.tztable import build_tz_table

        # _tbl is the packed transition-table operand the native VM
        # converts with; the closure stays the semantic ground truth and
        # doubles as the native per-value fallback (called without _tbl)
        def conv(d: _dtm.datetime, _tbl: Any = None) -> _dtm.datetime:
            return d.replace(tzinfo=ZoneInfo(from_timezone)).astimezone(_UTC)

        return self._m(
            "dt.to_utc", conv, dt.DATE_TIME_UTC, build_tz_table(from_timezone, conv)
        )

    def to_naive_in_timezone(self, timezone: str) -> ColumnExpression:
        from zoneinfo import ZoneInfo

        from pathway_tpu_torch.internals.tztable import build_tz_table

        def conv(d: _dtm.datetime, _tbl: Any = None) -> _dtm.datetime:
            return d.astimezone(ZoneInfo(timezone)).replace(tzinfo=None)

        return self._m(
            "dt.to_naive_in_timezone",
            conv,
            dt.DATE_TIME_NAIVE,
            build_tz_table(timezone, conv),
        )

    def round(self, duration: Any) -> ColumnExpression:
        return self._m("dt.round", _round_dt, self._expr._dtype, duration)

    def floor(self, duration: Any) -> ColumnExpression:
        return self._m("dt.floor", _floor_dt, self._expr._dtype, duration)

    # duration accessors
    def nanoseconds(self) -> ColumnExpression:
        return self._m("dt.nanoseconds", lambda d: int(d.total_seconds() * 1e9), dt.INT)

    def microseconds(self) -> ColumnExpression:
        return self._m("dt.microseconds", lambda d: int(d.total_seconds() * 1e6), dt.INT)

    def milliseconds(self) -> ColumnExpression:
        return self._m("dt.milliseconds", lambda d: int(d.total_seconds() * 1e3), dt.INT)

    def seconds(self) -> ColumnExpression:
        return self._m("dt.seconds", lambda d: int(d.total_seconds()), dt.INT)

    def minutes(self) -> ColumnExpression:
        return self._m("dt.minutes", lambda d: int(d.total_seconds() // 60), dt.INT)

    def hours(self) -> ColumnExpression:
        return self._m("dt.hours", lambda d: int(d.total_seconds() // 3600), dt.INT)

    def days(self) -> ColumnExpression:
        return self._m("dt.days", lambda d: d.days, dt.INT)

    def weeks(self) -> ColumnExpression:
        return self._m("dt.weeks", lambda d: d.days // 7, dt.INT)

    def from_timestamp(self, unit: str = "s") -> ColumnExpression:
        # scale rides along as a float operand so the VM lowers by
        # (name, arity), like timestamp() above
        scale = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]
        return self._m(
            "dt.from_timestamp",
            lambda x, sc: _dtm.datetime.fromtimestamp(x / sc, tz=_UTC).replace(tzinfo=None),
            dt.DATE_TIME_NAIVE,
            scale,
        )

    def utc_from_timestamp(self, unit: str = "s") -> ColumnExpression:
        scale = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]
        return self._m(
            "dt.utc_from_timestamp",
            lambda x, sc: _dtm.datetime.fromtimestamp(x / sc, tz=_UTC),
            dt.DATE_TIME_UTC,
            scale,
        )


def _floor_dt(d: _dtm.datetime, duration: _dtm.timedelta) -> _dtm.datetime:
    epoch = _dtm.datetime(1970, 1, 1, tzinfo=d.tzinfo)
    delta = (d - epoch).total_seconds()
    step = duration.total_seconds()
    return epoch + _dtm.timedelta(seconds=math.floor(delta / step) * step)


def _round_dt(d: _dtm.datetime, duration: _dtm.timedelta) -> _dtm.datetime:
    epoch = _dtm.datetime(1970, 1, 1, tzinfo=d.tzinfo)
    delta = (d - epoch).total_seconds()
    step = duration.total_seconds()
    return epoch + _dtm.timedelta(seconds=round(delta / step) * step)
