"""Packed timezone transition tables for the native expression VM.

``dt.to_utc`` / ``dt.to_naive_in_timezone`` take a timezone NAME as a
build-time constant, so the zone's full transition table can be resolved
once at graph build and shipped to the VM as a constant operand; the
native method then converts each row with a binary search over int64
arrays instead of a Python ``ZoneInfo`` call per value.

The tables come from the pure-Python ``zoneinfo._zoneinfo`` loader (the
C-accelerated class hides them), which reads the same TZif data the
runtime closures use:

- ``_trans_utc``     — utc-side bisection keys (epoch seconds)
- ``_trans_local``   — local-side keys, one list per ``fold``
- ``_ttinfos[i]``    — offset applying AFTER transition ``i``
- ``_tti_before``    — offset before the first transition
- ``_tz_after``      — footer: a fixed offset, or a POSIX DST rule
                       (``_TZStr``) the native path does NOT evaluate —
                       out-of-range rows fall back to Python per value.

A zone that cannot be packed yields the 2-tuple ``(name, fallback)``
sentinel — NEVER ``None``: a ``None`` operand would propagate-to-None
through the VM and silently wipe every row.
"""

from __future__ import annotations

from typing import Any, Callable

_packed_cache: dict[str, tuple | None] = {}


def _packed(tz_name: str) -> tuple | None:
    """Arrays + runtime instance for ``tz_name``, or None if unpackable."""
    try:
        import zoneinfo
        from array import array
        from zoneinfo import _zoneinfo as zp

        src = zp.ZoneInfo(tz_name)  # pure-Python impl exposes the tables
        zi = zoneinfo.ZoneInfo(tz_name)  # runtime instance (identity checks)

        def _secs(td: Any) -> int:
            if td.microseconds != 0:  # sub-second offset: not packable
                raise ValueError(tz_name)
            return td.days * 86400 + td.seconds

        trans_utc = tuple(src._trans_utc)
        lk0, lk1 = (tuple(v) for v in src._trans_local)
        offs = tuple(_secs(t.utcoff) for t in src._ttinfos)
        off_before = _secs(src._tti_before.utcoff)
        after = src._tz_after
        after_off = _secs(after.utcoff) if isinstance(after, zp._ttinfo) else None
        if not (len(trans_utc) == len(lk0) == len(lk1) == len(offs)):
            return None

        def pack(xs: tuple) -> bytes:
            return array("q", xs).tobytes()

        return (
            pack(trans_utc),
            pack(lk0),
            pack(lk1),
            pack(offs),
            off_before,
            after_off,
            zi,
        )
    except Exception:  # noqa: BLE001 — unknown zone, odd TZif, no tzdata
        return None


def build_tz_table(tz_name: str, fallback: Callable) -> tuple:
    """Native operand for one ``to_utc``/``to_naive_in_timezone`` site.

    ``fallback`` is the call site's own conversion closure (semantic
    ground truth); the native method invokes it per value for anything
    the packed table cannot answer exactly.
    """
    if tz_name not in _packed_cache:
        _packed_cache[tz_name] = _packed(tz_name)
    packed = _packed_cache[tz_name]
    if packed is None:
        return (tz_name, fallback)
    return (tz_name, *packed, fallback)
