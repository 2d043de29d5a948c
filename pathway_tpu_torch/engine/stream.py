"""Update-stream primitives.

The engine models every table as a stream of keyed row updates
``(key, values, diff)`` grouped into *epochs* (logical timestamps).  This is
the capability of the reference's differential collections
(``src/engine/dataflow.rs``) re-expressed for an epoch-synchronous scheduler:
within one epoch all operators see a consistent atomic batch; retractions are
``diff=-1`` updates.

Timestamps are even integers advancing by 2, matching the reference's
convention of reserving odd times for internal interleaving
(``src/connectors/mod.rs:199,538,552``).
"""

from __future__ import annotations

import datetime
import json
from typing import Any, Iterable, NamedTuple

import numpy as np

from pathway_tpu_torch.internals import native as _native
from pathway_tpu_torch.internals.keys import Pointer


class Update(NamedTuple):
    key: Pointer
    values: tuple
    diff: int


Batch = list[Update]

TIME_STEP = 2


def hashable(value: Any) -> Any:
    """Map an arbitrary cell value to something hashable (for multiset
    counters inside reducers)."""
    if isinstance(value, np.ndarray):
        return ("__ndarray__", value.shape, value.tobytes())
    if isinstance(value, dict):
        # each cell by its own hashable form (an ndarray by its bytes): JSON
        # through str() formats every element of an array and summarises one
        # of over 1,000 elements, so rows that differ only there would merge
        # (a DataIndex reply's data snapshot holds the indexed vectors)
        items = tuple(sorted(((str(k), hashable(v)) for k, v in value.items()), key=lambda kv: kv[0]))
        try:
            hash(items)
        except TypeError:
            return ("__dict__", json.dumps(value, sort_keys=True, default=str))
        return ("__dict__", items)
    if isinstance(value, list):
        return ("__list__", tuple(hashable(v) for v in value))
    if isinstance(value, tuple):
        return tuple(hashable(v) for v in value)
    return value


def hashable_row(values: tuple) -> tuple:
    return tuple(hashable(v) for v in values)


def _py_consolidate(batch: Iterable[Update]) -> Batch:
    acc: dict[tuple, list] = {}
    for u in batch:
        k = (u.key, u.values)
        try:
            e = acc.get(k)
        except TypeError:
            k = (u.key, hashable_row(u.values))
            e = acc.get(k)
        if e is None:
            acc[k] = [u.key, u.values, u.diff]
        else:
            e[2] += u.diff
    return [Update(key, vals, d) for key, vals, d in acc.values() if d != 0]


def consolidate(batch: Iterable[Update]) -> Batch:
    """Merge updates with equal (key, row), dropping zero-diff entries.

    Fast path hashes the row tuple directly (scalar cells — the common
    case); rows holding unhashable cells (ndarray/dict/list) fall back to
    the type-tagged :func:`hashable_row` per update, so both spellings of
    an equal row land in the same bucket.

    Runs in C when the native extension is available
    (``native/pathway_native.cpp`` ``consolidate`` — the compaction loop
    the reference runs inside differential arrangements); unchanged
    single-occurrence updates are re-emitted by reference, so the common
    no-duplicate case allocates nothing.  The C path handles unhashable
    rows itself (via ``hashable_row``), so it needs no fallback."""
    native = _native.load()
    if native is not None:
        return native.consolidate(
            batch if isinstance(batch, list) else list(batch),
            Update,
            hashable_row,
        )
    return _py_consolidate(batch)


def per_key_changes(batch: Iterable[Update]) -> dict[Pointer, tuple[list, list]]:
    """Group a batch into per-key (removals, additions) lists."""
    native = _native.load()
    if native is not None:
        return native.per_key_changes(batch)
    out: dict[Pointer, tuple[list, list]] = {}
    for u in batch:
        rem, add = out.setdefault(u.key, ([], []))
        if u.diff < 0:
            rem.extend([u.values] * (-u.diff))
        else:
            add.extend([u.values] * u.diff)
    return out


def total_str(value: Any) -> str:
    if isinstance(value, datetime.datetime):
        return value.isoformat()
    return str(value)
