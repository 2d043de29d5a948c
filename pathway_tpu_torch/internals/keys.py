"""128-bit row keys ("pointers").

The reference engine identifies every row by a 128-bit ``Key`` produced by
hashing the values of the primary-key columns (``src/engine/value.rs`` ``Key``;
``shard_as_usize`` for worker sharding).  We reproduce the *capability* —
stable, collision-resistant, order-free row identity with derived-key
generation — with our own scheme: BLAKE2b-128 over a type-tagged
serialisation.  A thin C++ fast path may replace the hash loop later; the
Python fallback is authoritative for semantics.
"""

from __future__ import annotations

import datetime
import hashlib
import struct
from typing import Any, Iterable

import numpy as np

_SALT = b"pathway_tpu.key.v1"


class Pointer(int):
    """A row key: an int subclass so it hashes/sorts natively, prints short."""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"^{self:032X}"[:12] + "…"

    def __str__(self) -> str:
        return repr(self)

    @property
    def value(self) -> int:
        return int(self)


def _feed(h: "hashlib._Hash", value: Any) -> None:
    if value is None:
        h.update(b"\x00")
    elif isinstance(value, bool):
        h.update(b"\x01" + (b"\x01" if value else b"\x00"))
    elif isinstance(value, Pointer):
        h.update(b"\x07" + int(value).to_bytes(16, "little"))
    elif isinstance(value, int):
        h.update(b"\x02" + value.to_bytes((value.bit_length() + 8) // 8 + 1, "little", signed=True))
    elif isinstance(value, float):
        h.update(b"\x03" + struct.pack("<d", value))
    elif isinstance(value, str):
        b = value.encode()
        h.update(b"\x04" + len(b).to_bytes(8, "little") + b)
    elif isinstance(value, bytes):
        h.update(b"\x05" + len(value).to_bytes(8, "little") + value)
    elif isinstance(value, tuple):
        h.update(b"\x06" + len(value).to_bytes(8, "little"))
        for v in value:
            _feed(h, v)
    elif isinstance(value, datetime.datetime):
        h.update(b"\x08" + struct.pack("<d", value.timestamp()))
    elif isinstance(value, datetime.timedelta):
        h.update(b"\x09" + struct.pack("<d", value.total_seconds()))
    elif isinstance(value, np.ndarray):
        h.update(b"\x0a" + value.tobytes())
    else:
        b = repr(value).encode()
        h.update(b"\x0b" + len(b).to_bytes(8, "little") + b)


def _py_ref_scalar(*args: Any) -> Pointer:
    h = hashlib.blake2b(_SALT, digest_size=16)
    for a in args:
        _feed(h, a)
    return Pointer(int.from_bytes(h.digest(), "little"))


def _load_native():
    """C++ fast path (native/pathway_native.cpp): byte-identical
    serialization+hash, so keys are stable across both paths."""
    from pathway_tpu_torch.internals import native as _native_loader

    mod = _native_loader.load()
    if mod is not None:
        mod.set_pointer_type(Pointer)
    return mod


_native = None
_native_checked = False


def ref_scalar(*args: Any) -> Pointer:
    """Hash a tuple of values into a 128-bit Pointer (reference
    ``Key::for_values``)."""
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        _native = _load_native()
    if _native is not None:
        try:
            return Pointer(_native.ref_scalar(*args))
        except _native.Unsupported:
            pass  # value type outside the C fast path
    return _py_ref_scalar(*args)


def sequential_key(seq: int) -> Pointer:
    """Key for auto-numbered rows (static tables / connectors without
    primary keys)."""
    return ref_scalar("__seq__", seq)


def derive(key: Pointer, *tags: Any) -> Pointer:
    """Derive a new key from an existing one (reindex/flatten/join rows)."""
    return ref_scalar(int(key), *tags)


def join_key(left: Pointer, right: Pointer | None) -> Pointer:
    return ref_scalar("__join__", int(left), int(right) if right is not None else None)


def shard_of(key: Pointer, n_shards: int) -> int:
    """Worker shard for a key (reference ``shard_as_usize() % worker_count``,
    ``src/engine/dataflow.rs:1068-1072``)."""
    return int(key) % n_shards


def unsafe_pointer(x: int) -> Pointer:
    return Pointer(x)


def keys_for_values(rows: Iterable[tuple[Any, ...]]) -> list[Pointer]:
    """Hash many key tuples in ONE native call (bulk ingest fast path),
    falling back to per-row ref_scalar when the native module is absent
    or a value type is outside its fast path."""
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        _native = _load_native()
    rows = list(rows)
    if _native is not None:
        try:
            return [Pointer(k) for k in _native.hash_rows(rows)]
        except _native.Unsupported:
            pass
    return [ref_scalar(*r) for r in rows]
