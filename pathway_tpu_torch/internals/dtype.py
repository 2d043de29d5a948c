"""Dynamic type lattice for table columns.

Capability parity with the reference type system (reference:
``python/pathway/internals/dtype.py``, ``src/engine/value.rs:207-231``) but
designed fresh: a small closed set of scalar dtypes plus parametric
Optional/Tuple/List/Array/Pointer/Callable wrappers, with a ``lub`` (least
upper bound) used by concat/if_else/coalesce type inference.
"""

from __future__ import annotations

import datetime
import typing
from dataclasses import dataclass
from typing import Any as _Any

import numpy as np


class DType:
    """Base of all column dtypes."""

    name: str = "DType"

    def __repr__(self) -> str:
        return self.name

    def is_optional(self) -> bool:
        return False

    def strip_optional(self) -> "DType":
        return self

    def is_value_compatible(self, value: _Any) -> bool:  # pragma: no cover
        raise NotImplementedError

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and repr(self) == repr(other)

    def __hash__(self) -> int:
        return hash((type(self).__name__, repr(self)))


class _SimpleDType(DType):
    def __init__(self, name: str, py_types: tuple[type, ...]):
        self.name = name
        self.py_types = py_types

    def is_value_compatible(self, value: _Any) -> bool:
        if self.name == "FLOAT" and isinstance(value, (int, float)):
            return not isinstance(value, bool)
        if self.name == "INT" and isinstance(value, bool):
            return False
        if self.name == "BOOL":
            return isinstance(value, (bool, np.bool_))
        return isinstance(value, self.py_types)


ANY = _SimpleDType("ANY", (object,))
NONE = _SimpleDType("NONE", (type(None),))
BOOL = _SimpleDType("BOOL", (bool,))
INT = _SimpleDType("INT", (int,))
FLOAT = _SimpleDType("FLOAT", (float,))
STR = _SimpleDType("STR", (str,))
BYTES = _SimpleDType("BYTES", (bytes,))
DATE_TIME_NAIVE = _SimpleDType("DATE_TIME_NAIVE", (datetime.datetime,))
DATE_TIME_UTC = _SimpleDType("DATE_TIME_UTC", (datetime.datetime,))
DURATION = _SimpleDType("DURATION", (datetime.timedelta,))
JSON = _SimpleDType("JSON", (object,))
PY_OBJECT_WRAPPER = _SimpleDType("PY_OBJECT_WRAPPER", (object,))


class Optional(DType):
    def __init__(self, wrapped: DType):
        if isinstance(wrapped, Optional):
            wrapped = wrapped.wrapped
        self.wrapped = wrapped
        self.name = f"Optional({wrapped!r})"

    def is_optional(self) -> bool:
        return True

    def strip_optional(self) -> DType:
        return self.wrapped

    def is_value_compatible(self, value: _Any) -> bool:
        return value is None or self.wrapped.is_value_compatible(value)


class Pointer(DType):
    """Row reference (128-bit key); reference ``Value::Pointer``."""

    def __init__(self, *args: _Any):
        self.name = "POINTER"

    def is_value_compatible(self, value: _Any) -> bool:
        from pathway_tpu_torch.internals.keys import Pointer as Ptr

        return isinstance(value, Ptr)


POINTER = Pointer()


class Tuple(DType):
    def __init__(self, *element_types: DType):
        self.element_types = element_types
        self.name = f"Tuple{element_types!r}"

    def is_value_compatible(self, value: _Any) -> bool:
        return isinstance(value, tuple)


class List(DType):
    def __init__(self, element_type: DType = ANY):
        self.element_type = element_type
        self.name = f"List({element_type!r})"

    def is_value_compatible(self, value: _Any) -> bool:
        return isinstance(value, (tuple, list))


class Array(DType):
    """N-dim numeric array (reference ``Value::FloatArray``/``IntArray``)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType = FLOAT):
        self.n_dim = n_dim
        self.wrapped = wrapped
        self.name = f"Array({n_dim}, {wrapped!r})"

    def is_value_compatible(self, value: _Any) -> bool:
        return isinstance(value, np.ndarray) or hasattr(value, "__array__")


ANY_ARRAY = Array()


class Callable(DType):
    def __init__(self, *args: _Any):
        self.name = "CALLABLE"

    def is_value_compatible(self, value: _Any) -> bool:
        return callable(value)


class Future(DType):
    """Column whose values may still be pending (async UDF results)."""

    def __init__(self, wrapped: DType):
        self.wrapped = wrapped
        self.name = f"Future({wrapped!r})"

    def is_value_compatible(self, value: _Any) -> bool:
        from pathway_tpu_torch.internals import api

        return value is api.PENDING or self.wrapped.is_value_compatible(value)


class DateTimeNaive(datetime.datetime):
    """Schema annotation for timezone-naive datetimes (reference
    ``pw.DateTimeNaive``)."""


class DateTimeUtc(datetime.datetime):
    """Schema annotation for timezone-aware datetimes (reference
    ``pw.DateTimeUtc``)."""


class Duration(datetime.timedelta):
    """Schema annotation for durations (reference ``pw.Duration``)."""


_FROM_PY: dict[_Any, DType] = {
    DateTimeNaive: DATE_TIME_NAIVE,
    DateTimeUtc: DATE_TIME_UTC,
    Duration: DURATION,
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    np.ndarray: ANY_ARRAY,
    _Any: ANY,
    dict: JSON,
}


def wrap(input_type: _Any) -> DType:
    """Map a Python annotation / value-type to a DType."""
    if isinstance(input_type, DType):
        return input_type
    if input_type in _FROM_PY:
        return _FROM_PY[input_type]
    origin = typing.get_origin(input_type)
    args = typing.get_args(input_type)
    import types as _types

    if origin is typing.Union or origin is _types.UnionType:
        # typing.Optional[X] AND PEP-604 `X | None` literals (their
        # origin is types.UnionType, which the old string compare against
        # "types.UnionType" never matched — repr is "<class ...>")
        non_none = [a for a in args if a is not type(None)]
        has_none = len(non_none) != len(args)
        if len(non_none) == 1:
            inner = wrap(non_none[0])
        else:
            inner = ANY
        return Optional(inner) if has_none else inner
    if origin in (tuple,):
        if len(args) == 2 and args[1] is Ellipsis:
            return List(wrap(args[0]))
        return Tuple(*[wrap(a) for a in args])
    if origin in (list,):
        return List(wrap(args[0]) if args else ANY)
    if origin in (dict,):
        return JSON
    from pathway_tpu_torch.internals import keys

    if isinstance(input_type, type) and issubclass(input_type, keys.Pointer):
        return POINTER
    if input_type is np.ndarray:
        return ANY_ARRAY
    if callable(input_type) and input_type is not _Any:
        # typing constructs we don't model precisely
        return ANY
    return ANY


def unoptionalize(dtype: DType) -> DType:
    return dtype.strip_optional()


def dtype_of_value(value: _Any) -> DType:
    from pathway_tpu_torch.internals import keys
    from pathway_tpu_torch.internals.json import Json

    if value is None:
        return NONE
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT
    if isinstance(value, float):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, keys.Pointer):
        return POINTER
    if isinstance(value, Json):
        return JSON
    if isinstance(value, datetime.timedelta):
        return DURATION
    if isinstance(value, datetime.datetime):
        return DATE_TIME_UTC if value.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(value, tuple):
        return Tuple(*[dtype_of_value(v) for v in value])
    if isinstance(value, np.ndarray):
        return Array(value.ndim, INT if value.dtype.kind == "i" else FLOAT)
    if isinstance(value, dict):
        return JSON
    if callable(value):
        return Callable()
    return ANY


_NUMERIC_ORDER = {BOOL: 0, INT: 1, FLOAT: 2}


def is_subtype(sub: DType, sup: DType) -> bool:
    """Lattice ordering ``sub <= sup`` (reference ``dtype.is_subclass`` /
    the ``dtypes_pairs`` relation): INT <= FLOAT, T <= Optional(T),
    NONE <= Optional(T), covariant Tuple/List/Array, everything <= ANY."""
    if sup == ANY or sub == sup:
        return True
    if isinstance(sup, Optional):
        if sub == NONE:
            return True
        return is_subtype(sub.strip_optional() if isinstance(sub, Optional) else sub, sup.wrapped)
    if isinstance(sub, Optional):
        return False  # Optional(T) </= non-optional
    if sub in _NUMERIC_ORDER and sup in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[sub] <= _NUMERIC_ORDER[sup]
    if isinstance(sub, Tuple) and isinstance(sup, Tuple):
        return len(sub.element_types) == len(sup.element_types) and all(
            is_subtype(s, t)
            for s, t in zip(sub.element_types, sup.element_types)
        )
    if isinstance(sub, Tuple) and isinstance(sup, List):
        return all(is_subtype(s, sup.element_type) for s in sub.element_types)
    if isinstance(sub, List) and isinstance(sup, List):
        return is_subtype(sub.element_type, sup.element_type)
    if isinstance(sub, Array) and isinstance(sup, Array):
        dim_ok = sup.n_dim is None or sub.n_dim == sup.n_dim
        return dim_ok and is_subtype(sub.wrapped, sup.wrapped)
    if isinstance(sub, Future) and isinstance(sup, Future):
        return is_subtype(sub.wrapped, sup.wrapped)
    return False


def types_lca(a: DType, b: DType) -> DType:
    """Least common ancestor in the lattice (reference ``dtype.types_lca``):
    the narrowest type both sides convert to, structure-aware for
    Optional/Tuple/List/Array; ANY when unrelated."""
    if is_subtype(a, b):
        return b
    if is_subtype(b, a):
        return a
    if a == NONE:
        return Optional(b)
    if b == NONE:
        return Optional(a)
    if isinstance(a, Optional) or isinstance(b, Optional):
        return Optional(types_lca(a.strip_optional(), b.strip_optional()))
    if a in _NUMERIC_ORDER and b in _NUMERIC_ORDER:
        return a if _NUMERIC_ORDER[a] >= _NUMERIC_ORDER[b] else b
    if isinstance(a, Tuple) and isinstance(b, Tuple):
        if len(a.element_types) == len(b.element_types):
            return Tuple(
                *[
                    types_lca(x, y)
                    for x, y in zip(a.element_types, b.element_types)
                ]
            )
        return List(
            types_lca(
                lub_many(*a.element_types) if a.element_types else ANY,
                lub_many(*b.element_types) if b.element_types else ANY,
            )
        )
    if isinstance(a, (Tuple, List)) and isinstance(b, (Tuple, List)):
        ea = lub_many(*a.element_types) if isinstance(a, Tuple) else a.element_type
        eb = lub_many(*b.element_types) if isinstance(b, Tuple) else b.element_type
        return List(types_lca(ea, eb))
    if isinstance(a, Array) and isinstance(b, Array):
        return Array(
            a.n_dim if a.n_dim == b.n_dim else None,
            types_lca(a.wrapped, b.wrapped),
        )
    return ANY


def lub(a: DType, b: DType) -> DType:
    """Least upper bound of two dtypes (used by if_else/concat/coalesce)."""
    return types_lca(a, b)


def lub_many(*dtypes: DType) -> DType:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = lub(out, d)
    return out


def coerce(value: _Any, dtype: DType) -> _Any:
    """Best-effort runtime coercion of a parsed value to ``dtype``."""
    if value is None:
        return None
    base = dtype.strip_optional()
    try:
        if base == FLOAT and isinstance(value, int):
            return float(value)
        if base == INT and isinstance(value, float) and value.is_integer():
            return int(value)
        if base == STR and not isinstance(value, str):
            return str(value)
        if base == BOOL and isinstance(value, str):
            return value.lower() in ("true", "1", "t", "yes")
        if base == INT and isinstance(value, str):
            return int(value)
        if base == FLOAT and isinstance(value, str):
            return float(value)
    except (ValueError, TypeError):
        return value
    return value


@dataclass(frozen=True)
class ColumnProperties:
    """Per-column engine properties (reference ``TableProperties``,
    ``src/engine/graph.rs:374``)."""

    dtype: DType
    append_only: bool = False
