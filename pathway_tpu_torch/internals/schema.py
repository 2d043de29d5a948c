"""Schema: declarative column typing for tables.

Capability parity with reference ``python/pathway/internals/schema.py`` (947
LoC): class-syntax schemas, ``column_definition`` with primary keys and
defaults, builders (``schema_from_types``, ``schema_builder``,
``schema_from_dict``), merging via ``|``, and per-schema properties
(append_only).
"""

from __future__ import annotations

import typing
from dataclasses import dataclass, field
from typing import Any, Mapping

from pathway_tpu_torch.internals import dtype as dt

_NO_DEFAULT = object()


@dataclass
class ColumnDefinition:
    dtype: dt.DType = field(default_factory=lambda: dt.ANY)
    primary_key: bool = False
    default_value: Any = _NO_DEFAULT
    name: str | None = None
    append_only: bool | None = None

    @property
    def has_default(self) -> bool:
        return self.default_value is not _NO_DEFAULT


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _NO_DEFAULT,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    """Declare column properties inside a Schema class (reference
    ``schema.py`` ``column_definition``)."""
    return ColumnDefinition(
        dtype=dt.wrap(dtype) if dtype is not None else dt.ANY,
        primary_key=primary_key,
        default_value=default_value,
        name=name,
        append_only=append_only,
    )


class SchemaProperties:
    def __init__(self, append_only: bool = False):
        self.append_only = append_only


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnDefinition]
    __properties__: SchemaProperties

    def __new__(
        mcls,
        name: str,
        bases: tuple,
        namespace: dict,
        append_only: bool | None = None,
    ):
        # class-level kwargs (``class S(pw.Schema, append_only=True)``)
        # must not reach object.__init_subclass__, which rejects them
        return super().__new__(mcls, name, bases, namespace)

    def __init__(cls, name: str, bases: tuple, namespace: dict, append_only: bool | None = None) -> None:
        super().__init__(name, bases, namespace)
        columns: dict[str, ColumnDefinition] = {}
        for base in bases:
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)
        hints = namespace.get("__annotations__", {})
        # Resolve string annotations against the defining module when possible.
        module = namespace.get("__module__")
        globalns = vars(__import__(module, fromlist=["_"])) if module in __import__("sys").modules else {}
        for col_name, annotation in hints.items():
            if col_name.startswith("__"):
                continue
            if isinstance(annotation, str):
                try:
                    annotation = eval(annotation, dict(globalns), dict(vars(typing)))  # noqa: S307
                except Exception:
                    annotation = Any
            definition = namespace.get(col_name, None)
            if isinstance(definition, ColumnDefinition):
                cd = ColumnDefinition(
                    dtype=dt.wrap(annotation),
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                    name=definition.name or col_name,
                    append_only=definition.append_only,
                )
            else:
                cd = ColumnDefinition(dtype=dt.wrap(annotation), name=col_name)
                if definition is not None and not callable(definition):
                    cd.default_value = definition
            columns[cd.name or col_name] = cd
        cls.__columns__ = columns
        base_ao = any(
            getattr(getattr(b, "__properties__", None), "append_only", False) for b in bases
        )
        cls.__properties__ = SchemaProperties(append_only=bool(append_only) or base_ao)

    # --- introspection -----------------------------------------------------
    def columns(cls) -> dict[str, ColumnDefinition]:
        return dict(cls.__columns__)

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def keys(cls) -> list[str]:
        return cls.column_names()

    def primary_key_columns(cls) -> list[str] | None:
        pk = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pk or None

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def __getitem__(cls, name: str) -> ColumnDefinition:
        return cls.__columns__[name]

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        cols.update(other.__columns__)
        return schema_from_columns(cols, name=f"{cls.__name__}|{other.__name__}")

    def __repr__(cls) -> str:
        inner = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<Schema {cls.__name__}({inner})>"

    def __str__(cls) -> str:
        return repr(cls)

    # --- derivation --------------------------------------------------------
    def with_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        for n, t in kwargs.items():
            if n not in cols:
                raise ValueError(f"Schema has no column {n!r}")
            old = cols[n]
            cols[n] = ColumnDefinition(
                dtype=dt.wrap(t),
                primary_key=old.primary_key,
                default_value=old.default_value,
                name=n,
                append_only=old.append_only,
            )
        return schema_from_columns(cols, name=cls.__name__)

    def without(cls, *names: str) -> "SchemaMetaclass":
        cols = {n: c for n, c in cls.__columns__.items() if n not in names}
        return schema_from_columns(cols, name=cls.__name__)

    def update_properties(cls, **kwargs: Any) -> "SchemaMetaclass":
        out = schema_from_columns(dict(cls.__columns__), name=cls.__name__)
        for k, v in kwargs.items():
            setattr(out.__properties__, k, v)
        return out

    @property
    def append_only(cls) -> bool:
        return cls.__properties__.append_only


class Schema(metaclass=SchemaMetaclass):
    """Base class for user-declared schemas::

        class InputSchema(pw.Schema):
            doc: str
            rank: int = pw.column_definition(primary_key=True)
    """


def schema_from_columns(
    columns: Mapping[str, ColumnDefinition], name: str = "AnonymousSchema"
) -> SchemaMetaclass:
    cls = SchemaMetaclass(name, (Schema,), {"__module__": __name__, "__qualname__": name})
    cls.__columns__ = {
        n: ColumnDefinition(
            dtype=c.dtype,
            primary_key=c.primary_key,
            default_value=c.default_value,
            name=n,
            append_only=c.append_only,
        )
        for n, c in columns.items()
    }
    return cls


def schema_from_types(_name: str = "AnonymousSchema", **kwargs: Any) -> SchemaMetaclass:
    """``pw.schema_from_types(x=int, y=str)``."""
    return schema_from_columns(
        {n: ColumnDefinition(dtype=dt.wrap(t), name=n) for n, t in kwargs.items()},
        name=_name,
    )


def schema_from_dict(
    columns: Mapping[str, Any], name: str = "AnonymousSchema"
) -> SchemaMetaclass:
    cols: dict[str, ColumnDefinition] = {}
    for n, spec in columns.items():
        if isinstance(spec, ColumnDefinition):
            spec.name = spec.name or n
            cols[n] = spec
        elif isinstance(spec, dict):
            cols[n] = ColumnDefinition(
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", _NO_DEFAULT),
                name=n,
            )
        else:
            cols[n] = ColumnDefinition(dtype=dt.wrap(spec), name=n)
    return schema_from_columns(cols, name=name)


class _SchemaBuilder:
    def __init__(self) -> None:
        self._cols: dict[str, ColumnDefinition] = {}


def schema_builder(
    columns: Mapping[str, ColumnDefinition], *, name: str = "AnonymousSchema", properties: SchemaProperties | None = None
) -> SchemaMetaclass:
    out = schema_from_columns(
        {n: c for n, c in columns.items()}, name=name
    )
    if properties is not None:
        out.__properties__ = properties
    return out


def schema_from_pandas(df: Any, *, id_from: list[str] | None = None, name: str = "PandasSchema") -> SchemaMetaclass:
    import numpy as np

    cols: dict[str, ColumnDefinition] = {}
    for col in df.columns:
        kind = df[col].dtype.kind
        mapped: Any
        if kind == "i":
            mapped = dt.INT
        elif kind == "f":
            mapped = dt.FLOAT
        elif kind == "b":
            mapped = dt.BOOL
        elif kind == "M":
            mapped = dt.DATE_TIME_NAIVE
        elif kind == "m":
            mapped = dt.DURATION
        else:
            sample = df[col].dropna()
            if len(sample) and all(isinstance(v, str) for v in sample):
                mapped = dt.STR
            else:
                mapped = dt.ANY
        cols[str(col)] = ColumnDefinition(
            dtype=mapped, name=str(col), primary_key=bool(id_from and col in id_from)
        )
    del np
    return schema_from_columns(cols, name=name)


def is_schema(obj: Any) -> bool:
    return isinstance(obj, SchemaMetaclass)
