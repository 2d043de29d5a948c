"""``pw.Json`` value wrapper (reference ``python/pathway/internals/json.py``).

Wraps an arbitrary JSON-serialisable value so the type system can treat it as
one opaque dtype while still offering indexing and conversion accessors.
"""

from __future__ import annotations

import json as _json
from typing import Any


class Json:
    __slots__ = ("_value",)

    NULL: "Json"

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value._value
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def __getitem__(self, item: Any) -> "Json":
        v = self._value[item]
        return v if isinstance(v, Json) else Json(v)

    def get(self, item: Any, default: Any = None) -> Any:
        try:
            return self[item]
        except (KeyError, IndexError, TypeError):
            return default

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Json):
            return self._value == other._value
        return self._value == other

    def __hash__(self) -> int:
        try:
            return hash(_json.dumps(self._value, sort_keys=True, default=str))
        except TypeError:
            return hash(repr(self._value))

    def __repr__(self) -> str:
        return f"pw.Json({self._value!r})"

    def __str__(self) -> str:
        return _json.dumps(self._value, default=str)

    def __bool__(self) -> bool:
        return bool(self._value)

    def as_int(self) -> int | None:
        return int(self._value) if isinstance(self._value, (int, float)) and not isinstance(self._value, bool) else None

    def as_float(self) -> float | None:
        return float(self._value) if isinstance(self._value, (int, float)) and not isinstance(self._value, bool) else None

    def as_str(self) -> str | None:
        return self._value if isinstance(self._value, str) else None

    def as_bool(self) -> bool | None:
        return self._value if isinstance(self._value, bool) else None

    def as_list(self) -> list | None:
        return self._value if isinstance(self._value, list) else None

    def as_dict(self) -> dict | None:
        return self._value if isinstance(self._value, dict) else None

    @staticmethod
    def parse(text: str | bytes) -> "Json":
        return Json(_json.loads(text))

    @staticmethod
    def dumps(value: Any) -> str:
        if isinstance(value, Json):
            value = value.value
        return _json.dumps(value, default=str)


Json.NULL = Json(None)
