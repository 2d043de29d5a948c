"""Engine-level sentinels and error values.

Mirrors the capability of reference ``Value::Error`` / ``Value::Pending``
(``src/engine/value.rs:207-231``): a poisoned cell value that propagates
through expressions without aborting the run, and a pending marker for async
results.
"""

from __future__ import annotations


class _Error:
    _instance: "_Error | None" = None

    def __new__(cls) -> "_Error":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self) -> bool:
        raise ValueError("Cannot use pw Error value in a boolean context")


class _Pending:
    _instance: "_Pending | None" = None

    def __new__(cls) -> "_Pending":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Pending"


ERROR = _Error()
PENDING = _Pending()


def is_error(value: object) -> bool:
    return value is ERROR


class PyObjectWrapper:
    """Explicitly wraps an arbitrary Python object as an engine value
    (reference ``Value::PyObjectWrapper``, ``src/engine/value.rs:207-231``;
    Python shape ``engine.pyi:895``).

    The payload flows through tables untouched; equality/hashing delegate
    to the payload so wrapped values group and join naturally.  An
    optional serializer (``dumps``/``loads``, default pickle) controls
    how persistence snapshots the payload — set via
    :func:`wrap_py_object`.
    """

    __slots__ = ("value", "_serializer")

    def __init__(self, value: object, _serializer: object = None):
        self.value = value
        self._serializer = _serializer

    def __repr__(self) -> str:
        return f"PyObjectWrapper({self.value!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PyObjectWrapper):
            return self.value == other.value
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.value)

    def __reduce__(self):
        ser = self._serializer
        if ser is not None:
            return (_unwrap_py_object, (ser.dumps(self.value), ser))
        return (PyObjectWrapper, (self.value,))


def _unwrap_py_object(data: bytes, serializer: object) -> PyObjectWrapper:
    return PyObjectWrapper(serializer.loads(data), serializer)  # type: ignore[attr-defined]


def wrap_py_object(object: object, *, serializer: object = None) -> PyObjectWrapper:
    """Wrap a Python object for the engine, optionally with a custom
    ``dumps``/``loads`` serializer used by persistence (reference
    ``api.wrap_py_object``; default pickle via ``__reduce__``)."""
    return PyObjectWrapper(object, serializer)


class EngineError(Exception):
    """Raised for engine failures; contained per-node by the scheduler
    (routed to the error log) unless it is a :class:`FatalEngineError`."""


class FatalEngineError(EngineError):
    """An engine failure that must abort the run instead of being
    contained (e.g. runtime typecheck violations)."""


class EngineErrorWithTrace(EngineError):
    def __init__(self, message: str, trace: str | None = None):
        super().__init__(message if trace is None else f"{message}\n{trace}")
        self.trace = trace
