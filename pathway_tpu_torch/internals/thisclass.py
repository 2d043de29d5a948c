"""``pw.this`` / ``pw.left`` / ``pw.right`` placeholders.

Reference: ``python/pathway/internals/thisclass.py``.  A placeholder stands
for a not-yet-known table inside expressions passed to ``select``/``filter``/
``join``; substitution happens when the expression is bound to an operation.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnReference


class ThisMetaclass(type):
    def __getattr__(cls, name: str) -> Any:
        # block python-internal probes but allow framework columns
        # (pw.this._pw_window_start etc.)
        if name.startswith("_") and not name.startswith("_pw_"):
            raise AttributeError(name)
        return ColumnReference(cls, name)

    def __getitem__(cls, name: str) -> Any:
        if isinstance(name, str):
            return ColumnReference(cls, name)
        raise TypeError(f"Cannot index placeholder with {name!r}")

    def __repr__(cls) -> str:
        return f"<pw.{cls.__name__}>"


class this(metaclass=ThisMetaclass):
    """The table the current operation applies to."""


class left(metaclass=ThisMetaclass):
    """Left side of a join."""


class right(metaclass=ThisMetaclass):
    """Right side of a join."""
