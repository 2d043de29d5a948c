"""Static type interpretation of expressions.

Capability parity with the reference type interpreter
(``python/pathway/internals/type_interpreter.py``, 686 LoC, and the typed
expression enums in ``src/engine/expression.rs:26-340``): every binary /
unary operator application is checked against an operator table at graph
**build** time, so ``t.name + t.age`` on STR/INT columns raises immediately
with the offending types named, instead of producing ERROR values at run
time.  Columns typed ``ANY`` (or dynamic containers) bypass the check —
exactly the reference's escape hatch for untyped data.

The runtime half (``PATHWAY_RUNTIME_TYPECHECKING``) lives in
:func:`make_runtime_checker`: a per-schema validator used by ``select`` to
assert produced values actually inhabit the declared dtypes.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import dtype as dt


class TypeInterpreterError(TypeError):
    """Incompatible operand types detected at graph-build time."""


class RuntimeTypeError(api.FatalEngineError, TypeError):
    """Declared-dtype violation under PATHWAY_RUNTIME_TYPECHECKING —
    unrecoverable: the scheduler re-raises it instead of containing."""


#: scalar dtypes that participate in strict checking; anything else
#: (ANY/JSON/containers/callables) falls back to dynamic typing
_STRICT = (
    dt.BOOL,
    dt.INT,
    dt.FLOAT,
    dt.STR,
    dt.BYTES,
    dt.DATE_TIME_NAIVE,
    dt.DATE_TIME_UTC,
    dt.DURATION,
    dt.POINTER,
)

_NUMERIC = (dt.BOOL, dt.INT, dt.FLOAT)
_ARITH = ("+", "-", "*", "//", "%", "**")
_CMP = ("==", "!=", "<", "<=", ">", ">=")
_BITWISE = ("&", "|", "^")

#: (op, left, right) -> result for the non-numeric special forms
#: (mirrors the reference's DateTimeNaive/Utc/Duration expression enums)
_TABLE: dict[tuple[str, dt.DType, dt.DType], dt.DType] = {}


def _fill_table() -> None:
    for dtn in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
        _TABLE[("-", dtn, dtn)] = dt.DURATION
        _TABLE[("+", dtn, dt.DURATION)] = dtn
        _TABLE[("+", dt.DURATION, dtn)] = dtn
        _TABLE[("-", dtn, dt.DURATION)] = dtn
    _TABLE[("+", dt.DURATION, dt.DURATION)] = dt.DURATION
    _TABLE[("-", dt.DURATION, dt.DURATION)] = dt.DURATION
    _TABLE[("*", dt.DURATION, dt.INT)] = dt.DURATION
    _TABLE[("*", dt.INT, dt.DURATION)] = dt.DURATION
    _TABLE[("*", dt.DURATION, dt.FLOAT)] = dt.DURATION
    _TABLE[("*", dt.FLOAT, dt.DURATION)] = dt.DURATION
    _TABLE[("/", dt.DURATION, dt.INT)] = dt.DURATION
    _TABLE[("/", dt.DURATION, dt.FLOAT)] = dt.DURATION
    _TABLE[("/", dt.DURATION, dt.DURATION)] = dt.FLOAT
    _TABLE[("//", dt.DURATION, dt.DURATION)] = dt.INT
    _TABLE[("%", dt.DURATION, dt.DURATION)] = dt.DURATION
    _TABLE[("+", dt.STR, dt.STR)] = dt.STR
    _TABLE[("*", dt.STR, dt.INT)] = dt.STR
    _TABLE[("*", dt.INT, dt.STR)] = dt.STR
    _TABLE[("+", dt.BYTES, dt.BYTES)] = dt.BYTES


_fill_table()


def _is_strict(d: dt.DType) -> bool:
    return any(d == s for s in _STRICT)


def binary_result_dtype(op: str, left: dt.DType, right: dt.DType) -> dt.DType:
    """Result dtype of ``left <op> right``; raises
    :class:`TypeInterpreterError` when both operands are strict scalars and
    no typing rule accepts the pair (reference
    ``type_interpreter.py`` eval_binary_op)."""
    optional = left.is_optional() or right.is_optional()
    l, r = left.strip_optional(), right.strip_optional()

    def wrap(res: dt.DType) -> dt.DType:
        return dt.Optional(res) if optional and res != dt.ANY else res

    # dynamic escape hatch: ANY / JSON / containers never raise
    if not (_is_strict(l) and _is_strict(r)):
        if op in _CMP:
            return wrap(dt.BOOL)
        if op == "/":
            return wrap(dt.FLOAT) if l in _NUMERIC and r in _NUMERIC else dt.ANY
        return dt.lub(l, r) if op not in _BITWISE else dt.ANY

    # equality is total across strict scalars (keys, mixed columns)
    if op in ("==", "!="):
        return wrap(dt.BOOL)
    if op in _CMP:
        if (l in _NUMERIC and r in _NUMERIC) or l == r:
            return wrap(dt.BOOL)
        raise TypeInterpreterError(
            f"Cannot compare {l!r} with {r!r} using {op!r}"
        )
    special = _TABLE.get((op, l, r))
    if special is not None:
        return wrap(special)
    if op in _BITWISE:
        if l == dt.BOOL and r == dt.BOOL:
            return wrap(dt.BOOL)
        if l in (dt.BOOL, dt.INT) and r in (dt.BOOL, dt.INT):
            return wrap(dt.INT)
        raise TypeInterpreterError(
            f"Binary operator {op!r} is not defined on {l!r} and {r!r}; "
            "boolean columns combine with & | ^"
        )
    if op == "/":
        if l in _NUMERIC and r in _NUMERIC:
            return wrap(dt.FLOAT)
        raise TypeInterpreterError(f"Cannot divide {l!r} by {r!r}")
    if op in _ARITH:
        if l in _NUMERIC and r in _NUMERIC:
            if l == dt.FLOAT or r == dt.FLOAT:
                return wrap(dt.FLOAT)
            return wrap(dt.INT)
        raise TypeInterpreterError(
            f"Binary operator {op!r} is not defined on {l!r} and {r!r} "
            "(cast one side, e.g. pw.cast(str, ...) or .str namespace)"
        )
    if op == "@":
        raise TypeInterpreterError(
            f"Matrix multiplication needs array operands, got {l!r} and {r!r}"
        )
    return dt.ANY


def unary_result_dtype(op: str, operand: dt.DType) -> dt.DType:
    optional = operand.is_optional()
    o = operand.strip_optional()

    def wrap(res: dt.DType) -> dt.DType:
        return dt.Optional(res) if optional else res

    if not _is_strict(o):
        return operand if op == "-" else dt.ANY
    if op == "-":
        if o in _NUMERIC:
            return wrap(dt.INT if o == dt.BOOL else o)
        if o == dt.DURATION:
            return wrap(dt.DURATION)
        raise TypeInterpreterError(f"Unary - is not defined on {o!r}")
    if op == "~":
        if o == dt.BOOL:
            return wrap(dt.BOOL)
        if o == dt.INT:
            return wrap(dt.INT)
        raise TypeInterpreterError(f"Unary ~ is not defined on {o!r}")
    return dt.ANY


# ---------------------------------------------------------------------------
# runtime typechecking (PATHWAY_RUNTIME_TYPECHECKING)


def make_runtime_checker(
    names: list[str], dtypes: list[dt.DType], where: str
) -> Any:
    """A validator ``(values_tuple) -> None`` raising
    :class:`RuntimeTypeError` when a produced value does not inhabit its
    declared dtype (reference runtime typechecking mode).  ERROR/None
    propagation is always allowed."""
    checks = [
        (i, n, d)
        for i, (n, d) in enumerate(zip(names, dtypes))
        if d != dt.ANY
    ]

    def check(values: tuple) -> None:
        for i, name, d in checks:
            v = values[i]
            if v is api.ERROR or (v is None and (d.is_optional() or d == dt.NONE)):
                continue
            if not d.is_value_compatible(v):
                raise RuntimeTypeError(
                    f"{where}: column {name!r} declared {d!r} but produced "
                    f"{type(v).__name__} value {v!r}"
                )

    return check
