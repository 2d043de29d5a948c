"""Column expression AST.

Capability parity with reference ``python/pathway/internals/expression.py``
(1179 LoC) + ``src/engine/expression.rs``: lazily-built expression trees over
table columns, supporting arithmetic/comparison/boolean operators, casts,
apply (sync & async UDF), if_else/coalesce/require, pointers, tuples,
indexing, and method namespaces (``.dt``, ``.str``, ``.num``).

Unlike the reference (which interprets a typed Rust enum row-by-row), our
engine *compiles* each expression tree into a Python closure over the row
tuple once per operator build — and the numeric plane bypasses rowwise eval
entirely via batched jitted executors.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping

from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import keys

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class ColumnExpression:
    """Base class of all expressions."""

    _dtype: dt.DType = dt.ANY

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("+", self, _wrap(other))

    def __radd__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("+", _wrap(other), self)

    def __sub__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("-", self, _wrap(other))

    def __rsub__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("-", _wrap(other), self)

    def __mul__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("*", self, _wrap(other))

    def __rmul__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("*", _wrap(other), self)

    def __truediv__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("/", self, _wrap(other))

    def __rtruediv__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("/", _wrap(other), self)

    def __floordiv__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("//", self, _wrap(other))

    def __rfloordiv__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("//", _wrap(other), self)

    def __mod__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("%", self, _wrap(other))

    def __rmod__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("%", _wrap(other), self)

    def __pow__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("**", self, _wrap(other))

    def __rpow__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("**", _wrap(other), self)

    def __matmul__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("@", self, _wrap(other))

    def __neg__(self) -> "ColumnExpression":
        return UnaryExpression("-", self)

    def __abs__(self) -> "ColumnExpression":
        return ApplyExpression(abs, dt.ANY, (self,), {})

    # -- comparison ---------------------------------------------------------
    def __eq__(self, other: Any) -> "ColumnExpression":  # type: ignore[override]
        return BinaryExpression("==", self, _wrap(other))

    def __ne__(self, other: Any) -> "ColumnExpression":  # type: ignore[override]
        return BinaryExpression("!=", self, _wrap(other))

    def __lt__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("<", self, _wrap(other))

    def __le__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("<=", self, _wrap(other))

    def __gt__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression(">", self, _wrap(other))

    def __ge__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression(">=", self, _wrap(other))

    # -- boolean ------------------------------------------------------------
    def __and__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("&", self, _wrap(other))

    def __rand__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("&", _wrap(other), self)

    def __or__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("|", self, _wrap(other))

    def __ror__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("|", _wrap(other), self)

    def __xor__(self, other: Any) -> "ColumnExpression":
        return BinaryExpression("^", self, _wrap(other))

    def __invert__(self) -> "ColumnExpression":
        return UnaryExpression("~", self)

    def __bool__(self) -> bool:
        raise TypeError(
            "ColumnExpression is lazy and cannot be used in a boolean context; "
            "use & | ~ instead of and/or/not, and .is_none() instead of `is None`."
        )

    def __hash__(self) -> int:
        return id(self)

    # -- misc ---------------------------------------------------------------
    def __getitem__(self, item: Any) -> "ColumnExpression":
        return GetExpression(self, _wrap(item), check_if_exists=False)

    def get(self, item: Any, default: Any = None) -> "ColumnExpression":
        return GetExpression(self, _wrap(item), default=_wrap(default), check_if_exists=True)

    def is_none(self) -> "ColumnExpression":
        return IsNoneExpression(self)

    def is_not_none(self) -> "ColumnExpression":
        return UnaryExpression("~", IsNoneExpression(self))

    def to_string(self) -> "ColumnExpression":
        return ApplyExpression(
            lambda x: "" if x is None else str(x), dt.STR, (self,), {}
        )

    @property
    def dt(self) -> Any:
        from pathway_tpu_torch.internals.expressions import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self) -> Any:
        from pathway_tpu_torch.internals.expressions import StringNamespace

        return StringNamespace(self)

    @property
    def num(self) -> Any:
        from pathway_tpu_torch.internals.expressions import NumericalNamespace

        return NumericalNamespace(self)

    # -- infrastructure -----------------------------------------------------
    def _children(self) -> Iterable["ColumnExpression"]:
        return ()

    def _substitute(self, mapping: Mapping[Any, "Table"]) -> "ColumnExpression":
        """Replace this/left/right placeholders with concrete tables."""
        return self._rebuild([c._substitute(mapping) for c in self._children()])

    def _rebuild(self, children: list["ColumnExpression"]) -> "ColumnExpression":
        return self

    def _references(self) -> list["ColumnReference"]:
        # NOTE: keyed dict, not a set — ColumnReference overloads __eq__ to
        # build lazy expressions, so set/``in`` operations would call it.
        out: dict[tuple, ColumnReference] = {}
        stack: list[ColumnExpression] = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, ColumnReference):
                out.setdefault((id(e._table), e._name), e)
            stack.extend(e._children())
        return list(out.values())

    def _compile(self, resolver: Callable[["ColumnReference"], Callable[[tuple], Any]]) -> Callable[[tuple], Any]:
        """Compile to a closure ``row -> value``; ``resolver`` maps column
        references to accessors."""
        raise NotImplementedError(type(self))

    @property
    def _deps_tables(self) -> set[Any]:
        return {r._table for r in self._references()}


def _wrap(value: Any) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    return ConstExpression(value)


def smart_name(expr: ColumnExpression) -> str | None:
    if isinstance(expr, ColumnReference):
        return expr._name
    return None


class ConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value
        self._dtype = dt.dtype_of_value(value)

    def __repr__(self) -> str:
        return f"Const({self._value!r})"

    def _compile(self, resolver):
        v = self._value
        return lambda row: v


class ColumnReference(ColumnExpression):
    """``table.colname`` / ``pw.this.colname``."""

    def __init__(self, table: Any, name: str):
        self._table = table
        self._name = name

    @property
    def _dtype(self) -> dt.DType:  # type: ignore[override]
        if self._name == "id":
            return dt.POINTER
        dtypes = getattr(self._table, "_dtypes", None)
        if dtypes is not None and self._name in dtypes:
            return dtypes[self._name]
        return dt.ANY

    def __repr__(self) -> str:
        return f"<{getattr(self._table, '_name', self._table)}.{self._name}>"

    @property
    def table(self) -> Any:
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def _substitute(self, mapping):
        from pathway_tpu_torch.internals.thisclass import ThisMetaclass

        if isinstance(self._table, ThisMetaclass):
            target = mapping.get(self._table)
            if target is None:
                raise ValueError(f"Cannot resolve placeholder {self._table}")
            if self._name == "id":
                return target.id
            return ColumnReference(target, self._name)
        return self

    def _compile(self, resolver):
        return resolver(self)

    def __eq__(self, other: Any) -> ColumnExpression:  # type: ignore[override]
        return BinaryExpression("==", self, _wrap(other))

    def __hash__(self) -> int:
        return hash((id(self._table), self._name))


_BIN_OPS: dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: _true_div(a, b),
    "//": lambda a, b: a // b,
    "%": lambda a, b: a % b,
    "**": lambda a, b: a**b,
    "@": lambda a, b: a @ b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&": lambda a, b: a & b,
    "|": lambda a, b: a | b,
    "^": lambda a, b: a ^ b,
}


def _true_div(a: Any, b: Any) -> Any:
    if isinstance(a, int) and isinstance(b, int) and not isinstance(a, bool) and not isinstance(b, bool):
        if b == 0:
            raise ZeroDivisionError("division by zero")
        return a / b
    return a / b

_CMP_OPS = {"==", "!=", "<", "<=", ">", ">=" }


class BinaryExpression(ColumnExpression):
    def __init__(self, op: str, left: ColumnExpression, right: ColumnExpression):
        from pathway_tpu_torch.internals.type_interpreter import binary_result_dtype

        self._op = op
        self._left = left
        self._right = right
        # build-time operator typing (reference type_interpreter.py):
        # raises TypeInterpreterError on e.g. STR + INT before the graph runs
        self._dtype = binary_result_dtype(op, left._dtype, right._dtype)

    def __repr__(self) -> str:
        return f"({self._left!r} {self._op} {self._right!r})"

    def _children(self):
        return (self._left, self._right)

    def _rebuild(self, children):
        return BinaryExpression(self._op, children[0], children[1])

    def _compile(self, resolver):
        f = _BIN_OPS[self._op]
        lc = self._left._compile(resolver)
        rc = self._right._compile(resolver)
        op = self._op

        def run(row: tuple) -> Any:
            a = lc(row)
            b = rc(row)
            if a is api.ERROR or b is api.ERROR:
                return api.ERROR
            try:
                return f(a, b)
            except TypeError:
                if a is None or b is None:
                    if op == "==":
                        return a is b
                    if op == "!=":
                        return a is not b
                    return None
                return api.ERROR
            except (ZeroDivisionError, ValueError, OverflowError):
                return api.ERROR

        return run


class UnaryExpression(ColumnExpression):
    _OPS: dict[str, Callable[[Any], Any]] = {"-": lambda a: -a, "~": lambda a: (not a) if isinstance(a, bool) else ~a}

    def __init__(self, op: str, operand: ColumnExpression):
        from pathway_tpu_torch.internals.type_interpreter import unary_result_dtype

        self._op = op
        self._operand = operand
        self._dtype = unary_result_dtype(op, operand._dtype)

    def _children(self):
        return (self._operand,)

    def _rebuild(self, children):
        return UnaryExpression(self._op, children[0])

    def _compile(self, resolver):
        f = self._OPS[self._op]
        c = self._operand._compile(resolver)

        def run(row: tuple) -> Any:
            v = c(row)
            if v is api.ERROR:
                return api.ERROR
            if v is None:
                return None
            try:
                return f(v)
            except TypeError:
                return api.ERROR

        return run


class IsNoneExpression(ColumnExpression):
    _dtype = dt.BOOL

    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return IsNoneExpression(children[0])

    def _compile(self, resolver):
        c = self._expr._compile(resolver)
        return lambda row: (lambda v: api.ERROR if v is api.ERROR else v is None)(c(row))


class IfElseExpression(ColumnExpression):
    """``pw.if_else(cond, a, b)``."""

    def __init__(self, cond: ColumnExpression, then: ColumnExpression, else_: ColumnExpression):
        self._cond = cond
        self._then = then
        self._else = else_
        self._dtype = dt.lub(then._dtype, else_._dtype)

    def _children(self):
        return (self._cond, self._then, self._else)

    def _rebuild(self, children):
        return IfElseExpression(*children)

    def _compile(self, resolver):
        cc = self._cond._compile(resolver)
        tc = self._then._compile(resolver)
        ec = self._else._compile(resolver)

        def run(row: tuple) -> Any:
            c = cc(row)
            if c is api.ERROR:
                return api.ERROR
            return tc(row) if c else ec(row)

        return run


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args: ColumnExpression):
        self._args = args
        non_none = [a._dtype for a in args]
        self._dtype = dt.lub_many(*non_none) if non_none else dt.ANY

    def _children(self):
        return self._args

    def _rebuild(self, children):
        return CoalesceExpression(*children)

    def _compile(self, resolver):
        cs = [a._compile(resolver) for a in self._args]

        def run(row: tuple) -> Any:
            for c in cs:
                v = c(row)
                if v is not None:
                    return v
            return None

        return run


class RequireExpression(ColumnExpression):
    """``pw.require(value, *deps)`` — None if any dep is None."""

    def __init__(self, value: ColumnExpression, *deps: ColumnExpression):
        self._value = value
        self._deps = deps
        self._dtype = dt.Optional(value._dtype)

    def _children(self):
        return (self._value, *self._deps)

    def _rebuild(self, children):
        return RequireExpression(children[0], *children[1:])

    def _compile(self, resolver):
        vc = self._value._compile(resolver)
        dcs = [d._compile(resolver) for d in self._deps]

        def run(row: tuple) -> Any:
            for c in dcs:
                if c(row) is None:
                    return None
            return vc(row)

        return run


class ApplyExpression(ColumnExpression):
    """``pw.apply(f, *args)`` — a Python UDF evaluated row-wise (reference
    ``eval_apply`` ``internals/graph_runner/expression_evaluator.py:404``)."""

    def __init__(
        self,
        fun: Callable,
        return_type: Any,
        args: tuple[ColumnExpression, ...],
        kwargs: Mapping[str, ColumnExpression],
        *,
        propagate_none: bool = False,
        deterministic: bool = True,
    ):
        self._fun = fun
        self._args = tuple(_wrap(a) for a in args)
        self._kwargs = {k: _wrap(v) for k, v in kwargs.items()}
        self._dtype = dt.wrap(return_type)
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        from pathway_tpu_torch.engine.graph import _user_trace

        #: user file:line of the pw.apply(...) call — attached to runtime
        #: error-log entries (reference internals/trace.py)
        self._trace = _user_trace()

    def _children(self):
        return (*self._args, *self._kwargs.values())

    def _rebuild(self, children):
        n = len(self._args)
        return type(self)(
            self._fun,
            self._dtype,
            tuple(children[:n]),
            dict(zip(self._kwargs.keys(), children[n:])),
            propagate_none=self._propagate_none,
            deterministic=self._deterministic,
        )

    def _compile(self, resolver):
        acs = [a._compile(resolver) for a in self._args]
        kcs = {k: v._compile(resolver) for k, v in self._kwargs.items()}
        fun = self._fun
        propagate_none = self._propagate_none
        trace = self._trace

        def run(row: tuple) -> Any:
            args = [c(row) for c in acs]
            kwargs = {k: c(row) for k, c in kcs.items()}
            if any(a is api.ERROR for a in args) or any(v is api.ERROR for v in kwargs.values()):
                return api.ERROR
            if propagate_none and (any(a is None for a in args) or any(v is None for v in kwargs.values())):
                return None
            try:
                return fun(*args, **kwargs)
            except Exception as e:
                from pathway_tpu_torch.internals.parse_graph import G

                G.log_error(
                    f"apply({getattr(fun, '__name__', fun)!r}) failed: {e!r}",
                    trace=trace,
                )
                return api.ERROR

        return run


class AsyncApplyExpression(ApplyExpression):
    """``pw.apply_async`` — batched per-timestamp via the async executor
    (reference ``map_named_async``, ``src/engine/dataflow/operators.rs:269``)."""


class FullyAsyncApplyExpression(ApplyExpression):
    """``pw.apply_with_full_async`` — results arrive at later timestamps,
    column dtype becomes Future (reference fully-async UDF executor)."""


class BatchApplyExpression(AsyncApplyExpression):
    """Epoch-batched UDF: ``_fun`` receives one LIST per argument (all the
    epoch's rows at once) and returns an aligned list of results.  This is
    the host contract for jitted TPU executors — one compiled call per
    epoch instead of the reference's per-row torch calls
    (``xpacks/llm/embedders.py:270-327``)."""


class CastExpression(ColumnExpression):
    def __init__(self, target: dt.DType, expr: ColumnExpression):
        self._target = target
        self._expr = expr
        self._dtype = target

    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return CastExpression(self._target, children[0])

    def _compile(self, resolver):
        c = self._expr._compile(resolver)
        target = self._target.strip_optional()

        def run(row: tuple) -> Any:
            v = c(row)
            if v is api.ERROR or v is None:
                return v
            try:
                if target == dt.INT:
                    return int(v)
                if target == dt.FLOAT:
                    return float(v)
                if target == dt.BOOL:
                    return bool(v)
                if target == dt.STR:
                    return str(v)
                return v
            except (ValueError, TypeError):
                return api.ERROR

        return run


class ConvertExpression(ColumnExpression):
    """Json→scalar conversion: ``.as_int()`` etc."""

    def __init__(self, target: dt.DType, expr: ColumnExpression, *, unwrap: bool = False):
        self._target = target
        self._expr = expr
        self._unwrap = unwrap
        self._dtype = target if unwrap else dt.Optional(target)

    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return ConvertExpression(self._target, children[0], unwrap=self._unwrap)

    def _compile(self, resolver):
        from pathway_tpu_torch.internals.json import Json

        c = self._expr._compile(resolver)
        target = self._target.strip_optional()
        unwrap = self._unwrap

        def run(row: tuple) -> Any:
            v = c(row)
            if v is api.ERROR:
                return api.ERROR
            if isinstance(v, Json):
                v = v.value
            if v is None:
                return api.ERROR if unwrap else None
            try:
                if target == dt.INT:
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        return api.ERROR
                    return int(v)
                if target == dt.FLOAT:
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        return api.ERROR
                    return float(v)
                if target == dt.BOOL:
                    return v if isinstance(v, bool) else api.ERROR
                if target == dt.STR:
                    return v if isinstance(v, str) else api.ERROR
                return v
            except (ValueError, TypeError):
                return api.ERROR

        return run


class PointerExpression(ColumnExpression):
    """``table.pointer_from(*cols)``."""

    _dtype = dt.POINTER

    def __init__(self, table: Any, *args: ColumnExpression, instance: ColumnExpression | None = None, optional: bool = False):
        self._ptr_table = table
        self._args = tuple(_wrap(a) for a in args)
        self._instance = instance
        self._optional = optional

    def _children(self):
        return self._args if self._instance is None else (*self._args, self._instance)

    def _rebuild(self, children):
        if self._instance is None:
            return PointerExpression(self._ptr_table, *children, optional=self._optional)
        return PointerExpression(
            self._ptr_table, *children[:-1], instance=children[-1], optional=self._optional
        )

    def _substitute(self, mapping):
        from pathway_tpu_torch.internals.thisclass import ThisMetaclass

        table = self._ptr_table
        if isinstance(table, ThisMetaclass):
            table = mapping.get(table, table)
        children = [c._substitute(mapping) for c in self._args]
        inst = self._instance._substitute(mapping) if self._instance is not None else None
        return PointerExpression(table, *children, instance=inst, optional=self._optional)

    def _compile(self, resolver):
        acs = [a._compile(resolver) for a in self._args]
        optional = self._optional

        def run(row: tuple) -> Any:
            vals = [c(row) for c in acs]
            if optional and any(v is None for v in vals):
                return None
            return keys.ref_scalar(*vals)

        return run


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args: ColumnExpression):
        self._args = tuple(_wrap(a) for a in args)
        self._dtype = dt.Tuple(*[a._dtype for a in self._args])

    def _children(self):
        return self._args

    def _rebuild(self, children):
        return MakeTupleExpression(*children)

    def _compile(self, resolver):
        acs = [a._compile(resolver) for a in self._args]
        return lambda row: tuple(c(row) for c in acs)


class GetExpression(ColumnExpression):
    def __init__(
        self,
        obj: ColumnExpression,
        index: ColumnExpression,
        default: ColumnExpression | None = None,
        *,
        check_if_exists: bool,
    ):
        self._obj = obj
        self._index = index
        self._default = default if default is not None else ConstExpression(None)
        self._check = check_if_exists
        base = obj._dtype.strip_optional()
        if base == dt.JSON:
            self._dtype = dt.Optional(dt.JSON) if check_if_exists else dt.JSON
        else:
            self._dtype = dt.ANY

    def _children(self):
        return (self._obj, self._index, self._default)

    def _rebuild(self, children):
        return GetExpression(children[0], children[1], children[2], check_if_exists=self._check)

    def _compile(self, resolver):
        from pathway_tpu_torch.internals.json import Json

        oc = self._obj._compile(resolver)
        ic = self._index._compile(resolver)
        dc = self._default._compile(resolver)
        check = self._check

        def run(row: tuple) -> Any:
            obj = oc(row)
            idx = ic(row)
            if obj is api.ERROR or idx is api.ERROR:
                return api.ERROR
            try:
                if isinstance(obj, Json):
                    inner = obj.value
                    v = inner[idx]
                    return v if isinstance(v, Json) else Json(v)
                return obj[idx]
            except (KeyError, IndexError, TypeError):
                return dc(row) if check else api.ERROR

        return run


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr: ColumnExpression):
        self._expr = expr
        self._dtype = expr._dtype.strip_optional()

    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return UnwrapExpression(children[0])

    def _compile(self, resolver):
        c = self._expr._compile(resolver)

        def run(row: tuple) -> Any:
            v = c(row)
            return api.ERROR if v is None else v

        return run


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr: ColumnExpression, replacement: ColumnExpression):
        self._expr = expr
        self._replacement = _wrap(replacement)
        self._dtype = dt.lub(expr._dtype, self._replacement._dtype)

    def _children(self):
        return (self._expr, self._replacement)

    def _rebuild(self, children):
        return FillErrorExpression(children[0], children[1])

    def _compile(self, resolver):
        c = self._expr._compile(resolver)
        rc = self._replacement._compile(resolver)

        def run(row: tuple) -> Any:
            v = c(row)
            return rc(row) if v is api.ERROR else v

        return run


class MethodCallExpression(ColumnExpression):
    """Namespace method (``.dt.hour()``, ``.str.upper()`` …) — stored as a
    plain function over evaluated operands."""

    def __init__(self, name: str, fun: Callable, return_type: Any, *args: ColumnExpression, propagate_none: bool = True):
        self._method_name = name
        self._fun = fun
        self._args = tuple(_wrap(a) for a in args)
        self._dtype = dt.wrap(return_type)
        self._propagate_none = propagate_none

    def _children(self):
        return self._args

    def _rebuild(self, children):
        return MethodCallExpression(
            self._method_name, self._fun, self._dtype, *children, propagate_none=self._propagate_none
        )

    def _compile(self, resolver):
        acs = [a._compile(resolver) for a in self._args]
        fun = self._fun
        propagate_none = self._propagate_none

        def run(row: tuple) -> Any:
            vals = [c(row) for c in acs]
            if any(v is api.ERROR for v in vals):
                return api.ERROR
            if propagate_none and any(v is None for v in vals):
                return None
            try:
                return fun(*vals)
            except Exception:
                return api.ERROR

        return run


class ReducerExpression(ColumnExpression):
    """A reducer applied in a ``.reduce(...)`` context, e.g.
    ``pw.reducers.sum(pw.this.x)``."""

    def __init__(self, reducer: Any, *args: ColumnExpression, **kwargs: Any):
        self._reducer = reducer
        self._args = tuple(_wrap(a) for a in args)
        self._reducer_kwargs = kwargs
        self._dtype = reducer.return_dtype([a._dtype for a in self._args])

    def _children(self):
        return self._args

    def _rebuild(self, children):
        return ReducerExpression(self._reducer, *children, **self._reducer_kwargs)

    def _compile(self, resolver):
        raise TypeError(
            f"Reducer {self._reducer.name} can only be used inside .reduce(...)"
        )


# -- public constructors ----------------------------------------------------

def if_else(cond: Any, then: Any, else_: Any) -> ColumnExpression:
    """Lazy conditional: only the taken branch evaluates per row.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a
    ... -2
    ... 3
    ... ''')
    >>> out = t.select(sign=pw.if_else(t.a >= 0, 1, -1))
    >>> pw.debug.compute_and_print(out, include_id=False)
    sign
    -1
    1
    """
    return IfElseExpression(_wrap(cond), _wrap(then), _wrap(else_))


def coalesce(*args: Any) -> ColumnExpression:
    """First non-None argument, evaluated lazily left to right.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a | b
    ... 1 |
    ...   | 5
    ... ''')
    >>> out = t.select(v=pw.coalesce(t.a, t.b, 0))
    >>> pw.debug.compute_and_print(out, include_id=False)
    v
    1
    5
    """
    return CoalesceExpression(*[_wrap(a) for a in args])


def require(value: Any, *deps: Any) -> ColumnExpression:
    return RequireExpression(_wrap(value), *[_wrap(d) for d in deps])


def cast(target_type: Any, expr: Any) -> ColumnExpression:
    return CastExpression(dt.wrap(target_type), _wrap(expr))


class DeclareTypeExpression(ColumnExpression):
    """Static type assertion WITHOUT runtime conversion (reference
    ``pw.declare_type``): the value passes through untouched, only the
    declared dtype changes."""

    def __init__(self, target: dt.DType, expr: ColumnExpression):
        self._dtype = target
        self._expr = expr

    def __repr__(self) -> str:
        return f"declare_type({self._dtype!r}, {self._expr!r})"

    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return DeclareTypeExpression(self._dtype, children[0])

    def _compile(self, resolver):
        return self._expr._compile(resolver)


def declare_type(target_type: Any, expr: Any) -> ColumnExpression:
    return DeclareTypeExpression(dt.wrap(target_type), _wrap(expr))


def unwrap(expr: Any) -> ColumnExpression:
    return UnwrapExpression(_wrap(expr))


def fill_error(expr: Any, replacement: Any) -> ColumnExpression:
    return FillErrorExpression(_wrap(expr), _wrap(replacement))


def make_tuple(*args: Any) -> ColumnExpression:
    return MakeTupleExpression(*[_wrap(a) for a in args])


def apply(fun: Callable, *args: Any, **kwargs: Any) -> ColumnExpression:
    """Apply a Python function per row (reference ``pw.apply``).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... name
    ... alice
    ... bob
    ... ''')
    >>> out = t.select(length=pw.apply(len, t.name))
    >>> pw.debug.compute_and_print(out, include_id=False)
    length
    3
    5
    """
    import typing as _t

    hints = {}
    try:
        hints = _t.get_type_hints(fun)
    except Exception:
        pass
    ret = hints.get("return", dt.ANY)
    return ApplyExpression(fun, ret, args, kwargs)


def apply_with_type(fun: Callable, ret_type: Any, *args: Any, **kwargs: Any) -> ColumnExpression:
    return ApplyExpression(fun, ret_type, args, kwargs)


def apply_async(fun: Callable, *args: Any, **kwargs: Any) -> ColumnExpression:
    import typing as _t

    hints = {}
    try:
        hints = _t.get_type_hints(fun)
    except Exception:
        pass
    ret = hints.get("return", dt.ANY)
    return AsyncApplyExpression(fun, ret, args, kwargs)


def assert_table_has_columns(*a: Any, **k: Any) -> None:  # compat helper
    pass


__all__ = [
    "ColumnExpression",
    "ColumnReference",
    "ConstExpression",
    "BinaryExpression",
    "UnaryExpression",
    "IfElseExpression",
    "CoalesceExpression",
    "RequireExpression",
    "ApplyExpression",
    "AsyncApplyExpression",
    "FullyAsyncApplyExpression",
    "CastExpression",
    "ConvertExpression",
    "PointerExpression",
    "MakeTupleExpression",
    "GetExpression",
    "UnwrapExpression",
    "FillErrorExpression",
    "MethodCallExpression",
    "ReducerExpression",
    "IsNoneExpression",
    "if_else",
    "coalesce",
    "require",
    "cast",
    "unwrap",
    "fill_error",
    "make_tuple",
    "apply",
    "apply_with_type",
    "apply_async",
]
