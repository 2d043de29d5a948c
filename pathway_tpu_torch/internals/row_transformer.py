"""Row transformers — the legacy class-transformer API (reference
``internals/row_transformer.py`` + ``decorators.py``:
``@pw.transformer`` classes of ``pw.ClassArg`` tables with
``pw.input_attribute`` / ``@pw.output_attribute`` / ``@pw.method``).

Rows reference OTHER rows by pointer (``self.transformer.t[ptr].attr``),
so an attribute's value can depend on an unbounded pointer walk (linked
lists, skip lists).  Execution re-design for the epoch engine: one
centralized node per output table holds every input table's rows and
lazily evaluates attributes with memoization per epoch; only rows whose
outputs changed re-emit.  (The reference tracks fine-grained per-cell
dependencies inside its engine; epoch-level memoized recompute gives
the same externally observable updates for this legacy API.)
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import cluster as cl
from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.engine.stream import Update, consolidate
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals.parse_graph import G

__all__ = [
    "ClassArg",
    "RowTransformer",
    "input_attribute",
    "input_method",
    "method",
    "output_attribute",
    "transformer",
]


class _InputAttribute:
    _counter = 0

    def __init__(self, type: Any = float):
        self.type = type
        _InputAttribute._counter += 1
        self.order = _InputAttribute._counter
        self.name: str | None = None  # filled by ClassArg.__init_subclass__


class _OutputAttribute:
    def __init__(self, func: Callable):
        self.func = func
        self.name = func.__name__


class _Method:
    def __init__(self, func: Callable, is_output: bool = True):
        self.func = func
        self.name = func.__name__
        self.is_output = is_output


def input_attribute(type: Any = float) -> Any:
    """Declare an input column of the class-arg table."""
    return _InputAttribute(type)


def output_attribute(func: Callable) -> _OutputAttribute:
    """Decorate a zero-arg method: becomes an output column."""
    return _OutputAttribute(func)


def method(func: Callable) -> _Method:
    """Decorate a method callable from other attributes (exposed as a
    callable column in the output, like the reference's MethodColumn)."""
    return _Method(func)


input_method = input_attribute  # reference alias surface


class ClassArg:
    """Base for a transformer's per-table argument class.  At runtime an
    instance is a ROW VIEW: ``self.id``, input attributes from the row,
    output attributes computed (and memoized) on demand."""

    _input_attrs: list[_InputAttribute]
    _output_attrs: list[_OutputAttribute]
    _methods: list[_Method]

    def __init_subclass__(cls, input: Any = None, output: Any = None, **kw: Any):
        super().__init_subclass__(**kw)
        cls._input_schema = input
        cls._output_schema = output
        ins, outs, methods = [], [], []
        for name, v in list(cls.__dict__.items()):
            if isinstance(v, _InputAttribute):
                v.name = name
                ins.append(v)
            elif isinstance(v, _OutputAttribute):
                outs.append(v)
            elif isinstance(v, _Method):
                methods.append(v)
        ins.sort(key=lambda a: a.order)
        cls._input_attrs = ins
        cls._output_attrs = outs
        cls._methods = methods
        # remove the declarations from the class so instance attribute
        # access falls through to __getattr__ (the runtime resolver)
        for spec_list in (ins, outs, methods):
            for a in spec_list:
                if a.name and hasattr(cls, a.name):
                    delattr(cls, a.name)

    # -- runtime row view -------------------------------------------------
    def __init__(self, runtime: "_Runtime", table: str, key: Any):
        self._runtime = runtime
        self._table = table
        self.id = key

    @property
    def transformer(self) -> "_Runtime":
        return self._runtime

    def pointer_from(self, *args: Any) -> K.Pointer:
        return K.ref_scalar(*args)

    def __getattr__(self, name: str):
        # called only when normal lookup fails — resolve input/output attrs
        runtime = self.__dict__.get("_runtime")
        if runtime is None:
            raise AttributeError(name)
        return runtime._resolve(self._table, self.id, name)


class _RowView:
    """Proxy for ``self.transformer.<table>[pointer]``."""

    def __init__(self, runtime: "_Runtime", table: str):
        self._runtime = runtime
        self._table = table

    def __getitem__(self, key: Any) -> Any:
        return _InstanceView(self._runtime, self._table, key)


class _InstanceView:
    def __init__(self, runtime: "_Runtime", table: str, key: Any):
        self._runtime = runtime
        self._table = table
        self.id = key

    def __getattr__(self, name: str):
        return self._runtime._resolve(self._table, self.id, name)


class _Runtime:
    """Evaluation context for one epoch: all tables' rows + memo cache."""

    def __init__(self, spec: "RowTransformer", rows: dict[str, dict]):
        self._spec = spec
        self._rows = rows  # table name -> {key: value tuple}
        self._memo: dict[tuple, Any] = {}
        self._in_progress: set[tuple] = set()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._spec.class_args:
            return _RowView(self, name)
        raise AttributeError(name)

    def _resolve(self, table: str, key: Any, name: str) -> Any:
        cls = self._spec.class_args[table]
        row = self._rows[table].get(key)
        if row is None:
            raise KeyError(f"row {key!r} not present in {table!r}")
        for i, ia in enumerate(cls._input_attrs):
            if ia.name == name:
                return row[i]
        for oa in cls._output_attrs:
            if oa.name == name:
                memo_key = (table, key, name)
                if memo_key in self._memo:
                    return self._memo[memo_key]
                if memo_key in self._in_progress:
                    raise RecursionError(
                        f"cyclic attribute dependency at {table}[{key}].{name}"
                    )
                self._in_progress.add(memo_key)
                try:
                    value = oa.func(cls(self, table, key))
                finally:
                    self._in_progress.discard(memo_key)
                self._memo[memo_key] = value
                return value
        for m in cls._methods:
            if m.name == name:
                inst = cls(self, table, key)
                return lambda *a, **kw: m.func(inst, *a, **kw)
        raise AttributeError(f"{table} has no attribute {name!r}")


class _BoundMethod:
    """A method column's value: callable, LATE-BINDING (each call reads
    the node's current rows), and equal across epochs for the same
    (table, key, method) — so method columns never make change detection
    fire for rows whose attributes did not change."""

    def __init__(self, spec, rows_ref: dict, table: str, key: Any, name: str):
        self._spec = spec
        self._rows_ref = rows_ref  # the node state's live rows dict
        self._table = table
        self._key = key
        self._name = name

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        runtime = _Runtime(self._spec, self._rows_ref)
        fn = runtime._resolve(self._table, self._key, self._name)
        return fn(*args, **kwargs)

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, _BoundMethod)
            and self._table == other._table
            and self._key == other._key
            and self._name == other._name
        )

    def __hash__(self) -> int:
        return hash((self._table, self._key, self._name))

    def __repr__(self) -> str:
        return f"<method {self._table}[{self._key!r}].{self._name}>"


class _RowTransformerNode(eg.Node):
    """Holds every input table's rows; re-evaluates ONE class arg's output
    attributes each epoch, emitting only changed rows."""

    # pointer walks cross arbitrary rows: centralize (reference runs row
    # transformers inside one worker's scope too)
    exchange_routes = cl.route_all_to_zero

    def __init__(self, graph, inputs, spec, target: str, name=None):
        super().__init__(graph, inputs, name or f"transformer_{spec.name}_{target}")
        self.spec = spec
        self.target = target

    def make_state(self):
        return {
            "rows": {name: {} for name in self.spec.class_args},
            "out": {},
        }

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        changed = False
        for (name, _cls), batch in zip(self.spec.class_args.items(), inbatches):
            rows = st["rows"][name]
            for u in batch:
                changed = True
                if u.diff > 0:
                    rows[u.key] = u.values
                else:
                    rows.pop(u.key, None)
        if not changed:
            return []
        runtime = _Runtime(self.spec, st["rows"])
        cls = self.spec.class_args[self.target]
        out: list[Update] = []
        new_out: dict[Any, tuple] = {}
        for key in st["rows"][self.target]:
            vals = []
            ok = True
            for oa in cls._output_attrs:
                try:
                    vals.append(runtime._resolve(self.target, key, oa.name))
                except Exception as e:  # noqa: BLE001 — contained per row
                    ctx.log_error(self, f"{self.name}[{key!r}].{oa.name}: {e!r}")
                    ok = False
                    break
            if not ok:
                continue
            for m in cls._methods:
                vals.append(
                    _BoundMethod(
                        self.spec, st["rows"], self.target, key, m.name
                    )
                )
            new_out[key] = tuple(vals)
        for key, old in st["out"].items():
            if key not in new_out:
                out.append(Update(key, old, -1))
            elif new_out[key] != old:
                out.append(Update(key, old, -1))
                out.append(Update(key, new_out[key], 1))
        for key, vals in new_out.items():
            if key not in st["out"]:
                out.append(Update(key, vals, 1))
        st["out"] = new_out
        return consolidate(out)


class _TransformerResult:
    def __init__(self, tables: dict[str, Any]):
        for name, t in tables.items():
            setattr(self, name, t)


class RowTransformer:
    def __init__(self, name: str, class_args: dict[str, type]):
        self.name = name
        self.class_args = class_args

    def __call__(self, **tables: Any) -> _TransformerResult:
        from pathway_tpu_torch.internals.table import Table

        missing = set(self.class_args) - set(tables)
        if missing:
            raise TypeError(f"transformer {self.name} missing tables: {missing}")
        input_nodes = [tables[name]._node for name in self.class_args]
        outs: dict[str, Table] = {}
        for target, cls in self.class_args.items():
            node = _RowTransformerNode(
                G.engine_graph, input_nodes, self, target
            )
            cols = [oa.name for oa in cls._output_attrs] + [
                m.name for m in cls._methods
            ]
            dtypes = {c: dt.ANY for c in cols}
            outs[target] = Table(
                node, cols, dtypes, name=f"{self.name}.{target}"
            )
        return _TransformerResult(outs)


def transformer(cls: type) -> RowTransformer:
    """``@pw.transformer`` — turn a class of ``ClassArg`` inner classes
    into a callable row transformer."""
    class_args = {
        name: v
        for name, v in vars(cls).items()
        if isinstance(v, type) and issubclass(v, ClassArg)
    }
    if not class_args:
        raise TypeError(
            f"@pw.transformer class {cls.__name__} defines no ClassArg tables"
        )
    return RowTransformer(cls.__name__, class_args)
