"""The ``pw.Table`` user API.

Capability parity with reference ``python/pathway/internals/table.py`` (2675
LoC): lazily-built keyed tables with select/filter/groupby/reduce/join/
concat/update/ix/flatten/... methods.  Construction is eager *graph
building* (engine nodes are created immediately); execution happens at
``pw.run()``/``pw.debug.compute_and_print`` via the epoch scheduler.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping

from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expr_vm as _vm
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    ColumnExpression,
    ColumnReference,
    ConstExpression,
    PointerExpression,
    ReducerExpression,
    _wrap,
    smart_name,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.thisclass import ThisMetaclass, left as LEFT, right as RIGHT, this as THIS
from pathway_tpu_torch.engine import graph as eg


def _referenced_names(exprs: Iterable[ColumnExpression]) -> list[str]:
    """Input column names an expression list reads — build-time metadata
    for the static analyzer's dead-column pass (``analysis/passes.py``)."""
    names: set[str] = set()
    for e in exprs:
        try:
            for r in e._references():
                names.add(r._name)
        except Exception:
            pass
    names.discard("id")
    return sorted(names)


class _Layout:
    """Maps column references to accessors over engine row tuples.

    Matching is two-pass: exact table identity first, then "family" — the set
    of layout-preserving ancestor nodes (filter/intersect/difference/...) that
    share both universe and column layout, so a reference to the parent table
    resolves positionally on the derived one."""

    def __init__(self) -> None:
        # entries: (table, name->pos mapping, id_accessor_pos or None)
        self.entries: list[tuple[Any, dict[str, int | None], int | None]] = []

    def add(self, table: Any, mapping: dict[str, int | None], id_pos: int | None = None) -> None:
        self.entries.append((table, mapping, id_pos))

    @staticmethod
    def _family_match(entry_table: Any, t: Any) -> bool:
        fam = getattr(entry_table, "_family", None)
        node = getattr(t, "_node", None)
        return fam is not None and node is not None and node.id in fam

    def _build(self, ref: ColumnReference, mapping: dict, id_pos: int | None) -> Callable[[tuple], Any]:
        if ref._name == "id":
            if id_pos is None:
                return lambda kv: kv[0]
            pos = id_pos
            return lambda kv, pos=pos: kv[1][pos]
        if ref._name in mapping:
            pos = mapping[ref._name]
            if pos is None:
                raise ValueError(
                    f"Column {ref._name!r} is ambiguous here; qualify it "
                    "with pw.left / pw.right"
                )
            return lambda kv, pos=pos: kv[1][pos]
        raise KeyError(
            f"Table has no column {ref._name!r}; available: {list(mapping)}"
        )

    def resolver(self, ref: ColumnReference) -> Callable[[tuple], Any]:
        t = ref._table
        for table, mapping, id_pos in self.entries:
            if table is t:
                return self._build(ref, mapping, id_pos)
        for table, mapping, id_pos in self.entries:
            if self._family_match(table, t):
                return self._build(ref, mapping, id_pos)
        raise ValueError(
            f"Expression references table {getattr(t, '_name', t)!r} that is not part "
            "of this operation (universes must match)"
        )

    def resolve_pos(self, ref: ColumnReference) -> int | None:
        """Positional resolution for native fast paths: the value-tuple
        index, ``-1`` for the row key, or None when the reference isn't a
        plain positional column of this layout."""
        t = ref._table
        entry = None
        for table, mapping, id_pos in self.entries:
            if table is t:
                entry = (mapping, id_pos)
                break
        if entry is None:
            for table, mapping, id_pos in self.entries:
                if self._family_match(table, t):
                    entry = (mapping, id_pos)
                    break
        if entry is None:
            return None
        mapping, id_pos = entry
        if ref._name == "id":
            return -1 if id_pos is None else id_pos
        return mapping.get(ref._name)


def compile_exprs(
    exprs: list[ColumnExpression], layout: _Layout
) -> Callable[[Any, tuple], tuple]:
    compiled = [e._compile(layout.resolver) for e in exprs]

    if len(compiled) == 1:
        c0 = compiled[0]

        def row_fn(key: Any, values: tuple) -> tuple:
            return (c0((key, values)),)

    elif len(compiled) == 2:
        ca, cb = compiled

        def row_fn(key: Any, values: tuple) -> tuple:
            kv = (key, values)
            return (ca(kv), cb(kv))

    else:

        def row_fn(key: Any, values: tuple) -> tuple:
            kv = (key, values)
            return tuple(c(kv) for c in compiled)

    return row_fn


class TableSlice:
    """An ordered {output name -> column reference} view of a table
    (reference ``internals/table_slice.py``).  Iterating yields the
    references; passing the slice to ``select``/``with_columns`` keeps
    its renames."""

    def __init__(self, table: Any, mapping: "dict[str, ColumnReference]"):
        self._table = table
        self._mapping = dict(mapping)

    def __iter__(self):
        return iter(self._mapping.values())

    def keys(self) -> list[str]:
        return list(self._mapping)

    def __repr__(self) -> str:
        return f"TableSlice({list(self._mapping)})"

    def _name_of(self, col: Any) -> str:
        if isinstance(col, ColumnReference):
            if col._table is not self._table:
                raise ValueError(
                    f"column reference {col!r} belongs to a different table "
                    "than this slice"
                )
            name = col._name
        else:
            name = col
        if name not in self._mapping:
            raise KeyError(
                f"slice has no column {name!r}; available: {list(self._mapping)}"
            )
        return name

    def __getitem__(self, arg: Any):
        if isinstance(arg, (list, tuple)):
            return TableSlice(
                self._table,
                {self._name_of(c): self._mapping[self._name_of(c)] for c in arg},
            )
        return self._mapping[self._name_of(arg)]

    def without(self, *cols: Any) -> "TableSlice":
        drop = {self._name_of(c) for c in cols}
        return TableSlice(
            self._table,
            {n: r for n, r in self._mapping.items() if n not in drop},
        )

    def rename(self, mapping: "dict[Any, str]") -> "TableSlice":
        renames = {self._name_of(k): v for k, v in mapping.items()}
        out: dict[str, ColumnReference] = {}
        for n, r in self._mapping.items():
            target = renames.get(n, n)
            if target in out or (
                target != n and target in self._mapping and target not in renames
            ):
                # a collision would silently drop a column's data
                raise ValueError(
                    f"rename target {target!r} collides with an existing "
                    "column; rename or drop the other column first"
                )
            out[target] = r
        return TableSlice(self._table, out)

    def with_prefix(self, prefix: str) -> "TableSlice":
        return TableSlice(
            self._table, {prefix + n: r for n, r in self._mapping.items()}
        )

    def with_suffix(self, suffix: str) -> "TableSlice":
        return TableSlice(
            self._table, {n + suffix: r for n, r in self._mapping.items()}
        )


def _contains_async(expr: ColumnExpression) -> bool:
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, AsyncApplyExpression):
            return True
        stack.extend(e._children())
    return False


class Table:
    def __init__(
        self,
        node: eg.Node,
        column_names: list[str],
        dtypes: Mapping[str, dt.DType] | None = None,
        name: str = "table",
        layout_token: Any = None,
        id_dtype: dt.DType = dt.POINTER,
        family: frozenset | None = None,
    ):
        self._node = node
        self._column_names = list(column_names)
        self._dtypes = dict(dtypes) if dtypes else {c: dt.ANY for c in column_names}
        for c in column_names:
            self._dtypes.setdefault(c, dt.ANY)
        self._name = name
        from pathway_tpu_torch.internals.universe_solver import UniverseToken

        self._layout_token = (
            layout_token if layout_token is not None else UniverseToken()
        )
        self._id_dtype = id_dtype
        #: node ids sharing this table's (universe, column layout) — a
        #: reference to any of them resolves positionally on this table
        self._family: frozenset = (family or frozenset()) | {node.id}

    # -- introspection ------------------------------------------------------
    @property
    def schema(self) -> sch.SchemaMetaclass:
        return sch.schema_from_columns(
            {
                c: sch.ColumnDefinition(dtype=self._dtypes[c], name=c)
                for c in self._column_names
            },
            name=f"Schema_{self._name}",
        )

    def column_names(self) -> list[str]:
        return list(self._column_names)

    def keys(self) -> list[str]:
        return self.column_names()

    def typehints(self) -> dict[str, Any]:
        return {c: self._dtypes[c] for c in self._column_names}

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._column_names:
            raise AttributeError(
                f"Table has no column {name!r}; available: {self._column_names}"
            )
        return ColumnReference(self, name)

    def __getitem__(self, arg: Any) -> Any:
        if isinstance(arg, str):
            if arg == "id":
                return self.id
            if arg not in self._column_names:
                raise KeyError(arg)
            return ColumnReference(self, arg)
        if isinstance(arg, ColumnReference):
            return self[arg._name]
        if isinstance(arg, (list, tuple)):
            return self.select(*[self[c] for c in arg])
        raise TypeError(f"Cannot index Table with {arg!r}")

    @property
    def slice(self) -> "TableSlice":
        """Lazy column-set helper (reference ``TableSlice``,
        ``internals/table_slice.py``): ``t.select(t.slice.without("a"))``,
        ``t.slice.with_prefix("l_")`` etc."""
        return TableSlice(
            self, {c: ColumnReference(self, c) for c in self._column_names}
        )

    def __iter__(self) -> Iterable[ColumnReference]:
        return iter([self[c] for c in self._column_names])

    def __repr__(self) -> str:
        cols = ", ".join(f"{c}: {self._dtypes[c]!r}" for c in self._column_names)
        return f"<pw.Table {self._name}({cols})>"

    def _layout(self) -> _Layout:
        layout = _Layout()
        layout.add(self, {c: i for i, c in enumerate(self._column_names)})
        return layout

    def _prepare(self, exprs: list[ColumnExpression]) -> tuple[_Layout, eg.Node]:
        """Layout + engine node for rowwise evaluation of ``exprs``.

        References to other same-universe tables (same layout token but
        layout-incompatible, e.g. an ``ix`` result) are satisfied by zipping
        those tables' nodes by key."""
        zip_tables: list[Table] = []
        for e in exprs:
            for r in e._references():
                t = r._table
                if t is self or _Layout._family_match(self, t):
                    continue
                if any(t is z or _Layout._family_match(z, t) for z in zip_tables):
                    continue
                if getattr(t, "_layout_token", None) is self._layout_token:
                    zip_tables.append(t)
                # else: leave it to the resolver to raise a clear error
        if not zip_tables:
            return self._layout(), self._node
        widths = [len(self._column_names)] + [len(t._column_names) for t in zip_tables]
        node = eg.ZipNode(
            G.engine_graph,
            [self._node] + [t._node for t in zip_tables],
            widths,
        )
        layout = _Layout()
        layout.add(self, {c: i for i, c in enumerate(self._column_names)})
        offset = len(self._column_names)
        for t in zip_tables:
            layout.add(t, {c: offset + i for i, c in enumerate(t._column_names)})
            offset += len(t._column_names)
        return layout, node

    def _subst(self, expr: Any) -> ColumnExpression:
        return _wrap(expr)._substitute({THIS: self})

    # -- row transforms -----------------------------------------------------
    def _gather_select(
        self, args: tuple, kwargs: dict
    ) -> tuple[list[str], list[ColumnExpression]]:
        names: list[str] = []
        exprs: list[ColumnExpression] = []
        for a in args:
            if isinstance(a, ThisMetaclass):
                # pw.this splat: all columns
                for c in self._column_names:
                    names.append(c)
                    exprs.append(ColumnReference(self, c))
                continue
            if isinstance(a, TableSlice):
                # t.select(*...) also works, but passing the slice itself
                # keeps its renames: select(t.slice.with_prefix("l_"))
                for n, ref in a._mapping.items():
                    names.append(n)
                    exprs.append(ref)
                continue
            e = self._subst(a)
            n = smart_name(e)
            if n is None:
                raise ValueError(
                    "Positional select() arguments must be column references; "
                    "use keyword arguments for computed columns"
                )
            names.append(n)
            exprs.append(e)
        for n, a in kwargs.items():
            names.append(n)
            exprs.append(self._subst(a))
        return names, exprs

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        """Compute a new column set per row (reference ``Table.select``).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a | b
        ... 3 | foo
        ... 5 | bar
        ... ''')
        >>> out = t.select(t.a, double=t.a * 2, upper=t.b.str.upper())
        >>> pw.debug.compute_and_print(out, include_id=False)
        a | double | upper
        3 | 6      | 'FOO'
        5 | 10     | 'BAR'
        """
        names, exprs = self._gather_select(args, kwargs)
        seen: dict[str, int] = {}
        for i, n in enumerate(names):
            seen[n] = i  # later wins
        order = sorted(seen.values())
        names = [names[i] for i in order]
        exprs = [exprs[i] for i in order]
        layout, in_node = self._prepare(exprs)
        async_idx = [i for i, e in enumerate(exprs) if _contains_async(e)]
        dtypes = {n: e._dtype for n, e in zip(names, exprs)}
        if async_idx:
            return self._select_async(names, exprs, layout, dtypes, in_node)
        row_fn = compile_exprs(exprs, layout)
        node = eg.RowwiseNode(
            G.engine_graph, in_node, row_fn, name="select",
            typecheck_info=(names, [dtypes[n] for n in names]),
            programs=_vm.lower_programs(exprs, layout),
        )
        node.meta["select"] = {
            "kind": "select",
            "names": list(names),
            "exprs": list(exprs),
            "layout": layout,
            "dtypes": [dtypes[n] for n in names],
        }
        node.meta["used_cols"] = _referenced_names(exprs)
        # select keeps row keys -> same universe token; new layout family
        return Table(
            node, names, dtypes, name=f"{self._name}.select",
            layout_token=self._layout_token,
        )

    def _select_async(
        self,
        names: list[str],
        exprs: list[ColumnExpression],
        layout: _Layout,
        dtypes: dict[str, dt.DType],
        in_node: eg.Node | None = None,
    ) -> "Table":
        """Async apply columns: batch all rows of the epoch through the async
        executor (reference ``map_named_async`` micro-batching)."""
        from pathway_tpu_torch.internals.udfs import run_async_batch

        from pathway_tpu_torch.internals.expression import BatchApplyExpression

        async_exprs = [(i, e) for i, e in enumerate(exprs) if _contains_async(e)]
        sync_exprs = [(i, e) for i, e in enumerate(exprs) if not _contains_async(e)]
        sync_fns = [(i, e._compile(layout.resolver)) for i, e in sync_exprs]
        async_plans = []
        for i, e in async_exprs:
            assert isinstance(e, AsyncApplyExpression)
            arg_fns = [a._compile(layout.resolver) for a in e._args]
            kw_fns = {k: v._compile(layout.resolver) for k, v in e._kwargs.items()}
            async_plans.append(
                (
                    i,
                    e._fun,
                    arg_fns,
                    kw_fns,
                    isinstance(e, BatchApplyExpression),
                    e._propagate_none,
                )
            )

        if in_node is None:
            in_node = self._node
        n_in = (
            sum(in_node.widths) if isinstance(in_node, eg.ZipNode) else len(self._column_names)
        )

        def batch_fn(rows: list[tuple]) -> list[Any]:
            # rows are (original input values + hidden key at end)? we receive raw values
            kvs = [((r[-1]), r[:-1]) for r in rows]
            results: list[list[Any]] = [[None] * len(exprs) for _ in rows]
            for i, fn in sync_fns:
                for j, kv in enumerate(kvs):
                    results[j][i] = fn(kv)
            for i, fun, arg_fns, kw_fns, is_batch, prop_none in async_plans:
                if is_batch:
                    # one call with per-argument LISTS (jitted TPU batch).
                    # Rows with ERROR (or None under propagate_none) inputs
                    # are screened out so one bad row can't poison the batch.
                    all_args = [[f(kv) for f in arg_fns] for kv in kvs]
                    all_kw = [{k: f(kv) for k, f in kw_fns.items()} for kv in kvs]

                    def _bad(vals: Iterable) -> Any:
                        for v in vals:
                            if v is api.ERROR:
                                return api.ERROR
                            if v is None and prop_none:
                                return None
                        return False

                    sentinel = [
                        _bad(list(a) + list(k.values()))
                        for a, k in zip(all_args, all_kw)
                    ]
                    clean = [j for j, s in enumerate(sentinel) if s is False]
                    outs_clean: list[Any] = []
                    if clean:
                        arg_lists = [
                            [all_args[j][ai] for j in clean]
                            for ai in range(len(arg_fns))
                        ]
                        kw_lists = {
                            k: [all_kw[j][k] for j in clean] for k in kw_fns
                        }
                        outs_clean = list(fun(*arg_lists, **kw_lists))
                        if len(outs_clean) != len(clean):
                            raise ValueError(
                                f"batch UDF returned {len(outs_clean)} results "
                                f"for {len(clean)} rows"
                            )
                    outs = list(sentinel)
                    for j, o in zip(clean, outs_clean):
                        outs[j] = o
                else:
                    calls = []
                    for kv in kvs:
                        calls.append(
                            (
                                [f(kv) for f in arg_fns],
                                {k: f(kv) for k, f in kw_fns.items()},
                            )
                        )
                    outs = run_async_batch(fun, calls)
                for j, o in enumerate(outs):
                    results[j][i] = o
            return [tuple(r) for r in results]

        # append key as a hidden column so batch_fn can resolve `id` refs
        key_node = eg.RowwiseNode(
            G.engine_graph,
            in_node,
            lambda key, values: values + (key,),
            name="attach_key",
        )
        anode = eg.AsyncMapNode(
            G.engine_graph,
            key_node,
            batch_fn,
            name="async_select",
            # device-batched UDFs need the whole epoch batch on the TPU
            # host (worker 0); pure async-IO UDFs shard across workers
            distributed=not any(plan[4] for plan in async_plans),
        )
        # AsyncMapNode emits values + (result,); extract the result tuple
        unpack = eg.RowwiseNode(
            G.engine_graph,
            anode,
            lambda key, values: tuple(values[n_in + 1]),
            name="unpack_async",
        )
        return Table(
            unpack, names, dtypes, name=f"{self._name}.select",
            layout_token=self._layout_token,
        )

    def _gradual_broadcast(
        self,
        threshold_table: "Table",
        lower_column: Any,
        value_column: Any,
        upper_column: Any,
    ) -> "Table":
        """Append an ``apx_value`` column broadcast from a (usually 1-row)
        threshold table's ``(lower, value, upper)`` approximation triplet;
        rows only re-emit when their held value leaves the new window
        (reference ``Table._gradual_broadcast``, ``internals/table.py:631``
        over ``src/engine/dataflow/operators/gradual_broadcast.rs``)."""
        exprs = [
            threshold_table._subst(e)
            for e in (lower_column, value_column, upper_column)
        ]
        tlayout = threshold_table._layout()
        triplet_fn = compile_exprs(exprs, tlayout)
        node = eg.GradualBroadcastNode(
            G.engine_graph, self._node, threshold_table._node, triplet_fn
        )
        cols = self._column_names + ["apx_value"]
        dtypes = dict(self._dtypes)
        dtypes["apx_value"] = dt.Optional(dt.FLOAT)
        return Table(node, cols, dtypes, name=f"{self._name}.gradual_broadcast")

    def filter(self, expr: Any) -> "Table":
        """Keep rows where ``expr`` is truthy.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a
        ... 1
        ... 4
        ... 7
        ... ''')
        >>> pw.debug.compute_and_print(t.filter(t.a > 2), include_id=False)
        a
        4
        7
        """
        e = self._subst(expr)
        layout, in_node = self._prepare([e])
        c = e._compile(layout.resolver)
        node: eg.Node = eg.FilterNode(
            G.engine_graph, in_node, lambda key, values: c((key, values)),
            program=_vm.lower_program(e, layout),
        )
        node.meta["filter"] = {"exprs": [e], "layout": layout}
        node.meta["used_cols"] = _referenced_names([e])
        if in_node is not self._node:
            # predicate needed zipped columns: project back to our layout
            n = len(self._column_names)
            node = eg.RowwiseNode(
                G.engine_graph, node, lambda key, values: values[:n], name="project",
                programs=_vm.project_program(list(range(n))),
            )
        return Table(
            node,
            self._column_names,
            self._dtypes,
            name=f"{self._name}.filter",
            layout_token=self._layout_token,
            family=self._family,
        )

    def with_columns(self, *args: Any, **kwargs: Any) -> "Table":
        """All existing columns plus the given new/overridden ones.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a
        ... 1
        ... 2
        ... ''')
        >>> pw.debug.compute_and_print(t.with_columns(b=t.a + 10), include_id=False)
        a | b
        1 | 11
        2 | 12
        """
        names, exprs = self._gather_select(args, kwargs)
        all_names = list(self._column_names)
        all_exprs: list[ColumnExpression] = [
            ColumnReference(self, c) for c in self._column_names
        ]
        for n, e in zip(names, exprs):
            if n in all_names:
                all_exprs[all_names.index(n)] = e
            else:
                all_names.append(n)
                all_exprs.append(e)
        layout, in_node = self._prepare(all_exprs)
        dtypes = {n: e._dtype for n, e in zip(all_names, all_exprs)}
        if any(_contains_async(e) for e in all_exprs):
            return self._select_async(all_names, all_exprs, layout, dtypes, in_node)
        row_fn = compile_exprs(all_exprs, layout)
        node = eg.RowwiseNode(
            G.engine_graph, in_node, row_fn, name="with_columns",
            programs=_vm.lower_programs(all_exprs, layout),
        )
        node.meta["select"] = {
            "kind": "with_columns",  # pass-through columns exempt from PW-D001
            "names": list(all_names),
            "exprs": list(all_exprs),
            "layout": layout,
            "dtypes": [dtypes[n] for n in all_names],
        }
        node.meta["used_cols"] = _referenced_names(all_exprs)
        return Table(
            node, all_names, dtypes, name=f"{self._name}.with_columns",
            layout_token=self._layout_token,
        )

    def without(self, *columns: Any) -> "Table":
        drop = {c._name if isinstance(c, ColumnReference) else c for c in columns}
        keep = [c for c in self._column_names if c not in drop]
        return self.select(*[self[c] for c in keep])

    def rename(self, names_mapping: Mapping[Any, str] | None = None, **kwargs: str) -> "Table":
        mapping: dict[str, str] = {}
        if names_mapping:
            for k, v in names_mapping.items():
                mapping[k._name if isinstance(k, ColumnReference) else k] = v
        # kwargs: new_name=old_ref style (reference rename_columns(new=old))
        sel: dict[str, Any] = {}
        for c in self._column_names:
            if c in mapping:
                sel[mapping[c]] = self[c]
            else:
                sel[c] = self[c]
        for new, old in kwargs.items():
            old_name = old._name if isinstance(old, ColumnReference) else old
            sel.pop(old_name, None)
            sel[new] = self[old_name]
        return self.select(**sel)

    rename_columns = rename

    def rename_by_dict(self, names_mapping: Mapping[Any, str]) -> "Table":
        return self.rename(names_mapping)

    def with_suffix(self, suffix: str) -> "Table":
        return self.select(**{c + suffix: self[c] for c in self._column_names})

    def with_prefix(self, prefix: str) -> "Table":
        return self.select(**{prefix + c: self[c] for c in self._column_names})

    def cast_to_types(self, **kwargs: Any) -> "Table":
        from pathway_tpu_torch.internals.expression import cast

        sel = {c: self[c] for c in self._column_names}
        for n, t in kwargs.items():
            sel[n] = cast(t, self[n])
        return self.select(**sel)

    def update_types(self, **kwargs: Any) -> "Table":
        out = self.copy()
        for n, t in kwargs.items():
            out._dtypes[n] = dt.wrap(t)
        return out

    def copy(self) -> "Table":
        return Table(
            self._node,
            self._column_names,
            self._dtypes,
            name=self._name,
            layout_token=self._layout_token,
            family=self._family,
        )

    def await_futures(self) -> "Table":
        """Reference ``Table.await_futures``: make async-UDF results
        concrete.  This engine resolves async UDFs WITHIN the epoch
        (AsyncMapNode batches the whole epoch through the event loop), so
        values are already concrete — only the Future dtypes unwrap."""
        out = self.copy()
        out._dtypes = {
            c: (d.wrapped if isinstance(d, dt.Future) else d)
            for c, d in self._dtypes.items()
        }
        return out

    # -- keys / pointers ----------------------------------------------------
    def pointer_from(self, *args: Any, optional: bool = False, instance: Any = None) -> ColumnExpression:
        # NOTE: `pw.this` in args stays unresolved — it refers to the table
        # the expression is *used* on, not to the pointer's target (self).
        return PointerExpression(self, *[_wrap(a) for a in args], optional=optional)

    def with_id_from(self, *args: Any, instance: Any = None) -> "Table":
        exprs = [self._subst(a) for a in args]
        layout = self._layout()
        cs = [e._compile(layout.resolver) for e in exprs]

        def key_fn(key: Any, values: tuple) -> K.Pointer:
            kv = (key, values)
            return K.ref_scalar(*[c(kv) for c in cs])

        node = eg.ReindexNode(G.engine_graph, self._node, key_fn, name="with_id_from")
        return Table(node, self._column_names, self._dtypes, name=f"{self._name}.with_id_from")

    def with_id(self, new_id: ColumnReference) -> "Table":
        e = self._subst(new_id)
        layout = self._layout()
        c = e._compile(layout.resolver)
        node = eg.ReindexNode(
            G.engine_graph, self._node, lambda key, values: c((key, values)), name="with_id"
        )
        return Table(node, self._column_names, self._dtypes, name=f"{self._name}.with_id")

    # -- set operations -----------------------------------------------------
    def concat(self, *others: "Table") -> "Table":
        tables = [self, *others]
        for t in tables[1:]:
            if t._column_names != self._column_names:
                raise ValueError(
                    f"concat: column mismatch {t._column_names} vs {self._column_names}"
                )
        node = eg.ConcatNode(G.engine_graph, [t._node for t in tables])
        node.meta["concat"] = {
            "columns": {
                c: [t._dtypes[c] for t in tables] for c in self._column_names
            }
        }
        dtypes = {
            c: dt.lub_many(*[t._dtypes[c] for t in tables]) for c in self._column_names
        }
        return Table(node, self._column_names, dtypes, name="concat")

    def concat_reindex(self, *others: "Table") -> "Table":
        """Union of same-schema tables under fresh row keys.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> a = pw.debug.table_from_markdown('''
        ... x
        ... 1
        ... ''')
        >>> b = pw.debug.table_from_markdown('''
        ... x
        ... 2
        ... ''')
        >>> pw.debug.compute_and_print(a.concat_reindex(b), include_id=False)
        x
        1
        2
        """
        tables = [self, *others]
        reindexed = []
        for i, t in enumerate(tables):
            node = eg.ReindexNode(
                G.engine_graph,
                t._node,
                lambda key, values, i=i: K.derive(key, "concat", i),
                name="concat_reindex",
            )
            reindexed.append(
                Table(node, t._column_names, t._dtypes, name=f"reindex{i}")
            )
        return reindexed[0].concat(*reindexed[1:])

    def update_rows(self, other: "Table") -> "Table":
        """Per key, rows of ``other`` override rows of ``self``.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> a = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | x
        ... 2  | y
        ... ''')
        >>> b = pw.debug.table_from_markdown('''
        ... id | v
        ... 2  | z
        ... ''')
        >>> pw.debug.compute_and_print(a.update_rows(b), include_id=False)
        v
        'x'
        'z'
        """
        if other._column_names != self._column_names:
            other = other.select(**{c: other[c] for c in self._column_names})
        node = eg.UpdateRowsNode(G.engine_graph, self._node, other._node)
        dtypes = {
            c: dt.lub(self._dtypes[c], other._dtypes[c]) for c in self._column_names
        }
        return Table(node, self._column_names, dtypes, name="update_rows")

    def update_cells(self, other: "Table") -> "Table":
        for c in other._column_names:
            if c not in self._column_names:
                raise ValueError(f"update_cells: unknown column {c!r}")
        col_map: list[tuple[int, int]] = []
        for i, c in enumerate(self._column_names):
            if c in other._column_names:
                col_map.append((1, other._column_names.index(c)))
            else:
                col_map.append((0, i))
        node = eg.UpdateCellsNode(G.engine_graph, self._node, other._node, col_map)
        dtypes = dict(self._dtypes)
        for c in other._column_names:
            dtypes[c] = dt.lub(dtypes[c], other._dtypes[c])
        return Table(node, self._column_names, dtypes, name="update_cells")

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def intersect(self, *others: "Table") -> "Table":
        """Keep rows whose keys appear in every other table.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> a = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | x
        ... 2  | y
        ... ''')
        >>> b = pw.debug.table_from_markdown('''
        ... id | w
        ... 2  | q
        ... ''')
        >>> pw.debug.compute_and_print(a.intersect(b), include_id=False)
        v
        'y'
        """
        node = eg.IntersectNode(
            G.engine_graph, self._node, [t._node for t in others]
        )
        return Table(
            node,
            self._column_names,
            self._dtypes,
            name="intersect",
            layout_token=self._layout_token,
            family=self._family,
        )

    def difference(self, other: "Table") -> "Table":
        """Keep rows whose keys do NOT appear in ``other``.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> a = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | x
        ... 2  | y
        ... ''')
        >>> b = pw.debug.table_from_markdown('''
        ... id | w
        ... 2  | q
        ... ''')
        >>> pw.debug.compute_and_print(a.difference(b), include_id=False)
        v
        'x'
        """
        node = eg.SubtractNode(G.engine_graph, self._node, other._node)
        return Table(
            node,
            self._column_names,
            self._dtypes,
            name="difference",
            layout_token=self._layout_token,
            family=self._family,
        )

    def restrict(self, other: "Table") -> "Table":
        node = eg.IntersectNode(G.engine_graph, self._node, [other._node])
        return Table(
            node,
            self._column_names,
            self._dtypes,
            name="restrict",
            layout_token=self._layout_token,
            family=self._family,
        )

    def with_universe_of(self, other: "Table") -> "Table":
        from pathway_tpu_torch.internals.universe_solver import solver

        # reference semantics: with_universe_of REQUIRES a provable key-set
        # relation.  Rebinding with NO declared relation is a correctness
        # smell (zips may silently drop/misalign rows) — warn, then record
        # the equality claim so later rebinding of the same pair is known.
        if (
            self._layout_token is not other._layout_token
            and not solver.query_related(self._layout_token, other._layout_token)
        ):
            from pathway_tpu_torch.internals.parse_graph import logger

            logger.debug(
                "with_universe_of: no declared key-set relation between "
                "%r and %r (use pw.universes.promise_* to declare one)",
                self._name,
                other._name,
            )
        solver.register_as_equal(other._layout_token, self._layout_token)
        out = self.copy()
        out._layout_token = other._layout_token
        return out

    # -- flatten ------------------------------------------------------------
    def flatten(self, to_flatten: ColumnReference, **kwargs: Any) -> "Table":
        """Explode one sequence column into one row per element.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_rows(
        ...     pw.schema_from_types(xs=tuple), [((1, 2),), ((3,),)]
        ... )
        >>> pw.debug.compute_and_print(t.flatten(t.xs), include_id=False)
        xs
        1
        2
        3
        """
        e = self._subst(to_flatten)
        assert isinstance(e, ColumnReference)
        idx = self._column_names.index(e._name)
        node = eg.FlattenNode(G.engine_graph, self._node, idx)
        dtypes = dict(self._dtypes)
        inner = dtypes[e._name].strip_optional()
        if isinstance(inner, dt.List):
            dtypes[e._name] = inner.element_type
        elif inner == dt.STR:
            dtypes[e._name] = dt.STR
        else:
            dtypes[e._name] = dt.ANY
        return Table(node, self._column_names, dtypes, name=f"{self._name}.flatten")

    # -- groupby / reduce ---------------------------------------------------
    def groupby(self, *args: Any, id: Any = None, instance: Any = None, **kwargs: Any) -> "GroupedTable":
        """Group rows by expressions; follow with ``.reduce(...)``.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... word  | n
        ... apple | 2
        ... pear  | 1
        ... apple | 3
        ... ''')
        >>> res = t.groupby(t.word).reduce(t.word, total=pw.reducers.sum(t.n))
        >>> pw.debug.compute_and_print(res, include_id=False)
        word    | total
        'apple' | 5
        'pear'  | 1
        """
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        grouping = [self._subst(a) for a in args]
        if instance is not None:
            grouping.append(self._subst(instance))
        return GroupedTable(self, grouping, set_id=id is not None)

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        return GroupedTable(self, []).reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: Any,
        instance: Any = None,
        acceptor: Callable[[Any, Any], bool],
        name: str | None = None,
    ) -> "Table":
        """Stateful deduplicate (reference ``stdlib/stateful/deduplicate.py:9``)."""
        value_e = self._subst(value)
        layout = self._layout()
        vc = value_e._compile(layout.resolver)
        if instance is not None:
            ic = self._subst(instance)._compile(layout.resolver)
        else:
            ic = lambda kv: ()
        val_idx: dict[str, int] = {c: i for i, c in enumerate(self._column_names)}

        def acceptor_rows(new_vals: tuple, old_vals: tuple | None) -> bool:
            new_v = vc((None, new_vals))
            if old_vals is None:
                return True
            old_v = vc((None, old_vals))
            return acceptor(new_v, old_v)

        node = eg.DeduplicateNode(
            G.engine_graph,
            self._node,
            lambda key, values: ic((key, values)),
            acceptor_rows,
        )
        dedup_refs = [value_e]
        if instance is not None:
            dedup_refs.append(self._subst(instance))
        node.meta["used_cols"] = _referenced_names(dedup_refs)
        # the acceptor compares each row against the PREVIOUS accepted one,
        # so the result depends on per-instance arrival order (PW-X001)
        node.meta["dedup"] = {"order_sensitive": True}
        return Table(node, self._column_names, self._dtypes, name="deduplicate")

    # -- joins ---------------------------------------------------------------
    def join(self, other: "Table", *on: Any, id: Any = None, how: Any = None, **kwargs: Any) -> Any:
        """Equi-join on ``left.col == right.col`` conditions.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> left = pw.debug.table_from_markdown('''
        ... k | v
        ... 1 | a
        ... 2 | b
        ... ''')
        >>> right = pw.debug.table_from_markdown('''
        ... k | w
        ... 1 | x
        ... 2 | y
        ... ''')
        >>> out = left.join(right, left.k == right.k).select(left.v, right.w)
        >>> pw.debug.compute_and_print(out, include_id=False)
        v   | w
        'a' | 'x'
        'b' | 'y'
        """
        from pathway_tpu_torch.internals.joins import JoinKind, JoinResult

        kind = how if how is not None else JoinKind.INNER
        return JoinResult(self, other, list(on), kind, assign_id=id)

    def join_inner(self, other: "Table", *on: Any, **kw: Any) -> Any:
        from pathway_tpu_torch.internals.joins import JoinKind, JoinResult

        return JoinResult(self, other, list(on), JoinKind.INNER, assign_id=kw.get("id"))

    def join_left(self, other: "Table", *on: Any, **kw: Any) -> Any:
        from pathway_tpu_torch.internals.joins import JoinKind, JoinResult

        return JoinResult(self, other, list(on), JoinKind.LEFT, assign_id=kw.get("id"))

    def join_right(self, other: "Table", *on: Any, **kw: Any) -> Any:
        from pathway_tpu_torch.internals.joins import JoinKind, JoinResult

        return JoinResult(self, other, list(on), JoinKind.RIGHT, assign_id=kw.get("id"))

    def join_outer(self, other: "Table", *on: Any, **kw: Any) -> Any:
        from pathway_tpu_torch.internals.joins import JoinKind, JoinResult

        return JoinResult(self, other, list(on), JoinKind.OUTER, assign_id=kw.get("id"))

    # -- ix -------------------------------------------------------------------
    def ix(self, expression: Any, *, optional: bool = False, context: "Table | None" = None) -> "Table":
        """Row lookup: ``target.ix(requests.ptr_col)`` → table with requests'
        universe holding target's columns (reference ``Table.ix``)."""
        e = _wrap(expression)
        if context is None:
            refs = e._references()
            tables = {
                r._table
                for r in refs
                if not isinstance(r._table, ThisMetaclass)
            }
            if len(tables) != 1:
                raise ValueError("ix: cannot infer request table; pass context=")
            context = tables.pop()
        e = e._substitute({THIS: context})
        layout = context._layout()
        c = e._compile(layout.resolver)
        node = eg.IxNode(
            G.engine_graph,
            self._node,
            context._node,
            lambda key, values: c((key, values)),
            target_ncols=len(self._column_names),
            optional=optional,
        )
        dtypes = (
            {c_: dt.Optional(self._dtypes[c_]) for c_ in self._column_names}
            if optional
            else dict(self._dtypes)
        )
        return Table(
            node,
            self._column_names,
            dtypes,
            name=f"{self._name}.ix",
            layout_token=context._layout_token,
        )

    def ix_ref(self, *args: Any, optional: bool = False, context: "Table | None" = None, instance: Any = None) -> "Table":
        from pathway_tpu_torch.internals.expression import make_tuple

        if context is None:
            refs: set[ColumnReference] = set()
            for a in args:
                if isinstance(a, ColumnExpression):
                    refs |= a._references()
            tables = {r._table for r in refs if not isinstance(r._table, ThisMetaclass)}
            if len(tables) != 1:
                raise ValueError("ix_ref: cannot infer request table; pass context=")
            context = tables.pop()
        ptr = PointerExpression(self, *[_wrap(a) for a in args], optional=optional)
        return self.ix(ptr, optional=optional, context=context)

    def having(self, *indexers: ColumnReference) -> "Table":
        """Restrict to rows whose key appears among the pointer values of each
        indexer column (reference ``Table.having``)."""
        out = self
        for ix in indexers:
            if not isinstance(ix, ColumnReference):
                raise TypeError("having() arguments must be column references")
            src: Table = ix._table
            layout = src._layout()
            c = ix._compile(layout.resolver)
            keyset_node = eg.ReindexNode(
                G.engine_graph,
                src._node,
                lambda key, values, c=c: c((key, values)),
                name="having_keys",
            )
            keyset = Table(keyset_node, src._column_names, src._dtypes, name="having_keys")
            node = eg.IntersectNode(G.engine_graph, out._node, [keyset._node])
            out = Table(
                node,
                out._column_names,
                out._dtypes,
                name=f"{self._name}.having",
                layout_token=out._layout_token,
                family=out._family,
            )
        return out

    # -- temporal (reference exposes these as Table methods too) -------------
    def windowby(self, time_expr: Any, *, window: Any, behavior: Any = None, instance: Any = None, shard: Any = None) -> Any:
        """Assign rows to temporal windows; follow with ``.reduce(...)``.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... t  | v
        ... 1  | 10
        ... 3  | 20
        ... 12 | 30
        ... ''')
        >>> w = t.windowby(t.t, window=pw.temporal.tumbling(duration=10)).reduce(
        ...     start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v)
        ... )
        >>> pw.debug.compute_and_print(w.select(w.start, w.s), include_id=False)
        start | s
        0     | 30
        10    | 30
        """
        from pathway_tpu_torch.stdlib.temporal import windowby as _windowby

        return _windowby(self, time_expr, window=window, behavior=behavior, instance=instance, shard=shard)

    def interval_join(self, other: "Table", self_time: Any, other_time: Any, interval: Any, *on: Any, **kw: Any) -> Any:
        from pathway_tpu_torch.stdlib.temporal import interval_join as _ij

        return _ij(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_inner(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import interval_join_inner as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_left(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import interval_join_left as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_right(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import interval_join_right as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_outer(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import interval_join_outer as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def asof_join(self, other, self_time, other_time, *on, **kw):
        """For each left row, the closest right row at or before its time.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> trades = pw.debug.table_from_markdown('''
        ... t | px
        ... 3 | 100
        ... 7 | 105
        ... ''')
        >>> quotes = pw.debug.table_from_markdown('''
        ... t | bid
        ... 1 | 99
        ... 5 | 103
        ... ''')
        >>> j = trades.asof_join(quotes, trades.t, quotes.t)
        >>> pw.debug.compute_and_print(
        ...     j.select(trades.px, quotes.bid), include_id=False
        ... )
        px  | bid
        100 | 99
        105 | 103
        """
        from pathway_tpu_torch.stdlib.temporal import asof_join as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_left(self, other, self_time, other_time, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import asof_join_left as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_right(self, other, self_time, other_time, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import asof_join_right as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_outer(self, other, self_time, other_time, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import asof_join_outer as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_now_join(self, other, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import asof_now_join as _f

        return _f(self, other, *on, **kw)

    def asof_now_join_inner(self, other, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import asof_now_join_inner as _f

        return _f(self, other, *on, **kw)

    def asof_now_join_left(self, other, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import asof_now_join_left as _f

        return _f(self, other, *on, **kw)

    def window_join(self, other, self_time, other_time, window, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal import window_join as _f

        return _f(self, other, self_time, other_time, window, *on, **kw)

    def window_join_inner(self, other, self_time, other_time, window, *on):
        from pathway_tpu_torch.stdlib.temporal import window_join_inner as _f

        return _f(self, other, self_time, other_time, window, *on)

    def window_join_left(self, other, self_time, other_time, window, *on):
        from pathway_tpu_torch.stdlib.temporal import window_join_left as _f

        return _f(self, other, self_time, other_time, window, *on)

    def window_join_right(self, other, self_time, other_time, window, *on):
        from pathway_tpu_torch.stdlib.temporal import window_join_right as _f

        return _f(self, other, self_time, other_time, window, *on)

    def window_join_outer(self, other, self_time, other_time, window, *on):
        from pathway_tpu_torch.stdlib.temporal import window_join_outer as _f

        return _f(self, other, self_time, other_time, window, *on)

    # -- sorting / misc -------------------------------------------------------
    def sort(self, key: Any = None, instance: Any = None) -> "Table":
        from pathway_tpu_torch.stdlib.ordered import sort as _sort

        return _sort(self, key=key, instance=instance)

    def diff(self, timestamp: Any, *values: Any) -> "Table":
        from pathway_tpu_torch.stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values)

    # -- output helpers -------------------------------------------------------
    def _capture_node(self) -> eg.CaptureNode:
        node = eg.CaptureNode(G.engine_graph, self._node)
        node.meta["sink"] = {
            "names": list(self._column_names),
            "dtypes": dict(self._dtypes),
        }
        return node

    def _subscribe(self, on_change=None, on_time_end=None, on_end=None) -> eg.OutputNode:
        node = eg.OutputNode(
            G.engine_graph, self._node, on_change, on_time_end, on_end
        )
        node.meta["sink"] = {
            "names": list(self._column_names),
            "dtypes": dict(self._dtypes),
        }
        return node


def table_from_static_rows(
    rows: Iterable[tuple[Any, tuple]],
    column_names: list[str],
    dtypes: Mapping[str, dt.DType] | None = None,
    name: str = "static",
) -> Table:
    node = eg.InputNode(
        G.engine_graph, n_cols=len(column_names), static_rows=rows, name=name
    )
    return Table(node, column_names, dtypes, name=name)
