"""GroupedTable: ``table.groupby(...).reduce(...)``.

Capability parity with reference ``python/pathway/internals/groupbys.py``:
reduction over grouping columns with retraction-aware reducers, including
expressions that mix reducers with grouping columns
(``pw.reducers.sum(t.x) + pw.this.g``).
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
    _wrap,
    smart_name,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.thisclass import this as THIS


class GroupedTable:
    def __init__(
        self,
        source: Any,
        grouping: list[ColumnExpression],
        set_id: bool = False,
    ):
        self._source = source
        self._grouping = grouping
        self._set_id = set_id
        for g in self._grouping:
            if not isinstance(g, ColumnReference):
                raise NotImplementedError(
                    "groupby currently supports column references as grouping keys; "
                    "select the computed expression into a column first"
                )

    def _match_grouping(self, ref: ColumnReference) -> int | None:
        for i, g in enumerate(self._grouping):
            assert isinstance(g, ColumnReference)
            same_table = g._table is ref._table or getattr(
                g._table, "_layout_token", object()
            ) is getattr(ref._table, "_layout_token", None)
            if same_table and g._name == ref._name:
                return i
        return None

    def reduce(self, *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.internals.table import Table

        source: Table = self._source
        named: list[tuple[str, ColumnExpression]] = []
        for a in args:
            e = _wrap(a)._substitute({THIS: source})
            n = smart_name(e)
            if n is None:
                raise ValueError(
                    "Positional reduce() arguments must be column references"
                )
            named.append((n, e))
        for n, a in kwargs.items():
            named.append((n, _wrap(a)._substitute({THIS: source})))

        # --- rewrite each output expression: reducers and grouping refs
        # become slots of the intermediate groupby output table
        reducer_slots: list[ReducerExpression] = []

        n_group = len(self._grouping)
        inter_names = [f"__g{i}" for i in range(n_group)]

        def alloc_reducer(e: ReducerExpression) -> int:
            reducer_slots.append(e)
            return len(reducer_slots) - 1

        inter_ref_holder: list[Any] = [None]

        def rewrite(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ReducerExpression):
                i = alloc_reducer(e)
                return ColumnReference(inter_ref_holder, f"__r{i}")
            if isinstance(e, ColumnReference):
                if e._name == "id" and self._match_grouping(e) is None:
                    # group key pointer
                    return ColumnReference(inter_ref_holder, "id")
                gi = self._match_grouping(e)
                if gi is None:
                    raise ValueError(
                        f"Column {e._name!r} must appear in groupby(...) or inside "
                        "a reducer"
                    )
                return ColumnReference(inter_ref_holder, f"__g{gi}")
            children = [rewrite(c) for c in e._children()]
            return e._rebuild(children)

        rewritten = [(n, rewrite(e)) for n, e in named]

        # --- build engine groupby
        layout = source._layout()
        gfns = [
            g._substitute({THIS: source})._compile(layout.resolver)
            for g in self._grouping
        ]

        if len(gfns) == 1:
            gfn0 = gfns[0]

            def group_fn(key: Any, values: tuple) -> tuple:
                return (gfn0((key, values)),)

        else:

            def group_fn(key: Any, values: tuple) -> tuple:
                kv = (key, values)
                return tuple(f(kv) for f in gfns)

        # native partial-aggregation spec: usable when every grouping key
        # and reducer argument is a plain positional column (the common
        # case); engine falls back to the compiled-closure loop otherwise
        fast_group: list[int] = []
        fast_ok = True
        for g in self._grouping:
            ge = g._substitute({THIS: source})
            pos = (
                layout.resolve_pos(ge) if isinstance(ge, ColumnReference) else None
            )
            if pos is None:
                fast_ok = False
                break
            fast_group.append(pos)
        fast_reds: list[tuple[int, tuple]] = []

        def _arg_positions(args: list) -> tuple | None:
            poses = []
            for a in args:
                if not isinstance(a, ColumnReference):
                    return None
                p = layout.resolve_pos(a)
                if p is None:
                    return None
                poses.append(p)
            return tuple(poses)

        reducer_args: list[tuple[Any, Callable]] = []
        for re_expr in reducer_slots:
            impl = re_expr._reducer.make_impl(**re_expr._reducer_kwargs)
            arg_fns = [a._compile(layout.resolver) for a in re_expr._args]
            if fast_ok:
                code = impl.native_code
                poses = _arg_positions(list(re_expr._args))
                if code is None or poses is None:
                    fast_ok = False
                elif code == 0:
                    fast_reds.append((0, ()))
                elif impl.name in ("argmin", "argmax") and len(poses) == 1:
                    fast_reds.append((code, (poses[0], -1)))  # (value, row key)
                else:
                    fast_reds.append((code, poses))
            if impl.name in ("argmin", "argmax"):
                # one arg: returns the extreme row's KEY (reference
                # semantics); two args: (sort_value, returned_value)
                if len(arg_fns) == 2:
                    def arg_fn(key, values, arg_fns=arg_fns):
                        kv = (key, values)
                        return (arg_fns[0](kv), arg_fns[1](kv))

                else:
                    def arg_fn(key, values, arg_fns=arg_fns):
                        kv = (key, values)
                        return (arg_fns[0](kv), key)

            elif not arg_fns:
                def arg_fn(key, values):
                    return ()

            elif len(arg_fns) == 1:
                def arg_fn(key, values, f0=arg_fns[0]):
                    return (f0((key, values)),)

            else:
                def arg_fn(key, values, arg_fns=arg_fns):
                    kv = (key, values)
                    return tuple(f(kv) for f in arg_fns)

            reducer_args.append((impl, arg_fn))

        # groupby(..., id=col): the group key VALUE (a pointer) becomes the
        # output row id (reference groupby id= semantics)
        output_key_fn = None
        if self._set_id:
            if len(self._grouping) != 1:
                raise ValueError("groupby(id=...) needs exactly one grouping column")
            output_key_fn = lambda gvals: gvals[0]  # noqa: E731
        node = eg.GroupByNode(
            G.engine_graph,
            source._node,
            group_fn,
            reducer_args,
            output_key_fn=output_key_fn,
            include_group_values=True,
            name="groupby",
            fast_spec=(tuple(fast_group), tuple(fast_reds)) if fast_ok else None,
        )
        grouping_names = [
            g._name for g in self._grouping if isinstance(g, ColumnReference)
        ]
        used: set[str] = set(grouping_names)
        for re_expr in reducer_slots:
            for a in re_expr._args:
                try:
                    for r in a._references():
                        if r._name != "id":
                            used.add(r._name)
                except Exception:
                    pass
        node.meta["groupby"] = {
            "grouping": grouping_names,
            "reducers": [impl.name for impl, _ in reducer_args],
        }
        node.meta["used_cols"] = sorted(used)
        inter_cols = inter_names + [f"__r{i}" for i in range(len(reducer_slots))]
        inter_dtypes: dict[str, dt.DType] = {}
        for i, g in enumerate(self._grouping):
            inter_dtypes[f"__g{i}"] = g._dtype
        for i, re_expr in enumerate(reducer_slots):
            inter_dtypes[f"__r{i}"] = re_expr._dtype
        inter = Table(node, inter_cols, inter_dtypes, name="groupby_inter")

        # Re-point rewritten references at the concrete intermediate table.
        def repoint(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ColumnReference) and e._table is inter_ref_holder:
                if e._name == "id":
                    return inter.id
                return ColumnReference(inter, e._name)
            children = [repoint(c) for c in e._children()]
            return e._rebuild(children)

        final = {n: repoint(e) for n, e in rewritten}
        return inter.select(**final)
