"""JoinResult: ``t1.join(t2, t1.a == t2.b).select(...)``.

Capability parity with reference ``python/pathway/internals/joins.py`` (1422
LoC): inner/left/right/outer equi-joins with ``pw.left``/``pw.right``/
``pw.this`` resolution in the projection, chained filter, and id assignment.
"""

from __future__ import annotations

import enum
from typing import Any

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    BinaryExpression,
    ColumnExpression,
    ColumnReference,
    _wrap,
    smart_name,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table, _Layout
from pathway_tpu_torch.internals.thisclass import ThisMetaclass
from pathway_tpu_torch.internals.thisclass import left as LEFT
from pathway_tpu_torch.internals.thisclass import right as RIGHT
from pathway_tpu_torch.internals.thisclass import this as THIS


class JoinKind(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


JoinMode = JoinKind  # reference alias pw.JoinMode


def _side_of(expr: ColumnExpression, left: Table, right: Table) -> str:
    sides = set()
    for r in expr._references():
        t = r._table
        if t is LEFT:
            sides.add("left")
        elif t is RIGHT:
            sides.add("right")
        # table IDENTITY decides before layout tokens: a self-join via
        # t.copy() shares t's layout token on both sides, and the token
        # fallback alone would call both references "left"
        elif t is left:
            sides.add("left")
        elif t is right:
            sides.add("right")
        elif getattr(t, "_layout_token", object()) is left._layout_token:
            sides.add("left")
        elif getattr(t, "_layout_token", object()) is right._layout_token:
            sides.add("right")
        else:
            raise ValueError(f"join condition references unknown table: {r!r}")
    if len(sides) != 1:
        raise ValueError(f"join condition side is ambiguous: {expr!r}")
    return sides.pop()


class JoinResult:
    def __init__(
        self,
        left: Table,
        right: Table,
        on: list[Any],
        kind: JoinKind,
        assign_id: Any = None,
        _node: eg.Node | None = None,
    ):
        self._left = left
        self._right = right
        self._kind = kind
        self._assign_id = assign_id
        if _node is not None:
            self._node = _node
            return

        left_exprs: list[ColumnExpression] = []
        right_exprs: list[ColumnExpression] = []
        for cond in on:
            cond = _wrap(cond)._substitute({LEFT: left, RIGHT: right})
            if not (isinstance(cond, BinaryExpression) and cond._op == "=="):
                raise ValueError("join conditions must be equalities: t1.a == t2.b")
            a, b = cond._left, cond._right
            if _side_of(a, left, right) == "left":
                left_exprs.append(a)
                right_exprs.append(b)
                if _side_of(b, left, right) != "right":
                    raise ValueError("join condition must compare left vs right")
            else:
                left_exprs.append(b)
                right_exprs.append(a)
                if _side_of(b, left, right) != "left":
                    raise ValueError("join condition must compare left vs right")

        llayout = left._layout()
        rlayout = right._layout()
        lfns = [e._compile(llayout.resolver) for e in left_exprs]
        rfns = [e._compile(rlayout.resolver) for e in right_exprs]

        def left_jk(key: Any, values: tuple) -> tuple:
            kv = (key, values)
            return tuple(f(kv) for f in lfns)

        def right_jk(key: Any, values: tuple) -> tuple:
            kv = (key, values)
            return tuple(f(kv) for f in rfns)

        left_id_only = False
        if assign_id is not None:
            ref = assign_id
            if isinstance(ref, ColumnReference) and ref._name == "id":
                if ref._table is left or ref._table is LEFT:
                    left_id_only = True

        # native epoch pass: one VM program per side computing the whole
        # join-key tuple (internals/expr_vm.py); falls back to the
        # closures above when lowering is unavailable
        from pathway_tpu_torch.internals import expr_vm as _vm
        from pathway_tpu_torch.internals.expression import MakeTupleExpression

        lprog = _vm.lower_program(MakeTupleExpression(*left_exprs), llayout)
        rprog = _vm.lower_program(MakeTupleExpression(*right_exprs), rlayout)
        jk_programs = (
            (lprog, rprog) if lprog is not None and rprog is not None else None
        )

        self._node = eg.JoinNode(
            G.engine_graph,
            left._node,
            right._node,
            left_jk,
            right_jk,
            left_ncols=len(left._column_names),
            right_ncols=len(right._column_names),
            kind=kind.value,
            left_id_only=left_id_only,
            jk_programs=jk_programs,
        )
        self._node.meta["join"] = {
            "kind": kind.value,
            "on": [
                (
                    smart_name(le) or "<expr>",
                    getattr(le, "_dtype", dt.ANY),
                    smart_name(re_) or "<expr>",
                    getattr(re_, "_dtype", dt.ANY),
                )
                for le, re_ in zip(left_exprs, right_exprs)
            ],
        }

    # ------------------------------------------------------------------
    def _layout(self) -> _Layout:
        left, right = self._left, self._right
        ln = len(left._column_names)
        rn = len(right._column_names)
        layout = _Layout()
        lmap = {c: i for i, c in enumerate(left._column_names)}
        rmap = {c: ln + i for i, c in enumerate(right._column_names)}
        layout.add(left, lmap, id_pos=ln + rn)
        layout.add(right, rmap, id_pos=ln + rn + 1)
        union: dict[str, int | None] = {}
        for c, i in lmap.items():
            union[c] = i
        for c, i in rmap.items():
            if c in union:
                union[c] = None  # None marks ambiguity; resolver raises
            else:
                union[c] = i
        layout.add(self, union, id_pos=None)
        return layout

    def _dtype_of(self, name: str, side: str) -> dt.DType:
        t = self._left if side == "left" else self._right
        base = t._dtypes.get(name, dt.ANY)
        if self._kind in (JoinKind.OUTER,) or (
            side == "left" and self._kind == JoinKind.RIGHT
        ) or (side == "right" and self._kind == JoinKind.LEFT):
            return dt.Optional(base)
        return base

    def select(self, *args: Any, **kwargs: Any) -> Table:
        left, right = self._left, self._right
        named: list[tuple[str, ColumnExpression]] = []

        def expand(placeholder: Any) -> None:
            if placeholder is LEFT:
                for c in left._column_names:
                    named.append((c, ColumnReference(left, c)))
            elif placeholder is RIGHT:
                for c in right._column_names:
                    named.append((c, ColumnReference(right, c)))
            elif placeholder is THIS:
                seen = set()
                for c in left._column_names:
                    named.append((c, ColumnReference(left, c)))
                    seen.add(c)
                for c in right._column_names:
                    if c not in seen:
                        named.append((c, ColumnReference(right, c)))

        for a in args:
            if isinstance(a, ThisMetaclass):
                expand(a)
                continue
            e = _wrap(a)._substitute({THIS: self, LEFT: left, RIGHT: right})
            n = smart_name(e)
            if n is None:
                raise ValueError("positional join select args must be column refs")
            named.append((n, e))
        for n, a in kwargs.items():
            named.append((n, _wrap(a)._substitute({THIS: self, LEFT: left, RIGHT: right})))

        # dedup, later wins
        dedup: dict[str, ColumnExpression] = {}
        for n, e in named:
            dedup[n] = e
        names = list(dedup.keys())
        exprs = list(dedup.values())

        layout = self._layout()
        compiled = [e._compile(layout.resolver) for e in exprs]

        def row_fn(key: Any, values: tuple) -> tuple:
            kv = (key, values)
            return tuple(c(kv) for c in compiled)

        node = eg.RowwiseNode(G.engine_graph, self._node, row_fn, name="join_select")
        node.meta["used_cols"] = sorted(
            {
                r._name
                for e in exprs
                for r in e._references()
                if r._name != "id"
            }
        )
        dtypes: dict[str, dt.DType] = {}
        for n, e in zip(names, exprs):
            if isinstance(e, ColumnReference) and not isinstance(e._table, ThisMetaclass):
                if e._table is left or getattr(e._table, "_layout_token", None) is left._layout_token:
                    dtypes[n] = self._dtype_of(e._name, "left") if e._name != "id" else dt.POINTER
                elif e._table is right or getattr(e._table, "_layout_token", None) is right._layout_token:
                    dtypes[n] = self._dtype_of(e._name, "right") if e._name != "id" else dt.POINTER
                else:
                    dtypes[n] = e._dtype
            else:
                dtypes[n] = e._dtype
        node.meta["select"] = {
            "kind": "join_select",
            "names": names,
            "exprs": exprs,
            "layout": layout,
            "dtypes": [dtypes[n] for n in names],
        }
        return Table(node, names, dtypes, name="join")

    def filter(self, expr: Any) -> "JoinResult":
        e = _wrap(expr)._substitute({THIS: self, LEFT: self._left, RIGHT: self._right})
        layout = self._layout()
        c = e._compile(layout.resolver)
        fnode = eg.FilterNode(
            G.engine_graph, self._node, lambda key, values: c((key, values))
        )
        fnode.meta["filter"] = {"exprs": [e], "layout": layout}
        # frame marker: the predicate is over the raw join output frame
        # (lv + rv + (lk, rk)), which is what lets the optimizer push it
        # below the join without substitution
        fnode.meta["join_filter"] = {
            "left_ncols": len(self._left._column_names),
            "right_ncols": len(self._right._column_names),
        }
        fnode.meta["used_cols"] = sorted(
            {r._name for r in e._references() if r._name != "id"}
        )
        return JoinResult(
            self._left, self._right, [], self._kind, self._assign_id, _node=fnode
        )

    # column references on the join result (pw.this style)
    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        return ColumnReference(self, name)

    @property
    def _column_names(self) -> list[str]:
        seen = list(self._left._column_names)
        for c in self._right._column_names:
            if c not in seen:
                seen.append(c)
        return seen

    @property
    def _dtypes(self) -> dict[str, dt.DType]:
        out = {c: self._dtype_of(c, "left") for c in self._left._column_names}
        for c in self._right._column_names:
            out.setdefault(c, self._dtype_of(c, "right"))
        return out

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        return self.select(THIS).reduce(*args, **kwargs)

    def groupby(self, *args: Any, **kwargs: Any) -> Any:
        return self.select(THIS).groupby(*args, **kwargs)
