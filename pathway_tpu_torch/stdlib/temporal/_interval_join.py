"""Interval joins (reference ``stdlib/temporal/_interval_join.py:577+``)."""

from __future__ import annotations

import dataclasses
from typing import Any

from pathway_tpu_torch.engine.temporal import IntervalJoinNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import BinaryExpression, ColumnExpression, _wrap
from pathway_tpu_torch.internals.joins import JoinResult
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import left as LEFT, right as RIGHT, this as THIS

__all__ = [
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_right",
    "interval_join_outer",
]


@dataclasses.dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound: Any, upper_bound: Any) -> Interval:
    return Interval(lower_bound, upper_bound)


def _compile_side(table: Table, expr: Any):
    e = _wrap(expr)._substitute({THIS: table, LEFT: table, RIGHT: table})
    layout = table._layout()
    c = e._compile(layout.resolver)
    return lambda k, v: c((k, v))


def _split_on(on: tuple, left: Table, right: Table):
    lfns, rfns = [], []
    for cond in on:
        cond = _wrap(cond)._substitute({LEFT: left, RIGHT: right})
        if not (isinstance(cond, BinaryExpression) and cond._op == "=="):
            raise ValueError("interval_join conditions must be equalities")
        a, b = cond._left, cond._right
        a_tabs = {r._table for r in a._references()}
        if left in a_tabs or any(getattr(t, "_layout_token", None) is left._layout_token for t in a_tabs):
            la, ra = a, b
        else:
            la, ra = b, a
        llayout = left._layout()
        rlayout = right._layout()
        lc = la._compile(llayout.resolver)
        rc = ra._compile(rlayout.resolver)
        lfns.append(lc)
        rfns.append(rc)
    return (
        lambda k, v: tuple(f((k, v)) for f in lfns),
        lambda k, v: tuple(f((k, v)) for f in rfns),
    )


def interval_join(
    self: Table,
    other: Table,
    self_time: Any,
    other_time: Any,
    interval: Interval,
    *on: Any,
    how: str = "inner",
    behavior: Any = None,
) -> JoinResult:
    """reference ``interval_join`` — returns a JoinResult for .select()."""
    from pathway_tpu_torch.internals.joins import JoinKind

    lt = _compile_side(self, self_time)
    rt = _compile_side(other, other_time)
    ljk, rjk = _split_on(on, self, other)
    node = IntervalJoinNode(
        G.engine_graph,
        self._node,
        other._node,
        ljk,
        rjk,
        lt,
        rt,
        interval.lower_bound,
        interval.upper_bound,
        left_ncols=len(self._column_names),
        right_ncols=len(other._column_names),
        kind=how,
    )
    # analyzer annotation (graph_facts): finite interval bounds make this
    # a time-windowed construct — state is watermark-evicted, so it does
    # not accumulate unboundedly the way a plain join over a live source
    # does (PW-S001 near-miss)
    node.meta["temporal"] = {
        "kind": "interval_join",
        "how": how,
        "bounded": True,
        "lower": interval.lower_bound,
        "upper": interval.upper_bound,
    }
    return JoinResult(self, other, [], JoinKind[how.upper()], _node=node)


def interval_join_inner(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="inner", **kw)


def interval_join_left(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="left", **kw)


def interval_join_right(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="right", **kw)


def interval_join_outer(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="outer", **kw)