"""Asof joins (reference ``stdlib/temporal/_asof_join.py:479+`` and
``_asof_now_join.py:176+``)."""

from __future__ import annotations

import enum
from typing import Any

from pathway_tpu_torch.engine.temporal import AsofJoinNode
from pathway_tpu_torch.internals.joins import JoinKind, JoinResult
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.temporal._interval_join import _compile_side, _split_on

__all__ = [
    "Direction",
    "asof_join",
    "asof_join_left",
    "asof_join_right",
    "asof_join_outer",
    "asof_now_join",
    "asof_now_join_inner",
    "asof_now_join_left",
]


class Direction(enum.Enum):
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


def _asof(
    self: Table,
    other: Table,
    self_time: Any,
    other_time: Any,
    *on: Any,
    how: JoinKind = JoinKind.INNER,
    direction: Direction = Direction.BACKWARD,
    as_of_now: bool = False,
    defaults: dict | None = None,
) -> JoinResult:
    lt = _compile_side(self, self_time)
    rt = _compile_side(other, other_time)
    ljk, rjk = _split_on(on, self, other)
    kind = "inner" if how == JoinKind.INNER else "left"
    node = AsofJoinNode(
        G.engine_graph,
        self._node,
        other._node,
        ljk,
        rjk,
        lt,
        rt,
        left_ncols=len(self._column_names),
        right_ncols=len(other._column_names),
        direction=direction.value if isinstance(direction, Direction) else direction,
        kind=kind,
        as_of_now=as_of_now,
    )
    # analyzer annotation: asof keeps one match per left row under a
    # watermark discipline — time-bounded state (PW-S001 near-miss)
    node.meta["temporal"] = {
        "kind": "asof_join",
        "direction": direction.value if isinstance(direction, Direction) else direction,
        "bounded": True,
        "as_of_now": as_of_now,
    }
    return JoinResult(self, other, [], how, _node=node)


def asof_join(
    self: Table,
    other: Table,
    self_time: Any,
    other_time: Any,
    *on: Any,
    how: JoinKind = JoinKind.INNER,
    direction: Direction = Direction.BACKWARD,
    defaults: dict | None = None,
    behavior: Any = None,
) -> JoinResult:
    """reference ``asof_join`` — each left row matched with the closest
    right row by time within the same key group."""
    return _asof(
        self, other, self_time, other_time, *on,
        how=how, direction=direction, defaults=defaults,
    )


def asof_join_left(self, other, self_time, other_time, *on, **kw):
    kw.setdefault("how", JoinKind.LEFT)
    return asof_join(self, other, self_time, other_time, *on, **kw)


def asof_join_right(self, other, self_time, other_time, *on, **kw):
    # right asof = left asof with sides swapped
    kw.setdefault("how", JoinKind.LEFT)
    return asof_join(other, self, other_time, self_time, *on, **kw)


def asof_join_outer(self, other, self_time, other_time, *on, **kw):
    kw.setdefault("how", JoinKind.LEFT)
    return asof_join(self, other, self_time, other_time, *on, **kw)


def asof_now_join(
    self: Table,
    other: Table,
    *on: Any,
    how: JoinKind = JoinKind.INNER,
    **kw: Any,
) -> JoinResult:
    """reference ``asof_now_join`` — left rows are matched ONCE against
    the right side's state at their arrival epoch (no revision when the
    right side later changes)."""
    from pathway_tpu_torch.engine.temporal import AsofNowJoinNode

    ljk, rjk = _split_on(on, self, other)
    node = AsofNowJoinNode(
        G.engine_graph,
        self._node,
        other._node,
        ljk,
        rjk,
        left_ncols=len(self._column_names),
        right_ncols=len(other._column_names),
        kind="left" if how == JoinKind.LEFT else "inner",
    )
    # analyzer annotation: matches once at arrival epoch, no revision —
    # the left side is never buffered (PW-S001 near-miss)
    node.meta["temporal"] = {"kind": "asof_now_join", "bounded": True}
    return JoinResult(self, other, [], how, _node=node)


def asof_now_join_inner(self, other, *on, **kw):
    return asof_now_join(self, other, *on, how=JoinKind.INNER, **kw)


def asof_now_join_left(self, other, *on, **kw):
    return asof_now_join(self, other, *on, how=JoinKind.LEFT, **kw)
