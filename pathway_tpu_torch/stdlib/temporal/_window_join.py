"""Window joins (reference ``stdlib/temporal/_window_join.py``): rows
join when their windows coincide (plus optional equality conditions).
Use ``pw.left`` / ``pw.right`` in the conditions."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.joins import JoinKind, JoinResult
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.temporal._window import Window, windowby

__all__ = [
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_right",
    "window_join_outer",
    "WindowJoinResult",
]


class WindowJoinResult(JoinResult):
    """JoinResult whose sides carry ``_pw_window`` columns."""


def _assigned(table: Table, time_expr: Any, window: Window) -> Table:
    return windowby(table, time_expr, window=window)._assigned


def window_join(
    self: Table,
    other: Table,
    self_time: Any,
    other_time: Any,
    window: Window,
    *on: Any,
    how: JoinKind = JoinKind.INNER,
) -> JoinResult:
    left_a = _assigned(self, self_time, window)
    right_a = _assigned(other, other_time, window)
    import pathway_tpu_torch as pw

    conds = [pw.left["_pw_window"] == pw.right["_pw_window"], *on]
    return WindowJoinResult(left_a, right_a, conds, how)


def window_join_inner(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.INNER)


def window_join_left(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.LEFT)


def window_join_right(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.RIGHT)


def window_join_outer(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.OUTER)
