"""``pw.io.subscribe`` (reference ``python/pathway/io/_subscribe.py``)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

__all__ = ["subscribe", "OnChangeCallback", "OnFinishCallback"]

OnChangeCallback = Callable[..., Any]
OnFinishCallback = Callable[[], Any]


def subscribe(
    table: Table,
    on_change: Callable[[Pointer, dict, int, bool], Any] | None = None,
    on_end: Callable[[], Any] | None = None,
    on_time_end: Callable[[int], Any] | None = None,
    *,
    name: str = "subscribe",
    sort_by: Any = None,
) -> eg.OutputNode:
    """Call ``on_change(key, row: dict, time: int, is_addition: bool)`` for
    every update of ``table``; ``on_time_end(time)`` at every closed epoch;
    ``on_end()`` when the stream finishes.  Returns the sink node so
    callers can annotate ``node.meta`` for the analyzer."""
    cols = table._column_names

    def _on_change(key: Pointer, values: tuple, time: int, diff: int) -> None:
        if on_change is not None:
            on_change(key, dict(zip(cols, values)), time, diff > 0)

    return eg.OutputNode(
        G.engine_graph,
        table._node,
        _on_change if on_change else None,
        on_time_end,
        on_end,
        name=name,
    )
