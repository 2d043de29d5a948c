"""Ordered operations: sorting index and ``diff``.

Reference: ``python/pathway/stdlib/ordered/diff.py`` (prev/next via sorting
index, ``src/engine/dataflow/operators/prev_next.rs``).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnReference, _wrap
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this as THIS

__all__ = ["sort", "diff"]


def sort(table: Table, key: Any = None, instance: Any = None) -> Table:
    """Return a table (same universe) with ``prev``/``next`` Optional[Pointer]
    columns ordering rows by ``key`` within ``instance``."""
    key_expr = _wrap(key if key is not None else ColumnReference(table, "id"))
    key_expr = key_expr._substitute({THIS: table})
    layout = table._layout()
    kc = key_expr._compile(layout.resolver)
    if instance is not None:
        ic = _wrap(instance)._substitute({THIS: table})._compile(layout.resolver)
    else:
        ic = lambda kv: ()
    node = eg.SortNode(
        G.engine_graph,
        table._node,
        lambda k, v: kc((k, v)),
        lambda k, v: ic((k, v)),
    )
    return Table(
        node,
        ["prev", "next"],
        {"prev": dt.Optional(dt.POINTER), "next": dt.Optional(dt.POINTER)},
        name=f"{table._name}.sort",
        layout_token=table._layout_token,
    )


def diff(table: Table, timestamp: Any, *values: Any, instance: Any = None) -> Table:
    """Per-row difference vs the previous row when ordered by ``timestamp``
    (reference ``stdlib/ordered/diff.py``: ``diff_<col>`` columns; None for
    the first row)."""
    import pathway_tpu_torch as pw

    sorted_ix = sort(table, key=timestamp, instance=instance)
    combined = table.with_columns(pw_prev_=sorted_ix.prev)
    prev_rows = table.ix(combined["pw_prev_"], optional=True, context=combined)
    out_cols = {}
    for v in values:
        e = _wrap(v)._substitute({THIS: table})
        if not isinstance(e, ColumnReference):
            raise TypeError("diff() values must be column references")
        name = e._name
        out_cols[f"diff_{name}"] = pw.require(
            table[name] - prev_rows[name], prev_rows[name]
        )
    return combined.with_columns(**out_cols).without("pw_prev_")
