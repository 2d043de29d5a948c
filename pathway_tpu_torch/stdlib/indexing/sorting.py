"""Sorting-index helpers (counterpart of
``pathway_tpu/stdlib/indexing/sorting.py``; reference
``stdlib/indexing/sorting.py``).

The engine's :class:`~pathway_tpu_torch.engine.graph.SortNode` maintains
prev/next pointers per row (reference ``prev_next.rs``); this module adds
the nearest-non-None value retrieval used by ``statistical.interpolate``.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.engine.stream import Update, consolidate, per_key_changes
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

__all__ = ["retrieve_prev_next_values"]


class _PrevNextValueNode(eg.Node):
    """For each row of a prev/next-linked list, the NEAREST non-None value
    in each direction (walks the pointer chain host-side; dirty epochs
    recompute the affected chains)."""

    def __init__(self, graph, input: eg.Node, prev_idx: int, next_idx: int, value_idx: int, name="prev_next_values"):
        super().__init__(graph, [input], name)
        self.prev_idx = prev_idx
        self.next_idx = next_idx
        self.value_idx = value_idx

    def make_state(self):
        return {"rows": {}, "out": {}}

    def _nearest(self, rows: dict, key: Any, direction_idx: int) -> Any:
        seen = set()
        cur = rows.get(key)
        while cur is not None:
            nxt_key = cur[direction_idx]
            if nxt_key is None or nxt_key in seen:
                return None
            seen.add(nxt_key)
            cur = rows.get(nxt_key)
            if cur is None:
                return None
            v = cur[self.value_idx]
            if v is not None:
                return v
        return None

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        rows = st["rows"]
        touched = per_key_changes(consolidate(inbatches[0]))
        if not touched:
            return []
        for key, (rem, add) in touched.items():
            if add:
                rows[key] = add[-1]
            elif rem:
                rows.pop(key, None)
        # pointer chains shift arbitrarily on insert; recompute all rows and
        # emit only the diffs (interpolate-scale tables)
        out: list[Update] = []
        new_out: dict = {}
        for key, values in rows.items():
            pv = self._nearest(rows, key, self.prev_idx)
            nv = self._nearest(rows, key, self.next_idx)
            new_out[key] = values + (pv, nv)
        for key, row in new_out.items():
            old = st["out"].get(key)
            if old != row:
                if old is not None:
                    out.append(Update(key, old, -1))
                out.append(Update(key, row, 1))
        for key in list(st["out"]):
            if key not in new_out:
                out.append(Update(key, st["out"][key], -1))
        st["out"] = new_out
        return consolidate(out)


def retrieve_prev_next_values(ordered_table: Table, value: Any = None) -> Table:
    """Given a table with ``prev``/``next`` pointer columns and a value
    column, return ``prev_value``/``next_value`` columns holding the
    NEAREST non-None value in each direction (reference
    ``sorting.py retrieve_prev_next_values``)."""
    if value is None:
        value = ordered_table.value
    name = value._name
    cols = ordered_table._column_names
    node = _PrevNextValueNode(
        G.engine_graph,
        ordered_table._node,
        prev_idx=cols.index("prev"),
        next_idx=cols.index("next"),
        value_idx=cols.index(name),
    )
    out_cols = cols + ["prev_value", "next_value"]
    dtypes = dict(ordered_table._dtypes)
    vt = dtypes.get(name, dt.ANY)
    dtypes["prev_value"] = dt.Optional(vt)
    dtypes["next_value"] = dt.Optional(vt)
    return Table(
        node,
        out_cols,
        dtypes,
        name="prev_next_values",
        layout_token=ordered_table._layout_token,
    )
