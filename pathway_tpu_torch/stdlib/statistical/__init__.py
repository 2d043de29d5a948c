"""Statistical helpers (reference ``python/pathway/stdlib/statistical/``)."""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table

__all__ = ["interpolate", "InterpolateMode"]


class InterpolateMode:
    LINEAR = "linear"


def interpolate(
    self: Table, timestamp: Any, *values: Any, mode: str = InterpolateMode.LINEAR
) -> Table:
    """Linear interpolation of missing (None) values over time order
    (reference ``stdlib/statistical/_interpolate.py``): each None cell takes
    the linear blend of the nearest non-None neighbours in timestamp order.

    Implementation: a global sorted_tuple reduce packs (ts, values..., id)
    rows; one apply computes the interpolated mapping; a constant-key ix
    broadcasts it back to every row.  Incremental per-epoch (the reduce and
    mapping recompute only when inputs change).
    """
    if mode != InterpolateMode.LINEAR:
        raise ValueError(f"unsupported interpolation mode {mode!r}")

    table = self
    ts_name = timestamp._name
    val_names = [v._name for v in values]

    packed = table.reduce(
        rows=pw.reducers.sorted_tuple(
            pw.make_tuple(table[ts_name], *[table[v] for v in val_names], table.id)
        )
    )

    def interp(rows: tuple) -> dict:
        out: dict = {}
        for vi, vname in enumerate(val_names):
            known = [(r[0], r[1 + vi]) for r in rows if r[1 + vi] is not None]
            for r in rows:
                t, key, v = r[0], r[-1], r[1 + vi]
                if v is None and known:
                    before = [(kt, kv) for kt, kv in known if kt <= t]
                    after = [(kt, kv) for kt, kv in known if kt >= t]
                    if before and after:
                        (t0, v0), (t1, v1) = before[-1], after[0]
                        v = v0 if t1 == t0 else v0 + (v1 - v0) * (t - t0) / (t1 - t0)
                    elif before:
                        v = before[-1][1]
                    else:
                        v = after[0][1]
                out.setdefault(key, {})[vname] = v
        return out

    mapping = packed.select(m=pw.apply(interp, pw.this.rows))
    # broadcast the singleton mapping row to every input row: the global
    # reduce's key is ref_scalar() (empty group), so pointer_from() hits it
    broadcast = mapping.ix(mapping.pointer_from(), context=table)

    def pick(m: Any, key: Any, name: str) -> Any:
        if m is None or m is pw.Error:
            return None
        return m.get(key, {}).get(name)

    return table.with_columns(
        **{
            name: pw.apply(pick, broadcast.m, table.id, name)
            for name in val_names
        }
    )
