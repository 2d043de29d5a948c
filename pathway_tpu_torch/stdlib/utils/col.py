"""Column utilities (reference ``stdlib/utils/col.py``)."""

from __future__ import annotations

from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table

__all__ = ["unpack_col", "flatten_column", "multiapply_all", "apply_all_rows", "groupby_reduce_majority"]


def unpack_col(column: Any, *names: Any, schema: Any = None) -> Table:
    """Expand a tuple column into separate columns (reference
    ``col.py unpack_col``)."""
    table: Table = column._table
    if schema is not None:
        names = tuple(schema.column_names())
    out = {}
    for i, n in enumerate(names):
        n = n if isinstance(n, str) else n._name
        out[n] = pw.apply(lambda t, i=i: None if t is None else t[i], column)
    return table.select(**out)


def flatten_column(column: Any, origin_id: str | None = "origin_id") -> Table:
    """One row per element of an iterable column; keeps a pointer to the
    source row (reference ``col.py flatten_column``)."""
    table: Table = column._table
    name = column._name
    with_origin = table.select(
        **{name: table[name], origin_id or "origin_id": table.id}
    )
    return with_origin.flatten(with_origin[name])


def apply_all_rows(
    *cols: Any, fun: Callable, result_col_name: str = "result"
) -> Table:
    """Apply ``fun`` to ALL rows' values at once: fun receives one list per
    column, returns a list of per-row results (reference
    ``col.py apply_all_rows``)."""
    from pathway_tpu_torch.internals.udfs import batch_udf

    table: Table = cols[0]._table
    wrapped = batch_udf(fun)
    return table.select(**{result_col_name: wrapped(*cols)})


multiapply_all = apply_all_rows


def groupby_reduce_majority(column: Any, value_column: Any) -> Table:
    """Majority value per group (reference ``col.py groupby_reduce_majority``)."""
    table: Table = column._table
    counted = table.groupby(column, value_column).reduce(
        column, value_column, _pw_cnt=pw.reducers.count()
    )
    return (
        counted.groupby(counted[column._name])
        .reduce(
            counted[column._name],
            majority=pw.reducers.argmax(
                counted["_pw_cnt"], counted[value_column._name]
            ),
        )
    )
