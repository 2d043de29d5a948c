"""``pandas_transformer`` (reference ``stdlib/utils/pandas_transformer.py``):
run a pandas function over whole tables per epoch."""

from __future__ import annotations

from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table

__all__ = ["pandas_transformer"]


def pandas_transformer(
    output_schema: sch.SchemaMetaclass, output_universe: Any = None
) -> Callable:
    """Decorator: the wrapped function receives pandas DataFrames (one per
    input table) and returns a DataFrame matching ``output_schema``."""

    def wrapper(fun: Callable) -> Callable:
        def transformer(*tables: Table) -> Table:
            import pandas as pd

            cols_list = [t._column_names for t in tables]

            def run_batch(*col_lists) -> list:
                # rebuild one DataFrame per input table
                dfs = []
                start = 0
                for t_cols in cols_list:
                    data = {
                        c: col_lists[start + i] for i, c in enumerate(t_cols)
                    }
                    dfs.append(pd.DataFrame(data))
                    start += len(t_cols)
                out_df = fun(*dfs)
                out_cols = output_schema.column_names()
                return [
                    tuple(row[c] for c in out_cols)
                    for _, row in out_df.reset_index(drop=True).iterrows()
                ]

            # pack EVERY input table into one row of tuples, cross-join the
            # packs, and rebuild the DataFrames inside one apply
            packs = [
                t.reduce(
                    _pw_rows=pw.reducers.tuple(
                        pw.apply(
                            lambda *vs: tuple(vs), *[t[c] for c in t._column_names]
                        )
                    )
                )
                for t in tables
            ]

            def expand(*row_tuples):
                col_lists: list = []
                for t_cols, rows_tuple in zip(cols_list, row_tuples):
                    if rows_tuple:
                        col_lists.extend(list(zip(*rows_tuple)))
                    else:
                        col_lists.extend([[] for _ in t_cols])
                return run_batch(*col_lists)

            joined = packs[0].select(_pw_rows0=pw.this._pw_rows)
            for i, p in enumerate(packs[1:], start=1):
                # join_left: an EMPTY later table contributes an empty
                # DataFrame instead of wiping the whole output
                joined = joined.join_left(p).select(
                    **{
                        f"_pw_rows{j}": getattr(pw.left, f"_pw_rows{j}")
                        for j in range(i)
                    },
                    **{f"_pw_rows{i}": pw.right._pw_rows},
                )
            flat_src = joined.select(
                _pw_out=pw.apply(
                    expand,
                    *[joined[f"_pw_rows{j}"] for j in range(len(packs))],
                )
            )
            flat = flat_src.flatten(flat_src["_pw_out"])
            out_cols = output_schema.column_names()
            return flat.select(
                **{
                    c: pw.apply(lambda r, i=i: r[i], flat["_pw_out"])
                    for i, c in enumerate(out_cols)
                }
            )

        return transformer

    return wrapper
