"""``pw.io.sqlite`` — SQLite connector (reference ``python/pathway/io/sqlite``;
engine reader ``src/connectors/data_storage.rs:1415``).

Static snapshot read plus polling CDC in streaming mode: the table is
re-scanned when ``PRAGMA data_version`` changes, and row-level adds/removes
are emitted as diffs keyed by primary key.

Counterpart of ``pathway_tpu/io/sqlite``: the same host code over the port's engine.
"""

from __future__ import annotations

import sqlite3
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import RowSource, coerce_row, input_table

__all__ = ["read"]


class _SqliteSource(RowSource):
    def __init__(self, path: str, table_name: str, schema: sch.SchemaMetaclass, mode: str, poll_interval: float = 0.25):
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.mode = mode
        self.poll_interval = poll_interval

    def _snapshot(self, conn: sqlite3.Connection) -> dict:
        cols = self.schema.column_names()
        cur = conn.execute(
            f"SELECT {', '.join(cols)} FROM {self.table_name}"  # noqa: S608
        )
        pk = self.schema.primary_key_columns()
        out = {}
        for i, row in enumerate(cur.fetchall()):
            values = dict(zip(cols, row))
            if pk:
                key = ref_scalar(*[values[c] for c in pk])
            else:
                key = ref_scalar("__sqlite__", self.table_name, i)
            out[key] = coerce_row(values, self.schema)
        return out

    def run(self, events: Any) -> None:
        conn = sqlite3.connect(self.path)
        try:
            current = self._snapshot(conn)
            for key, row in current.items():
                events.add(key, row)
            events.commit()
            if self.mode == "static":
                return
            last_version = conn.execute("PRAGMA data_version").fetchone()[0]
            while not events.stopped:
                _time.sleep(self.poll_interval)
                version = conn.execute("PRAGMA data_version").fetchone()[0]
                if version == last_version:
                    continue
                last_version = version
                new = self._snapshot(conn)
                changed = False
                for key in set(current) - set(new):
                    events.remove(key, current[key])
                    changed = True
                for key, row in new.items():
                    if key not in current:
                        events.add(key, row)
                        changed = True
                    elif current[key] != row:
                        events.remove(key, current[key])
                        events.add(key, row)
                        changed = True
                current = new
                if changed:
                    events.commit()
        finally:
            conn.close()


def read(
    path: str,
    table_name: str,
    schema: sch.SchemaMetaclass,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str = "sqlite",
    **kwargs: Any,
) -> Table:
    src = _SqliteSource(path, table_name, schema, mode)
    return input_table(src, schema, name=name, upsert=True)
