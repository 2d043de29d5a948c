"""``pw.io.postgres`` — PostgreSQL sink (reference
``python/pathway/io/postgres``; writer ``PsqlWriter``
``src/connectors/data_storage.rs:1080``; formatters ``PsqlUpdates``
``data_format.rs:1625`` and ``PsqlSnapshot`` ``:1684``).

Two modes, matching the reference:

- :func:`write` — append every update as a row carrying ``time``/``diff``
  columns (the update-stream table form);
- :func:`write_snapshot` — maintain the current snapshot: upserts by
  primary key (``INSERT .. ON CONFLICT .. DO UPDATE``), deletes on
  retraction.

The connection is any DBAPI connection (or zero-arg factory) passed as
``connection=``; with a settings dict, ``psycopg2`` is imported lazily
(where it is not installed, the writer raises ``MissingDependency``).  ``ON CONFLICT`` and qmark/
format paramstyles cover both PostgreSQL and the sqlite used in tests.

Counterpart of ``pathway_tpu/io/postgres``: the same host code over the port's engine.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import Writer, attach_writer, fmt_value
from pathway_tpu_torch.io._gated import MissingDependency

__all__ = ["write", "write_snapshot"]


def _connect(postgres_settings: dict | None, connection: Any) -> Any:
    if connection is not None:
        # factory vs live connection: sqlite3.Connection is itself
        # callable (executes a statement), so presence of .cursor decides
        if callable(connection) and not hasattr(connection, "cursor"):
            return connection()
        return connection
    try:
        import psycopg2  # type: ignore[import-not-found]
    except ImportError as e:
        raise MissingDependency(
            "psycopg2 is not installed; pass connection= with a DBAPI "
            "connection (or factory) instead"
        ) from e
    return psycopg2.connect(**(postgres_settings or {}))


def _placeholder(conn: Any) -> str:
    mod = type(conn).__module__.split(".")[0]
    if mod == "sqlite3":
        return "?"
    return "%s"


class _PsqlWriter(Writer):
    def __init__(
        self,
        postgres_settings: dict | None,
        connection: Any,
        table_name: str,
        *,
        snapshot_keys: list[str] | None = None,
        max_batch_size: int = 256,
    ):
        self._settings = postgres_settings
        self._connection_arg = connection
        self._conn: Any = None
        self.table_name = table_name
        self.snapshot_keys = snapshot_keys
        self.max_batch_size = max_batch_size
        self._pending = 0

    def _get_conn(self) -> Any:
        if self._conn is None:
            self._conn = _connect(self._settings, self._connection_arg)
        return self._conn

    def write(self, row: dict[str, Any], time: int, diff: int) -> None:
        conn = self._get_conn()
        ph = _placeholder(conn)
        cur = conn.cursor()
        vals = {k: fmt_value(v) for k, v in row.items() if k != "id"}
        cols = list(vals)
        if self.snapshot_keys is None:
            # update-stream form: every change is an appended row
            cols2 = cols + ["time", "diff"]
            sql = (
                f"INSERT INTO {self.table_name} ({', '.join(cols2)}) "
                f"VALUES ({', '.join([ph] * len(cols2))})"
            )
            cur.execute(sql, [*vals.values(), time, diff])
        elif diff > 0:
            updates = [c for c in cols if c not in self.snapshot_keys]
            sql = (
                f"INSERT INTO {self.table_name} ({', '.join(cols)}) "
                f"VALUES ({', '.join([ph] * len(cols))}) "
                f"ON CONFLICT ({', '.join(self.snapshot_keys)}) DO UPDATE SET "
                + ", ".join(f"{c} = excluded.{c}" for c in updates)
            )
            cur.execute(sql, list(vals.values()))
        else:
            cond = " AND ".join(f"{c} = {ph}" for c in self.snapshot_keys)
            cur.execute(
                f"DELETE FROM {self.table_name} WHERE {cond}",
                [vals[c] for c in self.snapshot_keys],
            )
        self._pending += 1
        if self._pending >= self.max_batch_size:
            conn.commit()
            self._pending = 0

    def flush(self) -> None:
        if self._conn is not None:
            self._conn.commit()
            self._pending = 0

    def close(self) -> None:
        if self._conn is not None:
            self._conn.commit()
            self._conn.close()


def write(
    table: Table,
    postgres_settings: dict | None = None,
    table_name: str = "pathway_output",
    *,
    connection: Any = None,
    max_batch_size: int = 256,
    name: str = "postgres_out",
    **kwargs: Any,
) -> None:
    """Append the table's update stream (with time/diff columns)."""
    attach_writer(
        table,
        _PsqlWriter(
            postgres_settings, connection, table_name,
            max_batch_size=max_batch_size,
        ),
        name=name,
    )


def write_snapshot(
    table: Table,
    postgres_settings: dict | None = None,
    table_name: str = "pathway_output",
    primary_key: list[str] | None = None,
    *,
    connection: Any = None,
    max_batch_size: int = 256,
    name: str = "postgres_snapshot",
    **kwargs: Any,
) -> None:
    """Maintain the current snapshot keyed by ``primary_key``."""
    if not primary_key:
        raise ValueError("write_snapshot requires primary_key=[...]")
    attach_writer(
        table,
        _PsqlWriter(
            postgres_settings, connection, table_name,
            snapshot_keys=list(primary_key), max_batch_size=max_batch_size,
        ),
        name=name,
    )
