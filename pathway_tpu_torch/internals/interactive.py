"""Interactive mode / LiveTable / cross-graph export-import.

Capability parity with reference ``internals/interactive.py:37-222`` +
the engine export machinery (``src/engine/dataflow/export.rs``,
``ExportedTable`` at ``src/engine/graph.rs:630``):

- ``enable_interactive_mode()`` marks the session interactive; ``live()``
  starts the graph once in a background thread.
- ``export_table(t)`` attaches an :class:`~pathway_tpu_torch.engine.graph.
  ExportNode`: a thread-safe update log with a closed-epoch frontier,
  offset reads and replay-then-live subscriptions.
- ``import_table(exported)`` rebuilds the stream as an input of the
  CURRENT graph — a second, later graph continues from a finished (or
  still-running) first graph's table.
- :class:`LiveTable` is a continuously updated snapshot with blocking
  ``wait(epoch)`` / ``wait_closed()`` synchronisation and pandas export.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.engine.graph import ExportNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

__all__ = [
    "enable_interactive_mode",
    "LiveTable",
    "live",
    "export_table",
    "import_table",
    "ExportedTable",
]

_interactive: dict[str, Any] = {"enabled": False, "thread": None}


def enable_interactive_mode() -> None:
    """Mark the session interactive: ``live(table)`` snapshots run the
    graph in the background (reference ``enable_interactive_mode``)."""
    _interactive["enabled"] = True


class ExportedTable:
    """Handle over an engine export (reference ``ExportedTable``):
    column metadata + frontier/data_from_offset/subscribe."""

    def __init__(self, node: ExportNode, column_names: list[str], dtypes: dict):
        self._node = node
        self.column_names = list(column_names)
        self.dtypes = dict(dtypes)

    def frontier(self) -> int:
        """Last closed epoch exported so far."""
        return self._node.frontier()

    @property
    def closed(self) -> bool:
        """True once the producing run finished."""
        return self._node.closed

    def data_from_offset(self, offset: int):
        """(updates, next_offset, frontier, closed); updates are
        ``(time, key, values, diff)`` in epoch order."""
        return self._node.data_from_offset(offset)

    def subscribe(self, cb: Callable, replay: bool = True) -> None:
        """``cb(batch, frontier)`` on every exported epoch; ``replay``
        first delivers the full history atomically with registration."""
        self._node.subscribe(cb, replay=replay)

    def snapshot(self) -> dict[Any, tuple]:
        """Consolidated current rows (applies the whole log)."""
        rows: dict[Any, tuple] = {}
        batch, _, _, _ = self._node.data_from_offset(0)
        for _t, key, values, diff in batch:
            if diff > 0:
                rows[key] = values
            else:
                rows.pop(key, None)
        return rows


def export_table(table: Table) -> ExportedTable:
    """Attach an export to ``table`` (reference ``scope.export_table``).
    Must be called while building the producing graph."""
    node = ExportNode(G.engine_graph, table._node)
    return ExportedTable(node, table._column_names, table._dtypes)


class _ImportSubject:
    """RowSource bridging an ExportedTable into another graph's input:
    replays the committed history, then polls for new epochs until the
    producer closes (reference ``scope.import_table``)."""

    deterministic_replay = False

    def __init__(self, exported: ExportedTable, poll_s: float = 0.02):
        self._exported = exported
        self._poll_s = poll_s

    def run(self, events: Any) -> None:
        offset = 0
        while True:
            batch, offset, _frontier, closed = self._exported.data_from_offset(
                offset
            )
            for _t, key, values, diff in batch:
                if diff > 0:
                    events.add(key, values)
                else:
                    events.remove(key, values)
            if batch:
                events.commit()
            if closed and not batch:
                break
            if events.stopped:
                break
            if not batch:
                _time.sleep(self._poll_s)
        events.close()


def import_table(exported: ExportedTable) -> Table:
    """Rebuild an exported table as an input of the CURRENT graph,
    preserving row keys and dtypes (reference ``scope.import_table``)."""
    from pathway_tpu_torch.internals import schema as sch
    from pathway_tpu_torch.io._connector import input_table

    # dt.wrap passes DType instances through, so the exported dtypes
    # carry over verbatim
    schema = sch.schema_from_types(
        **{
            n: exported.dtypes.get(n) or object
            for n in exported.column_names
        }
    )
    t = input_table(
        _ImportSubject(exported), schema, name="import", upsert=False
    )
    t._dtypes.update(exported.dtypes)
    return t


class LiveTable:
    """A continuously updated snapshot of a table (reference ``LiveTable``),
    built on the export machinery: update history, epoch frontier, and
    blocking synchronisation."""

    def __init__(self, table: Table):
        self._columns = table._column_names
        self.rows: dict[Any, tuple] = {}
        self._lock = threading.Lock()
        self._changed = threading.Condition(self._lock)
        #: mirrored under OUR lock so wait() never touches the ExportNode
        #: lock (the engine thread holds that lock while delivering to
        #: _on_batch, which takes ours — reading through would AB-BA)
        self._frontier = -1
        self._exported = export_table(table)
        self._exported.subscribe(self._on_batch, replay=True)

    def _on_batch(self, batch: list, frontier: int) -> None:
        with self._changed:
            for _t, key, values, diff in batch:
                if diff > 0:
                    self.rows[key] = values
                else:
                    self.rows.pop(key, None)
            self._frontier = max(self._frontier, frontier)
            self._changed.notify_all()

    # -- synchronisation ------------------------------------------------
    def frontier(self) -> int:
        with self._lock:
            return self._frontier

    def wait(self, epoch: int, timeout: float = 30.0) -> bool:
        """Block until the exported frontier reaches ``epoch``."""
        deadline = _time.monotonic() + timeout
        with self._changed:
            while self._frontier < epoch:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return False
                self._changed.wait(min(left, 0.5))
        return True

    def wait_closed(self, timeout: float = 30.0) -> bool:
        """Block until the producing run finishes."""
        deadline = _time.monotonic() + timeout
        while not self._exported.closed:
            if _time.monotonic() >= deadline:
                return False
            _time.sleep(0.02)
        return True

    # -- views ----------------------------------------------------------
    def snapshot(self) -> dict[Any, tuple]:
        with self._lock:
            return dict(self.rows)

    def update_history(self) -> list[tuple[int, Any, tuple, int]]:
        """The full (time, key, values, diff) update stream so far (read
        from the export log — not duplicated here)."""
        return self._exported.data_from_offset(0)[0]

    def to_pandas(self):
        import pandas as pd

        with self._lock:
            return pd.DataFrame.from_dict(
                self.rows, orient="index", columns=self._columns
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self.rows)

    def __repr__(self) -> str:
        return f"<LiveTable {len(self.rows)} rows: {self._columns}>"


def live(table: Table, *, start: bool = True) -> LiveTable:
    """Create a LiveTable and (by default) start the run in the
    background if not already running."""
    lt = LiveTable(table)
    if start and _interactive["thread"] is None:
        import pathway_tpu_torch as pw

        th = threading.Thread(target=pw.run, daemon=True, name="pw_interactive")
        th.start()
        _interactive["thread"] = th
    return lt
