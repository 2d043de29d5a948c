"""``pw.debug`` — build tables from literals, run & print results.

Capability parity with reference ``python/pathway/debug/__init__.py``:
``table_from_markdown`` (``:312``), ``table_from_rows``, ``table_from_pandas``,
``compute_and_print`` (``:207``), ``compute_and_print_update_stream``
(``:235``), ``table_to_pandas``, ``StreamGenerator`` (``:496``).
"""

from __future__ import annotations

import re
import threading
from typing import Any, Iterable, Mapping

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.engine.scheduler import Scheduler
from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


def _parse_cell(text: str) -> Any:
    text = text.strip()
    if text in ("", "None"):
        return None
    if text == "True":
        return True
    if text == "False":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    return text


def table_from_markdown(
    txt: str,
    *,
    id_from: list[str] | None = None,
    schema: Any = None,
    _stream: bool = False,
    **kwargs: Any,
) -> Table:
    """Parse a markdown/ascii table into a static table.  A column named
    ``id`` gives explicit row keys; ``__time__``/``__diff__`` columns build
    an update stream (reference ``debug/__init__.py:312-481``)."""
    lines = [l for l in txt.strip().splitlines() if l.strip() and not set(l.strip()) <= {"-", "|", "+", " "}]

    # outer-pipe style ("| a | b |") is decided by the HEADER: in the
    # bare style ("a | b") a row's leading pipe marks an EMPTY FIRST
    # CELL ("  | n1" is [None, "n1"]), which a blanket strip("|") used
    # to swallow
    outer_pipes = lines[0].strip().startswith("|") if lines else False

    def split_line(line: str) -> list[str]:
        stripped = line.strip()
        if "|" in stripped:
            parts = stripped.split("|")
            if outer_pipes:
                if stripped.startswith("|"):
                    parts = parts[1:]
                if stripped.endswith("|"):
                    parts = parts[:-1]
            # bare style keeps every field: a trailing empty cell parses
            # to None exactly where header-length padding would put it
            return [c.strip() for c in parts]
        # whitespace-separated; quoted strings stay whole
        return re.findall(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|\S+", line)

    header = [h for h in split_line(lines[0]) if h]
    rows: list[list[Any]] = []
    for line in lines[1:]:
        cells = [c for c in split_line(line)]
        row = [_parse_cell(c) for c in cells[: len(header)]]
        row.extend([None] * (len(header) - len(row)))  # trailing empty cells
        rows.append(row)

    has_id = "id" in header
    special = [c for c in ("__time__", "__diff__") if c in header]
    data_cols = [c for c in header if c != "id" and c not in special]

    if special:
        return _stream_table_from_rows(header, rows, data_cols, has_id, schema)

    out_rows: list[tuple[K.Pointer, tuple]] = []
    for i, r in enumerate(rows):
        vals = dict(zip(header, r))
        if has_id:
            key = K.ref_scalar(vals["id"])
        elif id_from:
            key = K.ref_scalar(*[vals[c] for c in id_from])
        elif schema is not None and sch.is_schema(schema) and schema.primary_key_columns():
            key = K.ref_scalar(*[vals[c] for c in schema.primary_key_columns()])
        else:
            key = K.sequential_key(i)
        out_rows.append((key, tuple(vals[c] for c in data_cols)))

    dtypes = _infer_dtypes(data_cols, [v for _, v in out_rows], schema)
    node = eg.InputNode(
        G.engine_graph, n_cols=len(data_cols), static_rows=out_rows, name="markdown"
    )
    return Table(node, data_cols, dtypes, name="markdown")


def _infer_dtypes(cols: list[str], rows: list[tuple], schema: Any) -> dict[str, dt.DType]:
    if schema is not None and sch.is_schema(schema):
        return {c: schema.__columns__[c].dtype for c in cols if c in schema.__columns__}
    dtypes: dict[str, dt.DType] = {}
    for i, c in enumerate(cols):
        seen = {dt.dtype_of_value(r[i]) for r in rows if r[i] is not None}
        has_none = any(r[i] is None for r in rows)
        if len(seen) == 1:
            d = seen.pop()
        elif seen == {dt.INT, dt.FLOAT}:
            d = dt.FLOAT
        else:
            d = dt.ANY
        dtypes[c] = dt.Optional(d) if has_none and d != dt.ANY else d
    return dtypes


class _StreamClock:
    """Deterministic replay order for every markdown stream subject built
    on one graph.  Reader threads replay concurrently, so without
    coordination the epoch a row lands in depends on thread scheduling —
    two ``__time__`` tables only line up by luck.  The clock serializes
    the replay into one global schedule: every (time, subject) batch in
    ascending ``__time__`` order, registration (= construction) order
    within a time, each batch committed as its own epoch.  That is the
    interleaving the unsynchronized replay produced when the race went
    the expected way — now it is the only interleaving."""

    #: a reader that never starts (its node pruned from the run, or the
    #: run cancelled mid-replay) stalls the schedule; after this wait the
    #: remaining readers proceed unserialized rather than hang
    _STEP_TIMEOUT_S = 5.0

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._batches: list[tuple[int, int]] = []  # (time, subject id)
        self._n_subjects = 0
        self._steps: dict[tuple[int, int], int] | None = None
        self._counter = 0

    def register(self, times: Iterable[int]) -> int:
        """Called at graph-build time; returns the subject's id."""
        with self._cond:
            sid = self._n_subjects
            self._n_subjects += 1
            self._batches.extend((t, sid) for t in sorted(set(times)))
            return sid

    def reset(self) -> None:
        """Rewind for a fresh scheduler run: the same graph re-runs every
        subject from scratch, so the schedule replays from slot 0."""
        with self._cond:
            self._counter = 0
            self._steps = None  # pick up subjects registered since the freeze
            self._cond.notify_all()

    def _schedule(self) -> dict[tuple[int, int], int]:
        # first reader in freezes membership (graph construction is done
        # before the scheduler starts any reader thread)
        if self._steps is None:
            self._batches.sort()
            self._steps = {b: i for i, b in enumerate(self._batches)}
        return self._steps

    def step(self, t: int, sid: int, emit: Any) -> None:
        """Run ``emit`` (enqueue rows + commit) at this batch's slot in
        the global schedule."""
        with self._cond:
            # a subject built AFTER the first replay froze the schedule
            # (tables added to an already-run graph) has no slot: emit
            # unserialized rather than renumber a live schedule
            idx = self._schedule().get((t, sid))
            if idx is not None:
                self._cond.wait_for(
                    lambda: self._counter >= idx, timeout=self._STEP_TIMEOUT_S
                )
        try:
            emit()
        finally:
            if idx is not None:
                with self._cond:
                    self._counter = max(self._counter, idx + 1)
                    self._cond.notify_all()


class _StreamSubject:
    """Replays timed rows through the connector interface so ``__time__`` /
    ``__diff__`` markdown columns become a genuine update stream.  With a
    :class:`_StreamClock` every batch lands at its deterministic slot in
    the graph-wide replay schedule."""

    def __init__(
        self,
        timed_rows: list[tuple[int, K.Pointer, tuple, int]],
        clock: _StreamClock | None = None,
    ):
        self.timed_rows = sorted(timed_rows, key=lambda r: r[0])
        self.clock = clock
        self.sid = (
            clock.register({t for t, _k, _v, _d in self.timed_rows})
            if clock is not None
            else 0
        )

    def _emit(self, events: Any, batch: list) -> None:
        for key, vals, diff in batch:
            if diff >= 0:
                events.add(key, vals)
            else:
                events.remove(key, vals)
        events.commit()

    def run(self, events: Any) -> None:
        by_time: dict[int, list] = {}
        for t, key, vals, diff in self.timed_rows:
            by_time.setdefault(t, []).append((key, vals, diff))
        for t in sorted(by_time):
            if self.clock is not None:
                self.clock.step(
                    t, self.sid, lambda b=by_time[t]: self._emit(events, b)
                )
            else:
                self._emit(events, by_time[t])


def _occurrence_key(tag: str, row: tuple, diff: int, occupancy: dict) -> K.Pointer:
    """Value-derived stream keys with multiset semantics: the n-th
    outstanding addition of equal row values gets a distinct key, and a
    retraction targets the LATEST outstanding occurrence — so duplicates
    stay distinct rows AND ``__diff__=-1`` lines retract the row their
    matching ``+1`` line added (sequential per-line keys would miss)."""
    from pathway_tpu_torch.engine.stream import hashable_row

    h = hashable_row(row)
    outstanding = occupancy.setdefault(h, [0, []])
    if diff >= 0:
        occ = outstanding[0]
        outstanding[0] += 1
        key = K.ref_scalar(tag, occ, *row)
        outstanding[1].append(key)
        return key
    if outstanding[1]:
        return outstanding[1].pop()
    return K.ref_scalar(tag, 0, *row)  # retract-before-add


def _stream_table_from_rows(
    header: list[str], rows: list[list[Any]], data_cols: list[str], has_id: bool, schema: Any
) -> Table:
    timed: list[tuple[int, K.Pointer, tuple, int]] = []
    occupancy: dict = {}
    for i, r in enumerate(rows):
        vals = dict(zip(header, r))
        t = int(vals.get("__time__") or 0)  # `or`: a padded None cell
        diff = int(vals.get("__diff__") or 1)
        row = tuple(vals[c] for c in data_cols)
        if has_id:
            key = K.ref_scalar(vals["id"])
        else:
            key = _occurrence_key("__md_stream__", row, diff, occupancy)
        timed.append((t, key, row, diff))
    dtypes = _infer_dtypes(data_cols, [v for _, _, v, _ in timed], schema)
    graph = G.engine_graph
    clock = getattr(graph, "_md_stream_clock", None)
    if clock is None:
        clock = graph._md_stream_clock = _StreamClock()
    node = eg.InputNode(
        graph,
        n_cols=len(data_cols),
        subject=_StreamSubject(timed, clock),
        name="markdown_stream",
    )
    return Table(node, data_cols, dtypes, name="markdown_stream")


def stream_table_from_markdown(txt: str, **kwargs: Any) -> Table:
    return table_from_markdown(txt, _stream=True, **kwargs)


def table_from_rows(
    schema: Any,
    rows: Iterable[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    cols = schema.column_names()
    pk = schema.primary_key_columns()
    out_rows: list[tuple[K.Pointer, tuple]] = []
    timed: list[tuple[int, K.Pointer, tuple, int]] = []
    occupancy: dict = {}
    for i, r in enumerate(rows):
        if is_stream:
            *vals, time_, diff = r
        else:
            vals = list(r)
            time_, diff = 0, 1
        if pk:
            key = K.ref_scalar(*[vals[cols.index(c)] for c in pk])
        elif is_stream:
            key = _occurrence_key("__rows_stream__", tuple(vals), diff, occupancy)
        else:
            key = K.sequential_key(i)
        if is_stream:
            timed.append((time_, key, tuple(vals), diff))
        else:
            out_rows.append((key, tuple(vals)))
    dtypes = {c: schema.__columns__[c].dtype for c in cols}
    if is_stream:
        node = eg.InputNode(
            G.engine_graph, n_cols=len(cols), subject=_StreamSubject(timed), name="rows_stream"
        )
    else:
        node = eg.InputNode(
            G.engine_graph, n_cols=len(cols), static_rows=out_rows, name="rows"
        )
    return Table(node, cols, dtypes, name="rows")


def table_from_dicts(rows: Iterable[Mapping[str, Any]], schema: Any = None) -> Table:
    rows = list(rows)
    if schema is None:
        cols: list[str] = []
        for r in rows:
            for c in r:
                if c not in cols:
                    cols.append(c)
        schema = sch.schema_from_types(**{c: Any for c in cols})
    return table_from_rows(schema, [tuple(r.get(c) for c in schema.column_names()) for r in rows])


def table_from_pandas(df: Any, id_from: list[str] | None = None, schema: Any = None) -> Table:
    if schema is None:
        schema = sch.schema_from_pandas(df, id_from=id_from)
    cols = schema.column_names()
    rows = [tuple(df.iloc[i][c] for c in cols) for i in range(len(df))]
    # normalise numpy scalars to python
    import numpy as np

    def norm(v: Any) -> Any:
        if isinstance(v, np.generic):
            return v.item()
        return v

    rows = [tuple(norm(v) for v in r) for r in rows]
    return table_from_rows(schema, rows)


def table_from_parquet(
    path: Any, id_from: list[str] | None = None, schema: Any = None
) -> Table:
    """Static table from a parquet file (reference
    ``debug/__init__.py:312-481`` table_from_parquet)."""
    import pandas as pd

    return table_from_pandas(pd.read_parquet(path), id_from=id_from, schema=schema)


def table_to_parquet(table: Table, filename: Any) -> None:
    """Run the graph and write the table's final rows to parquet."""
    table_to_pandas(table, include_id=False).to_parquet(filename)


def _run_capture(*tables: Table) -> list[tuple[dict, list]]:
    captures = [t._capture_node() for t in tables]
    clock = getattr(G.engine_graph, "_md_stream_clock", None)
    if clock is not None:
        clock.reset()
    sched = Scheduler(G.engine_graph)
    ctx = sched.run()
    G.last_run_ctx = ctx
    out = []
    for c in captures:
        st = ctx.state(c)
        out.append((st["rows"], st["stream"]))
    return out


def table_to_dicts(table: Table) -> tuple[list, dict[str, dict]]:
    (rows, _), = _run_capture(table)
    keys = list(rows.keys())
    cols = {
        c: {k: rows[k][i] for k in keys} for i, c in enumerate(table._column_names)
    }
    return keys, cols


def table_to_pandas(table: Table, include_id: bool = True) -> Any:
    import pandas as pd

    (rows, _), = _run_capture(table)
    data = {c: [v[i] for v in rows.values()] for i, c in enumerate(table._column_names)}
    if include_id:
        return pd.DataFrame(data, index=[repr(k) for k in rows.keys()])
    return pd.DataFrame(data)


def _fmt(v: Any) -> str:
    if v is None:
        return "None"
    if v is api.ERROR:
        return "Error"
    return repr(v) if isinstance(v, str) else str(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    squash_updates: bool = True,
    **kwargs: Any,
) -> None:
    """Run the graph; print the final state of ``table``."""
    (rows, _), = _run_capture(table)
    cols = table._column_names
    header = (["id"] if include_id else []) + list(cols)
    lines = []
    sortable = sorted(
        rows.items(), key=lambda kv: tuple(repr(v) for v in kv[1])
    )
    for key, vals in sortable[: n_rows if n_rows is not None else len(sortable)]:
        row = ([repr(key)] if include_id else []) + [_fmt(v) for v in vals]
        lines.append(row)
    widths = [max(len(h), *(len(l[i]) for l in lines)) if lines else len(h) for i, h in enumerate(header)]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for l in lines:
        print(" | ".join(c.ljust(w) for c, w in zip(l, widths)).rstrip())


def compute_and_print_update_stream(
    table: Table, *, include_id: bool = True, **kwargs: Any
) -> None:
    """Run the graph; print every (time, diff) update of ``table``."""
    (_, stream), = _run_capture(table)
    cols = table._column_names
    header = (["id"] if include_id else []) + list(cols) + ["__time__", "__diff__"]
    lines = []
    for key, vals, time, diff in stream:
        row = ([repr(key)] if include_id else []) + [_fmt(v) for v in vals] + [str(time), str(diff)]
        lines.append(row)
    widths = [max(len(h), *(len(l[i]) for l in lines)) if lines else len(h) for i, h in enumerate(header)]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for l in lines:
        print(" | ".join(c.ljust(w) for c, w in zip(l, widths)).rstrip())


class StreamGenerator:
    """Programmatic update-stream builder for tests (reference
    ``debug/__init__.py:496``)."""

    def __init__(self) -> None:
        self._events: list[tuple[int, K.Pointer, tuple, int]] = []
        self._counter = 0

    def table(self, schema: Any, batches: list[dict[K.Pointer, list]] | None = None) -> Table:
        cols = schema.column_names()
        node = eg.InputNode(
            G.engine_graph,
            n_cols=len(cols),
            subject=_StreamSubject(self._events),
            name="stream_generator",
        )
        dtypes = {c: schema.__columns__[c].dtype for c in cols}
        return Table(node, cols, dtypes, name="stream_generator")

    def _next_key(self) -> K.Pointer:
        self._counter += 1
        return K.sequential_key(self._counter)

    def add(self, time: int, values: tuple, key: K.Pointer | None = None, diff: int = 1) -> K.Pointer:
        key = key if key is not None else self._next_key()
        self._events.append((time, key, values, diff))
        return key

    def table_from_list_of_batches_by_workers(self, *args: Any, **kwargs: Any) -> Table:
        raise NotImplementedError("multi-worker stream generation: single-worker build")
