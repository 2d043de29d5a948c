"""Connector framework: reader subjects feeding the engine, writer sinks.

Capability parity with the reference connector layer
(``src/connectors/mod.rs`` ``Connector::run``, ``data_storage.rs`` readers,
``data_format.rs`` parsers/formatters): a reader thread parses events into
keyed rows and commits epochs; a writer subscribes to a table's update
stream and formats rows out.  The engine side is
:class:`pathway_tpu_torch.engine.graph.InputNode` (+ scheduler event queue).
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from typing import Any, Callable, Iterable

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import native as _nat
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

class _AutogenCounter:
    """Process-global sequence for auto-generated row keys.  Unlike
    ``itertools.count`` it can be observed and fast-forwarded, which
    persistence uses to guarantee resumed runs never re-issue a sequence
    number that a replayed key already embeds."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def __next__(self) -> int:
        with self._lock:
            v = self._n
            self._n += 1
            return v

    def peek(self) -> int:
        return self._n

    def advance_to(self, n: int) -> None:
        with self._lock:
            self._n = max(self._n, n)


_autogen_counter = _AutogenCounter()


class RowSource:
    """Engine-facing subject: ``run(events)`` called on a reader thread with
    an event sink (add/remove/commit/close)."""

    #: True for readers that re-emit their full history deterministically
    #: (enables count-based persistence resume; see pathway_tpu_torch.persistence)
    deterministic_replay = False

    #: how rows split across workers in a multi-worker run: "single"
    #: (one reader owns the whole stream), "byte-range" (static files
    #: split by offset), "round-robin", or "key" (routed by row key).
    #: Consumed by the distribution-safety pass (analysis/distribution.py).
    partitioning = "single"

    #: whether per-key arrival order survives a partitioned multi-worker
    #: read.  Byte-range file splits do NOT preserve it.
    order_preserving = True

    def run(self, events: Any) -> None:  # pragma: no cover
        raise NotImplementedError


def key_for_row(
    values: dict[str, Any],
    pk_columns: list[str] | None,
    seq: int | None = None,
    source_tag: str = "",
) -> K.Pointer:
    """Row key: hash of primary-key values when declared, else sequential
    (reference keys from pk columns or connector offsets)."""
    if pk_columns:
        return K.ref_scalar(*[values[c] for c in pk_columns])
    return K.ref_scalar("__autogen__", source_tag, seq if seq is not None else next(_autogen_counter))


_coercer_cache: dict[Any, list] = {}


def _column_coercer(dtype: Any):
    """Per-dtype coercion closure — same semantics as ``dt.coerce`` with the
    dtype dispatch hoisted out of the per-row loop."""
    base = dtype.strip_optional()
    if base == dt.FLOAT:

        def co(v):
            if isinstance(v, float):
                return v
            if isinstance(v, int):
                return float(v)
            if isinstance(v, str):
                try:
                    return float(v)
                except ValueError:
                    return v
            return v

    elif base == dt.INT:

        def co(v):
            if isinstance(v, int):
                return v
            if isinstance(v, float) and v.is_integer():
                return int(v)
            if isinstance(v, str):
                try:
                    return int(v)
                except ValueError:
                    return v
            return v

    elif base == dt.STR:

        def co(v):
            return v if isinstance(v, str) else str(v)

    elif base == dt.BOOL:

        def co(v):
            if isinstance(v, str):
                return v.lower() in ("true", "1", "t", "yes")
            return v

    else:

        def co(v):
            return v

    return co


#: native coercion codes (native/pathway_native.cpp CoerceCode); every
#: dtype outside this map coerces as identity (code 0)
_NATIVE_CODES = {dt.INT: 1, dt.FLOAT: 2, dt.STR: 3, dt.BOOL: 4}


def _schema_plans(schema: sch.SchemaMetaclass) -> tuple[list, tuple]:
    """One cached plan per schema, built once: the Python coercer closures
    and the equivalent native code table share the same (name, default)
    extraction so the two paths cannot drift apart."""
    plans = _coercer_cache.get(schema)
    if plans is None:
        cols = [
            (name, col.default_value if col.has_default else None, col.dtype)
            for name, col in schema.__columns__.items()
        ]
        py_plan = [(n, d, _column_coercer(t)) for n, d, t in cols]
        native_plan = tuple(
            (n, d, _NATIVE_CODES.get(t.strip_optional(), 0)) for n, d, t in cols
        )
        plans = (py_plan, native_plan)
        _coercer_cache[schema] = plans
    return plans


def _schema_coercers(schema: sch.SchemaMetaclass) -> list:
    return _schema_plans(schema)[0]


def coerce_row(values: dict[str, Any], schema: sch.SchemaMetaclass) -> tuple:
    out = []
    for name, default, co in _schema_coercers(schema):
        v = values.get(name)
        if v is None:
            v = default
        out.append(co(v) if v is not None else None)
    return tuple(out)


def coerce_rows(rows: list, schema: sch.SchemaMetaclass) -> list:
    """Bulk :func:`coerce_row` over a block of parsed row dicts — one C
    call when the native extension is available (reference parser hot
    loop, ``src/connectors/data_format.rs``)."""
    native = _nat.load()
    if native is not None:
        try:
            return native.coerce_rows(rows, _schema_plans(schema)[1])
        except native.Unsupported:
            pass
    return [coerce_row(v, schema) for v in rows]


def input_table(
    subject: RowSource | None,
    schema: sch.SchemaMetaclass,
    *,
    static_rows: Iterable[tuple[K.Pointer, tuple]] = (),
    name: str = "connector",
    upsert: bool = False,
    auxiliary: bool = False,
    persistent_id: str | None = None,
    recovery_policy: Any = None,
    on_overflow: str | None = None,
) -> Table:
    cols = schema.column_names()
    if on_overflow is not None:
        from pathway_tpu_torch.engine.scheduler import INGEST_OVERFLOW_MODES

        if on_overflow not in INGEST_OVERFLOW_MODES:
            raise ValueError(
                f"on_overflow must be one of {INGEST_OVERFLOW_MODES}, "
                f"got {on_overflow!r}"
            )
    node = eg.InputNode(
        G.engine_graph,
        n_cols=len(cols),
        static_rows=static_rows,
        subject=subject,
        name=name,
        upsert=upsert,
    )
    # auxiliary inputs (e.g. AsyncTransformer loopbacks) don't keep the
    # run alive on their own; the scheduler exits when primaries close
    # and auxiliaries report no pending work
    node.auxiliary = auxiliary
    # explicit snapshot identity (reference persistent_id): names the
    # snapshot stream stably across graph edits, and opts the source into
    # SELECTIVE_PERSISTING
    node.persistent_id = persistent_id
    # restart/backoff/breaker supervision (ConnectorRecoveryPolicy,
    # pathway_tpu_torch.internals.resilience); None keeps the historical
    # one-failure-drops-the-source behaviour
    node.recovery_policy = recovery_policy
    # ingest-buffer overflow policy ("pause" | "shed_oldest" | "fail");
    # None defaults to "pause" — the reader parks until the drain frees
    # credit (see engine.scheduler.IngestCredit)
    node.on_overflow = on_overflow
    # distribution-safety facts for the analyzer: static tables live on
    # every worker identically; live sources advertise how they split and
    # whether per-key order survives the split (analysis/distribution.py)
    dtypes = {c: schema.__columns__[c].dtype for c in cols}
    node.meta["source"] = {
        "name": name,
        "upsert": upsert,
        "partitioning": (
            "static" if subject is None else getattr(subject, "partitioning", "single")
        ),
        "order_preserving": (
            True if subject is None else bool(getattr(subject, "order_preserving", True))
        ),
        "dtypes": list(dtypes.values()),
    }
    return Table(node, cols, dtypes, name=name)


class DictSource(RowSource):
    """Reader emitting parsed dict rows via a user-supplied generator; commits
    an epoch per ``commit_every`` rows or ``commit_interval`` seconds."""

    deterministic_replay = True

    def __init__(
        self,
        row_iter: Callable[[], Iterable[dict[str, Any] | tuple[str, dict[str, Any]]]],
        schema: sch.SchemaMetaclass,
        *,
        commit_every: int | None = None,
        commit_interval: float | None = None,
        tag: str = "",
    ):
        self.row_iter = row_iter
        self.schema = schema
        self.commit_every = commit_every
        self.commit_interval = commit_interval
        self.tag = tag

    def run(self, events: Any) -> None:
        pk = self.schema.primary_key_columns()
        n = 0
        last_commit = _time.monotonic()
        for item in self.row_iter():
            if events.stopped:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] in ("add", "remove"):
                op, values = item
            else:
                op, values = "add", item
            key = key_for_row(values, pk, seq=None, source_tag=self.tag)
            row = coerce_row(values, self.schema)
            if op == "add":
                events.add(key, row)
            else:
                events.remove(key, row)
            n += 1
            now = _time.monotonic()
            if (self.commit_every and n % self.commit_every == 0) or (
                self.commit_interval and now - last_commit >= self.commit_interval
            ):
                events.commit()
                last_commit = now
        events.commit()


# ---------------------------------------------------------------------------
# Writers


class Writer:
    """Formats and persists one row update (reference ``trait Writer``,
    ``src/connectors/data_storage.rs:619``)."""

    def write(self, row: dict[str, Any], time: int, diff: int) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class LazyFileWriter(Writer):
    """File-backed writer that opens lazily on first row.

    In a process cluster every process builds the graph, but only worker 0
    receives output rows — an eager ``open(path, "w")`` in ``__init__``
    would let a peer process truncate worker 0's file.  ``close()`` (called
    only on the owning worker) still creates/truncates the file even when
    the run emitted zero rows, so stale output from a previous run never
    survives a successful empty run."""

    _open_newline: str | None = None

    def __init__(self, path: str):
        self._path = path
        self._f: Any = None
        self._resumed = False

    def _file(self):
        if self._f is None:
            # after a checkpoint resume the committed prefix up to the
            # watermark must survive — append instead of truncating
            mode = "a" if self._resumed else "w"
            self._f = open(self._path, mode, newline=self._open_newline)
        return self._f

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        self._file().close()

    def watermark(self) -> int:
        """Byte offset of everything emitted so far (the sink-dedup
        watermark checkpointed with the operator state).  Flushes first so
        the offset covers the epoch just closed; measured with getsize —
        byte-exact, unlike text-mode ``tell()`` cookies."""
        if self._f is not None:
            self._f.flush()
            return os.path.getsize(self._path)
        if self._resumed and os.path.exists(self._path):
            return os.path.getsize(self._path)
        return 0

    def resume_at(self, offset: int) -> bool:
        """Roll the output file back to a checkpointed watermark: truncate
        to ``offset`` bytes and flip subsequent opens to append, so the
        recovered file is exactly the checkpointed prefix plus the
        replayed tail (duplicate emissions from replayed epochs are
        suppressed by construction).  False when the file is gone or
        shorter than the watermark — the sink then rewrites from scratch,
        which is still correct (full replay reproduces every row)."""
        if self._f is not None:
            return False  # already emitting: too late to roll back
        try:
            if os.path.getsize(self._path) < offset:
                return False
            with open(self._path, "r+b") as f:
                f.truncate(offset)
            self._resumed = True
            return True
        except OSError:
            return False


def attach_writer(table: Table, writer: Writer, *, name: str = "output") -> None:
    cols = table._column_names

    def on_change(key: K.Pointer, values: tuple, time: int, diff: int) -> None:
        row = dict(zip(cols, values))
        row["id"] = key
        writer.write(row, time, diff)

    def on_time_end(time: int) -> None:
        writer.flush()

    def on_end() -> None:
        writer.flush()
        writer.close()

    node = eg.OutputNode(
        G.engine_graph,
        table._node,
        on_change,
        on_time_end,
        on_end,
        name=name,
        writer=writer,  # enables checkpointed sink-dedup watermarks
    )
    node.meta["sink"] = {
        "names": list(cols),
        "dtypes": dict(table._dtypes),
    }


def format_change_row(row: dict[str, Any], time: int, diff: int) -> dict[str, Any]:
    """Standard change-stream document for service sinks: formatted row
    columns (``id`` dropped) plus integral ``time``/``diff`` fields — the
    reference's writer contract (a modification = a -1 doc then a +1 doc)."""
    doc = {k: fmt_value(v) for k, v in row.items() if k != "id"}
    doc["time"] = time
    doc["diff"] = diff
    return doc


def fmt_key(v: Any) -> str:
    """Canonical sink serialization of a row key: the full 128-bit value,
    NOT repr (repr truncates to 12 chars — two distinct keys could print
    identically).  One format across every sink, so ids correlate.
    Non-Pointer ids pass through as plain strings."""
    if isinstance(v, K.Pointer):
        return f"^{int(v):032X}"
    return str(v)


def fmt_value(v: Any) -> Any:
    import datetime

    import numpy as np

    from pathway_tpu_torch.internals.api import ERROR
    from pathway_tpu_torch.internals.json import Json

    if isinstance(v, K.Pointer):
        return fmt_key(v)
    if isinstance(v, Json):
        return v.value
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (datetime.datetime, datetime.timedelta)):
        return str(v)
    if v is ERROR:
        return "Error"
    if isinstance(v, tuple):
        return [fmt_value(x) for x in v]
    return v
