"""``pw.io.fs`` — filesystem connector: single files or directories, static
or watched-streaming (reference ``python/pathway/io/fs``; engine POSIX-like
scanner ``src/connectors/posix_like.rs``, ``scanner/filesystem.rs``)."""

from __future__ import annotations

import os
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.engine.columnar import columnar_enabled as _columnar_enabled
from pathway_tpu_torch.internals import native as _native_mod
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import keys_for_values, ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import (
    LazyFileWriter,
    RowSource,
    attach_writer,
    coerce_row,
    coerce_rows,
    fmt_value,
    input_table,
)

__all__ = ["read", "write"]


def _list_files(path: str) -> list[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return sorted(out)
    import glob

    if any(ch in path for ch in "*?["):
        return sorted(glob.glob(path))
    return [path] if os.path.exists(path) else []


def _nonempty_lines_before(f, nbytes: int, block: int) -> int:
    """Count non-empty lines in the first ``nbytes`` of an open binary
    file — the global line-seq base for a byte-range share (row keys hash
    the global sequence number, so a worker starting mid-file must know
    how many lines precede it).  Newline counting is memchr-speed with no
    per-line allocation; only blocks actually containing empty lines pay
    a split."""
    count = 0
    prev_nl = True  # start-of-file behaves like "just after a newline"
    left = nbytes
    while left > 0:
        b = f.read(min(block, left))
        if not b:
            break
        left -= len(b)
        if b"\n\n" not in b and not (prev_nl and b.startswith(b"\n")):
            # no empty line anywhere: every newline ends a non-empty line
            count += b.count(b"\n")
        else:
            parts = b.split(b"\n")
            if len(parts) > 1:
                # parts[0] closes a line opened earlier (non-empty if it
                # has bytes here or had any before this block)
                if parts[0] or not prev_nl:
                    count += 1
                count += sum(1 for p in parts[1:-1] if p)
        prev_nl = b.endswith(b"\n")
    return count


class _FilesSource(RowSource):
    """Reads lines of files under a path; in streaming mode polls for new
    files and appended lines (reference filesystem scanner + dir watching)."""

    deterministic_replay = True

    # multi-worker reads split files by byte range (static, stateless
    # parser) or interleaved line share; either way two rows with the
    # same key can land on different ranks, so cross-rank per-key arrival
    # order is NOT preserved (the keyed-upsert hazard — PW-X001)
    partitioning = "byte-range"
    order_preserving = False

    def __init__(
        self,
        path: str,
        schema: sch.SchemaMetaclass,
        *,
        parse_line: Callable[[str], dict | None] | None = None,
        parser_factory: Callable[[str], Callable[[str], dict | None]] | None = None,
        parse_block: Callable[[bytes], "list[dict] | None"] | None = None,
        frame_plan: tuple | None = None,
        mode: str = "streaming",
        poll_interval: float = 0.2,
        with_metadata: bool = False,
        tag: str = "fs",
    ):
        self.path = path
        self.schema = schema
        #: optional columnar fast path: parse a block of COMPLETE lines at
        #: once (e.g. pandas' C JSON parser); returning None falls back to
        #: the per-line parser for that block (e.g. malformed rows)
        self.parse_block = parse_block
        #: native schema plan for frame_parse_jsonl (set by formats whose
        #: lines are flat JSON objects): a block of lines parses straight
        #: into a columnar frame — typed column arrays + interned string
        #: pool + LAZY row keys — and enters the engine via add_frame
        #: with no per-row Python objects at all.  None = row path.
        self.frame_plan = frame_plan
        # parser_factory(fp) -> line parser with per-file state (CSV headers);
        # plain parse_line is wrapped as a stateless factory.  Stateless
        # parsers allow the pre-parse line partition (each worker parses
        # only its share); stateful ones must see every line (headers), so
        # partitioned workers filter at emit instead
        self._stateless_parser = parser_factory is None
        if parser_factory is None:
            assert parse_line is not None
            parser_factory = lambda fp, p=parse_line: p
        self.parser_factory = parser_factory
        self.mode = mode
        self.poll_interval = poll_interval
        self.with_metadata = with_metadata
        self.tag = tag
        #: (worker, n_workers) — this reader emits only rows whose key
        #: hash it owns (parallel partitioned reads, reference
        #: ``connector_table(parallel_readers=...)`` dataflow.rs:3291)
        self._part = (0, 1)

    def partition(self, worker: int, n_workers: int) -> "_FilesSource | None":
        """Disjoint share per worker: static files with stateless parsers
        split by BYTE RANGE (each worker reads only its 1/n of the file);
        streaming appends fall back to the interleaved line-index share
        (stateful parsers see every line and filter at emit).  Row keys
        are identical to a single-worker run either way, so persistence
        resume and N-vs-1-worker outputs stay exact.  Downstream placement
        is the consumers' business — every routed operator re-exchanges
        its input."""
        import copy

        sub = copy.copy(self)
        sub._part = (worker, n_workers)
        return sub

    def _emit_file(
        self, events: Any, fp: str, start_offset: int, seq_start: int, parser: Callable
    ) -> tuple[int, int]:
        pk = self.schema.primary_key_columns()
        seq = seq_start  # non-empty LINE counter (keys + partitioning)
        add_many = getattr(events, "add_many", None)
        chunk: list = []  # (key, row) additions flushed per _CHUNK rows
        _CHUNK = 16384
        _BLOCK = 8 << 20
        schema = self.schema
        meta = (
            {"path": fp, "modified_at": int(os.path.getmtime(fp))}
            if self.with_metadata
            else None
        )
        w, n = self._part
        # columnar ingest gate, decided once per file: the native JSONL->
        # frame parser replicates coerce_rows + hash_prefix_ints exactly
        # (strict subset — anything unusual returns None and the block
        # falls back to the row path), so it is sound whenever keys are
        # seq-derived (no primary key), no metadata column is spliced in,
        # and the engine accepts frames (events.add_frame)
        _native = _native_mod.load()
        add_frame = getattr(events, "add_frame", None)
        frame_prefix = ("__fs__", self.tag, fp)
        frame_ok = (
            self.frame_plan is not None
            and add_frame is not None
            and _native is not None
            and not pk
            and meta is None
            and _columnar_enabled()
        )
        # static files with stateless parsers partition by BYTE RANGE:
        # the interleaved line share makes every worker read AND split the
        # whole file (the split allocates one object per line), a fixed
        # per-process cost that grows with worker count.  A byte range
        # reads 1/n of the file; the seq base for key stability comes
        # from a newline count over the prefix (no allocation).  Line
        # ownership changes, but keys hash the global line seq, so the
        # union of shares is byte-identical to a single-worker run.
        byte_range = None
        if (
            n > 1
            and start_offset == 0
            and self.mode == "static"
            and self._stateless_parser
        ):
            size = os.path.getsize(fp)
            byte_range = (size * w // n, size * (w + 1) // n)

        def emit_rows(rows: list, line_seqs: list[int]) -> None:
            nonlocal chunk
            if not rows:
                return
            if meta is not None:
                for values in rows:
                    values["_metadata"] = dict(meta)
            # keys for the whole block in ONE native hash call
            if pk:
                key_args = [tuple(v[c] for c in pk) for v in rows]
                keys = keys_for_values(key_args)
            else:
                keys = None
                native = _native_mod.load()
                if native is not None:
                    try:
                        # prefix hash state computed once, per-row seq int
                        # appended in C — no per-row Python key tuples
                        keys = native.hash_prefix_ints(
                            ("__fs__", self.tag, fp), line_seqs, 1
                        )
                    except native.Unsupported:
                        keys = None
                if keys is None:
                    keys = keys_for_values(
                        ("__fs__", self.tag, fp, s + 1) for s in line_seqs
                    )
            coerced = coerce_rows(rows, schema)
            if add_many is None:
                for key, row in zip(keys, coerced):
                    events.add(key, row)
            else:
                chunk.extend(zip(keys, coerced))
                while len(chunk) >= _CHUNK:  # bounded add_many batches:
                    # one queue item / snapshot record per _CHUNK rows
                    add_many(chunk[:_CHUNK])
                    chunk = chunk[_CHUNK:]

        def parse_and_emit(complete: bytes) -> None:
            """Split once, keep only this worker's line share (disjoint
            line-index partition: each worker PARSES only 1/n of the
            input, unlike a post-parse key filter), parse, emit.

            Parsing runs in LINE-BOUNDED SUB-BATCHES: an 8MB block holds
            ~10^5 rows, and coercing + hashing all of them before the
            first emit keeps the engine idle for the whole parse (the
            epoch loop saw its first row only after ~70% of the run's
            wall time in the 2-process wordcount).  Emitting every ~32k
            lines overlaps the downstream epochs with the parse the way
            the reference's connector thread overlaps with its timely
            workers (src/connectors/mod.rs reader thread -> main loop)."""
            nonlocal seq, chunk
            lines = [ln for ln in complete.split(b"\n") if ln]
            base = seq
            seq = base + len(lines)
            if not lines:
                return
            emit_filter = False
            if byte_range is not None:
                # byte-range share: every line handed to us is owned
                owned_seqs: "list[int] | range" = range(
                    base, base + len(lines)
                )
                owned_lines = lines
            elif n > 1 and self._stateless_parser:
                # owned line indices form an arithmetic progression:
                # first index i with (base + i) % n == w, then every n-th
                first = (w - base) % n
                owned_seqs = range(base + first, base + len(lines), n)
                owned_lines = lines[first::n]
            else:
                owned_seqs = range(base, base + len(lines))
                owned_lines = lines
                emit_filter = n > 1  # stateful parser: filter after parse
            if not owned_lines:
                return
            _SUB = 32768
            for lo in range(0, len(owned_lines), _SUB):
                sub_lines = owned_lines[lo : lo + _SUB]
                sub_seqs = owned_seqs[lo : lo + _SUB]
                if frame_ok and not emit_filter and isinstance(sub_seqs, range):
                    # columnar fast path: one C pass parses the lines into
                    # a frame (typed columns, interned strings, lazy keys
                    # from the same prefix-hash the row path uses).  The
                    # row count must match exactly — a skipped/malformed
                    # line changes seq alignment, so the row path decides.
                    fr = _native.frame_parse_jsonl(
                        b"\n".join(sub_lines),
                        self.frame_plan,
                        frame_prefix,
                        sub_seqs.start,
                        sub_seqs.step,
                        1,
                    )
                    if fr is not None and _native.frame_len(fr) == len(
                        sub_lines
                    ):
                        if chunk:
                            # per-source event ORDER is the persistence
                            # resume contract: row chunks queued before
                            # this frame must enter the log first
                            add_many(chunk)
                            chunk = []
                        add_frame(fr)
                        continue
                rows = None
                if self.parse_block is not None and not emit_filter:
                    # (emit_filter set = stateful parser under n>1: only
                    # the per-line loop below applies the share filter)
                    rows = self.parse_block(b"\n".join(sub_lines))
                    if rows is not None and len(rows) != len(sub_lines):
                        # parser dropped lines: per-line path keeps the
                        # line-seq <-> row alignment exact, so row keys
                        # never depend on worker count
                        rows = None
                if rows is not None:
                    emit_rows(rows, list(sub_seqs))
                    continue
                out_rows: list = []
                out_seqs: list[int] = []
                for s, raw in zip(sub_seqs, sub_lines):
                    try:
                        values = parser(raw.decode(errors="replace"))
                    except Exception:
                        values = None  # unparseable line: skip
                    if isinstance(values, dict) and not (
                        emit_filter and s % n != w
                    ):
                        out_rows.append(values)
                        out_seqs.append(s)
                emit_rows(out_rows, out_seqs)

        # binary mode: byte-accurate offsets (text-mode tell() is unusable
        # with block reads), splitting on b"\n"; only COMPLETE lines are
        # consumed in streaming mode (a writer mid-append retries later)
        with open(fp, "rb") as f:
            if byte_range is not None:
                lo, hi = byte_range
                start = 0
                if lo > 0:
                    # a line spanning the lo boundary belongs to the
                    # worker owning its first byte: skip to the first line
                    # START at/after lo.  Seeking to lo-1 makes a boundary
                    # landing exactly on a line start discard nothing (the
                    # byte at lo-1 is then the previous line's newline).
                    start = size  # no line starts here: emit nothing
                    f.seek(lo - 1)
                    probe = lo - 1
                    while True:
                        data = f.read(_BLOCK)
                        if not data:
                            break
                        nl = data.find(b"\n")
                        if nl >= 0:
                            start = probe + nl + 1
                            break
                        probe += len(data)
                f.seek(0)
                seq = _nonempty_lines_before(f, start, _BLOCK)
                f.seek(start)
                offset = start
                while offset < hi:
                    data = f.read(_BLOCK)
                    if not data:
                        break
                    at_eof = len(data) < _BLOCK
                    cut = -1
                    if offset + len(data) > hi:
                        # the line containing byte hi-1 is the last one
                        # owned; consume through its newline and stop
                        cut = data.find(b"\n", hi - 1 - offset)
                    if cut >= 0:
                        complete = data[: cut + 1]
                        f.seek(offset + len(complete))
                    elif at_eof:
                        complete = data  # static: unterminated tail too
                    else:
                        nl = data.rfind(b"\n")
                        if nl < 0:
                            # single line longer than the block: keep
                            # reading until its newline (or EOF)
                            parts = [data]
                            while True:
                                more = f.read(_BLOCK)
                                if not more:
                                    break
                                mnl = more.find(b"\n")
                                if mnl >= 0:
                                    parts.append(more[: mnl + 1])
                                    break
                                parts.append(more)
                            complete = b"".join(parts)
                        else:
                            complete = data[: nl + 1]
                        f.seek(offset + len(complete))
                    parse_and_emit(complete)
                    offset += len(complete)
                    if cut >= 0:
                        break
                if chunk:
                    add_many(chunk)
                return size, seq
            f.seek(start_offset)
            offset = start_offset
            while True:
                data = f.read(_BLOCK)
                if not data:
                    break
                at_eof = len(data) < _BLOCK
                if at_eof and self.mode == "static":
                    complete = data  # static: consume the unterminated tail too
                else:
                    nl = data.rfind(b"\n")
                    if nl < 0:
                        # a single line longer than the block: keep reading
                        # until its newline (or EOF) so the offset can
                        # advance — breaking here would re-read the same
                        # block forever in streaming mode
                        parts = [data]
                        while True:
                            more = f.read(_BLOCK)
                            if not more:
                                at_eof = True
                                break
                            nl = more.find(b"\n")
                            if nl >= 0:
                                parts.append(more[: nl + 1])
                                break
                            parts.append(more)
                        if at_eof and self.mode != "static":
                            break  # unterminated giant line: retry later
                        data = b"".join(parts)
                        complete = data
                        f.seek(offset + len(complete))
                    else:
                        complete = data[: nl + 1]
                        if nl + 1 < len(data):
                            f.seek(offset + len(complete))
                parse_and_emit(complete)
                offset += len(complete)
                if at_eof:
                    break
            if chunk:
                add_many(chunk)
            return offset, seq

    def run(self, events: Any) -> None:
        offsets: dict[str, int] = {}
        seqs: dict[str, int] = {}
        parsers: dict[str, Callable] = {}
        while True:
            emitted = False
            for fp in _list_files(self.path):
                start = offsets.get(fp, 0)
                try:
                    size = os.path.getsize(fp)
                except OSError:
                    continue
                if size > start:
                    if fp not in parsers:
                        parsers[fp] = self.parser_factory(fp)
                    offsets[fp], seqs[fp] = self._emit_file(
                        events, fp, start, seqs.get(fp, 0), parsers[fp]
                    )
                    emitted = True
            if emitted:
                events.commit()
            if self.mode == "static":
                return
            if events.stopped:
                return
            _time.sleep(self.poll_interval)


class _WholeFileSource(RowSource):
    """One row PER FILE (``format="binary"`` / ``"plaintext_by_file"``,
    reference binary object pattern): streaming mode polls the directory
    and upserts changed files (keyed by path) and retracts deleted ones —
    the dir-watch contract DocumentStore ingestion relies on."""

    #: the sorted dir scan re-produces events in the same order on a
    #: resume-from-snapshot restart (same contract as _FilesSource)
    deterministic_replay = True

    def __init__(
        self,
        path: str,
        schema: sch.SchemaMetaclass,
        *,
        binary: bool,
        mode: str,
        poll_interval: float = 0.2,
        with_metadata: bool = False,
    ):
        self.path = path
        self.schema = schema
        self.binary = binary
        self.mode = mode
        self.poll_interval = poll_interval
        self.with_metadata = with_metadata

    def _row(self, fp: str, payload: Any, mtime: float = 0.0) -> dict:
        values: dict[str, Any] = {"data": payload}
        if self.with_metadata:
            values["_metadata"] = {
                "path": fp,
                "modified_at": int(mtime),
            }
        return values

    def run(self, events: Any) -> None:
        seen: dict[str, tuple[float, int]] = {}  # path -> (mtime, size)
        while True:
            changed = False
            current = set()
            for fp in _list_files(self.path):
                current.add(fp)
                try:
                    st = os.stat(fp)
                    sig = (st.st_mtime, st.st_size)
                    if seen.get(fp) == sig:
                        continue
                    with open(fp, "rb") as f:
                        data = f.read()
                except OSError:
                    continue  # raced with deletion: next poll retracts
                payload: Any = (
                    data if self.binary else data.decode("utf-8", "replace")
                )
                events.add(
                    ref_scalar("__fsbin__", fp),
                    coerce_row(
                        self._row(fp, payload, st.st_mtime), self.schema
                    ),
                )
                seen[fp] = sig
                changed = True
            for fp in list(seen):
                if fp not in current:
                    del seen[fp]
                    events.remove(
                        ref_scalar("__fsbin__", fp),
                        coerce_row(
                            self._row(fp, b"" if self.binary else ""),
                            self.schema,
                        ),
                    )
                    changed = True
            if changed:
                events.commit()
            if self.mode == "static":
                return
            deadline = _time.monotonic() + self.poll_interval
            while _time.monotonic() < deadline:
                if events.stopped:
                    return
                _time.sleep(min(0.05, self.poll_interval))


def read(
    path: str | os.PathLike,
    *,
    format: str = "plaintext",
    schema: sch.SchemaMetaclass | None = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str = "fs",
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    if format in ("binary", "plaintext_by_file"):
        # whole-file rows (reference binary/plaintext_by_file object
        # pattern): the natural source for DocumentStore pipelines
        binary = format == "binary"
        if schema is None:
            cols: dict[str, Any] = {"data": bytes if binary else str}
            if with_metadata:
                cols["_metadata"] = dict
            schema = sch.schema_from_types(**cols)
        wsrc = _WholeFileSource(
            str(path), schema, binary=binary, mode=mode,
            with_metadata=with_metadata,
            poll_interval=kwargs.get("poll_interval", 0.2),
        )
        return input_table(
            wsrc, schema, name=name, persistent_id=persistent_id,
            upsert=True,
        )
    if format == "plaintext":
        if schema is None:
            schema = sch.schema_from_types(data=str)

        def parse_plain(line: str) -> dict | None:
            line = line.rstrip("\n")
            return {"data": line} if line else None

        src = _FilesSource(
            str(path), schema, parse_line=parse_plain, mode=mode,
            with_metadata=with_metadata, tag=f"fs:{path}",
        )
        return input_table(
            src, schema, name=name, persistent_id=persistent_id
        )
    if format == "json" or format == "jsonlines":
        from pathway_tpu_torch.io import jsonlines

        return jsonlines.read(
            path, schema=schema, mode=mode, name=name,
            with_metadata=with_metadata, **kwargs
        )
    if format == "csv":
        from pathway_tpu_torch.io import csv as csv_io

        return csv_io.read(
            path, schema=schema, mode=mode, name=name,
            csv_settings=csv_settings, with_metadata=with_metadata, **kwargs
        )
    raise ValueError(f"unsupported fs format {format!r}")


class _PlainWriter(LazyFileWriter):
    def write(self, row: dict[str, Any], time: int, diff: int) -> None:
        vals = {k: fmt_value(v) for k, v in row.items() if k != "id"}
        import json

        vals["time"] = time
        vals["diff"] = diff
        self._file().write(json.dumps(vals) + "\n")



def write(table: Table, filename: str | os.PathLike, format: str = "json", **kwargs: Any) -> None:
    if format in ("json", "jsonlines"):
        from pathway_tpu_torch.io import jsonlines

        jsonlines.write(table, filename)
        return
    if format == "csv":
        from pathway_tpu_torch.io import csv as csv_io

        csv_io.write(table, filename)
        return
    attach_writer(table, _PlainWriter(str(filename)))
