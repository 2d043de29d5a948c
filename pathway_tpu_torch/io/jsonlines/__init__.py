"""``pw.io.jsonlines`` — JSON Lines file connector (reference
``python/pathway/io/jsonlines``; engine parser ``JsonLinesParser``
``src/connectors/data_format.rs:1439``)."""

from __future__ import annotations

import json
import os
from typing import Any

from pathway_tpu_torch.internals import native as _native
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import (
    LazyFileWriter,
    attach_writer,
    fmt_value,
    input_table,
)
from pathway_tpu_torch.io.fs import _FilesSource, _list_files

__all__ = ["read", "write"]


def read(
    path: str | os.PathLike,
    *,
    schema: sch.SchemaMetaclass | None = None,
    mode: str = "streaming",
    json_field_paths: dict[str, str] | None = None,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str = "jsonlines",
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    if schema is None:
        schema = sch.schema_from_types(data=dict)

    def parse_line(line: str) -> dict[str, Any] | None:
        line = line.strip()
        if not line:
            return None
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            return None
        if not isinstance(obj, dict):
            return None  # valid JSON but not an object: skip
        if json_field_paths:
            for col, jpath in json_field_paths.items():
                cur: Any = obj
                for part in jpath.strip("/").split("/"):
                    if isinstance(cur, dict):
                        cur = cur.get(part)
                    else:
                        cur = None
                        break
                obj[col] = cur
        return obj

    def parse_block(data: bytes) -> list[dict] | None:
        """Block fast path: join a block of complete JSONL lines into ONE
        JSON array and parse it with a single C-level ``json.loads``
        (~7x the per-line loop; JSONL guarantees raw newlines only appear
        as separators — inside strings they are escaped).  Any malformed
        line fails the whole-block parse, falling back to the per-line
        parser which skips bad rows individually."""
        if json_field_paths:
            return None
        # plain `if ln` instead of `if ln.strip()`: a per-line strip costs
        # ~10% of the whole parse; whitespace-only lines are rare enough
        # that letting them fail the block parse (-> per-line fallback)
        # is the better trade
        lines = [ln for ln in data.split(b"\n") if ln]
        if not lines:
            return []
        try:
            rows = json.loads(b"[" + b",".join(lines) + b"]")
        except ValueError:
            # JSONDecodeError AND UnicodeDecodeError (invalid UTF-8 bytes)
            # are both ValueError; the per-line fallback skips bad rows
            # individually with errors="replace"
            return None
        native = _native.load()
        if native is not None:
            if not native.all_dicts(rows):
                return None  # non-object lines: per-line path skips them
        elif not all(isinstance(r, dict) for r in rows):
            return None
        return rows

    # columnar frame parsing is sound only for flat objects mapped
    # one-to-one onto the schema — json_field_paths rewrites rows in
    # Python, so it stays on the row path
    frame_plan = None
    if not json_field_paths:
        from pathway_tpu_torch.io._connector import _schema_plans

        frame_plan = _schema_plans(schema)[1]

    source = _FilesSource(
        str(path), schema, parse_line=parse_line, parse_block=parse_block,
        frame_plan=frame_plan, mode=mode,
        with_metadata=with_metadata, tag=f"jsonlines:{path}",
    )
    return input_table(source, schema, name=name, persistent_id=persistent_id)


class _JsonLinesWriter(LazyFileWriter):
    def write(self, row: dict[str, Any], time: int, diff: int) -> None:
        out = {k: fmt_value(v) for k, v in row.items() if k != "id"}
        out["time"] = time
        out["diff"] = diff
        self._file().write(json.dumps(out) + "\n")



def write(table: Table, filename: str | os.PathLike, *, name: str = "jsonlines_out", **kwargs: Any) -> None:
    attach_writer(table, _JsonLinesWriter(str(filename)), name=name)
