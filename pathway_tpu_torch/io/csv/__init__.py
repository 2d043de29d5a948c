"""``pw.io.csv`` — CSV connector (reference ``python/pathway/io/csv``;
engine DSV parser ``src/connectors/data_format.rs:500``)."""

from __future__ import annotations

import csv as _csv
import io as _io
import os
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import (
    LazyFileWriter,
    attach_writer,
    fmt_value,
    input_table,
)
from pathway_tpu_torch.io.fs import _FilesSource

__all__ = ["read", "write", "CsvParserSettings"]


class CsvParserSettings:
    def __init__(
        self,
        delimiter: str = ",",
        quote: str = '"',
        escape: str | None = None,
        enable_double_quote_escapes: bool = True,
        enable_quoting: bool = True,
        comment_character: str | None = None,
    ):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.enable_double_quote_escapes = enable_double_quote_escapes
        self.enable_quoting = enable_quoting
        self.comment_character = comment_character

    def reader_kwargs(self) -> dict[str, Any]:
        return {
            "delimiter": self.delimiter,
            "quotechar": self.quote,
            "escapechar": self.escape,
            "doublequote": self.enable_double_quote_escapes,
            "quoting": _csv.QUOTE_MINIMAL if self.enable_quoting else _csv.QUOTE_NONE,
        }


def read(
    path: str | os.PathLike,
    *,
    schema: sch.SchemaMetaclass | None = None,
    csv_settings: CsvParserSettings | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str = "csv",
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    settings = csv_settings or CsvParserSettings()
    if schema is None:
        raise ValueError("pw.io.csv.read requires schema=")

    def parser_factory(fp: str):
        # header state is per file — each file starts with its own header row
        state: dict[str, list[str] | None] = {"header": None}

        def parse_line(line: str) -> dict | None:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                return None
            if settings.comment_character and line.startswith(settings.comment_character):
                return None
            row = next(_csv.reader(_io.StringIO(line), **settings.reader_kwargs()))
            if state["header"] is None:
                state["header"] = row
                return None
            return dict(zip(state["header"], row))

        return parse_line

    src = _FilesSource(
        str(path),
        schema,
        parser_factory=parser_factory,
        mode=mode,
        with_metadata=with_metadata,
        tag=f"csv:{path}",
    )
    return input_table(src, schema, name=name, persistent_id=persistent_id)


class _CsvWriter(LazyFileWriter):
    _open_newline = ""

    def __init__(self, path: str):
        super().__init__(path)
        self._writer: Any = None

    def write(self, row: dict[str, Any], time: int, diff: int) -> None:
        out = {k: fmt_value(v) for k, v in row.items() if k != "id"}
        out["time"] = time
        out["diff"] = diff
        if self._writer is None:
            self._writer = _csv.DictWriter(self._file(), fieldnames=list(out.keys()))
            self._writer.writeheader()
        self._writer.writerow(out)



def write(table: Table, filename: str | os.PathLike, **kwargs: Any) -> None:
    attach_writer(table, _CsvWriter(str(filename)))
