"""``pw.io.null`` — sink that drops everything (reference NullWriter,
``src/connectors/data_storage.rs:1395``).

Counterpart of ``pathway_tpu/io/null``: the same host code over the port's engine.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import Writer, attach_writer

__all__ = ["write"]


class _NullWriter(Writer):
    def write(self, row: dict, time: int, diff: int) -> None:
        pass


def write(table: Table, **kwargs: Any) -> None:
    attach_writer(table, _NullWriter(), name="null")
