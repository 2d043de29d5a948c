"""``pw.io.pyfilesystem`` — read files from any PyFilesystem source
(reference ``python/pathway/io/pyfilesystem``: one row per file, binary
``data`` column, optional ``_metadata``).

The FS object itself is the injection point (the reference signature
takes an ``fs.base.FS`` too); only the duck-typed subset is used —
``walk.files()`` (or ``listdir``), ``readbytes``/``open``, ``getinfo``
— so tests pass a plain fake and any `fs <https://pypi.org/project/fs/>`_
filesystem (zip/tar/s3/ftp/mem) works when the package is installed.

Upsert semantics: a file whose size/mtime changes re-emits under the
same path key, replacing the previous row; deleted files retract.

Counterpart of ``pathway_tpu/io/pyfilesystem``: the same host code over the port's engine.
"""

from __future__ import annotations

import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import RowSource, input_table

__all__ = ["read"]


def _iter_files(source: Any, path: str) -> list[str]:
    walk = getattr(source, "walk", None)
    if walk is not None and hasattr(walk, "files"):
        return sorted(walk.files(path=path or "/"))
    # minimal fallback: non-recursive listdir
    base = (path or "/").rstrip("/")
    return sorted(
        f"{base}/{name}" for name in source.listdir(path or "/")
    )


def _read_bytes(source: Any, path: str) -> bytes:
    rb = getattr(source, "readbytes", None)
    if rb is not None:
        return rb(path)
    with source.open(path, "rb") as f:
        return f.read()


def _version(source: Any, path: str) -> Any:
    getinfo = getattr(source, "getinfo", None)
    if getinfo is None:
        return None
    try:
        info = getinfo(path, namespaces=["details"])
    except TypeError:
        info = getinfo(path)
    size = getattr(info, "size", None)
    modified = getattr(info, "modified", None)
    return (size, str(modified))


class _PyFsSource(RowSource):
    deterministic_replay = True

    def __init__(
        self,
        source: Any,
        path: str,
        schema: sch.SchemaMetaclass,
        *,
        refresh_interval: float = 30,
        mode: str = "streaming",
        with_metadata: bool = False,
    ):
        self.source = source
        self.path = path
        self.schema = schema
        self.refresh_interval = refresh_interval
        self.mode = mode
        self.with_metadata = with_metadata

    def run(self, events: Any) -> None:
        seen: dict[str, Any] = {}
        while True:
            emitted = False
            current = set()
            for fp in _iter_files(self.source, self.path):
                current.add(fp)
                ver = _version(self.source, fp)
                if fp in seen and (ver is None or seen[fp] == ver):
                    # unchanged (or unversionable: emit once only) —
                    # decided BEFORE the download, so polls are free
                    continue
                data = _read_bytes(self.source, fp)
                row: tuple = (data,)
                if self.with_metadata:
                    row = (data, {"path": fp, "version": str(ver)})
                events.add(ref_scalar("__pyfs__", fp), row)
                seen[fp] = ver
                emitted = True
            for fp in list(seen):
                if fp not in current:
                    del seen[fp]
                    events.remove(ref_scalar("__pyfs__", fp), (b"",))
                    emitted = True
            if emitted:
                events.commit()
            if self.mode == "static":
                return
            if events.stopped:
                return
            _time.sleep(self.refresh_interval)


def read(
    source: Any,
    *,
    path: str = "",
    refresh_interval: float = 30,
    mode: str = "streaming",
    with_metadata: bool = False,
    name: str = "pyfilesystem",
    **kwargs: Any,
) -> Table:
    """One row per file under ``path`` of the PyFilesystem ``source``."""
    if with_metadata:
        schema = sch.schema_from_types(data=bytes, _metadata=dict)
    else:
        schema = sch.schema_from_types(data=bytes)
    src = _PyFsSource(
        source,
        path,
        schema,
        refresh_interval=refresh_interval,
        mode=mode,
        with_metadata=with_metadata,
    )
    return input_table(src, schema, name=name, upsert=True)
