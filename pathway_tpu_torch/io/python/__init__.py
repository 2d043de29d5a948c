"""``pw.io.python`` — custom Python connectors.

Capability parity with reference ``python/pathway/io/python/__init__.py``
(``ConnectorSubject`` ``:49-308``): subclass :class:`ConnectorSubject`,
override ``run()``, push rows with ``next``/``next_json``/``next_str``/
``next_bytes``, delete with ``_remove``, cut epochs with ``commit()``.
"""

from __future__ import annotations

import json as _json
import threading
from typing import Any

from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import RowSource, coerce_row, input_table, key_for_row

__all__ = ["ConnectorSubject", "read"]


class ConnectorSubject:
    """Base class for custom streaming sources."""

    def __init__(self, datasource_name: str = "python") -> None:
        self._events: Any = None
        self._schema: sch.SchemaMetaclass | None = None
        self._seq = 0
        self._name = datasource_name
        self._deletions_enabled = True

    # -- user API -----------------------------------------------------------
    def run(self) -> None:  # pragma: no cover
        raise NotImplementedError

    def next(self, **kwargs: Any) -> None:
        self._add_values(kwargs)

    def next_json(self, message: dict | str | bytes) -> None:
        if isinstance(message, (str, bytes)):
            message = _json.loads(message)
        self._add_values(dict(message))

    def next_str(self, message: str) -> None:
        self._add_values({"data": message})

    def next_bytes(self, message: bytes) -> None:
        self._add_values({"data": message})

    def commit(self) -> None:
        if self._events is not None:
            self._events.commit()

    def close(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    @property
    def stopped(self) -> bool:
        """True once the scheduler is shutting down; long-running ``run()``
        loops should poll this and return."""
        return self._events is not None and self._events.stopped

    # -- plumbing -----------------------------------------------------------
    def _add_values(self, values: dict[str, Any]) -> None:
        assert self._schema is not None and self._events is not None
        key = self._key_of(values)
        self._events.add(key, coerce_row(values, self._schema))

    def _remove(self, values: dict[str, Any]) -> None:
        assert self._schema is not None and self._events is not None
        key = self._key_of(values)
        self._events.remove(key, coerce_row(values, self._schema))

    def _key_of(self, values: dict[str, Any]) -> K.Pointer:
        pk = self._schema.primary_key_columns()  # type: ignore[union-attr]
        if pk:
            return K.ref_scalar(*[values[c] for c in pk])
        self._seq += 1
        return K.ref_scalar("__py_connector__", id(self), self._seq)


class _SubjectAdapter(RowSource):
    def __init__(self, subject: ConnectorSubject, schema: sch.SchemaMetaclass):
        self.subject = subject
        self.schema = schema
        # forward the wrapped subject's replay contract: supervised
        # restart and persistence resume inspect ``node.subject``, which
        # is this adapter, not the user's ConnectorSubject
        self.deterministic_replay = bool(
            getattr(subject, "deterministic_replay", False)
        )
        # distribution facts: a python connector runs ONE reader thread,
        # so it is single-owner and order-preserving unless the wrapped
        # subject declares otherwise (analysis/distribution.py, PW-X001)
        self.partitioning = getattr(subject, "partitioning", "single")
        self.order_preserving = bool(getattr(subject, "order_preserving", True))
        hook = getattr(subject, "on_persistence_resume", None)
        if hook is not None:
            self.on_persistence_resume = hook

    def run(self, events: Any) -> None:
        self.subject._events = events
        self.subject._schema = self.schema
        try:
            self.subject.run()
        finally:
            self.subject.on_stop()
            self.subject.close()


def read(
    subject: ConnectorSubject,
    *,
    schema: sch.SchemaMetaclass,
    autocommit_duration_ms: int | None = None,
    name: str = "python",
    persistent_id: str | None = None,
    recovery_policy: Any = None,
    on_overflow: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a stream produced by a :class:`ConnectorSubject`.

    ``recovery_policy`` (a
    :class:`~pathway_tpu_torch.internals.resilience.ConnectorRecoveryPolicy`)
    opts the source into supervised restart with backoff; without one a
    reader failure closes the stream after a single attempt.
    ``on_overflow`` picks this source's full-ingest-buffer behaviour
    (``"pause"``/``"shed_oldest"``/``"fail"``)."""
    adapter = _SubjectAdapter(subject, schema)
    upsert = bool(schema.primary_key_columns())
    return input_table(
        adapter,
        schema,
        name=name,
        upsert=upsert,
        persistent_id=persistent_id,
        recovery_policy=recovery_policy,
        on_overflow=on_overflow,
    )
