"""``pw.io.debezium`` — Debezium CDC streams (reference
``python/pathway/io/debezium``; parser ``DebeziumMessageParser``
``src/connectors/data_format.rs:1053``).

Consumes CDC envelopes from a Kafka topic (real ``kafka-python`` broker or
the in-process ``mock://`` broker) and maps them onto the engine's upsert
input session (reference ``SessionType::Upsert``):

- ``op`` in (``r`` read-snapshot, ``c`` create, ``u`` update): upsert
  ``payload.after`` under the primary-key columns;
- ``op`` = ``d`` (delete): remove by ``payload.before``'s key.

Both the flat Debezium JSON envelope and the ``schema``/``payload``
wrapped form are accepted; MongoDB's variant (after/patch as embedded
JSON strings) is unwrapped too.

Counterpart of ``pathway_tpu/io/debezium``: the same host code over the port's engine.
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import RowSource, coerce_row, input_table

__all__ = ["read", "DB_TYPE_POSTGRES", "DB_TYPE_MONGODB"]

DB_TYPE_POSTGRES = "postgres"
DB_TYPE_MONGODB = "mongodb"


def _unwrap(raw: bytes) -> dict | None:
    try:
        msg = _json.loads(raw.decode())
    except Exception:
        return None
    if not isinstance(msg, dict):
        return None
    payload = msg.get("payload", msg)
    return payload if isinstance(payload, dict) else None


def _row_from(payload_side: Any) -> dict | None:
    if isinstance(payload_side, str):  # MongoDB embeds JSON strings
        try:
            payload_side = _json.loads(payload_side)
        except Exception:
            return None
    return payload_side if isinstance(payload_side, dict) else None


class _DebeziumSource(RowSource):
    """Kafka-topic reader emitting upsert/delete events from CDC
    envelopes.  Keys come from the schema's primary-key columns."""

    deterministic_replay = False  # live CDC position; broker tracks offsets

    def __init__(
        self,
        rdkafka_settings: dict,
        topic: str,
        schema: sch.SchemaMetaclass,
        *,
        poll_timeout: float = 0.5,
    ):
        self.rdkafka_settings = rdkafka_settings
        self.topic = topic
        self.schema = schema
        self.poll_timeout = poll_timeout
        self._resume = 0

    def on_persistence_resume(self, n_events: int) -> None:
        self._resume = n_events

    def _key(self, values: dict) -> Any:
        pk = self.schema.primary_key_columns()
        cols = pk or list(self.schema.__columns__)
        return ref_scalar(*[values.get(c) for c in cols])

    def _consume_mock(self, events: Any, broker: Any) -> None:
        offset = 0
        emitted = 0
        while True:
            msgs = broker.consume_from(self.topic, offset, self.poll_timeout)
            for _k, raw in msgs:
                offset += 1
                if self._emit(events, raw):
                    emitted += 1
            if msgs:
                events.commit()
            if broker.is_closed(self.topic) and offset >= len(
                broker.topics[self.topic]
            ):
                return
            if events.stopped:
                return

    def _emit(self, events: Any, raw: bytes) -> bool:
        payload = _unwrap(raw)
        if payload is None:
            return False
        op = payload.get("op")
        if op in ("r", "c", "u"):
            row = _row_from(payload.get("after"))
            if row is None:
                return False
            if self._resume > 0:
                self._resume -= 1
                return False
            events.add(self._key(row), coerce_row(row, self.schema))
            return True
        if op == "d":
            row = _row_from(payload.get("before"))
            if row is None:
                return False
            if self._resume > 0:
                self._resume -= 1
                return False
            events.remove(self._key(row), coerce_row(row, self.schema))
            return True
        return False

    def run(self, events: Any) -> None:
        servers = str(self.rdkafka_settings.get("bootstrap.servers", ""))
        if servers.startswith("mock://"):
            from pathway_tpu_torch.io.kafka import MockBroker

            self._consume_mock(events, MockBroker.get(servers))
            return
        from kafka import KafkaConsumer  # type: ignore[import-not-found]

        group_id = self.rdkafka_settings.get("group.id")
        if group_id:
            # committed group offsets: the broker resumes PAST consumed
            # history, so nothing is redelivered — an armed resume skip
            # would silently drop the first N FRESH CDC events.  The skip
            # only applies to transports that actually replay from the
            # start (mock broker, or no consumer group below).
            self._resume = 0
        consumer = KafkaConsumer(
            self.topic,
            bootstrap_servers=servers,
            group_id=group_id,
            auto_offset_reset=self.rdkafka_settings.get(
                "auto.offset.reset", "earliest"
            ),
        )
        try:
            emitted = False
            while not events.stopped:
                polled = consumer.poll(timeout_ms=int(self.poll_timeout * 1000))
                for records in polled.values():
                    for record in records:
                        if self._emit(events, record.value):
                            emitted = True
                if emitted:
                    events.commit()
                    emitted = False
        finally:
            consumer.close()


def read(
    rdkafka_settings: dict,
    topic_name: str,
    *,
    schema: sch.SchemaMetaclass,
    db_type: str = DB_TYPE_POSTGRES,
    autocommit_duration_ms: int | None = 1500,
    name: str = "debezium",
    **kwargs: Any,
) -> Table:
    """CDC table mirroring the upstream database (upsert semantics)."""
    src = _DebeziumSource(rdkafka_settings, topic_name, schema)
    return input_table(src, schema, name=name, upsert=True)
