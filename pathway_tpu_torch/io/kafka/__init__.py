"""``pw.io.kafka`` — Kafka connector (reference ``python/pathway/io/kafka``;
engine reader ``src/connectors/data_storage.rs:692``, writer ``:1258``).

Two transports:

- a real broker via the ``kafka-python`` client when installed;
- an in-process :class:`MockBroker` (``bootstrap.servers: "mock://..."``),
  used by tests and benchmarks in environments without services — same
  partitioned, offset-ordered semantics on the framework side.

Counterpart of ``pathway_tpu/io/kafka``: the same host code over the port's engine.
"""

from __future__ import annotations

import json as _json
import threading
import time as _time
from collections import defaultdict
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import (
    RowSource,
    Writer,
    attach_writer,
    coerce_row,
    fmt_value,
    input_table,
    key_for_row,
)

__all__ = ["read", "write", "simple_read", "MockBroker"]


class MockBroker:
    """In-process topic store with Kafka-ish semantics (append-only
    partitioned logs, consumer offsets)."""

    _instances: dict[str, "MockBroker"] = {}
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.topics: dict[str, list[tuple[bytes | None, bytes]]] = defaultdict(list)
        self.closed_topics: set[str] = set()
        self.cond = threading.Condition()

    @classmethod
    def get(cls, url: str) -> "MockBroker":
        with cls._lock:
            if url not in cls._instances:
                cls._instances[url] = cls()
            return cls._instances[url]

    def produce(self, topic: str, value: bytes, key: bytes | None = None) -> None:
        with self.cond:
            self.topics[topic].append((key, value))
            self.cond.notify_all()

    def close_topic(self, topic: str) -> None:
        with self.cond:
            self.closed_topics.add(topic)
            self.cond.notify_all()

    def consume_from(self, topic: str, offset: int, timeout: float = 0.5) -> list[tuple[bytes | None, bytes]]:
        with self.cond:
            if len(self.topics[topic]) <= offset and topic not in self.closed_topics:
                self.cond.wait(timeout)
            return self.topics[topic][offset:]

    def is_closed(self, topic: str) -> bool:
        with self.cond:
            return topic in self.closed_topics


def _parse_message(
    raw: bytes,
    format: str,
    schema: sch.SchemaMetaclass | None,
    dsv_separator: str = ";",
) -> dict[str, Any] | None:
    if format == "raw":
        return {"data": raw.decode(errors="replace")}
    if format == "json":
        try:
            obj = _json.loads(raw)
        except _json.JSONDecodeError:
            return None
        return obj if isinstance(obj, dict) else None
    if format == "dsv":
        # separator-delimited values in schema column order (reference DSV
        # parser, src/connectors/data_format.rs:500)
        if schema is None:
            return None
        parts = raw.decode(errors="replace").rstrip("\n").split(dsv_separator)
        cols = schema.column_names()
        if len(parts) < len(cols):
            return None
        return dict(zip(cols, parts))
    raise ValueError(f"unsupported kafka format {format!r}")


class _MockKafkaSource(RowSource):
    def __init__(
        self,
        broker: MockBroker,
        topic: str,
        schema: sch.SchemaMetaclass,
        format: str,
        mode: str,
        commit_every: int = 256,
    ):
        self.broker = broker
        self.topic = topic
        self.schema = schema
        self.format = format
        self.mode = mode
        self.commit_every = commit_every

    def run(self, events: Any) -> None:
        pk = self.schema.primary_key_columns()
        offset = 0
        seq = 0
        while not events.stopped:
            msgs = self.broker.consume_from(self.topic, offset)
            for _key, raw in msgs:
                values = _parse_message(raw, self.format, self.schema)
                offset += 1
                if values is None:
                    continue
                seq += 1
                key = key_for_row(values, pk, seq=seq, source_tag=f"kafka:{self.topic}")
                events.add(key, coerce_row(values, self.schema))
                if seq % self.commit_every == 0:
                    events.commit()
            events.commit()
            if self.broker.is_closed(self.topic) and offset >= len(self.broker.topics[self.topic]):
                return
            if self.mode == "static" and not msgs:
                return


class _KafkaClientSource(RowSource):
    def __init__(self, settings: dict, topic: str, schema: sch.SchemaMetaclass, format: str):
        self.settings = settings
        self.topic = topic
        self.schema = schema
        self.format = format

    def run(self, events: Any) -> None:
        from kafka import KafkaConsumer  # type: ignore[import-not-found]

        consumer = KafkaConsumer(
            self.topic,
            bootstrap_servers=self.settings.get("bootstrap.servers"),
            group_id=self.settings.get("group.id"),
            auto_offset_reset=self.settings.get("auto.offset.reset", "earliest"),
        )
        pk = self.schema.primary_key_columns()
        seq = 0
        try:
            # poll with a timeout (instead of blocking iteration) so scheduler
            # shutdown is observed between batches
            while not events.stopped:
                batches = consumer.poll(timeout_ms=500)
                for msgs in batches.values():
                    for msg in msgs:
                        values = _parse_message(msg.value, self.format, self.schema)
                        if values is None:
                            continue
                        seq += 1
                        key = key_for_row(
                            values, pk, seq=seq, source_tag=f"kafka:{self.topic}"
                        )
                        events.add(key, coerce_row(values, self.schema))
                if batches:
                    events.commit()
        finally:
            consumer.close()


def read(
    rdkafka_settings: dict,
    topic: str | None = None,
    *,
    schema: sch.SchemaMetaclass | None = None,
    format: str = "raw",
    autocommit_duration_ms: int | None = 1500,
    mode: str = "streaming",
    name: str = "kafka",
    **kwargs: Any,
) -> Table:
    if schema is None:
        schema = sch.schema_from_types(data=str)
    assert topic is not None, "topic= is required"
    servers = rdkafka_settings.get("bootstrap.servers", "")
    upsert = bool(schema.primary_key_columns())
    if servers.startswith("mock://"):
        source: RowSource = _MockKafkaSource(
            MockBroker.get(servers), topic, schema, format, mode
        )
    else:
        from pathway_tpu_torch.io._gated import require

        require("kafka")
        source = _KafkaClientSource(rdkafka_settings, topic, schema, format)
    return input_table(source, schema, name=name, upsert=upsert)


simple_read = read


class _MockKafkaWriter(Writer):
    def __init__(self, broker: MockBroker, topic: str, format: str):
        self.broker = broker
        self.topic = topic
        self.format = format

    def write(self, row: dict, time: int, diff: int) -> None:
        out = {k: fmt_value(v) for k, v in row.items() if k != "id"}
        out["time"] = time
        out["diff"] = diff
        self.broker.produce(self.topic, _json.dumps(out).encode())


def write(
    table: Table,
    rdkafka_settings: dict,
    topic_name: str,
    *,
    format: str = "json",
    **kwargs: Any,
) -> None:
    servers = rdkafka_settings.get("bootstrap.servers", "")
    if servers.startswith("mock://"):
        attach_writer(
            table, _MockKafkaWriter(MockBroker.get(servers), topic_name, format), name="kafka_out"
        )
        return
    from pathway_tpu_torch.io._gated import require

    require("kafka")

    class _ClientWriter(Writer):
        def __init__(self) -> None:
            from kafka import KafkaProducer  # type: ignore[import-not-found]

            self.producer = KafkaProducer(
                bootstrap_servers=rdkafka_settings.get("bootstrap.servers")
            )

        def write(self, row: dict, time: int, diff: int) -> None:
            out = {k: fmt_value(v) for k, v in row.items() if k != "id"}
            out["time"] = time
            out["diff"] = diff
            self.producer.send(topic_name, _json.dumps(out).encode())

        def flush(self) -> None:
            self.producer.flush()

    attach_writer(table, _ClientWriter(), name="kafka_out")
