"""``pw.io`` — connector modules (reference export list
``python/pathway/io/__init__.py:3-65``; counterpart of
``pathway_tpu/io``).

The port has the file connectors (fs, csv, jsonlines, plaintext), the
Python connector, the REST connector (http, on the standard library's
asyncio server), subscribe, and (slice 16f) null, sqlite, pyfilesystem,
the object stores (s3, s3_csv, minio), the Kafka family (kafka,
redpanda, debezium) and postgres.  A connector whose client library is
absent raises ``MissingDependency`` when it is called (``io/_gated.py``);
the Kafka family also runs over the in-process ``MockBroker``.  The
other connectors of the JAX package (nats, deltalake, airbyte, ...) come
with ROADMAP slice 16g; until then their names raise an
``AttributeError`` that says so.
"""

from __future__ import annotations

import importlib
from typing import Any

from pathway_tpu_torch.io._subscribe import OnChangeCallback, OnFinishCallback, subscribe

#: connector submodules of the port
_SUBMODULES = [
    "csv",
    "debezium",
    "fs",
    "http",
    "jsonlines",
    "kafka",
    "minio",
    "null",
    "plaintext",
    "postgres",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "sqlite",
]

#: connector submodules of ``pathway_tpu.io`` that a later slice brings
_LATER = [
    "airbyte",
    "bigquery",
    "deltalake",
    "elasticsearch",
    "gdrive",
    "logstash",
    "mongodb",
    "nats",
    "pubsub",
    "slack",
]


def __getattr__(name: str) -> Any:
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _LATER:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} yet: the port brings it with "
            "ROADMAP item 16 (slice 16g: the last connectors)"
        )
    raise AttributeError(f"module {__name__} has no attribute {name!r}")


__all__ = _SUBMODULES + ["subscribe", "OnChangeCallback", "OnFinishCallback"]
