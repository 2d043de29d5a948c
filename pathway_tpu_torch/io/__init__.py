"""``pw.io`` — connector modules (reference export list
``python/pathway/io/__init__.py:3-65``; counterpart of
``pathway_tpu/io``).

The port has the file connectors (fs, csv, jsonlines, plaintext), the
Python connector, the REST connector (http, on the standard library's
asyncio server) and subscribe.  The other connectors of the JAX package
(kafka, postgres, s3, sqlite, null, ...) come with ROADMAP item 16; until
then their names raise an ``AttributeError`` that says so.
"""

from __future__ import annotations

import importlib
from typing import Any

from pathway_tpu_torch.io._subscribe import OnChangeCallback, OnFinishCallback, subscribe

#: connector submodules of the port
_SUBMODULES = ["csv", "fs", "http", "jsonlines", "plaintext", "python"]

#: connector submodules of ``pathway_tpu.io`` that a later slice brings
_LATER = [
    "airbyte",
    "bigquery",
    "debezium",
    "deltalake",
    "elasticsearch",
    "gdrive",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "redpanda",
    "s3",
    "s3_csv",
    "slack",
    "sqlite",
]


def __getattr__(name: str) -> Any:
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _LATER:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} yet: the port brings it with "
            "ROADMAP item 16 (slice 16e: the other connectors)"
        )
    raise AttributeError(f"module {__name__} has no attribute {name!r}")


__all__ = _SUBMODULES + ["subscribe", "OnChangeCallback", "OnFinishCallback"]
