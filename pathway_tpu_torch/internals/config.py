"""Runtime configuration from environment variables.

Reference: ``python/pathway/internals/config.py:10-144`` +
``src/engine/dataflow/config.rs:86-120`` (worker topology env).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


@dataclass
class PathwayConfig:
    ignore_asserts: bool = field(default_factory=lambda: _env_bool("PATHWAY_IGNORE_ASSERTS"))
    runtime_typechecking: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_RUNTIME_TYPECHECKING")
    )
    persistent_storage: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_PERSISTENT_STORAGE")
    )
    threads: int = field(default_factory=lambda: _env_int("PATHWAY_THREADS", 1))
    processes: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESSES", 1))
    process_id: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESS_ID", 0))
    first_port: int = field(default_factory=lambda: _env_int("PATHWAY_FIRST_PORT", 10000))
    monitoring_http_port: int | None = field(
        default_factory=lambda: (
            int(p) if (p := os.environ.get("PATHWAY_MONITORING_HTTP_PORT")) else None
        )
    )
    license_key: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_LICENSE_KEY")
    )
    persistence_config: Any = None

    @property
    def total_workers(self) -> int:
        return self.threads * self.processes

    def refresh(self) -> None:
        self.__init__()


pathway_config = PathwayConfig()


def set_license_key(key: str | None) -> None:
    pathway_config.license_key = key


def set_monitoring_config(*, server_endpoint: str | None = None, **kwargs: Any) -> None:
    pathway_config.monitoring_endpoint = server_endpoint  # type: ignore[attr-defined]
    # the endpoint also drives the OTLP span/metric exporter
    from pathway_tpu_torch.internals import telemetry

    telemetry.set_monitoring_config(server_endpoint=server_endpoint)
