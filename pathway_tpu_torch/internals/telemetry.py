"""Telemetry — spans + metrics with OTLP/HTTP export (reference
``src/engine/telemetry.rs:37-436``: OpenTelemetry traces and metrics
around the graph run, process mem/CPU gauges, batch latency).

No hard dependency on the opentelemetry SDK: spans/metrics are recorded
in-process (queryable, cheap) and, when an OTLP endpoint is configured
(``pw.set_monitoring_config(server_endpoint=...)`` or
``PATHWAY_MONITORING_SERVER``), exported as OTLP/HTTP JSON with plain
urllib.  Usage telemetry (the reference phones home with a license key)
is intentionally NOT implemented.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any

__all__ = ["Telemetry", "get_telemetry", "set_monitoring_config"]

_logger = logging.getLogger("pathway_tpu_torch.telemetry")


class Telemetry:
    """Per-process span/metric recorder with optional OTLP/HTTP export."""

    def __init__(self, endpoint: str | None = None, service_name: str = "pathway_tpu_torch"):
        self.endpoint = endpoint
        self.service_name = service_name
        self.run_id = str(uuid.uuid4())
        self.spans: list[dict] = []
        self.gauges: dict[str, float] = {}
        #: monotonic counters (connector restarts, breaker trips, DLQ
        #: events — the resilience subsystem's telemetry surface)
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    # -- spans ----------------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs: Any):
        """Record a span around a block (reference spans
        ``graph_runner.run`` / ``graph_runner.build``)."""
        t0 = time.time()
        try:
            yield
        finally:
            rec = {
                "name": name,
                "start_s": t0,
                "duration_ms": (time.time() - t0) * 1000.0,
                "attributes": attrs,
            }
            with self._lock:
                self.spans.append(rec)
                del self.spans[:-500]  # bound memory
            self._export_span(rec)

    # -- metrics --------------------------------------------------------
    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def counter(self, name: str, inc: int = 1) -> int:
        """Increment (and return) a monotonic counter — exported with the
        gauges and surfaced in the monitoring snapshot."""
        with self._lock:
            v = self.counters.get(name, 0) + inc
            self.counters[name] = v
            return v

    def snapshot_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def record_process_metrics(self) -> None:
        """Process memory/CPU gauges (reference telemetry.rs:316-395)."""
        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            self.gauge("process.memory.rss_kb", ru.ru_maxrss)
            self.gauge("process.cpu.user_s", ru.ru_utime)
            self.gauge("process.cpu.system_s", ru.ru_stime)
        except Exception:  # noqa: BLE001 — platform without resource
            pass

    # -- export ---------------------------------------------------------
    def _export_span(self, rec: dict) -> None:
        if not self.endpoint:
            return
        now_ns = int(rec["start_s"] * 1e9)
        payload = {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            _kv("service.name", self.service_name),
                            _kv("run.id", self.run_id),
                            _kv("license.tier", _license_tier()),
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "pathway_tpu_torch"},
                            "spans": [
                                {
                                    "traceId": uuid.uuid4().hex,
                                    "spanId": uuid.uuid4().hex[:16],
                                    "name": rec["name"],
                                    "kind": 1,
                                    "startTimeUnixNano": str(now_ns),
                                    "endTimeUnixNano": str(
                                        now_ns + int(rec["duration_ms"] * 1e6)
                                    ),
                                    "attributes": [
                                        _kv(k, v)
                                        for k, v in rec["attributes"].items()
                                    ],
                                }
                            ],
                        }
                    ],
                }
            ]
        }
        self._post("/v1/traces", payload)

    def export_metrics(self) -> None:
        if not self.endpoint or not (self.gauges or self.counters):
            return
        now_ns = str(int(time.time() * 1e9))
        with self._lock:
            gauges = dict(self.gauges)
            # counters ride the same gauge export (cumulative values)
            gauges.update(
                {name: float(v) for name, v in self.counters.items()}
            )
        payload = {
            "resourceMetrics": [
                {
                    "resource": {
                        "attributes": [
                            _kv("service.name", self.service_name),
                            _kv("run.id", self.run_id),
                            _kv("license.tier", _license_tier()),
                        ]
                    },
                    "scopeMetrics": [
                        {
                            "scope": {"name": "pathway_tpu_torch"},
                            "metrics": [
                                {
                                    "name": name,
                                    "gauge": {
                                        "dataPoints": [
                                            {
                                                "timeUnixNano": now_ns,
                                                "asDouble": value,
                                            }
                                        ]
                                    },
                                }
                                for name, value in gauges.items()
                            ],
                        }
                    ],
                }
            ]
        }
        self._post("/v1/metrics", payload)

    def _post(self, path: str, payload: dict) -> None:
        import urllib.request

        try:
            req = urllib.request.Request(
                self.endpoint.rstrip("/") + path,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            urllib.request.urlopen(req, timeout=5).read()
        except Exception as e:  # noqa: BLE001 — telemetry must never break runs
            _logger.debug("telemetry export failed: %r", e)


def _license_tier() -> str:
    """Resource attribute like the reference's license-aware telemetry
    (``src/engine/telemetry.rs:62-143`` run_id/license attrs)."""
    try:
        from pathway_tpu_torch.internals.license import get_license

        return get_license().tier
    except Exception:  # noqa: BLE001 — invalid license must not kill export
        return "unknown"


def _kv(key: str, value: Any) -> dict:
    if isinstance(value, bool):
        v: dict = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


_telemetry: Telemetry | None = None


def get_telemetry() -> Telemetry:
    global _telemetry
    if _telemetry is None:
        _telemetry = Telemetry(
            endpoint=os.environ.get("PATHWAY_MONITORING_SERVER") or None
        )
    return _telemetry


def set_monitoring_config(*, server_endpoint: str | None = None) -> None:
    """reference ``pw.set_monitoring_config``: OTLP/HTTP endpoint for
    spans + metrics export."""
    global _telemetry
    _telemetry = Telemetry(endpoint=server_endpoint)
