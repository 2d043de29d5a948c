"""``pw.run`` — execute the constructed dataflow.

Reference: ``python/pathway/internals/run.py`` + ``GraphRunner``
(``internals/graph_runner/__init__.py:36-252``).  In ``pathway_tpu`` it
runs the epoch scheduler over the global graph with the connectors, the
licence check, telemetry, the monitoring server and persistence around
it (``pathway_tpu/internals/run.py``).  Those belong to the port's last
host-plane slice (ROADMAP item 16), so :func:`run` and :func:`run_all`
raise :class:`NotImplementedError` until it lands rather than run with
their hooks skipped; ``pw.debug`` (``compute_and_print``,
``table_to_dicts``, ...) runs the scheduler directly.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.parse_graph import G


class MonitoringLevel:
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"
    AUTO = "auto"


_MISSING = (
    "pw.run() needs the connectors, the licence check, telemetry, the monitoring "
    "server and persistence, which pathway_tpu_torch ports in ROADMAP item 16; "
    "drive a pipeline through pw.debug (compute_and_print, table_to_dicts) until then"
)


def run(
    *,
    monitoring_level: Any = MonitoringLevel.AUTO,
    with_http_server: bool = False,
    autocommit_duration_ms: int | None = 50,
    persistence_config: Any = None,
    runtime_typechecking: bool | None = None,
    strict: bool | None = None,
    optimize: int | None = None,
    **kwargs: Any,
):
    """Run the whole computation graph: not yet in the port (ROADMAP item
    16); raises :class:`NotImplementedError`."""
    raise NotImplementedError(_MISSING)


def run_all(**kwargs: Any):
    raise NotImplementedError(_MISSING)


def attach_prober(callback: Any) -> None:
    """Register a per-epoch stats callback (reference ``attach_prober`` /
    ``probe_table``, ``src/engine/graph.rs:988-995``): invoked by EVERY
    worker after each of its epochs with ``{"time", "worker",
    "operators", "connectors"}`` — per-worker partition stats like the
    reference's ProberStats; aggregate over ``worker`` for a fleet view."""
    G.engine_graph.probers.append(callback)
