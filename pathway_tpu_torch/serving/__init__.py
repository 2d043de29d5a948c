"""``pathway_tpu_torch.serving`` — multi-tenant RAG serving layer.

Admission control (:mod:`~pathway_tpu_torch.serving.admission`), SLO-class
scheduling (:mod:`~pathway_tpu_torch.serving.scheduler`), stage co-scheduling
with lookahead retrieval (:mod:`~pathway_tpu_torch.serving.coscheduler`), the
composed live-RAG graph (:mod:`~pathway_tpu_torch.serving.graph`), and a
seedable traffic generator (:mod:`~pathway_tpu_torch.serving.loadgen`).

This module is import-light on purpose: the monitoring endpoint calls
:func:`serving_snapshot` on every ``/metrics`` scrape, and the heavy
graph/loadgen modules (which pull in the engine) load lazily.

The module-level registry tracks live serving components (weakly — a
closed app's entries vanish with it) so process-wide monitoring can
aggregate admission counters, scheduler lane stats, and per-tenant-class
latency without holding references that keep dead apps alive.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any

from .admission import AdmissionController, AdmissionTicket, TenantPolicy

__all__ = [
    "AdmissionController",
    "AdmissionTicket",
    "TenantPolicy",
    "SloScheduler",
    "StageCoScheduler",
    "RagServingApp",
    "HashingEmbedder",
    "LoadGen",
    "TenantLoad",
    "PartitionedIndex",
    "ShardOwner",
    "ShardHealthTracker",
    "ShardFailoverSupervisor",
    "serving_probe",
    "serving_snapshot",
]

_registry_lock = threading.Lock()
_admissions: "weakref.WeakSet[Any]" = weakref.WeakSet()
_schedulers: "weakref.WeakSet[Any]" = weakref.WeakSet()
_coschedulers: "weakref.WeakSet[Any]" = weakref.WeakSet()
_shard_sets: "weakref.WeakSet[Any]" = weakref.WeakSet()
_probe: Any = None


def _register_admission(obj: Any) -> None:
    with _registry_lock:
        _admissions.add(obj)


def _register_scheduler(obj: Any) -> None:
    with _registry_lock:
        _schedulers.add(obj)


def _register_coscheduler(obj: Any) -> None:
    with _registry_lock:
        _coschedulers.add(obj)


def _register_shard_set(obj: Any) -> None:
    with _registry_lock:
        _shard_sets.add(obj)


def serving_probe() -> Any:
    """The process-wide per-tenant-class latency probe (lazy singleton)."""
    global _probe
    with _registry_lock:
        if _probe is None:
            from pathway_tpu_torch.internals.monitoring import LabeledLatencyProbe

            _probe = LabeledLatencyProbe()
        return _probe


def push_pressure(source: str, level: float) -> None:
    """Propagate an engine pressure signal (0..1) to every live
    :class:`~pathway_tpu_torch.serving.admission.AdmissionController` — the
    brownout actuator.  Called by the scheduler's epoch loop; safe with
    no controllers live (no-op)."""
    with _registry_lock:
        admissions = list(_admissions)
        schedulers = list(_schedulers)
    for a in admissions:
        try:
            a.set_pressure(source, level)
        except Exception:
            pass  # one controller's failure must not starve the rest
    for s in schedulers:
        try:
            s.set_pressure(level)
        except Exception:
            pass


def serving_snapshot() -> dict[str, Any]:
    """Aggregate snapshot across every live serving component: admission
    counters per tenant class, scheduler lane/class stats, co-scheduler
    overlap counters, and the per-(stage, tenant_class) latency
    histograms.  Empty sections mean no component of that kind is live."""
    with _registry_lock:
        admissions = list(_admissions)
        schedulers = list(_schedulers)
        coschedulers = list(_coschedulers)
        shard_sets = list(_shard_sets)
        probe = _probe
    admitted: dict[str, int] = {}
    shed: dict[str, int] = {}
    inflight: dict[str, int] = {}
    brownout_shed: dict[str, int] = {}
    pressure_level = 0.0
    for a in admissions:
        s = a.stats()
        for cls, n in s.get("admitted_total", {}).items():
            admitted[cls] = admitted.get(cls, 0) + n
        for cls, n in s.get("shed_total", {}).items():
            shed[cls] = shed.get(cls, 0) + n
        for cls, n in s.get("inflight", {}).items():
            inflight[cls] = inflight.get(cls, 0) + n
        pr = s.get("pressure", {})
        pressure_level = max(pressure_level, pr.get("level", 0.0))
        for cls, n in pr.get("brownout_shed_total", {}).items():
            brownout_shed[cls] = brownout_shed.get(cls, 0) + n
    out: dict[str, Any] = {}
    if admissions:
        out["admission"] = {
            "admitted_total": admitted,
            "shed_total": shed,
            "inflight": inflight,
            "pressure_level": pressure_level,
            "brownout_shed_total": brownout_shed,
        }
    if schedulers:
        out["schedulers"] = [s.stats() for s in schedulers]
    if coschedulers:
        out["coschedulers"] = [c.stats() for c in coschedulers]
    if shard_sets:
        # degraded-mode aggregate across every live partitioned index:
        # total/healthy shard counts, degraded responses, and the
        # failover-seconds histogram (summed counts, worst-case maxima)
        shards_total = shards_healthy = degraded = failovers = 0
        hists = []
        for p in shard_sets:
            s = p.stats()
            shards_total += s.get("shards_total", 0)
            shards_healthy += s.get("shards_healthy", 0)
            degraded += s.get("degraded_responses", 0)
            failovers += s.get("failovers_total", 0)
            h = s.get("failover_seconds")
            if h:
                hists.append(h)
        failover_s: dict[str, Any] = {}
        if hists:
            failover_s = {
                "count": sum(h.get("count", 0) for h in hists),
                "sum_ns": sum(h.get("sum_ns", 0) for h in hists),
                "max_ns": max(h.get("max_ns", 0) for h in hists),
                "p50_ns": max(h.get("p50_ns", 0) for h in hists),
                "p95_ns": max(h.get("p95_ns", 0) for h in hists),
                "p99_ns": max(h.get("p99_ns", 0) for h in hists),
            }
        out["failover"] = {
            "shards_total": shards_total,
            "shards_healthy": shards_healthy,
            "degraded_responses_total": degraded,
            "failovers_total": failovers,
            "failover_seconds": failover_s,
        }
    if probe is not None:
        lat = probe.snapshot()
        if lat:
            out["latency"] = lat
    return out


def __getattr__(name: str) -> Any:
    if name == "SloScheduler":
        from .scheduler import SloScheduler

        return SloScheduler
    if name in ("StageCoScheduler", "extractive_answerer"):
        from . import coscheduler as _m

        return getattr(_m, name)
    if name in ("RagServingApp", "HashingEmbedder", "simple_splitter"):
        from . import graph as _m

        return getattr(_m, name)
    if name in ("LoadGen", "TenantLoad", "percentile"):
        from . import loadgen as _m

        return getattr(_m, name)
    if name in (
        "PartitionedIndex",
        "ShardOwner",
        "ShardHealthTracker",
        "ShardFailoverSupervisor",
    ):
        from . import failover as _m

        return getattr(_m, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
