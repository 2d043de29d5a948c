"""Monitoring dashboard (reference ``internals/monitoring.py:56-232``:
rich-based live TUI driven by ProberStats — connectors table, operator
latency table, recent errors)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "LabeledLatencyProbe",
    "LatencyProbe",
    "MonitoringLevel",
    "ProberStats",
    "SERVING_STAGES",
    "STAGES",
    "collect_stats",
    "index_stats",
    "start_dashboard",
]

#: pipeline stages instrumented by the scheduler (ISSUE 4 tentpole c):
#:   ingest   — connector enqueue -> scheduler drain (queue residency)
#:   cut      — first buffered arrival -> epoch cut decision (batching hold)
#:   process  — one epoch of operator propagation (run_epoch wall time)
#:   exchange — cluster mailbox wait for peer frames (recv side)
#:   sink     — epoch cut -> update delivered to an output node
#:   e2e      — earliest enqueue in the epoch -> sink delivery
STAGES = ("ingest", "cut", "process", "exchange", "sink", "e2e")

#: serving-layer stages instrumented per tenant class (ISSUE 10): the
#: SLO scheduler's queue wait, then the co-scheduled pipeline stages
#:   serve_sched    — submit -> lane dispatch (weighted-fair queue wait)
#:   serve_embed    — submit -> query embedding done
#:   serve_retrieve — embedding done -> index hits resolved
#:   serve_generate — hits resolved -> answer produced
#:   serve_e2e      — submit -> answer delivered
SERVING_STAGES = (
    "serve_sched",
    "serve_embed",
    "serve_retrieve",
    "serve_generate",
    "serve_e2e",
)

_LAT_BUCKETS = 488  # mirrors kLatBuckets in native/pathway_native.cpp


def _lat_bucket(ns: int) -> int:
    """Python mirror of the native ``lat_bucket``: 16 exact unit buckets,
    then 8 sub-buckets per octave (~12% relative resolution)."""
    if ns < 16:
        return ns if ns > 0 else 0
    msb = ns.bit_length() - 1
    idx = 16 + (msb - 4) * 8 + ((ns >> (msb - 3)) & 7)
    return idx if idx < _LAT_BUCKETS else _LAT_BUCKETS - 1


def _lat_rep(idx: int) -> int:
    """Representative (midpoint) nanosecond value of bucket ``idx``."""
    if idx < 16:
        return idx
    msb = (idx - 16) // 8 + 4
    sub = (idx - 16) % 8
    lo = (1 << msb) | (sub << (msb - 3))
    return lo + (1 << (msb - 3)) // 2


class _PyHist:
    """Fallback histogram when the native module is unavailable; same
    bucket layout and snapshot contract as the C++ ``LatHist``."""

    __slots__ = ("buckets", "count", "sum_ns", "max_ns", "_lock")

    def __init__(self) -> None:
        self.buckets = [0] * _LAT_BUCKETS
        self.count = 0
        self.sum_ns = 0
        self.max_ns = 0
        self._lock = threading.Lock()

    def record(self, ns: int) -> None:
        if ns < 0:
            ns = 0
        with self._lock:
            self.buckets[_lat_bucket(ns)] += 1
            self.count += 1
            self.sum_ns += ns
            if ns > self.max_ns:
                self.max_ns = ns

    def snapshot(self) -> dict:
        with self._lock:
            buckets = list(self.buckets)
            count, sum_ns, max_ns = self.count, self.sum_ns, self.max_ns

        def q(target: float) -> float:
            cum = 0
            for i, c in enumerate(buckets):
                if not c:
                    continue
                cum += c
                if cum >= target:
                    return float(min(_lat_rep(i), max_ns))
            return float(max_ns)

        return {
            "count": count,
            "sum_ns": sum_ns,
            "max_ns": max_ns,
            "p50_ns": q(0.50 * count) if count else 0.0,
            "p95_ns": q(0.95 * count) if count else 0.0,
            "p99_ns": q(0.99 * count) if count else 0.0,
        }


class LatencyProbe:
    """Per-stage latency histograms for the streaming hot path.

    Recording is one native call per sample (atomic log-bucket increment,
    no lock, safe from any thread); snapshots reduce the buckets to
    p50/p95/p99 without ever resetting them, so the probe is streaming-
    safe — concurrent recording during a snapshot at worst lands a sample
    in the next read."""

    def __init__(self) -> None:
        native = None
        try:
            from pathway_tpu_torch.internals import native as _native_mod

            native = _native_mod.load()
        except Exception:
            native = None
        if native is not None and hasattr(native, "hist_new"):
            self._native = native
            self._h = {s: native.hist_new() for s in STAGES}
            self.now_ns = native.monotonic_ns
            self._record = native.hist_record
        else:
            self._native = None
            self._h = {s: _PyHist() for s in STAGES}
            self.now_ns = time.monotonic_ns
            self._record = lambda h, ns: h.record(ns)

    def record(self, stage: str, ns: int) -> None:
        self._record(self._h[stage], ns)

    def record_since(self, stage: str, t0_ns: int) -> None:
        self._record(self._h[stage], self.now_ns() - t0_ns)

    def snapshot(self) -> dict[str, dict]:
        """``{stage: {count, p50_ms, p95_ms, p99_ms, max_ms, mean_ms}}``
        for every stage that has recorded at least one sample."""
        out: dict[str, dict] = {}
        for s in STAGES:
            h = self._h[s]
            d = self._native.hist_snapshot(h) if self._native else h.snapshot()
            n = d["count"]
            if not n:
                continue
            out[s] = {
                "count": n,
                "p50_ms": d["p50_ns"] / 1e6,
                "p95_ms": d["p95_ns"] / 1e6,
                "p99_ms": d["p99_ns"] / 1e6,
                "max_ms": d["max_ns"] / 1e6,
                "mean_ms": d["sum_ns"] / n / 1e6,
                # cumulative sum: the Prometheus _sum companion, so
                # rate(sum)/rate(count) average math works downstream
                "sum_ms": d["sum_ns"] / 1e6,
            }
        return out


class LabeledLatencyProbe:
    """Latency histograms keyed by ``(stage, label)`` — the serving
    layer's per-tenant-class variant of :class:`LatencyProbe`.

    Histograms are created on first record per key (tenant classes are
    not known up front) and share the native/py histogram substrate:
    recording is one lock-free bucket increment, snapshots never reset,
    so concurrent recording at worst lands a sample in the next read."""

    def __init__(self, stages: tuple[str, ...] = SERVING_STAGES):
        self._stages = tuple(stages)
        native = None
        try:
            from pathway_tpu_torch.internals import native as _native_mod

            native = _native_mod.load()
        except Exception:
            native = None
        if native is not None and hasattr(native, "hist_new"):
            self._native = native
            self._new = native.hist_new
            self.now_ns = native.monotonic_ns
            self._rec = native.hist_record
        else:
            self._native = None
            self._new = _PyHist
            self.now_ns = time.monotonic_ns
            self._rec = lambda h, ns: h.record(ns)
        self._h: dict[tuple[str, str], Any] = {}
        self._lock = threading.Lock()

    def _hist(self, stage: str, label: str) -> Any:
        key = (stage, label)
        h = self._h.get(key)
        if h is None:
            with self._lock:
                h = self._h.get(key)
                if h is None:
                    h = self._h[key] = self._new()
        return h

    def record(self, stage: str, label: str, ns: int) -> None:
        self._rec(self._hist(stage, label), ns)

    def record_since(self, stage: str, label: str, t0_ns: int) -> None:
        self._rec(self._hist(stage, label), self.now_ns() - t0_ns)

    def snapshot(self) -> dict[str, dict[str, dict]]:
        """``{stage: {label: {count, p50_ms, p95_ms, p99_ms, max_ms,
        mean_ms}}}`` for every key with at least one sample."""
        with self._lock:
            keys = list(self._h.items())
        out: dict[str, dict[str, dict]] = {}
        for (stage, label), h in keys:
            d = self._native.hist_snapshot(h) if self._native else h.snapshot()
            n = d["count"]
            if not n:
                continue
            out.setdefault(stage, {})[label] = {
                "count": n,
                "p50_ms": d["p50_ns"] / 1e6,
                "p95_ms": d["p95_ns"] / 1e6,
                "p99_ms": d["p99_ns"] / 1e6,
                "max_ms": d["max_ns"] / 1e6,
                "mean_ms": d["sum_ns"] / n / 1e6,
                "sum_ms": d["sum_ns"] / 1e6,
            }
        return out


class MonitoringLevel:
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"
    AUTO = "auto"


@dataclass
class ProberStats:
    """Per-run stats snapshot (reference ``ProberStats``,
    ``src/engine/graph.rs:554-566``)."""

    epoch: int = 0
    operators: int = 0
    errors: int = 0
    input_rows: int = 0
    output_rows: int = 0
    latency_ms: float | None = None
    connectors: dict[str, dict] = field(default_factory=dict)
    operator_probes: dict[int, dict] = field(default_factory=dict)
    #: resilience counters (connector.restarts/failures/breaker_open/
    #: dlq_events) from the telemetry layer
    resilience: dict[str, int] = field(default_factory=dict)
    #: connector names whose source gave up under on_failure="degrade" —
    #: their downstream tables are stale, not complete
    stale_connectors: list[str] = field(default_factory=list)
    #: exchange-overhead probe from cluster runs: collective counts plus
    #: pack/send/unpack/wait milliseconds (empty for single-worker runs)
    exchange: dict[str, Any] = field(default_factory=dict)
    #: per-stage streaming latency histogram snapshot
    #: ({stage: {count, p50_ms, p95_ms, p99_ms, max_ms, mean_ms}})
    latency: dict[str, Any] = field(default_factory=dict)
    #: pre-flight static-analyzer finding counts by severity
    #: ({"error": n, "warning": n, "info": n}) — what this deployed
    #: graph was warned about before it started
    analysis: dict[str, int] = field(default_factory=dict)
    #: coordinated-checkpoint snapshot ({epoch, age_seconds, bytes,
    #: count, wall_at}; empty when persistence is off) plus the cluster
    #: supervisor's restart generation under "worker_restarts"
    checkpoint: dict[str, Any] = field(default_factory=dict)
    #: serving-layer snapshot (pathway_tpu_torch.serving.serving_snapshot():
    #: admission counters per tenant class, scheduler lane stats,
    #: co-scheduler overlap, per-(stage, tenant_class) latency); empty
    #: when no serving component is live in this process
    serving: dict[str, Any] = field(default_factory=dict)
    #: capacity cross-validation per stateful operator
    #: ({operator: {"estimated": bytes, "measured": bytes, "growth"}};
    #: estimated from analysis/memory.py over the executing plan view,
    #: measured sampled by the scheduler into the operator probes)
    memory: dict[str, Any] = field(default_factory=dict)
    #: backpressure snapshot ({"ingest": per-source buffer occupancy +
    #: shed counters, "exchange": per-peer credit backlog, "serving":
    #: brownout level + sheds}; sections empty where not applicable)
    pressure: dict[str, Any] = field(default_factory=dict)
    #: device-plane join: live jit-compile / H2D / D2H counters
    #: (internals/device_counters.py) next to the static device-safety
    #: prediction (analysis/device.py) — steady state must hold
    #: jit_compiles flat once predicted_recompile_sites == 0
    device: dict[str, Any] = field(default_factory=dict)


def memory_stats(sched: Any) -> dict[str, Any]:
    """Estimated vs measured state bytes, joined per operator label."""
    out: dict[str, Any] = {}
    est = getattr(sched, "memory_estimate", None)
    if est is not None and getattr(est, "operators", None):
        for o in est.operators:
            out[f"{o.name}#{o.node_id}"] = {
                "estimated": o.total_bytes,
                "growth": o.growth,
                "measured": 0,
            }
    try:
        probes = sched.snapshot_operator_probes()
    except Exception:
        probes = {}
    for p in probes.values():
        measured = p.get("state_bytes", 0)
        if not measured:
            continue
        entry = out.setdefault(
            p["name"], {"estimated": 0, "growth": None, "measured": 0}
        )
        entry["measured"] = measured
    return out


def collect_stats(sched: Any) -> ProberStats:
    from pathway_tpu_torch.internals.telemetry import get_telemetry

    ctx = sched.ctx
    # race-free copy: worker threads register connectors concurrently
    connectors = sched.snapshot_connector_stats()
    probes = {k: dict(v) for k, v in ctx.stats.get("operators", {}).items()}
    resilience = {
        name: v
        for name, v in get_telemetry().snapshot_counters().items()
        if name.startswith("connector.")
    }
    return ProberStats(
        epoch=ctx.time,
        operators=len(sched.graph.nodes),
        errors=len(ctx.error_log),
        input_rows=sum(c.get("rows", 0) for c in connectors.values()),
        output_rows=sum(
            # OutputNodes consume rows and emit none: rows_in IS the
            # number of updates written (matched by node TYPE — sink
            # names vary: "bigquery_out", "kafka_out", ...)
            p["rows_in"]
            for p in probes.values()
            if p.get("kind") == "OutputNode"
        ),
        connectors=connectors,
        operator_probes=probes,
        resilience=resilience,
        stale_connectors=sorted(
            name for name, c in connectors.items() if c.get("stale")
        ),
        exchange=_exchange_stats(sched, ctx),
        latency=latency_stats(sched),
        analysis=dict(getattr(sched, "analysis_findings", {}) or {}),
        checkpoint=checkpoint_stats(sched),
        serving=serving_stats(),
        memory=memory_stats(sched),
        pressure=pressure_stats(sched),
        device=device_stats(),
    )


def pressure_stats(sched: Any) -> dict[str, Any]:
    """Backpressure snapshot across the three bounded hops: connector
    ingest buffer (per source), exchange credit windows (per peer), and
    serving brownout.  Every section degrades to absent/empty when the
    layer is not running — the schema is stable either way."""
    out: dict[str, Any] = {}
    ip = getattr(sched, "ingest_pressure", None)
    if ip is not None:
        try:
            out["ingest"] = ip()
        except Exception:
            pass
    cluster = getattr(sched, "_active_cluster", None)
    if cluster is not None:
        try:
            ex = cluster.exchange_pressure()
            if ex:
                out["exchange"] = ex
        except Exception:
            pass
    srv = serving_stats().get("admission")
    if srv:
        out["serving"] = {
            "pressure_level": srv.get("pressure_level", 0.0),
            "brownout_shed_total": srv.get("brownout_shed_total", {}),
            "shed_total": srv.get("shed_total", {}),
        }
    return out


def device_stats() -> dict[str, Any]:
    """Predicted-vs-observed device-plane join.  ``counters`` is the
    live side (jit compiles, H2D/D2H bytes — zeros until a device module
    runs); ``static`` is the analyzer's prediction over the device
    source.  Keyed off ``sys.modules`` like :func:`serving_stats`: a
    host-only process that never imported the device layer pays neither
    a jax import nor an AST sweep on every scrape."""
    import sys

    if sys.modules.get("pathway_tpu_torch.internals.device_counters") is None:
        return {}
    out: dict[str, Any] = {}
    try:
        from pathway_tpu_torch.internals import device_counters

        out["counters"] = device_counters.snapshot()
    except Exception:
        return {}
    try:
        from pathway_tpu_torch.analysis.device import device_profile

        out["static"] = device_profile()
    except Exception:
        pass
    return out


def serving_stats() -> dict[str, Any]:
    """Process-wide serving-layer snapshot — admission/scheduler/latency
    aggregates from ``pathway_tpu_torch.serving``, plus the ``"failover"``
    section (shard health, degraded-response counters, and the
    failover-seconds histogram) when a
    :class:`~pathway_tpu_torch.serving.failover.PartitionedIndex` is live.
    Deliberately keyed off ``sys.modules`` so a process that never
    imported the serving layer pays nothing for this on every scrape."""
    import sys

    mod = sys.modules.get("pathway_tpu_torch.serving")
    if mod is None:
        return {}
    try:
        return mod.serving_snapshot()
    except Exception:
        return {}


def checkpoint_stats(sched: Any) -> dict[str, Any]:
    """Coordinated-checkpoint health snapshot: last checkpointed epoch,
    its age, size, and the supervisor restart generation.  Empty dict
    when persistence is not attached (nothing to report)."""
    hooks = getattr(sched, "persistence", None)
    snap_fn = getattr(hooks, "checkpoint_snapshot", None)
    if snap_fn is None:
        return {}
    try:
        snap = dict(snap_fn())
    except Exception:
        return {}
    snap["worker_restarts"] = int(getattr(sched, "worker_restarts", 0) or 0)
    return snap


def index_stats(sched: Any) -> dict[str, Any]:
    """Live external-index maintenance snapshot, one entry per index
    operator: delta segment size, tombstones, merges, main-segment size
    (see ``stdlib/indexing/segments.py``).  Empty dict when the graph
    has no index operators (or their adapters predate ``stats()``)."""
    graph = getattr(sched, "graph", None)
    if graph is None:
        return {}
    out: dict[str, Any] = {}
    for node in getattr(graph, "nodes", []):
        stats_fn = getattr(getattr(node, "adapter", None), "stats", None)
        if stats_fn is None:
            continue
        try:
            out[f"{node.name}#{node.id}"] = dict(stats_fn())
        except Exception:
            continue
    return out


def latency_stats(sched: Any) -> dict[str, Any]:
    """Per-stage latency snapshot from the scheduler's probe (empty when
    the scheduler has not recorded any samples yet)."""
    probe = getattr(sched, "latency", None)
    if probe is None:
        return {}
    try:
        return probe.snapshot()
    except Exception:
        return {}


def _exchange_stats(sched: Any, ctx: Any) -> dict[str, Any]:
    """Live exchange probe while a cluster run is active; the final
    snapshot stashed on the context afterwards."""
    cluster = getattr(sched, "_active_cluster", None)
    if cluster is not None:
        try:
            return cluster.exchange_stats()
        except Exception:
            pass
    return dict(ctx.stats.get("exchange", {}))


def start_dashboard(
    sched: Any, refresh_per_second: float = 4.0, level: str = MonitoringLevel.ALL
) -> threading.Thread:
    """Live rich dashboard (call before ``sched.run``); sections mirror
    the reference TUI: connector counters, per-operator latency probes
    (``level=ALL``), recent errors."""
    from rich.console import Group
    from rich.live import Live
    from rich.table import Table as RichTable

    def render() -> Group:
        stats = collect_stats(sched)
        parts: list[Any] = []

        head = RichTable(title="pathway_tpu_torch")
        head.add_column("epoch")
        head.add_column("operators")
        head.add_column("errors")
        head.add_row(str(stats.epoch), str(stats.operators), str(stats.errors))
        parts.append(head)

        if stats.connectors:
            ct = RichTable(title="connectors")
            for col in ("input", "rows", "retractions", "commits", "restarts", "state"):
                ct.add_column(col)
            for name, c in sorted(stats.connectors.items()):
                if c.get("stale"):
                    state = "degraded"
                elif c.get("state") in ("failed", "drop"):
                    state = "failed"
                elif c.get("closed"):
                    state = "closed"
                else:
                    state = "live"
                ct.add_row(
                    name,
                    str(c.get("rows", 0)),
                    str(c.get("retractions", 0)),
                    str(c.get("commits", 0)),
                    str(c.get("restarts", 0)),
                    state,
                )
            parts.append(ct)

        if level == MonitoringLevel.ALL and stats.operator_probes:
            ot = RichTable(title="operators (top by total latency)")
            for col in ("operator", "rows in", "rows out", "total ms", "max ms"):
                ot.add_column(col)
            top = sorted(
                stats.operator_probes.values(),
                key=lambda p: -p["total_ms"],
            )[:12]
            for p in top:
                ot.add_row(
                    p["name"],
                    str(p["rows_in"]),
                    str(p["rows_out"]),
                    f"{p['total_ms']:.1f}",
                    f"{p['max_ms']:.2f}",
                )
            parts.append(ot)

        if sched.ctx.error_log:
            et = RichTable(title="recent errors")
            et.add_column("message")
            for e in sched.ctx.error_log[-5:]:
                et.add_row(str(e)[:120])
            parts.append(et)
        return Group(*parts)

    def loop() -> None:
        with Live(render(), refresh_per_second=refresh_per_second) as live:
            while not sched._stop.is_set():
                time.sleep(1.0 / refresh_per_second)
                live.update(render())

    t = threading.Thread(target=loop, daemon=True, name="pw_dashboard")
    t.start()
    return t
