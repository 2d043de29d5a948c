"""Per-process monitoring HTTP endpoint (reference
``src/engine/http_server.rs:21-130``): ``/status``, OpenMetrics
``/metrics``, ``/debug/stacks``, and ``/debug/trace?seconds=N`` on port
``PATHWAY_MONITORING_HTTP_PORT`` (default 20000) + process id."""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

__all__ = ["start_http_server"]


def _metrics_text(sched: Any) -> str:
    ctx = sched.ctx
    lines = [
        "# TYPE pathway_tpu_epoch gauge",
        f"pathway_tpu_epoch {ctx.time}",
        "# TYPE pathway_tpu_error_count gauge",
        f"pathway_tpu_error_count {len(ctx.error_log)}",
        "# TYPE pathway_tpu_operator_count gauge",
        f"pathway_tpu_operator_count {len(sched.graph.nodes)}",
    ]
    # per-connector counters (reference src/connectors/monitoring.rs);
    # copied under the scheduler's lock (registration races iteration)
    connector_stats = sched.snapshot_connector_stats()
    if connector_stats:
        lines.append("# TYPE pathway_tpu_connector_rows_total counter")
        lines.append("# TYPE pathway_tpu_connector_commits_total counter")
        lines.append("# TYPE pathway_tpu_connector_restarts_total counter")
        lines.append("# TYPE pathway_tpu_connector_failures_total counter")
        lines.append("# TYPE pathway_tpu_connector_stale gauge")
        for name, c in sorted(connector_stats.items()):
            label = name.replace('"', "'")
            lines.append(
                f'pathway_tpu_connector_rows_total{{input="{label}"}} '
                f"{c.get('rows', 0)}"
            )
            lines.append(
                f'pathway_tpu_connector_commits_total{{input="{label}"}} '
                f"{c.get('commits', 0)}"
            )
            lines.append(
                f'pathway_tpu_connector_restarts_total{{input="{label}"}} '
                f"{c.get('restarts', 0)}"
            )
            lines.append(
                f'pathway_tpu_connector_failures_total{{input="{label}"}} '
                f"{c.get('failures', 0)}"
            )
            lines.append(
                f'pathway_tpu_connector_stale{{input="{label}"}} '
                f"{1 if c.get('stale') else 0}"
            )
    # resilience counters (supervisor restarts, breaker trips, DLQ)
    from pathway_tpu_torch.internals.telemetry import get_telemetry

    for name, v in sorted(get_telemetry().snapshot_counters().items()):
        metric = "pathway_tpu_" + name.replace(".", "_") + "_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {v}")
    # columnar vs row execution-path row counts: a pipeline
    # silently degraded to the row fallback shows up as path="row"
    # dominating instead of a latent slowdown
    colrows = ctx.stats.get("columnar_rows")
    if colrows:
        lines.append("# TYPE pathway_tpu_columnar_rows_total counter")
        for path in ("columnar", "row"):
            lines.append(
                f'pathway_tpu_columnar_rows_total{{path="{path}"}} '
                f"{colrows.get(path, 0)}"
            )
    # per-operator probes (reference attach_prober, graph.rs:988-995)
    probes = ctx.stats.get("operators", {})
    if probes:
        lines.append("# TYPE pathway_tpu_operator_rows_in_total counter")
        lines.append("# TYPE pathway_tpu_operator_rows_out_total counter")
        lines.append("# TYPE pathway_tpu_operator_latency_ms_total counter")
        lines.append("# TYPE pathway_tpu_state_bytes gauge")
        for p in probes.values():
            label = p["name"].replace('"', "'")
            lines.append(
                f'pathway_tpu_operator_rows_in_total{{operator="{label}"}} '
                f"{p['rows_in']}"
            )
            lines.append(
                f'pathway_tpu_operator_rows_out_total{{operator="{label}"}} '
                f"{p['rows_out']}"
            )
            lines.append(
                f'pathway_tpu_operator_latency_ms_total{{operator="{label}"}} '
                f"{p['total_ms']:.3f}"
            )
            lines.append(
                f'pathway_tpu_state_bytes{{operator="{label}"}} '
                f"{p.get('state_bytes', 0)}"
            )
    # static capacity predictions next to the measured gauges above —
    # the cross-validation pair (analysis/memory.py); same operator label
    est = getattr(sched, "memory_estimate", None)
    if est is not None and getattr(est, "operators", None):
        lines.append("# TYPE pathway_tpu_state_bytes_estimated gauge")
        for o in est.operators:
            label = f"{o.name}#{o.node_id}".replace('"', "'")
            lines.append(
                f'pathway_tpu_state_bytes_estimated{{operator="{label}"}} '
                f"{o.total_bytes}"
            )
    # per-stage streaming latency histograms: the
    # scheduler's LatencyProbe reduced to quantile gauges per stage
    lat = _latency_snapshot(sched)
    if lat:
        lines.append("# TYPE pathway_tpu_stage_latency_ms gauge")
        lines.append("# TYPE pathway_tpu_stage_latency_count gauge")
        lines.append("# TYPE pathway_tpu_stage_latency_ms_count counter")
        lines.append("# TYPE pathway_tpu_stage_latency_ms_sum counter")
        for stage, d in sorted(lat.items()):
            for qk in ("p50", "p95", "p99", "max"):
                lines.append(
                    f'pathway_tpu_stage_latency_ms{{stage="{stage}",'
                    f'quantile="{qk}"}} {d[qk + "_ms"]:.4f}'
                )
            lines.append(
                f'pathway_tpu_stage_latency_count{{stage="{stage}"}} '
                f"{d['count']}"
            )
            # _count/_sum companions so rate(sum)/rate(count) gives the
            # true windowed mean (quantile gauges can't be averaged)
            lines.append(
                f'pathway_tpu_stage_latency_ms_count{{stage="{stage}"}} '
                f"{d['count']}"
            )
            lines.append(
                f'pathway_tpu_stage_latency_ms_sum{{stage="{stage}"}} '
                f"{d.get('sum_ms', 0.0):.4f}"
            )
    # pre-flight static-analyzer finding counts (pathway_tpu_torch/analysis/)
    findings = getattr(sched, "analysis_findings", {}) or {}
    if findings:
        lines.append("# TYPE pathway_tpu_analysis_findings gauge")
        for sev, n in sorted(findings.items()):
            lines.append(
                f'pathway_tpu_analysis_findings{{severity="{sev}"}} {n}'
            )
    # plan-compiler rewrite counters (analysis/rewrite.py), one gauge
    # per applied pass, plus the effective optimization level
    plan_counters = getattr(sched, "plan_counters", {}) or {}
    if plan_counters:
        lines.append("# TYPE pathway_tpu_plan_rewrites gauge")
        for pass_name, n in sorted(plan_counters.items()):
            lines.append(
                f'pathway_tpu_plan_rewrites{{pass="{pass_name}"}} {n}'
            )
    plan = getattr(sched, "execution_plan", None)
    if plan is not None:
        lines.append("# TYPE pathway_tpu_plan_level gauge")
        lines.append(f"pathway_tpu_plan_level {plan.level}")
    # coordinated-checkpoint health (fault-tolerance observability): a
    # growing age with bytes stuck means checkpoints stopped landing —
    # the alert that matters before a worker ever dies
    ckpt = _checkpoint_snapshot(sched)
    if ckpt:
        age = ckpt.get("age_seconds")
        lines.append("# TYPE pathway_tpu_checkpoint_age_seconds gauge")
        lines.append(
            f"pathway_tpu_checkpoint_age_seconds "
            f"{age if age is not None else -1:.3f}"
        )
        lines.append("# TYPE pathway_tpu_checkpoint_bytes gauge")
        lines.append(f"pathway_tpu_checkpoint_bytes {ckpt.get('bytes', 0)}")
    # live index maintenance (delta segment / tombstones / merges per
    # external-index operator; see stdlib/indexing/segments.py) — the
    # gauges that show churn outrunning the background merge
    idx = _index_snapshot(sched)
    if idx:
        lines.append("# TYPE pathway_tpu_index_size gauge")
        lines.append("# TYPE pathway_tpu_index_delta_size gauge")
        lines.append("# TYPE pathway_tpu_index_tombstones gauge")
        lines.append("# TYPE pathway_tpu_index_merges_total counter")
        for name, s in sorted(idx.items()):
            label = name.replace('"', "'")
            lines.append(
                f'pathway_tpu_index_size{{index="{label}"}} '
                f"{s.get('size', 0)}"
            )
            lines.append(
                f'pathway_tpu_index_delta_size{{index="{label}"}} '
                f"{s.get('delta_size', 0)}"
            )
            lines.append(
                f'pathway_tpu_index_tombstones{{index="{label}"}} '
                f"{s.get('tombstones', 0)}"
            )
            lines.append(
                f'pathway_tpu_index_merges_total{{index="{label}"}} '
                f"{s.get('merges_total', 0)}"
            )
    lines.append("# TYPE pathway_tpu_worker_restarts_total counter")
    lines.append(
        f"pathway_tpu_worker_restarts_total "
        f"{int(getattr(sched, 'worker_restarts', 0) or 0)}"
    )
    # multi-tenant serving layer (admission + SLO scheduling):
    # admitted/shed counters per tenant class, and the serving stages'
    # latency quantiles carrying the tenant_class label.  The engine
    # stage lines above stay label-free — serving emits ADDITIONAL
    # labeled series, so existing dashboards keep parsing.
    srv = _serving_snapshot()
    adm = srv.get("admission", {})
    if adm:
        lines.append("# TYPE pathway_tpu_serving_admitted_total counter")
        lines.append("# TYPE pathway_tpu_serving_shed_total counter")
        lines.append("# TYPE pathway_tpu_serving_inflight gauge")
        for cls, n in sorted(adm.get("admitted_total", {}).items()):
            label = str(cls).replace('"', "'")
            lines.append(
                f'pathway_tpu_serving_admitted_total{{tenant_class="{label}"}} {n}'
            )
        for cls, n in sorted(adm.get("shed_total", {}).items()):
            label = str(cls).replace('"', "'")
            lines.append(
                f'pathway_tpu_serving_shed_total{{tenant_class="{label}"}} {n}'
            )
        for cls, n in sorted(adm.get("inflight", {}).items()):
            label = str(cls).replace('"', "'")
            lines.append(
                f'pathway_tpu_serving_inflight{{tenant_class="{label}"}} {n}'
            )
    srv_lat = srv.get("latency", {})
    if srv_lat:
        lines.append("# TYPE pathway_tpu_stage_latency_ms gauge")
        lines.append("# TYPE pathway_tpu_stage_latency_count gauge")
        lines.append("# TYPE pathway_tpu_stage_latency_ms_count counter")
        lines.append("# TYPE pathway_tpu_stage_latency_ms_sum counter")
        for stage, by_class in sorted(srv_lat.items()):
            for cls, d in sorted(by_class.items()):
                label = str(cls).replace('"', "'")
                for qk in ("p50", "p95", "p99", "max"):
                    lines.append(
                        f'pathway_tpu_stage_latency_ms{{stage="{stage}",'
                        f'tenant_class="{label}",quantile="{qk}"}} '
                        f"{d[qk + '_ms']:.4f}"
                    )
                lines.append(
                    f'pathway_tpu_stage_latency_count{{stage="{stage}",'
                    f'tenant_class="{label}"}} {d["count"]}'
                )
                lines.append(
                    f'pathway_tpu_stage_latency_ms_count{{stage="{stage}",'
                    f'tenant_class="{label}"}} {d["count"]}'
                )
                lines.append(
                    f'pathway_tpu_stage_latency_ms_sum{{stage="{stage}",'
                    f'tenant_class="{label}"}} {d.get("sum_ms", 0.0):.4f}'
                )
    # degraded serving / shard failover: shard health, responses
    # served with partial coverage, and the failover-duration histogram —
    # the dashboard panel for "one owner died; did anyone notice?"
    fo = srv.get("failover", {})
    if fo:
        lines.append("# TYPE pathway_tpu_shards_total gauge")
        lines.append(f"pathway_tpu_shards_total {fo.get('shards_total', 0)}")
        lines.append("# TYPE pathway_tpu_shards_healthy gauge")
        lines.append(
            f"pathway_tpu_shards_healthy {fo.get('shards_healthy', 0)}"
        )
        lines.append("# TYPE pathway_tpu_degraded_responses_total counter")
        lines.append(
            f"pathway_tpu_degraded_responses_total "
            f"{fo.get('degraded_responses_total', 0)}"
        )
        lines.append("# TYPE pathway_tpu_failovers_total counter")
        lines.append(
            f"pathway_tpu_failovers_total {fo.get('failovers_total', 0)}"
        )
        hist = fo.get("failover_seconds") or {}
        if hist.get("count"):
            lines.append("# TYPE pathway_tpu_failover_seconds gauge")
            for qk in ("p50", "p95", "p99", "max"):
                lines.append(
                    f'pathway_tpu_failover_seconds{{quantile="{qk}"}} '
                    f"{hist.get(qk + '_ns', 0) / 1e9:.6f}"
                )
            lines.append("# TYPE pathway_tpu_failover_seconds_count counter")
            lines.append(
                f"pathway_tpu_failover_seconds_count {hist.get('count', 0)}"
            )
            lines.append("# TYPE pathway_tpu_failover_seconds_sum counter")
            lines.append(
                f"pathway_tpu_failover_seconds_sum "
                f"{hist.get('sum_ns', 0) / 1e9:.6f}"
            )
    # backpressure: bounded ingest buffer occupancy per source,
    # exchange credit backlog per peer, brownout level + sheds — the
    # panels that explain "slow but alive" before it becomes an OOM
    pressure = _pressure_snapshot(sched)
    ing = pressure.get("ingest", {})
    if ing:
        tot = ing.get("totals", {})
        lines.append("# TYPE pathway_tpu_ingest_buffer_capacity_bytes gauge")
        lines.append(
            f"pathway_tpu_ingest_buffer_capacity_bytes "
            f"{tot.get('capacity_bytes', 0)}"
        )
        lines.append("# TYPE pathway_tpu_ingest_credit_stalls_total counter")
        lines.append(
            f"pathway_tpu_ingest_credit_stalls_total "
            f"{tot.get('stalls_total', 0)}"
        )
        srcs = ing.get("sources", {})
        if srcs:
            lines.append("# TYPE pathway_tpu_ingest_queue_rows gauge")
            lines.append("# TYPE pathway_tpu_ingest_queue_bytes gauge")
            lines.append("# TYPE pathway_tpu_ingest_shed_rows_total counter")
            lines.append("# TYPE pathway_tpu_ingest_paused gauge")
            for name, s in sorted(srcs.items()):
                label = str(name).replace('"', "'")
                lines.append(
                    f'pathway_tpu_ingest_queue_rows{{input="{label}"}} '
                    f"{s.get('rows', 0)}"
                )
                lines.append(
                    f'pathway_tpu_ingest_queue_bytes{{input="{label}"}} '
                    f"{s.get('bytes', 0)}"
                )
                lines.append(
                    f'pathway_tpu_ingest_shed_rows_total{{input="{label}"}} '
                    f"{s.get('shed_rows', 0)}"
                )
                lines.append(
                    f'pathway_tpu_ingest_paused{{input="{label}"}} '
                    f"{1 if s.get('paused') else 0}"
                )
    ex = pressure.get("exchange", {})
    if ex:
        lines.append("# TYPE pathway_tpu_exchange_credit_bytes gauge")
        lines.append(
            f"pathway_tpu_exchange_credit_bytes {ex.get('credit_bytes', 0)}"
        )
        lines.append("# TYPE pathway_tpu_exchange_credit_stalls_total counter")
        lines.append(
            f"pathway_tpu_exchange_credit_stalls_total "
            f"{ex.get('credit_stalls_total', 0)}"
        )
        peers = ex.get("peers", {})
        if peers:
            lines.append("# TYPE pathway_tpu_exchange_backlog_bytes gauge")
            for p, s in sorted(peers.items()):
                lines.append(
                    f'pathway_tpu_exchange_backlog_bytes{{peer="{p}"}} '
                    f"{s.get('backlog_bytes', 0)}"
                )
    srv_p = pressure.get("serving", {})
    if srv_p:
        lines.append("# TYPE pathway_tpu_serving_brownout_level gauge")
        lines.append(
            f"pathway_tpu_serving_brownout_level "
            f"{srv_p.get('pressure_level', 0.0):.4f}"
        )
        bshed = srv_p.get("brownout_shed_total", {})
        if bshed:
            lines.append(
                "# TYPE pathway_tpu_serving_brownout_shed_total counter"
            )
            for cls, n in sorted(bshed.items()):
                label = str(cls).replace('"', "'")
                lines.append(
                    f"pathway_tpu_serving_brownout_shed_total"
                    f'{{tenant_class="{label}"}} {n}'
                )
    device = _device_snapshot()
    ctr = device.get("counters", {})
    if ctr:
        lines.append("# TYPE pathway_tpu_jit_compiles_total counter")
        lines.append(
            f"pathway_tpu_jit_compiles_total {ctr.get('jit_compiles', 0)}"
        )
        lines.append("# TYPE pathway_tpu_h2d_bytes_total counter")
        lines.append(f"pathway_tpu_h2d_bytes_total {ctr.get('h2d_bytes', 0)}")
        lines.append("# TYPE pathway_tpu_d2h_bytes_total counter")
        lines.append(f"pathway_tpu_d2h_bytes_total {ctr.get('d2h_bytes', 0)}")
        lines.append("# TYPE pathway_tpu_h2d_transfers_total counter")
        lines.append(
            f"pathway_tpu_h2d_transfers_total {ctr.get('h2d_transfers', 0)}"
        )
        lines.append("# TYPE pathway_tpu_d2h_transfers_total counter")
        lines.append(
            f"pathway_tpu_d2h_transfers_total {ctr.get('d2h_transfers', 0)}"
        )
        static = device.get("static", {})
        if static:
            lines.append(
                "# TYPE pathway_tpu_device_predicted_recompile_sites gauge"
            )
            lines.append(
                f"pathway_tpu_device_predicted_recompile_sites "
                f"{static.get('predicted_recompile_sites', 0)}"
            )
    return "\n".join(lines) + "\n# EOF\n"


def _latency_snapshot(sched: Any) -> dict[str, Any]:
    from pathway_tpu_torch.internals.monitoring import latency_stats

    return latency_stats(sched)


def _checkpoint_snapshot(sched: Any) -> dict[str, Any]:
    from pathway_tpu_torch.internals.monitoring import checkpoint_stats

    return checkpoint_stats(sched)


def _index_snapshot(sched: Any) -> dict[str, Any]:
    from pathway_tpu_torch.internals.monitoring import index_stats

    return index_stats(sched)


def _serving_snapshot() -> dict[str, Any]:
    from pathway_tpu_torch.internals.monitoring import serving_stats

    return serving_stats()


def _memory_snapshot(sched: Any) -> dict[str, Any]:
    from pathway_tpu_torch.internals.monitoring import memory_stats

    return memory_stats(sched)


def _pressure_snapshot(sched: Any) -> dict[str, Any]:
    from pathway_tpu_torch.internals.monitoring import pressure_stats

    return pressure_stats(sched)


def _device_snapshot() -> dict[str, Any]:
    from pathway_tpu_torch.internals.monitoring import device_stats

    return device_stats()


def start_http_server(sched: Any, port: int | None = None) -> threading.Thread:
    if port is None:
        base = int(os.environ.get("PATHWAY_MONITORING_HTTP_PORT", "20000"))
        port = base + int(os.environ.get("PATHWAY_PROCESS_ID", "0"))

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802
            if self.path.startswith("/status"):
                srv = _serving_snapshot()
                fo = srv.get("failover", {})
                xplan = getattr(sched, "execution_plan", None)
                body = json.dumps(
                    {
                        "epoch": sched.ctx.time,
                        "operators": len(sched.graph.nodes),
                        "errors": len(sched.ctx.error_log),
                        "latency": _latency_snapshot(sched),
                        # pre-flight analyzer verdict for the running graph
                        "analysis": dict(
                            getattr(sched, "analysis_findings", {}) or {}
                        ),
                        # plan-compiler rewrite counters + level, plus
                        # the per-operator columnar/row path decisions
                        # and the runtime rows-per-path counter
                        "plan": {
                            "level": getattr(xplan, "level", 0),
                            "rewrites": dict(
                                getattr(sched, "plan_counters", {}) or {}
                            ),
                            "columnar": (
                                xplan.columnar_lines()
                                if hasattr(xplan, "columnar_lines")
                                else []
                            ),
                            "columnar_rows": dict(
                                sched.ctx.stats.get("columnar_rows", {})
                            ),
                        },
                        # coordinated-checkpoint health: last checkpoint
                        # epoch, its age/size, and the supervisor restart
                        # generation ({} when persistence is off)
                        "checkpoint": _checkpoint_snapshot(sched),
                        # live index maintenance per index operator:
                        # delta/tombstones/merges (segments.py)
                        "index": _index_snapshot(sched),
                        # capacity cross-validation: statically estimated
                        # vs runtime-sampled state bytes per operator
                        # (analysis/memory.py + scheduler sampling)
                        "memory": _memory_snapshot(sched),
                        # multi-tenant serving layer: admission counters
                        # per tenant class, scheduler lane stats, and
                        # per-(stage, tenant_class) latency
                        "serving": srv,
                        # backpressure across the bounded hops: ingest
                        # buffer, exchange credit windows, brownout
                        "pressure": _pressure_snapshot(sched),
                        # device-plane join: live jit-compile + H2D/D2H
                        # counters next to the static device-safety
                        # prediction (analysis/device.py); a warmed
                        # serving loop must hold jit_compiles flat
                        "device": _device_snapshot(),
                        # degraded-mode summary: one glance says
                        # whether answers are currently partial and why
                        "degraded": {
                            "active": fo.get("shards_healthy", 0)
                            < fo.get("shards_total", 0),
                            "shards_healthy": fo.get("shards_healthy", 0),
                            "shards_total": fo.get("shards_total", 0),
                            "degraded_responses_total": fo.get(
                                "degraded_responses_total", 0
                            ),
                            "failovers_total": fo.get("failovers_total", 0),
                        }
                        if fo
                        else {},
                    }
                ).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = _metrics_text(sched).encode()
                ctype = "application/openmetrics-text"
            elif self.path.startswith("/debug/stacks"):
                from pathway_tpu_torch.internals import tracing

                body = tracing.dump_stacks().encode()
                ctype = "text/plain"
            elif self.path.startswith("/debug/trace"):
                import time as _time
                from urllib.parse import parse_qs, urlsplit

                from pathway_tpu_torch.internals import tracing

                qs = parse_qs(urlsplit(self.path).query)
                since_ns = None
                try:
                    secs = float(qs["seconds"][0])
                    since_ns = _time.monotonic_ns() - int(secs * 1e9)
                except (KeyError, IndexError, ValueError):
                    pass
                body = json.dumps(
                    {
                        "traceEvents": tracing.chrome_events(
                            since_ns=since_ns, all_spans=True
                        )
                    }
                ).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args: Any) -> None:
            pass

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True, name="pw_monitoring")
    t.start()
    sched._monitoring_server = server
    # SIGUSR2 → dump all thread stacks to stderr and flush the tracing
    # flight recorder to PATHWAY_TRACE_DIR (no-op off the main thread)
    from pathway_tpu_torch.internals import tracing

    tracing.install_sigusr2()
    return t
