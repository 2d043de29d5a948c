"""``pw.run`` — execute the constructed dataflow.

Reference: ``python/pathway/internals/run.py`` + ``GraphRunner``
(``internals/graph_runner/__init__.py:36-252``); counterpart of
``pathway_tpu/internals/run.py``.  Runs the pre-flight static analyzer
and the plan compiler (``pathway_tpu_torch/analysis/``), then the epoch
scheduler over the rewritten view of the global graph, with the free
tier's worker cap, the cluster topology, telemetry and the collector
pacing around it; with live connectors it blocks until all sources close
(streaming mode), mirroring ``pw.run`` blocking semantics.

``with_http_server=True`` (or ``PATHWAY_MONITORING_HTTP_PORT``) serves
``/status``, ``/metrics``, ``/debug/stacks`` and ``/debug/trace`` for the
length of the run (``internals/monitoring_server.py``).  A
``persistence_config`` (here or in ``pathway_config.persistence_config``)
attaches the persistence layer (``pathway_tpu_torch/persistence/``: input
logs, replay and operator checkpoints) to the scheduler before it runs.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.scheduler import Scheduler
from pathway_tpu_torch.internals.parse_graph import G


class MonitoringLevel:
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"
    AUTO = "auto"


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
    """Run the whole computation graph (blocking until sources finish).

    ``strict=True`` (or ``PATHWAY_STRICT=1``) runs the pre-flight static
    analyzer (``pathway_tpu_torch/analysis/``) and raises
    :class:`pathway_tpu_torch.AnalysisError` on any error-severity
    finding, BEFORE the scheduler exists, so no connector thread ever
    starts.  Finding counts are computed either way
    (``sched.analysis_findings``).

    ``optimize`` sets the plan-compiler level (0 = off, 1 = const-fold +
    dead-column elimination + select/filter fusion, 2 = + append-only
    specialization + join pushdowns + the columnar fast paths); default
    comes from ``PATHWAY_OPTIMIZE``, else 2.  The applied plan is
    available as ``pw.explain()`` / ``G.last_plan``.

    ``with_http_server=True`` (or ``PATHWAY_MONITORING_HTTP_PORT``) starts
    the monitoring server on ``PATHWAY_MONITORING_HTTP_PORT`` (default
    20000) plus ``PATHWAY_PROCESS_ID``; it stops when the run ends.  A
    ``persistence_config`` (here or in ``pathway_config.persistence_config``)
    is attached to the scheduler (:func:`pathway_tpu_torch.persistence.attach_persistence`)."""
    import os

    from pathway_tpu_torch.analysis import SEV_ERROR, AnalysisError, analyze, count_by_severity
    from pathway_tpu_torch.analysis.rewrite import optimize_graph, resolve_level
    from pathway_tpu_torch.internals import config as cfg

    if strict is None:
        strict = os.environ.get("PATHWAY_STRICT", "").lower() in (
            "1",
            "true",
            "yes",
        )
    if persistence_config is None:
        persistence_config = cfg.pathway_config.persistence_config

    level = resolve_level(optimize)
    # plan-aware: analyze the view the scheduler will execute, so
    # rewrites that cure a finding (dead-column elimination, append-only
    # reducer specialization) also clear its diagnostic
    diags = analyze(G.engine_graph, optimize=level)
    if strict and any(d.severity == SEV_ERROR for d in diags):
        raise AnalysisError(diags)

    # plan compiler: rewrite a cloned execution view of the captured
    # graph; the captured graph itself stays pristine (re-runs, explain)
    exec_graph, plan = optimize_graph(G.engine_graph, level)
    G.last_plan = plan

    pc = cfg.pathway_config
    saved_typecheck = pc.runtime_typechecking
    if runtime_typechecking is not None:
        pc.runtime_typechecking = runtime_typechecking
    try:
        return _run_inner(
            pc,
            monitoring_level,
            with_http_server or bool(cfg.pathway_config.monitoring_http_port),
            autocommit_duration_ms,
            count_by_severity(diags),
            exec_graph,
            plan,
            persistence_config,
        )
    finally:
        # per-run override, not a process-wide setting
        pc.runtime_typechecking = saved_typecheck


def _run_inner(
    pc: Any,
    monitoring_level: Any,
    with_http_server: bool,
    autocommit_duration_ms: int | None,
    analysis_counts: dict[str, int],
    exec_graph: Any,
    plan: Any,
    persistence_config: Any = None,
):
    import os

    from pathway_tpu_torch.analysis.memory import estimate_memory
    from pathway_tpu_torch.internals.license import LicenseError, get_license

    threads = max(1, pc.threads)
    processes = max(1, pc.processes)
    # free tier caps total workers (reference MAX_WORKERS, config.rs:7-11).
    # Thread counts clamp locally; a process topology over the cap cannot
    # be shrunk from inside one process, so it is refused outright (every
    # process raises the same error).
    cap = get_license().worker_cap()
    if cap is not None and threads * processes > cap:
        if processes > cap:
            raise LicenseError(
                f"free tier allows at most {cap} workers but "
                f"PATHWAY_PROCESSES={processes}; set a license key with "
                "the 'scale' entitlement"
            )
        threads = max(1, cap // processes)
        import logging

        logging.getLogger("pathway_tpu_torch.license").warning(
            "free tier caps workers at %d: running %d threads x %d "
            "processes = %d workers; set a license key with the 'scale' "
            "entitlement to lift the cap",
            cap,
            threads,
            processes,
            threads * processes,
        )
    sched = Scheduler(exec_graph, autocommit_ms=autocommit_duration_ms or 50)
    #: pre-flight analyzer finding counts, by severity
    sched.analysis_findings = dict(analysis_counts)
    # a ClusterSupervisor stamps its respawn generation into the env so the
    # worker can surface it as pathway_tpu_worker_restarts_total
    try:
        sched.worker_restarts = int(os.environ.get("PATHWAY_WORKER_RESTARTS", "0"))
    except ValueError:
        sched.worker_restarts = 0
    #: optimizer audit trail + rewrite counters
    sched.execution_plan = plan
    sched.plan_counters = plan.counters()
    #: static capacity estimate of the EXECUTING view, beside the
    #: measured state bytes
    try:
        sched.memory_estimate = estimate_memory(exec_graph, optimize=0)  # already rewritten
    except Exception:
        sched.memory_estimate = None
    if with_http_server:
        from pathway_tpu_torch.internals.monitoring_server import start_http_server

        start_http_server(sched)
    if persistence_config is not None:
        from pathway_tpu_torch.persistence import attach_persistence

        attach_persistence(sched, persistence_config)
    try:
        return _run_scheduler(sched, pc, monitoring_level, threads, processes)
    finally:
        server = getattr(sched, "_monitoring_server", None)
        if server is not None:
            server.shutdown()
            server.server_close()


def _run_scheduler(sched: Any, pc: Any, monitoring_level: Any, threads: int, processes: int):
    # live TUI dashboard (reference pw.run(monitoring_level=...) rich TUI):
    # AUTO shows it only on a real terminal; NONE never
    show = monitoring_level in (MonitoringLevel.ALL, MonitoringLevel.IN_OUT)
    if monitoring_level == MonitoringLevel.AUTO:
        import sys

        show = sys.stderr.isatty()
    if show:
        try:
            from pathway_tpu_torch.internals.monitoring import start_dashboard

            start_dashboard(
                sched,
                level=(
                    monitoring_level
                    if monitoring_level != MonitoringLevel.AUTO
                    else MonitoringLevel.ALL
                ),
            )
        except ImportError:
            pass  # rich unavailable: run silently
    G.active_scheduler = sched  # handle for stopping threaded servers
    from pathway_tpu_torch.internals.telemetry import get_telemetry

    telemetry = get_telemetry()
    with telemetry.span(
        "graph_runner.run", operators=len(G.engine_graph.nodes)
    ), _ManagedGc() as mgc:

        def _gc_tick() -> None:
            # the GC pacer is a wakeup source too: a sweep can take long
            # enough that parked workers' deadlines passed — notify the
            # scheduler's event waits so they re-evaluate immediately
            if mgc.maybe_sweep():
                sched.wake()

        sched.gc_tick = _gc_tick
        if threads * processes > 1:
            # multi-worker topology from the spawn env contract
            # (PATHWAY_THREADS × PATHWAY_PROCESSES, reference config.rs:86-120)
            from pathway_tpu_torch.engine.cluster import Cluster

            cluster = Cluster(
                threads=threads,
                processes=processes,
                process_id=pc.process_id,
                first_port=pc.first_port,
            )
            try:
                ctx = sched.run_cluster(cluster)
            finally:
                cluster.close()
        else:
            ctx = sched.run()
    telemetry.record_process_metrics()
    telemetry.gauge("run.epoch", ctx.time)
    telemetry.gauge("run.errors", len(ctx.error_log))
    telemetry.export_metrics()
    G.last_run_ctx = ctx
    return ctx


class _ManagedGc:
    """Collector discipline for the run hot loop.

    CPython's automatic gen-0 collection fires every ~700 net container
    allocations; a streaming epoch allocates millions of short-lived row
    tuples, so the collector's pauses cost the run loop throughput.  The
    reference engine has no such pauses — Rust frees rows
    deterministically (src/engine/dataflow.rs) — so the host runtime
    disables *automatic* collection for the duration of the run and
    sweeps at EPOCH BOUNDARIES instead (the scheduler calls
    :meth:`maybe_sweep` after each epoch).  Mid-epoch sweeps walk every
    transient row tuple alive inside the epoch and hold the GIL against
    the exchange reader threads, stalling peer processes; at the boundary
    the transients are already refcount-freed, so a sweep only walks live
    survivors (reducer state, buffers).  Startup objects (modules, the
    graph, torch internals) are frozen out of the collector entirely for
    the run.  Plain reference-counted garbage (the vast majority of row
    data) is freed immediately either way.  Opt out with
    PATHWAY_GC_INTERVAL_S=0; a user who already disabled gc keeps their
    setting untouched.
    """

    def __init__(self) -> None:
        import gc
        import os
        import time

        self._gc = gc
        self._time = time
        try:
            self._interval = float(os.environ.get("PATHWAY_GC_INTERVAL_S", "2.0"))
        except ValueError:
            self._interval = 2.0
        self._was_enabled = False
        self._last_sweep = 0.0
        self._next_due = 0.0
        self._sweeps = 0

    def __enter__(self) -> "_ManagedGc":
        if self._interval <= 0 or not self._gc.isenabled():
            return self
        self._was_enabled = True
        self._gc.disable()
        # clean the YOUNG generations, then freeze everything into the
        # permanent generation.  A full collect here walks gen-2 — with a
        # million-row static table that is ~1s before the run even starts
        # — for the sole benefit of not freezing old cyclic garbage; that
        # garbage is bounded (startup imports) and unfreezes at exit.
        self._gc.collect(1)
        self._gc.freeze()
        self._last_sweep = self._time.monotonic()
        self._next_due = self._last_sweep + self._interval
        return self

    def maybe_sweep(self) -> bool:
        """Sweep cycles if due — called by the scheduler between epochs,
        when transient row data is already dead.  Sweeps are PACED by
        their own cost: a sweep that took ``t`` seconds pushes the next
        one at least ``t / 0.02`` seconds out, bounding collector
        overhead to ~2% of runtime.  A fixed wall interval instead
        charges every process the full sweep cost per interval, which on
        a shared core compounds — slower runs sweep more, sweeping makes
        them slower.  Cycle garbage only accumulates from the few objects
        that survive epochs, so deferring sweeps costs memory slowly;
        leaks still get collected, just amortized.  Returns True when a
        sweep actually ran (the caller treats that as a wakeup-worthy
        event)."""
        if not self._was_enabled:
            return False
        now = self._time.monotonic()
        if now < self._next_due:
            return False
        self._sweeps += 1
        # young generations every sweep; a full collection every 8th so
        # gen-2 cycles (promoted survivors) cannot leak over a long
        # streaming run
        t0 = self._time.monotonic()
        self._gc.collect(2 if self._sweeps % 8 == 0 else 1)
        self._last_sweep = self._time.monotonic()
        cost = self._last_sweep - t0
        self._next_due = self._last_sweep + max(self._interval, cost / 0.02)
        return True

    def __exit__(self, *exc: Any) -> None:
        if self._was_enabled:
            self._gc.unfreeze()
            self._gc.enable()


def run_all(**kwargs: Any):
    return run(**kwargs)


def attach_prober(callback: Any) -> None:
    """Register a per-epoch stats callback (reference ``attach_prober`` /
    ``probe_table``, ``src/engine/graph.rs:988-995``): invoked by EVERY
    worker after each of its epochs with ``{"time", "worker",
    "operators", "connectors"}`` — per-worker partition stats like the
    reference's ProberStats; aggregate over ``worker`` for a fleet view."""
    G.engine_graph.probers.append(callback)
