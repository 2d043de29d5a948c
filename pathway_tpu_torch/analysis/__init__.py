"""Pre-flight static analysis of the captured dataflow graph.

``analyze()`` walks the engine graph (``internals/parse_graph.G``) and
the expression-VM programs compiled for it, BEFORE execution, and
returns structured :class:`Diagnostic` findings — the build-time
equivalent of the checks the reference Rust engine does inside
``trait Graph`` (``src/engine/graph.rs``), plus perf, state-growth and
distribution-safety lints no runtime check can give you.

The code registry lives in ONE place —
:data:`pathway_tpu_torch.analysis.diagnostics.CODE_INFO` — and that module's
docstring embeds the generated table (``render_code_table()``); codes
are never listed by hand anywhere else.

Three surfaces: ``pathway_tpu_torch.analyze()``, :func:`lint_file` (the
CLI's ``lint`` subcommand, ``python -m pathway_tpu_torch.cli lint``), and strict mode (``pw.run(strict=True)`` /
``PATHWAY_STRICT=1``) which refuses to start connectors while
error-severity findings exist.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.analysis.diagnostics import (
    CODE_INFO,
    CODES,
    SEV_ERROR,
    SEV_INFO,
    SEV_WARNING,
    AnalysisError,
    Diagnostic,
    count_by_severity,
    format_diagnostics,
    render_code_table,
    sort_diagnostics,
)
from pathway_tpu_torch.analysis.device import (
    DeviceReport,
    device_module_files,
    device_profile,
    scan_paths as scan_device,
)
from pathway_tpu_torch.analysis.graph_facts import GraphFacts
from pathway_tpu_torch.analysis.memory import (
    EstimateParams,
    MemoryReport,
    estimate_memory,
)
from pathway_tpu_torch.analysis.passes import ALL_PASSES
from pathway_tpu_torch.analysis.plan import ExecutionPlan
from pathway_tpu_torch.analysis.rewrite import optimize_graph, resolve_level

__all__ = [
    "analyze",
    "explain",
    "lint_file",
    "estimate_memory",
    "EstimateParams",
    "MemoryReport",
    "DeviceReport",
    "scan_device",
    "device_profile",
    "device_module_files",
    "Diagnostic",
    "AnalysisError",
    "CODES",
    "CODE_INFO",
    "render_code_table",
    "SEV_ERROR",
    "SEV_WARNING",
    "SEV_INFO",
    "count_by_severity",
    "format_diagnostics",
    "GraphFacts",
    "ExecutionPlan",
    "optimize_graph",
    "resolve_level",
]


def analyze(graph: Any = None, optimize: "int | None" = None) -> list[Diagnostic]:
    """Statically analyze a captured graph (default: the global parse
    graph) and return sorted diagnostics.  Never raises on exotic
    graphs: a pass that cannot reason about a node skips it.

    ``optimize`` (plan-aware mode) runs every pass over the
    ``optimize_graph`` rewritten view at that level — what the scheduler
    will actually execute — so rewrites that remove work (dead columns,
    append-only reducer specialization) also remove the findings they
    cure.  ``None`` (the default) analyzes the captured graph as built."""
    if graph is None:
        from pathway_tpu_torch.internals.parse_graph import G

        graph = G.engine_graph
    engine_graph = getattr(graph, "engine_graph", graph)
    if optimize is not None:
        level = resolve_level(optimize)
        if level > 0:
            engine_graph, _plan = optimize_graph(engine_graph, level)
    facts = GraphFacts(engine_graph)
    diags: list[Diagnostic] = []
    for p in ALL_PASSES:
        try:
            diags.extend(p(engine_graph, facts))
        except Exception:  # a broken pass must not block the run
            continue
    return sort_diagnostics(diags)


def explain(graph: Any = None, optimize: int | None = None) -> ExecutionPlan:
    """Compile (but do not run) the execution plan for a captured graph
    — default: the global parse graph at the default/env optimization
    level.  Returns the :class:`ExecutionPlan` audit trail; ``print()``
    it for the golden-tested textual form."""
    if graph is None:
        from pathway_tpu_torch.internals.parse_graph import G

        graph = G.engine_graph
    engine_graph = getattr(graph, "engine_graph", graph)
    _, plan = optimize_graph(engine_graph, resolve_level(optimize))
    return plan


def lint_file(path: str) -> list[Diagnostic]:
    """Execute a pipeline script with ``pw.run``/``run_all`` stubbed to
    no-ops so the graph gets BUILT but never executed, then analyze it."""
    import runpy

    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.internals.parse_graph import G

    saved_run, saved_run_all = run_mod.run, run_mod.run_all

    def _no_run(*a: Any, **k: Any) -> None:
        return None

    G.clear()
    run_mod.run = _no_run  # type: ignore[assignment]
    run_mod.run_all = _no_run  # type: ignore[assignment]
    import pathway_tpu_torch as pw

    pw_run, pw_run_all = pw.run, pw.run_all
    pw.run = _no_run  # type: ignore[assignment]
    pw.run_all = _no_run  # type: ignore[assignment]
    try:
        runpy.run_path(path, run_name="__main__")
        return analyze()
    finally:
        run_mod.run = saved_run  # type: ignore[assignment]
        run_mod.run_all = saved_run_all  # type: ignore[assignment]
        pw.run = pw_run  # type: ignore[assignment]
        pw.run_all = pw_run_all  # type: ignore[assignment]
