"""Static state-growth & memory-capacity estimation.

Abstract interpretation over the captured engine graph: every operator
gets a **state-growth class** from a four-point lattice

- ``O(1)``      — no retained state (or a constant amount)
- ``O(window)`` — retention bounded by a temporal behavior / window
- ``O(keys)``   — linear in the number of DISTINCT keys (upsert sources,
  fixed-accumulator groupbys, deduplicate, keyed indexes)
- ``O(stream)`` — linear in total rows ingested: the class that turns a
  long-running deployment into an OOM schedule

plus a bytes estimate: per-row widths come from the build-time dtype
annotations (fixed-width scalars are exact; str/bytes/ndarray are
parameterized — constant expressions are measured from their actual
value), retained cardinalities from :class:`GraphFacts` (streaming /
unbounded / append-only) and the numeric parameters of
:class:`EstimateParams`, and the per-worker split from the
``distribution.py`` placement lattice.

The estimator is **plan-aware**: :func:`estimate_memory` runs over the
``optimize_graph`` rewritten view, so dead-column elimination (nulled
``ConstExpression(None)`` select slots) and append-only reducer
specialization (``AppendOnly*`` accumulators replacing row-retaining
multisets) shrink the estimate exactly where they shrink runtime state.

Three registry codes ride on the same model (:func:`check_memory`, part
of ``ALL_PASSES``):

- **PW-M001** (error): ``O(stream)`` operator state on an unbounded
  streaming path that reaches a sink.
- **PW-M002** (warning): estimated footprint exceeds
  ``PATHWAY_MEMORY_BUDGET`` (bytes, or with K/M/G[i]B suffix), with a
  per-operator breakdown in ``details``.
- **PW-M003** (warning): checkpointed ``O(stream)`` state — snapshot
  bytes grow with stream length, eroding recovery-time targets.

Runtime cross-validation closes the loop: the scheduler samples measured
per-operator state bytes (``pathway_tpu_state_bytes{operator}``); the
JAX package's ``bench.py bench_capacity`` records predicted-vs-measured
ratios of the same estimate (this module is its copy).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex

from pathway_tpu_torch.analysis.diagnostics import SEV_ERROR, SEV_WARNING, Diagnostic
from pathway_tpu_torch.analysis.graph_facts import GraphFacts

__all__ = [
    "G_CONSTANT",
    "G_BOUNDED",
    "G_KEYS",
    "G_STREAM",
    "growth_join",
    "dtype_width",
    "EstimateParams",
    "OperatorMemory",
    "MemoryReport",
    "estimate_memory",
    "check_memory",
    "parse_budget",
]

# ---------------------------------------------------------------------------
# the state-growth lattice

G_CONSTANT = "O(1)"
G_BOUNDED = "O(window)"
G_KEYS = "O(keys)"
G_STREAM = "O(stream)"

_G_ORDER = {G_CONSTANT: 0, G_BOUNDED: 1, G_KEYS: 2, G_STREAM: 3}


def growth_join(*growths: str) -> str:
    """Least upper bound on the growth lattice."""
    best = G_CONSTANT
    for g in growths:
        if _G_ORDER.get(g, 0) > _G_ORDER[best]:
            best = g
    return best


def growth_meet(*growths: str) -> str:
    """Greatest lower bound on the growth lattice."""
    best = G_STREAM
    for g in growths:
        if _G_ORDER.get(g, 3) < _G_ORDER[best]:
            best = g
    return best


# ---------------------------------------------------------------------------
# bytes-per-row from dtype annotations

#: exact CPython-object widths for fixed-size scalars (small ints/bools
#: are interned, floats/pointers/datetimes are one 8-byte payload each —
#: container overhead is charged separately per retained entry)
_FIXED_WIDTHS = {
    dt.INT: 8,
    dt.FLOAT: 8,
    dt.BOOL: 8,
    dt.POINTER: 8,
    dt.DURATION: 8,
    dt.DATE_TIME_NAIVE: 8,
    dt.DATE_TIME_UTC: 8,
    dt.NONE: 8,
}

#: per-retained-row container overhead: dict slot + key object + the
#: row tuple header.  Calibrated against ``approx_state_bytes`` samples
#: of the running engine (the JAX package's ``bench.py bench_capacity``
#: cross-validates the two within 3x on the same engine code) — CPython object headers cost real bytes and the
#: estimate must describe THIS engine, not a hypothetical packed one.
ENTRY_OVERHEAD = 300
#: per-group overhead of a groupby entry: the group dict itself plus
#: gvals / accs / count / last_out slots around the accumulators
#: (calibrated the same way; see ENTRY_OVERHEAD)
GROUP_OVERHEAD = 800
#: one fixed-size accumulator object (count/sum/avg/append-only extreme)
ACC_FIXED = 56


def dtype_width(
    d: Any, *, str_bytes: int = 32, array_bytes: int = 256
) -> int:
    """Estimated payload bytes for one value of dtype ``d``; fixed-width
    scalars are exact, str/bytes/ndarray use the parameterized sizes."""
    if isinstance(d, dt.DType):
        d = d.strip_optional()
    w = _FIXED_WIDTHS.get(d)
    if w is not None:
        return w
    if d in (dt.STR, dt.BYTES):
        return str_bytes
    if d == dt.JSON:
        return 4 * str_bytes
    if d == dt.ANY_ARRAY or "Array" in type(d).__name__:
        return array_bytes
    return 24  # ANY / unannotated: a small boxed object


def _expr_width(expr: Any, declared: Any, params: "EstimateParams") -> int:
    """Width of one select column: constant expressions are measured
    from the actual value (the VM program is LOAD_CONST), everything
    else falls back to the declared dtype."""
    if type(expr) is ex.ConstExpression:
        v = expr._value
        if isinstance(v, (str, bytes)):
            return 49 + len(v)  # CPython str/bytes header + payload
    return dtype_width(
        declared, str_bytes=params.str_bytes, array_bytes=params.array_bytes
    )


def _is_nulled(expr: Any) -> bool:
    """A select slot the plan compiler dead-column-eliminated: replaced
    by a constant-None expression that is never computed or retained."""
    return type(expr) is ex.ConstExpression and expr._value is None


# ---------------------------------------------------------------------------
# parameters

@dataclass(frozen=True)
class EstimateParams:
    """Numeric scenario the symbolic growth classes are evaluated at.

    ``rows`` is total stream length, ``distinct_keys`` the live key
    cardinality, ``window_rows`` the rows a behavior/window keeps live,
    ``static_rows`` the size assumed for static (batch) sources."""

    rows: int = 1_000_000
    distinct_keys: int = 10_000
    window_rows: int = 10_000
    static_rows: int = 10_000
    str_bytes: int = 32
    array_bytes: int = 256
    workers: int = 1

    @classmethod
    def from_env(cls, **overrides: Any) -> "EstimateParams":
        def _i(name: str, default: int) -> int:
            v = os.environ.get(name, "").strip()
            try:
                return int(v) if v else default
            except ValueError:
                return default

        base = cls(
            rows=_i("PATHWAY_MEMORY_ROWS", cls.rows),
            distinct_keys=_i("PATHWAY_MEMORY_KEYS", cls.distinct_keys),
            window_rows=_i("PATHWAY_MEMORY_WINDOW_ROWS", cls.window_rows),
            static_rows=_i("PATHWAY_MEMORY_STATIC_ROWS", cls.static_rows),
            str_bytes=_i("PATHWAY_MEMORY_STR_BYTES", cls.str_bytes),
            array_bytes=_i("PATHWAY_MEMORY_ARRAY_BYTES", cls.array_bytes),
            workers=_i("PATHWAY_MEMORY_WORKERS", cls.workers),
        )
        clean = {k: v for k, v in overrides.items() if v is not None}
        return replace(base, **clean) if clean else base

    def cardinality(self, growth: str) -> int:
        """Retained-entry count a growth class evaluates to here."""
        if growth == G_STREAM:
            return self.rows
        if growth == G_KEYS:
            return self.distinct_keys
        if growth == G_BOUNDED:
            return self.window_rows
        return 0


def parse_budget(s: "str | None") -> "int | None":
    """``PATHWAY_MEMORY_BUDGET`` value -> bytes: a plain integer or a
    K/M/G/T with optional i/iB/B suffix (decimal and binary both read as
    binary — capacity planning rounds the safe way)."""
    if not s:
        return None
    t = s.strip().upper().removesuffix("IB").removesuffix("B").removesuffix("I")
    mult = 1
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30), ("T", 1 << 40)):
        if t.endswith(suffix):
            t = t[: -len(suffix)]
            mult = m
            break
    try:
        return int(float(t) * mult)
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# the per-operator model

@dataclass(frozen=True)
class OperatorMemory:
    """One stateful operator's estimate."""

    node_id: int
    name: str
    kind: str
    growth: str
    total_bytes: int
    per_worker_bytes: int
    placement: str
    #: column names whose widths the estimate counted (from the nearest
    #: select upstream); plan-nulled dead columns are absent
    columns: tuple[str, ...]
    detail: str
    checkpointed: bool


@dataclass(frozen=True)
class MemoryReport:
    """The ``pw.estimate_memory()`` capacity report."""

    operators: tuple[OperatorMemory, ...]
    total_bytes: int
    max_worker_bytes: int
    workers: int
    level: int
    growth: str
    params: EstimateParams

    def by_id(self) -> dict[int, OperatorMemory]:
        return {o.node_id: o for o in self.operators}

    def format(self) -> str:
        lines = [
            f"memory capacity estimate (optimize={self.level}, "
            f"workers={self.workers}, rows={self.params.rows}, "
            f"keys={self.params.distinct_keys})",
            f"{'operator':<28} {'growth':<10} {'bytes':>12} "
            f"{'per-worker':>12}  detail",
            "-" * 88,
        ]
        for o in sorted(
            self.operators, key=lambda o: o.total_bytes, reverse=True
        ):
            cols = f" [{', '.join(o.columns)}]" if o.columns else ""
            lines.append(
                f"{o.name + '#' + str(o.node_id):<28} {o.growth:<10} "
                f"{o.total_bytes:>12} {o.per_worker_bytes:>12}  "
                f"{o.detail}{cols}"
            )
        lines.append("-" * 88)
        lines.append(
            f"{'TOTAL':<28} {self.growth:<10} {self.total_bytes:>12} "
            f"{self.max_worker_bytes:>12}  (per-worker = hottest rank)"
        )
        return "\n".join(lines)


#: reducer impl classes whose accumulator is a fixed-size object — the
#: append-only variants keep their user-facing ``.name`` (min/max/...),
#: so classification MUST look at the instance type, which is what the
#: plan compiler's ``specialize_append_only`` actually swaps
_FIXED_ACC_CLASSES = {"CountReducer", "SumReducer", "AvgReducer", "NpSumReducer"}

#: reducer NAMES with fixed accumulators — fallback when a node carries
#: only build-time meta (name-based: cannot see plan specialization)
_FIXED_ACC_NAMES = {"count", "sum", "avg", "npsum"}

#: node classes that retain one entry per live input row, keyed by row
#: key (set ops, cell/row patches, sort/ix neighborhood state, ...)
_ROW_RETAINERS = {
    "IntersectNode",
    "SubtractNode",
    "UpdateRowsNode",
    "UpdateCellsNode",
    "ZipNode",
    "SortNode",
    "IxNode",
    "GradualBroadcastNode",
}

#: temporal buffer nodes: retention bounded by the behavior itself
_BOUNDED_BUFFERS = {"TemporalBehaviorNode", "SessionAssignNode"}


def _retaining_reducers(n: eg.Node) -> tuple[int, int]:
    """(fixed_acc_count, row_retaining_count) for a groupby node,
    classified from the LIVE reducer instances when present (plan-aware:
    ``AppendOnly*`` swaps land there), meta names otherwise."""
    args = getattr(n, "reducer_args", None)
    if args:
        fixed = retaining = 0
        for impl, _arg_fn in args:
            cls = type(impl).__name__
            if cls in _FIXED_ACC_CLASSES or cls.startswith("AppendOnly"):
                fixed += 1
            else:
                retaining += 1
        return fixed, retaining
    names = n.meta.get("groupby", {}).get("reducers", ())
    fixed = sum(1 for nm in names if nm in _FIXED_ACC_NAMES)
    return fixed, max(0, len(names) - fixed)


class _Estimator:
    """One forward pass over the graph: output-cardinality growth per
    node, then per-class state models."""

    def __init__(
        self, graph: eg.EngineGraph, facts: GraphFacts, params: EstimateParams
    ):
        self.graph = graph
        self.facts = facts
        self.params = params
        #: growth class of each node's OUTPUT cardinality (live rows)
        self.out_growth: dict[int, str] = {}
        #: numeric evaluation of that cardinality under ``params``
        self.out_rows: dict[int, int] = {}
        self._layout_cache: dict[int, tuple[tuple[str, ...], int]] = {}
        for n in graph.nodes:
            self._forward(n)

    # -- output cardinality -------------------------------------------
    def _forward(self, n: eg.Node) -> None:
        p = self.params
        if isinstance(n, eg.InputNode):
            if n.subject is not None:
                if n.upsert:
                    g, r = G_KEYS, p.distinct_keys
                else:
                    g, r = G_STREAM, p.rows
            else:
                g, r = G_CONSTANT, p.static_rows
        elif isinstance(n, eg.GroupByNode):
            g, r = self._groups_of(n)
        elif isinstance(n, eg.DeduplicateNode):
            gi, ri = self._in_card(n)
            g = growth_meet(gi, G_KEYS)
            r = min(ri, p.distinct_keys)
        elif isinstance(n, eg.JoinNode):
            g, r = self._in_card(n)
        else:
            g, r = self._in_card(n)
        self.out_growth[n.id] = g
        self.out_rows[n.id] = r

    def _in_card(self, n: eg.Node) -> tuple[str, int]:
        if not n.inputs:
            return G_CONSTANT, 0
        g = growth_join(*(self.out_growth.get(i.id, G_CONSTANT) for i in n.inputs))
        r = max(self.out_rows.get(i.id, 0) for i in n.inputs)
        return g, r

    def _groups_of(self, n: eg.Node) -> tuple[str, int]:
        """Live-group cardinality of a groupby: distinct keys over an
        unbounded input, window-bounded under a behavior, input-bounded
        over static data."""
        p = self.params
        gi, ri = self._in_card(n)
        if any(i.id in self.facts.unbounded for i in n.inputs):
            return G_KEYS, p.distinct_keys
        if any(i.id in self.facts.streaming for i in n.inputs):
            # streaming but bounded upstream (window/behavior)
            return growth_meet(gi, G_BOUNDED), min(ri, p.window_rows)
        return growth_meet(gi, G_KEYS), min(ri, p.distinct_keys)

    # -- row layout ----------------------------------------------------
    def row_layout(self, node: eg.Node) -> tuple[tuple[str, ...], int]:
        """(counted column names, bytes/row) from the nearest select or
        source dtype annotation upstream; plan-nulled select slots are
        skipped — they carry a shared ``None``, not a value."""
        cached = self._layout_cache.get(node.id)
        if cached is not None:
            return cached
        p = self.params
        out: tuple[tuple[str, ...], int] = ((), 3 * 24)  # unannotated
        work = [node]
        seen: set[int] = set()
        while work:
            n = work.pop(0)
            if n.id in seen:
                continue
            seen.add(n.id)
            sel = n.meta.get("select")
            if sel and sel.get("dtypes"):
                names: list[str] = []
                width = 0
                exprs = sel.get("exprs", ())
                for i, (nm, d) in enumerate(
                    zip(sel.get("names", ()), sel["dtypes"])
                ):
                    e = exprs[i] if i < len(exprs) else None
                    if e is not None and _is_nulled(e):
                        continue
                    names.append(nm)
                    width += _expr_width(e, d, p)
                out = (tuple(names), max(width, 8))
                break
            src = n.meta.get("source", {})
            if src.get("dtypes"):
                width = sum(
                    dtype_width(
                        d, str_bytes=p.str_bytes, array_bytes=p.array_bytes
                    )
                    for d in src["dtypes"]
                )
                out = ((), max(width, 8))
                break
            work.extend(n.inputs)
        self._layout_cache[node.id] = out
        return out

    # -- per-node state model -----------------------------------------
    def estimate_node(
        self, n: eg.Node
    ) -> "tuple[str, int, tuple[str, ...], str] | None":
        """(growth, total bytes, counted columns, detail) for a stateful
        node; None for stateless operators."""
        p = self.params
        cls = type(n).__name__

        if isinstance(n, eg.InputNode):
            if not n.upsert:
                return None  # append sessions never populate state
            g, r = self.out_growth[n.id], self.out_rows[n.id]
            cols, w = self.row_layout(n)
            return (
                growth_meet(g, G_KEYS),
                r * (w + ENTRY_OVERHEAD),
                cols,
                f"upsert session: {r} keys x {w + ENTRY_OVERHEAD} B",
            )

        if isinstance(n, eg.GroupByNode):
            gg, groups = self._groups_of(n)
            fixed, retaining = _retaining_reducers(n)
            key_cols = tuple(n.meta.get("groupby", {}).get("grouping", ()))
            _in_cols, in_w = self.row_layout(n.inputs[0]) if n.inputs else ((), 24)
            out_cols, out_w = self.row_layout(n)
            per_group = GROUP_OVERHEAD + out_w + fixed * ACC_FIXED
            total = groups * per_group
            growth = gg
            detail = (
                f"{groups} groups x {per_group} B "
                f"({fixed} fixed acc{'s' if fixed != 1 else ''}"
            )
            if retaining:
                gi, ri = self._in_card(n)
                growth = growth_join(gg, gi)
                retained = max(ri, groups)
                total += retaining * retained * (in_w + ENTRY_OVERHEAD)
                detail += (
                    f", {retaining} row-retaining x {retained} rows"
                )
            detail += ")"
            return growth, total, out_cols or key_cols, detail

        if isinstance(n, eg.JoinNode):
            if n.meta.get("temporal", {}).get("bounded"):
                g = G_BOUNDED
                sides = [(G_BOUNDED, p.window_rows)] * 2
            else:
                sides = [
                    (
                        self.out_growth.get(i.id, G_CONSTANT),
                        self.out_rows.get(i.id, 0),
                    )
                    for i in n.inputs
                ]
                g = growth_join(*(sg for sg, _ in sides))
            total = 0
            for inp, (_sg, sr) in zip(n.inputs, sides):
                _c, w = self.row_layout(inp)
                total += sr * (w + ENTRY_OVERHEAD)
            cols, _w = self.row_layout(n)
            rows = " + ".join(str(sr) for _sg, sr in sides)
            return g, total, cols, f"join retains both sides: {rows} rows"

        if cls == "IntervalJoinNode":
            # both sides buffer only rows inside the time band: the
            # watermark evicts everything older, so retention is the
            # window, not the stream
            total = 0
            for inp in n.inputs:
                _c, w = self.row_layout(inp)
                total += p.window_rows * (w + ENTRY_OVERHEAD)
            cols, _w = self.row_layout(n)
            return (
                G_BOUNDED,
                total,
                cols,
                f"time-band buffer: {p.window_rows} rows/side",
            )

        if cls in ("AsofJoinNode", "AsofNowJoinNode"):
            # retains the live right-side history (sorted per key) plus
            # the per-left-row answer cache: entries track live input
            # rows, so growth follows the inputs — an append-only raw
            # stream makes this linear even though RESULTS are frozen
            total = 0
            rows: list[int] = []
            for inp in n.inputs:
                _c, w = self.row_layout(inp)
                r = self.out_rows.get(inp.id, 0)
                total += r * (w + ENTRY_OVERHEAD)
                rows.append(r)
            g = growth_join(
                *(self.out_growth.get(i.id, G_CONSTANT) for i in n.inputs)
            )
            cols, _w = self.row_layout(n)
            return (
                g,
                total,
                cols,
                "asof retains live inputs: "
                + " + ".join(str(r) for r in rows)
                + " rows",
            )

        if isinstance(n, eg.DeduplicateNode):
            g, r = self.out_growth[n.id], self.out_rows[n.id]
            cols, w = self.row_layout(n)
            return (
                growth_meet(g, G_KEYS),
                r * (w + ENTRY_OVERHEAD),
                cols,
                f"one kept row per instance: {r} x {w + ENTRY_OVERHEAD} B",
            )

        if cls in _ROW_RETAINERS:
            g, r = self._in_card(n)
            cols, w = self.row_layout(n)
            total = sum(
                self.out_rows.get(i.id, 0) * (w + ENTRY_OVERHEAD)
                for i in n.inputs
            )
            return g, total, cols, f"retains live input rows ({r} max/side)"

        if cls in _BOUNDED_BUFFERS:
            cols, w = self.row_layout(n)
            return (
                G_BOUNDED,
                p.window_rows * (w + ENTRY_OVERHEAD),
                cols,
                f"behavior buffer: {p.window_rows} rows",
            )

        if cls == "ExternalIndexNode":
            # keyed upsert into the index: one entry per live doc id
            g = growth_meet(
                self.out_growth.get(n.inputs[0].id, G_KEYS) if n.inputs else G_KEYS,
                G_KEYS,
            )
            r = min(
                self.out_rows.get(n.inputs[0].id, p.distinct_keys)
                if n.inputs
                else p.distinct_keys,
                p.distinct_keys,
            )
            cols, w = self.row_layout(n.inputs[0]) if n.inputs else ((), 24)
            per = w + p.array_bytes + ENTRY_OVERHEAD
            return g, r * per, cols, f"index: {r} docs x {per} B (payload+vector)"

        if isinstance(n, eg.CaptureNode):
            g, r = self._in_card(n)
            cols, w = self.row_layout(n)
            return g, r * (w + ENTRY_OVERHEAD), cols, f"captures {r} rows"

        return None


def _placement_of(dist: Any, nid: int) -> tuple:
    try:
        return dist.placement.get(nid, ("single",))
    except Exception:
        return ("single",)


def _split_bytes(placement: tuple, total: int, workers: int) -> int:
    """Bytes held by the hottest worker under the placement lattice."""
    if workers <= 1 or placement[0] in ("single", "repl"):
        return total
    return -(-total // workers)  # key/cols/byterange/rr: even split


def build_report(
    engine_graph: eg.EngineGraph,
    facts: "GraphFacts | None" = None,
    *,
    params: "EstimateParams | None" = None,
    level: int = 0,
) -> MemoryReport:
    """Estimate over the graph AS GIVEN (callers resolve plan views)."""
    if facts is None:
        facts = GraphFacts(engine_graph)
    if params is None:
        params = EstimateParams.from_env()
    est = _Estimator(engine_graph, facts, params)
    try:
        dist = facts.distribution
    except Exception:
        dist = None
    ops: list[OperatorMemory] = []
    worker0 = 0
    for n in engine_graph.nodes:
        got = est.estimate_node(n)
        if got is None:
            continue
        growth, total, cols, detail = got
        placement = _placement_of(dist, n.id) if dist is not None else ("single",)
        per_worker = _split_bytes(placement, total, params.workers)
        worker0 += per_worker
        ops.append(
            OperatorMemory(
                node_id=n.id,
                name=n.name,
                kind=type(n).__name__,
                growth=growth,
                total_bytes=total,
                per_worker_bytes=per_worker,
                placement=placement[0],
                columns=cols,
                detail=detail,
                checkpointed=True,  # ctx.states is snapshot territory
            )
        )
    total_bytes = sum(o.total_bytes for o in ops)
    return MemoryReport(
        operators=tuple(ops),
        total_bytes=total_bytes,
        max_worker_bytes=worker0,
        workers=params.workers,
        level=level,
        growth=growth_join(*(o.growth for o in ops)) if ops else G_CONSTANT,
        params=params,
    )


def estimate_memory(
    graph: Any = None,
    *,
    optimize: "int | None" = None,
    rows: "int | None" = None,
    distinct_keys: "int | None" = None,
    window_rows: "int | None" = None,
    static_rows: "int | None" = None,
    str_bytes: "int | None" = None,
    array_bytes: "int | None" = None,
    workers: "int | None" = None,
) -> MemoryReport:
    """Plan-aware capacity report for a captured graph (default: the
    global parse graph at the default/env optimization level, i.e. the
    view that actually runs).  ``optimize=0`` estimates the unrewritten
    graph."""
    if graph is None:
        from pathway_tpu_torch.internals.parse_graph import G

        graph = G.engine_graph
    engine_graph = getattr(graph, "engine_graph", graph)
    from pathway_tpu_torch.analysis.rewrite import optimize_graph, resolve_level

    level = resolve_level(optimize)
    if level > 0:
        engine_graph, _plan = optimize_graph(engine_graph, level)
    params = EstimateParams.from_env(
        rows=rows,
        distinct_keys=distinct_keys,
        window_rows=window_rows,
        static_rows=static_rows,
        str_bytes=str_bytes,
        array_bytes=array_bytes,
        workers=workers,
    )
    return build_report(engine_graph, params=params, level=level)


# ---------------------------------------------------------------------------
# the diagnostics pass (ALL_PASSES member)


def _diag(
    code: str, sev: str, msg: str, node: "eg.Node | None", **details: Any
) -> Diagnostic:
    return Diagnostic(
        code=code,
        severity=sev,
        message=msg,
        trace=getattr(node, "trace", "") or "" if node is not None else "",
        node_id=node.id if node is not None else None,
        node_name=node.name if node is not None else "",
        details=details,
    )


def check_memory(graph: eg.EngineGraph, facts: GraphFacts) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    params = EstimateParams.from_env()
    report = build_report(graph, facts, params=params)
    by_node = {n.id: n for n in graph.nodes}
    for op in report.operators:
        if op.growth != G_STREAM or op.node_id not in facts.streaming:
            continue
        n = by_node.get(op.node_id)
        if n is None:
            continue
        if op.node_id in facts.reaches_sink:
            out.append(
                _diag(
                    "PW-M001",
                    SEV_ERROR,
                    f"operator state is linear in the stream ({op.detail}): "
                    "every ingested row is retained forever on a path that "
                    "reaches a sink; bound it with a window/behavior, an "
                    "upsert-keyed source, or an append-only-safe reducer",
                    n,
                    growth=op.growth,
                    estimated_bytes=op.total_bytes,
                )
            )
        if op.checkpointed:
            out.append(
                _diag(
                    "PW-M003",
                    SEV_WARNING,
                    "checkpointed operator state grows with stream length "
                    f"({op.detail}): snapshot bytes and recovery time "
                    "degrade as the run ages; bound retention or exclude "
                    "the operator from persistence",
                    n,
                    growth=op.growth,
                    estimated_bytes=op.total_bytes,
                )
            )
    budget = parse_budget(os.environ.get("PATHWAY_MEMORY_BUDGET"))
    if budget is not None and report.max_worker_bytes > budget:
        breakdown = [
            (f"{o.name}#{o.node_id}", o.per_worker_bytes)
            for o in sorted(
                report.operators,
                key=lambda o: o.per_worker_bytes,
                reverse=True,
            )[:8]
        ]
        out.append(
            _diag(
                "PW-M002",
                SEV_WARNING,
                f"estimated per-worker footprint "
                f"{report.max_worker_bytes} B exceeds "
                f"PATHWAY_MEMORY_BUDGET={budget} B "
                f"(top: {', '.join(f'{n}={b}B' for n, b in breakdown[:3])})",
                None,
                budget_bytes=budget,
                estimated_bytes=report.max_worker_bytes,
                breakdown=breakdown,
            )
        )
    return out
