"""Distribution-safety pass: partition + order lattices over the graph.

Multi-worker execution is only correct when two properties line up with
what each operator assumes:

- **placement** — how a node's output rows are spread across workers:

  - ``("single",)``   one worker owns the whole stream
  - ``("repl",)``     replicated (static rows exist on every worker)
  - ``("key", None)`` partitioned by row-key hash
  - ``("cols", (c, ...))`` co-partitioned by the named columns
  - ``("byterange",)`` static files split by byte offset (PR 9)
  - ``("rr",)``       round-robin / unknown interleave

- **ordered** — whether per-key arrival order is preserved.  Byte-range
  file splits put two updates for the same key on different ranks, so
  the downstream exchange can deliver them in either order.

Sources declare both via ``node.meta["source"]`` (stamped by
``io/_connector.py`` from ``RowSource.partitioning`` /
``order_preserving``); exchanges (groupby/join/dedup routing, the
route-to-zero operators) transform them.  One forward pass computes the
fixpoint-free lattice (the graph is a DAG in topological order), then
four checks read it:

- PW-X001 (error): order-sensitive stateful operator (keyed upsert into
  an index, ``deduplicate``, asof join) fed by a non-order-preserving
  partitioned source.
- PW-X002 (warning): streaming join/groupby whose input is partitioned
  but not co-partitioned with its keys — a full exchange on the hot
  path, with estimated per-row exchange volume.
- PW-X003 (error): arrival-order-dependent reducer over an unordered
  stream feeding a sink — recovered runs are not byte-identical (PR 8).
- PW-R001 (error): node holding out-of-band state (adapter/writer) whose
  class overrides neither ``snapshot_state`` nor ``on_restore`` — a
  checkpoint-coverage hole that duplicates work on replay.
- PW-R002 (warning): single-owner stateful serving/index node with no
  snapshot-backed standby — correctness survives a crash (PW-R001's
  territory) but *availability* does not: every query against it fails
  until recovery completes.  Shard the index
  (:class:`~pathway_tpu_torch.serving.failover.PartitionedIndex`) or stamp
  ``node.meta["failover"] = {"standby": True}`` once a snapshot-backed
  standby actually serves during recovery.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import dtype as dt

from pathway_tpu_torch.analysis.diagnostics import SEV_ERROR, SEV_WARNING, Diagnostic
from pathway_tpu_torch.analysis.graph_facts import GraphFacts

# placement lattice constants
SINGLE = ("single",)
REPL = ("repl",)
KEY = ("key", None)
BYTERANGE = ("byterange",)
RR = ("rr",)

#: placements under which no cross-worker hazard exists
_LOCAL = (SINGLE, REPL)

#: operators that collapse their output onto worker 0
_ROUTE_TO_ZERO = {
    "AsyncMapNode",
    "OutputNode",
    "ExportNode",
    "CaptureNode",
    "GradualBroadcastNode",
    "ExternalIndexNode",
}

#: reducer impl names whose result depends on per-key ARRIVAL ORDER
#: (pathway_tpu_torch/reducers.py); sum/min/max/count/... are commutative,
#: sorted_tuple canonicalises, these do not
_ORDER_DEPENDENT_REDUCERS = {"any", "earliest", "latest", "tuple", "ndarray"}


def _reducer_order_dependent(name: str) -> bool:
    return (
        name in _ORDER_DEPENDENT_REDUCERS
        or name.startswith("stateful_")
        or name.startswith("udf_reducer_")
    )


def _source_placement(meta: dict) -> tuple:
    p = meta.get("partitioning", "single")
    if p == "static":
        return REPL
    if p == "byte-range":
        return BYTERANGE
    if p == "key":
        return KEY
    if p == "round-robin":
        return RR
    return SINGLE


class DistributionFacts:
    """Per-node placement + order facts (one forward pass, creation
    order is topological — ``EngineGraph.register``)."""

    def __init__(self, graph: eg.EngineGraph, facts: GraphFacts):
        self.graph = graph
        self.facts = facts
        self.placement: dict[int, tuple] = {}
        self.ordered: dict[int, bool] = {}
        #: node id of the first order-breaking source upstream (messages)
        self.order_breaker: dict[int, int | None] = {}

        for n in graph.nodes:
            cls = type(n).__name__
            ins = list(n.inputs)
            in_ordered = all(self.ordered.get(i.id, True) for i in ins)
            breaker = next(
                (
                    self.order_breaker.get(i.id)
                    for i in ins
                    if self.order_breaker.get(i.id) is not None
                ),
                None,
            )

            if isinstance(n, eg.InputNode):
                src = n.meta.get("source", {})
                self.placement[n.id] = _source_placement(src)
                ordered = bool(src.get("order_preserving", True))
                self.ordered[n.id] = ordered
                self.order_breaker[n.id] = None if ordered else n.id
                continue

            if isinstance(n, eg.GroupByNode):
                grouping = tuple(n.meta.get("groupby", {}).get("grouping", ()))
                # exchange by group key: one worker owns each group, and
                # its output per group is emitted in processing order
                place = ("cols", grouping) if grouping else SINGLE
            elif isinstance(n, eg.JoinNode):
                on = n.meta.get("join", {}).get("on", ())
                lcols = tuple(ln for ln, _ld, _rn, _rd in on)
                place = ("cols", lcols) if lcols and "<expr>" not in lcols else KEY
            elif isinstance(n, eg.DeduplicateNode):
                place = KEY  # exchanged by instance hash
            elif cls in _ROUTE_TO_ZERO:
                place = SINGLE
            else:
                places = {self.placement.get(i.id, SINGLE) for i in ins}
                if len(places) == 1:
                    place = places.pop()
                elif places <= set(_LOCAL):
                    place = RR if SINGLE not in places else SINGLE
                else:
                    place = RR
            self.placement[n.id] = place
            self.ordered[n.id] = in_ordered
            self.order_breaker[n.id] = breaker

    # ------------------------------------------------------------------
    def co_partitioned(self, node: eg.Node, keys: tuple) -> bool:
        """True when ``node``'s output needs no exchange to be grouped /
        joined by ``keys`` (already local, or already split by exactly
        those columns)."""
        p = self.placement.get(node.id, SINGLE)
        if p in _LOCAL:
            return True
        return p[0] == "cols" and tuple(p[1]) == tuple(keys)


_WIDTHS = {dt.INT: 8, dt.FLOAT: 8, dt.BOOL: 8, dt.POINTER: 8, dt.STR: 32}


def _row_width(node: eg.Node) -> int | None:
    """Estimated bytes/row of ``node``'s output, from the nearest
    build-time dtype annotation upstream; None when unannotated."""
    work = [node]
    seen: set[int] = set()
    while work:
        n = work.pop(0)
        if n.id in seen:
            continue
        seen.add(n.id)
        dtypes = n.meta.get("select", {}).get("dtypes") or n.meta.get(
            "source", {}
        ).get("dtypes")
        if dtypes:
            return sum(
                _WIDTHS.get(d.strip_optional() if isinstance(d, dt.DType) else d, 24)
                for d in dtypes
            )
        work.extend(n.inputs)
    return None


def _diag(code: str, sev: str, msg: str, node: eg.Node, **details: Any) -> Diagnostic:
    return Diagnostic(
        code=code,
        severity=sev,
        message=msg,
        trace=getattr(node, "trace", "") or "",
        node_id=node.id,
        node_name=node.name,
        details=details,
    )


def _breaker_desc(dist: DistributionFacts, nid: int | None) -> str:
    if nid is None:
        return "an unordered upstream"
    for n in dist.graph.nodes:
        if n.id == nid:
            src = n.meta.get("source", {})
            part = src.get("partitioning", "?")
            return f"source {n.name}#{n.id} ({part}-partitioned)"
    return f"node #{nid}"


# ---------------------------------------------------------------------------
# PW-X001: order-sensitive operator over an unordered partitioned stream


def _order_sensitive_inputs(n: eg.Node) -> "list[tuple[int, str]]":
    """(input index, what-it-is) pairs whose per-key arrival order this
    operator's semantics depend on; empty when order-insensitive."""
    meta = n.meta
    if isinstance(n, eg.DeduplicateNode) or meta.get("dedup", {}).get(
        "order_sensitive"
    ):
        return [(0, "deduplicate acceptor state")]
    if meta.get("index", {}).get("order_sensitive"):
        return [(0, "keyed upsert into the external index")]
    if meta.get("index_upsert"):
        return [(0, "keyed upsert into an index")]
    kind = meta.get("temporal", {}).get("kind", "")
    if "asof" in kind:
        return [(i, f"{kind} matching") for i in range(len(n.inputs))]
    return []


def check_distribution(
    graph: eg.EngineGraph, facts: GraphFacts
) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    dist = facts.distribution

    for n in graph.nodes:
        # X001 at the source itself: an upsert session dedups by key, so
        # the source IS the order-sensitive consumer of its own split
        if isinstance(n, eg.InputNode):
            src = n.meta.get("source", {})
            if (
                src.get("upsert")
                and not dist.ordered.get(n.id, True)
                and dist.placement.get(n.id) not in _LOCAL
            ):
                out.append(
                    _diag(
                        "PW-X001",
                        SEV_ERROR,
                        f"keyed upsert source {n.name!r} is "
                        f"{src.get('partitioning')}-partitioned and not "
                        "order-preserving: two updates for one key can land "
                        "on different ranks and apply out of order; use a "
                        "single-reader connector (pw.io.python) or an "
                        "order-preserving partitioning",
                        n,
                        partitioning=src.get("partitioning"),
                    )
                )
            continue

        for idx, what in _order_sensitive_inputs(n):
            if idx >= len(n.inputs):
                continue
            inp = n.inputs[idx]
            if dist.ordered.get(inp.id, True):
                continue
            breaker = dist.order_breaker.get(inp.id)
            out.append(
                _diag(
                    "PW-X001",
                    SEV_ERROR,
                    f"{what} depends on per-key arrival order, but its "
                    f"input comes from {_breaker_desc(dist, breaker)} which "
                    "does not preserve cross-rank per-key order in a "
                    "multi-worker run; feed it from an order-preserving "
                    "connector (pw.io.python) or key-partitioned source",
                    n,
                    input=f"{inp.name}#{inp.id}",
                    breaker=breaker,
                )
            )

        # X002: streaming groupby/join not co-partitioned with its keys
        if n.id in facts.streaming:
            if isinstance(n, eg.GroupByNode):
                grouping = tuple(n.meta.get("groupby", {}).get("grouping", ()))
                inp = n.inputs[0] if n.inputs else None
                if inp is not None and not dist.co_partitioned(inp, grouping):
                    out.append(_x002(n, inp, "groupby", grouping, dist))
            elif isinstance(n, eg.JoinNode):
                on = n.meta.get("join", {}).get("on", ())
                lcols = tuple(ln for ln, _ld, _rn, _rd in on)
                rcols = tuple(rn for _ln, _ld, rn, _rd in on)
                for side, inp, cols in (
                    ("left", n.inputs[0] if n.inputs else None, lcols),
                    ("right", n.inputs[1] if len(n.inputs) > 1 else None, rcols),
                ):
                    if inp is not None and not dist.co_partitioned(inp, cols):
                        out.append(_x002(n, inp, f"join ({side} side)", cols, dist))

        # X003: order-dependent reducer over an unordered stream -> sink
        if isinstance(n, eg.GroupByNode) and n.id in facts.reaches_sink:
            inp = n.inputs[0] if n.inputs else None
            if inp is not None and not dist.ordered.get(inp.id, True):
                bad = [
                    r
                    for r in n.meta.get("groupby", {}).get("reducers", ())
                    if _reducer_order_dependent(r)
                ]
                if bad:
                    breaker = dist.order_breaker.get(inp.id)
                    out.append(
                        _diag(
                            "PW-X003",
                            SEV_ERROR,
                            f"reducer(s) {', '.join(sorted(set(bad)))} depend "
                            "on per-key arrival order, but the input stream "
                            f"comes from {_breaker_desc(dist, breaker)}; the "
                            "result reaches a sink, so a recovered run can "
                            "emit different bytes (breaks byte-identical "
                            "recovery) — use a commutative reducer "
                            "(sorted_tuple, min/max/sum) or an "
                            "order-preserving source",
                            n,
                            reducers=sorted(set(bad)),
                            breaker=breaker,
                        )
                    )

    out.extend(_check_recovery_coverage(graph, facts))
    out.extend(_check_failover_coverage(graph, facts))
    return out


def _x002(
    n: eg.Node, inp: eg.Node, kind: str, keys: tuple, dist: DistributionFacts
) -> Diagnostic:
    p = dist.placement.get(inp.id, SINGLE)
    width = _row_width(inp)
    vol = (
        f"; estimated exchange volume ~{width} bytes/row"
        if width is not None
        else ""
    )
    keys_s = ", ".join(keys) if keys else "<row key>"
    return _diag(
        "PW-X002",
        SEV_WARNING,
        f"streaming {kind} keyed on ({keys_s}) is fed by a "
        f"{p[0]}-partitioned input, so every row is exchanged across "
        f"workers on the hot path{vol}; pre-partition the source by the "
        "key or reuse an upstream groupby's partitioning",
        n,
        placement=p[0],
        keys=list(keys),
        row_width=width,
    )


# ---------------------------------------------------------------------------
# PW-R001: checkpoint-coverage holes


def _check_recovery_coverage(
    graph: eg.EngineGraph, facts: GraphFacts
) -> list[Diagnostic]:
    """Out-of-band state (an external adapter or writer handle) is only
    recovered when the node class overrides ``snapshot_state`` /
    ``on_restore`` (engine/scheduler.py ``_enriched_states`` /
    ``_restore_nodes``); plain ``ctx.states`` snapshotting cannot see it,
    so a hole here duplicates already-applied work on replay."""
    out: list[Diagnostic] = []
    for n in graph.nodes:
        if n.id not in facts.streaming:
            continue
        adapter = getattr(n, "adapter", None)
        writer = getattr(n, "writer", None)
        external = adapter is not None or writer is not None or bool(
            n.meta.get("external_state")
        )
        if not external:
            continue
        cls = type(n)
        has_snapshot = cls.snapshot_state is not eg.Node.snapshot_state
        has_restore = cls.on_restore is not eg.Node.on_restore
        if not has_snapshot and not has_restore:
            held = (
                "an external adapter"
                if adapter is not None
                else ("a writer handle" if writer is not None else "external state")
            )
            out.append(
                _diag(
                    "PW-R001",
                    SEV_ERROR,
                    f"{cls.__name__} holds {held} but overrides neither "
                    "snapshot_state nor on_restore: its state is invisible "
                    "to checkpoints, so a restored run replays input into "
                    "already-applied external effects (duplicates)",
                    n,
                )
            )
        elif adapter is not None and not (
            hasattr(adapter, "state_dict") and hasattr(adapter, "load_state_dict")
        ):
            out.append(
                _diag(
                    "PW-R001",
                    SEV_ERROR,
                    f"adapter {type(adapter).__name__} on {cls.__name__} has "
                    "no state_dict/load_state_dict, so snapshot_state cannot "
                    "capture it; the index rebuilt after restore diverges "
                    "from the checkpointed operator state",
                    n,
                    adapter=type(adapter).__name__,
                )
            )
    return out


# ---------------------------------------------------------------------------
# PW-R002: single-owner serving state with no standby


def _check_failover_coverage(
    graph: eg.EngineGraph, facts: GraphFacts
) -> list[Diagnostic]:
    """PW-R001 is about *correctness* after a crash; this is about
    *availability* during one.  A stateful serving/index node whose whole
    state lives on a single rank (SINGLE placement or a route-to-zero
    operator) is a query-surface single point of failure: per-rank
    failover restarts it, but every probe routed to it fails until the
    snapshot restore + tail replay finishes.  A snapshot-backed standby
    (or sharding the index across owners — ``PartitionedIndex``) keeps
    answers flowing, degraded, through that window; graphs that wired one
    up declare it via ``node.meta["failover"]["standby"]``."""
    dist = facts.distribution
    out: list[Diagnostic] = []
    for n in graph.nodes:
        if n.id not in facts.streaming:
            continue
        cls = type(n).__name__
        single_owner = (
            dist.placement.get(n.id, SINGLE) == SINGLE or cls in _ROUTE_TO_ZERO
        )
        if not single_owner:
            continue
        adapter = getattr(n, "adapter", None)
        stateful_serving = (
            bool(n.meta.get("index_upsert"))
            or bool(n.meta.get("index"))
            or (
                adapter is not None
                and hasattr(adapter, "state_dict")
                and hasattr(adapter, "load_state_dict")
            )
        )
        if not stateful_serving:
            continue
        if n.meta.get("failover", {}).get("standby"):
            continue  # a snapshot-backed standby covers the window
        out.append(
            _diag(
                "PW-R002",
                SEV_WARNING,
                f"{cls} holds the only copy of serving/index state on one "
                "rank with no snapshot-backed standby: if that rank dies, "
                "every query against it fails until restore + tail replay "
                "completes; shard it (serving.PartitionedIndex) or attach "
                'a standby and stamp meta["failover"]["standby"]',
                n,
                placement="single",
            )
        )
    return out
