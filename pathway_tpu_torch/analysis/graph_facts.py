"""Per-operator dataflow facts over the engine graph.

One forward pass in topological order (node creation order — inputs are
always registered before consumers, ``EngineGraph.register``) derives,
per node:

- **streaming**: transitively fed by a live connector
  (``InputNode.subject is not None``) — the "hot path" predicate for
  PW-P001 and the precondition for PW-S001.
- **unbounded**: streaming AND no windowing construct upstream bounds
  the key space.  Window markers (``TemporalBehaviorNode``,
  ``SessionAssignNode``, the ``window_assign`` rowwise stage, a groupby
  keyed on ``_pw_window``) clear the flag; stateful consumers
  (groupby/join) re-clear it after being reported once so a single
  missing window doesn't cascade a diagnostic per downstream operator.
- **append_only**: the node's output stream provably carries no
  retractions (reference ``ColumnProperties.append_only``,
  ``src/engine/graph.rs:374``).

A backward pass marks **reaches_sink** (OutputNode / ExportNode /
CaptureNode) for the nullability lint.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import graph as eg

#: engine-graph classes recognised by *name* so this module never has to
#: import stdlib/temporal (which imports table, which imports half the
#: package) — markers that bound stateful operators' key space
_WINDOW_MARKERS = {"TemporalBehaviorNode", "SessionAssignNode"}

#: node classes whose output preserves append-only-ness of ALL inputs
_APPEND_PRESERVING = {
    "RowwiseNode",
    "FilterNode",
    "FlattenNode",
    "ReindexNode",
    "ConcatNode",
    "IntersectNode",
    "ZipNode",
    "AsyncMapNode",
}

#: node classes that can emit retractions even over append-only inputs
_RETRACTING = {
    "SubtractNode",
    "UpdateRowsNode",
    "UpdateCellsNode",
    "GroupByNode",
    "DeduplicateNode",
    "SortNode",
    "GradualBroadcastNode",
    "IxNode",
}

_SINKS = {"OutputNode", "ExportNode", "CaptureNode"}


class GraphFacts:
    def __init__(self, graph: eg.EngineGraph):
        self.graph = graph
        nodes = graph.nodes
        self.consumers: dict[int, list[eg.Node]] = {n.id: [] for n in nodes}
        for n in nodes:
            for inp in n.inputs:
                self.consumers.setdefault(inp.id, []).append(n)

        self.streaming: set[int] = set()
        self.unbounded: set[int] = set()
        self.append_only: set[int] = set()
        self.reaches_sink: set[int] = set()

        for n in nodes:
            cls = type(n).__name__
            in_streaming = any(i.id in self.streaming for i in n.inputs)
            in_unbounded = any(i.id in self.unbounded for i in n.inputs)
            in_append = all(i.id in self.append_only for i in n.inputs)

            if isinstance(n, eg.InputNode):
                live = n.subject is not None
                if live:
                    self.streaming.add(n.id)
                    self.unbounded.add(n.id)
                # upsert sessions overwrite by key -> retractions
                if not n.upsert:
                    self.append_only.add(n.id)
                continue

            if in_streaming:
                self.streaming.add(n.id)

            windowing = (
                cls in _WINDOW_MARKERS
                or n.name == "window_assign"
                # stdlib/temporal builders annotate their nodes with
                # meta["temporal"]["bounded"]: windowed/watermark-evicted
                # constructs (interval/asof joins, behaviors, window
                # assignment) bound downstream key spaces and must not
                # fall through analysis as opaque
                or bool(n.meta.get("temporal", {}).get("bounded"))
            )
            if isinstance(n, eg.GroupByNode):
                grouping = n.meta.get("groupby", {}).get("grouping", ())
                if "_pw_window" in grouping:
                    windowing = True
            if windowing:
                in_unbounded = False
            elif isinstance(n, (eg.GroupByNode, eg.JoinNode)):
                # stateful: the PW-S001 pass reports it when unbounded;
                # its (aggregated) output counts as accounted-for either
                # way, so one missing window yields ONE diagnostic
                in_unbounded = False
            if in_unbounded:
                self.unbounded.add(n.id)

            if isinstance(n, eg.JoinNode):
                if in_append and getattr(n, "kind", "inner") == "inner":
                    self.append_only.add(n.id)
            elif cls in _RETRACTING:
                pass
            elif cls in _APPEND_PRESERVING or cls in _SINKS:
                if in_append:
                    self.append_only.add(n.id)
            # unknown classes: conservatively not append-only

        # backward: which nodes can reach a sink
        work = [n for n in nodes if type(n).__name__ in _SINKS]
        seen = {n.id for n in work}
        while work:
            n = work.pop()
            self.reaches_sink.add(n.id)
            for inp in n.inputs:
                if inp.id not in seen:
                    seen.add(inp.id)
                    work.append(inp)

    @property
    def distribution(self):
        """Lazily-built partition/order facts (analysis/distribution.py),
        shared by every pass that consults them."""
        cached = getattr(self, "_distribution", None)
        if cached is None:
            from pathway_tpu_torch.analysis.distribution import DistributionFacts

            cached = self._distribution = DistributionFacts(self.graph, self)
        return cached

    def is_stateful_unbounded(self, n: eg.Node) -> bool:
        """True when ``n`` is a groupby/join holding per-key state over a
        live source with nothing upstream bounding the key space."""
        if not isinstance(n, (eg.GroupByNode, eg.JoinNode)):
            return False
        if isinstance(n, eg.GroupByNode):
            grouping = n.meta.get("groupby", {}).get("grouping", ())
            if "_pw_window" in grouping:
                return False
        return any(i.id in self.unbounded for i in n.inputs)


def used_columns(node: eg.Node) -> "set[str] | None":
    """Input column names this consumer reads, from build-time meta;
    None when the consumer is not analyzable (treat as uses-everything)."""
    meta = node.meta
    if "used_cols" in meta:
        return set(meta["used_cols"])
    return None
