"""Inspectable execution plans for the graph-rewriting optimizer.

Every rewrite the optimizer (``analysis/rewrite.py``) applies is
recorded as a :class:`RewriteStep` inside an :class:`ExecutionPlan`.
The plan is the *audit trail* of the static half of columnar execution:
``pw.explain()`` returns one (the JAX package's ``cli lint --plan``
prints one), and the
textual format below is committed as golden files
(``tests/plans/*.txt``) so any plan change shows up as a reviewable
diff.

Format stability contract: node labels are ``{name}#{id}`` (ids are
creation-order per graph, deterministic for a deterministic build
script), steps are listed in application order, and detail strings are
built only from sorted/stable inputs.  Nothing in the format depends on
the native module being present — pass *decisions* are made on the
native-free lint lowering, native code generation is best-effort.
"""

from __future__ import annotations

from typing import Any

__all__ = ["RewriteStep", "ExecutionPlan"]


class RewriteStep:
    """One applied rewrite: which pass, which nodes, what changed."""

    __slots__ = ("pass_name", "nodes", "detail")

    def __init__(self, pass_name: str, nodes: list[str], detail: str = ""):
        self.pass_name = pass_name
        self.nodes = list(nodes)
        self.detail = detail

    def format(self) -> str:
        where = " + ".join(self.nodes)
        return f"{self.pass_name}: {where}" + (
            f" [{self.detail}]" if self.detail else ""
        )

    def __repr__(self) -> str:
        return f"RewriteStep({self.format()!r})"


class ExecutionPlan:
    """The optimizer's output: rewritten-graph summary + step log.

    ``counters()`` (rewrite count per pass) feeds ``/status`` →
    ``plan``, the ``pathway_tpu_plan_rewrites`` gauge on ``/metrics``,
    and the JAX package's bench artifact.  ``format()`` is the
    golden-tested text.
    """

    def __init__(self, level: int):
        self.level = int(level)
        self.steps: list[RewriteStep] = []
        self.nodes_before = 0
        self.nodes_after = 0
        #: per-operator columnar decisions: (node_label, path, reason)
        #: where path is "columnar" or "row" and reason explains a row
        #: fallback (empty for columnar).  Golden-tested like steps.
        self.columnar: list[tuple[str, str, str]] = []

    def record(self, pass_name: str, nodes: list[Any], detail: str = "") -> None:
        """Append one step; ``nodes`` may be engine nodes (labelled
        ``{name}#{id}``) or pre-formatted strings."""
        labels = [
            n if isinstance(n, str) else f"{n.name}#{n.id}" for n in nodes
        ]
        self.steps.append(RewriteStep(pass_name, labels, detail))

    def record_columnar(self, node: Any, path: str, reason: str = "") -> None:
        """Record one operator's batch-execution decision ("columnar" =
        frame segments run native kernels; "row" = the operator
        materializes frames and runs row-at-a-time, with ``reason``)."""
        label = node if isinstance(node, str) else f"{node.name}#{node.id}"
        self.columnar.append((label, path, reason))

    def columnar_lines(self) -> list[str]:
        """The per-operator decision lines (shared by ``format()`` and
        the ``/status`` plan block)."""
        return [
            f"{label}: {path}" + (f" [{reason}]" if reason else "")
            for label, path, reason in self.columnar
        ]

    def counters(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.steps:
            out[s.pass_name] = out.get(s.pass_name, 0) + 1
        return out

    def count(self, pass_name: str) -> int:
        return self.counters().get(pass_name, 0)

    def format(self) -> str:
        lines = [
            f"== execution plan (optimize={self.level}) ==",
            f"nodes: {self.nodes_before} -> {self.nodes_after}",
        ]
        if not self.steps:
            lines.append("(no rewrites)")
        else:
            width = len(str(len(self.steps)))
            for i, s in enumerate(self.steps, 1):
                lines.append(f"{str(i).rjust(width)}. {s.format()}")
        counters = self.counters()
        if counters:
            lines.append(
                "counters: "
                + " ".join(f"{k}={v}" for k, v in sorted(counters.items()))
            )
        if self.columnar:
            lines.append("columnar:")
            lines.extend("  " + ln for ln in self.columnar_lines())
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()

    def __repr__(self) -> str:
        return (
            f"<ExecutionPlan level={self.level} steps={len(self.steps)} "
            f"nodes={self.nodes_before}->{self.nodes_after}>"
        )
