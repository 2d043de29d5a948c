"""The diagnostic passes.

Each pass is a pure function ``(graph, facts) -> list[Diagnostic]`` over
the engine graph + the dataflow facts; ``analyze()`` in
``analysis/__init__`` runs them all.  Detection relies on the build-time
``Node.meta`` annotations the table API attaches (expression ASTs,
layouts, declared dtypes) — nodes built outside the table API simply
carry no meta and are skipped, never crashed on.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import dtype as dt

from pathway_tpu_torch.analysis.diagnostics import (
    SEV_ERROR,
    SEV_WARNING,
    Diagnostic,
)
from pathway_tpu_torch.analysis.graph_facts import GraphFacts
from pathway_tpu_torch.analysis import vm_abstract as va

_SINK_CLASSES = {"OutputNode", "ExportNode", "CaptureNode"}


def _diag(
    code: str, sev: str, msg: str, node: eg.Node, **details: Any
) -> Diagnostic:
    return Diagnostic(
        code=code,
        severity=sev,
        message=msg,
        trace=getattr(node, "trace", "") or "",
        node_id=node.id,
        node_name=node.name,
        details=details,
    )


def _bases_compatible(a: dt.DType, b: dt.DType) -> bool:
    """Two dtypes can hold a common value (either direction of the
    lattice order after stripping Optional)."""
    ab, bb = a.strip_optional(), b.strip_optional()
    if ab == dt.ANY or bb == dt.ANY:
        return True
    return dt.is_subtype(ab, bb) or dt.is_subtype(bb, ab)


# ---------------------------------------------------------------------------
# PW-T001 / PW-N001: types and nullability


def check_types(graph: eg.EngineGraph, facts: GraphFacts) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for n in graph.nodes:
        join = n.meta.get("join")
        if join:
            for ln, ld, rn, rd in join.get("on", ()):
                if not (isinstance(ld, dt.DType) and isinstance(rd, dt.DType)):
                    continue
                if not _bases_compatible(ld, rd):
                    out.append(
                        _diag(
                            "PW-T001",
                            SEV_ERROR,
                            f"join key {ln!r} ({ld!r}) cannot match "
                            f"{rn!r} ({rd!r}): no value inhabits both",
                            n,
                            left=repr(ld),
                            right=repr(rd),
                        )
                    )
        concat = n.meta.get("concat")
        if concat:
            for col, dlist in concat.get("columns", {}).items():
                for i in range(1, len(dlist)):
                    if not _bases_compatible(dlist[0], dlist[i]):
                        out.append(
                            _diag(
                                "PW-T001",
                                SEV_ERROR,
                                f"concat column {col!r} mixes {dlist[0]!r} "
                                f"and {dlist[i]!r}",
                                n,
                                column=col,
                            )
                        )
                        break
        sel = n.meta.get("select")
        if sel:
            out.extend(_check_select_types(n, sel, facts))
    return out


def _check_select_types(
    n: eg.Node, sel: dict, facts: GraphFacts
) -> list[Diagnostic]:
    """Abstractly execute each output column's VM program and compare the
    inferred result dtype against the DECLARED one (``expr._dtype`` —
    which ``declare_type`` overrides without changing the bytecode)."""
    out: list[Diagnostic] = []
    layout = sel.get("layout")
    names = sel.get("names", ())
    exprs = sel.get("exprs", ())
    declared_list = sel.get("dtypes", ())
    for name, expr, declared in zip(names, exprs, declared_list):
        if not isinstance(declared, dt.DType):
            continue
        res = va.analyze_expression(expr, layout)
        if res is None:
            continue
        for op, l, r in res.type_conflicts:
            out.append(
                _diag(
                    "PW-T001",
                    SEV_ERROR,
                    f"column {name!r}: operator {op!r} is not defined on "
                    f"{l!r} and {r!r}",
                    n,
                    column=name,
                )
            )
        if not res.ok:
            continue
        inferred = res.result_dtype
        inf_b, dec_b = inferred.strip_optional(), declared.strip_optional()
        if dt.ANY in (inf_b, dec_b) or inferred == dt.NONE:
            continue
        if dt.is_subtype(inferred, declared):
            continue
        if _bases_compatible(inferred, declared):
            # base types agree (or one narrows the other — a legitimate
            # declare_type assertion); the residue is optionality
            if (
                (inferred.is_optional() or inferred == dt.NONE)
                and not declared.is_optional()
                and n.id in facts.reaches_sink
            ):
                out.append(
                    _diag(
                        "PW-N001",
                        SEV_WARNING,
                        f"column {name!r} declared {declared!r} but its "
                        f"program can produce None ({inferred!r}) and the "
                        "value reaches a sink; unwrap or coalesce it",
                        n,
                        column=name,
                        inferred=repr(inferred),
                        declared=repr(declared),
                    )
                )
        else:
            out.append(
                _diag(
                    "PW-T001",
                    SEV_ERROR,
                    f"column {name!r} declared {declared!r} but its program "
                    f"computes {inferred!r}",
                    n,
                    column=name,
                    inferred=repr(inferred),
                    declared=repr(declared),
                )
            )
    return out


# ---------------------------------------------------------------------------
# PW-P001: CALL_PY fallback on a streaming path


def check_call_py(graph: eg.EngineGraph, facts: GraphFacts) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for n in graph.nodes:
        if n.id not in facts.streaming:
            continue
        sel = n.meta.get("select")
        if sel:
            layout = sel.get("layout")
            for name, expr in zip(sel.get("names", ()), sel.get("exprs", ())):
                asm = va.lint_lower(expr, layout)
                if asm is None:
                    continue
                k = va.count_call_py(asm.code)
                if k:
                    out.append(
                        _diag(
                            "PW-P001",
                            SEV_WARNING,
                            f"column {name!r} drops to the Python fallback "
                            f"({k} CALL_PY op{'s' if k > 1 else ''}) on a "
                            "streaming path; every row pays the closure "
                            "call",
                            n,
                            column=name,
                            call_py=k,
                        )
                    )
        flt = n.meta.get("filter")
        if flt:
            layout = flt.get("layout")
            for expr in flt.get("exprs", ()):
                asm = va.lint_lower(expr, layout)
                if asm is None:
                    continue
                k = va.count_call_py(asm.code)
                if k:
                    out.append(
                        _diag(
                            "PW-P001",
                            SEV_WARNING,
                            f"filter predicate drops to the Python fallback "
                            f"({k} CALL_PY op{'s' if k > 1 else ''}) on a "
                            "streaming path",
                            n,
                            call_py=k,
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# PW-S001: unbounded state


def check_unbounded_state(
    graph: eg.EngineGraph, facts: GraphFacts
) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for n in graph.nodes:
        if facts.is_stateful_unbounded(n):
            kind = "join" if isinstance(n, eg.JoinNode) else "groupby"
            out.append(
                _diag(
                    "PW-S001",
                    SEV_WARNING,
                    f"unwindowed {kind} over a streaming source: per-key "
                    "state grows without bound; window the input "
                    "(windowby/sessions) or bound it with a behavior",
                    n,
                )
            )
    return out


# ---------------------------------------------------------------------------
# PW-S002: append-only violations


def check_append_only(
    graph: eg.EngineGraph, facts: GraphFacts
) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for n in graph.nodes:
        if isinstance(n, eg.DeduplicateNode):
            inp = n.inputs[0] if n.inputs else None
            if inp is not None and inp.id not in facts.append_only:
                out.append(
                    _diag(
                        "PW-S002",
                        SEV_ERROR,
                        "deduplicate requires an append-only input, but "
                        f"upstream {inp.name}#{inp.id} can retract rows; "
                        "acceptor state would silently diverge",
                        n,
                        upstream=f"{inp.name}#{inp.id}",
                    )
                )
    return out


# ---------------------------------------------------------------------------
# PW-D001: dead columns


_TRANSPARENT_FOR_USAGE = {
    "FilterNode",
    "IntersectNode",
    "SubtractNode",
    "ReindexNode",
    "DeduplicateNode",
}


def _consumer_usage(n: eg.Node, facts: GraphFacts) -> "set[str] | None":
    """Union of column names ``n``'s consumers read, following
    pass-through operators; None = not analyzable / reaches a consumer
    that needs every column (sinks included)."""
    used: set[str] = set()
    work = list(facts.consumers.get(n.id, ()))
    seen: set[int] = set()
    while work:
        c = work.pop()
        if c.id in seen:
            continue
        seen.add(c.id)
        cls = type(c).__name__
        if cls in _SINK_CLASSES:
            return None
        uc = c.meta.get("used_cols")
        if cls in _TRANSPARENT_FOR_USAGE:
            if uc:
                used.update(uc)
            nxt = facts.consumers.get(c.id, ())
            if not nxt:
                return None  # dangling pass-through: assume probed
            work.extend(nxt)
            continue
        if uc is None:
            return None
        used.update(uc)
    return used


def check_dead_columns(
    graph: eg.EngineGraph, facts: GraphFacts
) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for n in graph.nodes:
        sel = n.meta.get("select")
        if not sel or sel.get("kind") != "select":
            continue  # with_columns pass-through columns are deliberate
        consumers = facts.consumers.get(n.id, ())
        if not consumers:
            continue  # a table nobody consumes is the user's business
        used = _consumer_usage(n, facts)
        if used is None:
            continue
        for name in sel.get("names", ()):
            if name.startswith("__"):
                continue  # internal groupby slots
            if name not in used:
                out.append(
                    _diag(
                        "PW-D001",
                        SEV_WARNING,
                        f"column {name!r} is computed but never read by "
                        "any downstream operator; drop it from the select",
                        n,
                        column=name,
                    )
                )
    return out


from pathway_tpu_torch.analysis.device import check_device  # noqa: E402
from pathway_tpu_torch.analysis.distribution import check_distribution  # noqa: E402
from pathway_tpu_torch.analysis.memory import check_memory  # noqa: E402

ALL_PASSES = (
    check_types,
    check_call_py,
    check_unbounded_state,
    check_append_only,
    check_dead_columns,
    check_distribution,
    check_memory,
    check_device,
)
