"""The plan compiler: analyzer-fact-driven graph rewriting.

``optimize_graph(graph, level)`` builds an *execution view* of the
captured dataflow graph — shallow node clones sharing the original ids
— and runs a deterministic pass pipeline over it, recording every
applied rewrite in an :class:`~pathway_tpu_torch.analysis.plan.ExecutionPlan`.
The scheduler consumes the view transparently: it routes purely by
``node.id`` (consumers map, per-run states, exchange keys), so clones
with original ids slot in without any scheduler change, and the
original graph stays untouched for re-runs and for ``pw.explain()``.

Passes, by level:

- **1** — ``const_fold`` (evaluate constant subtrees at plan time),
  ``dead_column_elim`` (act on the PW-D001 fact: a column no consumer
  reads is replaced by a constant-``None`` slot at its producer, so the
  value is never computed and exchange frames carry a shared immutable
  ``None`` instead of real payloads; slot *positions* are preserved
  because consumers address columns positionally), ``select_fusion`` /
  ``filter_fusion`` (adjacent CALL_PY-free nodes collapse into one
  operator whose VM program is the bytecode splice of both —
  ``expr_vm.concat_programs``).
- **2** — additionally ``append_only_groupby`` (swap retraction-capable
  reducers for non-retracting ones when ``graph_facts`` proves the
  input append-only), ``pushdown_filter`` and ``pushdown_projection``
  (move predicates / column nulling across joins toward connectors).

Every *decision* is made on the native-free lint lowering
(``vm_abstract.lint_lower``), so plans are identical with or without
the native module; native code generation for rewritten programs is
best-effort and falls back to composed Python closures.
"""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expr_vm as vm
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import _referenced_names, compile_exprs

from pathway_tpu_torch.analysis import vm_abstract as va
from pathway_tpu_torch.analysis.graph_facts import GraphFacts
from pathway_tpu_torch.analysis.passes import _SINK_CLASSES, _consumer_usage
from pathway_tpu_torch.analysis.plan import ExecutionPlan

__all__ = ["optimize_graph", "resolve_level", "DEFAULT_LEVEL"]

DEFAULT_LEVEL = 2


def resolve_level(optimize: "int | None" = None) -> int:
    """Effective optimization level: explicit ``run(optimize=)`` beats
    ``PATHWAY_OPTIMIZE`` beats the default (2).  Clamped to 0..2."""
    if optimize is None:
        env = os.environ.get("PATHWAY_OPTIMIZE", "")
        if env.strip():
            try:
                optimize = int(env)
            except ValueError:
                optimize = None
    if optimize is None:
        optimize = DEFAULT_LEVEL
    return max(0, min(2, int(optimize)))


# ---------------------------------------------------------------------------
# execution view


class _GraphView:
    """Mutable clone layer over an EngineGraph.  Clones share the
    original node ids (the scheduler's only addressing scheme); rewiring
    happens exclusively through the clones' ``inputs`` lists.  Nodes the
    rewriter inserts get fresh ids past the original range."""

    def __init__(self, graph: eg.EngineGraph):
        self.original = graph
        self.nodes: list[eg.Node] = [self._clone(n) for n in graph.nodes]
        self.by_id = {c.id: c for c in self.nodes}
        for c in self.nodes:
            if type(c).__name__ in _SINK_CLASSES:
                continue  # identity-kept: leave the original's wiring alone
            c.inputs = [self.by_id[i.id] for i in c.inputs]
        self._next_id = max(self.by_id, default=-1) + 1

    @staticmethod
    def _clone(n: eg.Node) -> eg.Node:
        # sinks are NOT cloned: ExportNode accumulates its update log and
        # closed-frontier on the node object itself, and user handles
        # (ExportedTable, capture contexts) hold the original — a clone
        # would absorb the run's state where nobody reads it.  No pass
        # rewrites a sink or repoints its inputs, and the scheduler
        # routes by input *id*, so sharing the object is safe.
        if type(n).__name__ in _SINK_CLASSES:
            return n
        c = object.__new__(type(n))
        c.__dict__ = dict(n.__dict__)
        # meta is edited per-clone (exprs swap on recompile); one level
        # of copy keeps the original graph's annotations pristine
        c.meta = dict(n.meta)
        return c

    def alloc_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    def consumers(self) -> dict[int, list[eg.Node]]:
        out: dict[int, list[eg.Node]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for i in n.inputs:
                out.setdefault(i.id, []).append(n)
        return out

    def remove(self, node: eg.Node) -> None:
        self.nodes.remove(node)
        del self.by_id[node.id]

    def insert_before(self, anchor: eg.Node, node: eg.Node) -> None:
        self.nodes.insert(self.nodes.index(anchor), node)
        self.by_id[node.id] = node

    def finish(self) -> eg.EngineGraph:
        g = object.__new__(eg.EngineGraph)
        g.nodes = self.nodes
        # shared list: attach_prober() after optimization is still seen
        g.probers = self.original.probers
        for n in self.nodes:
            if type(n).__name__ in _SINK_CLASSES:
                continue  # identity-kept sink: don't touch the original
            n.graph = g
        return g


class _UsageFacts:
    """Minimal ``facts`` shim for :func:`passes._consumer_usage` over
    the current (possibly already rewritten) view topology."""

    def __init__(self, consumers: dict[int, list[eg.Node]]):
        self.consumers = consumers


# ---------------------------------------------------------------------------
# recompilation helpers (mirror the table-API build paths exactly)


def _recompile_select(
    n: eg.Node, sel: dict, new_exprs: list, relax: "tuple[int, ...]" = ()
) -> None:
    layout = sel["layout"]
    n.row_fn = compile_exprs(new_exprs, layout)
    if sel.get("kind") != "join_select":
        # join_select keeps the closure path it was built with
        n.programs = vm.lower_programs(new_exprs, layout)
    n.meta["select"] = {**sel, "exprs": list(new_exprs)}
    n.meta["used_cols"] = _referenced_names(new_exprs)
    if relax and n.typecheck_info is not None:
        names, dtypes = n.typecheck_info
        n.typecheck_info = (
            names,
            [dt.ANY if i in relax else d for i, d in enumerate(dtypes)],
        )
        n._checker = None


def _recompile_filter(n: eg.Node, flt: dict, e: Any) -> None:
    layout = flt["layout"]
    c = e._compile(layout.resolver)
    n.pred = lambda key, values, c=c: c((key, values))
    n.program = vm.lower_program(e, layout)
    n.meta["filter"] = {**flt, "exprs": [e]}
    n.meta["used_cols"] = _referenced_names([e])


def _lint_triple(e: Any, layout: Any) -> "tuple[list, list, list] | None":
    """CALL_PY-free raw (code, consts, pyfuncs) triple for one
    expression, or None — the native-independent fusion currency."""
    asm = va.lint_lower(e, layout)
    if asm is None or asm.pyfuncs:
        return None
    return (asm.code, asm.consts, [])


# ---------------------------------------------------------------------------
# constant folding

_FOLDABLE = (ex.BinaryExpression, ex.UnaryExpression, ex.IsNoneExpression)


def _no_resolver(ref: Any) -> Any:
    raise ValueError("constant subtree must not reference columns")


def _fold_expr(e: Any) -> tuple[Any, int]:
    """Bottom-up fold; returns (expression, number of collapsed
    subtrees).  A subtree folds when every leaf is already constant and
    evaluation neither raises nor yields the ERROR sentinel (those keep
    their per-row runtime semantics)."""
    kids = list(e._children())
    if not kids:
        return e, 0
    folded = 0
    new_kids = []
    changed = False
    for k in kids:
        nk, f = _fold_expr(k)
        folded += f
        changed = changed or nk is not k
        new_kids.append(nk)
    if changed:
        try:
            e = e._rebuild(new_kids)
        except Exception:
            return e, 0  # rebuild refused (dtype conflict): keep original
    if isinstance(e, _FOLDABLE) and all(
        type(k) is ex.ConstExpression for k in e._children()
    ):
        try:
            v = e._compile(_no_resolver)(None)
        except Exception:
            return e, folded
        if v is api.ERROR:
            return e, folded
        try:
            ne = ex.ConstExpression(v)
        except Exception:
            return e, folded
        ne._dtype = e._dtype
        return ne, folded + 1
    return e, folded


def _pass_const_fold(view: _GraphView, plan: ExecutionPlan) -> None:
    for n in view.nodes:
        sel = n.meta.get("select")
        if sel is not None and type(n) is eg.RowwiseNode:
            exprs, layout = sel.get("exprs"), sel.get("layout")
            if exprs is None or layout is None:
                continue
            total = 0
            new_exprs = []
            for e in exprs:
                try:
                    ne, k = _fold_expr(e)
                except Exception:
                    ne, k = e, 0
                total += k
                new_exprs.append(ne)
            if total:
                _recompile_select(n, sel, new_exprs)
                plan.record("const_fold", [n], f"subtrees={total}")
            continue
        flt = n.meta.get("filter")
        if flt is not None and type(n) is eg.FilterNode:
            exprs, layout = flt.get("exprs"), flt.get("layout")
            if not exprs or layout is None:
                continue
            try:
                ne, k = _fold_expr(exprs[0])
            except Exception:
                continue
            if k:
                _recompile_filter(n, flt, ne)
                plan.record("const_fold", [n], f"subtrees={k}")


# ---------------------------------------------------------------------------
# dead-column elimination (acts on the PW-D001 fact)


def _null_columns(
    n: eg.Node, sel: dict, dead: list[int]
) -> None:
    new_exprs = list(sel["exprs"])
    for i in dead:
        ne = ex.ConstExpression(None)
        new_exprs[i] = ne
    _recompile_select(n, sel, new_exprs, relax=tuple(dead))


def _pass_dead_columns(view: _GraphView, plan: ExecutionPlan) -> None:
    consumers = view.consumers()
    shim = _UsageFacts(consumers)
    # reverse topological order: nulling a consumer's dead columns
    # shrinks its used_cols, letting dead columns cascade upstream
    for n in reversed(view.nodes):
        sel = n.meta.get("select")
        if not sel or sel.get("kind") != "select" or type(n) is not eg.RowwiseNode:
            continue
        if not consumers.get(n.id):
            continue  # a table nobody consumes is the user's business
        used = _consumer_usage(n, shim)
        if used is None:
            continue
        names = sel.get("names", ())
        exprs = sel.get("exprs", ())
        dead = [
            i
            for i, name in enumerate(names)
            if not name.startswith("__")
            and name not in used
            and i < len(exprs)
            and type(exprs[i]) is not ex.ConstExpression
        ]
        if not dead:
            continue
        _null_columns(n, sel, dead)
        plan.record(
            "dead_column_elim",
            [n],
            "null=" + ",".join(names[i] for i in dead),
        )


# ---------------------------------------------------------------------------
# append-only specialization


def _pass_append_only(
    view: _GraphView, facts: GraphFacts, plan: ExecutionPlan
) -> None:
    for n in view.nodes:
        if type(n) is not eg.GroupByNode:
            continue
        inp = n.inputs[0] if n.inputs else None
        if inp is None or inp.id not in facts.append_only:
            continue
        # reducer_args is shared with the original node until the swap
        # copies it (specialize_append_only builds a fresh list)
        swapped = n.specialize_append_only()
        if swapped:
            plan.record(
                "append_only_groupby", [n], "reducers=" + ",".join(swapped)
            )


# ---------------------------------------------------------------------------
# select fusion


def _select_triples(n: eg.Node) -> "list | None":
    """Per-output-column raw program triples for a select-like rowwise
    node — from a previous fusion's stored triples, or freshly
    lint-lowered from the build-time meta.  None = not fusable."""
    pf = n.meta.get("plan_fused")
    if pf is not None:
        return pf["triples"]
    sel = n.meta.get("select")
    if not sel or sel.get("kind") not in ("select", "with_columns", "join_select"):
        return None
    exprs, layout = sel.get("exprs"), sel.get("layout")
    if exprs is None or layout is None:
        return None
    triples = []
    for e in exprs:
        t = _lint_triple(e, layout)
        if t is None:
            return None
        triples.append(t)
    return triples


def _compose_row_fns(fa: Any, fb: Any) -> Any:
    def fused(key: Any, values: tuple, fa=fa, fb=fb) -> tuple:
        return fb(key, fa(key, values))

    return fused


def _pass_fuse_selects(view: _GraphView, plan: ExecutionPlan) -> None:
    changed = True
    while changed:
        changed = False
        consumers = view.consumers()
        for b in list(view.nodes):
            if type(b) is not eg.RowwiseNode or len(b.inputs) != 1:
                continue
            a = b.inputs[0]
            if type(a) is not eg.RowwiseNode:
                continue
            if consumers.get(a.id) != [b]:
                continue
            b_triples = _select_triples(b)
            a_triples = _select_triples(a)
            if b_triples is None or a_triples is None:
                continue
            colmap = dict(enumerate(a_triples))
            try:
                fused_triples = [
                    vm.concat_programs(t, colmap) for t in b_triples
                ]
            except (KeyError, ValueError):
                continue
            b.inputs = [a.inputs[0]]
            b.row_fn = _compose_row_fns(a.row_fn, b.row_fn)
            capsules = [vm.compile_triple(t) for t in fused_triples]
            b.programs = (
                tuple(capsules) if all(c is not None for c in capsules) else None
            )
            b.meta.pop("select", None)
            b.meta["plan_fused"] = {"triples": fused_triples}
            a_used = a.meta.get("used_cols")
            if a_used is not None:
                b.meta["used_cols"] = list(a_used)
            else:
                b.meta.pop("used_cols", None)
            view.remove(a)
            plan.record(
                "select_fusion", [a, b], f"cols={len(fused_triples)}"
            )
            changed = True
            break


# ---------------------------------------------------------------------------
# filter fusion


def _filter_triple(n: eg.Node) -> "tuple | None":
    pf = n.meta.get("plan_fused_filter")
    if pf is not None:
        return pf["triple"]
    flt = n.meta.get("filter")
    if not flt:
        return None
    exprs, layout = flt.get("exprs"), flt.get("layout")
    if not exprs or layout is None:
        return None
    e = exprs[0]
    d = getattr(e, "_dtype", None)
    if not isinstance(d, dt.DType) or d.strip_optional() != dt.BOOL:
        return None  # non-bool truthiness diverges under fused AND
    return _lint_triple(e, layout)


def _fused_pred(pa: Any, pb: Any) -> Any:
    def fused(key: Any, values: tuple, pa=pa, pb=pb) -> Any:
        ka = pa(key, values)
        if ka is None or ka is api.ERROR or not ka:
            return False
        return pb(key, values)

    return fused


#: downstream pseudo-program `if col0 then col1 else False` — splicing
#: predicate A into slot 0 and predicate B into slot 1 yields the fused,
#: short-circuiting predicate bytecode (same shape _lower emits for
#: IfElseExpression, whose None/ERROR behaviour is differential-tested)
_AND_TEMPLATE = (
    [
        vm.OP_LOAD_COL, 0,
        vm.OP_BRANCH, 9, 11,
        vm.OP_LOAD_COL, 1,
        vm.OP_JUMP, 11,
        vm.OP_LOAD_CONST, 0,
    ],
    [False],
    [],
)


def _pass_fuse_filters(view: _GraphView, plan: ExecutionPlan) -> None:
    changed = True
    while changed:
        changed = False
        consumers = view.consumers()
        for b in list(view.nodes):
            if type(b) is not eg.FilterNode or len(b.inputs) != 1:
                continue
            a = b.inputs[0]
            if type(a) is not eg.FilterNode:
                continue
            if consumers.get(a.id) != [b]:
                continue
            ta = _filter_triple(a)
            tb = _filter_triple(b)
            if ta is None or tb is None:
                continue
            try:
                fused = vm.concat_programs(_AND_TEMPLATE, {0: ta, 1: tb})
            except (KeyError, ValueError):
                continue
            b.inputs = [a.inputs[0]]
            b.pred = _fused_pred(a.pred, b.pred)
            b.program = vm.compile_triple(fused)
            b.meta.pop("filter", None)
            b.meta["plan_fused_filter"] = {"triple": fused}
            ua, ub = a.meta.get("used_cols"), b.meta.get("used_cols")
            if ua is not None and ub is not None:
                b.meta["used_cols"] = sorted(set(ua) | set(ub))
            else:
                b.meta.pop("used_cols", None)
            view.remove(a)
            plan.record("filter_fusion", [a, b])
            changed = True
            break


# ---------------------------------------------------------------------------
# filter pushdown across joins


class _Bail(Exception):
    pass


def _substitute_refs(e: Any, layout: Any, repl: list) -> Any:
    """Rewrite a predicate over a join_select's *output* frame into one
    over the join frame by replacing each column reference with the
    select expression that defines it.  Bails on id/key references and
    anything the layout cannot resolve positionally."""
    if type(e) is ex.ColumnReference:
        pos = layout.resolve_pos(e)
        if pos is None or pos < 0 or pos >= len(repl):
            raise _Bail
        return repl[pos]
    kids = list(e._children())
    if not kids:
        return e
    new = [_substitute_refs(k, layout, repl) for k in kids]
    if all(a is b for a, b in zip(new, kids)):
        return e
    try:
        return e._rebuild(new)
    except Exception:
        raise _Bail from None


def _pred_over_join(f: eg.Node, join: eg.JoinNode) -> "tuple | None":
    """(expr, join_layout) for a filter's predicate expressed over the
    join output frame, or None."""
    flt = f.meta.get("filter")
    if not flt or not flt.get("exprs"):
        return None
    e = flt["exprs"][0]
    if f.meta.get("join_filter") is not None:
        return e, flt["layout"]  # already over the join frame
    # filter over a join_select's output: substitute the select exprs
    s = f.inputs[0]
    sel = s.meta.get("select")
    if not sel or sel.get("kind") != "join_select":
        return None
    try:
        e2 = _substitute_refs(e, flt["layout"], list(sel["exprs"]))
    except Exception:
        return None
    return e2, sel["layout"]


def _try_push_filter(
    view: _GraphView,
    plan: ExecutionPlan,
    f: eg.Node,
    join: eg.JoinNode,
    e: Any,
    join_layout: Any,
) -> bool:
    asm = va.lint_lower(e, join_layout)
    if asm is None or asm.pyfuncs:
        return False
    try:
        ops = list(va.iter_ops(asm.code))
    except Exception:
        return False
    if any(op == vm.OP_LOAD_KEY for _, op, _ in ops):
        return False  # join output keys don't exist below the join
    positions = [o[0] for _, op, o in ops if op == vm.OP_LOAD_COL]
    if not positions:
        return False
    ln, rn = join.left_ncols, join.right_ncols
    if all(p < ln for p in positions):
        side, kinds = 0, ("inner", "left")
    elif all(ln <= p < ln + rn for p in positions):
        side, kinds = 1, ("inner", "right")
    else:
        return False  # mixed-side or id-slot predicate stays above
    if join.kind not in kinds:
        # on the side a join preserves unmatched, pre-filtering would
        # also drop the null-padded survivors the retained filter keeps
        return False
    c = e._compile(join_layout.resolver)
    if side == 0:
        pred = lambda key, values, c=c: c((key, values))  # noqa: E731
        code = asm.code
    else:
        pad = (None,) * ln
        pred = (  # noqa: E731
            lambda key, values, c=c, pad=pad: c((key, pad + tuple(values)))
        )
        try:
            code = vm.renumber_columns(asm.code, lambda p: p - ln)
        except (KeyError, ValueError):
            return False
    program = vm.compile_triple((code, asm.consts, []))
    pushed = eg.FilterNode.detached(
        join.inputs[side],
        pred,
        node_id=view.alloc_id(),
        name="pushed_filter",
        program=program,
    )
    view.insert_before(join, pushed)
    join.inputs[side] = pushed
    plan.record(
        "pushdown_filter",
        [f, join],
        f"side={'left' if side == 0 else 'right'}",
    )
    return True


def _pass_pushdown_filters(view: _GraphView, plan: ExecutionPlan) -> None:
    consumers = view.consumers()
    for f in list(view.nodes):
        if type(f) is not eg.FilterNode or len(f.inputs) != 1:
            continue
        up = f.inputs[0]
        if type(up) is eg.JoinNode:
            join = up
            if consumers.get(join.id) != [f]:
                continue
        elif (
            type(up) is eg.RowwiseNode
            and len(up.inputs) == 1
            and type(up.inputs[0]) is eg.JoinNode
        ):
            join = up.inputs[0]
            # the join (and the select) must feed this filter only —
            # other consumers expect the unfiltered stream
            if consumers.get(join.id) != [up] or consumers.get(up.id) != [f]:
                continue
        else:
            continue
        res = _pred_over_join(f, join)
        if res is None:
            continue
        _try_push_filter(view, plan, f, join, res[0], res[1])


# ---------------------------------------------------------------------------
# projection pushdown across joins


def _pass_pushdown_projection(view: _GraphView, plan: ExecutionPlan) -> None:
    consumers = view.consumers()
    shim = _UsageFacts(consumers)
    for join in list(view.nodes):
        if type(join) is not eg.JoinNode:
            continue
        if not consumers.get(join.id):
            continue
        used = _consumer_usage(join, shim)
        if used is None:
            continue
        on = join.meta.get("join", {}).get("on")
        if on is None:
            continue
        key_names = ([p[0] for p in on], [p[2] for p in on])
        for side in (0, 1):
            if "<expr>" in key_names[side]:
                continue  # unknown key inputs: keep every side column
            p = join.inputs[side]
            if type(p) is not eg.RowwiseNode or consumers.get(p.id) != [join]:
                continue
            sel = p.meta.get("select")
            if not sel or sel.get("kind") not in ("select", "with_columns"):
                continue
            keep = set(used) | set(key_names[side])
            names = sel.get("names", ())
            exprs = sel.get("exprs", ())
            dead = [
                i
                for i, name in enumerate(names)
                if not name.startswith("__")
                and name not in keep
                and i < len(exprs)
                and type(exprs[i]) is not ex.ConstExpression
            ]
            if not dead:
                continue
            _null_columns(p, sel, dead)
            plan.record(
                "pushdown_projection",
                [p, join],
                f"side={'left' if side == 0 else 'right'} null="
                + ",".join(names[i] for i in dead),
            )


# ---------------------------------------------------------------------------
# columnar path annotation (the static half of frame execution)

#: FilterNode comparison ops with a native frame kernel, by expression
#: operator string -> native FrameCmp code (frame_filter's ``op``)
_FRAME_CMP_OPS = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}


def _columnar_select_spec(n: eg.Node) -> "tuple | str":
    """Positional projection tuple if every output column of a select is
    a plain column reference, else the row-fallback reason string."""
    if n.meta.get("plan_fused") is not None:
        return "fused program (expression VM)"
    sel = n.meta.get("select")
    if not sel or sel.get("kind") not in ("select", "with_columns"):
        return "non-select rowwise program"
    exprs, layout = sel.get("exprs"), sel.get("layout")
    if exprs is None or layout is None:
        return "no expression metadata"
    poses = []
    for e in exprs:
        if type(e) is not ex.ColumnReference:
            return f"computed column (expression VM): {type(e).__name__}"
        pos = layout.resolve_pos(e)
        if pos is None or pos < 0:
            return "key-derived column"
        poses.append(pos)
    return tuple(poses)


def _columnar_filter_spec(n: eg.Node) -> "tuple | str":
    """(pos, op, const) for a single col-cmp-const predicate, else the
    row-fallback reason string."""
    if n.meta.get("plan_fused") is not None:
        return "fused predicate (expression VM)"
    flt = n.meta.get("filter")
    if not flt:
        return "no predicate metadata (expression VM)"
    exprs, layout = flt.get("exprs"), flt.get("layout")
    if not exprs or layout is None:
        return "no predicate metadata"
    e = exprs[0]
    if (
        type(e) is not ex.BinaryExpression
        or e._op not in _FRAME_CMP_OPS
        or type(e._left) is not ex.ColumnReference
        or type(e._right) is not ex.ConstExpression
    ):
        return "predicate not col-cmp-const (expression VM)"
    pos = layout.resolve_pos(e._left)
    if pos is None or pos < 0:
        return "key-derived predicate column"
    return (pos, _FRAME_CMP_OPS[e._op], e._right._value)


def _pass_columnar(view: _GraphView, plan: ExecutionPlan) -> None:
    """Record every operator's batch-execution decision and arm the
    frame fast paths the kernels support: pure-projection selects
    (``frame_project``) and col-cmp-const filters (``frame_filter``).
    Input and groupby decisions were fixed at graph build time
    (``supports_columnar`` / ``fast_spec``); this pass makes them
    visible in the plan next to the ones it decides itself."""
    for n in view.nodes:
        t = type(n)
        if t is eg.InputNode:
            if n.supports_columnar:
                plan.record_columnar(n, "columnar")
            else:
                plan.record_columnar(
                    n, "row", "upsert stream keeps per-key state"
                )
        elif t is eg.GroupByNode:
            if n.fast_spec is not None:
                plan.record_columnar(n, "columnar")
            else:
                plan.record_columnar(
                    n, "row", "reducer or grouping not native-positional"
                )
        elif t is eg.RowwiseNode:
            spec = _columnar_select_spec(n)
            if isinstance(spec, tuple):
                n.frame_project = spec
                n.supports_columnar = True
                plan.record_columnar(n, "columnar")
            else:
                plan.record_columnar(n, "row", spec)
        elif t is eg.FilterNode:
            spec = _columnar_filter_spec(n)
            if isinstance(spec, tuple):
                n.frame_filter_spec = spec
                n.supports_columnar = True
                plan.record_columnar(n, "columnar")
            else:
                plan.record_columnar(n, "row", spec)


# ---------------------------------------------------------------------------
# pipeline


def optimize_graph(
    graph: eg.EngineGraph,
    level: int,
    facts: "GraphFacts | None" = None,
) -> tuple[eg.EngineGraph, ExecutionPlan]:
    """Rewrite ``graph`` at ``level`` (0..2); returns ``(exec_graph,
    plan)``.  Level 0 returns the original graph and an empty plan.  The
    input graph is never mutated — clones carry every change."""
    level = max(0, min(2, int(level)))
    plan = ExecutionPlan(level)
    plan.nodes_before = len(graph.nodes)
    if level <= 0 or not graph.nodes:
        plan.nodes_after = len(graph.nodes)
        return graph, plan
    if facts is None:
        facts = GraphFacts(graph)
    view = _GraphView(graph)
    _pass_const_fold(view, plan)
    _pass_dead_columns(view, plan)
    if level >= 2:
        _pass_append_only(view, facts, plan)
        # projection first: a pushed filter inserted between a select
        # and its join would hide the sole-consumer pattern
        _pass_pushdown_projection(view, plan)
        _pass_pushdown_filters(view, plan)
    _pass_fuse_selects(view, plan)
    _pass_fuse_filters(view, plan)
    # after all rewrites: decide + record the frame/row path per operator
    # on the FINAL shape of each node's program
    _pass_columnar(view, plan)
    exec_graph = view.finish()
    plan.nodes_after = len(exec_graph.nodes)
    return exec_graph, plan
