"""Engine dataflow graph: operator nodes.

This is the TPU-build equivalent of the reference's engine operation surface
(``trait Graph``, ``src/engine/graph.rs:664-1012``) and its differential
implementation (``src/engine/dataflow.rs``).  Design differences, on purpose:

- Epoch-synchronous scheduling (one consistent batch per logical timestamp)
  instead of asynchronous timely progress tracking — same externally
  observable consistency (outputs only at closed timestamps), far simpler
  host runtime, and a natural fit for feeding batched jitted TPU executors.
- Nodes are *stateless descriptions*; all mutable execution state lives in a
  per-run :class:`RunContext`, so a graph can be executed many times
  (mirrors the reference replaying the parse graph per worker).
- Retraction-aware: every operator processes ``diff=±1`` update batches.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, Sequence

from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals import native as _native
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.engine import cluster as cl
from pathway_tpu_torch.engine.reducers import ReducerImpl
from pathway_tpu_torch.engine.stream import Batch, Update, consolidate, per_key_changes


class ErrorEntry(str):
    """One error-log record.  A ``str`` subclass so every existing
    consumer (substring checks, len, logging) keeps working, with the
    structured fields the reference routes to its global error-log table
    (``src/engine/error.rs`` + ``parse_graph.add_error_log``)."""

    operator: str
    trace: str
    time: int

    def __new__(cls, message: str, operator: str = "", trace: str = "", time: int = 0):
        text = f"{message} [at {trace}]" if trace else message
        self = super().__new__(cls, text)
        self.message = message
        self.operator = operator
        self.trace = trace
        self.time = time
        return self


_ctx_local = __import__("threading").local()


def current_ctx() -> "RunContext | None":
    """The RunContext this worker thread is currently processing an epoch
    for — lets per-cell expression errors reach the run's error log."""
    return getattr(_ctx_local, "ctx", None)


def set_current_ctx(ctx: "RunContext | None") -> None:
    _ctx_local.ctx = ctx


def _user_trace() -> str:
    """file:line of the first stack frame OUTSIDE pathway_tpu_torch — the user
    code that created the operator (reference ``internals/trace.py``
    captures the creation frame the same way)."""
    import sys

    f = sys._getframe(1)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(pkg_root) and "pathway_tpu_torch" not in fn:
            return f"{fn}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return ""


class RunContext:
    """Per-run mutable state: node states, current time, worker topology."""

    def __init__(self, n_workers: int = 1, worker_id: int = 0):
        self.states: dict[int, Any] = {}
        self.time: int = 0
        self.n_workers = n_workers
        self.worker_id = worker_id
        self.error_log: list[str] = []
        self.stats: dict[str, Any] = {}
        #: entries not yet drained into the error-log table node; ONLY
        #: filled when the graph has an ErrorLogNode (the scheduler sets
        #: error_sink_enabled) — otherwise nothing ever drains it and a
        #: long streaming run would leak unboundedly
        self.error_pending: list[ErrorEntry] = []
        self.error_sink_enabled: bool = False
        #: input node ids whose connector gave up under on_failure=
        #: "degrade": downstream tables reflect only the rows delivered
        #: before the failure (stale).  Filled by the connector
        #: supervisor; surfaced through the monitoring snapshot.
        self.stale_sources: set[int] = set()

    def state(self, node: "Node") -> Any:
        if node.id not in self.states:
            self.states[node.id] = node.make_state()
        return self.states[node.id]

    def log_error(self, node: "Node | None", message: str) -> ErrorEntry:
        """Record an operator error with its creation trace; the entry
        feeds both ``ctx.error_log`` and the global error-log table."""
        entry = ErrorEntry(
            message,
            operator=repr(node) if node is not None else "",
            trace=getattr(node, "trace", "") or "",
            time=self.time,
        )
        self.error_log.append(entry)
        if self.error_sink_enabled:
            self.error_pending.append(entry)
        return entry


class Node:
    """An operator in the dataflow graph."""

    #: nodes that want a `process` call every epoch even with empty input
    always_tick = False

    #: True when :meth:`process` understands
    #: :class:`~pathway_tpu_torch.engine.columnar.ColumnarBatch` inputs (frame
    #: segments consumed by native kernels); the scheduler materializes
    #: frames to row lists before calling any node that leaves this False
    #: — the Python-UDF row-at-a-time fallback
    supports_columnar = False

    def __init__(self, graph: "EngineGraph", inputs: Sequence["Node"], name: str = ""):
        self.graph = graph
        self.inputs = list(inputs)
        self.name = name or type(self).__name__
        self.id = graph.register(self)
        #: user file:line that created this operator (engine errors are
        #: re-annotated with it — reference OperatorProperties.trace,
        #: ``src/engine/graph.rs:441-463``)
        self.trace = _user_trace()
        #: build-time annotations consumed by the pre-flight static
        #: analyzer (pathway_tpu_torch/analysis/): expression ASTs, declared
        #: column names/dtypes, join-key pairs.  Never read by the engine
        #: hot path and never shipped across processes.
        self.meta: dict[str, Any] = {}

    def exchange_routes(self) -> list | None:
        """Multi-worker co-location: one route function per input port
        (``Update -> stable shard int``; destination worker = shard % W),
        or None for operators that process rows wherever they are
        (reference key-hash exchange, ``src/engine/dataflow.rs:1068-1072``).
        Stateful operators MUST route so each worker owns a disjoint state
        shard; stateless ones keep data local."""
        return None

    def make_state(self) -> Any:
        return {}

    def process(self, ctx: RunContext, time: int, inbatches: list[Batch]) -> Batch:
        raise NotImplementedError

    def on_time_end(self, ctx: RunContext, time: int) -> None:
        pass

    def on_end(self, ctx: RunContext) -> None:
        pass

    def on_restore(self, ctx: RunContext) -> None:
        """Called once after this node's state was restored from an
        operator snapshot, before any epoch runs.  Sinks reposition their
        outputs to the checkpointed watermark here so replayed epochs
        cannot double-emit; most operators need nothing."""

    def snapshot_state(self, ctx: RunContext) -> Any:
        """Extra state to checkpoint IN PLACE of ``ctx.states[self.id]``,
        or None to snapshot the plain operator state.  Operators holding
        large out-of-band state (an external index) fold a serialized
        copy into the snapshot here, keyed to the same connector offsets
        as everything else; :meth:`on_restore` unfolds it.  Must return
        picklable data (numpy, not jax arrays)."""
        return None

    def __repr__(self) -> str:
        return f"<{self.name}#{self.id}>"


class EngineGraph:
    """Holds the node list; topological order == creation order (inputs are
    always created before consumers; `iterate` bodies live in subgraphs)."""

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        #: per-epoch stats callbacks (reference attach_prober/probe_table,
        #: src/engine/graph.rs:988-995); invoked by the scheduler on
        #: worker 0 after every epoch
        self.probers: list[Callable[[dict], None]] = []

    def register(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1


# ---------------------------------------------------------------------------
# Sources


class InputNode(Node):
    """A table fed from outside the graph: static rows and/or a live
    connector subject (reference ``connector_table``,
    ``src/engine/graph.rs:961``)."""

    def __init__(
        self,
        graph: EngineGraph,
        n_cols: int,
        static_rows: Iterable[tuple[Pointer, tuple]] = (),
        subject: Any = None,
        name: str = "input",
        upsert: bool = False,
    ):
        super().__init__(graph, [], name)
        self.n_cols = n_cols
        self.static_rows = list(static_rows)
        self.subject = subject
        self.upsert = upsert
        # upsert sessions walk per-row state; only the plain append
        # stream can pass frames through untouched
        self.supports_columnar = not upsert

    def exchange_routes(self):
        return [cl.route_by_key] if self.upsert else None

    def make_state(self) -> Any:
        return {"rows": {}}  # key -> values, for upsert semantics

    def process(self, ctx: RunContext, time: int, inbatches: list[Batch]) -> Batch:
        # inbatches[0] is the externally injected batch for this epoch
        raw = inbatches[0] if inbatches else []
        if not self.upsert:
            from pathway_tpu_torch.engine.columnar import ColumnarBatch

            if isinstance(raw, ColumnarBatch):
                # frame passthrough: append-only frames flow downstream
                # columnar (the header's all_plus flag makes the check
                # O(segments)); anything with retractions materializes
                # for the consolidation pass below
                if raw.all_plus():
                    return raw
                raw = raw.to_list()
            if not isinstance(raw, list):
                raw = list(raw)  # the all() scan below must not consume it
            # append-only batch (no retractions): consolidation is a
            # semantic no-op on the multiset — skip the hash pass
            native = _native.load()
            if native is not None:
                if native.all_positive(raw):
                    return raw
            elif all(u.diff > 0 for u in raw):
                return raw
            return consolidate(raw)
        # Upsert session semantics (reference SessionType::Upsert,
        # src/connectors/adaptors.rs:23-40): +1 overwrites, -1 deletes by key.
        rows = ctx.state(self)["rows"]
        out: list[Update] = []
        for u in raw:
            old = rows.get(u.key)
            if u.diff > 0:
                if old == u.values:
                    continue  # no-op overwrite: an object re-read's
                    # unchanged prefix must not churn downstream
                if old is not None:
                    out.append(Update(u.key, old, -1))
                rows[u.key] = u.values
                out.append(Update(u.key, u.values, 1))
            else:
                if old is not None:
                    out.append(Update(u.key, old, -1))
                    del rows[u.key]
        return consolidate(out)


# ---------------------------------------------------------------------------
# Stateless row transforms


class RowwiseNode(Node):
    """expression_table (reference ``Graph::expression_table``): compute a new
    tuple of columns for each row via compiled expression closures."""

    #: positional projection tuple set by the plan compiler
    #: (analysis/rewrite._pass_columnar) when every output column is a
    #: plain column reference — arms the frame_project fast path (and
    #: supports_columnar with it)
    frame_project: "tuple | None" = None

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        row_fn: Callable[[Pointer, tuple], tuple],
        name: str = "select",
        typecheck_info: tuple[list[str], list] | None = None,
        programs: Any = None,
    ):
        super().__init__(graph, [input], name)
        self.row_fn = row_fn
        #: per-column VM bytecode capsules (internals/expr_vm.py) — the
        #: fully-native select path; row_fn remains the semantic ground
        #: truth and the PATHWAY_DISABLE_NATIVE fallback
        self.programs = programs
        #: (column names, declared dtypes) for PATHWAY_RUNTIME_TYPECHECKING
        self.typecheck_info = typecheck_info
        self._checker: Any = None

    def _typecheck(self) -> Callable[[tuple], None] | None:
        """The runtime validator iff typechecking is on for this run
        (reference runtime typechecking mode) — checked per batch so
        ``pw.run(runtime_typechecking=True)`` works after graph build."""
        if self.typecheck_info is None:
            return None
        from pathway_tpu_torch.internals.config import pathway_config

        if not pathway_config.runtime_typechecking:
            return None
        if self._checker is None:
            from pathway_tpu_torch.internals.type_interpreter import (
                make_runtime_checker,
            )

            names, dtypes = self.typecheck_info
            self._checker = make_runtime_checker(names, dtypes, self.name)
        return self._checker

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.columnar import ColumnarBatch

        batch = inbatches[0]
        if isinstance(batch, ColumnarBatch):
            check = self._typecheck()
            native = _native.load()
            if (
                self.frame_project is None
                or check is not None
                or native is None
            ):
                inbatches = [batch.to_list()]
            else:
                # pure projection: column copies per frame segment, row
                # segments ride the existing row kernels below
                out = ColumnarBatch()
                for kind, seg in batch.segments:
                    if kind == "f":
                        out.append_frame(
                            native.frame_project(seg, self.frame_project)
                        )
                    elif seg:
                        out.extend(self.process(ctx, time, [seg]))
                return out
        fn = self.row_fn
        check = self._typecheck()
        native = _native.load()
        if native is not None and check is None:
            if self.programs is not None:
                # expression VM: typed tree evaluated in C, no per-row
                # Python closure dispatch (reference expression.rs role)
                return native.vm_eval_batch(
                    inbatches[0],
                    self.programs,
                    Update,
                    api.ERROR,
                    lambda e: ctx.log_error(self, f"{self.name}: {e!r}"),
                )
            return native.rowwise_map(
                inbatches[0],
                fn,
                Update,
                api.ERROR,
                lambda e: ctx.log_error(self, f"{self.name}: {e!r}"),
            )
        out = []
        for u in inbatches[0]:
            try:
                vals = fn(u.key, u.values)
            except Exception as e:
                ctx.log_error(self, f"{self.name}: {e!r}")
                vals = tuple([api.ERROR])
            else:
                if check is not None:
                    check(vals)  # declared-type violations fail the run
            out.append(Update(u.key, vals, u.diff))
        return out


class FilterNode(Node):
    #: (pos, cmp_op, const) set by the plan compiler for a single
    #: col-cmp-const predicate — arms the frame_filter fast path
    frame_filter_spec: "tuple | None" = None

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        pred: Callable[[Pointer, tuple], Any],
        name: str = "filter",
        program: Any = None,
    ):
        super().__init__(graph, [input], name)
        self.pred = pred
        #: VM bytecode capsule for the predicate (internals/expr_vm.py)
        self.program = program

    @classmethod
    def detached(
        cls,
        input: Node,
        pred: Callable[[Pointer, tuple], Any],
        *,
        node_id: int,
        name: str = "filter",
        program: Any = None,
    ) -> "FilterNode":
        """Build a filter without registering it in any graph — the plan
        rewriter (analysis/rewrite.py) inserts these into its execution
        view with an id it allocates itself, leaving the captured graph's
        id space untouched."""
        n = object.__new__(cls)
        n.graph = input.graph
        n.inputs = [input]
        n.name = name
        n.id = node_id
        n.trace = input.trace
        n.meta = {}
        n.pred = pred
        n.program = program
        return n

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.columnar import ColumnarBatch

        batch = inbatches[0]
        if isinstance(batch, ColumnarBatch):
            native = _native.load()
            spec = self.frame_filter_spec
            if native is None or spec is None:
                inbatches = [batch.to_list()]
            else:
                out = ColumnarBatch()
                for kind, seg in batch.segments:
                    if kind == "f":
                        try:
                            out.append_frame(
                                native.frame_filter(seg, *spec)
                            )
                            continue
                        except native.Unsupported:
                            # e.g. int column vs float const: exact
                            # arithmetic parity needs the row semantics
                            seg = native.frame_to_updates(seg)
                    if seg:
                        out.extend(self.process(ctx, time, [seg]))
                return out
        pred = self.pred
        native = _native.load()
        if native is not None:
            if self.program is not None:
                return native.vm_filter_batch(
                    inbatches[0], self.program, api.ERROR
                )
            return native.filter_batch(inbatches[0], pred, api.ERROR)
        out = []
        for u in inbatches[0]:
            try:
                keep = pred(u.key, u.values)
            except Exception:
                keep = False
            # accept any truthy value (incl. numpy bools); Error/None drop
            if keep is not None and keep is not api.ERROR and bool(keep):
                out.append(u)
        return out


class FlattenNode(Node):
    """Explode one column; derived keys (reference ``Graph::flatten_table``)."""

    def __init__(self, graph: EngineGraph, input: Node, col_idx: int, name: str = "flatten"):
        super().__init__(graph, [input], name)
        self.col_idx = col_idx

    def process(self, ctx, time, inbatches):
        out = []
        ci = self.col_idx
        for u in inbatches[0]:
            seq = u.values[ci]
            if seq is None or seq is api.ERROR:
                continue
            if isinstance(seq, str):
                elems: Iterable[Any] = list(seq)
            else:
                try:
                    elems = list(seq)
                except TypeError:
                    continue
            for i, e in enumerate(elems):
                vals = u.values[:ci] + (e,) + u.values[ci + 1 :]
                out.append(Update(K.derive(u.key, "flatten", i), vals, u.diff))
        return out


class ReindexNode(Node):
    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        key_fn: Callable[[Pointer, tuple], Pointer],
        name: str = "reindex",
    ):
        super().__init__(graph, [input], name)
        self.key_fn = key_fn

    def process(self, ctx, time, inbatches):
        fn = self.key_fn
        return [Update(fn(u.key, u.values), u.values, u.diff) for u in inbatches[0]]


class ConcatNode(Node):
    """Union of disjoint-key tables (reference ``Graph::concat_tables``)."""

    def __init__(self, graph: EngineGraph, inputs: Sequence[Node], name: str = "concat"):
        super().__init__(graph, inputs, name)

    def process(self, ctx, time, inbatches):
        out: list[Update] = []
        for b in inbatches:
            out.extend(b)
        return consolidate(out)


# ---------------------------------------------------------------------------
# Keyed stateful combinators

def _apply_batch_to_rows(rows: dict, batch: Batch) -> dict[Pointer, tuple]:
    """Apply updates to a key->values dict; return {key: old_values_or_None}
    of touched keys (before state)."""
    touched: dict[Pointer, Any] = {}
    for key, (rem, add) in per_key_changes(batch).items():
        if key not in touched:
            touched[key] = rows.get(key)
        if add:
            rows[key] = add[-1]
        elif rem:
            rows.pop(key, None)
    return touched


class IntersectNode(Node):
    """Rows of main whose key exists in every other input
    (reference ``Graph::intersect_tables``)."""

    def __init__(self, graph: EngineGraph, main: Node, others: Sequence[Node], name: str = "intersect"):
        super().__init__(graph, [main, *others], name)

    def exchange_routes(self):
        return [cl.route_by_key] * len(self.inputs)

    def make_state(self):
        return {"main": {}, "others": [dict() for _ in self.inputs[1:]]}

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        # O(batch): _apply_batch_to_rows returns pre-update values of exactly
        # the touched keys; untouched keys read current state.
        tm = _apply_batch_to_rows(st["main"], inbatches[0])
        tos = [
            _apply_batch_to_rows(st["others"][i], b)
            for i, b in enumerate(inbatches[1:])
        ]
        touched: set[Pointer] = set(tm)
        for to in tos:
            touched.update(to)

        def old_value(key):
            return tm[key] if key in tm else st["main"].get(key)

        def old_in_other(i, key):
            if key in tos[i]:
                return tos[i][key] is not None
            return key in st["others"][i]

        out = []
        for key in touched:
            was_v = old_value(key)
            was = was_v is not None and all(old_in_other(i, key) for i in range(len(tos)))
            now_v = st["main"].get(key)
            now = now_v is not None and all(key in o for o in st["others"])
            if was:
                out.append(Update(key, was_v, -1))
            if now:
                out.append(Update(key, now_v, 1))
        return consolidate(out)


class SubtractNode(Node):
    """Rows of main whose key is absent from other
    (reference ``Graph::subtract_table``)."""

    def __init__(self, graph: EngineGraph, main: Node, other: Node, name: str = "difference"):
        super().__init__(graph, [main, other], name)

    def exchange_routes(self):
        return [cl.route_by_key, cl.route_by_key]

    def make_state(self):
        return {"main": {}, "other": {}}

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        tm = _apply_batch_to_rows(st["main"], inbatches[0])
        to = _apply_batch_to_rows(st["other"], inbatches[1])
        touched: set[Pointer] = set(tm) | set(to)
        out = []
        for key in touched:
            was_v = tm[key] if key in tm else st["main"].get(key)
            was_in_other = (to[key] is not None) if key in to else key in st["other"]
            was = was_v is not None and not was_in_other
            now_v = st["main"].get(key)
            now = now_v is not None and key not in st["other"]
            if was:
                out.append(Update(key, was_v, -1))
            if now:
                out.append(Update(key, now_v, 1))
        return consolidate(out)


class UpdateRowsNode(Node):
    """``a.update_rows(b)``: per key, b wins (reference
    ``Graph::update_rows_table``)."""

    def __init__(self, graph: EngineGraph, a: Node, b: Node, name: str = "update_rows"):
        super().__init__(graph, [a, b], name)

    def exchange_routes(self):
        return [cl.route_by_key, cl.route_by_key]

    def make_state(self):
        return {"a": {}, "b": {}}

    def _value(self, st, key):
        if key in st["b"]:
            return st["b"][key]
        return st["a"].get(key)

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        ta = _apply_batch_to_rows(st["a"], inbatches[0])
        tb = _apply_batch_to_rows(st["b"], inbatches[1])
        touched: set[Pointer] = set(ta) | set(tb)
        out = []
        for key in touched:
            old_a = ta[key] if key in ta else st["a"].get(key)
            old_b = tb[key] if key in tb else st["b"].get(key)
            was = old_b if old_b is not None else old_a
            now = self._value(st, key)
            if was is not None:
                out.append(Update(key, was, -1))
            if now is not None:
                out.append(Update(key, now, 1))
        return consolidate(out)


class UpdateCellsNode(Node):
    """``a.update_cells(b)``: override selected columns for keys present in b
    (reference ``Graph::update_cells_table``).  ``col_map[i]`` gives, for
    output column i, ``(source, idx)`` with source 0=a, 1=b."""

    def __init__(self, graph: EngineGraph, a: Node, b: Node, col_map: list[tuple[int, int]], name: str = "update_cells"):
        super().__init__(graph, [a, b], name)
        self.col_map = col_map

    def exchange_routes(self):
        return [cl.route_by_key, cl.route_by_key]

    def make_state(self):
        return {"a": {}, "b": {}}

    def _value(self, st, key):
        a = st["a"].get(key)
        if a is None:
            return None
        b = st["b"].get(key)
        if b is None:
            return a
        return tuple(a[i] if src == 0 else b[i] for src, i in self.col_map)

    def _value_from(self, a, b):
        if a is None:
            return None
        if b is None:
            return a
        return tuple(a[i] if src == 0 else b[i] for src, i in self.col_map)

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        ta = _apply_batch_to_rows(st["a"], inbatches[0])
        tb = _apply_batch_to_rows(st["b"], inbatches[1])
        touched: set[Pointer] = set(ta) | set(tb)
        out = []
        for key in touched:
            old_a = ta[key] if key in ta else st["a"].get(key)
            old_b = tb[key] if key in tb else st["b"].get(key)
            was = self._value_from(old_a, old_b)
            now = self._value(st, key)
            if was is not None:
                out.append(Update(key, was, -1))
            if now is not None:
                out.append(Update(key, now, 1))
        return consolidate(out)


# ---------------------------------------------------------------------------
# GroupBy / reduce


class GroupByNode(Node):
    """Incremental grouped reduction (reference ``Graph::group_by_table`` +
    ``src/engine/reduce.rs``).  Only dirty groups re-extract per epoch."""

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        group_fn: Callable[[Pointer, tuple], tuple],
        reducer_args: list[tuple[ReducerImpl, Callable[[Pointer, tuple], tuple]]],
        output_key_fn: Callable[[tuple], Pointer] | None = None,
        include_group_values: bool = True,
        name: str = "groupby",
        fast_spec: tuple | None = None,
    ):
        super().__init__(graph, [input], name)
        self.group_fn = group_fn
        self.reducer_args = reducer_args
        self.output_key_fn = output_key_fn or (lambda gvals: K.ref_scalar(*gvals))
        self.include_group_values = include_group_values
        #: (group_positions, reducer_specs) for the native partial
        #: aggregation path (groupbys.py builds it when every grouping and
        #: reducer argument is a plain positional column)
        self.fast_spec = fast_spec
        # frame segments reduce via frame_groupby_partials, which needs
        # the same positional spec as the row-batch partials kernel
        self.supports_columnar = fast_spec is not None

    def exchange_routes(self):
        route = cl.route_by(self.group_fn)
        if self.fast_spec is not None:
            # native route_split hashes the same positional group cells
            # stable_shard would (one C pass instead of per-row closures)
            route.positional = self.fast_spec[0]
        return [route]

    def specialize_append_only(self) -> list[str]:
        """Swap every reducer that has a non-retracting variant
        (reducers.append_only_variant); returns the swapped reducers'
        names.  Sound only when the input stream is proven append-only —
        the caller (analysis/rewrite.py) owns that proof.  Builds a
        fresh reducer_args list so a cloned node never mutates the
        original's.  fast_spec stays valid: variants keep native_code 2,
        the partial format the swapped-in merge_partial folds."""
        from pathway_tpu_torch.engine.reducers import append_only_variant

        swapped: list[str] = []
        new_args = []
        for impl, arg_fn in self.reducer_args:
            variant = append_only_variant(impl)
            if variant is None:
                new_args.append((impl, arg_fn))
            else:
                swapped.append(impl.name)
                new_args.append((variant, arg_fn))
        if swapped:
            self.reducer_args = new_args
        return swapped

    def make_state(self):
        # group_hash -> {gvals, accs: [...], count, last_out: tuple|None}
        return {"groups": {}}

    def _group(self, st, gvals):
        from pathway_tpu_torch.engine.stream import hashable_row

        # plain tuple hash first (scalar group keys — the common case);
        # unhashable cells fall back to the type-tagged form
        groups = st["groups"]
        try:
            g = groups.get(gvals)
            gh = gvals
        except TypeError:
            gh = hashable_row(gvals)
            g = groups.get(gh)
        if g is None:
            g = {
                "gvals": gvals,
                "accs": [r.make_acc() for r, _ in self.reducer_args],
                "count": 0,
                "last_out": None,
            }
            groups[gh] = g
        return gh, g

    def _accumulate_native(self, st, batch) -> dict | None:
        """One C pass producing per-group partials, merged per dirty group
        (native ``groupby_partials``); None -> caller runs the Python loop."""
        from pathway_tpu_torch.internals import native as _native
        from pathway_tpu_torch.engine.stream import hashable_row

        native = _native.load()
        if native is None:
            return None
        try:
            partials = native.groupby_partials(
                batch,
                self.fast_spec[0],
                self.fast_spec[1],
                api.ERROR,
                hashable_row,
            )
        except native.Unsupported:
            return None
        dirty: dict[Any, Any] = {}
        self._merge_partials(st, partials, dirty)
        return dirty

    def _merge_partials(self, st, partials: dict, dirty: dict) -> None:
        """Fold a per-group partials dict (the shared output format of
        ``groupby_partials`` and ``frame_groupby_partials``) into the
        live group accumulators, marking touched groups dirty."""
        reducer_args = self.reducer_args
        for gvals, (cdelta, parts) in partials.items():
            gh, g = self._group(st, gvals)
            g["count"] += cdelta
            for (reducer, _), acc, part in zip(reducer_args, g["accs"], parts):
                reducer.merge_partial(acc, part)
            dirty[gh] = g

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.columnar import ColumnarBatch

        st = ctx.state(self)
        batch = inbatches[0]
        frame_dirty: dict[Any, Any] = {}
        if isinstance(batch, ColumnarBatch):
            # frame segments: one native pass per frame producing the
            # SAME partials dict as the row kernel — no Update objects,
            # no per-row key hashing (groupby never looks at row keys
            # when grouping by columns, so lazy frame keys stay lazy).
            # Frames cannot hold the ERROR sentinel by construction, so
            # the error-poisoning scan below applies only to row
            # segments.  Unsupported frames (overflow, odd types) fall
            # back to rows individually.
            from pathway_tpu_torch.internals import native as _native

            native = _native.load()
            rows: list = []
            for seg_kind, seg in batch.segments:
                if seg_kind != "f":
                    rows.extend(seg)
                    continue
                partials = None
                if self.fast_spec is not None and native is not None:
                    try:
                        partials = native.frame_groupby_partials(
                            seg,
                            self.fast_spec[0],
                            self.fast_spec[1],
                            api.ERROR,
                        )
                    except native.Unsupported:
                        partials = None
                if partials is None:
                    rows.extend(native.frame_to_updates(seg))
                else:
                    self._merge_partials(st, partials, frame_dirty)
            batch = rows
        if not isinstance(batch, list):
            batch = list(batch)  # Unsupported fallback must re-iterate
        # ERROR poisoning (reference reduce.rs: any Error input makes the
        # group's aggregate Value::Error until it is retracted).  Error
        # presence is tracked per (group, reducer) in g["errs"], balanced
        # by diffs; extract() is bypassed while the count is nonzero.
        dirty: dict[Any, Any] | None = None
        if self.fast_spec is not None:
            dirty = self._accumulate_native(st, batch)
        if dirty is None:
            dirty = {}
            reducer_args = self.reducer_args
            group_fn = self.group_fn
            for u in batch:
                gvals = group_fn(u.key, u.values)
                gh, g = self._group(st, gvals)
                g["count"] += u.diff
                for ri, ((reducer, arg_fn), acc) in enumerate(
                    zip(reducer_args, g["accs"])
                ):
                    # args computed ONCE; an ERROR arg (raw cell or a
                    # computed expression that errored) or a raising
                    # arg expression poisons instead of reaching
                    # update() — multiset reducers would otherwise store
                    # the sentinel and crash at extract
                    try:
                        rargs = arg_fn(u.key, u.values)
                        poisoned = bool(reducer.n_args) and any(
                            a is api.ERROR for a in rargs
                        )
                    except Exception:
                        rargs, poisoned = None, True
                    if poisoned:
                        errs = g.setdefault("errs", {})
                        errs[ri] = errs.get(ri, 0) + u.diff
                        continue
                    reducer.update(acc, rargs, u.diff)
                dirty[gh] = g
        else:
            # native fast path: reducer args are plain column positions
            # (fast_spec), so scanning the raw cells is exact; the C
            # partials skip sum-like error args and the multiset stores
            # them symmetrically — extract is masked while poisoned.
            # The sentinel scan itself runs in C too: a per-update Python
            # any() over the cells costs more than the aggregation.
            from pathway_tpu_torch.internals import native as _native

            native = _native.load()
            err_rows = batch
            if native is not None:
                try:
                    err_rows = native.rows_with_error(batch, api.ERROR)
                except (native.Unsupported, AttributeError):
                    err_rows = batch
            for u in err_rows:
                if not any(v is api.ERROR for v in u.values):
                    continue
                gvals = self.group_fn(u.key, u.values)
                gh, g = self._group(st, gvals)
                for ri, (reducer, arg_fn) in enumerate(self.reducer_args):
                    if not reducer.n_args:
                        continue  # count() never looks at values
                    try:
                        poisoned = any(
                            a is api.ERROR for a in arg_fn(u.key, u.values)
                        )
                    except Exception:
                        poisoned = True
                    if poisoned:
                        errs = g.setdefault("errs", {})
                        errs[ri] = errs.get(ri, 0) + u.diff
                dirty[gh] = g
        if frame_dirty:
            dirty.update(frame_dirty)
        out = []
        for gh, g in dirty.items():
            # output key is a pure function of the group values — hash it
            # once per group's lifetime, not once per dirty epoch
            okey = g.get("okey")
            if okey is None:
                okey = g["okey"] = self.output_key_fn(g["gvals"])
            if g["last_out"] is not None:
                out.append(Update(okey, g["last_out"], -1))
                g["last_out"] = None
            if g["count"] > 0:
                errs = g.get("errs") or {}
                reduced = tuple(
                    api.ERROR if errs.get(ri, 0) != 0 else r.extract(acc)
                    for ri, ((r, _), acc) in enumerate(
                        zip(self.reducer_args, g["accs"])
                    )
                )
                row = (tuple(g["gvals"]) + reduced) if self.include_group_values else reduced
                out.append(Update(okey, row, 1))
                g["last_out"] = row
            elif g["count"] == 0:
                del st["groups"][gh]
        return consolidate(out)


class DeduplicateNode(Node):
    """Stateful deduplicate (reference ``Graph::deduplicate``,
    ``src/engine/graph.rs:895``): per instance, keep one accepted row;
    ``acceptor(new, old) -> bool`` decides replacement."""

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        instance_fn: Callable[[Pointer, tuple], Any],
        acceptor: Callable[[tuple, tuple | None], bool],
        name: str = "deduplicate",
    ):
        super().__init__(graph, [input], name)
        self.instance_fn = instance_fn
        self.acceptor = acceptor

    def exchange_routes(self):
        return [cl.route_by(self.instance_fn)]

    def make_state(self):
        return {"kept": {}}  # instance -> (key, values)

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.stream import hashable

        st = ctx.state(self)
        out = []
        for u in inbatches[0]:
            if u.diff <= 0:
                continue  # deduplicate consumes additions only (append-only source)
            inst = hashable(self.instance_fn(u.key, u.values))
            old = st["kept"].get(inst)
            try:
                accept = self.acceptor(u.values, old[1] if old else None)
            except Exception as e:
                ctx.log_error(self, f"deduplicate acceptor failed: {e!r}")
                continue
            if accept:
                if old is not None:
                    out.append(Update(old[0], old[1], -1))
                st["kept"][inst] = (u.key, u.values)
                out.append(Update(u.key, u.values, 1))
        return consolidate(out)


# ---------------------------------------------------------------------------
# Joins


class JoinNode(Node):
    """Incremental equi-join (reference ``Graph::join_tables``).

    Output rows: ``left_values + right_values`` (either side replaced by
    Nones when unmatched in outer modes).  Per-epoch algorithm: apply both
    deltas to the per-join-key arrangements, then recompute the output block
    for every dirty join key and emit the difference — correct for
    inner/left/right/outer under arbitrary mixed deltas.
    """

    def __init__(
        self,
        graph: EngineGraph,
        left: Node,
        right: Node,
        left_jk_fn: Callable[[Pointer, tuple], tuple],
        right_jk_fn: Callable[[Pointer, tuple], tuple],
        left_ncols: int,
        right_ncols: int,
        kind: str = "inner",  # inner|left|right|outer
        *,
        left_id_only: bool = False,
        name: str = "join",
        jk_programs: Any = None,
    ):
        super().__init__(graph, [left, right], name)
        self.left_jk_fn = left_jk_fn
        self.right_jk_fn = right_jk_fn
        self.left_ncols = left_ncols
        self.right_ncols = right_ncols
        self.kind = kind
        self.left_id_only = left_id_only
        #: (left_prog, right_prog) VM capsules computing the join-key
        #: tuple per row — enables the full native epoch pass
        self.jk_programs = jk_programs

    def exchange_routes(self):
        return [cl.route_by(self.left_jk_fn), cl.route_by(self.right_jk_fn)]

    def make_state(self):
        return {"left": {}, "right": {}}  # jk -> {row_key: values}

    def _block(self, lrows: dict, rrows: dict) -> dict[Pointer, tuple]:
        """Full output block for one join key."""
        out: dict[Pointer, tuple] = {}
        lnone = (None,) * self.left_ncols
        rnone = (None,) * self.right_ncols
        if lrows and rrows:
            if self.left_id_only and len(rrows) > 1:
                # id=pw.left.id requires at most one match per left row
                # (reference raises on duplicated ids)
                raise api.EngineError(
                    f"join with id=left.id: left row has {len(rrows)} right matches"
                )
            for lk, lv in lrows.items():
                for rk, rv in rrows.items():
                    okey = lk if self.left_id_only else K.join_key(lk, rk)
                    out[okey] = lv + rv + (lk, rk)
        elif lrows and self.kind in ("left", "outer"):
            for lk, lv in lrows.items():
                okey = lk if self.left_id_only else K.join_key(lk, None)
                out[okey] = lv + rnone + (lk, None)
        elif rrows and self.kind in ("right", "outer"):
            for rk, rv in rrows.items():
                out[K.ref_scalar("__join_r__", int(rk))] = lnone + rv + (None, rk)
        return out

    @staticmethod
    def _side_jks(batch: Batch, jk_fn) -> list:
        """Hashable join key per update (None = null key, never matches);
        computed ONCE per row and reused by the dirty scan + state apply."""
        from pathway_tpu_torch.engine.stream import hashable_row

        out = []
        for u in batch:
            jk = jk_fn(u.key, u.values)
            try:
                hash(jk)  # plain-scalar tuples: use as-is (common case)
            except TypeError:
                jk = hashable_row(jk)
            if jk is None or any(v is None for v in jk):
                jk = None
            out.append(jk)
        return out

    @staticmethod
    def _apply_side(side: dict, batch: Batch, jks: list) -> None:
        for u, jk in zip(batch, jks):
            if jk is None:
                continue  # null join keys never match
            rows = side.setdefault(jk, {})
            if u.diff > 0:
                rows[u.key] = u.values
            else:
                rows.pop(u.key, None)

    _KIND_CODES = {"inner": 0, "left": 1, "right": 2, "outer": 3}

    def _split_null_keys(self, batch, jk_fn, side: str, null_out: list):
        """Partition null-jk rows off a batch, appending their
        passthrough updates (built by :meth:`_block`, the single owner of
        the output row shape) to ``null_out``.  Returns (kept_rows,
        kept_jks)."""
        batch = list(batch)
        jks = self._side_jks(batch, jk_fn)
        if all(jk is not None for jk in jks):
            return batch, jks
        kept, kept_jks = [], []
        for u, jk in zip(batch, jks):
            if jk is not None:
                kept.append(u)
                kept_jks.append(jk)
                continue
            single = {u.key: u.values}
            block = (
                self._block(single, {})
                if side == "left"
                else self._block({}, single)
            )
            null_out.extend(
                Update(okey, vals, u.diff) for okey, vals in block.items()
            )
        return kept, kept_jks

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        native = _native.load()
        if native is not None and self.jk_programs is not None:
            # whole-epoch native pass (build/probe/diff in C, mirroring
            # groupby_partials); Unsupported is only raised BEFORE the
            # arrangements mutate, so the fallback below re-runs safely
            try:
                out = native.join_process(
                    inbatches[0],
                    inbatches[1],
                    self.jk_programs[0],
                    self.jk_programs[1],
                    st["left"],
                    st["right"],
                    self._KIND_CODES[self.kind],
                    1 if self.left_id_only else 0,
                    self.left_ncols,
                    self.right_ncols,
                    Update,
                    api.ERROR,
                    api.EngineError,
                )
            except native.Unsupported:
                pass
            else:
                return consolidate(out)
        # SQL outer semantics: a null join key never MATCHES, but the row
        # is RETAINED unmatched on its preserved side (LEFT/RIGHT/FULL
        # OUTER keep null-key rows; only INNER drops them).  The native
        # pass emits these passthroughs itself
        # (join_emit_null_passthroughs); this split only runs on the
        # Python fallback, and its jks feed the arrangement pass below so
        # nothing is evaluated twice.
        null_out: list[Update] = []
        ljks = rjks = None
        if self.kind in ("left", "outer"):
            left_b, ljks = self._split_null_keys(
                inbatches[0], self.left_jk_fn, "left", null_out
            )
            inbatches = [left_b, inbatches[1]]
        if self.kind in ("right", "outer"):
            right_b, rjks = self._split_null_keys(
                inbatches[1], self.right_jk_fn, "right", null_out
            )
            inbatches = [inbatches[0], right_b]
        if ljks is None:
            ljks = self._side_jks(inbatches[0], self.left_jk_fn)
        if rjks is None:
            rjks = self._side_jks(inbatches[1], self.right_jk_fn)
        dirty_keys: set = set()
        dirty_keys.update(jk for jk in ljks if jk is not None)
        dirty_keys.update(jk for jk in rjks if jk is not None)
        old_blocks = {
            jk: self._block(st["left"].get(jk, {}), st["right"].get(jk, {}))
            for jk in dirty_keys
        }
        self._apply_side(st["left"], inbatches[0], ljks)
        self._apply_side(st["right"], inbatches[1], rjks)
        out: list[Update] = []
        for jk in dirty_keys:
            new_block = self._block(st["left"].get(jk, {}), st["right"].get(jk, {}))
            old_block = old_blocks[jk]
            for okey, vals in old_block.items():
                if new_block.get(okey) != vals:
                    out.append(Update(okey, vals, -1))
            for okey, vals in new_block.items():
                if old_block.get(okey) != vals:
                    out.append(Update(okey, vals, 1))
            if not st["left"].get(jk) and not st["right"].get(jk):
                st["left"].pop(jk, None)
                st["right"].pop(jk, None)
        return consolidate(out + null_out)


class IxNode(Node):
    """Row lookup by pointer (reference ``Graph::ix_table``): for each request
    row holding a key into `target`, output the target row under the request's
    key.  Maintains a reverse index so target changes re-resolve requests."""

    def __init__(
        self,
        graph: EngineGraph,
        target: Node,
        requests: Node,
        key_fn: Callable[[Pointer, tuple], Any],
        target_ncols: int,
        optional: bool = False,
        strict: bool = True,
        name: str = "ix",
    ):
        super().__init__(graph, [target, requests], name)
        self.key_fn = key_fn
        self.optional = optional
        self.strict = strict
        self.target_ncols = target_ncols

    def exchange_routes(self):
        from pathway_tpu_torch.engine import cluster as cl

        def route_request(u):
            try:
                tkey = self.key_fn(u.key, u.values)
            except Exception:
                return 0
            if tkey is None or tkey is api.ERROR:
                return 0
            return int(tkey)

        return [cl.route_by_key, route_request]

    def make_state(self):
        # out: req_key -> last emitted values (the cache that keeps
        # retractions consistent when target and requests change together)
        return {"target": {}, "requests": {}, "reverse": {}, "out": {}}

    def _resolve(self, st, req_key, req_vals):
        """Return (output_values_or_None, target_key_or_None) against the
        CURRENT target state."""
        tkey = self.key_fn(req_key, req_vals)
        if tkey is None or tkey is api.ERROR:
            if self.optional:
                return (None,) * self.target_ncols, None
            return tuple([api.ERROR] * self.target_ncols), None
        tv = st["target"].get(tkey)
        if tv is None:
            if self.strict:
                return tuple([api.ERROR] * self.target_ncols), tkey
            return None, tkey
        return tv, tkey

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        out: list[Update] = []
        touched_targets = _apply_batch_to_rows(st["target"], inbatches[0])
        handled: set[Pointer] = set()
        for u in inbatches[1]:
            handled.add(u.key)
            if u.diff > 0:
                vals, tkey = self._resolve(st, u.key, u.values)
                st["requests"][u.key] = u.values
                if tkey is not None:
                    st["reverse"].setdefault(tkey, set()).add(u.key)
                if vals is not None:
                    out.append(Update(u.key, vals, 1))
                    st["out"][u.key] = vals
            else:
                _, tkey = self._resolve(st, u.key, u.values)
                st["requests"].pop(u.key, None)
                if tkey is not None:
                    st["reverse"].get(tkey, set()).discard(u.key)
                prev = st["out"].pop(u.key, None)
                if prev is not None:
                    out.append(Update(u.key, prev, -1))
        for tkey in touched_targets:
            for rkey in list(st["reverse"].get(tkey, set())):
                if rkey in handled or rkey not in st["requests"]:
                    continue
                new_out, _ = self._resolve(st, rkey, st["requests"][rkey])
                old_out = st["out"].get(rkey)
                if old_out == new_out:
                    continue
                if old_out is not None:
                    out.append(Update(rkey, old_out, -1))
                if new_out is not None:
                    out.append(Update(rkey, new_out, 1))
                    st["out"][rkey] = new_out
                else:
                    st["out"].pop(rkey, None)
        return consolidate(out)


class ZipNode(Node):
    """Zip same-universe tables by key: output tuple = concatenation of every
    input's values (inner semantics — a key emits only when present in all
    inputs).  Supports select() referencing columns of several same-universe
    tables, the capability the reference gets from its column/universe model
    (``internals/column.py``)."""

    def __init__(self, graph: EngineGraph, inputs: Sequence[Node], widths: Sequence[int], name: str = "zip"):
        super().__init__(graph, inputs, name)
        self.widths = list(widths)

    def exchange_routes(self):
        return [cl.route_by_key] * len(self.inputs)

    def make_state(self):
        return {"rows": [dict() for _ in self.inputs], "out": {}}

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        touched: set[Pointer] = set()
        for i, b in enumerate(inbatches):
            touched.update(_apply_batch_to_rows(st["rows"][i], b).keys())
        out: list[Update] = []
        for key in touched:
            parts = [st["rows"][i].get(key) for i in range(len(self.inputs))]
            new = None
            if all(p is not None for p in parts):
                new = tuple(v for p in parts for v in p)
            old = st["out"].get(key)
            if old == new:
                continue
            if old is not None:
                out.append(Update(key, old, -1))
            if new is not None:
                out.append(Update(key, new, 1))
                st["out"][key] = new
            else:
                st["out"].pop(key, None)
        return consolidate(out)


class ErrorLogNode(Node):
    """The global error-log TABLE's source (reference
    ``parse_graph.add_error_log`` + ``src/engine/error.rs``): drains the
    run context's pending error entries every epoch into rows
    ``(message, operator, trace)``.  Errors raised by operators processed
    after this node in an epoch surface one epoch later (and the final
    flush epoch drains the tail)."""

    always_tick = True

    def __init__(self, graph: EngineGraph, name: str = "error_log"):
        super().__init__(graph, [], name)

    def make_state(self):
        return {"seq": 0}

    def process(self, ctx, time, inbatches):
        if not ctx.error_pending:
            return []
        st = ctx.state(self)
        out = []
        for entry in ctx.error_pending:
            st["seq"] += 1
            key = K.ref_scalar("__error__", ctx.worker_id, st["seq"])
            out.append(
                Update(key, (entry.message, entry.operator, entry.trace), 1)
            )
        ctx.error_pending = []
        return out


class GradualBroadcastNode(Node):
    """Apportioned broadcast of a changing scalar (reference
    ``gradual_broadcast`` operator,
    ``src/engine/dataflow/operators/gradual_broadcast.rs``, 490 LoC).

    Port 0: the keyed table; port 1: a (usually 1-row) threshold table
    whose rows yield an approximation triplet ``(lower, value, upper)``
    via ``triplet_fn``.  Every output row carries an extra ``apx_value``
    column holding SOME value within the most recent ``[lower, upper]``
    window; a row's apx only changes when its held value falls OUTSIDE
    the new window.  This is the churn-damping contract the reference
    provides: a slightly-changed global aggregate (e.g. Louvain's total
    edge weight) does not retract/re-emit every row downstream."""

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        threshold: Node,
        triplet_fn: Callable[[Pointer, tuple], tuple],
        name: str = "gradual_broadcast",
    ):
        super().__init__(graph, [input, threshold], name)
        self.triplet_fn = triplet_fn

    # the threshold triplet is global state: centralize like the
    # reference's temporal buffers (TimeKey::shard() -> one worker)
    exchange_routes = cl.route_all_to_zero

    def make_state(self):
        return {"rows": {}, "apx": {}, "cur": None}

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        out: list[Update] = []
        # newest triplet first, so rows arriving this epoch use it
        trip = None
        for u in inbatches[1]:
            if u.diff > 0:
                trip = self.triplet_fn(u.key, u.values)
        if trip is not None:
            lower, value, upper = (float(x) for x in trip)
            st["cur"] = (lower, value, upper)
            for key, apx in list(st["apx"].items()):
                if apx is not None and lower <= apx <= upper:
                    continue  # still inside the window: no churn
                vals = st["rows"].get(key)
                if vals is None:
                    continue
                out.append(Update(key, vals + (apx,), -1))
                out.append(Update(key, vals + (value,), 1))
                st["apx"][key] = value
        removals = [u for u in inbatches[0] if u.diff < 0]
        additions = [u for u in inbatches[0] if u.diff > 0]
        for u in removals:
            vals = st["rows"].pop(u.key, None)
            apx = st["apx"].pop(u.key, None)
            if vals is not None:
                out.append(Update(u.key, vals + (apx,), -1))
        cur = st["cur"]
        for u in additions:
            apx = cur[1] if cur is not None else None
            st["rows"][u.key] = u.values
            st["apx"][u.key] = apx
            out.append(Update(u.key, u.values + (apx,), 1))
        return consolidate(out)


class SortNode(Node):
    """Sorting index: emits (prev, next) pointer columns per row, ordered by a
    sort key within an instance (reference ``prev_next`` operator,
    ``src/engine/dataflow/operators/prev_next.rs``).  Dirty instances are
    re-sorted per epoch; only rows whose neighbours changed re-emit."""

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        key_fn: Callable[[Pointer, tuple], Any],
        instance_fn: Callable[[Pointer, tuple], Any],
        name: str = "sort",
    ):
        super().__init__(graph, [input], name)
        self.key_fn = key_fn
        self.instance_fn = instance_fn

    def exchange_routes(self):
        return [cl.route_by(self.instance_fn)]

    def make_state(self):
        # instances: inst -> {row_key: sort_val}; out: row_key -> (prev, next)
        return {"instances": {}, "out": {}, "inst_of": {}}

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.stream import hashable

        st = ctx.state(self)
        dirty: set = set()
        removed: list[Pointer] = []
        for u in inbatches[0]:
            inst = hashable(self.instance_fn(u.key, u.values))
            rows = st["instances"].setdefault(inst, {})
            if u.diff > 0:
                rows[u.key] = self.key_fn(u.key, u.values)
                st["inst_of"][u.key] = inst
            else:
                rows.pop(u.key, None)
                st["inst_of"].pop(u.key, None)
                removed.append(u.key)
            dirty.add(inst)
        out: list[Update] = []
        for rk in removed:
            pair = st["out"].pop(rk, None)
            if pair is not None:
                out.append(Update(rk, pair, -1))
        for inst in dirty:
            rows = st["instances"].get(inst, {})
            ordering = sorted(rows.items(), key=lambda kv: (kv[1], kv[0]))
            for i, (rk, _sv) in enumerate(ordering):
                prev = ordering[i - 1][0] if i > 0 else None
                nxt = ordering[i + 1][0] if i + 1 < len(ordering) else None
                pair = (prev, nxt)
                old = st["out"].get(rk)
                if old != pair:
                    if old is not None:
                        out.append(Update(rk, old, -1))
                    out.append(Update(rk, pair, 1))
                    st["out"][rk] = pair
            if not rows:
                st["instances"].pop(inst, None)
        return consolidate(out)


# ---------------------------------------------------------------------------
# Async / batched UDF execution


class AsyncMapNode(Node):
    """Per-epoch micro-batched async map (reference ``map_named_async``,
    ``src/engine/dataflow/operators.rs:218-305``): collect all additions in
    the epoch, run one batched async/jitted call, emit results at the same
    epoch.  Retractions replay the cached result."""

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        batch_fn: Callable[[list[tuple]], list[Any]],
        name: str = "async_map",
        distributed: bool = False,
    ):
        super().__init__(graph, [input], name)
        self.batch_fn = batch_fn
        #: False (default): all rows route to worker 0 — REQUIRED for
        #: device-batched UDFs (one TPU host executes one big batch;
        #: sharding would split it into per-worker fragments on workers
        #: without the device).  True: shard rows by key — right for
        #: IO-bound async UDFs (API calls), whose concurrency scales with
        #: workers instead of funneling through one.
        self.distributed = distributed

    def exchange_routes(self):
        return [cl.route_by_key if self.distributed else cl.route_to_zero]

    def make_state(self):
        return {"cache": {}}  # key -> result

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        additions = [u for u in inbatches[0] if u.diff > 0]
        removals = [u for u in inbatches[0] if u.diff < 0]
        out: list[Update] = []
        if additions:
            try:
                results = self.batch_fn([u.values for u in additions])
            except Exception as e:
                ctx.log_error(self, f"{self.name}: batched UDF failed: {e!r}")
                results = [api.ERROR] * len(additions)
            for u, res in zip(additions, results):
                st["cache"][u.key] = res
                out.append(Update(u.key, u.values + (res,), 1))
        for u in removals:
            res = st["cache"].get(u.key, api.ERROR)
            out.append(Update(u.key, u.values + (res,), -1))
        return out


# ---------------------------------------------------------------------------
# Outputs


def _record_sink_latency(ctx) -> None:
    """Per-stage latency probe at a sink (sink = epoch cut -> delivery
    here, e2e = earliest connector enqueue -> delivery); anchors are set
    by the scheduler only for live streaming epochs."""
    lat = getattr(ctx, "latency", None)
    if lat is None:
        return
    done_ns = lat.now_ns()
    cut_ns = getattr(ctx, "epoch_cut_ns", None)
    if cut_ns is not None:
        lat.record("sink", done_ns - cut_ns)
    origin_ns = getattr(ctx, "epoch_origin_ns", None)
    if origin_ns is not None:
        lat.record("e2e", done_ns - origin_ns)


class OutputNode(Node):
    """subscribe_table (reference ``src/engine/graph.rs:754``,
    ``SubscribeCallbacks`` ``:569``)."""

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        on_change: Callable[[Pointer, tuple, int, int], None] | None = None,
        on_time_end: Callable[[int], None] | None = None,
        on_end: Callable[[], None] | None = None,
        name: str = "subscribe",
        writer: Any = None,
    ):
        super().__init__(graph, [input], name)
        self._on_change = on_change
        self._on_time_end = on_time_end
        self._on_end = on_end
        #: the file writer behind this sink, when there is one — enables
        #: checkpointed sink-dedup watermarks (see on_restore)
        self._writer = writer

    def exchange_routes(self):
        return [cl.route_to_zero]

    def make_state(self):
        return {"saw_data": False}

    def process(self, ctx, time, inbatches):
        if self._on_change is not None:
            for u in inbatches[0]:
                self._on_change(u.key, u.values, time, u.diff)
        if inbatches[0]:
            ctx.state(self)["saw_data"] = True
            _record_sink_latency(ctx)
        return []

    def on_time_end(self, ctx, time):
        # multi-worker: all updates are routed to worker 0, which alone
        # drives the output lifecycle (single-writer semantics)
        if ctx.worker_id == 0 and self._on_time_end is not None:
            self._on_time_end(time)
            if self._writer is not None:
                # sink dedup watermark: the byte offset of everything
                # emitted through this epoch, checkpointed with the
                # operator state — on_restore truncates the file back to
                # it, so replayed epochs never double-emit
                wm = getattr(self._writer, "watermark", None)
                if wm is not None:
                    ctx.state(self)["sink_watermark"] = wm()

    def on_end(self, ctx):
        if ctx.worker_id == 0 and self._on_end is not None:
            self._on_end()

    def on_restore(self, ctx):
        if ctx.worker_id != 0 or self._writer is None:
            return
        resume = getattr(self._writer, "resume_at", None)
        watermark = ctx.state(self).get("sink_watermark")
        if resume is not None and watermark is not None:
            resume(watermark)


class ExportNode(Node):
    """Cross-graph table export (reference ``ExportedTable``:
    ``src/engine/dataflow/export.rs``, ``src/engine/graph.rs:630``): a
    thread-safe update log with a closed-epoch frontier, offset reads, and
    replay-then-live subscriptions.  Another graph imports it through
    ``internals.interactive.import_table`` and continues from the stream."""

    def __init__(self, graph: EngineGraph, input: Node, name: str = "export"):
        import threading

        super().__init__(graph, [input], name)
        self._lock = threading.Lock()
        self._log: list[tuple[int, Pointer, tuple, int]] = []
        self._frontier = -1
        self._closed = False
        self._subs: list[Callable] = []

    def exchange_routes(self):
        return [cl.route_to_zero]

    def process(self, ctx, time, inbatches):
        batch = [(time, u.key, u.values, u.diff) for u in inbatches[0]]
        # callbacks run UNDER the lock so delivery order matches log order
        # and subscribe()'s replay-then-live handoff has no gap; callbacks
        # must not call back into this export (they'd deadlock)
        with self._lock:
            self._log.extend(batch)
            self._frontier = time
            for cb in self._subs:
                cb(batch, time)
        return []

    def on_end(self, ctx):
        with self._lock:
            self._closed = True

    # --- reader side (any thread) ------------------------------------
    def frontier(self) -> int:
        """Last closed epoch exported so far (reference
        ``ExportedTable::frontier``)."""
        with self._lock:
            return self._frontier

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def data_from_offset(
        self, offset: int
    ) -> tuple[list[tuple[int, Pointer, tuple, int]], int, int, bool]:
        """Updates from ``offset`` on: (batch, next_offset, frontier,
        closed) — reference ``ExportedTable::data_from_offset``."""
        with self._lock:
            batch = self._log[offset:]
            return batch, len(self._log), self._frontier, self._closed

    def subscribe(self, cb: Callable, replay: bool = True) -> None:
        """``cb(batch, frontier)``; with ``replay`` the full history is
        delivered first, atomically with registration (the history call
        and all live deliveries happen under one lock, so no epoch can
        slip between or around them)."""
        with self._lock:
            if replay and self._log:
                cb(list(self._log), self._frontier)
            self._subs.append(cb)


class CaptureNode(Node):
    """Collects the final table state + full update stream (test/debug
    support — reference captured-stream test utilities)."""

    def __init__(self, graph: EngineGraph, input: Node, name: str = "capture"):
        super().__init__(graph, [input], name)

    def exchange_routes(self):
        return [cl.route_to_zero]

    def make_state(self):
        return {"rows": {}, "stream": []}

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        if inbatches[0]:
            _record_sink_latency(ctx)
        native = _native.load()
        if native is not None:
            native.capture_batch(st["stream"], st["rows"], inbatches[0], time)
            return []
        for u in inbatches[0]:
            st["stream"].append((u.key, u.values, time, u.diff))
            if u.diff > 0:
                st["rows"][u.key] = u.values
            else:
                st["rows"].pop(u.key, None)
        return []
