"""``pw.iterate`` — fixed-point iteration (counterpart of
``pathway_tpu/internals/iterate.py``; the port's node also records the
inner rounds of each solve in ``IterateNode.rounds``).

Reference: ``pw.iterate`` builds a differential-dataflow subscope with
feedback variables (``Graph::iterate`` ``src/engine/graph.rs:941-949``,
``complex_columns.rs``).  Here the body is built into a SUBGRAPH whose
input placeholders are re-fed with the body's outputs until the row sets
stabilize (or ``iteration_limit`` is hit); the solve re-runs per epoch
when the outer inputs change — same externally observable fixpoint,
batch-style inner loop instead of differential nesting.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.engine.stream import Update, consolidate
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

__all__ = ["iterate", "iterate_universe"]


class IterateNode(eg.Node):
    """inputs = outer nodes (ordered as ``names``).  Emits rows tagged
    with their output-table index: values = (out_idx,) + inner_values."""

    def __init__(
        self,
        graph: eg.EngineGraph,
        outer_inputs: list[eg.Node],
        names: list[str],
        subgraph: eg.EngineGraph,
        placeholders: dict[str, eg.Node],
        captures: dict[str, eg.CaptureNode],
        out_names: list[str],
        iteration_limit: int | None,
        name: str = "iterate",
    ):
        super().__init__(graph, outer_inputs, name)
        self.names = names
        self.subgraph = subgraph
        self.placeholders = placeholders
        self.captures = captures
        self.out_names = out_names
        self.iteration_limit = iteration_limit
        #: the inner rounds of each solve, in order (host-side stats: the
        #: JAX package's node keeps none)
        self.rounds: list[int] = []

    def make_state(self):
        return {
            "in": [dict() for _ in self.inputs],
            "last": {n: {} for n in self.out_names},
        }

    def exchange_routes(self):
        # the fixpoint solve is self-contained: centralize on worker 0
        from pathway_tpu_torch.engine import cluster as cl

        return cl.route_all_to_zero(self)

    def _solve(self, st) -> dict[str, dict]:
        from pathway_tpu_torch.engine.scheduler import Scheduler

        current: dict[str, dict] = {
            n: dict(st["in"][i]) for i, n in enumerate(self.names)
        }
        limit = self.iteration_limit if self.iteration_limit is not None else 1000
        outputs: dict[str, dict] = {n: {} for n in self.out_names}
        rounds = 0
        for _ in range(max(1, limit)):
            rounds += 1
            sched = Scheduler(self.subgraph)
            inject = {
                self.placeholders[n].id: [
                    Update(k, v, 1) for k, v in current[n].items()
                ]
                for n in self.names
            }
            sched.run_epoch(0, inject)
            outputs = {
                n: dict(sched.ctx.state(self.captures[n])["rows"])
                for n in self.out_names
            }
            next_state = {
                n: outputs.get(n, current[n]) for n in self.names
            }
            if next_state == current:
                break
            current = next_state
        self.rounds.append(rounds)
        return outputs

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        changed = False
        for i, batch in enumerate(inbatches):
            for u in consolidate(batch):
                changed = True
                if u.diff > 0:
                    st["in"][i][u.key] = u.values
                else:
                    st["in"][i].pop(u.key, None)
        if not changed:
            return []
        outputs = self._solve(st)
        out: list[Update] = []
        for oi, n in enumerate(self.out_names):
            new_rows = outputs.get(n, {})
            old_rows = st["last"][n]
            for k, v in old_rows.items():
                if new_rows.get(k) != v:
                    out.append(Update(k, (oi,) + v, -1))
            for k, v in new_rows.items():
                if old_rows.get(k) != v:
                    out.append(Update(k, (oi,) + v, 1))
            st["last"][n] = new_rows
        return consolidate(out)


def iterate(
    func: Callable[..., Any],
    iteration_limit: int | None = None,
    **kwargs: Table,
) -> Any:
    """Iterate ``func`` to a fixed point.  ``func`` receives tables (by
    the kwarg names) and returns a table / dict / namedtuple of tables;
    returned tables matching input names feed back into the next
    iteration (reference ``pw.iterate`` semantics)."""
    names = list(kwargs.keys())
    outer_tables = [kwargs[n] for n in names]

    sub = eg.EngineGraph()
    placeholders: dict[str, eg.Node] = {}
    subtables: dict[str, Table] = {}
    outer_graph = G.engine_graph
    G.engine_graph = sub
    try:
        for n in names:
            t = kwargs[n]
            node = eg.InputNode(sub, n_cols=len(t._column_names), name=f"iter_{n}")
            placeholders[n] = node
            subtables[n] = Table(
                node, t._column_names, t._dtypes, name=f"iterate.{n}"
            )
        result = func(**subtables)
    finally:
        G.engine_graph = outer_graph

    if isinstance(result, Table):
        # a single returned table feeds back into the FIRST input; other
        # inputs are read-only context for the body
        out_map = {names[0]: result}
        single = result
    elif isinstance(result, dict):
        out_map = dict(result)
        single = None
    elif hasattr(result, "_asdict"):
        out_map = dict(result._asdict())
        single = None
    else:
        raise TypeError("iterate body must return a Table, dict, or namedtuple")

    captures: dict[str, eg.CaptureNode] = {}
    saved = G.engine_graph
    G.engine_graph = sub
    try:
        for n, t in out_map.items():
            captures[n] = eg.CaptureNode(sub, t._node, name=f"iter_cap_{n}")
    finally:
        G.engine_graph = saved

    out_names = list(out_map.keys())
    node = IterateNode(
        G.engine_graph,
        [t._node for t in outer_tables],
        names,
        sub,
        placeholders,
        captures,
        out_names,
        iteration_limit,
    )

    results: dict[str, Table] = {}
    for oi, n in enumerate(out_names):
        t = out_map[n]
        fnode = eg.FilterNode(
            G.engine_graph, node, lambda k, v, oi=oi: v[0] == oi, name=f"iter_out_{n}"
        )
        snode = eg.RowwiseNode(
            G.engine_graph, fnode, lambda k, v: v[1:], name=f"iter_strip_{n}"
        )
        results[n] = Table(snode, t._column_names, t._dtypes, name=f"iterate.{n}")

    if single is not None:
        return results[out_names[0]]
    if hasattr(result, "_asdict"):
        return type(result)(**results)
    return results


def iterate_universe(func: Callable[..., Any], **kwargs: Table) -> Any:
    """Reference ``pw.iterate_universe`` — iterate where the universe may
    change between steps (our iterate already allows that)."""
    return iterate(func, **kwargs)
