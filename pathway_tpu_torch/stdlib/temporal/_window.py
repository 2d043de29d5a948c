"""Windows + ``windowby`` (reference ``stdlib/temporal/_window.py:595-905``).

Window assignment is a stateless rowwise flatten (a row can land in
several sliding windows); grouped reduction rides the engine's
incremental GroupByNode; behaviors (delay/cutoff/keep_results) are the
engine :class:`TemporalBehaviorNode` between assignment and reduction,
driven by the event-time watermark.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.engine.temporal import TemporalBehaviorNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals.expression import ColumnExpression, _wrap
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this as THIS
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
)

__all__ = [
    "Window",
    "tumbling",
    "sliding",
    "session",
    "intervals_over",
    "windowby",
    "WindowedTable",
]


class Window:
    def assign(self, t: Any, instance: Any) -> list[tuple]:
        """-> list of (instance, start, end) window triples."""
        raise NotImplementedError


@dataclasses.dataclass
class TumblingWindow(Window):
    duration: Any
    origin: Any = None
    offset: Any = None

    def assign(self, t, instance):
        origin = self.origin if self.origin is not None else (self.offset or 0)
        n = math.floor((t - origin) / self.duration)
        start = origin + n * self.duration
        return [(instance, start, start + self.duration)]


@dataclasses.dataclass
class SlidingWindow(Window):
    hop: Any
    duration: Any
    origin: Any = None
    offset: Any = None

    def assign(self, t, instance):
        origin = self.origin if self.origin is not None else (self.offset or 0)
        out = []
        # windows [s, s+duration) with s = origin + i*hop containing t
        first = math.floor((t - self.duration - origin) / self.hop) + 1
        i = first
        while True:
            s = origin + i * self.hop
            if s > t:
                break
            if t < s + self.duration:
                out.append((instance, s, s + self.duration))
            i += 1
        return out


@dataclasses.dataclass
class SessionWindow(Window):
    """Session windows merge rows closer than ``max_gap`` (or linked by
    ``predicate``); assignment is stateful per instance, handled by
    :class:`SessionAssignNode`."""

    predicate: Any = None
    max_gap: Any = None


@dataclasses.dataclass
class IntervalsOverWindow(Window):
    at: Any  # ColumnReference with the probe time points
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True  # match the intervals_over() factory default


def tumbling(duration: Any, origin: Any = None, offset: Any = None) -> TumblingWindow:
    return TumblingWindow(duration, origin, offset)


def sliding(hop: Any, duration: Any = None, ratio: int | None = None, origin: Any = None, offset: Any = None) -> SlidingWindow:
    if duration is None:
        assert ratio is not None, "sliding() needs duration or ratio"
        duration = hop * ratio
    return SlidingWindow(hop, duration, origin, offset)


def session(predicate: Any = None, max_gap: Any = None) -> SessionWindow:
    if (predicate is None) == (max_gap is None):
        raise ValueError("session() needs exactly one of predicate / max_gap")
    return SessionWindow(predicate, max_gap)


def intervals_over(*, at: Any, lower_bound: Any, upper_bound: Any, is_outer: bool = True) -> IntervalsOverWindow:
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


class SessionAssignNode(eg.Node):
    """Stateful session clustering: per instance, sort rows by time and
    merge neighbours per max_gap/predicate; dirty instances re-cluster
    (reference session windows in ``_window.py:595+``)."""

    def __init__(self, graph, input, time_fn, instance_fn, window: SessionWindow, name="session_assign"):
        super().__init__(graph, [input], name)
        self.time_fn = time_fn
        self.instance_fn = instance_fn
        self.window = window

    def make_state(self):
        # instances: inst -> {row_key: (values, time)}; out: row_key -> assigned values
        return {"instances": {}, "out": {}}

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.stream import consolidate, hashable

        st = ctx.state(self)
        dirty = set()
        for u in consolidate(inbatches[0]):
            inst = hashable(self.instance_fn(u.key, u.values))
            rows = st["instances"].setdefault(inst, {})
            if u.diff > 0:
                rows[u.key] = (u.values, self.time_fn(u.key, u.values))
            else:
                rows.pop(u.key, None)
            dirty.add(inst)
        out = []
        for inst in dirty:
            rows = st["instances"].get(inst, {})
            ordering = sorted(rows.items(), key=lambda kv: (kv[1][1], str(kv[0])))
            # cluster
            clusters: list[list] = []
            prev_t = None
            for rk, (values, t) in ordering:
                new = prev_t is None
                if not new:
                    if self.window.max_gap is not None:
                        new = (t - prev_t) > self.window.max_gap
                    else:
                        new = not self.window.predicate(prev_t, t)
                if new:
                    clusters.append([])
                clusters[-1].append((rk, values, t))
                prev_t = t
            assigned: dict = {}
            for cluster in clusters:
                start = min(t for _, _, t in cluster)
                end = max(t for _, _, t in cluster)
                for rk, values, _t in cluster:
                    assigned[rk] = values + ((inst, start, end),)
            for rk, row in assigned.items():
                old = st["out"].get(rk)
                if old != row:
                    if old is not None:
                        out.append(eg.Update(rk, old, -1))
                    out.append(eg.Update(rk, row, 1))
                    st["out"][rk] = row
        # rows removed from the input retract their assignment
        for u in inbatches[0]:
            if u.diff < 0 and u.key in st["out"]:
                old = st["out"].pop(u.key)
                out.append(eg.Update(u.key, old, -1))
        return consolidate(out)


class WindowedTable:
    """Result of ``windowby``: call ``.reduce(...)``.  Inside reduce,
    ``pw.this._pw_window_start`` / ``_pw_window_end`` / ``_pw_instance``
    /``_pw_window`` are available (reference window columns)."""

    def __init__(self, assigned: Table, shard_expr: Any):
        self._assigned = assigned
        self._shard = shard_expr

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        t = self._assigned
        grouped = t.groupby(t["_pw_window"])
        extras = self._gather(args, kwargs)
        extras.pop("_pw_window", None)
        out = grouped.reduce(_pw_window=t["_pw_window"], **extras)
        final = out.with_columns(
            _pw_instance=pw.apply(lambda w: w[0], out["_pw_window"]),
            _pw_window_start=pw.apply(lambda w: w[1], out["_pw_window"]),
            _pw_window_end=pw.apply(lambda w: w[2], out["_pw_window"]),
        )
        return final

    def _gather(self, args, kwargs) -> dict[str, Any]:
        from pathway_tpu_torch.internals.expression import smart_name

        t = self._assigned
        window_cols = {
            "_pw_window": t["_pw_window"],
            "_pw_window_start": pw.apply(lambda w: w[1], t["_pw_window"]),
            "_pw_window_end": pw.apply(lambda w: w[2], t["_pw_window"]),
            "_pw_instance": pw.apply(lambda w: w[0], t["_pw_window"]),
        }
        out: dict[str, Any] = {}
        for a in args:
            e = _wrap(a)._substitute({THIS: t})
            n = smart_name(e)
            if n is None:
                raise ValueError("positional reduce() args must be named columns")
            out[n] = window_cols.get(n, e)
        for n, a in kwargs.items():
            e = _wrap(a)._substitute({THIS: t})
            if isinstance(a, str) and a in window_cols:
                e = window_cols[a]
            out[n] = window_cols.get(getattr(e, "_name", None), e)
        return out


def windowby(
    table: Table,
    time_expr: Any,
    *,
    window: Window,
    behavior: Behavior | None = None,
    instance: Any = None,
    shard: Any = None,
) -> WindowedTable:
    """reference ``_window.py:windowby`` (``:820+``)"""
    time_e = _wrap(time_expr)._substitute({THIS: table})
    inst_e = (
        _wrap(instance if instance is not None else shard)._substitute({THIS: table})
        if (instance is not None or shard is not None)
        else None
    )
    layout = table._layout()
    tc = time_e._compile(layout.resolver)
    ic = inst_e._compile(layout.resolver) if inst_e is not None else (lambda kv: None)

    if isinstance(window, IntervalsOverWindow):
        return _intervals_over_windowby(table, tc, ic, window, behavior)

    if isinstance(window, SessionWindow):
        node = SessionAssignNode(
            G.engine_graph,
            table._node,
            lambda k, v: tc((k, v)),
            lambda k, v: ic((k, v)),
            window,
        )
        # analyzer annotation (graph_facts): session assignment is a
        # windowing construct — bounds downstream stateful key spaces
        node.meta["temporal"] = {"kind": "session_window", "bounded": True}
        assigned = Table(
            node,
            table._column_names + ["_pw_window"],
            {**table._dtypes, "_pw_window": dt.ANY},
            name="session_windows",
        )
    else:
        win = window

        def assign_row(key, values):
            t = tc((key, values))
            inst = ic((key, values))
            return values + (tuple(win.assign(t, inst)),)

        rnode = eg.RowwiseNode(G.engine_graph, table._node, assign_row, name="window_assign")
        rnode.meta["temporal"] = {
            "kind": "window_assign",
            "window": type(win).__name__,
            "bounded": True,
        }
        multi = Table(
            rnode,
            table._column_names + ["_pw_windows"],
            {**table._dtypes, "_pw_windows": dt.ANY},
            name="window_assign",
        )
        flat = multi.flatten(multi["_pw_windows"])
        assigned = flat.select(
            *[flat[c] for c in table._column_names],
            _pw_window=flat["_pw_windows"],
        )

    if behavior is not None:
        # original column positions are preserved in `assigned`, so the
        # compiled time accessor works on its rows: the watermark advances
        # by TRUE event time
        assigned = _apply_behavior(assigned, behavior, lambda k, v: tc((k, v)))
    return WindowedTable(assigned, inst_e)


def _apply_behavior(
    assigned: Table, behavior: Behavior, time_fn, window_end_offset: Any = 0
) -> Table:
    """``window_end_offset`` shifts where a window CLOSES relative to its
    tuple's end field: intervals_over windows store the probe point p in
    both slots while their data band extends to p + upper_bound — the
    cutoff/shift must anchor at the band end, or in-band rows past the
    probe freeze their own window (late-row loss)."""
    widx = assigned._column_names.index("_pw_window")
    off = window_end_offset

    if isinstance(behavior, ExactlyOnceBehavior):
        shift = (behavior.shift or 0) + off
        # exactly-once: buffer the whole window, release at close + shift,
        # then freeze (late rows dropped); results kept
        thr_fn = lambda k, v, s=shift: v[widx][2] + s  # noqa: E731
        exp_fn = lambda k, v, s=shift: v[widx][2] + s  # noqa: E731
        node = TemporalBehaviorNode(
            G.engine_graph,
            assigned._node,
            time_fn=time_fn,
            threshold_fn=thr_fn,
            expiry_fn=exp_fn,
            keep_results=True,
        )
        node.meta["temporal"] = {
            "kind": "behavior",
            "behavior": "exactly_once",
            "bounded": True,
        }
        return Table(
            node, assigned._column_names, assigned._dtypes, name="exactly_once"
        )

    assert isinstance(behavior, CommonBehavior)
    delay = behavior.delay
    cutoff = behavior.cutoff
    thr_fn = (
        (lambda k, v, d=delay: v[widx][1] + d) if delay is not None else None
    )
    exp_fn = (
        (lambda k, v, c=cutoff + off: v[widx][2] + c)
        if cutoff is not None
        else None
    )
    node = TemporalBehaviorNode(
        G.engine_graph,
        assigned._node,
        time_fn=time_fn,
        threshold_fn=thr_fn,
        expiry_fn=exp_fn,
        keep_results=behavior.keep_results,
    )
    node.meta["temporal"] = {
        "kind": "behavior",
        "behavior": "common",
        "bounded": True,
        "keep_results": behavior.keep_results,
    }
    return Table(node, assigned._column_names, assigned._dtypes, name="behavior")


def _intervals_over_windowby(table, tc, ic, window: IntervalsOverWindow, behavior):
    """intervals_over: a window per probe point p = [p+lower, p+upper]."""
    at_ref = window.at
    at_table: Table = at_ref._table
    at_layout = at_table._layout()
    ac = _wrap(at_ref)._compile(at_layout.resolver)

    class ProbeAssignNode(eg.Node):
        """Pair data rows with probe points within the band; stateful on
        both sides (a small dedicated interval join)."""

        def __init__(self, graph, data, probes, name="intervals_over"):
            super().__init__(graph, [data, probes], name)

        def make_state(self):
            return {"data": {}, "probes": {}, "out": {}}

        def process(self, ctx, time, inbatches):
            from pathway_tpu_torch.engine.stream import consolidate

            st = ctx.state(self)
            for u in consolidate(inbatches[0]):
                if u.diff > 0:
                    st["data"][u.key] = (u.values, tc((u.key, u.values)), ic((u.key, u.values)))
                else:
                    st["data"].pop(u.key, None)
            for u in consolidate(inbatches[1]):
                if u.diff > 0:
                    st["probes"][u.key] = (ac((u.key, u.values)), None)
                else:
                    st["probes"].pop(u.key, None)
            # recompute full assignment (dirty-all; probe sets are small)
            new_out: dict = {}
            matched: set = set()
            for dk, (values, t, inst) in st["data"].items():
                for pk, (p, _) in st["probes"].items():
                    if p + window.lower_bound <= t <= p + window.upper_bound:
                        okey = K.derive(dk, "iv", int(pk))
                        new_out[okey] = values + ((inst, p, p),)
                        matched.add(pk)
            if window.is_outer:
                # outer: a probe with no data in its band still yields a
                # window — one placeholder row of Nones (reference
                # intervals_over is_outer)
                n_data_cols = len(table._column_names)
                for pk, (p, _) in st["probes"].items():
                    if pk not in matched:
                        okey = K.derive(pk, "iv_outer")
                        new_out[okey] = (None,) * n_data_cols + ((None, p, p),)
            out = []
            for okey, row in new_out.items():
                if st["out"].get(okey) != row:
                    if okey in st["out"]:
                        out.append(eg.Update(okey, st["out"][okey], -1))
                    out.append(eg.Update(okey, row, 1))
            for okey in list(st["out"]):
                if okey not in new_out:
                    out.append(eg.Update(okey, st["out"][okey], -1))
            st["out"] = new_out
            return consolidate(out)

    node = ProbeAssignNode(G.engine_graph, table._node, at_table._node)
    node.meta["temporal"] = {"kind": "intervals_over", "bounded": True}
    assigned = Table(
        node,
        table._column_names + ["_pw_window"],
        {**table._dtypes, "_pw_window": dt.ANY},
        name="intervals_over",
    )
    if behavior is not None:
        # behaviors act on the data rows' TRUE event time, like the
        # fixed-window paths; the window tuple stores the probe point p
        # in both slots, so closing anchors at the BAND end
        # p + upper_bound via the offset (placeholder outer rows carry
        # time None and pass through untouched by the watermark)
        assigned = _apply_behavior(
            assigned,
            behavior,
            lambda k, v: tc((k, v)),
            window_end_offset=window.upper_bound,
        )
    return WindowedTable(assigned, None)
