"""Temporal dataflow operators: behaviors, interval joins, asof joins.

Equivalents of the reference's custom Rust operators:

- :class:`TemporalBehaviorNode` — the forget/buffer/freeze trio of
  ``src/engine/dataflow/operators/time_column.rs`` (750 LoC), driven by
  an **event-time watermark** (max time value seen) instead of timely
  frontiers; same externally observable semantics: rows buffer until
  their release threshold, late rows are frozen out past the cutoff,
  and non-kept rows are retracted when their window expires.
- :class:`IntervalJoinNode` — ``interval_join`` family
  (reference ``stdlib/temporal/_interval_join.py:577``): equi-join plus
  a time-band predicate, with outer-mode unmatched rows.
- :class:`AsofJoinNode` / as-of-now variant — ``asof_join``/``asof_now_join``
  (reference ``_asof_join.py:479``, ``_asof_now_join.py:176``) over the
  ``prev_next``-style sorted neighbour search.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable

from pathway_tpu_torch.engine.graph import EngineGraph, Node
from pathway_tpu_torch.engine.stream import Update, consolidate
from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals.keys import Pointer


def _num(x: Any) -> Any:
    """Times are compared as-is (int/float/datetime all support <)."""
    return x


class TemporalBehaviorNode(Node):
    """Buffer/forget/freeze over an update stream.

    Per row, ``threshold_fn`` gives the release threshold (buffer until
    watermark >= threshold) and ``expiry_fn`` the expiry time (None =
    never).  ``time_fn`` extracts the row's event time, which advances
    the watermark.  Semantics:

    - a row buffers until ``watermark >= threshold`` (buffer);
    - a row arriving with ``expiry <= watermark`` is dropped (freeze);
    - if ``keep_results`` is False, emitted rows are retracted when
      ``watermark >= expiry`` (forget).
    """

    always_tick = True

    def __init__(
        self,
        graph: EngineGraph,
        input: Node,
        time_fn: Callable[[Pointer, tuple], Any],
        threshold_fn: Callable[[Pointer, tuple], Any] | None,
        expiry_fn: Callable[[Pointer, tuple], Any] | None,
        keep_results: bool = True,
        flush_on_end: bool = True,
        name: str = "temporal_behavior",
    ):
        super().__init__(graph, [input], name)
        self.time_fn = time_fn
        self.threshold_fn = threshold_fn
        self.expiry_fn = expiry_fn
        self.keep_results = keep_results
        self.flush_on_end = flush_on_end

    def make_state(self):
        return {
            "watermark": None,
            # buffered: key -> (values, threshold, expiry)
            "buffered": {},
            # emitted: key -> (values, expiry)
            "emitted": {},
        }

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        out: list[Update] = []
        wm = st["watermark"]
        finalizing = getattr(ctx, "finalizing", False)

        for u in consolidate(inbatches[0]):
            try:
                t = self.time_fn(u.key, u.values)
            except Exception:
                continue
            if t is not None and t is not api.ERROR:
                wm = t if wm is None else max(wm, t)
            if u.diff < 0:
                if u.key in st["buffered"]:
                    del st["buffered"][u.key]
                elif u.key in st["emitted"]:
                    del st["emitted"][u.key]
                    out.append(Update(u.key, u.values, -1))
                continue
            threshold = (
                self.threshold_fn(u.key, u.values)
                if self.threshold_fn is not None
                else None
            )
            expiry = (
                self.expiry_fn(u.key, u.values) if self.expiry_fn is not None else None
            )
            if expiry is not None and wm is not None and expiry <= wm:
                continue  # late: frozen out
            if threshold is None or (wm is not None and threshold <= wm):
                st["emitted"][u.key] = (u.values, expiry)
                out.append(Update(u.key, u.values, 1))
            else:
                st["buffered"][u.key] = (u.values, threshold, expiry)

        # advance watermark: release buffers, expire emitted rows
        if wm is not None:
            st["watermark"] = wm
            release = [
                k
                for k, (_v, thr, _e) in st["buffered"].items()
                if thr <= wm or (finalizing and self.flush_on_end)
            ]
            for k in release:
                # freeze applies at ARRIVAL (late rows); a buffered row was
                # on time, so it always releases — under keep_results=False
                # the expiry sweep below may retract it in the same epoch
                values, _thr, expiry = st["buffered"].pop(k)
                st["emitted"][k] = (values, expiry)
                out.append(Update(k, values, 1))
            if not self.keep_results:
                expired = [
                    k
                    for k, (_v, e) in st["emitted"].items()
                    if e is not None and e <= wm
                ]
                for k in expired:
                    values, _e = st["emitted"].pop(k)
                    out.append(Update(k, values, -1))
        if finalizing and self.flush_on_end:
            for k, (values, _thr, _e) in list(st["buffered"].items()):
                st["emitted"][k] = (values, _e)
                out.append(Update(k, values, 1))
            st["buffered"].clear()
        return consolidate(out)


class IntervalJoinNode(Node):
    """Equi-join + time band: match (l, r) when keys equal and
    ``r.time - l.time in [lower_bound, upper_bound]``."""

    def __init__(
        self,
        graph: EngineGraph,
        left: Node,
        right: Node,
        left_jk_fn: Callable[[Pointer, tuple], tuple],
        right_jk_fn: Callable[[Pointer, tuple], tuple],
        left_time_fn: Callable[[Pointer, tuple], Any],
        right_time_fn: Callable[[Pointer, tuple], Any],
        lower_bound: Any,
        upper_bound: Any,
        left_ncols: int,
        right_ncols: int,
        kind: str = "inner",  # inner|left|right|outer
        name: str = "interval_join",
    ):
        super().__init__(graph, [left, right], name)
        self.left_jk_fn = left_jk_fn
        self.right_jk_fn = right_jk_fn
        self.left_time_fn = left_time_fn
        self.right_time_fn = right_time_fn
        self.lower = lower_bound
        self.upper = upper_bound
        self.left_ncols = left_ncols
        self.right_ncols = right_ncols
        self.kind = kind

    def make_state(self):
        # per side: jk -> {row_key: (values, time)}
        return {"left": {}, "right": {}, "out": {}}

    def _pairs(self, lrows: dict, rrows: dict) -> dict[Pointer, tuple]:
        # rows end with (left_key, right_key) — the JoinResult id protocol
        block: dict[Pointer, tuple] = {}
        lnone = (None,) * self.left_ncols
        rnone = (None,) * self.right_ncols
        lmatched: set = set()
        rmatched: set = set()
        for lk, (lv, lt) in lrows.items():
            for rk, (rv, rt) in rrows.items():
                if lt is None or rt is None:
                    continue
                d = rt - lt
                if self.lower <= d <= self.upper:
                    block[K.join_key(lk, rk)] = lv + rv + (lk, rk)
                    lmatched.add(lk)
                    rmatched.add(rk)
        if self.kind in ("left", "outer"):
            for lk, (lv, _lt) in lrows.items():
                if lk not in lmatched:
                    block[K.join_key(lk, None)] = lv + rnone + (lk, None)
        if self.kind in ("right", "outer"):
            for rk, (rv, _rt) in rrows.items():
                if rk not in rmatched:
                    block[K.ref_scalar("__ij_r__", int(rk))] = lnone + rv + (None, rk)
        return block

    def _apply_side(self, side: dict, batch, jk_fn, time_fn) -> set:
        from pathway_tpu_torch.engine.stream import hashable_row

        dirty = set()
        for u in batch:
            jk = hashable_row(jk_fn(u.key, u.values))
            if jk is None or any(v is None for v in jk):
                continue
            t = time_fn(u.key, u.values)
            rows = side.setdefault(jk, {})
            if u.diff > 0:
                rows[u.key] = (u.values, t)
            else:
                rows.pop(u.key, None)
                if not rows:
                    side.pop(jk, None)
            dirty.add(jk)
        return dirty

    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        from pathway_tpu_torch.engine.stream import hashable_row

        dirty: set = set()
        for u in inbatches[0]:
            jk = hashable_row(self.left_jk_fn(u.key, u.values))
            if not (jk is None or any(v is None for v in jk)):
                dirty.add(jk)
        for u in inbatches[1]:
            jk = hashable_row(self.right_jk_fn(u.key, u.values))
            if not (jk is None or any(v is None for v in jk)):
                dirty.add(jk)
        old_blocks = {
            jk: self._pairs(st["left"].get(jk, {}), st["right"].get(jk, {}))
            for jk in dirty
        }
        self._apply_side(st["left"], inbatches[0], self.left_jk_fn, self.left_time_fn)
        self._apply_side(st["right"], inbatches[1], self.right_jk_fn, self.right_time_fn)
        out: list[Update] = []
        for jk in dirty:
            new_block = self._pairs(st["left"].get(jk, {}), st["right"].get(jk, {}))
            old_block = old_blocks[jk]
            for okey, vals in old_block.items():
                if new_block.get(okey) != vals:
                    out.append(Update(okey, vals, -1))
            for okey, vals in new_block.items():
                if old_block.get(okey) != vals:
                    out.append(Update(okey, vals, 1))
        return consolidate(out)


class AsofNowJoinNode(Node):
    """Equi-join answered as-of-now: each left row is matched against the
    right side's state at its arrival epoch and never revised (reference
    ``asof_now_join``, ``stdlib/temporal/_asof_now_join.py:176``)."""

    def __init__(
        self,
        graph: EngineGraph,
        left: Node,
        right: Node,
        left_jk_fn,
        right_jk_fn,
        left_ncols: int,
        right_ncols: int,
        kind: str = "inner",  # inner|left
        name: str = "asof_now_join",
    ):
        super().__init__(graph, [left, right], name)
        self.left_jk_fn = left_jk_fn
        self.right_jk_fn = right_jk_fn
        self.left_ncols = left_ncols
        self.right_ncols = right_ncols
        self.kind = kind

    def make_state(self):
        # right: jk -> {row_key: values}; out: left_key -> [(okey, row)]
        return {"right": {}, "out": {}}

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.stream import hashable_row

        st = ctx.state(self)
        # right side first: a query in the same epoch sees these updates
        for u in consolidate(inbatches[1]):
            jk = hashable_row(self.right_jk_fn(u.key, u.values))
            if jk is None or any(v is None for v in jk):
                continue
            rows = st["right"].setdefault(jk, {})
            if u.diff > 0:
                rows[u.key] = u.values
            else:
                rows.pop(u.key, None)
                if not rows:
                    st["right"].pop(jk, None)
        out: list[Update] = []
        rnone = (None,) * self.right_ncols
        for u in consolidate(inbatches[0]):
            if u.diff > 0:
                jk = hashable_row(self.left_jk_fn(u.key, u.values))
                matches = (
                    st["right"].get(jk, {})
                    if not (jk is None or any(v is None for v in jk))
                    else {}
                )
                emitted = []
                if matches:
                    for rk, rv in matches.items():
                        okey = K.join_key(u.key, rk)
                        row = u.values + rv + (u.key, rk)
                        emitted.append((okey, row))
                elif self.kind == "left":
                    emitted.append(
                        (K.join_key(u.key, None), u.values + rnone + (u.key, None))
                    )
                st["out"][u.key] = emitted
                for okey, row in emitted:
                    out.append(Update(okey, row, 1))
            else:
                for okey, row in st["out"].pop(u.key, ()):  # retract cached
                    out.append(Update(okey, row, -1))
        return consolidate(out)


class AsofJoinNode(Node):
    """For each left row: the closest right row per key by time
    (direction backward: rt <= lt; forward: rt >= lt; nearest: min |d|)."""

    def __init__(
        self,
        graph: EngineGraph,
        left: Node,
        right: Node,
        left_jk_fn,
        right_jk_fn,
        left_time_fn,
        right_time_fn,
        left_ncols: int,
        right_ncols: int,
        direction: str = "backward",  # backward|forward|nearest
        kind: str = "left",  # inner|left
        as_of_now: bool = False,
        name: str = "asof_join",
    ):
        super().__init__(graph, [left, right], name)
        self.left_jk_fn = left_jk_fn
        self.right_jk_fn = right_jk_fn
        self.left_time_fn = left_time_fn
        self.right_time_fn = right_time_fn
        self.left_ncols = left_ncols
        self.right_ncols = right_ncols
        self.direction = direction
        self.kind = kind
        self.as_of_now = as_of_now

    def make_state(self):
        # right: jk -> sorted list of (time, row_key, values)
        # left: jk -> {row_key: (values, time)}
        # out: left_row_key -> emitted values
        return {"right": {}, "left": {}, "out": {}}

    def _match(self, st, jk, lt) -> tuple | None:
        rows = st["right"].get(jk)
        if not rows or lt is None:
            return None
        times = [r[0] for r in rows]
        if self.direction == "backward":
            i = bisect.bisect_right(times, lt) - 1
            return rows[i] if i >= 0 else None
        if self.direction == "forward":
            i = bisect.bisect_left(times, lt)
            return rows[i] if i < len(rows) else None
        # nearest
        i = bisect.bisect_left(times, lt)
        candidates = []
        if i > 0:
            candidates.append(rows[i - 1])
        if i < len(rows):
            candidates.append(rows[i])
        if not candidates:
            return None
        return min(candidates, key=lambda r: abs(r[0] - lt))

    def _result_row(self, st, jk, lkey, lv, lt) -> tuple | None:
        # rows end with (left_key, right_key) — the JoinResult id protocol
        m = self._match(st, jk, lt)
        if m is None:
            if self.kind == "inner":
                return None
            return lv + (None,) * self.right_ncols + (lkey, None)
        return lv + m[2] + (lkey, m[1])

    def process(self, ctx, time, inbatches):
        from pathway_tpu_torch.engine.stream import hashable_row

        st = ctx.state(self)
        out: list[Update] = []
        dirty_right: set = set()
        for u in consolidate(inbatches[1]):
            jk = hashable_row(self.right_jk_fn(u.key, u.values))
            if jk is None or any(v is None for v in jk):
                continue
            t = self.right_time_fn(u.key, u.values)
            rows = st["right"].setdefault(jk, [])
            entry = (t, u.key, u.values)
            if u.diff > 0:
                bisect.insort(rows, entry, key=lambda r: (r[0], str(r[1])))
            else:
                try:
                    rows.remove(entry)
                except ValueError:
                    pass
            dirty_right.add(jk)

        handled: set = set()
        for u in consolidate(inbatches[0]):
            jk = hashable_row(self.left_jk_fn(u.key, u.values))
            if jk is None or any(v is None for v in jk):
                continue
            handled.add(u.key)
            lt = self.left_time_fn(u.key, u.values)
            if u.diff > 0:
                st["left"].setdefault(jk, {})[u.key] = (u.values, lt)
                row = self._result_row(st, jk, u.key, u.values, lt)
                prev = st["out"].get(u.key)
                if prev is not None and prev != row:
                    out.append(Update(u.key, prev, -1))
                if row is not None and prev != row:
                    out.append(Update(u.key, row, 1))
                    st["out"][u.key] = row
            else:
                st["left"].get(jk, {}).pop(u.key, None)
                prev = st["out"].pop(u.key, None)
                if prev is not None:
                    out.append(Update(u.key, prev, -1))

        if not self.as_of_now:
            for jk in dirty_right:
                for lkey, (lv, lt) in st["left"].get(jk, {}).items():
                    if lkey in handled:
                        continue
                    row = self._result_row(st, jk, lkey, lv, lt)
                    prev = st["out"].get(lkey)
                    if prev == row:
                        continue
                    if prev is not None:
                        out.append(Update(lkey, prev, -1))
                    if row is not None:
                        out.append(Update(lkey, row, 1))
                        st["out"][lkey] = row
                    else:
                        st["out"].pop(lkey, None)
        return consolidate(out)


# multi-worker routing: temporal operators keep watermark/buffer state on a
# single worker, exactly like the reference (TimeKey::shard() -> 1,
# src/engine/dataflow/operators/time_column.rs:44-52)
from pathway_tpu_torch.engine import cluster as _cl

for _cls in (TemporalBehaviorNode, IntervalJoinNode, AsofNowJoinNode, AsofJoinNode):
    _cls.exchange_routes = _cl.route_all_to_zero
