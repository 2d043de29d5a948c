"""The port's temporal stdlib (``pathway_tpu_torch/stdlib/temporal/`` over
``engine/temporal.py``) against the JAX package's, on the CPU.

Every case of ``tests/test_temporal.py``, ``test_temporal_consistency.py``
and ``test_temporal_windows_extra.py`` (but its ``viz`` case, which comes
with slice 16e) is written once, as a function of the package module, and
runs through both packages with the same inputs: the consolidated final
rows are equal, by id, and so is the update stream wherever the input is a
``pw.debug`` table (one clock); the JAX test's own assertions hold on the
port's output.  Windows (tumbling, sliding, session, ``intervals_over``)
run under ``common_behavior`` with a delay, a cutoff and
``keep_results=False``, and under ``exactly_once_behavior``; the interval,
asof, asof-now and window joins run in their inner, left, right and outer
forms; a streamed input with rows that arrive late and past the cutoff
drops the same rows in both packages.  The temporal cases of
``tests/test_static_analysis.py`` give the same findings with the port's
analyzer, at ``optimize`` 0 and 2 the same results.
"""

from __future__ import annotations

import json
import random
import threading
import time

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw


@pytest.fixture(autouse=True)
def fresh_port_graph():
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


def norm(v):
    """A value in a form both packages' values compare in."""
    if type(v).__name__ == "_Error":
        return ("Error",)
    if type(v).__name__ == "Pointer":
        return ("Pointer", int(v))
    if type(v).__name__ == "Json":
        return ("Json", json.dumps(v.value, sort_keys=True))
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tolist())
    if isinstance(v, (tuple, list)):
        return tuple(norm(x) for x in v)
    return v


def capture(pw, build) -> list:
    """``build(pw)``'s tables run through ``pw.debug``: per table, its rows
    by id and its update stream, normalised."""
    pw.G.clear()
    tables = build(pw)
    tables = tables if isinstance(tables, tuple) else (tables,)
    out = []
    for rows, stream in pw.debug._run_capture(*tables):
        out.append((
            {int(k): norm(tuple(v)) for k, v in rows.items()},
            [(int(k), norm(tuple(v)), t, d) for k, v, t, d in stream],
        ))
    pw.G.clear()
    return out


def run_both(build) -> list:
    """``build`` through both packages: equal rows by id and equal update
    streams; the port's ``(rows, stream)`` per table."""
    want = capture(jpw, build)
    got = capture(tpw, build)
    assert len(got) == len(want)
    for (grows, gstream), (wrows, wstream) in zip(got, want):
        assert grows == wrows
        assert sorted(gstream, key=repr) == sorted(wstream, key=repr)
    return got


def values(rows: dict) -> list:
    """The final rows as ``tests.utils.run_to_rows`` orders them."""
    return sorted(rows.values(), key=repr)


# ---------------------------------------------------------------------------
# tests/test_temporal.py


def tumbling_reduce(pw):
    t = pw.debug.table_from_markdown(
        """
    t  | v
    1  | 10
    2  | 20
    11 | 1
    12 | 2
    25 | 5
    """
    )
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=10)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v), n=pw.reducers.count()
    )


def test_tumbling_window_reduce():
    ((rows, _),) = run_both(tumbling_reduce)
    assert sorted((r[1], r[2], r[3]) for r in values(rows)) == [(0, 30, 2), (10, 3, 2), (20, 5, 1)]


def test_sliding_window_assigns_multiple():
    def build(pw):
        t = pw.debug.table_from_markdown("t | v\n5 | 1")
        return t.windowby(pw.this.t, window=pw.temporal.sliding(hop=2, duration=6)).reduce(
            start=pw.this._pw_window_start, n=pw.reducers.count()
        )

    ((rows, _),) = run_both(build)
    assert sorted(r[1] for r in values(rows)) == [0, 2, 4]


def test_session_window():
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
        t  | v
        1  | 1
        2  | 1
        3  | 1
        20 | 1
        21 | 1
        """
        )
        return t.windowby(pw.this.t, window=pw.temporal.session(max_gap=5)).reduce(
            start=pw.this._pw_window_start, end=pw.this._pw_window_end, n=pw.reducers.count()
        )

    ((rows, _),) = run_both(build)
    assert sorted((r[1], r[2], r[3]) for r in values(rows)) == [(1, 3, 3), (20, 21, 2)]


def test_window_behavior_forget():
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
        t   | v   | __time__
        1   | 1   | 2
        2   | 1   | 2
        30  | 1   | 4
        """
        )
        return t.windowby(
            pw.this.t,
            window=pw.temporal.tumbling(duration=10),
            behavior=pw.temporal.common_behavior(cutoff=5, keep_results=False),
        ).reduce(start=pw.this._pw_window_start, n=pw.reducers.count())

    ((rows, _),) = run_both(build)
    assert [(r[1], r[2]) for r in values(rows)] == [(30, 1)]


def test_exactly_once_behavior_buffers():
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
        t   | v   | __time__
        1   | 1   | 2
        2   | 1   | 2
        11  | 1   | 4
        30  | 1   | 6
        """
        )
        return t.windowby(
            pw.this.t, window=pw.temporal.tumbling(duration=10), behavior=pw.temporal.exactly_once_behavior()
        ).reduce(start=pw.this._pw_window_start, n=pw.reducers.count())

    ((_, stream),) = run_both(build)
    w0 = [s for s in stream if s[1][1] == 0]
    assert len(w0) == 1 and w0[0][3] == 1 and w0[0][1][2] == 2


def test_interval_join_inner():
    def build(pw):
        a = pw.debug.table_from_markdown("t | k | va\n1 | x | a1\n5 | x | a5")
        b = pw.debug.table_from_markdown("t | k | vb\n2 | x | b2\n9 | x | b9")
        return pw.temporal.interval_join(
            a, b, a.t, b.t, pw.temporal.interval(-1, 2), pw.left.k == pw.right.k
        ).select(va=pw.left.va, vb=pw.right.vb)

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [("a1", "b2")]


def test_interval_join_outer_unmatched():
    def build(pw):
        a = pw.debug.table_from_markdown("t | va\n1 | a1\n9 | a9")
        b = pw.debug.table_from_markdown("t | vb\n2 | b2")
        return pw.temporal.interval_join_outer(a, b, a.t, b.t, pw.temporal.interval(-1, 1)).select(
            va=pw.left.va, vb=pw.right.vb
        )

    ((rows, _),) = run_both(build)
    got = values(rows)
    assert ("a1", "b2") in got and ("a9", None) in got


def test_asof_join_backward():
    def build(pw):
        trades = pw.debug.table_from_markdown("t  | k | price\n3  | x | 100\n7  | x | 101")
        quotes = pw.debug.table_from_markdown("t | k | quote\n1 | x | 99\n5 | x | 100\n9 | x | 102")
        return pw.temporal.asof_join(
            trades, quotes, trades.t, quotes.t, pw.left.k == pw.right.k
        ).select(price=pw.left.price, quote=pw.right.quote)

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [(100, 99), (101, 100)]


def asof_now_updates(pw) -> list:
    """A left row that arrives after ``r1`` and before ``r2``, asof-now
    joined: the sink's updates, in order."""
    from importlib import import_module

    Scheduler = import_module(f"{pw.__name__}.engine.scheduler").Scheduler

    class RightSubject(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(k="x", r="r1")
            self.commit()
            time.sleep(0.5)
            self.next(k="x", r="r2")
            self.commit()

    class LeftSubject(pw.io.python.ConnectorSubject):
        def run(self):
            time.sleep(0.25)  # after r1, before r2
            self.next(k="x", l="l1")
            self.commit()

    class RightSchema(pw.Schema):
        k: str
        r: str

    class LeftSchema(pw.Schema):
        k: str
        l: str  # noqa: E741

    pw.G.clear()
    left = pw.io.python.read(LeftSubject(), schema=LeftSchema)
    right = pw.io.python.read(RightSubject(), schema=RightSchema)
    res = pw.temporal.asof_now_join(left, right, pw.left.k == pw.right.k).select(l=pw.left.l, r=pw.right.r)
    updates = []
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: updates.append((is_addition, row["r"])))
    sched = Scheduler(pw.G.engine_graph, autocommit_ms=20)
    th = threading.Thread(target=sched.run)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    pw.G.clear()
    return updates


def test_asof_now_join_no_revision():
    """The left row is answered against the right state at its arrival
    (``r1`` only) and never revised when ``r2`` arrives, in both."""
    for pw in (jpw, tpw):
        updates = asof_now_updates(pw)
        assert [u for u in updates if u[0]] == [(True, "r1")], pw.__name__
        assert not [u for u in updates if not u[0]], pw.__name__


def test_window_join():
    def build(pw):
        a = pw.debug.table_from_markdown("t | va\n1 | a1\n11| a11")
        b = pw.debug.table_from_markdown("t | vb\n2 | b2\n12| b12")
        return pw.temporal.window_join(a, b, a.t, b.t, pw.temporal.tumbling(duration=10)).select(
            va=pw.left.va, vb=pw.right.vb
        )

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [("a1", "b2"), ("a11", "b12")]


def test_intervals_over_window():
    def build(pw):
        data = pw.debug.table_from_markdown("t  | v\n1  | 10\n3  | 30\n5  | 50\n9  | 90")
        probes = pw.debug.table_from_markdown("at\n2\n6")
        res = data.windowby(
            data.t, window=pw.temporal.intervals_over(at=probes.at, lower_bound=-2, upper_bound=1)
        ).reduce(total=pw.reducers.sum(pw.this.v), n=pw.reducers.count())
        return res.select(at=pw.this._pw_window_start, total=pw.this.total, n=pw.this.n)

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [(2, 40, 2), (6, 50, 1)]


def test_sliding_window_ratio():
    def build(pw):
        t = pw.debug.table_from_markdown("t | v\n0 | 1\n2 | 1\n4 | 1")
        res = t.windowby(t.t, window=pw.temporal.sliding(hop=2, ratio=2)).reduce(n=pw.reducers.count())
        return res.select(s=pw.this._pw_window_start, n=pw.this.n)

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [(-2, 1), (0, 2), (2, 2), (4, 1)]


def test_session_window_predicate():
    def build(pw):
        t = pw.debug.table_from_markdown("t  | v\n1  | 1\n2  | 1\n10 | 1")
        res = t.windowby(t.t, window=pw.temporal.session(predicate=lambda a, b: abs(a - b) <= 3)).reduce(
            n=pw.reducers.count()
        )
        return res.select(n=pw.this.n)

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [(1,), (2,)]


def test_interval_join_left_and_right():
    def build(pw):
        left = pw.debug.table_from_markdown("t | a\n1 | l1\n5 | l2")
        right = pw.debug.table_from_markdown("t | b\n2 | r1\n9 | r2")
        lres = left.interval_join_left(right, left.t, right.t, pw.temporal.interval(-1, 1)).select(
            a=left.a, b=right.b
        )
        rres = left.interval_join_right(right, left.t, right.t, pw.temporal.interval(-1, 1)).select(
            a=left.a, b=right.b
        )
        return lres, rres

    (lrows, _), (rrows, _) = run_both(build)
    assert values(lrows) == [("l1", "r1"), ("l2", None)]
    assert values(rrows) == [("l1", "r1"), (None, "r2")]


def test_asof_join_directions():
    def build(pw):
        left = pw.debug.table_from_markdown("t | a\n3 | x\n7 | y")
        right = pw.debug.table_from_markdown("t | p\n2 | 20\n5 | 50\n8 | 80")
        fwd = left.asof_join(right, left.t, right.t, how=pw.JoinMode.LEFT, direction="forward").select(
            a=left.a, p=right.p
        )
        nearest = left.asof_join(right, left.t, right.t, how=pw.JoinMode.LEFT, direction="nearest").select(
            a=left.a, p=right.p
        )
        return fwd, nearest

    (frows, _), (nrows, _) = run_both(build)
    assert sorted(values(frows)) == [("x", 50), ("y", 80)]
    assert sorted(values(nrows)) == [("x", 20), ("y", 80)]


# ---------------------------------------------------------------------------
# the joins in every form, the behaviors, late rows


JOINS = ("inner", "left", "right", "outer")


def _two_sides(pw):
    a = pw.debug.table_from_markdown(
        """
    t  | k | va
    1  | x | a1
    4  | y | a4
    9  | x | a9
    20 | x | a20
    """
    )
    b = pw.debug.table_from_markdown(
        """
    t  | k | vb
    2  | x | b2
    5  | y | b5
    8  | x | b8
    31 | y | b31
    """
    )
    return a, b


@pytest.mark.parametrize("how", JOINS)
def test_interval_join_every_form(how):
    def build(pw):
        a, b = _two_sides(pw)
        fn = getattr(pw.temporal, "interval_join" if how == "inner" else f"interval_join_{how}")
        return fn(a, b, a.t, b.t, pw.temporal.interval(-2, 3), pw.left.k == pw.right.k).select(
            va=pw.left.va, vb=pw.right.vb
        )

    ((rows, _),) = run_both(build)
    got = values(rows)
    assert ("a1", "b2") in got and ("a4", "b5") in got
    assert (("a20", None) in got) == (how in ("left", "outer"))
    assert ((None, "b31") in got) == (how in ("right", "outer"))


@pytest.mark.parametrize("how", JOINS)
def test_asof_join_every_form(how):
    def build(pw):
        a, b = _two_sides(pw)
        mode = {"inner": pw.JoinMode.INNER, "left": pw.JoinMode.LEFT, "right": pw.JoinMode.RIGHT,
                "outer": pw.JoinMode.OUTER}[how]
        return a.asof_join(b, a.t, b.t, pw.left.k == pw.right.k, how=mode).select(
            va=pw.left.va, vb=pw.right.vb
        )

    ((rows, _),) = run_both(build)
    got = values(rows)
    assert ("a9", "b8") in got and ("a20", "b8") in got


@pytest.mark.parametrize("how", ("inner", "left"))
def test_asof_now_join_every_form(how):
    """``asof_now_join`` has an inner and a left form (the reference's
    ``asof_now_join``/``asof_now_join_left``): both packages the same."""

    def build(pw):
        a, b = _two_sides(pw)
        fn = pw.temporal.asof_now_join if how == "inner" else pw.temporal.asof_now_join_left
        return fn(a, b, pw.left.k == pw.right.k).select(va=pw.left.va, vb=pw.right.vb)

    ((rows, _),) = run_both(build)
    assert rows


@pytest.mark.parametrize("how", JOINS)
@pytest.mark.parametrize("window", ("tumbling", "sliding", "session"))
def test_window_join_every_form(how, window):
    def build(pw):
        a, b = _two_sides(pw)
        w = {"tumbling": pw.temporal.tumbling(duration=10),
             "sliding": pw.temporal.sliding(hop=5, duration=10),
             "session": pw.temporal.session(max_gap=3)}[window]
        fn = getattr(a, "window_join" if how == "inner" else f"window_join_{how}")
        return fn(b, a.t, b.t, w, pw.left.k == pw.right.k).select(va=pw.left.va, vb=pw.right.vb)

    ((rows, _),) = run_both(build)
    if window != "session":
        assert ("a1", "b2") in values(rows)
    else:
        # each side's sessions are its own (ROADMAP, "Reference behaviour"):
        # no window of one side has the bounds of one of the other's here
        assert all(None in r for r in values(rows)) and (len(rows) > 0) == (how != "inner")


def late_stream(pw, behavior):
    """A markdown stream (one clock) in which rows arrive late: within the
    delay, within the cutoff, and past it."""
    t = pw.debug.table_from_markdown(
        """
    t   | v  | __time__
    1   | 1  | 2
    3   | 2  | 2
    12  | 4  | 4
    5   | 8  | 6
    26  | 16 | 8
    7   | 32 | 10
    41  | 64 | 12
    2   | 128| 14
    """
    )
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=10), behavior=behavior(pw)).reduce(
        start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v), n=pw.reducers.count()
    )


BEHAVIORS = {
    "none": lambda pw: None,
    "delay": lambda pw: pw.temporal.common_behavior(delay=5),
    "cutoff": lambda pw: pw.temporal.common_behavior(cutoff=4),
    "delay_cutoff": lambda pw: pw.temporal.common_behavior(delay=3, cutoff=8),
    "forget": lambda pw: pw.temporal.common_behavior(cutoff=4, keep_results=False),
    "exactly_once": lambda pw: pw.temporal.exactly_once_behavior(),
    "exactly_once_shift": lambda pw: pw.temporal.exactly_once_behavior(shift=5),
}


@pytest.mark.parametrize("name", sorted(BEHAVIORS))
def test_late_rows_drop_alike(name):
    """The same late rows are kept, held or dropped, at the same epochs,
    in both packages; without a cutoff every row counts."""
    ((rows, stream),) = run_both(lambda pw: late_stream(pw, BEHAVIORS[name]))
    total = sum(r[2] for r in rows.values())
    if name in ("none", "delay"):
        assert total == 255
    if name in ("cutoff", "delay_cutoff", "exactly_once", "exactly_once_shift"):
        assert total < 255  # the row at t=2 came past its window's cutoff
    if name.startswith("exactly_once"):
        # each window is emitted once and never revised
        assert all(d == 1 for *_, d in stream)


@pytest.mark.parametrize("window", ("tumbling", "sliding", "session", "intervals_over"))
def test_windows_with_instance_and_delay(window):
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
        t  | g | v | __time__
        1  | a | 1 | 2
        2  | b | 2 | 2
        6  | a | 3 | 4
        13 | b | 4 | 4
        14 | a | 5 | 6
        30 | a | 6 | 8
        """
        )
        probes = pw.debug.table_from_markdown("at\n5\n15")
        w = {"tumbling": pw.temporal.tumbling(duration=10),
             "sliding": pw.temporal.sliding(hop=4, duration=8),
             "session": pw.temporal.session(max_gap=5),
             "intervals_over": pw.temporal.intervals_over(at=probes.at, lower_bound=-5, upper_bound=5)}[window]
        kwargs = {} if window == "intervals_over" else {"instance": pw.this.g}
        return t.windowby(t.t, window=w, behavior=pw.temporal.common_behavior(delay=2), **kwargs).reduce(
            start=pw.this._pw_window_start, end=pw.this._pw_window_end, s=pw.reducers.sum(pw.this.v)
        )

    ((rows, _),) = run_both(build)
    assert rows


# ---------------------------------------------------------------------------
# tests/test_temporal_consistency.py: streamed (Python connector) against
# batch, in both packages


def _schema(pw):
    return pw.schema_from_types(k=int, t=int, v=int)


def _stream(pw, epochs):
    from importlib import import_module

    K = import_module(f"{pw.__name__}.internals.keys")
    coerce_row = import_module(f"{pw.__name__}.io._connector").coerce_row
    schema = _schema(pw)

    class StreamSource(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for epoch in epochs:
                for kind, key, row in epoch:
                    k = K.ref_scalar("tmp", key)
                    if kind == "add":
                        self._events.add(k, coerce_row(row, schema))
                    else:
                        self._events.remove(k, coerce_row(row, schema))
                self.commit()

    return pw.io.python.read(StreamSource(), schema=schema)


def _batch(pw, rows):
    return pw.debug.table_from_rows(_schema(pw), [(r["k"], r["t"], r["v"]) for r in rows])


def _history(rng: random.Random, n_keys=10, n_epochs=10, t_range=50):
    alive: dict[int, dict] = {}
    epochs = []
    for _ in range(n_epochs):
        epoch = []
        for _ in range(rng.randrange(1, 5)):
            key = rng.randrange(n_keys)
            if key in alive and rng.random() < 0.3:
                epoch.append(("remove", key, alive.pop(key)))
            elif key not in alive:
                row = {"k": key, "t": rng.randrange(t_range), "v": rng.randrange(20)}
                epoch.append(("add", key, row))
                alive[key] = row
        if epoch:
            epochs.append(epoch)
    return epochs, list(alive.values())


def streamed_and_batch(build, *sides, nonempty: bool = True) -> None:
    """``build(pw, *tables)`` over the streamed and the batch form of
    each side, in both packages: all four final states are equal (the
    streamed runs' epochs depend on the connector threads, so their
    update streams are not compared)."""
    results = []
    for pw in (jpw, tpw):
        for make in (lambda pw, s: _stream(pw, s[0]), lambda pw, s: _batch(pw, s[1])):
            pw.G.clear()
            ((rows, _),) = pw.debug._run_capture(build(pw, *[make(pw, s) for s in sides]))
            results.append(sorted((norm(tuple(v)) for v in rows.values()), key=repr))
            pw.G.clear()
    assert results[0] or not nonempty  # the JAX package's streamed run produced rows
    assert all(r == results[0] for r in results), results


@pytest.mark.parametrize("seed", range(5))
def test_tumbling_window_consistency(seed):
    side = _history(random.Random(seed))
    streamed_and_batch(lambda pw, t: t.windowby(t.t, window=pw.temporal.tumbling(duration=10)).reduce(
        start=pw.this._pw_window_start, n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v)), side)


@pytest.mark.parametrize("seed", range(5))
def test_sliding_window_consistency(seed):
    side = _history(random.Random(30 + seed))
    streamed_and_batch(lambda pw, t: t.windowby(t.t, window=pw.temporal.sliding(hop=5, duration=15)).reduce(
        start=pw.this._pw_window_start, n=pw.reducers.count(), mx=pw.reducers.max(pw.this.v)), side)


@pytest.mark.parametrize("seed", range(5))
def test_session_window_consistency(seed):
    side = _history(random.Random(60 + seed), t_range=40)
    streamed_and_batch(lambda pw, t: t.windowby(t.t, window=pw.temporal.session(max_gap=4)).reduce(
        n=pw.reducers.count(), lo=pw.reducers.min(pw.this.t), hi=pw.reducers.max(pw.this.t)), side)


@pytest.mark.parametrize("seed", range(4))
def test_interval_join_consistency(seed):
    rng = random.Random(90 + seed)
    a = _history(rng, n_keys=6, n_epochs=7, t_range=30)
    b = _history(rng, n_keys=6, n_epochs=7, t_range=30)

    def build(pw, x, y):
        return x.interval_join(y, x.t, y.t, pw.temporal.interval(-3, 3)).select(ta=x.t, tb=y.t, va=x.v, vb=y.v)

    streamed_and_batch(build, a, b)


@pytest.mark.parametrize("seed", range(4))
def test_asof_join_consistency(seed):
    """Right-side times made unique, as the JAX test makes them (an asof
    tie breaks on row identity, which differs between streamed and batch
    keys)."""
    rng = random.Random(120 + seed)
    a = _history(rng, n_keys=6, n_epochs=7, t_range=30)
    b = _history(rng, n_keys=6, n_epochs=7, t_range=1000)
    used: set = set()
    bumped: set = set()
    for epoch in b[0]:
        for _kind, _key, row in epoch:
            if id(row) in bumped:
                continue
            bumped.add(id(row))
            while row["t"] in used:
                row["t"] += 1000
            used.add(row["t"])

    def build(pw, x, y):
        return x.asof_join(y, x.t, y.t).select(ta=x.t, tb=y.t, va=x.v, vb=y.v)

    # the JAX test's data: most left times precede every right time, so
    # some seeds' backward matches are empty
    streamed_and_batch(build, a, b, nonempty=False)


@pytest.mark.parametrize("seed", range(3))
def test_windowed_groupby_instance_consistency(seed):
    side = _history(random.Random(150 + seed), n_keys=12)
    streamed_and_batch(lambda pw, t: t.windowby(t.t, window=pw.temporal.tumbling(duration=8), instance=t.k % 3)
                       .reduce(inst=pw.this._pw_instance, start=pw.this._pw_window_start,
                               s=pw.reducers.sum(pw.this.v)), side)


# ---------------------------------------------------------------------------
# tests/test_temporal_windows_extra.py


def test_intervals_over_gathers_neighborhoods():
    def build(pw):
        data = pw.debug.table_from_markdown("t  | v\n1  | 1\n4  | 2\n6  | 4\n12 | 8")
        probes = pw.debug.table_from_markdown("at\n5\n10")
        w = data.windowby(
            data.t, window=pw.temporal.intervals_over(at=probes.at, lower_bound=-4, upper_bound=4, is_outer=False)
        ).reduce(vals=pw.reducers.sorted_tuple(pw.this.v))
        return w.select(at=pw.this._pw_window_start, vals=pw.this.vals)

    ((rows, _),) = run_both(build)
    got = dict(values(rows))
    assert got[5] == (1, 2, 4) and got[10] == (4, 8)


def test_intervals_over_outer_keeps_empty_probes():
    def build(pw):
        data = pw.debug.table_from_markdown("t | v\n1 | 1")
        probes = pw.debug.table_from_markdown("at\n100")
        w = data.windowby(
            data.t, window=pw.temporal.intervals_over(at=probes.at, lower_bound=-1, upper_bound=1, is_outer=True)
        ).reduce(n=pw.reducers.count())
        return w.select(at=pw.this._pw_window_start, n=pw.this.n)

    ((rows, _),) = run_both(build)
    assert 100 in dict(values(rows))


def test_window_join_inner_pairs_same_window():
    def build(pw):
        a = pw.debug.table_from_markdown("t | va\n1 | 1\n11 | 2")
        b = pw.debug.table_from_markdown("t | vb\n2 | 10\n3 | 20\n12 | 30")
        return a.window_join(b, a.t, b.t, pw.temporal.tumbling(duration=10)).select(va=pw.left.va, vb=pw.right.vb)

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [(1, 10), (1, 20), (2, 30)]


def test_window_join_left_keeps_unmatched_windows():
    def build(pw):
        a = pw.debug.table_from_markdown("t  | va\n1  | 1\n25 | 9")
        b = pw.debug.table_from_markdown("t | vb\n2 | 10")
        return a.window_join_left(b, a.t, b.t, pw.temporal.tumbling(duration=10)).select(
            va=pw.left.va, vb=pw.right.vb
        )

    ((rows, _),) = run_both(build)
    got = values(rows)
    assert (1, 10) in got and (9, None) in got


def test_sliding_window_geometry_counts():
    def build(pw):
        t = pw.debug.table_from_markdown("t  | v\n7  | 1\n23 | 1")
        w = t.windowby(t.t, window=pw.temporal.sliding(hop=5, duration=15)).reduce(
            start=pw.this._pw_window_start, n=pw.reducers.count()
        )
        return w.select(w.start, w.n)

    ((rows, _),) = run_both(build)
    got = values(rows)
    assert sum(n for _s, n in got) == 6
    assert {s for s, n in got if n and s <= 7} >= {-5, 0, 5}


def test_session_window_merges_across_gap_boundary():
    def build(pw):
        t = pw.debug.table_from_markdown("t  | v\n1  | 1\n4  | 2\n9  | 4\n30 | 8")
        w = t.windowby(t.t, window=pw.temporal.session(max_gap=5)).reduce(
            lo=pw.reducers.min(pw.this.t), hi=pw.reducers.max(pw.this.t), s=pw.reducers.sum(pw.this.v)
        )
        return w.select(w.lo, w.hi, w.s)

    ((rows, _),) = run_both(build)
    assert sorted(values(rows)) == [(1, 9, 7), (30, 30, 8)]


def test_intervals_over_behavior_cutoff_applies():
    def build(pw):
        data = pw.debug.table_from_markdown(
            """
        t  | v  | __time__ | __diff__
        1  | 10 | 2        | 1
        20 | 5  | 4        | 1
        2  | 90 | 6        | 1
        """
        )
        probes = pw.debug.table_from_markdown("at\n2\n20")
        w = data.windowby(
            data.t,
            window=pw.temporal.intervals_over(at=probes.at, lower_bound=-2, upper_bound=2, is_outer=False),
            behavior=pw.temporal.common_behavior(cutoff=0),
        ).reduce(s=pw.reducers.sum(pw.this.v))
        return w.select(pw.this.s)

    ((rows, _),) = run_both(build)
    assert sorted(r[0] for r in values(rows)) == [5, 10]


# ---------------------------------------------------------------------------
# the plan rewrite: a temporal node is a row-path node


@pytest.mark.parametrize("name", ["tumbling", "interval_join", "asof_join", "window_join"])
def test_results_equal_at_optimize_0_and_2(name, monkeypatch):
    """``pw.run`` rewrites at ``optimize=2``: the temporal operators give
    the same sink rows at 0 and 2 in the port, and equal the JAX
    package's at 2."""

    def build(pw):
        a, b = _two_sides(pw)
        if name == "tumbling":
            return a.windowby(a.t, window=pw.temporal.tumbling(duration=10), instance=a.k).reduce(
                s=pw.reducers.count())
        if name == "interval_join":
            return a.interval_join_outer(b, a.t, b.t, pw.temporal.interval(-2, 3), pw.left.k == pw.right.k).select(
                va=pw.left.va, vb=pw.right.vb)
        if name == "asof_join":
            return a.asof_join(b, a.t, b.t, pw.left.k == pw.right.k).select(va=pw.left.va, vb=pw.right.vb)
        return a.window_join_outer(b, a.t, b.t, pw.temporal.tumbling(duration=10)).select(
            va=pw.left.va, vb=pw.right.vb)

    def sink(pw, level):
        pw.G.clear()
        table = build(pw)
        rows: list = []
        pw.io.subscribe(table, on_change=lambda key, row, time, add: rows.append(
            (int(key), tuple(sorted((k, norm(v)) for k, v in row.items())), add)))
        pw.run(monitoring_level=pw.MonitoringLevel.NONE, optimize=level)
        pw.G.clear()
        return sorted(rows)

    at0, at2 = sink(tpw, 0), sink(tpw, 2)
    assert at0 and at0 == at2
    assert at2 == sink(jpw, 2)


# ---------------------------------------------------------------------------
# tests/test_static_analysis.py:154-190, with the port's analyzer


def _streaming_events(pw):
    class Never(pw.io.python.ConnectorSubject):
        def run(self) -> None:  # pragma: no cover - not executed
            pass

    class S(pw.Schema):
        k: str
        t: int
        v: int

    return pw.io.python.read(Never(), schema=S)


def _temporal_join(pw, kind):
    a = _streaming_events(pw)
    b = _streaming_events(pw)
    if kind == "interval":
        j = pw.temporal.interval_join(a, b, a.t, b.t, pw.temporal.interval(-1, 1), pw.left.k == pw.right.k)
    elif kind == "asof":
        j = pw.temporal.asof_join(a, b, a.t, b.t, pw.left.k == pw.right.k)
    elif kind == "asof_now":
        j = pw.temporal.asof_now_join(a, b, pw.left.k == pw.right.k)
    else:
        j = a.join(b, pw.left.k == pw.right.k)
    j = j.select(k=pw.left.k, v=pw.left.v)
    j.groupby(j.k).reduce(j.k, c=pw.reducers.count())


@pytest.mark.parametrize("kind", ["interval", "asof", "asof_now", "plain"])
def test_s001_over_temporal_joins_like_jax(kind):
    """A temporal join bounds its downstream state (no PW-S001); the plain
    join keeps it.  The findings are equal by code and node."""
    found = {}
    for pw in (jpw, tpw):
        pw.G.clear()
        _temporal_join(pw, kind)
        found[pw] = [(d.code, d.severity, d.node_id, d.node_name) for d in pw.analyze()
                     if not d.code.startswith("PW-J")]
        pw.G.clear()
    assert found[tpw] == found[jpw]
    assert ("PW-S001" in [c for c, *_ in found[tpw]]) == (kind == "plain")
