"""The port's plan compiler (``pathway_tpu_torch.analysis.rewrite``, ROADMAP
slice 16a) against the JAX package's, on the CPU.

Each graph is written once, as a function of the package module
(``build(pw, ...)``), and built on a fresh graph in each package:

- the golden plans: the builders of ``tests/test_plan_golden.py`` give the
  port the committed ``tests/plans/*.txt`` byte for byte (read only here);
- ``explain()`` prints the same plan text in both packages over those
  graphs and the pipelines of ``tests/test_plan_equivalence.py`` and
  ``tests/test_columnar.py`` (all but the windowed groupby, whose
  ``stdlib.temporal`` the port brings with slice 16d);
- results: the port's captured rows, keys included, are equal at
  ``optimize=0`` and ``optimize=2``, at 1 and 2 workers, and equal to the
  JAX package's; at ``optimize=2`` the columnar fast paths run (the
  scheduler's ``columnar_rows`` counter is above 0), also under ``pw.run``.
"""

from __future__ import annotations

import json
import pathlib
import random

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.analysis.rewrite import optimize_graph as j_optimize
from pathway_tpu.engine.cluster import Cluster as JCluster
from pathway_tpu.engine.graph import CaptureNode as JCapture
from pathway_tpu.engine.scheduler import Scheduler as JScheduler
from pathway_tpu_torch.analysis.rewrite import optimize_graph as t_optimize
from pathway_tpu_torch.engine.cluster import Cluster as TCluster
from pathway_tpu_torch.engine.graph import CaptureNode as TCapture
from pathway_tpu_torch.engine.scheduler import Scheduler as TScheduler

PLANS_DIR = pathlib.Path(__file__).parent / "plans"

ENGINE = {
    jpw: (j_optimize, JCapture, JScheduler, JCluster),
    tpw: (t_optimize, TCapture, TScheduler, TCluster),
}


@pytest.fixture(autouse=True)
def fresh_port_graph():
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


# ---------------------------------------------------------------------------
# the golden graphs (tests/test_plan_golden.py), written once


def schemas(pw):
    class W(pw.Schema):
        word: str

    class E(pw.Schema):
        k: str
        a: int
        b: int

    return W, E


def golden_wordcount(pw, files=None):
    W, _ = schemas(pw)
    words = pw.debug.table_from_rows(W, [("a",), ("b",), ("a",)])
    counts = words.groupby(words.word).reduce(words.word, n=pw.reducers.count())
    mid = counts.select(counts.word, n=counts.n, dead=counts.n * 100 + 1)
    return mid.select(mid.word, out=mid.n + 6)


def golden_join_pushdown(pw, files=None):
    _, E = schemas(pw)
    t = pw.debug.table_from_rows(E, [("a", 1, 2), ("b", 5, 1)])
    s = pw.debug.table_from_rows(E, [("a", 3, 4), ("b", 7, 0)])
    lt = t.select(t.k, a=t.a + 0, b=t.b + 0)
    rt = s.select(s.k, a=s.a + 0, b=s.b + 0)
    j = lt.join(rt, lt.k == rt.k).select(k=pw.left.k, la=pw.left.a, ra=pw.right.a)
    f1 = j.filter(j.la > 2)
    return f1.filter(f1.ra > 0)


def golden_append_only_groupby(pw, files=None):
    _, E = schemas(pw)
    t = pw.debug.table_from_rows(E, [("a", 1, 2), ("a", 5, 1)])
    s = pw.debug.table_from_rows(E, [("a", 3, 4)])
    j = t.join(s, t.k == s.k).select(k=pw.left.k, a=pw.left.a)
    return j.groupby(j.k).reduce(j.k, lo=pw.reducers.min(j.a), hi=pw.reducers.max(j.a),
                                 n=pw.reducers.count())


GOLDEN = {
    "wordcount": golden_wordcount,
    "join_pushdown": golden_join_pushdown,
    "append_only_groupby": golden_append_only_groupby,
}


# ---------------------------------------------------------------------------
# the file-fed pipelines (tests/test_plan_equivalence.py, tests/test_columnar.py)


def write_files(tmp_path) -> dict:
    rng = random.Random(11)
    (tmp_path / "words.jsonl").write_text(
        "\n".join(json.dumps({"word": "w%d" % rng.randint(0, 12)}) for _ in range(120)))
    for name, seed, n in (("main", 23, 80), ("side", 41, 12)):
        rng = random.Random(seed)
        (tmp_path / f"{name}.jsonl").write_text("\n".join(
            json.dumps({"k": rng.choice("abcde"), "t": rng.randint(0, 99), "a": rng.randint(-30, 30),
                        "b": rng.randint(0, 9)}) for _ in range(n)))
    rng = random.Random(29)
    (tmp_path / "events.jsonl").write_text("\n".join(
        json.dumps({"word": "w%d" % rng.randint(0, 15), "n": rng.randint(-20, 20),
                    "x": rng.random() * 10 - 5}) for _ in range(400)))
    return {name: str(tmp_path / f"{name}.jsonl") for name in ("words", "main", "side", "events")}


def event_schemas(pw):
    class Words(pw.Schema):
        word: str

    class Events(pw.Schema):
        k: str
        t: int
        a: int
        b: int

    class Ev(pw.Schema):
        word: str
        n: int
        x: float

    return Words, Events, Ev


def eq_wordcount(pw, files):
    Words, _, _ = event_schemas(pw)
    lines = pw.io.jsonlines.read(files["words"], schema=Words, mode="static")
    counts = lines.groupby(lines.word).reduce(lines.word, n=pw.reducers.count())
    mid = counts.select(counts.word, n=counts.n, dead=counts.n * 100 + 1)
    return mid.select(mid.word, out=mid.n + 6)


def eq_join_filter(pw, files):
    _, Events, _ = event_schemas(pw)
    t = pw.io.jsonlines.read(files["main"], schema=Events, mode="static")
    s = pw.io.jsonlines.read(files["side"], schema=Events, mode="static")
    j = t.join(s, t.k == s.k).select(k=pw.left.k, a=pw.left.a, b=pw.right.b)
    f = j.filter(j.a > 0)
    return f.groupby(f.k).reduce(f.k, lo=pw.reducers.min(f.a), n=pw.reducers.count())


def eq_udf_mix(pw, files):
    _, Events, _ = event_schemas(pw)
    t = pw.io.jsonlines.read(files["main"], schema=Events, mode="static")
    u = t.select(t.k, z=pw.apply(lambda a, b: a * 2 + b, t.a, t.b), b=t.b)
    f = u.filter(u.z != 0)
    chained = f.select(f.k, y=f.z + 1, dead=f.b * 3)
    return chained.select(pw.this.k, pw.this.y)


def col_frame_chain(pw, files):
    _, _, Ev = event_schemas(pw)
    t = pw.io.jsonlines.read(files["events"], schema=Ev, mode="static")
    flt = t.filter(t.n >= 0)
    proj = flt.select(flt.x, flt.word)
    return proj.groupby(proj.word).reduce(proj.word, s=pw.reducers.sum(proj.x), c=pw.reducers.count())


def col_udf_fallback(pw, files):
    _, _, Ev = event_schemas(pw)
    t = pw.io.jsonlines.read(files["events"], schema=Ev, mode="static")
    u = t.select(t.word, z=pw.apply(lambda n, x: n * 2 + int(x), t.n, t.x))
    return u.groupby(u.word).reduce(u.word, s=pw.reducers.sum(u.z))


PIPELINES = {
    "eq_wordcount": eq_wordcount,
    "eq_join_filter": eq_join_filter,
    "eq_udf_mix": eq_udf_mix,
    "col_frame_chain": col_frame_chain,
    "col_udf_fallback": col_udf_fallback,
}
ALL_GRAPHS = {**{f"golden_{n}": b for n, b in GOLDEN.items()}, **PIPELINES}


def plan_text(pw, build, files=None, level: int = 2) -> str:
    """``plan.format()`` of ``build``'s graph, captured, at ``level``."""
    optimize, capture, _, _ = ENGINE[pw]
    pw.G.clear()
    table = build(pw, files)
    capture(pw.G.engine_graph, table._node)
    _graph, plan = optimize(pw.G.engine_graph, level)
    pw.G.clear()
    return plan.format() + "\n"


def run_rows(pw, build, files, level: int, n_threads: int) -> tuple[dict, dict]:
    """(captured rows by key, the scheduler's columnar_rows counter) of
    ``build``'s graph at ``level`` on ``n_threads`` workers."""
    optimize, capture, scheduler, cluster_cls = ENGINE[pw]
    pw.G.clear()
    table = build(pw, files)
    cap = capture(pw.G.engine_graph, table._node)
    exec_graph, _plan = optimize(pw.G.engine_graph, level)
    sched = scheduler(exec_graph, autocommit_ms=10)
    cluster = cluster_cls(threads=n_threads)
    try:
        ctx = sched.run_cluster(cluster)
    finally:
        cluster.close()
    pw.G.clear()
    return dict(ctx.state(cap)["rows"]), dict(ctx.stats.get("columnar_rows", {}))


def assert_same_rows(a: dict, b: dict, msg: str) -> None:
    """Equal keys and cells; a float cell within 1e-9 (native frame partials
    sum f64 in segment order, not the row path's, as
    ``tests/test_columnar.py`` allows)."""
    assert a.keys() == b.keys(), msg
    for k, va in a.items():
        vb = b[k]
        assert len(va) == len(vb), f"{msg}: {k}"
        for ca, cb in zip(va, vb):
            if isinstance(ca, float):
                assert cb == pytest.approx(ca, rel=1e-9, abs=1e-9), f"{msg}: {k}"
            else:
                assert ca == cb, f"{msg}: {k}"


# ---------------------------------------------------------------------------
# plans


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_plan_byte_for_byte(name):
    text = plan_text(tpw, GOLDEN[name])
    assert text == (PLANS_DIR / f"{name}.txt").read_text()
    assert text == plan_text(jpw, GOLDEN[name])


@pytest.mark.parametrize("name", sorted(ALL_GRAPHS))
def test_explain_matches_jax_package(tmp_path, name):
    """``pw.explain()`` over the global graph prints the same plan in both
    packages, at the default level and at each level named."""
    files = write_files(tmp_path)
    texts = {}
    for pw in (jpw, tpw):
        pw.G.clear()
        ALL_GRAPHS[name](pw, files)
        texts[pw] = [pw.explain().format(), *(pw.explain(optimize=lvl).format() for lvl in (0, 1, 2))]
        assert isinstance(pw.explain(), pw.ExecutionPlan)
        pw.G.clear()
    assert texts[tpw] == texts[jpw]
    assert texts[tpw][0] == texts[tpw][3]  # the default level is 2


def test_optimize_graph_leaves_the_captured_graph_alone():
    """The rewrite works on a clone: the captured graph keeps its nodes."""
    tpw.G.clear()
    table = golden_wordcount(tpw)
    TCapture(tpw.G.engine_graph, table._node)
    before = [(n.id, type(n).__name__) for n in tpw.G.engine_graph.nodes]
    exec_graph, plan = t_optimize(tpw.G.engine_graph, 2)
    assert [(n.id, type(n).__name__) for n in tpw.G.engine_graph.nodes] == before
    assert len(exec_graph.nodes) < len(before)
    assert plan.counters() == {"dead_column_elim": 1, "select_fusion": 2}


# ---------------------------------------------------------------------------
# results


@pytest.mark.parametrize("n_threads", [1, 2])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_results_equal_at_optimize_0_and_2(tmp_path, name, n_threads):
    files = write_files(tmp_path)
    build = PIPELINES[name]
    plain, _ = run_rows(tpw, build, files, 0, n_threads)
    optimized, counter = run_rows(tpw, build, files, 2, n_threads)
    assert plain, f"{name}: empty capture"
    assert_same_rows(optimized, plain, f"{name}: optimize=2 diverged from optimize=0 at {n_threads} worker(s)")
    assert counter.get("columnar", 0) > 0, (name, counter)
    want, _ = run_rows(jpw, build, files, 2, n_threads)
    assert_same_rows(optimized, want, f"{name}: the port diverged from the JAX package")


@pytest.mark.parametrize("level", [0, 2])
def test_pw_run_takes_the_plan(tmp_path, level):
    """``pw.run(optimize=...)`` executes the rewritten view: the same rows
    at both levels, ``G.last_plan`` and the scheduler's plan counters set,
    and the columnar path taken at level 2 only where the plan says so."""
    files = write_files(tmp_path)
    rows = {}
    tpw.G.clear()
    table = col_frame_chain(tpw, files)
    tpw.io.subscribe(table, on_change=lambda key, row, time, is_addition: rows.__setitem__(
        key, row if is_addition else None))
    ctx = tpw.run(optimize=level, monitoring_level=tpw.MonitoringLevel.NONE)
    plan, sched = tpw.G.last_plan, tpw.G.active_scheduler
    assert plan.level == level and sched.execution_plan is plan
    assert sched.plan_counters == plan.counters()
    assert sched.memory_estimate is not None and sched.memory_estimate.total_bytes > 0
    assert sched.analysis_findings == tpw.analysis.count_by_severity(tpw.analyze(optimize=level))
    assert sched.analysis_findings["error"] == 0
    if level == 2:
        assert any(p == "columnar" for _n, p, _r in plan.columnar)
    assert ctx.stats["columnar_rows"]["columnar"] > 0 or level == 0
    got = {k: v for k, v in rows.items() if v is not None}
    want, _ = run_rows(tpw, col_frame_chain, files, 0, 1)
    assert {tuple(r.values()) for r in got.values()} == {tuple(v) for v in want.values()}
