"""The port's static analyzer (``pathway_tpu_torch.analysis``, ROADMAP slice
16a) against the JAX package's, on the CPU, and its device pass (A11).

Each graph is written once, as a function of the package module
(``build(pw, tmp)``), and built on a fresh graph in each package:

- findings: ``analyze()`` gives the same diagnostics on both sides (code,
  severity, node id, node name and message) for every code of the graph
  passes that ``tests/test_static_analysis.py`` triggers; the PW-J codes
  are each package's own device pass, over its own source, and are held
  below instead;
- memory: ``estimate_memory`` prices the same operators at the same bytes
  for the same ``EstimateParams`` (pure Python on both sides: exactly);
- ``pw.run``: ``strict=True`` and ``PATHWAY_STRICT=1`` raise
  ``AnalysisError`` on a graph with an error finding in both packages,
  before any source starts, and run a clean graph, setting ``G.last_plan``;
- ``tracecrit`` reads the port's own tracing dumps as the JAX package's
  reads them;
- A11: for each of PW-J002..J005, snippets that the pass must flag, and
  the same snippets waived or on a cold path, which it must not; the scan
  of the whole port finds no unwaived error; ``check_device`` attributes
  findings to the index node of a ``DataIndex`` graph;
- isolation: a subprocess with ``jax`` and ``pathway_tpu`` blocked imports
  ``pathway_tpu_torch.analysis`` and analyses and runs a graph.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.analysis import tracecrit as j_tracecrit
from pathway_tpu.engine import graph as j_eg
from pathway_tpu.internals import tracing as j_tracing
from pathway_tpu_torch.analysis import device as dev
from pathway_tpu_torch.analysis import tracecrit as t_tracecrit
from pathway_tpu_torch.engine import graph as t_eg
from pathway_tpu_torch.internals import tracing as t_tracing

REPO = pathlib.Path(__file__).resolve().parent.parent
EG = {jpw: j_eg, tpw: t_eg}


@pytest.fixture(autouse=True)
def fresh_port_graph():
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


def kw(pw) -> dict:
    """The device argument of the port's device indexes (the JAX package's
    take none)."""
    return {"device": "cpu"} if pw is tpw else {}


# ---------------------------------------------------------------------------
# graphs, written once (the trigger graphs of tests/test_static_analysis.py)


def subject(pw):
    class Never(pw.io.python.ConnectorSubject):
        """Never-started source: graphs here are analyzed, not run."""

        def run(self) -> None:  # pragma: no cover - not executed
            pass

    return Never()


def static_table(pw):
    class S(pw.Schema):
        word: str
        n: int

    return pw.debug.table_from_rows(S, [("a", 1), ("b", 2)])


def streaming_table(pw):
    class S(pw.Schema):
        word: str
        n: int

    return pw.io.python.read(subject(pw), schema=S)


def streaming_events(pw):
    class S(pw.Schema):
        k: str
        t: int
        v: int

    return pw.io.python.read(subject(pw), schema=S)


def files_table(pw, tmp):
    """Byte-range-partitioned, non-order-preserving source."""
    d = tmp / "data"
    d.mkdir(parents=True, exist_ok=True)
    (d / "part.jsonl").write_text('{"word": "a", "n": 1}\n{"word": "b", "n": 2}\n')

    class S(pw.Schema):
        word: str
        n: int

    return pw.io.jsonlines.read(str(d), schema=S, mode="static")


class StatefulAdapter:
    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        pass


def hooked_node(pw):
    class Hooked(EG[pw].Node):
        def snapshot_state(self, ctx):
            return {}

        def on_restore(self, ctx):
            pass

    return Hooked


def t001_join(pw, tmp):
    class L(pw.Schema):
        k: int
        v: int

    class R(pw.Schema):
        k: str
        w: int

    left = pw.debug.table_from_rows(L, [(1, 10)])
    right = pw.debug.table_from_rows(R, [("1", 20)])
    left.join(right, left.k == right.k).select(pw.this.v, pw.this.w)


def t001_declare(pw, tmp):
    t = static_table(pw)
    t.select(s=pw.declare_type(str, pw.this.n + 1))


def p001(pw, tmp):
    t = streaming_table(pw)
    t.select(u=pw.apply(str.upper, t.word))


def s001(pw, tmp):
    t = streaming_table(pw)
    t.groupby(t.word).reduce(t.word, c=pw.reducers.count())


def s002(pw, tmp):
    t = streaming_table(pw)
    agg = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
    agg.deduplicate(value=agg.c, acceptor=lambda new, old: new > old)


def d001(pw, tmp):
    t = static_table(pw)
    sel = t.select(t.word, dead=t.n + 1)
    sel.select(t2=pw.this.word)._capture_node()


def n001(pw, tmp):
    t = static_table(pw)
    t.select(v=pw.declare_type(int, pw.if_else(t.n > 1, t.n, None)))._capture_node()


def x001_dedup(pw, tmp):
    t = files_table(pw, tmp)
    t.deduplicate(value=t.n, acceptor=lambda new, old: new > old)


def x001_index_upsert(pw, tmp):
    docs = files_table(pw, tmp)
    docs = docs.select(word=pw.this.word, vec=pw.apply(lambda n: (float(n), 0.0), pw.this.n))
    index = pw.indexing.BruteForceKnnFactory(dimensions=2, reserved_space=8, **kw(pw)).build_data_index(
        docs.vec, docs)

    class QueryS(pw.Schema):
        qx: float
        qy: float

    queries = pw.io.python.read(subject(pw), schema=QueryS)
    queries = queries.select(qvec=pw.apply(lambda x, y: (float(x), float(y)), pw.this.qx, pw.this.qy))
    index.query_as_of_now(queries.qvec, number_of_matches=1)


def x001_upsert_source(pw, tmp):
    streaming_table(pw)
    node = next(n for n in pw.G.engine_graph.nodes if isinstance(n, EG[pw].InputNode))
    node.meta["source"].update({"upsert": True, "partitioning": "round-robin", "order_preserving": False})


def x002(pw, tmp):
    t = files_table(pw, tmp)
    agg = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
    agg.groupby(agg.word).reduce(agg.word, m=pw.reducers.max(agg.c))


def x003(pw, tmp):
    t = files_table(pw, tmp)
    t.groupby(t.word).reduce(t.word, last=pw.reducers.latest(t.n))._capture_node()


def r001(pw, tmp):
    t = streaming_table(pw)
    node = EG[pw].Node(pw.G.engine_graph, [t._node], "external_sink")
    node.adapter = object()
    node = hooked_node(pw)(pw.G.engine_graph, [t._node], "hooked_sink")
    node.adapter = object()


def r002(pw, tmp):
    t = streaming_table(pw)
    node = hooked_node(pw)(pw.G.engine_graph, [t._node], "index_sink")
    node.adapter = StatefulAdapter()


def m001_m003(pw, tmp):
    for sink in (True, False):
        a, b = streaming_events(pw), streaming_events(pw)
        j = a.join(b, a.k == b.k).select(k=pw.left.k, v=pw.right.v)
        if sink:
            j._capture_node()


def m002(pw, tmp):
    s001(pw, tmp)


def m002_device(pw, tmp):
    """Python-fed docs feeding a KNN index: the device-resident state that
    the per-card budget prices."""

    class DocS(pw.Schema):
        doc_id: str = pw.column_definition(primary_key=True)
        vx: float
        vy: float

    docs = pw.io.python.read(subject(pw), schema=DocS)
    docs = docs.select(doc_id=pw.this.doc_id,
                       vec=pw.apply(lambda x, y: (float(x), float(y)), pw.this.vx, pw.this.vy))
    index = pw.indexing.BruteForceKnnFactory(dimensions=2, reserved_space=4096, **kw(pw)).build_data_index(
        docs.vec, docs)
    index.query_as_of_now(docs.vec, number_of_matches=2)


def rag_server(pw, tmp):
    """The served graph of ``tests/test_torch_vector_store.py`` and of
    ``chip_smoke.py``'s phase 15, built and not run: ``VectorStoreServer``
    over files, a QA server over its store, and the routes that
    ``run_server`` adds (``DocumentStoreServer``)."""
    import test_torch_vector_store as vs

    tmp.mkdir(parents=True, exist_ok=True)
    vs.write_files(tmp)
    llm = pw.xpacks.llm
    docs = pw.io.fs.read(str(tmp), format="binary", mode="streaming", with_metadata=True)
    server = llm.vector_store.VectorStoreServer(
        docs,
        index_factory=pw.indexing.BruteForceKnnFactory(embedder=vs.embedder(pw), reserved_space=64, **kw(pw)),
        splitter=llm.splitters.TokenCountSplitter(min_tokens=4, max_tokens=12),
    )
    rag = llm.question_answering.BaseRAGQuestionAnswerer(vs.digest_chat(pw), server.document_store, search_topk=4)
    rag.build_server("127.0.0.1", vs.free_port())
    llm.servers.DocumentStoreServer("127.0.0.1", vs.free_port(), server.document_store)


def clean(pw, tmp):
    t = static_table(pw)
    t.select(t.word, m=t.n + 1)._capture_node()


#: (builder, environment, codes it must give)
FINDINGS = {
    "t001_join": (t001_join, {}, {"PW-T001"}),
    "t001_declare": (t001_declare, {}, {"PW-T001"}),
    "p001": (p001, {}, {"PW-P001"}),
    "s001": (s001, {}, {"PW-S001"}),
    "s002": (s002, {}, {"PW-S002"}),
    "d001": (d001, {}, {"PW-D001"}),
    "n001": (n001, {}, {"PW-N001"}),
    "x001_dedup": (x001_dedup, {}, {"PW-X001"}),
    "x001_index_upsert": (x001_index_upsert, {}, {"PW-X001"}),
    "x001_upsert_source": (x001_upsert_source, {}, {"PW-X001"}),
    "x002": (x002, {}, {"PW-X002"}),
    "x003": (x003, {}, {"PW-X003"}),
    "r001": (r001, {}, {"PW-R001"}),
    "r002": (r002, {}, {"PW-R002"}),
    "m001_m003": (m001_m003, {}, {"PW-M001", "PW-M003"}),
    "m002": (m002, {"PATHWAY_MEMORY_BUDGET": "64K"}, {"PW-M002"}),
    "m002_device": (m002_device, {"PATHWAY_DEVICE_BUDGET_BYTES": "1", "PATHWAY_DEVICE_CHIPS": "2"},
                    {"PW-M002"}),
    "rag_server": (rag_server, {}, {"PW-M001", "PW-M003", "PW-D001", "PW-P001", "PW-R002", "PW-S001"}),
    "clean": (clean, {}, set()),
}


def findings(pw, build, tmp, optimize=None) -> list:
    pw.G.clear()
    build(pw, tmp)
    diags = pw.analyze(optimize=optimize)
    pw.G.clear()
    return diags


def graph_findings(diags) -> list:
    """What the two packages must agree on: every finding of a graph pass
    (the PW-J findings are each package's scan of its own source)."""
    return [(d.code, d.severity, d.node_id, d.node_name, d.message, d.details.get("scope"))
            for d in diags if not d.code.startswith("PW-J")]


@pytest.mark.parametrize("optimize", [None, 2])
@pytest.mark.parametrize("name", sorted(FINDINGS))
def test_findings_match_jax_package(tmp_path, monkeypatch, name, optimize):
    build, env, want_codes = FINDINGS[name]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    got = findings(tpw, build, tmp_path / "port", optimize)
    want = findings(jpw, build, tmp_path / "jax", optimize)
    assert graph_findings(got) == graph_findings(want)
    assert [d.trace.rsplit(":", 1)[-1] for d in got if not d.code.startswith("PW-J")] == [
        d.trace.rsplit(":", 1)[-1] for d in want if not d.code.startswith("PW-J")]
    if optimize is None:  # the rewrite may cure a finding (a dead column is elided)
        assert want_codes <= {d.code for d in got}, [d.format() for d in got]
    if not want_codes:
        assert not [d for d in got if d.severity == tpw.analysis.SEV_ERROR]


def test_registry_matches_jax_package():
    """The same codes at the same severities; the rows other than PW-J read
    as the JAX package's."""
    from pathway_tpu.analysis.diagnostics import CODE_INFO as J_INFO

    t_info = tpw.analysis.CODE_INFO
    assert t_info.keys() == J_INFO.keys()
    for code, (sev, desc) in t_info.items():
        assert sev == J_INFO[code][0], code
        if not code.startswith("PW-J"):
            assert desc == J_INFO[code][1], code
    assert "torch" in t_info["PW-J002"][1] and "no site emits it" in t_info["PW-J001"][1]
    assert set(tpw.analysis.__all__) == set(jpw.analysis.__all__)


# ---------------------------------------------------------------------------
# memory


MEMORY_GRAPHS = ["s001", "m001_m003", "x002", "x001_index_upsert", "d001", "t001_join"]


@pytest.mark.parametrize("params", [
    {},
    {"rows": 123_456, "distinct_keys": 77, "str_bytes": 12, "workers": 4},
    {"rows": 10**9, "window_rows": 16, "static_rows": 5, "array_bytes": 3072, "workers": 3},
], ids=["defaults", "keys", "large"])
@pytest.mark.parametrize("name", MEMORY_GRAPHS)
def test_estimate_memory_matches_jax_package(tmp_path, name, params):
    build = FINDINGS[name][0]
    reports = {}
    for pw, tag in ((jpw, "jax"), (tpw, "port")):
        pw.G.clear()
        build(pw, tmp_path / tag)
        reports[tag] = [pw.estimate_memory(optimize=level, **params) for level in (0, 2)]
        assert isinstance(reports[tag][0], pw.MemoryReport)
        pw.G.clear()
    for got, want in zip(reports["port"], reports["jax"]):
        assert got.total_bytes == want.total_bytes and got.max_worker_bytes == want.max_worker_bytes
        assert [dataclasses.astuple(o) for o in got.operators] == [dataclasses.astuple(o) for o in want.operators]
        assert got.format() == want.format()
        assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)


def test_estimate_params_match_jax_package(monkeypatch):
    monkeypatch.setenv("PATHWAY_MEMORY_ROWS", "123")
    monkeypatch.setenv("PATHWAY_MEMORY_KEYS", "7")
    monkeypatch.setenv("PATHWAY_MEMORY_STR_BYTES", "not-a-number")
    got, want = tpw.EstimateParams.from_env(workers=3), jpw.EstimateParams.from_env(workers=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rows == 123 and got.distinct_keys == 7 and got.workers == 3


# ---------------------------------------------------------------------------
# pw.run


@pytest.mark.parametrize("how", ["strict", "env"])
def test_strict_refuses_error_findings_and_runs_clean_graphs(monkeypatch, how):
    """Both packages: an error finding (a dedup over a retracting input,
    PW-S002) refuses the run before its connector thread starts; a clean
    graph runs, and the plan it ran is ``G.last_plan``."""
    kwargs = {"strict": True} if how == "strict" else {}
    if how == "env":
        monkeypatch.setenv("PATHWAY_STRICT", "1")
    for pw in (jpw, tpw):
        started = threading.Event()

        class Tracking(pw.io.python.ConnectorSubject):
            def run(self) -> None:
                started.set()

        class S(pw.Schema):
            word: str

        pw.G.clear()
        t = pw.io.python.read(Tracking(), schema=S)
        agg = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
        agg.deduplicate(value=agg.c, acceptor=lambda new, old: new > old)
        with pytest.raises(pw.AnalysisError) as ei:
            pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kwargs)
        assert any(d.code == "PW-S002" for d in ei.value.diagnostics)
        assert "refusing to run (strict mode)" in str(ei.value)
        time.sleep(0.05)
        assert not started.is_set(), f"{pw.__name__}: the connector ran despite strict"
        pw.G.clear()
        out = []
        t = static_table(pw)
        pw.io.subscribe(t.select(t.word, m=t.n + 1), on_change=lambda key, row, time, is_addition: out.append(row))
        assert pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kwargs) is not None
        assert sorted(r["m"] for r in out) == [2, 3]
        assert isinstance(pw.G.last_plan, pw.ExecutionPlan) and pw.G.last_plan.level == 2
        pw.G.clear()


# ---------------------------------------------------------------------------
# tracecrit over the port's own tracing dumps


@pytest.fixture
def tracing_on():
    for tr in (t_tracing, j_tracing):
        tr.configure(PATHWAY_TRACE="1", PATHWAY_TRACE_SAMPLE="1.0", PATHWAY_TRACE_TAIL_MS=None,
                     PATHWAY_TRACE_RING=None, PATHWAY_TRACE_DIR=None)
        tr.reset()
    yield
    for tr in (t_tracing, j_tracing):
        tr.configure(PATHWAY_TRACE=None, PATHWAY_TRACE_SAMPLE=None, PATHWAY_TRACE_TAIL_MS=None,
                     PATHWAY_TRACE_RING=None, PATHWAY_TRACE_DIR=None)
        tr.reset()


def test_tracecrit_reads_the_port_dumps(tmp_path, tracing_on):
    """Requests recorded with the port's tracing (spans at fixed stamps:
    a 1 ms wait, then a search of 2 ms and more, inside the request's
    span), dumped to a file, read back: the port's critical-path report
    equals the JAX package's on the same dump, and attributes the
    stages."""
    ms = 1_000_000
    for i in range(6):
        ctx = t_tracing.new_trace()
        t0 = t_tracing.now_ns()
        wait_end, end = t0 + ms, t0 + 3 * ms + i * ms // 2
        e2e = t_tracing.record_span("serve_e2e", t0, end, ctx=ctx)
        t_tracing.record_spans(ctx.child(e2e), [("serve_sched_wait", t0, wait_end, None),
                                                ("search", wait_end, end, None)])
        t_tracing.finish_request(ctx, end)
    path = str(tmp_path / "trace.json")
    t_tracing.dump(path)
    events = t_tracecrit.load_events(path)
    rep = t_tracecrit.report(events)
    assert rep == j_tracecrit.report(j_tracecrit.load_events(path))
    assert rep["requests"] == 6
    assert rep["p50"]["by_category_ms"]["device"] >= 2.0
    assert [s["stage"] for s in rep["slowest"]["critical_path"]][:2] == ["serve_e2e", "search"]
    assert all(t_tracecrit.connected_traces(events).values())


# ---------------------------------------------------------------------------
# A11: the device pass


def scan(src: str, filename: str = "pathway_tpu_torch/parallel/snippet.py") -> list:
    return dev.scan_source(textwrap.dedent(src), filename)


#: code -> (flagged snippet, the line the finding points at)
SNIPPETS = {
    "PW-J002_readback": ("PW-J002", """
        import torch
        def serve(outs):
            scores = []
            for o in outs:
                scores.append(o.max().item())
            return scores
        """, 6),
    "PW-J002_sync": ("PW-J002", """
        import torch
        def serve(batches, enc):
            for b in batches:
                enc(b)
                torch.cuda.synchronize()
        """, 6),
    "PW-J002_upload": ("PW-J002", """
        import torch
        def serve(queries, device):
            for q in range(len(queries)):
                x = torch.as_tensor(queries[q], device=device)
        """, 5),
    "PW-J002_to_device": ("PW-J002", """
        import torch
        def epoch(rows, index):
            for r in range(4):
                index.add(rows.to(index.device))
        """, 5),
    "PW-J003": ("PW-J003", """
        import torch
        class Index:
            def upsert(self, slots, rows):
                self.slab = self.slab.index_copy(0, slots, rows)
        """, 5),
    "PW-J003_where": ("PW-J003", """
        import torch
        class Index:
            def clear(self, dead):
                self._vecs[0] = torch.where(dead[:, None], 0.0, self._vecs[0])
        """, 5),
    "PW-J004": ("PW-J004", """
        import torch.distributed as dist
        def step(x, rank):
            if rank == 0:
                dist.all_reduce(x)
        """, 5),
    "PW-J004_mesh_copy": ("PW-J004", """
        def ring(blocks, ready, device, process_index):
            if process_index > 0:
                blocks, ready = _hand_on(blocks, ready, device)
        """, 4),
    "PW-J005_lock": ("PW-J005", """
        import torch
        class Index:
            def search(self, q):
                with self._lock:
                    return self.scores(q).cpu()
        """, 6),
    "PW-J005_lane": ("PW-J005", """
        import torch
        class ExternalIndexNode:
            def _answer(self, st, items):
                return self.adapter.search(items).tolist()
        """, 5),
}


def waived(src: str, line: int, code: str) -> str:
    lines = src.split("\n")
    lines[line - 1] += f"  # pw-j{code[-3:]}: a reason"
    return "\n".join(lines)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_device_pass_flags_its_snippet(name):
    code, src, line = SNIPPETS[name]
    filename = ("pathway_tpu_torch/engine/external_index.py" if name == "PW-J005_lane"
                else "pathway_tpu_torch/parallel/snippet.py")
    diags = scan(src, filename)
    assert [(d.code, d.details["line"]) for d in diags] == [(code, line)], [d.format() for d in diags]
    assert diags[0].severity == tpw.analysis.CODE_INFO[code][0]
    # a waiver on the line, specific or general, silences it
    assert scan(waived(textwrap.dedent(src), line, code), filename) == []
    general = textwrap.dedent(src).split("\n")
    general[line - 1] += "  # pw-j: a reason"
    assert scan("\n".join(general), filename) == []


@pytest.mark.parametrize("name", sorted(n for n in SNIPPETS if n.startswith(("PW-J002", "PW-J003"))))
def test_device_pass_spares_cold_paths(name):
    """The same code in a cold function (train, restore, grow, ...) is not
    flagged: a transfer there is paid once."""
    _, src, _ = SNIPPETS[name]
    for hot in ("def serve(", "def epoch(", "def upsert(", "def clear("):
        src = src.replace(hot, "def restore_state(")
    assert scan(src) == []


CLEAN = {
    "comprehension_not_a_loop": """
        import torch
        def dispatch(args, devices):
            return [a.to(d) for a, d in zip(args, devices)]
        """,
    "non_blocking_copy": """
        import torch
        def serve(outs, pinned):
            for o, p in zip(outs, pinned):
                p.copy_(o, non_blocking=True)
                o.to("cpu", non_blocking=True)
        """,
    "in_place_update": """
        import torch
        class Index:
            def upsert(self, slots, rows):
                self.slab.index_copy_(0, slots, rows)
                tmp = torch.where(rows > 0, rows, 0.0)
                tmp = tmp.masked_fill(tmp < 0, 0.0)
        """,
    "static_config_branch": """
        import torch.distributed as dist
        def step(x, world):
            if world > 1:
                dist.all_reduce(x)
        """,
    "sync_outside_lock": """
        import torch
        class Index:
            def search(self, q):
                with self._lock:
                    out = self.scores(q)
                return out.cpu()
        """,
    "not_a_lane": """
        import torch
        class ExternalIndexNode:
            def process(self, items):
                return self.adapter.search(items).tolist()
        """,
}


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_device_pass_clean_snippets(name):
    assert scan(CLEAN[name], "pathway_tpu_torch/engine/external_index.py") == []


def test_device_pass_registered_and_port_scans_clean():
    """``check_device`` is the last of ``ALL_PASSES``; the device surface
    and every other module of the port hold no unwaived error, and the
    surface no unwaived finding at all; ``device_profile`` serves the
    monitoring join."""
    from pathway_tpu_torch.analysis.passes import ALL_PASSES

    assert ALL_PASSES[-1] is dev.check_device
    files = dev.device_module_files()
    rel = {os.path.relpath(f, REPO / "pathway_tpu_torch").replace(os.sep, "/") for f in files}
    assert {"train.py", "engine/external_index.py", "stdlib/indexing/segments.py", "io/http/__init__.py",
            "parallel/sharded_knn.py", "ops/ring_attention.py", "models/encoder.py",
            "kernels/knn_topk.py"} <= rel
    profile = dev.device_profile(refresh=True)
    assert profile == {"files_scanned": len(files), "findings": 0, "errors": 0, "by_code": {},
                       "predicted_recompile_sites": 0}
    everything = dev.scan_paths(sorted(str(p) for p in (REPO / "pathway_tpu_torch").rglob("*.py")))
    assert everything.errors == 0, [d.format() for d in everything.diagnostics]
    import pathway_tpu_torch.internals.device_counters  # noqa: F401  (the join reads it)
    from pathway_tpu_torch.internals.monitoring import device_stats

    assert device_stats()["static"] == profile


def test_check_device_attributes_findings_to_the_index_node(tmp_path, monkeypatch):
    """A ``DataIndex`` graph's index node pulls in the device surface: a
    finding in it is reported against that node."""
    hot = tmp_path / "hot.py"
    hot.write_text(textwrap.dedent(SNIPPETS["PW-J002_readback"][1]))
    monkeypatch.setattr(dev, "device_module_files", lambda: [str(hot)])
    m002_device(tpw, tmp_path)
    index_nodes = [n for n in tpw.G.engine_graph.nodes if getattr(n, "adapter", None) is not None]
    assert len(index_nodes) == 1
    diags = [d for d in tpw.analyze() if d.code.startswith("PW-J")]
    assert [(d.code, d.node_id, d.node_name) for d in diags] == [
        ("PW-J002", index_nodes[0].id, type(index_nodes[0]).__name__)]
    tpw.G.clear()
    clean(tpw, tmp_path)  # a host-only graph scans nothing
    assert not [d for d in tpw.analyze() if d.code.startswith("PW-J")]


# ---------------------------------------------------------------------------
# isolation


def test_analysis_imports_no_jax(tmp_path):
    """With ``jax`` and ``pathway_tpu`` blocked, the port's analyzer
    imports, analyses, explains, estimates and runs a graph."""
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "pathway_tpu", "flax"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import pathway_tpu_torch as pw
        import pathway_tpu_torch.analysis as analysis

        t = pw.debug.table_from_rows(pw.schema_from_types(word=str, n=int), [("a", 1), ("b", 2), ("a", 3)])
        agg = t.groupby(t.word).reduce(t.word, s=pw.reducers.sum(t.n))
        out = []
        pw.io.subscribe(agg, on_change=lambda key, row, time, is_addition: out.append(row))
        diags = pw.analyze()
        assert not [d for d in diags if d.severity == "error"], diags
        assert "columnar" in pw.explain().format()
        assert pw.estimate_memory().total_bytes > 0
        pw.run(strict=True, monitoring_level=pw.MonitoringLevel.NONE)
        assert sorted((r["word"], r["s"]) for r in out) == [("a", 4), ("b", 2)]
        assert analysis.device_profile()["errors"] == 0
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pathway_tpu", "flax")]
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
