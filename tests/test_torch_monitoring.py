"""The port's monitoring server (``pathway_tpu_torch/internals/
monitoring_server.py``) against the JAX package's, on the CPU, and
``pw.run(with_http_server=True)``.

One live pipeline is built in each package (a Python connector that
holds the run open, a groupby, a ``DataIndex`` query, an SLO-scheduled
co-scheduler over a two-shard ``PartitionedIndex`` with one failover) and
run by ``pw.run(with_http_server=True)`` on a free
``PATHWAY_MONITORING_HTTP_PORT``.  While the run is live both servers
are scraped: ``/metrics`` has the same metric names, ``/status`` the
same keys section by section, ``/debug/stacks`` and ``/debug/trace``
answer, and the serving latency series carry ``tenant_class``.  The
port's server stops with its run.  A subprocess with ``jax`` and
``pathway_tpu`` blocked imports the serving layer and the monitoring
server, serves a query and a scrape.
"""

from __future__ import annotations

import gc
import json
import os
import re
import socket
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from tests.test_torch_serving import package

REPO = Path(__file__).resolve().parent.parent
D = 16
DEADLINE_S = 30.0
DOCS = [(f"doc{i}", " ".join(f"w{(i * 7 + j) % 23}" for j in range(6))) for i in range(24)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_port_graph():
    tpw.G.clear()
    yield
    tpw.G.clear()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def get(port: int, path: str) -> bytes:
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read()


def serving_objects(p) -> dict:
    """Live serving components of package ``p``: an admission controller
    that admitted and shed, a co-scheduler that answered both classes over
    a partitioned index, one shard killed and restored."""
    s = p.serving
    ac = s.AdmissionController({"alice": s.TenantPolicy("interactive", rate_per_s=1000.0, burst=10),
                                "bob": s.TenantPolicy("batch", rate_per_s=1.0, burst=1)}, clock=lambda: 0.0)
    held = [ac.admit("alice"), ac.admit("bob")]
    with pytest.raises(p.RetryLater):
        ac.admit("bob")
    emb = s.HashingEmbedder(D)
    part = s.PartitionedIndex(lambda: p.seg(p.knn(D, capacity=256), delta_cap=8, auto_merge=False), n_shards=2,
                              snapshot_every=8)
    part.add([(doc_id, emb(text)) for doc_id, text in DOCS])
    co = s.StageCoScheduler(embedder=emb, index=part, k=3, probe=s.serving_probe())
    answers = [co.submit("w1 w2", "interactive").result(timeout=DEADLINE_S),
               co.submit("w3 w4", "batch").result(timeout=DEADLINE_S)]
    part.fail_shard(1)
    answers.append(co.submit("w5", "interactive").result(timeout=DEADLINE_S))
    part.recover_shard(1)
    assert [a["partial"] for a in answers] == [False, False, True]
    return {"ac": ac, "held": held, "part": part, "co": co}


def close_serving(objs: dict) -> None:
    for t in objs["held"]:
        t.release()
    objs["co"].close()
    objs["co"].scheduler.close()
    objs["part"].close()


def live_pipeline(pw, p, go: threading.Event, fed: threading.Event) -> None:
    """A Python connector that feeds ``DOCS``, commits, and holds the run
    open until ``go``; a groupby and a ``DataIndex`` query over it."""

    class DocSchema(pw.Schema):
        doc_id: str = pw.column_definition(primary_key=True)
        text: str

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for doc_id, text in DOCS:
                self.next(doc_id=doc_id, text=text)
            self.commit()
            go.wait(DEADLINE_S)

    emb = p.serving.HashingEmbedder(D)
    docs = pw.io.python.read(Feed(), schema=DocSchema, name="monitored_docs")
    vecs = docs.select(docs.doc_id, first=pw.apply(lambda t: t.split()[0], docs.text),
                       vec=pw.apply(lambda t: tuple(float(x) for x in emb(t)), docs.text))
    counts = vecs.groupby(vecs.first).reduce(vecs.first, n=pw.reducers.count())
    seen: list = []

    def on_count(key, row, time, is_addition):
        seen.append(row)
        if sum(1 for r in seen) >= len({t.split()[0] for _, t in DOCS}):
            fed.set()

    pw.io.subscribe(counts, on_change=on_count)
    queries = pw.debug.table_from_rows(pw.schema_from_types(qvec=tuple), [(tuple(float(x) for x in emb("w1 w2")),)])
    kw = {"device": "cpu"} if pw is tpw else {}
    index = pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=64, **kw).build_data_index(vecs.vec, vecs)
    pw.io.subscribe(index.query_as_of_now(queries.qvec, number_of_matches=3), on_change=lambda *a: None)


def metric_names(text: str) -> set:
    names = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            names.add(line.split()[2])
        elif line and not line.startswith("#"):
            names.add(re.split(r"[{ ]", line, maxsplit=1)[0])
    return names


def scrape_live_run(name: str, monkeypatch) -> dict:
    """``pw.run(with_http_server=True)`` of package ``name``'s pipeline on
    a thread; every endpoint scraped while the run is live."""
    p = package(name)
    pw = p.pw
    from importlib import import_module

    telemetry = import_module(f"{pw.__name__}.internals.telemetry")
    monkeypatch.setattr(telemetry, "_telemetry", None)  # counters of this run only
    tracing = import_module(f"{pw.__name__}.internals.tracing")
    tracing.configure(PATHWAY_TRACE="1", PATHWAY_TRACE_SAMPLE="1.0")
    port = free_port()
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
    monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)
    gc.collect()  # closed serving components of earlier tests leave the registries
    objs = serving_objects(p)
    go, fed = threading.Event(), threading.Event()
    pw.G.clear()
    pw.G.active_scheduler = None
    live_pipeline(pw, p, go, fed)
    runner = threading.Thread(target=pw.run, kwargs={"with_http_server": True,
                                                     "monitoring_level": pw.MonitoringLevel.NONE}, daemon=True)
    runner.start()
    out: dict = {"port": port}
    try:
        assert fed.wait(DEADLINE_S), "the pipeline did not process its rows"
        sched = pw.G.active_scheduler
        out["server"] = sched._monitoring_server
        now = tracing.now_ns()
        tracing.record_span("monitoring_probe", now - 1_000_000, now, ctx=tracing.new_trace())
        out["metrics"] = get(port, "/metrics").decode()
        out["status"] = json.loads(get(port, "/status"))
        # the registries are process-wide: what this process holds live,
        # beside what the server read from them
        out["snapshot"] = p.serving.serving_snapshot()
        out["stacks"] = get(port, "/debug/stacks").decode()
        out["trace"] = json.loads(get(port, "/debug/trace?seconds=30"))
        out["trace_empty"] = json.loads(get(port, "/debug/trace?seconds=0.0000001"))
        try:
            get(port, "/nothing")
        except urllib.error.HTTPError as e:
            out["missing"] = e.code
        out["alive"] = runner.is_alive()
    finally:
        go.set()
        runner.join(DEADLINE_S)
        close_serving(objs)
        tracing.configure(PATHWAY_TRACE="0")
    out["joined"] = not runner.is_alive()
    return out


@pytest.fixture(scope="module")
def scrapes():
    mp = pytest.MonkeyPatch()
    try:
        out = {name: scrape_live_run(name, mp) for name in ("jax", "port")}
    finally:
        mp.undo()
        jpw.G.clear()
        tpw.G.clear()
    # the JAX package's server outlives its run; the port's stops with it
    server = out["jax"]["server"]
    server.shutdown()
    server.server_close()
    yield out


def test_metrics_names_match_jax(scrapes):
    want, got = metric_names(scrapes["jax"]["metrics"]), metric_names(scrapes["port"]["metrics"])
    assert got == want, (sorted(got - want), sorted(want - got))
    for family in ("pathway_tpu_connector_rows_total", "pathway_tpu_operator_rows_in_total",
                   "pathway_tpu_serving_admitted_total", "pathway_tpu_serving_shed_total",
                   "pathway_tpu_shards_healthy", "pathway_tpu_failover_seconds", "pathway_tpu_index_size",
                   "pathway_tpu_h2d_bytes_total", "pathway_tpu_plan_level", "pathway_tpu_analysis_findings"):
        assert family in got, family
    assert scrapes["port"]["metrics"].endswith("# EOF\n")


def test_status_keys_match_jax_section_by_section(scrapes):
    want, got = scrapes["jax"]["status"], scrapes["port"]["status"]
    assert got.keys() == want.keys()
    for section, value in want.items():
        if isinstance(value, dict):
            assert got[section].keys() == value.keys(), section
    for sub in ("admission", "failover"):
        assert got["serving"][sub].keys() == want["serving"][sub].keys(), sub
    # the JAX counters add XLA's compile count and its listener's flag; the
    # port compiles nothing (``/metrics`` reads its jit_compiles_total as 0)
    assert set(got["device"]["counters"]) == set(want["device"]["counters"]) - {"listener_installed", "jit_compiles"}
    assert got["device"]["static"].keys() == want["device"]["static"].keys()
    for name in ("jax", "port"):
        status, snap = scrapes[name]["status"], scrapes[name]["snapshot"]
        adm, fo = status["serving"]["admission"], snap["failover"]
        assert adm["admitted_total"] == snap["admission"]["admitted_total"], name
        assert adm["shed_total"] == snap["admission"]["shed_total"], name
        # this test's controller admitted one of each class and shed one batch request
        assert adm["admitted_total"]["interactive"] >= 1 and adm["admitted_total"]["batch"] >= 1, name
        assert adm["shed_total"]["batch"] >= 1, name
        assert status["degraded"] == {
            "active": fo["shards_healthy"] < fo["shards_total"], "shards_healthy": fo["shards_healthy"],
            "shards_total": fo["shards_total"], "degraded_responses_total": fo["degraded_responses_total"],
            "failovers_total": fo["failovers_total"]}, name
        assert fo["shards_total"] >= 2 and fo["degraded_responses_total"] >= 1 and fo["failovers_total"] >= 1
    assert got["device"]["static"]["errors"] == 0


def test_debug_endpoints_answer(scrapes):
    for name in ("jax", "port"):
        s = scrapes[name]
        assert "--- Thread" in s["stacks"] and "pw_monitoring" in s["stacks"], name
        assert "monitoring_probe" in [e["name"] for e in s["trace"]["traceEvents"]], name
        assert "monitoring_probe" not in [e["name"] for e in s["trace_empty"]["traceEvents"]], name
        assert s["missing"] == 404 and s["alive"] and s["joined"], name


def test_serving_latency_series_carry_tenant_class(scrapes):
    text = scrapes["port"]["metrics"]
    for stage in ("serve_embed", "serve_retrieve", "serve_generate", "serve_e2e", "serve_sched"):
        for cls in ("interactive", "batch"):
            assert (f'pathway_tpu_stage_latency_ms{{stage="{stage}",tenant_class="{cls}",quantile="p99"}}'
                    in text), (stage, cls)
            m = re.search(rf'pathway_tpu_stage_latency_ms_count\{{stage="{stage}",tenant_class="{cls}"\}} (\d+)',
                          text)
            assert m is not None and int(m.group(1)) >= 1, (stage, cls)
    # the engine's own stage series stay label-free
    assert re.search(r'pathway_tpu_stage_latency_ms\{stage="[^"]+",quantile="p50"\}', text)
    shed = scrapes["port"]["snapshot"]["admission"]["shed_total"]["batch"]
    assert shed >= 1 and f'pathway_tpu_serving_shed_total{{tenant_class="batch"}} {shed}' in text


def test_the_port_server_stops_with_its_run(scrapes):
    port = scrapes["port"]["port"]
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    assert scrapes["port"]["server"].server_address[1] == port


def test_metrics_companions_match_jax_on_known_samples():
    """Known samples into the serving probe: the same ``_count`` / ``_sum``
    companion lines in both packages' ``/metrics`` text."""
    lines = {}
    for name in ("jax", "port"):
        p = package(name)
        pw = p.pw
        from importlib import import_module

        ms = import_module(f"{pw.__name__}.internals.monitoring_server")
        sched_mod = import_module(f"{pw.__name__}.engine.scheduler")
        probe = p.serving.serving_probe()
        base = probe.snapshot().get("serve_known", {}).get("interactive", {}).get("count", 0)
        probe.record("serve_known", "interactive", 5_000_000)
        probe.record("serve_known", "interactive", 7_000_000)
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
        pw.io.subscribe(t, on_change=lambda *a: None)
        sched = sched_mod.Scheduler(pw.G.engine_graph, autocommit_ms=20)
        text = ms._metrics_text(sched)
        pw.G.clear()
        m = re.search(r'pathway_tpu_stage_latency_ms_count\{stage="serve_known",tenant_class="interactive"\} (\d+)',
                      text)
        assert m is not None and int(m.group(1)) == base + 2
        lines[name] = sorted(line for line in text.splitlines() if "serve_known" in line and "_count" in line)
    assert lines["port"] == lines["jax"]


def test_persistence_still_raises_naming_16c():
    t = tpw.debug.table_from_rows(tpw.schema_from_types(a=int), [(1,)])
    tpw.io.subscribe(t, on_change=lambda *a: None)
    with pytest.raises(NotImplementedError, match="16c"):
        tpw.run(persistence_config=object())


def test_serving_and_monitoring_import_no_jax():
    """With ``jax`` and ``pathway_tpu`` blocked, the serving layer and the
    monitoring server import, a ``RagServingApp`` answers a query over the
    port's slab on the CPU, and ``/metrics`` and ``/status`` serve it."""
    code = textwrap.dedent("""
        import json, socket, sys, urllib.request

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "pathway_tpu", "flax"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import pathway_tpu_torch as pw
        import pathway_tpu_torch.serving as serving
        from pathway_tpu_torch.internals.monitoring_server import start_http_server
        from pathway_tpu_torch.parallel import ShardedKnnIndex
        from pathway_tpu_torch.serving import admission, coscheduler, failover, graph, loadgen, scheduler
        from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex

        app = serving.RagServingApp({"t": serving.TenantPolicy("interactive")},
                                    index=SegmentedIndex(ShardedKnnIndex(64, capacity=256, device="cpu")))
        app.start()
        try:
            app.upsert("a", "solar panels make electricity")
            app.upsert("b", "index merges compact segments")
            assert app.wait_indexed(2, timeout=30)
            r = app.answer("solar electricity", tenant="t")
            s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
            start_http_server(app.sched, port=port)
            metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
            status = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=10).read())
            app.sched._monitoring_server.shutdown()
        finally:
            app.close()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pathway_tpu", "flax"))
        print(json.dumps({"top": r["docs"][0]["id"], "admitted": status["serving"]["admission"]["admitted_total"],
                          "series": 'tenant_class="interactive"' in metrics, "bad": bad}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"top": "a#0", "admitted": {"interactive": 1}, "series": True, "bad": []}
