"""The port's run loop and file, Python and subscribe connectors
(``pathway_tpu_torch.run`` and ``pathway_tpu_torch.io``) against the JAX
package's, on the CPU.

Each pipeline is written once, as a function of the package module
(``build(pw, ...)``), and runs through ``pathway_tpu`` and through
``pathway_tpu_torch`` with ``pw.run``: the counterparts of the README's
jsonlines word count and of ``tests/test_io_roundtrips.py`` and
``tests/test_io.py``'s file and Python cases.  The data are made from a
seed with numpy.  What is compared is what a user reads: output files'
records (``time`` and ``diff`` included), the rows a table ends with
(keys are not compared: a Python subject keys rows by its own ``id``), and
a streaming directory's state after files are added, rewritten and
deleted.  Also: the free tier's worker cap, and the parts of ``pw.run``
that come with ROADMAP item 16 (``strict``, persistence, the monitoring
server), which raise.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

WORDS = ["apple", "pear", "plum", "fig", "kiwi", "lime", "date"]
_rng = np.random.default_rng(20)
DOC_WORDS = [str(w) for w in _rng.choice(WORDS, 60)]
DEADLINE_S = 20.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_port_graph():
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


def run(pw) -> None:
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)


def final_rows(pw, table) -> collections.Counter:
    """The rows ``table`` ends with after ``pw.run``, through
    ``pw.io.subscribe`` (a multiset of value tuples, keys dropped)."""
    count: collections.Counter = collections.Counter()
    cols = table.column_names()

    def on_change(key, row, time, is_addition):
        count[(key, tuple(row[c] for c in cols))] += 1 if is_addition else -1

    pw.io.subscribe(table, on_change=on_change)
    run(pw)
    out: collections.Counter = collections.Counter()
    for (_key, row), n in count.items():
        assert n in (0, 1), (row, n)
        if n:
            out[row] += 1
    return out


def both(build, *args) -> tuple:
    """``build(pw, *args)`` through the JAX package, then the port."""
    want = build(jpw, *args)
    tpw.G.clear()
    got = build(tpw, *args)
    return want, got


def records(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# pw.run over the file connectors, written once


def wordcount(pw, tmp_path):
    """The README's quick start: a jsonlines directory -> groupby count ->
    jsonlines out."""
    src = tmp_path / f"docs_{pw.__name__}"
    src.mkdir()
    for part in range(3):
        with open(src / f"part{part}.jsonl", "w") as f:
            for w in DOC_WORDS[part::3]:
                f.write(json.dumps({"text": w}) + "\n")

    class Doc(pw.Schema):
        text: str

    docs = pw.io.jsonlines.read(str(src), schema=Doc, mode="static")
    counts = docs.groupby(docs.text).reduce(docs.text, n=pw.reducers.count())
    out = tmp_path / f"counts_{pw.__name__}.jsonl"
    pw.io.jsonlines.write(counts, str(out))
    run(pw)
    return records(out)


def check_wordcount_stream(recs: list[dict]) -> None:
    """One package's word-count stream against the input's oracle: every
    retraction removes a row inserted at an earlier time; the consolidated
    stream is ``Counter(DOC_WORDS)``; and the table at each time is the word
    count of a prefix of each input file (the lines of a file are read in
    order), the prefixes growing with time.  Where the autocommit cuts the
    static read into epochs is up to the host's load, so the times are not
    compared across packages."""
    parts = [DOC_WORDS[part::3] for part in range(3)]
    prefix_counts = {
        (a, b, c): collections.Counter(parts[0][:a] + parts[1][:b] + parts[2][:c])
        for a in range(len(parts[0]) + 1) for b in range(len(parts[1]) + 1) for c in range(len(parts[2]) + 1)
    }
    table: collections.Counter = collections.Counter()
    reachable = {(0, 0, 0)}
    for t in sorted({r["time"] for r in recs}):
        batch = [r for r in recs if r["time"] == t]
        for r in batch:
            assert r["diff"] in (1, -1), r
            if r["diff"] == -1:
                assert table[(r["text"], r["n"])] == 1, f"retraction of a row not inserted before it: {r}"
        for r in batch:
            table[(r["text"], r["n"])] += r["diff"]
        assert set(table.values()) <= {0, 1}, table
        snapshot = collections.Counter({text: n for (text, n), live in table.items() if live})
        feasible = {p for p, count in prefix_counts.items() if count == snapshot}
        reachable = {p for p in feasible if any(all(x >= y for x, y in zip(p, r)) for r in reachable)}
        assert reachable, f"time {t}: {dict(snapshot)} is not the count of input prefixes read in order"
    final = {text: n for (text, n), live in table.items() if live}
    assert final == dict(collections.Counter(DOC_WORDS))


def test_readme_wordcount_through_pw_run(tmp_path):
    want, got = both(wordcount, tmp_path)
    check_wordcount_stream(want)
    check_wordcount_stream(got)


ROWS = [
    (1, 2.5, True, "plain"),
    (2, -0.0, False, 'quotes "inside" and, commas'),
    (3, 1e300, True, "unicode: ünïcødé ✓"),
    (4, 2.0, False, ""),  # float that LOOKS like an int
]


def jsonlines_roundtrip(pw, tmp_path):
    t = pw.debug.table_from_rows(pw.schema_from_types(i=int, f=float, b=bool, s=str), ROWS)
    out = tmp_path / f"data_{pw.__name__}.jsonl"
    pw.io.jsonlines.write(t, str(out))
    run(pw)
    written = records(out)
    pw.G.clear()

    class S(pw.Schema):
        i: int
        f: float
        b: bool
        s: str

    back = pw.io.jsonlines.read(str(out), schema=S, mode="static")
    got = final_rows(pw, back.select(back.i, back.f, back.b, back.s))
    return written, sorted(got.elements()), [tuple(type(v) for v in r) for r in sorted(got.elements())]


def test_jsonlines_roundtrip_type_fidelity(tmp_path):
    want, got = both(jsonlines_roundtrip, tmp_path)
    key = lambda r: r["i"]  # noqa: E731
    assert sorted(got[0], key=key) == sorted(want[0], key=key)
    assert got[1] == want[1] == sorted(ROWS)
    assert got[2] == want[2] == [(int, float, bool, str)] * len(ROWS)


def csv_roundtrip(pw, tmp_path):
    rows = [(1, "plain"), (2, "has,comma"), (3, 'has "quotes"'), (4, "multi word value")]
    t = pw.debug.table_from_rows(pw.schema_from_types(k=int, s=str), rows)
    out = tmp_path / f"data_{pw.__name__}.csv"
    pw.io.csv.write(t, str(out))
    run(pw)
    text = sorted(open(out).read().splitlines())
    pw.G.clear()

    class S(pw.Schema):
        k: int
        s: str

    back = pw.io.csv.read(str(out), schema=S, mode="static")
    return text, sorted(final_rows(pw, back.select(back.k, back.s)).elements())


def test_csv_roundtrip_with_quoting(tmp_path):
    want, got = both(csv_roundtrip, tmp_path)
    assert got == want
    assert got[1] == [(1, "plain"), (2, "has,comma"), (3, 'has "quotes"'), (4, "multi word value")]


def stream_out(pw, tmp_path):
    t = pw.debug.table_from_markdown(
        """
    v | __time__ | __diff__
    1 | 2        | 1
    2 | 2        | 1
    1 | 4        | -1
    """
    )
    out = tmp_path / f"stream_{pw.__name__}.jsonl"
    pw.io.jsonlines.write(t, str(out))
    run(pw)
    return records(out)


def test_jsonlines_output_carries_time_and_diff(tmp_path):
    want, got = both(stream_out, tmp_path)
    key = lambda r: (r["time"], r["diff"], r["v"])  # noqa: E731
    assert sorted(got, key=key) == sorted(want, key=key)
    dels = [r for r in got if r["diff"] == -1]
    add_t = next(r["time"] for r in got if r["diff"] == 1 and r["v"] == 1)
    assert [r["v"] for r in dels] == [1] and dels[0]["time"] > add_t


def malformed_and_nulls(pw, tmp_path):
    p = tmp_path / f"mixed_{pw.__name__}.jsonl"
    p.write_text('{"a": 1, "b": "x"}\nthis is not json\n{"a": 2}\n{"a": }\n{"a": 3, "b": null}\n')

    class S(pw.Schema):
        a: int
        b: str | None

    t = pw.io.jsonlines.read(str(p), schema=S, mode="static")
    return sorted(final_rows(pw, t.select(t.a, t.b)).elements())


def test_jsonlines_skips_malformed_lines_and_fills_nulls(tmp_path):
    want, got = both(malformed_and_nulls, tmp_path)
    assert got == want == [(1, "x"), (2, None), (3, None)]


# ---------------------------------------------------------------------------
# Python subjects and subscribe


def python_subjects(pw):
    class Counter(pw.io.python.ConnectorSubject):
        def run(self):
            for v in _rng_values:
                self.next(a=int(v))
            self.commit()
            self.next(a=1000)
            self.commit()

    class Upserts(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(k="a", v=1)
            self.commit()
            self.next(k="a", v=5)  # overwrite by primary key
            self.next(k="b", v=2)
            self.commit()
            self.next_json({"k": "c", "v": 7})
            self.commit()

    class S(pw.Schema):
        a: int

    class KV(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    t = pw.io.python.read(Counter(), schema=S)
    total = t.reduce(s=pw.reducers.sum(t.a), n=pw.reducers.count())
    kv = pw.io.python.read(Upserts(), schema=KV)
    events: list = []
    ends: list = []
    pw.io.subscribe(kv, on_change=lambda key, row, time, add: events.append((row["k"], row["v"], add)),
                    on_end=lambda: ends.append(True))
    rows = final_rows(pw, total)
    pw.G.clear()
    kv_rows = final_rows(pw, pw.io.python.read(Upserts(), schema=KV))
    return rows, kv_rows, sorted(events), ends


_rng_values = np.random.default_rng(21).integers(0, 100, 50)


def test_python_subjects_and_subscribe():
    want, got = both(python_subjects)
    assert got == want
    rows, kv_rows, events, ends = got
    assert rows == collections.Counter({(int(_rng_values.sum()) + 1000, 51): 1})
    assert kv_rows == collections.Counter({("a", 5): 1, ("b", 2): 1, ("c", 7): 1})
    assert ("a", 1, False) in events and ends == [True]


# ---------------------------------------------------------------------------
# pw.io.fs.read, static and streaming


def fs_static(pw, src):
    def binary():
        t = pw.io.fs.read(str(src), format="binary", mode="static", with_metadata=True)
        return t.select(t.data, path=pw.apply(lambda m: m["path"], t["_metadata"]),
                        modified_at=pw.apply(lambda m: m["modified_at"], t["_metadata"]))

    out = []
    for table in (
        binary,
        lambda: pw.io.fs.read(str(src), format="plaintext_by_file", mode="static"),
        lambda: pw.io.plaintext.read(str(src), mode="static"),
    ):
        out.append(sorted(final_rows(pw, table()).elements()))
        pw.G.clear()
    return out


def write_docs(src, names, salt=""):
    for i, name in enumerate(names):
        words = np.random.default_rng(zlib.crc32(f"{name}/{salt}".encode())).choice(WORDS, 4 + i % 3)
        (src / name).write_text(f"{' '.join(words)} {salt}\n{name}\n")


def test_fs_read_static(tmp_path):
    src = tmp_path / "docs"
    src.mkdir()
    write_docs(src, [f"d{i}.txt" for i in range(6)])
    want, got = both(fs_static, src)
    assert got == want
    assert len(got[0]) == len(got[1]) == 6 and len(got[2]) == 12
    assert all(isinstance(r[0], bytes) and r[1].startswith(str(src)) for r in got[0])


def fs_streaming(pw, src):
    """A watched directory: two files, then one added, one rewritten and
    one deleted while the run is live; the state after each step."""
    write_docs(src, ["a.txt", "b.txt"])
    docs = pw.io.fs.read(str(src), format="binary", mode="streaming", with_metadata=True)
    lock = threading.Lock()
    state: collections.Counter = collections.Counter()

    def on_change(key, row, time, is_addition):
        with lock:
            state[(os.path.basename(row["_metadata"]["path"]), row["data"])] += 1 if is_addition else -1

    def current() -> dict:
        with lock:
            return {p: d for (p, d), n in state.items() if n > 0}

    def files() -> dict:
        return {p: (src / p).read_bytes() for p in sorted(os.listdir(src))}

    pw.io.subscribe(docs, on_change=on_change)
    pw.G.active_scheduler = None
    thread = threading.Thread(target=run, args=(pw,), daemon=True)
    thread.start()
    seen = []
    try:
        for step in range(2):
            deadline = time.monotonic() + DEADLINE_S
            while current() != files() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert current() == files(), (step, current(), files())
            seen.append(current())
            if step == 0:
                write_docs(src, ["c.txt"])
                write_docs(src, ["a.txt"], salt="rewritten")
                os.remove(src / "b.txt")
    finally:
        deadline = time.monotonic() + DEADLINE_S
        while getattr(pw.G, "active_scheduler", None) is None and time.monotonic() < deadline:
            time.sleep(0.02)
        pw.G.active_scheduler.stop()
        thread.join(timeout=DEADLINE_S)
    assert not thread.is_alive()
    with lock:
        assert all(n in (0, 1) for n in state.values())
    return seen


def test_fs_streaming_add_rewrite_delete(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = fs_streaming(jpw, tmp_path / "jax")
    tpw.G.clear()
    got = fs_streaming(tpw, tmp_path / "port")
    assert got == want
    assert sorted(got[1]) == ["a.txt", "c.txt"] and b"rewritten" in got[1]["a.txt"]


def csv_streaming(pw, src):
    p = src / "data.csv"
    p.write_text("k,s\n1,one\n")

    class S(pw.Schema):
        k: int
        s: str

    t = pw.io.csv.read(str(src), schema=S, mode="streaming")
    got: list = []
    pw.io.subscribe(t, on_change=lambda key, row, tm, add: got.append((row["k"], row["s"], add)))
    pw.G.active_scheduler = None
    thread = threading.Thread(target=run, args=(pw,), daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + DEADLINE_S
        while len(got) < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        with open(p, "a") as f:
            f.write("2,two\n")
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        while getattr(pw.G, "active_scheduler", None) is None and time.monotonic() < deadline:
            time.sleep(0.02)
        pw.G.active_scheduler.stop()
        thread.join(timeout=DEADLINE_S)
    assert not thread.is_alive()
    return got


def test_csv_reader_streaming_appends(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = csv_streaming(jpw, tmp_path / "jax")
    tpw.G.clear()
    got = csv_streaming(tpw, tmp_path / "port")
    assert got == want == [(1, "one", True), (2, "two", True)]


# ---------------------------------------------------------------------------
# the free tier's worker cap, and what pw.run leaves to item 16


def capped_groupby(pw):
    t = pw.debug.table_from_rows(pw.schema_from_types(w=str, n=int),
                                 [(w, i) for i, w in enumerate(DOC_WORDS)])
    return final_rows(pw, t.groupby(t.w).reduce(t.w, total=pw.reducers.sum(t.n)))


def test_worker_cap_over_the_free_tier(monkeypatch, caplog):
    """``PATHWAY_THREADS`` above the free tier's cap runs with the cap's
    thread count, warns, and gives the one-worker result."""
    from pathway_tpu.internals import license as jlic
    from pathway_tpu_torch.internals import license as tlic

    assert tlic.MAX_WORKERS_FREE == jlic.MAX_WORKERS_FREE
    for pkg, lic in ((jpw, jlic), (tpw, tlic)):
        cfg = pkg.internals.config.pathway_config
        monkeypatch.setattr(cfg, "license_key", None)
        monkeypatch.setattr(cfg, "threads", lic.MAX_WORKERS_FREE * 2)
        lic._cache.clear()
    with caplog.at_level(logging.WARNING):
        want, got = both(capped_groupby)
    assert got == want
    expected = collections.Counter()
    for i, w in enumerate(DOC_WORDS):
        expected[w] += i
    assert got == collections.Counter({(w, n): 1 for w, n in expected.items()})
    for logger in ("pathway_tpu.license", "pathway_tpu_torch.license"):
        msgs = [r.getMessage() for r in caplog.records if r.name == logger]
        assert any(f"free tier caps workers at {tlic.MAX_WORKERS_FREE}: running "
                   f"{tlic.MAX_WORKERS_FREE} threads" in m for m in msgs), (logger, msgs)


@pytest.mark.parametrize(
    "kwargs, env, what",
    [
        ({"strict": True}, {}, None),
        ({}, {"PATHWAY_STRICT": "1"}, None),
        ({"persistence_config": "filesystem"}, {}, "persistence"),
        ({"with_http_server": True}, {}, "monitoring server"),
        ({}, {"monitoring_http_port": 9}, "monitoring server"),
    ],
    ids=["strict", "strict_env", "persistence", "http_server", "monitoring_port"],
)
def test_run_raises_for_what_item_16_brings(monkeypatch, tmp_path, kwargs, env, what):
    """Strict mode came with 16a: it refuses a graph with an error
    finding (a join of an int key with a str key, PW-T001) before any
    source starts, and runs a clean one.  The monitoring server came with
    16b: ``with_http_server=True`` or a configured monitoring port runs,
    serves on ``PATHWAY_MONITORING_HTTP_PORT`` and stops with the run.
    Persistence came with 16c: ``persistence_config=`` runs, and a second
    run over the same storage and the same file delivers no row twice."""
    import socket

    t = tpw.debug.table_from_rows(tpw.schema_from_types(a=int), [(1,)])
    ran = []
    tpw.io.subscribe(t, on_change=lambda *a: ran.append(a))
    for name, value in env.items():
        if name.isupper():
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.setattr(tpw.internals.config.pathway_config, name, value)
    if what == "monitoring server":
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
        monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)
        tpw.G.active_scheduler = None
        tpw.run(monitoring_level=tpw.MonitoringLevel.NONE, **kwargs)
        assert len(ran) == 1
        server = tpw.G.active_scheduler._monitoring_server
        assert server.server_address[1] == port
        with pytest.raises(OSError):  # stopped with the run
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
        return
    if what == "persistence":
        from pathway_tpu_torch.persistence import Backend, Config

        (tmp_path / "w.jsonl").write_text("\n".join(json.dumps({"word": w}) for w in DOC_WORDS))
        for run in (tpw.run, tpw.run_all):
            tpw.G.clear()
            src = tpw.io.jsonlines.read(str(tmp_path / "w.jsonl"), schema=tpw.schema_from_types(word=str),
                                        mode="static")
            tpw.io.subscribe(src, on_change=lambda key, row, time, is_addition: ran.append(row["word"]))
            run(monitoring_level=tpw.MonitoringLevel.NONE, persistence_config=Config.simple_config(
                Backend.filesystem(tmp_path / "snap"), persistence_mode=tpw.PersistenceMode.OPERATOR_PERSISTING))
        assert ran == list(DOC_WORDS)  # the file once: the resumed run restores and delivers nothing again
        return
    s = tpw.debug.table_from_rows(tpw.schema_from_types(b=str), [("1",)])
    tpw.io.subscribe(t.join(s, t.a == s.b).select(t.a), on_change=lambda *a: ran.append(a))
    for run in (tpw.run, tpw.run_all):
        with pytest.raises(tpw.AnalysisError, match="PW-T001"):
            run(**kwargs)
    assert ran == []  # refused before any source started
    tpw.G.clear()
    t = tpw.debug.table_from_rows(tpw.schema_from_types(a=int), [(1,)])
    tpw.io.subscribe(t, on_change=lambda key, row, time, is_addition: ran.append(row))
    tpw.run(monitoring_level=tpw.MonitoringLevel.NONE, **kwargs)
    assert ran == [{"a": 1}]


def test_io_names():
    """The ported connectors resolve lazily, the others name item 16 and
    slice 16g."""
    import pathway_tpu_torch.io as tio

    for name in tio._SUBMODULES:
        assert getattr(tio, name).__name__ == f"pathway_tpu_torch.io.{name}"
    assert set(tio._SUBMODULES) | set(tio._LATER) == set(jpw.io._SUBMODULES)
    assert not set(tio._SUBMODULES) & set(tio._LATER)
    for name in tio._LATER:
        with pytest.raises(AttributeError, match="item 16 \\(slice 16g"):
            getattr(tio, name)
    assert tpw.io.subscribe is tio.subscribe
