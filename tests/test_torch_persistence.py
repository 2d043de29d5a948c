"""The port's persistence layer (``pathway_tpu_torch/persistence/``)
against the JAX package's, on the CPU.

Each scenario of ``tests/test_persistence.py`` (but the one that needs
``io.s3``, which a later slice brings)
is written once, as a function of one package's namespace, and runs
through both packages with the same inputs, made from a seed with numpy:
the sinks' consolidated outputs are equal, and so are the counts the JAX
test asserts.  The filesystem log's framing is byte-identical in both
packages.  Logs and snapshots are never exchanged between the packages:
their pickles name each package's own classes.  A ``DataIndex`` over the
flagship tiny encoder runs under OPERATOR_PERSISTING, resumes with more
input and resumes again with none, in both packages; the port's slab and
segmented index round-trip through ``state_dict``, ``pickle`` and
``load_state_dict`` bit for bit.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60.0


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


def package(name: str) -> SimpleNamespace:
    """One package's engine, persistence layer and connector internals."""
    root = "pathway_tpu" if name == "jax" else "pathway_tpu_torch"
    pw = jpw if name == "jax" else tpw
    return SimpleNamespace(
        name=name,
        pw=pw,
        G=pw.G,
        Scheduler=import_module(f"{root}.engine.scheduler").Scheduler,
        persistence=import_module(f"{root}.persistence"),
        conn=import_module(f"{root}.io._connector"),
        keys=import_module(f"{root}.internals.keys"),
        device={} if name == "jax" else {"device": "cpu"},
    )


BOTH = ("jax", "port")


def both(scenario, tmp_path, *args) -> dict:
    """``scenario(p, dir, *args)`` in each package, each in a directory of
    its own: ``{"jax": ..., "port": ...}``."""
    out = {}
    for name in BOTH:
        p = package(name)
        p.G.clear()
        d = tmp_path / name
        d.mkdir()
        try:
            out[name] = scenario(p, d, *args)
        finally:
            p.G.clear()
    return out


def words(n: int, vocab: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"w{i}" for i in rng.integers(0, vocab, n)]


def write_words(path, ws: list[str], mode: str = "w") -> None:
    with open(path, mode) as f:
        if mode == "a":
            f.write("\n")
        f.write("\n".join(json.dumps({"word": w}) for w in ws))


def wordcount(p, input_file, results: dict, changes: list | None = None):
    pw = p.pw

    class WordSchema(pw.Schema):
        word: str

    table = pw.io.jsonlines.read(str(input_file), schema=WordSchema, mode="static")
    counts = table.groupby(table.word).reduce(table.word, n=pw.reducers.count())

    def on_change(key, row, time, is_addition):
        if changes is not None:
            changes.append((row["word"], row["n"], is_addition))
        if is_addition:
            results[row["word"]] = row["n"]
        elif results.get(row["word"]) == row["n"]:
            del results[row["word"]]

    pw.io.subscribe(counts, on_change=on_change)
    return counts


def run_with(p, config, autocommit_ms: int = 10):
    sched = p.Scheduler(p.G.engine_graph, autocommit_ms=autocommit_ms)
    p.persistence.attach_persistence(sched, config)
    sched.run()
    return sched


def fs_config(p, path, mode=None, **kw):
    P = p.persistence
    if mode is not None:
        kw["persistence_mode"] = getattr(P.PersistenceMode, mode)
    return P.Config.simple_config(P.Backend.filesystem(path), **kw)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_persistence.py


def snapshot_resume(p, d):
    first, more = words(40, 5, seed=1), words(9, 7, seed=2)
    write_words(d / "words.jsonl", first)
    r1: dict = {}
    wordcount(p, d / "words.jsonl", r1)
    run_with(p, fs_config(p, d / "snapshots"))
    p.G.clear()
    write_words(d / "words.jsonl", more, "a")
    r2: dict = {}
    wordcount(p, d / "words.jsonl", r2)
    run_with(p, fs_config(p, d / "snapshots"))
    return r1, r2, dict(collections.Counter(first)), dict(collections.Counter(first + more))


def test_snapshot_resume_no_duplicates(tmp_path):
    got = both(snapshot_resume, tmp_path)
    assert got["port"] == got["jax"]
    r1, r2, want1, want2 = got["port"]
    assert r1 == want1 and r2 == want2


def replay_mode(p, d):
    ws = words(30, 4, seed=3)
    write_words(d / "words.jsonl", ws)
    r1: dict = {}
    wordcount(p, d / "words.jsonl", r1)
    run_with(p, fs_config(p, d / "snapshots"))
    os.unlink(d / "words.jsonl")  # replay must not need the source
    p.G.clear()
    r2: dict = {}
    wordcount(p, d / "words.jsonl", r2)
    run_with(p, fs_config(p, d / "snapshots", "SPEEDRUN_REPLAY"))
    return r1, r2, dict(collections.Counter(ws))


def test_replay_mode_reproduces_without_source(tmp_path):
    got = both(replay_mode, tmp_path)
    assert got["port"] == got["jax"]
    r1, r2, want = got["port"]
    assert r1 == r2 == want


def selective(p, d):
    pw = p.pw
    ws = words(12, 3, seed=4)
    write_words(d / "words.jsonl", ws)

    class WordSchema(pw.Schema):
        word: str

    def build(results):
        named = pw.io.jsonlines.read(str(d / "words.jsonl"), schema=WordSchema, mode="static",
                                     persistent_id="words_src")
        anon = pw.io.jsonlines.read(str(d / "words.jsonl"), schema=WordSchema, mode="static")
        both_ = named.concat_reindex(anon)
        counts = both_.groupby(both_.word).reduce(both_.word, n=pw.reducers.count())
        pw.io.subscribe(counts, on_change=lambda key, row, time, add: results.__setitem__(row["word"], row["n"])
                        if add else None)

    out = []
    for _ in range(2):
        p.G.clear()
        results: dict = {}
        build(results)
        run_with(p, fs_config(p, d / "snapshots", "SELECTIVE_PERSISTING"))
        out.append(results)
    logs = sorted(x.name for x in (d / "snapshots").iterdir())
    return out, logs, {w: 2 * n for w, n in collections.Counter(ws).items()}


def test_selective_persisting_only_with_persistent_id(tmp_path):
    got = both(selective, tmp_path)
    assert got["port"] == got["jax"]
    (r1, r2), logs, want = got["port"]
    assert r1 == r2 == want
    assert any("input_pid_words_src" in n for n in logs)
    assert not any("jsonlines" in n for n in logs)


def realtime_replay(p, d):
    pw = p.pw
    ConnectorSubject = import_module(f"{pw.__name__}.io.python").ConnectorSubject

    class WordSchema(pw.Schema):
        word: str

    class SlowSource(ConnectorSubject):
        def run(self):
            self.next(word="x")
            self.commit()
            time.sleep(0.4)  # the recorded gap that realtime replay honours
            self.next(word="y")
            self.commit()

    def build():
        t = pw.io.python.read(SlowSource(), schema=WordSchema)
        return t.groupby(t.word).reduce(t.word, n=pw.reducers.count())._capture_node()

    build()
    run_with(p, fs_config(p, d / "snap"))

    def replay(mode):
        p.G.clear()
        cap = build()
        sched = p.Scheduler(p.G.engine_graph, autocommit_ms=10)
        p.persistence.attach_persistence(sched, fs_config(p, d / "snap", mode))
        t0 = time.monotonic()
        ctx = sched.run()
        return time.monotonic() - t0, sorted(ctx.state(cap)["rows"].values())

    fast_dt, fast_rows = replay("SPEEDRUN_REPLAY")
    slow_dt, slow_rows = replay("REALTIME_REPLAY")
    return fast_dt, slow_dt, fast_rows, slow_rows


def test_realtime_replay_honours_recorded_gaps(tmp_path):
    got = both(realtime_replay, tmp_path)
    for name in BOTH:
        fast_dt, slow_dt, fast_rows, slow_rows = got[name]
        assert fast_rows == slow_rows == [("x", 1), ("y", 1)]
        assert slow_dt >= fast_dt + 0.25, name  # the recorded ~0.4 s gap was honoured
    assert got["port"][2] == got["jax"][2]


@pytest.mark.parametrize("name", BOTH)
def test_memory_backend_roundtrip(name):
    P = package(name).persistence
    ns = f"test_torch_roundtrip_{name}_{os.getpid()}"
    b = P.Backend.memory(namespace=ns)
    b._impl.append("s1", b"one")
    b._impl.append("s1", b"two")
    assert b._impl.read_all("s1") == [b"one", b"two"]
    b._impl.put_meta({"t": 5})
    assert P.Backend.memory(namespace=ns)._impl.get_meta() == {"t": 5}


def torn_tail(p, d):
    b = p.persistence.Backend.filesystem(d / "p")
    b._impl.append("s", b"complete")
    with open(b._impl._stream_path("s"), "ab") as f:
        f.write((100).to_bytes(8, "little"))
        f.write(b"short")
    return b._impl.read_all("s")


def test_fs_backend_torn_write(tmp_path):
    got = both(torn_tail, tmp_path)
    assert got["port"] == got["jax"] == [b"complete"]


def log_framing(p, d, records, torn_keep):
    """The same ``bytes`` records through ``_FsBackend``, a torn last
    append, a truncate and an append after it: the file after each step
    and what ``read_all`` returns."""
    impl = p.persistence.Backend.filesystem(d / "p")._impl
    for i, rec in enumerate(records):
        impl.append("st", rec, durable=i % 2 == 0)
    files = [open(impl._stream_path("st"), "rb").read()]
    with open(impl._stream_path("st"), "ab") as f:  # a crash mid-append
        f.write(len(records[0]).to_bytes(8, "little") + records[0][:torn_keep])
    files.append(open(impl._stream_path("st"), "rb").read())
    read = impl.read_all("st")
    impl.truncate("st", len(read) - 1)
    impl.append("st", b"after")
    files.append(open(impl._stream_path("st"), "rb").read())
    return files, read, impl.read_all("st"), sorted(os.listdir(d / "p"))


def test_fs_log_framing_is_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    records = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in rng.integers(0, 300, 12)]
    records[0] = records[0] or b"x"
    got = both(log_framing, tmp_path, records, 3)
    assert got["port"] == got["jax"]
    files, read, after, _ = got["port"]
    assert read == records
    assert after == records[:-1] + [b"after"]
    assert len(files[1]) == len(files[0]) + 8 + 3


def test_udf_disk_cache(tmp_path):
    def scenario(p, d):
        pw = p.pw
        calls: list = []

        @pw.udf(cache_strategy=pw.udfs.DiskCache(str(d / "cache")))
        def slow(x: int) -> int:
            calls.append(x)
            return x * 2

        xs = [int(v) for v in np.random.default_rng(6).integers(0, 50, 6)]
        outs = []
        for _ in range(2):
            p.G.clear()
            t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(x,) for x in xs])
            keys, cols = pw.debug.table_to_dicts(t.select(y=slow(pw.this.x)))
            outs.append(sorted(cols["y"][k] for k in keys))
        return outs, sorted(calls), sorted(set(xs)), xs

    got = both(scenario, tmp_path)
    assert got["port"] == got["jax"]
    (out1, out2), calls, distinct, xs = got["port"]
    assert out1 == out2 == sorted(2 * x for x in xs)
    assert calls == distinct  # the second run is served from the cache


def uncommitted_tail(p, d):
    ws = words(20, 3, seed=7)
    write_words(d / "words.jsonl", ws)
    r1: dict = {}
    wordcount(p, d / "words.jsonl", r1)
    run_with(p, fs_config(p, d / "snapshots"))
    impl = p.persistence.Backend.filesystem(d / "snapshots")._impl
    streams = [x.stem for x in (d / "snapshots").glob("*.log")]
    assert len(streams) == 1
    committed = len(impl.read_all(streams[0]))
    # a crash mid-epoch: a tail event recorded without a commit
    impl.append(streams[0], pickle.dumps(("add", p.keys.ref_scalar("__crash_tail__"), ("w0",))))
    runs = []
    for _ in range(2):
        p.G.clear()
        r: dict = {}
        wordcount(p, d / "words.jsonl", r)
        run_with(p, fs_config(p, d / "snapshots"))
        runs.append(r)
    return r1, runs, committed, len(impl.read_all(streams[0])), dict(collections.Counter(ws))


def test_uncommitted_tail_truncated_on_resume(tmp_path):
    got = both(uncommitted_tail, tmp_path)
    assert got["port"] == got["jax"]
    r1, runs, committed, after, want = got["port"]
    assert r1 == runs[0] == runs[1] == want
    assert after == committed  # the stale tail is gone from the log


def nondeterministic(p, d):
    pw = p.pw
    conn = p.conn

    class WordSchema(pw.Schema):
        word: str

    class OneShotSource(conn.RowSource):
        deterministic_replay = False  # emits its rows once: a live feed

        def __init__(self, rows):
            self.rows = rows
            self.resumed_from = None

        def on_persistence_resume(self, n):
            self.resumed_from = n

        def run(self, events):
            for w in self.rows:
                events.add(conn.key_for_row({"word": w}, None), (w,))
            events.commit()

    def build(rows, results):
        src = OneShotSource(rows)
        table = conn.input_table(src, WordSchema, name="oneshot")
        counts = table.groupby(table.word).reduce(table.word, n=pw.reducers.count())
        pw.io.subscribe(counts, on_change=lambda key, row, time, add: results.__setitem__(row["word"], row["n"])
                        if add else None)
        return src

    first, later = words(7, 3, seed=8), words(4, 4, seed=9)
    r1: dict = {}
    build(first, r1)
    run_with(p, fs_config(p, d / "snapshots"))
    p.G.clear()
    r2: dict = {}
    src2 = build(later, r2)
    run_with(p, fs_config(p, d / "snapshots"))
    return r1, r2, src2.resumed_from, dict(collections.Counter(first)), dict(collections.Counter(first + later))


def test_nondeterministic_source_replays_committed_history(tmp_path):
    """The committed history of a source that cannot re-emit it comes
    back from the log; the replay advances the autogen key counter, so
    the new rows' keys never collide with the replayed ones."""
    got = both(nondeterministic, tmp_path)
    assert got["port"] == got["jax"]
    r1, r2, resumed, want1, want2 = got["port"]
    assert r1 == want1 and r2 == want2 and resumed == 7


def async_transformer(p, d):
    pw = p.pw
    conn = p.conn

    class OutSchema(pw.Schema):
        ret: int

    class Doubler(pw.AsyncTransformer):
        output_schema = OutSchema

        async def invoke(self, value: int) -> dict:
            return {"ret": value * 2}

    class InSchema(pw.Schema):
        value: int

    values = [int(v) for v in np.random.default_rng(10).integers(1, 20, 3)]
    out = []
    for _ in range(2):
        p.G.clear()
        r: dict = {}
        src = conn.DictSource(lambda: [{"value": v} for v in values], InSchema, tag="axt")
        transformer = Doubler(conn.input_table(src, InSchema, name="axt_in"))
        totals = transformer.successful.reduce(s=pw.reducers.sum(pw.this.ret))
        pw.io.subscribe(totals, on_change=lambda key, row, time, add: r.__setitem__("s", row["s"]) if add else None)
        run_with(p, fs_config(p, d / "snapshots"))
        out.append(r)
    return out, 2 * sum(values)


def test_async_transformer_results_not_doubled_on_resume(tmp_path):
    got = both(async_transformer, tmp_path)
    assert got["port"] == got["jax"]
    (r1, r2), want = got["port"]
    assert r1 == r2 == {"s": want}  # loopback history must not double


def bounded_replay(p, d):
    first, more = words(30, 4, seed=11), ["w9", "w1"]
    write_words(d / "words.jsonl", first)
    runs = []
    for extra in (None, more, None):
        p.G.clear()
        if extra:
            write_words(d / "words.jsonl", extra, "a")
        changes: list = []
        results: dict = {}
        wordcount(p, d / "words.jsonl", results, changes)
        run_with(p, fs_config(p, d / "snapshots", "OPERATOR_PERSISTING", snapshot_interval_ms=0), autocommit_ms=5)
        runs.append((results, changes))
    return runs, dict(collections.Counter(first)), dict(collections.Counter(first + more))


def test_operator_snapshot_bounded_replay(tmp_path):
    got = both(bounded_replay, tmp_path)
    assert got["port"] == got["jax"]
    ((r1, _), (r2, c2), (_, c3)), want1, want2 = got["port"]
    assert r1 == want1
    assert r2 == {w: want2[w] for w in ("w9", "w1")}  # only updated groups fire
    assert {w for w, _n, _add in c2} == {"w9", "w1"}
    assert c3 == []  # a restart with no new input fires nothing


def op_run(p, d):
    return run_with(p, fs_config(p, d / "snapshots", "OPERATOR_PERSISTING", snapshot_interval_ms=0), autocommit_ms=5)


def join_window(p, d):
    """A join over a tumbling window per key, killed after partial input
    and restarted over the appended rest, then a fresh run over the whole
    input: the restarted and the fresh final states."""
    pw = p.pw
    CaptureNode = import_module(f"{p.pw.__name__}.engine.graph").CaptureNode
    rows1 = [{"k": "x", "t": 1, "v": 10}, {"k": "y", "t": 2, "v": 20}, {"k": "x", "t": 6, "v": 30}]
    rows2 = [{"k": "y", "t": 7, "v": 40}, {"k": "x", "t": 11, "v": 50}]
    (d / "names.jsonl").write_text('{"k": "x", "name": "xray"}\n{"k": "y", "name": "yankee"}')

    class ES(pw.Schema):
        k: str
        t: int
        v: int

    class NS(pw.Schema):
        k: str
        name: str

    def build():
        ev = pw.io.jsonlines.read(str(d / "events.jsonl"), schema=ES, mode="static")
        nm = pw.io.jsonlines.read(str(d / "names.jsonl"), schema=NS, mode="static")
        win = ev.windowby(ev.t, window=pw.temporal.tumbling(duration=5), instance=ev.k).reduce(
            k=pw.this._pw_instance, start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))
        joined = win.join(nm, win.k == nm.k).select(nm.name, win.start, win.s)
        return CaptureNode(p.G.engine_graph, joined._node)

    (d / "events.jsonl").write_text("\n".join(json.dumps(r) for r in rows1))
    build()
    op_run(p, d)
    p.G.clear()
    with open(d / "events.jsonl", "a") as f:
        f.write("\n" + "\n".join(json.dumps(r) for r in rows2))
    cap = build()
    restarted = sorted(op_run(p, d).ctx.state(cap)["rows"].values())
    p.G.clear()
    cap = build()
    fresh_sched = p.Scheduler(p.G.engine_graph, autocommit_ms=5)
    fresh_sched.run()
    return restarted, sorted(fresh_sched.ctx.state(cap)["rows"].values())


def test_operator_snapshot_join_window_equivalence(tmp_path):
    """Kill/restart over a join + tumbling-window pipeline: the restarted
    run's final state equals a fresh full-input run, in both packages."""
    got = both(join_window, tmp_path)
    assert got["port"] == got["jax"]
    restarted, fresh = got["port"]
    assert restarted == fresh and len(fresh) >= 3


def windows_flushed(p, d):
    """A tumbling window's sink over a clean run, then over a restart with
    no new input."""
    pw = p.pw
    (d / "ev.jsonl").write_text('{"t": 1, "v": 10}\n{"t": 2, "v": 20}\n{"t": 7, "v": 30}')

    class ES(pw.Schema):
        t: int
        v: int

    runs = []
    for _ in range(2):
        p.G.clear()
        fired: list = []
        ev = pw.io.jsonlines.read(str(d / "ev.jsonl"), schema=ES, mode="static")
        win = ev.windowby(ev.t, window=pw.temporal.tumbling(duration=5)).reduce(
            start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))
        pw.io.subscribe(win, on_change=lambda k, row, time, add: fired.append((row["start"], row["s"], add)))
        op_run(p, d)
        runs.append(fired)
    return runs


def test_operator_snapshot_windows_not_reflushed(tmp_path):
    """The clean shutdown snapshots after the finalizing flush: a restart
    with no new input re-emits no window, in both packages."""
    got = both(windows_flushed, tmp_path)
    assert got["port"] == got["jax"]
    fired1, fired2 = got["port"]
    assert {(s, v) for s, v, add in fired1 if add} == {(0, 30), (5, 30)}
    assert fired2 == []


class FakeS3Client:
    """boto3-compatible in-memory object store shared across instances."""

    def __init__(self, store=None):
        self.store = store if store is not None else {}
        self.get_calls = 0

    def put_object(self, Bucket, Key, Body):
        self.store[Key] = bytes(Body)

    def get_object(self, Bucket, Key):
        self.get_calls += 1
        if Key not in self.store:
            raise KeyError(Key)
        return {"Body": self.store[Key]}

    def list_objects_v2(self, Bucket, Prefix, **kw):
        return {
            "Contents": [{"Key": k, "Size": len(v)} for k, v in sorted(self.store.items()) if k.startswith(Prefix)],
            "IsTruncated": False,
        }

    def delete_object(self, Bucket, Key):
        self.store.pop(Key, None)


class BucketSettings:
    """What ``_S3Backend`` reads of ``pw.io.s3.AwsS3Settings``."""

    def __init__(self, client):
        self.bucket_name = "bkt"
        self._client = client

    def create_client(self):
        return self._client


def s3_backend(p, store):
    return p.persistence.Backend.s3("pstorage/test", BucketSettings(FakeS3Client(store)))


def s3_resume(p, d):
    first, more = words(15, 3, seed=12), words(5, 4, seed=13)
    write_words(d / "words.jsonl", first)
    store: dict = {}
    out = []
    for extra in (None, more):
        p.G.clear()
        if extra:
            write_words(d / "words.jsonl", extra, "a")
        r: dict = {}
        wordcount(p, d / "words.jsonl", r)
        run_with(p, p.persistence.Config.simple_config(s3_backend(p, store)))
        out.append(r)
    prefixes = sorted({k.rsplit("/", 1)[0] for k in store})
    return out, prefixes, dict(collections.Counter(first)), dict(collections.Counter(first + more))


def test_s3_backend_snapshot_resume(tmp_path):
    got = both(s3_resume, tmp_path)
    assert got["port"] == got["jax"]
    (r1, r2), prefixes, want1, want2 = got["port"]
    assert r1 == want1 and r2 == want2
    assert any(k.startswith("pstorage/test/streams/") for k in prefixes)


@pytest.mark.parametrize("name", BOTH)
def test_s3_backend_stream_truncate_roundtrip(name):
    impl = s3_backend(package(name), {})._impl
    for i in range(5):
        impl.append("st", b"rec%d" % i)
    assert impl.read_all("st") == [b"rec0", b"rec1", b"rec2", b"rec3", b"rec4"]
    impl.truncate("st", 2)
    assert impl.read_all("st") == [b"rec0", b"rec1"]
    impl.append("st", b"new")
    assert impl.read_all("st") == [b"rec0", b"rec1", b"new"]
    impl.put_meta({"n_workers": 2})
    assert impl.get_meta() == {"n_workers": 2}
    impl.put_blob("blb", b"xyz")
    assert impl.get_blob("blb") == b"xyz"


def test_s3_backend_writes_the_same_objects(tmp_path):
    """The same appends, truncate, meta and blob through both packages'
    S3 backends leave the same object store."""
    def scenario(p, d):
        store: dict = {}
        impl = s3_backend(p, store)._impl
        for i in range(4):
            impl.append("a", b"r%d" % i)
        impl.truncate("a", 3)
        impl.put_meta({"n_workers": 1})
        impl.put_blob("opsnap_w0", b"state")
        return store

    got = both(scenario, tmp_path)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("name", BOTH)
def test_cached_object_storage(name):
    P = package(name).persistence
    ns = f"torch_obj_cache_{name}_{os.getpid()}"
    cache = P.CachedObjectStorage(P.Backend.memory(ns))
    assert cache.get("s3://b/k", "v1") is None
    cache.put("s3://b/k", "v1", b"data1")
    assert cache.contains("s3://b/k", "v1") and not cache.contains("s3://b/k", "v2")
    assert cache.get("s3://b/k", "v1") == b"data1"
    cache.put("s3://b/k", "v2", b"data2")
    assert cache.get("s3://b/k", "v1") is None and cache.get("s3://b/k", "v2") == b"data2"
    cache2 = P.CachedObjectStorage(P.Backend.memory(ns))  # a restart
    assert cache2.get("s3://b/k", "v2") == b"data2" and cache2.uris() == ["s3://b/k"]
    cache2.invalidate("s3://b/k")
    assert cache2.get("s3://b/k", "v2") is None


# ---------------------------------------------------------------------------
# pw.run(persistence_config=...), the names, and the gate that went


def test_run_with_persistence_config_resumes_without_duplicates(tmp_path):
    """``pw.run(persistence_config=...)`` and ``pathway_config``'s
    ``persistence_config`` attach the layer in both packages: a second
    run over appended input counts each row once."""
    def scenario(p, d, via_config):
        pw = p.pw
        first, more = words(25, 4, seed=14), words(6, 5, seed=15)
        write_words(d / "words.jsonl", first)
        cfg = pw.internals.config.pathway_config
        out = []
        for extra in (None, more):
            pw.G.clear()
            if extra:
                write_words(d / "words.jsonl", extra, "a")
            r: dict = {}
            wordcount(p, d / "words.jsonl", r)
            conf = fs_config(p, d / "snapshots")
            if via_config:
                saved, cfg.persistence_config = cfg.persistence_config, conf
                try:
                    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
                finally:
                    cfg.persistence_config = saved
            else:
                pw.run(monitoring_level=pw.MonitoringLevel.NONE, persistence_config=conf)
            out.append(r)
        return out, dict(collections.Counter(first)), dict(collections.Counter(first + more))

    for via_config in (False, True):
        sub = tmp_path / str(via_config)
        sub.mkdir()
        got = both(scenario, sub, via_config)
        assert got["port"] == got["jax"]
        (r1, r2), want1, want2 = got["port"]
        assert r1 == want1 and r2 == want2


def test_names_resolve_to_the_ports_modules():
    import pathway_tpu_torch.persistence as tpers
    import pathway_tpu_torch.testing as ttest
    from pathway_tpu_torch.testing import chaos as tchaos_mod

    assert tpw.persistence is tpers and tpw.testing is ttest
    assert tpw.PersistenceMode is tpers.PersistenceMode
    assert tpers.__all__ == jpw.persistence.__all__
    assert [m.value for m in tpers.PersistenceMode] == [m.value for m in jpw.PersistenceMode]
    assert ttest.__all__ == jpw.testing.__all__ == ["ChaosError", "chaos", "flaky_once"]
    drills = import_module("pathway_tpu_torch.testing.chaos")
    assert drills.ClusterDrill.__module__ == drills.IndexDrill.__module__ == "pathway_tpu_torch.testing.chaos"
    assert tchaos_mod is drills.chaos
    assert not ({"persistence", "PersistenceMode", "testing"} & set(tpw._LATER))


# ---------------------------------------------------------------------------
# the device configuration at a tiny width


@pytest.fixture(scope="module")
def tiny_encoder():
    import jax

    import __graft_entry__ as graft
    from pathway_tpu.parallel import JittedEncoder
    from test_torch_encoder import port_config

    jcfg = graft._flagship_config(tiny=True)
    return jcfg, port_config(jcfg), jax.tree.map(np.asarray, JittedEncoder(jcfg).params)


def corpus_lines(n: int, seed: int, prefix: str = "d") -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"doc": f"{prefix}{i}", "text": " ".join(f"t{w}" for w in rng.integers(0, 400, int(rng.integers(3, 12))))}
            for i in range(n)]


def device_pipeline(p, d, tiny, steps):
    """A ``DataIndex`` over ``BruteForceKnn`` (the port's on the CPU) with
    the tiny encoder as the embedding UDF over documents and questions,
    under OPERATOR_PERSISTING; after each step its index size, answers,
    rows embedded and sink rows."""
    pw = p.pw
    jcfg, tcfg, params = tiny
    if p.name == "jax":
        from pathway_tpu.xpacks.llm.embedders import TPUEncoderEmbedder as Embedder

        cfg = jcfg
    else:
        from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder as Embedder

        cfg = tcfg
    out = []
    vecs: dict = {}  # each text embedded in this package, to its vector
    for docs, questions in steps:
        with open(d / "docs.jsonl", "a") as f:
            f.writelines(json.dumps(row) + "\n" for row in docs)
        with open(d / "questions.jsonl", "a") as f:
            f.writelines(json.dumps({"qid": q["doc"], "text": q["text"]}) + "\n" for q in questions)
        p.G.clear()
        embedded = [0]

        class Counting(Embedder):
            def __batch__(self, texts):
                embedded[0] += len(texts)
                got = super().__batch__(texts)
                vecs.update((t, np.asarray(v, np.float64)) for t, v in zip(texts, got))
                return got

        class Doc(pw.Schema):
            doc: str = pw.column_definition(primary_key=True)
            text: str

        class Q(pw.Schema):
            qid: str = pw.column_definition(primary_key=True)
            text: str

        emb = Counting(config=cfg, params=params, max_batch_size=16, **p.device)
        dt = pw.io.jsonlines.read(str(d / "docs.jsonl"), schema=Doc, mode="static")
        dt = dt.select(doc=pw.this.doc, vec=emb(pw.this.text))
        qt = pw.io.jsonlines.read(str(d / "questions.jsonl"), schema=Q, mode="static")
        qt = qt.select(qid=pw.this.qid, qvec=emb(pw.this.text))
        index = pw.indexing.DataIndex(dt, pw.indexing.BruteForceKnn(
            dt.vec, dimensions=cfg.hidden, reserved_space=256, metric="cos", delta_cap=8, **p.device))
        reply = index.query(qt.qvec, number_of_matches=4)
        rows: list = []
        pw.io.subscribe(reply, on_change=lambda key, row, time, add: rows.append(
            (row["qid"], [x["doc"] for x in row["_pw_index_reply"]], list(row["_pw_index_reply_score"]), add)))
        pw.run(monitoring_level=pw.MonitoringLevel.NONE,
               persistence_config=fs_config(p, d / "snap", "OPERATOR_PERSISTING"))
        final: dict = {}
        for qid, ids, scores, add in rows:
            if add:
                final[qid] = (ids, scores)
            elif final.get(qid, (None,))[0] == ids:
                del final[qid]
        out.append({"size": reply._node.adapter.stats()["size"], "final": final, "embedded": embedded[0],
                    "sink_rows": len(rows), "rows": rows, "vecs": vecs})
    return out


F32_TOL = 1e-5


def same_answer(a: dict, b: dict) -> bool:
    """Two replies ({doc: score}) with the same ids, scores at ``F32_TOL``."""
    return a.keys() == b.keys() and all(abs(a[doc] - b[doc]) <= F32_TOL for doc in a)


def step_revisions(rows: list) -> tuple[list, int]:
    """One run's sink rows as (question, diff, {doc: score}), less each
    retraction and insertion of one question whose replies are the same
    at ``F32_TOL``, and the number of such pairs taken out.  A reply
    re-emitted with its ids unchanged is no revision: ``SegmentedIndex``
    merges its delta segment on a background thread, and when a merge
    ends between two re-answers a document's score comes from the main
    segment instead of the delta, a rounding apart (ROADMAP, "Reference
    behaviour found while porting", C10 and C12)."""
    by: dict = {}
    for qid, ids, scores, add in rows:
        by.setdefault(qid, []).append((add, dict(zip(ids, map(float, scores)))))
    out, removed = [], 0
    for qid, ups in by.items():
        ins = [r for add, r in ups if add]
        rets = [r for add, r in ups if not add]
        for r in list(ins):
            match = next((x for x in rets if same_answer(x, r)), None)
            if match is not None:
                ins.remove(r)
                rets.remove(match)
                removed += 1
        out += [(qid, -1, r) for r in rets] + [(qid, 1, r) for r in ins]
    return out, removed


def resume_oracle(steps: list, vecs: dict, k: int = 4) -> list:
    """The revisions each run must emit, from numpy: over the documents
    present after that run's input (a re-upserted document by its new
    text), each question's exact top ``k`` by cosine similarity (in f64,
    over ``vecs``, the package's own embeddings); a question's first
    answer is an insertion, a changed answer a retraction of the old
    and an insertion of the new."""
    docs: dict = {}
    questions: list = []
    prev: dict = {}
    out = []
    for step_docs, step_questions in steps:
        docs.update((row["doc"], row["text"]) for row in step_docs)
        questions += [q["doc"] for q in step_questions]
        texts = {q["doc"]: q["text"] for _, qs in steps for q in qs}
        names = sorted(docs)
        mat = np.stack([vecs[docs[n]] for n in names])
        mat /= np.linalg.norm(mat, axis=1, keepdims=True)
        revs = []
        for qid in questions:
            q = vecs[texts[qid]] / np.linalg.norm(vecs[texts[qid]])
            scores = mat @ q
            order = np.argsort(-scores, kind="stable")
            # no near-tie at the cut: the top k is decided at any f32 rounding
            assert len(order) <= k or scores[order[k - 1]] - scores[order[k]] > 10 * F32_TOL, qid
            answer = {names[j]: float(scores[j]) for j in order[:k]}
            if qid not in prev:
                revs.append((qid, 1, answer))
            elif not same_answer(prev[qid], answer):
                revs += [(qid, -1, prev[qid]), (qid, 1, answer)]
            prev[qid] = answer
        out.append(revs)
    return out


def _revision_key(r: tuple) -> tuple:
    return (r[0], r[1], sorted(r[2]))


def revisions_equal(got: list, want: list) -> bool:
    g, w = sorted(got, key=_revision_key), sorted(want, key=_revision_key)
    return len(g) == len(w) and all(a[:2] == b[:2] and same_answer(a[2], b[2]) for a, b in zip(g, w))


def test_device_config_persists_and_resumes_like_jax(tmp_path, tiny_encoder):
    """Run, stop; append documents (some re-upserted) and questions,
    resume; resume again with nothing new.  Index sizes, final answers'
    ids and rows embedded after each restart are equal in both packages,
    scores within 1e-5, and the last run sinks nothing.  Each run's
    revisions, less the replies re-emitted unchanged after a background
    merge, equal an exact numpy oracle: the port's always, the JAX
    package's where it agrees with its oracle (then it is held to the
    port's too)."""
    base = corpus_lines(24, seed=16)
    extra = corpus_lines(8, seed=17, prefix="e") + [dict(base[i], text=f"new text {i}") for i in (2, 5)]
    questions = corpus_lines(6, seed=18, prefix="q")
    steps = [(base, questions[:4]), (extra, questions[4:]), ([], [])]
    got = both(device_pipeline, tmp_path, tiny_encoder, steps)
    for g, w in zip(got["port"], got["jax"]):
        assert g["size"] == w["size"] and g["embedded"] == w["embedded"]
        assert g["final"].keys() == w["final"].keys()
        for qid, (ids, scores) in w["final"].items():
            assert g["final"][qid][0] == ids, qid
            np.testing.assert_allclose(g["final"][qid][1], scores, rtol=0, atol=1e-5)
    first, second, third = got["port"]
    assert [first["size"], second["size"], third["size"]] == [24, 32, 32]
    assert first["embedded"] == 24 + 4
    assert second["embedded"] == len(extra) + 2  # only the appended rows: the checkpoint covered the rest
    assert third["embedded"] == 0 and third["sink_rows"] == 0 and got["jax"][2]["sink_rows"] == 0
    assert len(first["final"]) == 4 and len(second["final"]) == 6
    port_oracle = resume_oracle(steps, first["vecs"])
    jax_oracle = resume_oracle(steps, got["jax"][0]["vecs"])
    for i, (g, w) in enumerate(zip(got["port"], got["jax"])):
        port_revs, port_repeats = step_revisions(g["rows"])
        jax_revs, jax_repeats = step_revisions(w["rows"])
        print(f"run {i + 1}: sink rows port {g['sink_rows']} jax {w['sink_rows']}; "
              f"unchanged re-emissions port {port_repeats} jax {jax_repeats}")
        assert bool(port_oracle[i]) == (i < 2)  # revisions in every run but the last
        assert revisions_equal(port_revs, port_oracle[i]), (i, port_revs, port_oracle[i])
        if revisions_equal(jax_revs, jax_oracle[i]):
            assert revisions_equal(port_revs, jax_revs), (i, port_revs, jax_revs)
        else:
            print(f"run {i + 1}: the reference diverged from its oracle: {jax_revs} against {jax_oracle[i]}")


# ---------------------------------------------------------------------------
# the index's state round trip


def test_slab_and_segmented_index_state_round_trip():
    from pathway_tpu_torch.parallel import ShardedKnnIndex
    from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex

    rng = np.random.default_rng(19)
    qs = rng.standard_normal((5, 16)).astype(np.float32)
    slab = ShardedKnnIndex(16, metric="cos", capacity=64, device="cpu")
    slab.add_batch([f"k{i}" for i in range(40)], rng.standard_normal((40, 16)).astype(np.float32))
    slab.remove(["k3", "k9"])
    seg = SegmentedIndex(ShardedKnnIndex(16, metric="cos", capacity=64, device="cpu"), delta_cap=64,
                         auto_merge=False)
    seg.add([(f"s{i}", v) for i, v in enumerate(rng.standard_normal((20, 16)).astype(np.float32))])
    seg.merge(wait=True)
    seg.add([(f"s{i}", v) for i, v in zip(range(15, 25), rng.standard_normal((10, 16)).astype(np.float32))])
    seg.remove(["s1", "s16", "s30"])
    for index, fresh in ((slab, lambda: ShardedKnnIndex(16, metric="cos", capacity=64, device="cpu")),
                         (seg, lambda: SegmentedIndex(ShardedKnnIndex(16, metric="cos", capacity=64, device="cpu"),
                                                      delta_cap=64, auto_merge=False))):
        state = index.state_dict()
        copy = fresh()
        copy.load_state_dict(pickle.loads(pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)))
        again = copy.state_dict()
        flat = lambda s: s["main"] if "main" in s else s  # noqa: E731
        for key in ("vectors", "valid"):
            assert np.array_equal(flat(again)[key], flat(state)[key])
        assert flat(again)["slot_of"] == flat(state)["slot_of"] and flat(again)["cursor"] == flat(state)["cursor"]
        if "main" in state:
            assert again["delta_keys"] == state["delta_keys"] and set(again["tombstones"]) == set(state["tombstones"])
            assert np.array_equal(again["delta_vectors"], state["delta_vectors"])
            assert len(state["delta_keys"]) == 9 and len(state["tombstones"]) == 2
        assert copy.search(qs, 6) == index.search(qs, 6)
        keys = lambda ix: ix.keys() if callable(ix.keys) else ix.keys  # noqa: E731
        assert sorted(keys(copy)) == sorted(keys(index))


# ---------------------------------------------------------------------------
# monitoring and the analyzer on a persisted run


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scrape_persisted_run(p, d, monkeypatch) -> dict:
    """``pw.run(with_http_server=True, persistence_config=...)`` under
    OPERATOR_PERSISTING on a thread, held open by a Python connector until
    ``/status`` shows a checkpoint; its checkpoint section and the
    checkpoint series of ``/metrics``."""
    pw = p.pw
    ConnectorSubject = import_module(f"{pw.__name__}.io.python").ConnectorSubject
    go = threading.Event()
    port = free_port()
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
    monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)

    class WordSchema(pw.Schema):
        word: str

    class Feed(ConnectorSubject):
        def run(self):
            for w in words(20, 4, seed=20):
                self.next(word=w)
            self.commit()
            go.wait(DEADLINE_S)

    t = pw.io.python.read(Feed(), schema=WordSchema)
    pw.io.subscribe(t.groupby(t.word).reduce(t.word, n=pw.reducers.count()), on_change=lambda *a: None)
    runner = threading.Thread(target=pw.run, kwargs={
        "with_http_server": True, "monitoring_level": pw.MonitoringLevel.NONE,
        "persistence_config": fs_config(p, d / "snap", "OPERATOR_PERSISTING")}, daemon=True)
    runner.start()
    try:
        deadline = time.monotonic() + DEADLINE_S
        while True:
            try:
                status = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=10).read())
                if (status.get("checkpoint") or {}).get("count"):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no checkpoint landed"
            go.wait(0.05)
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    finally:
        go.set()
        runner.join(DEADLINE_S)
    series = sorted({line.split()[0] for line in metrics.splitlines()
                     if line.startswith("pathway_tpu_checkpoint")} |
                    {line.split()[2] for line in metrics.splitlines()
                     if line.startswith("# TYPE pathway_tpu_checkpoint")})
    return {"checkpoint": status["checkpoint"], "series": series, "joined": not runner.is_alive()}


def test_status_and_metrics_of_a_persisted_run_match_jax(tmp_path, monkeypatch):
    got = both(scrape_persisted_run, tmp_path, monkeypatch)
    assert got["port"]["joined"] and got["jax"]["joined"]
    assert sorted(got["port"]["checkpoint"]) == sorted(got["jax"]["checkpoint"])
    assert got["port"]["checkpoint"]["count"] >= 1 and got["port"]["checkpoint"]["bytes"] > 0
    assert got["port"]["series"] == got["jax"]["series"]
    assert "pathway_tpu_checkpoint_bytes" in got["port"]["series"]


def index_drill_graph(p, d) -> list:
    """``IndexDrill``'s program with its run taken out: ``pw.analyze``'s
    checkpoint-coverage findings (PW-R001) over its graph."""
    chaos_mod = import_module(f"{p.pw.__name__}.testing.chaos")
    drill = chaos_mod.IndexDrill(str(d), seed=7, processes=1)
    docs_path, queries_path = drill._write_inputs()
    prog, _out, _dump = drill._write_index_program("graph", docs_path, queries_path)
    src = open(prog).read()
    cut = src.index("pconf = Config.simple_config(")
    namespace: dict = {"__name__": "drill_graph"}
    exec(compile(src[:cut], prog, "exec"), namespace)
    diags = p.pw.analyze()
    return sorted((x.code, x.severity, x.message) for x in diags if x.code.startswith("PW-R"))


def test_analyzer_checkpoint_coverage_on_the_index_drill_graph(tmp_path):
    """The recovery findings over the drill's graph are the JAX package's:
    no checkpoint-coverage hole (PW-R001: the index operator folds the
    adapter's state into its snapshot), and the single-owner index's
    availability warning (PW-R002)."""
    got = both(index_drill_graph, tmp_path)
    assert got["port"] == got["jax"]
    assert [code for code, _sev, _msg in got["port"]] == ["PW-R002"]


# ---------------------------------------------------------------------------
# import hygiene


def test_persistence_and_testing_import_no_jax(tmp_path):
    """With ``jax`` and ``pathway_tpu`` blocked, the persistence layer and
    the chaos harness import, and a persisted wordcount resumes without
    duplicates."""
    code = textwrap.dedent(f"""
        import collections, json, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "pathway_tpu", "flax"):
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.persistence import Backend, Config
        from pathway_tpu_torch.testing import ChaosError, chaos, flaky_once
        from pathway_tpu_torch.testing.chaos import ClusterDrill, IndexDrill

        path = {str(tmp_path / "w.jsonl")!r}

        class S(pw.Schema):
            word: str

        out = []
        for rows in (["a", "b", "a"], ["c"]):
            with open(path, "a") as f:
                f.writelines(json.dumps({{"word": w}}) + "\\n" for w in rows)
            pw.G.clear()
            t = pw.io.jsonlines.read(path, schema=S, mode="static")
            r = {{}}
            pw.io.subscribe(t.groupby(t.word).reduce(t.word, n=pw.reducers.count()),
                            on_change=lambda key, row, time, add: r.__setitem__(row["word"], row["n"]) if add else None)
            pw.run(monitoring_level="none",
                   persistence_config=Config.simple_config(Backend.filesystem({str(tmp_path / "snap")!r})))
            out.append(r)
        assert out == [{{"a": 2, "b": 1}}, {{"a": 2, "b": 1, "c": 1}}], out
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "pathway_tpu"))
        print(json.dumps(bad))
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ---------------------------------------------------------------------------
# replay latency (tests/test_streaming_latency.py)


def replay_speed(p, d, env_speedup):
    """Record a source with a 0.4 s gap between two commits, then replay
    it under REALTIME_REPLAY at 1x and faster (``replay_speedup=40`` or
    ``PATHWAY_REPLAY_SPEEDUP``): each replay's seconds and rows."""
    pw = p.pw
    ConnectorSubject = import_module(f"{pw.__name__}.io.python").ConnectorSubject

    class WordSchema(pw.Schema):
        word: str

    class SlowSource(ConnectorSubject):
        def run(self):
            self.next(word="x")
            self.commit()
            time.sleep(0.4)  # the recorded gap
            self.next(word="y")
            self.commit()

    def build():
        p.G.clear()
        t = pw.io.python.read(SlowSource(), schema=WordSchema)
        return t.groupby(t.word).reduce(t.word, n=pw.reducers.count())._capture_node()

    build()
    run_with(p, fs_config(p, d / "snap"))

    def replay(**kw):
        cap = build()
        sched = p.Scheduler(p.G.engine_graph, autocommit_ms=10)
        p.persistence.attach_persistence(sched, fs_config(p, d / "snap", "REALTIME_REPLAY", **kw))
        t0 = time.monotonic()
        ctx = sched.run()
        return time.monotonic() - t0, sorted(ctx.state(cap)["rows"].values())

    if env_speedup:
        os.environ["PATHWAY_REPLAY_SPEEDUP"] = "100"
        try:
            return [replay()]
        finally:
            del os.environ["PATHWAY_REPLAY_SPEEDUP"]
    return [replay(), replay(replay_speedup=40.0)]


def test_realtime_replay_speed_factor(tmp_path):
    got = both(replay_speed, tmp_path, False)
    for name in BOTH:
        (slow_dt, slow_rows), (fast_dt, fast_rows) = got[name]
        assert slow_rows == fast_rows == [("x", 1), ("y", 1)], name
        assert slow_dt >= 0.3 and fast_dt < slow_dt - 0.25, name  # honoured at 1x, collapsed at 40x


def test_replay_speedup_env_override(tmp_path, monkeypatch):
    monkeypatch.delenv("PATHWAY_REPLAY_SPEEDUP", raising=False)
    got = both(replay_speed, tmp_path, True)
    for name in BOTH:
        ((dt, rows),) = got[name]
        assert rows == [("x", 1), ("y", 1)] and dt < 0.3, name
