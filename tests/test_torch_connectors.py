"""The port's slice-16f connectors (``pathway_tpu_torch.io``: null, sqlite,
pyfilesystem, s3, s3_csv, minio, kafka, redpanda, debezium, postgres and
the ``_gated`` helper) against the JAX package's, on the CPU.

Each case is written once, as a function of the package module
(``build(pw, ...)``), and runs through ``pathway_tpu`` and through
``pathway_tpu_torch``; the inputs are made from a seed with numpy.  A
service is driven as the JAX package's own tests drive it: the in-process
``MockBroker`` for the Kafka family, a fake client for S3 and MinIO, a fake
filesystem for PyFilesystem, ``sqlite3`` for SQLite and PostgreSQL.  What
is compared is what a user reads: the rows a table ends with (keys
dropped), the rows a sink wrote, the events a source emitted, and the
``MissingDependency`` messages where a client library is absent.  The
templates are ``tests/test_io.py`` (Kafka, dsv, sqlite, the S3 modified
object), ``tests/test_io_connectors.py`` (PyFilesystem),
``tests/test_reducers_matrix.py`` (Debezium, Kafka upserts),
``tests/test_io_roundtrips.py`` and ``tests/test_writer_formats.py``
(postgres) and ``tests/test_persistence.py`` (the S3 object cache).
"""

from __future__ import annotations

import collections
import json
import sqlite3
import threading
import time

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

WORDS = ["ada", "bob", "cyd", "dee", "eve", "fay", "gus", "hal"]
_rng = np.random.default_rng(26)
VALUES = [int(v) for v in _rng.integers(0, 100, 24)]
NAMES = [str(w) for w in _rng.choice(WORDS, 24)]
DEADLINE_S = 10.0


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
    """The rows ``table`` ends with after ``pw.run`` (a multiset of value
    tuples, keys dropped)."""
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
    jpw.G.clear()
    want = build(jpw, *args)
    tpw.G.clear()
    got = build(tpw, *args)
    return want, got


def url(pw, name: str) -> str:
    """A mock broker per package and case (each package keeps its own
    registry of brokers)."""
    return f"mock://{pw.__name__}-{name}"


# ---------------------------------------------------------------------------
# names


def test_slice_connectors_resolve_to_the_ports_own():
    import pathway_tpu_torch.io as tio

    for name in ("null", "sqlite", "pyfilesystem", "s3", "s3_csv", "minio", "kafka", "redpanda", "debezium",
                 "postgres"):
        assert getattr(tio, name).__name__ == f"pathway_tpu_torch.io.{name}"
        assert name in tio._SUBMODULES
        assert set(getattr(tio, name).__all__) == set(getattr(jpw.io, name).__all__)
    assert tio._LATER == ["airbyte", "bigquery", "deltalake", "elasticsearch", "gdrive", "logstash", "mongodb",
                          "nats", "pubsub", "slack"]
    for name in tio._LATER:
        with pytest.raises(AttributeError, match="slice 16g"):
            getattr(tio, name)
    assert tio.redpanda.read is tio.kafka.read and tio.redpanda.write is tio.kafka.write
    assert tio.kafka.simple_read is tio.kafka.read


# ---------------------------------------------------------------------------
# Kafka family over the MockBroker


def kafka_json(pw):
    broker = pw.io.kafka.MockBroker.get(url(pw, "json"))
    for v in VALUES:
        broker.produce("topic", json.dumps({"v": v}).encode())
    broker.produce("topic", b"not json")
    broker.produce("topic", b"[1, 2]")
    broker.close_topic("topic")

    class S(pw.Schema):
        v: int

    t = pw.io.kafka.read({"bootstrap.servers": url(pw, "json")}, topic="topic", schema=S, format="json")
    return final_rows(pw, t.reduce(s=pw.reducers.sum(t.v), c=pw.reducers.count()))


def kafka_dsv(pw):
    broker = pw.io.kafka.MockBroker.get(url(pw, "dsv"))
    for name, v in zip(NAMES, VALUES):
        broker.produce("t", f"{name};{v}".encode())
    broker.produce("t", b"short")
    broker.close_topic("t")

    class S(pw.Schema):
        k: str
        v: int

    return final_rows(pw, pw.io.kafka.read({"bootstrap.servers": url(pw, "dsv")}, topic="t", schema=S, format="dsv"))


def kafka_raw(pw):
    broker = pw.io.kafka.MockBroker.get(url(pw, "raw"))
    for name in NAMES:
        broker.produce("t", name.encode())
    broker.close_topic("t")
    return final_rows(pw, pw.io.redpanda.read({"bootstrap.servers": url(pw, "raw")}, topic="t"))


def kafka_upsert(pw):
    broker = pw.io.kafka.MockBroker.get(url(pw, "upsert"))
    for name, v in zip(NAMES, VALUES):
        broker.produce("t", json.dumps({"k": name, "v": v}).encode())
    broker.close_topic("t")

    class S(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    return final_rows(pw, pw.io.kafka.read({"bootstrap.servers": url(pw, "upsert")}, topic="t", schema=S,
                                           format="json"))


@pytest.mark.parametrize("build", [kafka_json, kafka_dsv, kafka_raw, kafka_upsert],
                         ids=["json", "dsv", "raw", "upsert"])
def test_kafka_reads(build):
    want, got = both(build)
    assert got == want and got


def test_kafka_upsert_keeps_the_last_value():
    last = dict(zip(NAMES, VALUES))
    assert kafka_upsert(tpw) == collections.Counter(last.items())


def kafka_roundtrip(pw):
    """A table written to a topic, then the topic read back (json)."""

    class S(pw.Schema):
        k: str
        v: int

    t = pw.debug.table_from_rows(S, list(zip(NAMES, VALUES)))
    pw.io.kafka.write(t, {"bootstrap.servers": url(pw, "out")}, "out")
    run(pw)
    broker = pw.io.kafka.MockBroker.get(url(pw, "out"))
    msgs = [json.loads(v) for _, v in broker.topics["out"]]
    return sorted((m["k"], m["v"], m["diff"]) for m in msgs)


def test_kafka_write_roundtrip():
    want, got = both(kafka_roundtrip)
    assert got == want == sorted((k, v, 1) for k, v in zip(NAMES, VALUES))


def kafka_format_error(pw):
    with pytest.raises(ValueError) as e:
        pw.io.kafka._parse_message(b"x", "avro", None)
    return str(e.value)


def test_kafka_unknown_format_raises_alike():
    want, got = both(kafka_format_error)
    assert got == want


# ---------------------------------------------------------------------------
# Debezium CDC over the MockBroker


def debezium(pw, wrapped: bool):
    broker = pw.io.kafka.MockBroker.get(url(pw, f"dbz-{wrapped}"))

    def envelope(op, before, after):
        payload = {"op": op, "before": before, "after": after}
        return json.dumps({"schema": {}, "payload": payload} if wrapped else payload).encode()

    rows = {i: name for i, name in enumerate(NAMES)}
    for i, name in rows.items():
        broker.produce("cdc", envelope("c", None, {"id": i, "name": name}))
    for i in range(0, len(NAMES), 3):  # updates
        broker.produce("cdc", envelope("u", {"id": i, "name": rows[i]}, {"id": i, "name": rows[i] + "2"}))
    for i in range(1, len(NAMES), 4):  # deletes
        broker.produce("cdc", envelope("d", {"id": i, "name": rows[i]}, None))
    broker.produce("cdc", b"garbage")
    broker.close_topic("cdc")

    class S(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        name: str

    return final_rows(pw, pw.io.debezium.read({"bootstrap.servers": url(pw, f"dbz-{wrapped}")},
                                              topic_name="cdc", schema=S))


@pytest.mark.parametrize("wrapped", [False, True], ids=["flat", "schema-payload"])
def test_debezium_create_update_delete(wrapped):
    want, got = both(debezium, wrapped)
    assert got == want
    expect = {i: name + ("2" if i % 3 == 0 else "") for i, name in enumerate(NAMES) if i % 4 != 1}
    assert got == collections.Counter(expect.items())


# ---------------------------------------------------------------------------
# sqlite


def sqlite_db(tmp_path, tag: str):
    db = tmp_path / f"{tag}.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE items (k TEXT PRIMARY KEY, v INTEGER)")
    conn.executemany("INSERT INTO items VALUES (?, ?)", sorted(dict(zip(NAMES, VALUES)).items()))
    conn.commit()
    conn.close()
    return db


def sqlite_static(pw, tmp_path):
    db = sqlite_db(tmp_path, pw.__name__)

    class S(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    return final_rows(pw, pw.io.sqlite.read(str(db), "items", S, mode="static"))


def test_sqlite_static(tmp_path):
    want, got = both(sqlite_static, tmp_path)
    assert got == want == collections.Counter(dict(zip(NAMES, VALUES)).items())


def sqlite_streaming(pw, tmp_path):
    """A streaming read sees an insert, an update and a delete made while
    it runs; the events it emits, in order."""
    db = sqlite_db(tmp_path, f"stream-{pw.__name__}")

    class S(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    src = pw.io.sqlite._SqliteSource(str(db), "items", S, "streaming", poll_interval=0.02)
    events, stop, commits = [], threading.Event(), [0]

    class Events:
        @property
        def stopped(self):
            return stop.is_set()

        def add(self, key, row):
            events.append(("+", row))

        def remove(self, key, row):
            events.append(("-", row))

        def commit(self):
            commits[0] += 1

        def close(self):
            pass

    th = threading.Thread(target=src.run, args=(Events(),), daemon=True)
    th.start()
    deadline = time.monotonic() + DEADLINE_S
    while commits[0] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    first = len(events)
    conn = sqlite3.connect(db)
    conn.execute("INSERT INTO items VALUES ('zed', 7)")
    conn.execute("UPDATE items SET v = v + 1000 WHERE k = ?", (NAMES[0],))
    conn.execute("DELETE FROM items WHERE k = ?", (NAMES[1],))
    conn.commit()
    conn.close()
    while commits[0] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    th.join(timeout=5)
    return first, sorted(events[:first]), sorted(events[first:])


def test_sqlite_streaming_sees_changes(tmp_path):
    want, got = both(sqlite_streaming, tmp_path)
    assert got == want
    first, _, changes = got
    assert first == len(set(NAMES))
    assert ("+", ("zed", 7)) in changes and ("-", (NAMES[1], dict(zip(NAMES, VALUES))[NAMES[1]])) in changes


# ---------------------------------------------------------------------------
# postgres on sqlite3, and null


def postgres(pw, tmp_path, snapshot: bool):
    db = tmp_path / f"pg-{pw.__name__}-{snapshot}.db"
    conn = sqlite3.connect(db, check_same_thread=False)
    if snapshot:
        conn.execute("CREATE TABLE counts (word TEXT PRIMARY KEY, n INTEGER)")
    else:
        conn.execute("CREATE TABLE counts (word TEXT, n INTEGER, time INTEGER, diff INTEGER)")
    conn.commit()
    t = pw.debug.table_from_markdown(
        """
        word | n | __time__ | __diff__
        a    | 1 | 2        | 1
        b    | 1 | 2        | 1
        a    | 1 | 4        | -1
        a    | 2 | 4        | 1
        c    | 5 | 4        | 1
        c    | 5 | 6        | -1
        """
    )
    if snapshot:
        pw.io.postgres.write_snapshot(t, None, "counts", ["word"], connection=conn)
    else:
        pw.io.postgres.write(t, None, "counts", connection=lambda: conn)
    pw.io.null.write(t)
    run(pw)
    check = sqlite3.connect(db)
    rows = sorted(check.execute("SELECT * FROM counts").fetchall())
    check.close()
    return rows


@pytest.mark.parametrize("snapshot", [False, True], ids=["write", "write_snapshot"])
def test_postgres_on_sqlite(tmp_path, snapshot):
    want, got = both(postgres, tmp_path, snapshot)
    assert got == want
    if snapshot:
        assert got == [("a", 2), ("b", 1)]
    else:
        assert sorted((w, n, d) for w, n, _t, d in got) == [
            ("a", 1, -1), ("a", 1, 1), ("a", 2, 1), ("b", 1, 1), ("c", 5, -1), ("c", 5, 1)]


def postgres_sql(pw, snapshot_keys):
    """The SQL the writer issues on a connection that is not sqlite's."""
    log = []

    class Cursor:
        def execute(self, sql, params=None):
            log.append((sql, list(params or [])))

    class Conn:
        def cursor(self):
            return Cursor()

        def commit(self):
            log.append("commit")

        def close(self):
            pass

    w = pw.io.postgres._PsqlWriter(None, Conn(), "tbl", snapshot_keys=snapshot_keys, max_batch_size=2)
    w.write({"k": 7, "v": "new", "n": 2}, time=2, diff=1)
    w.write({"k": 7, "v": "new", "n": 2}, time=4, diff=-1)
    w.write({"k": 8, "v": "x", "n": 3}, time=4, diff=1)
    w.flush()
    return log


@pytest.mark.parametrize("keys", [None, ["k"]], ids=["updates", "snapshot"])
def test_postgres_statements(keys):
    want, got = both(postgres_sql, keys)
    assert got == want


# ---------------------------------------------------------------------------
# object stores (fake clients) and PyFilesystem (a fake FS)


class FakeS3:
    def __init__(self, objects: dict):
        self.objects = objects
        self.get_calls = 0

    def list_objects_v2(self, Bucket, Prefix, **kw):
        return {"Contents": [{"Key": k, "ETag": str(zlib_crc(v)), "Size": len(v)}
                             for k, v in sorted(self.objects.items()) if k.startswith(Prefix)],
                "IsTruncated": False}

    def get_object(self, Bucket, Key):
        self.get_calls += 1
        return {"Body": self.objects[Key]}


def zlib_crc(data: bytes) -> int:
    import zlib

    return zlib.crc32(data)


def jsonl(rows) -> bytes:
    return "".join(json.dumps(r) + "\n" for r in rows).encode()


def s3_read(pw, fmt: str):
    objects = {
        "pre/a.jsonl": jsonl({"k": n, "v": v} for n, v in zip(NAMES[:12], VALUES[:12])),
        "pre/b.jsonl": jsonl({"k": n, "v": v} for n, v in zip(NAMES[12:], VALUES[12:])),
        "other/c.jsonl": jsonl([{"k": "zz", "v": 0}]),
        "pre/c.csv": ("k,v\n" + "".join(f"{n},{v}\n" for n, v in zip(NAMES, VALUES))).encode(),
    }

    class S(pw.Schema):
        k: str
        v: int

    client = FakeS3(objects)
    if fmt == "jsonlines":
        objects.pop("pre/c.csv")
        t = pw.io.s3.read("s3://bkt/pre/", aws_s3_settings=pw.io.s3.AwsS3Settings(client=client), schema=S,
                          mode="static")
    elif fmt == "csv":
        for key in ("pre/a.jsonl", "pre/b.jsonl"):
            objects.pop(key)
        t = pw.io.s3_csv.read("pre/", aws_s3_settings=pw.io.s3.AwsS3Settings(bucket_name="bkt", client=client),
                              schema=S, mode="static")
    else:  # minio, jsonlines with metadata
        objects.pop("pre/c.csv")
        settings = pw.io.minio.MinIOSettings(endpoint="http://minio:9000", bucket_name="bkt", client=client)
        t = pw.io.minio.read("pre/", settings, schema=S, mode="static")
    return final_rows(pw, t)


@pytest.mark.parametrize("fmt", ["jsonlines", "csv", "minio"])
def test_object_store_reads(fmt):
    want, got = both(s3_read, fmt)
    assert got == want == collections.Counter(zip(NAMES, VALUES))


def s3_modified_object(pw):
    """A changed object replaces its predecessor (template:
    ``tests/test_io.py`` ``test_s3_modified_object_retracts_old_version``)."""
    from importlib import import_module

    s3 = import_module(f"{pw.__name__}.io.s3")
    client = FakeS3({"a.jsonl": b'{"v": 1}\n{"v": 2}\n'})

    class S(pw.Schema):
        v: int

    src = s3._S3Source(s3.AwsS3Settings(bucket_name="b", client=client), "", S, s3._parser_for("jsonlines", S, None),
                       mode="streaming", poll_interval=0.02)
    adds, removes, commits, stop = [], [], [0], threading.Event()

    class Events:
        @property
        def stopped(self):
            return stop.is_set()

        def add(self, key, row):
            adds.append((int(key), row))

        def remove(self, key, row):
            removes.append(int(key))

        def commit(self):
            commits[0] += 1

        def close(self):
            pass

    th = threading.Thread(target=src.run, args=(Events(),), daemon=True)
    th.start()
    deadline = time.monotonic() + DEADLINE_S
    for n, change in ((1, b'{"v": 3}\n'), (2, None), (3, None)):
        while commits[0] < n and time.monotonic() < deadline:
            time.sleep(0.01)
        if n == 1:
            client.objects["a.jsonl"] += change
        elif n == 2:
            client.objects["a.jsonl"] = b'{"v": 1}\n'
    stop.set()
    th.join(timeout=5)
    return [row for _, row in adds], len(removes), len({k for k, _ in adds}), all(
        k in {a for a, _ in adds} for k in removes)


def test_s3_modified_object_retracts_old_version():
    want, got = both(s3_modified_object)
    assert got == want
    rows, n_removed, n_keys, removed_known = got
    assert rows == [(1,), (2,), (1,), (2,), (3,), (1,)] and n_removed == 2 and n_keys == 3 and removed_known


def s3_object_cache(pw):
    """Unchanged object versions come from the cache: the second run makes
    no ``get_object`` call."""
    from importlib import import_module

    s3 = import_module(f"{pw.__name__}.io.s3")
    cache = pw.persistence.CachedObjectStorage(pw.persistence.Backend.memory(f"s3_cache_{pw.__name__}"))

    class S(pw.Schema):
        v: int

    calls = []
    for _ in range(2):
        client = FakeS3({"pre/a.jsonl": b'{"v": 1}\n'})
        src = s3._S3Source(s3.AwsS3Settings(bucket_name="b", client=client), "pre/", S,
                           s3._parser_for("jsonlines", S, None), mode="static", object_cache=cache)
        rows = []

        class Events:
            stopped = False

            def add(self, key, row):
                rows.append(row)

            def remove(self, key, row):
                pass

            def commit(self):
                pass

            def close(self):
                pass

        src.run(Events())
        calls.append((client.get_calls, rows))
    return calls


def test_s3_source_uses_object_cache():
    want, got = both(s3_object_cache)
    assert got == want == [(1, [(1,)]), (0, [(1,)])]


class FakeFS:
    """The PyFilesystem subset ``pw.io.pyfilesystem`` reads."""

    class Info:
        def __init__(self, size):
            self.size = size
            self.modified = "2026-01-01"

    def __init__(self, files: dict):
        self.files = files
        fs = self
        self.walk = type("W", (), {"files": staticmethod(lambda path="/": sorted(fs.files))})()

    def listdir(self, path):
        return sorted(p.rsplit("/", 1)[1] for p in self.files)

    def readbytes(self, path):
        return self.files[path]

    def getinfo(self, path, namespaces=None):
        return FakeFS.Info(len(self.files[path]))


def pyfilesystem(pw):
    files = {f"/docs/{n}_{i}.txt": f"{n} {v}".encode() for i, (n, v) in enumerate(zip(NAMES, VALUES))}
    files["/docs/b.bin"] = b"\x00\x01"
    t = pw.io.pyfilesystem.read(FakeFS(files), path="/docs", mode="static", with_metadata=True)
    keys, cols = pw.debug.table_to_dicts(t)
    return collections.Counter((cols["data"][k], cols["_metadata"][k]["path"]) for k in keys)


def test_pyfilesystem_read_fake_fs():
    want, got = both(pyfilesystem)
    assert got == want and len(got) == len(NAMES) + 1


# ---------------------------------------------------------------------------
# absent client libraries


def missing_messages(pw):
    """``MissingDependency`` where a client library is absent: boto3 (S3
    without a client), kafka-python (a real broker), psycopg2 (postgres
    settings), and the ``_gated`` helpers."""
    from importlib import import_module

    gated = import_module(f"{pw.__name__}.io._gated")
    out = []

    def message(fn, *args, **kwargs):
        with pytest.raises(gated.MissingDependency) as e:
            fn(*args, **kwargs)
        out.append(str(e.value))

    message(pw.io.s3.AwsS3Settings().create_client)
    message(pw.io.kafka.read, {"bootstrap.servers": "localhost:9092"}, topic="t")
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
    message(pw.io.kafka.write, t, {"bootstrap.servers": "localhost:9092"}, "t")
    message(import_module(f"{pw.__name__}.io.postgres")._connect, {"host": "db"}, None)
    message(gated.require, "no_such_client_a", "no_such_client_b")
    message(gated.gated_reader("x", "no_such_client"))
    message(gated.gated_writer("x", "no_such_client"))
    assert issubclass(gated.MissingDependency, ImportError)
    with pytest.raises(NotImplementedError, match="pw.io.y.read"):
        gated.gated_reader("y", "json")()
    return out


def test_missing_dependency_messages():
    for lib in ("boto3", "kafka", "psycopg2"):
        try:
            __import__(lib)
        except ImportError:
            continue
        pytest.skip(f"{lib} is installed: this case holds the messages of its absence")
    want, got = both(missing_messages)
    assert got == want and len(got) == 7
