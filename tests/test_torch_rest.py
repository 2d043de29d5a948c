"""The port's REST ingress (``pathway_tpu_torch.io.http``, on the standard
library's asyncio server) against the JAX package's (on aiohttp), on the
CPU.

One app is written once, as a function of the package module
(``app(pw, port, log)``): ``rest_connector`` routes (a round trip, schema
defaults, a request validator, a fake admission controller that sheds,
``delete_completed_queries``) and ``BaseRestServer.serve_callable`` routes
(async with the schema inferred, sync with it explicit, a callable that
raises), all on one webserver.  Both packages' apps run at once, each on
its own free port, under ``pw.run`` on a thread, and every case sends the
same requests to both: the status codes, the ``Retry-After`` header and
the JSON bodies must be equal.  These are the counterparts of
``tests/test_rest.py`` and ``tests/test_rest_detail.py``, plus 404s, bad
bodies, the query string merged into the payload, a keep-alive connection
and a chunked body, which aiohttp's server and the port's both speak.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

DEADLINE_S = 30.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class FakeAdmission:
    """The admission contract of the JAX package's ``serving/admission.py``,
    duck-typed: tenant "shed" is refused with ``RetryLater``, every other
    tenant gets a ticket whose release is counted."""

    def __init__(self, retry_later, log: dict):
        self.retry_later = retry_later
        self.log = log

    def admit(self, tenant: str, route: str = ""):
        if tenant == "shed":
            self.log["shed"].append(route)
            raise self.retry_later(retry_after=2.3, reason="tenant queue full")
        log = self.log

        class Ticket:
            def release(self):
                log["released"].append(tenant)

        return Ticket()


def app(pw, port: int, log: dict) -> None:
    """Every route of the tests on one webserver."""
    http = pw.io.http
    server = pw.xpacks.llm.servers.BaseRestServer("127.0.0.1", port)
    ws = server.webserver

    class Q(pw.Schema):
        query: str

    q, writer = http.rest_connector(webserver=ws, route="/", schema=Q)
    writer(q.select(result=pw.apply(lambda s: s.upper(), q.query)))

    class Add(pw.Schema):
        x: int
        y: int = pw.column_definition(default_value=10)

    a, writer = http.rest_connector(webserver=ws, route="/add", schema=Add)
    writer(a.select(result=a.x + a.y))

    v, writer = http.rest_connector(
        webserver=ws, route="/validated", schema=Q,
        request_validator=lambda p: None if str(p.get("query", "")).isalpha() else "query must be letters",
    )
    writer(v.select(result=pw.apply(lambda s: s[::-1], v.query)))

    class Tenant(pw.Schema):
        query: str
        tenant: str | None = pw.column_definition(default_value=None)

    s, writer = http.rest_connector(webserver=ws, route="/shed", schema=Tenant,
                                    admission=FakeAdmission(http.RetryLater, log))
    writer(s.select(result=pw.apply(lambda q, t: f"{t}:{q}", s.query, s.tenant)))

    d, writer = http.rest_connector(webserver=ws, route="/deleted", schema=Q, delete_completed_queries=True)
    writer(d.select(result=pw.apply(len, d.query)))
    pw.io.subscribe(d, on_change=lambda key, row, time, add: log["deleted"].append((row["query"], add)))

    @server.serve_callable("/v1/combine")
    async def combine(a, b):
        return {"sum": a + b, "echo": [a, b]}

    class Text(pw.Schema):
        text: str

    server.serve_callable("/v1/upper", Text, lambda text: text.upper())

    def reverse(text: str) -> str:
        if text == "boom":
            raise ValueError("handler failure")
        return text[::-1]

    server.serve_callable("/v1/reverse", Text, reverse)


def start(pw, port: int, log: dict):
    app(pw, port, log)
    pw.G.active_scheduler = None
    thread = threading.Thread(target=pw.run, kwargs={"monitoring_level": pw.MonitoringLevel.NONE},
                              daemon=True)
    thread.start()
    deadline = time.monotonic() + DEADLINE_S
    while pw.G.active_scheduler is None and time.monotonic() < deadline:
        time.sleep(0.02)
    sched = pw.G.active_scheduler
    assert sched is not None, "pw.run did not start"
    while time.monotonic() < deadline:
        try:
            if ask(port, "POST", "/", {"query": "up"}) == (200, None, "UP"):
                return sched, thread
        except OSError:
            pass
        time.sleep(0.1)
    raise TimeoutError(f"the server on port {port} did not come up")


@pytest.fixture(scope="module")
def apps():
    """Both packages' apps, running; stopped and joined at the end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    running = []
    out = SimpleNamespace()
    try:
        for name, pw in (("jax", jpw), ("port", tpw)):
            pw.G.clear()
            port, log = free_port(), {"shed": [], "released": [], "deleted": []}
            sched, thread = start(pw, port, log)
            running.append((sched, thread))
            setattr(out, name, SimpleNamespace(port=port, log=log))
            pw.G.clear()
        yield out
    finally:
        for sched, thread in running:
            sched.stop()
        for sched, thread in running:
            thread.join(timeout=DEADLINE_S)
            assert not thread.is_alive()
        torch.set_num_threads(threads)


def ask(port: int, method: str, path: str, payload=None, *, raw: bytes | None = None,
        headers: dict | None = None, timeout: float = 10.0):
    """One request on a new connection: (status, Retry-After, JSON body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
        conn.request(method, path, body=body, headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        assert resp.getheader("Content-Type") == "application/json; charset=utf-8"
        return resp.status, resp.getheader("Retry-After"), json.loads(data)
    finally:
        conn.close()


def same(apps, *args, **kwargs):
    """The same request to both apps; both answers, which must be equal."""
    want = ask(apps.jax.port, *args, **kwargs)
    got = ask(apps.port.port, *args, **kwargs)
    assert got == want, (args, got, want)
    return got


def test_roundtrip(apps):
    assert same(apps, "POST", "/", {"query": "hello"}) == (200, None, "HELLO")
    assert same(apps, "POST", "/", {"query": "again"}) == (200, None, "AGAIN")


def test_concurrent_queries_and_schema(apps):
    rng = np.random.default_rng(22)
    xs = [int(v) for v in rng.integers(-50, 50, 16)]

    def round_(port):
        with ThreadPoolExecutor(max_workers=8) as pool:
            return list(pool.map(lambda x: ask(port, "POST", "/add", {"x": x, "y": 2 * x}), xs))

    want, got = round_(apps.jax.port), round_(apps.port.port)
    assert got == want == [(200, None, 3 * x) for x in xs]
    # a schema default applies when a field is omitted
    assert same(apps, "POST", "/add", {"x": 1}) == (200, None, 11)
    jdoc = ask(apps.jax.port, "GET", "/_schema")
    tdoc = ask(apps.port.port, "GET", "/_schema")
    assert jdoc[2].pop("info") == {"title": "pathway_tpu app", "version": "1.0"}
    assert tdoc[2].pop("info") == {"title": "pathway_tpu_torch app", "version": "1.0"}
    assert tdoc == jdoc and jdoc[0] == 200
    assert set(tdoc[2]["paths"]) == {"/", "/add", "/validated", "/shed", "/deleted", "/v1/combine",
                                     "/v1/upper", "/v1/reverse"}


def test_serve_callable_async_with_inferred_schema(apps):
    assert same(apps, "POST", "/v1/combine", {"a": 2, "b": 3}) == (200, None, {"sum": 5, "echo": [2, 3]})
    assert same(apps, "POST", "/v1/combine", {"a": "x", "b": "y"})[2] == {"sum": "xy", "echo": ["x", "y"]}


def test_serve_callable_sync_with_explicit_schema(apps):
    assert same(apps, "POST", "/v1/upper", {"text": "hi there"}) == (200, None, "HI THERE")


def test_serve_callable_error_path(apps):
    """A raising callable gives no response row: both servers leave the
    request unanswered (the client times out), and the route keeps
    answering."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        out = list(pool.map(lambda i: same(apps, "POST", "/v1/reverse", {"text": f"word{i}"}), range(8)))
    assert out == [(200, None, f"word{i}"[::-1]) for i in range(8)]
    for port in (apps.jax.port, apps.port.port):
        with pytest.raises(TimeoutError):
            ask(port, "POST", "/v1/reverse", {"text": "boom"}, timeout=1.0)
    assert same(apps, "POST", "/v1/reverse", {"text": "xyz"}) == (200, None, "zyx")


def test_bad_bodies(apps):
    status, _, body = same(apps, "POST", "/", raw=b"{not json")
    assert status == 400 and "Expecting property name" in body["error"]
    # a JSON body that is not an object cannot take the query string
    status, _, body = same(apps, "POST", "/", [1, 2])
    assert status == 500 and body["error"].startswith("AttributeError(")
    # a field of the wrong type reaches the engine, whose error value is
    # the answer
    assert same(apps, "POST", "/add", {"x": "seven"}) == (200, None, "Error")


def test_body_limit(apps):
    """Bodies up to aiohttp's ``client_max_size`` (1 MiB) are read; over
    it both refuse: the port with 413, the JAX package with the 500 its
    dispatcher makes of aiohttp's ``HTTPRequestEntityTooLarge``."""
    fits = "x" * ((1 << 20) - 64)
    assert same(apps, "POST", "/", {"query": fits}) == (200, None, fits.upper())
    big = {"query": "x" * (2 << 20)}
    status, _, body = ask(apps.jax.port, "POST", "/", big)
    assert status == 500 and "HTTPRequestEntityTooLarge" in body["error"]
    status, _, body = ask(apps.port.port, "POST", "/", big)
    assert status == 413 and "over the 1048576-byte limit" in body["error"]
    assert same(apps, "POST", "/", {"query": "after"}) == (200, None, "AFTER")


OVER_LIMIT = 8 << 20
N_OVER_LIMIT = 64


def over_limit(port: int, chunked: bool):
    """One 8 MiB body (more than the loopback socket buffers hold), by
    ``Content-Length`` or in 256 KiB chunks: (status, JSON body), or the
    name of the error the client met instead of an answer."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=DEADLINE_S)
    try:
        body = b'{"query": "' + b"x" * (OVER_LIMIT - 13) + b'"}'
        if chunked:
            step = 1 << 18
            conn.request("POST", "/", body=iter([body[i:i + step] for i in range(0, len(body), step)]),
                         headers={"Content-Type": "application/json"}, encode_chunked=True)
        else:
            conn.request("POST", "/", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    except OSError as e:
        return type(e).__name__
    finally:
        conn.close()


@pytest.mark.parametrize("chunked", [False, True], ids=["content_length", "chunked"])
def test_every_over_limit_body_gets_its_413(apps, chunked):
    """An over-limit body is answered, never dropped: the server writes its
    413, then half-closes and discards the rest of the body before it
    closes, so no client meets a reset before it reads the answer."""
    with ThreadPoolExecutor(8) as pool:
        answers = list(pool.map(lambda _: over_limit(apps.port.port, chunked), range(N_OVER_LIMIT)))
    refused = [a for a in answers if not (isinstance(a, tuple) and a[0] == 413)]
    assert not refused, f"{len(refused)} of {N_OVER_LIMIT} over-limit requests got no 413: {refused[:4]}"
    for _, body in answers:
        assert "over the 1048576-byte limit" in body["error"]
    assert same(apps, "POST", "/", {"query": "after"}) == (200, None, "AFTER")


def test_expect_continue_over_limit_gets_413_without_continue(apps):
    """A client that asks ``Expect: 100-continue`` for an over-limit body is
    refused from the head alone: the 413 comes with no ``100 Continue``
    before it, and the body is never sent."""
    with socket.create_connection(("127.0.0.1", apps.port.port), timeout=DEADLINE_S) as s:
        s.sendall(b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  b"Expect: 100-continue\r\nContent-Length: %d\r\n\r\n" % OVER_LIMIT)
        data = b""
        while chunk := s.recv(1 << 16):
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 413 "), data[:200]
    assert b"100 Continue" not in data
    assert "over the 1048576-byte limit" in json.loads(body)["error"]
    # the same request within the limit is told to go on, and then answered
    with socket.create_connection(("127.0.0.1", apps.port.port), timeout=DEADLINE_S) as s:
        payload = b'{"query": "go"}'
        s.sendall(b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\nConnection: close\r\n"
                  b"Expect: 100-continue\r\nContent-Length: %d\r\n\r\n" % len(payload))
        assert s.recv(64).startswith(b"HTTP/1.1 100 Continue\r\n\r\n")
        s.sendall(payload)
        data = b""
        while chunk := s.recv(1 << 16):
            data += chunk
    assert data.startswith(b"HTTP/1.1 200 ") and json.loads(data.partition(b"\r\n\r\n")[2]) == "GO"


def test_query_string_merges_into_the_payload(apps):
    assert same(apps, "POST", "/?query=from%20url") == (200, None, "FROM URL")
    assert same(apps, "POST", "/add?y=5", {"x": 1}) == (200, None, 6)
    # the query string wins over the body; a repeated name reads as its first value
    assert same(apps, "POST", "/?query=url&query=second", {"query": "body"}) == (200, None, "URL")


def test_delete_completed_queries(apps):
    for q in ("one", "three"):
        assert same(apps, "POST", "/deleted", {"query": q}) == (200, None, len(q))
    deadline = time.monotonic() + DEADLINE_S
    while (len(apps.port.log["deleted"]) < 4 or len(apps.jax.log["deleted"]) < 4) and time.monotonic() < deadline:
        time.sleep(0.02)
    for log in (apps.jax.log, apps.port.log):
        assert sorted(log["deleted"]) == [("one", False), ("one", True), ("three", False), ("three", True)]


def test_request_validator(apps):
    assert same(apps, "POST", "/validated", {"query": "abc"}) == (200, None, "cba")
    assert same(apps, "POST", "/validated", {"query": "a b"}) == (400, None, {"error": "query must be letters"})


def test_admission_sheds_with_429(apps):
    assert same(apps, "POST", "/shed", {"query": "q", "tenant": "shed"}) == (
        429, "3", {"error": "tenant queue full", "retry_after": 2.3})
    assert same(apps, "POST", "/shed", {"query": "q", "tenant": "a"}) == (200, None, "a:q")
    assert same(apps, "POST", "/shed", {"query": "q"}) == (200, None, "None:q")
    for log in (apps.jax.log, apps.port.log):
        assert log["shed"] == ["/shed"] and sorted(log["released"]) == ["a", "default"]


def test_not_found(apps):
    assert same(apps, "POST", "/no-such-route", {}) == (404, None, {"error": "not found"})
    assert same(apps, "GET", "/add") == (404, None, {"error": "not found"})


def test_keep_alive_connection_and_chunked_body(apps):
    """Several requests on one connection, one of them with a chunked
    body; the socket stays the same throughout."""
    answers = {}
    for name in ("jax", "port"):
        conn = http.client.HTTPConnection("127.0.0.1", getattr(apps, name).port, timeout=10)
        out = []
        try:
            conn.connect()
            sock = conn.sock
            for i in range(3):
                conn.request("POST", "/add", body=json.dumps({"x": i}), headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                out.append((resp.status, json.loads(resp.read())))
            conn.request("POST", "/", body=iter([b'{"query":', b' "chunked', b' body"}']),
                         headers={"Content-Type": "application/json"}, encode_chunked=True)
            resp = conn.getresponse()
            out.append((resp.status, json.loads(resp.read())))
            assert conn.sock is sock  # no reconnect: the server kept the connection
        finally:
            conn.close()
        answers[name] = out
    assert answers["port"] == answers["jax"] == [(200, 10), (200, 11), (200, 12), (200, "CHUNKED BODY")]
