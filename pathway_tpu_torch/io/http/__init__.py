"""``pw.io.http`` — REST ingress/egress (counterpart of
``pathway_tpu/io/http``).

Capability parity with reference ``python/pathway/io/http/_server.py``:
``rest_connector(...) -> (Table, response_writer)`` (``:624``),
``PathwayWebserver`` (an HTTP server + OpenAPI docs, ``:329``),
``RestServerSubject`` (``:490``).  Each HTTP request becomes a row; the
response is resolved when the paired response table produces the row's
result (future-per-key, exactly the reference's mechanism).

The JAX package serves with aiohttp; the port's server is written on the
standard library (``asyncio.start_server`` and an HTTP/1.1 reader of its
own) and keeps the same contract: ``async def handler(payload, request)``
per route, the query string merged into the JSON payload, ``/_schema``
for the OpenAPI description, JSON errors (404; 400 on ``ValueError``; 429
with ``Retry-After`` on :class:`RetryLater`; 500 with the error's
``repr``), bodies by ``Content-Length`` or chunked, and keep-alive
connections.
"""

from __future__ import annotations

import asyncio
import email.utils
import json
import logging
import math
import sys
import threading
import urllib.parse
from dataclasses import dataclass
from http import HTTPStatus
from typing import Any, Callable

from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import RowSource, coerce_row, fmt_value, input_table
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["rest_connector", "PathwayWebserver", "RetryLater", "Request"]

logger = logging.getLogger("pathway_tpu_torch.http")


class RetryLater(Exception):
    """Request shed by admission control before entering the engine.

    The ingress maps it to HTTP 429 with a ``Retry-After`` header — the
    client is told WHEN capacity is expected back instead of having its
    request buffered into an unbounded queue (the admission contract of
    the JAX package's ``serving/admission.py``)."""

    def __init__(self, retry_after: float = 1.0, reason: str = "overloaded"):
        super().__init__(reason)
        self.retry_after = max(0.0, float(retry_after))
        self.reason = reason


#: the longest request line plus headers, and the longest chunk-size line
_MAX_HEAD = 1 << 16
#: the largest request body (aiohttp's default ``client_max_size``)
_MAX_BODY = 1 << 20
#: an idle keep-alive connection closes after this many seconds (aiohttp's
#: default keep-alive timeout)
_KEEPALIVE_S = 75.0
_SERVER = f"Python/{sys.version_info[0]}.{sys.version_info[1]} pathway_tpu_torch"


class _BadRequest(Exception):
    """A request the HTTP reader cannot parse (400) or whose body is over
    ``_MAX_BODY`` (413); answered with ``status`` and the connection
    closed."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


def _too_large(n: int) -> _BadRequest:
    return _BadRequest(f"request body of {n} bytes is over the {_MAX_BODY}-byte limit", 413)


@dataclass
class Request:
    """What a route handler sees of its HTTP request (the part of
    aiohttp's ``web.Request`` that handlers of this package read)."""

    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    version: str
    body: bytes = b""

    @property
    def can_read_body(self) -> bool:
        return bool(self.body)

    @property
    def charset(self) -> str:
        ctype = self.headers.get("content-type", "")
        for part in ctype.split(";")[1:]:
            name, _, value = part.strip().partition("=")
            if name.lower() == "charset" and value:
                return value.strip('"')
        return "utf-8"

    def text(self) -> str:
        return self.body.decode(self.charset)

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn


async def _read_request(reader: asyncio.StreamReader, idle_s: float) -> Request | None:
    """Read one request (head and body) off a connection; None when the
    client closed it between requests."""
    try:
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), idle_s)
    except asyncio.IncompleteReadError as e:
        if e.partial.strip():
            raise _BadRequest("truncated request head") from None
        return None
    except asyncio.LimitOverrunError:
        raise _BadRequest("request head too long") from None
    lines = head.decode("latin-1").split("\r\n")
    while lines and not lines[0]:  # stray CRLF between keep-alive requests
        lines.pop(0)
    parts = lines[0].split(" ") if lines else []
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(f"bad request line {lines[0] if lines else ''!r}")
    method, target, version = parts
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name.strip():
            raise _BadRequest(f"bad header line {line!r}")
        name = name.strip().lower()
        value = value.strip()
        headers[name] = f"{headers[name]}, {value}" if name in headers else value
    split = urllib.parse.urlsplit(target)
    items = urllib.parse.parse_qsl(split.query, keep_blank_values=True)
    query: dict[str, str] = {}
    for k, v in items:
        query.setdefault(k, v)  # a repeated name reads as its first value
    return Request(
        method=method.upper(),
        path=urllib.parse.unquote(split.path or "/"),
        query=query,
        headers=headers,
        version=version,
    )


async def _read_body(reader: asyncio.StreamReader, req: Request) -> bytes:
    if "chunked" in req.headers.get("transfer-encoding", "").lower():
        chunks, total = [], 0
        while True:
            try:
                line = await reader.readuntil(b"\r\n")
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                raise _BadRequest("bad chunk size line") from None
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise _BadRequest(f"bad chunk size {line!r}") from None
            if size == 0:
                while (await reader.readuntil(b"\r\n")) != b"\r\n":
                    pass  # trailers
                return b"".join(chunks)
            total += size
            if total > _MAX_BODY:
                raise _too_large(total)
            chunks.append(await reader.readexactly(size))
            if await reader.readexactly(2) != b"\r\n":
                raise _BadRequest("chunk not followed by CRLF")
    length = req.headers.get("content-length")
    if not length:
        return b""
    try:
        n = int(length)
    except ValueError:
        raise _BadRequest(f"bad Content-Length {length!r}") from None
    if n < 0:
        raise _BadRequest(f"bad Content-Length {length!r}")
    if n > _MAX_BODY:
        raise _too_large(n)
    return await reader.readexactly(n)


def _response(
    status: int, body: Any, *, headers: dict[str, str] | None = None, keep_alive: bool = True
) -> bytes:
    """One JSON response as bytes, headed as aiohttp's ``json_response``
    (``default=str`` as the JAX package's results are dumped)."""
    data = json.dumps(body, default=str).encode("utf-8")
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"]
    for name, value in (headers or {}).items():
        lines.append(f"{name}: {value}")
    lines += [
        "Content-Type: application/json; charset=utf-8",
        f"Content-Length: {len(data)}",
        f"Date: {email.utils.formatdate(usegmt=True)}",
        f"Server: {_SERVER}",
        f"Connection: {'keep-alive' if keep_alive else 'close'}",
    ]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data


class PathwayWebserver:
    """One HTTP server shared by any number of routes (reference
    ``PathwayWebserver``).  Runs on its own thread + event loop."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080, with_cors: bool = False):
        self.host = host
        self.port = port
        self.with_cors = with_cors
        self._routes: dict[tuple[str, str], Callable] = {}
        self._openapi_paths: dict[str, Any] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._server: asyncio.AbstractServer | None = None
        self._error: BaseException | None = None

    def register(self, route: str, methods: tuple[str, ...], handler: Callable, doc: Any = None) -> None:
        for m in methods:
            self._routes[(m.upper(), route)] = handler
        if doc is not None:
            self._openapi_paths[route] = doc

    def openapi_description_json(self) -> dict:
        return {
            "openapi": "3.0.3",
            "info": {"title": "pathway_tpu_torch app", "version": "1.0"},
            "paths": self._openapi_paths,
        }

    def _ensure_started(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._serve, daemon=True)
            self._thread.start()
        self._started.wait(timeout=10)
        if self._error is not None:
            raise OSError(
                f"the REST server could not listen on {self.host}:{self.port}: {self._error}"
            ) from self._error

    def _serve(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def start() -> None:
            self._server = await asyncio.start_server(
                self._connection, self.host, self.port, limit=_MAX_HEAD, reuse_address=True
            )

        try:
            loop.run_until_complete(start())
        except OSError as e:
            self._error = e
            self._started.set()
            loop.close()
            return
        self._started.set()
        loop.run_forever()

    async def _connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await _read_request(reader, _KEEPALIVE_S)
                    if req is None:
                        break
                    if req.headers.get("expect", "").lower() == "100-continue":
                        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    req.body = await _read_body(reader, req)
                except _BadRequest as e:
                    writer.write(_response(e.status, {"error": str(e)}, keep_alive=False))
                    await writer.drain()
                    break
                writer.write(await self._dispatch(req))
                await writer.drain()
                if not req.keep_alive:
                    break
        except (asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionError):
            pass  # idle keep-alive expired, or the client went away
        finally:
            writer.close()

    async def _dispatch(self, request: Request) -> bytes:
        keep = request.keep_alive
        if request.path == "/_schema":
            return _response(200, self.openapi_description_json(), keep_alive=keep)
        handler = self._routes.get((request.method, request.path))
        if handler is None:
            return _response(404, {"error": "not found"}, keep_alive=keep)
        try:
            payload: dict[str, Any] = {}
            if request.can_read_body:
                text = request.text()
                if text:
                    payload = json.loads(text)
            payload.update(request.query)
            result = await handler(payload, request)
            return _response(200, result, keep_alive=keep)
        except RetryLater as e:
            # load shed: bounded queues + explicit backpressure, never
            # a silent drop or an unbounded buffer
            return _response(
                429,
                {"error": e.reason, "retry_after": e.retry_after},
                headers={"Retry-After": str(max(1, math.ceil(e.retry_after)))},
                keep_alive=keep,
            )
        except ValueError as e:
            return _response(400, {"error": str(e)}, keep_alive=keep)
        except Exception as e:  # noqa: BLE001
            logger.exception("handler failed")
            return _response(500, {"error": repr(e)}, keep_alive=keep)


class RestServerSubject(RowSource):
    """Bridges HTTP requests into the engine stream (reference
    ``RestServerSubject`` ``io/http/_server.py:490``)."""

    def __init__(
        self,
        webserver: PathwayWebserver,
        route: str,
        methods: tuple[str, ...],
        schema: sch.SchemaMetaclass,
        delete_completed_queries: bool,
        request_validator: Callable | None = None,
        admission: Any = None,
        tenant_field: str = "tenant",
    ):
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        #: admission controller (serving/admission.py contract: ``admit(
        #: tenant, route=...) -> ticket`` raising :class:`RetryLater` on
        #: shed, ticket released when the request leaves the system) —
        #: None keeps the legacy unbounded ingress
        self.admission = admission
        self.tenant_field = tenant_field
        self.futures: dict[K.Pointer, asyncio.Future] = {}
        self._seq = 0
        self._events: Any = None
        self._closed = threading.Event()

    def run(self, events: Any) -> None:
        self._events = events
        doc = {
            "post": {
                "requestBody": {
                    "content": {
                        "application/json": {
                            "schema": {
                                "type": "object",
                                "properties": {
                                    n: {"type": "string"}
                                    for n in self.schema.column_names()
                                },
                            }
                        }
                    }
                },
                "responses": {"200": {"description": "result"}},
            }
        }
        self.webserver.register(self.route, self.methods, self._handle, doc)
        self.webserver._ensure_started()
        # REST source stays open for the lifetime of the run (or until the
        # scheduler shuts down)
        while not self._closed.is_set() and not events.stopped:
            self._closed.wait(timeout=0.25)

    async def _handle(self, payload: dict[str, Any], request: Any) -> Any:
        if self.request_validator is not None:
            maybe_error = self.request_validator(payload)
            if maybe_error is not None:
                raise ValueError(str(maybe_error))
        ticket = None
        if self.admission is not None:
            # bounded ingress: admit or shed BEFORE the row enters the
            # engine; the ticket holds one slot of the tenant's bounded
            # queue until the response resolves (raises RetryLater)
            tenant = str(payload.get(self.tenant_field) or "default")
            ticket = self.admission.admit(tenant, route=self.route)
        try:
            self._seq += 1
            key = K.ref_scalar("__rest__", id(self), self._seq)
            row = coerce_row(payload, self.schema)
            loop = asyncio.get_running_loop()
            future: asyncio.Future = loop.create_future()
            self.futures[key] = future
            self._events.add(key, row)
            self._events.commit()
            try:
                result = await asyncio.wait_for(future, timeout=120)
            finally:
                self.futures.pop(key, None)
                if self.delete_completed_queries:
                    self._events.remove(key, row)
                    self._events.commit()
        finally:
            if ticket is not None:
                ticket.release()
        return result

    def resolve(self, key: K.Pointer, value: Any) -> None:
        future = self.futures.get(key)
        if future is not None and not future.done():
            loop = future.get_loop()
            loop.call_soon_threadsafe(
                lambda: None if future.done() else future.set_result(value)
            )

    def stop(self) -> None:
        self._closed.set()


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    methods: tuple[str, ...] = ("POST",),
    schema: sch.SchemaMetaclass | None = None,
    autocommit_duration_ms: int | None = 50,
    keep_queries: bool | None = None,
    delete_completed_queries: bool = False,
    request_validator: Callable | None = None,
    documentation: Any = None,
    admission: Any = None,
    tenant_field: str = "tenant",
) -> tuple[Table, Callable[[Table], None]]:
    """Expose an HTTP endpoint as an input table; returns the table and a
    ``response_writer(responses)`` that resolves each request's HTTP response
    from the row in ``responses`` with the same key (column ``result``).

    ``admission`` (optional) is an admission controller (the contract of
    the JAX package's ``serving/admission.py``): each request is admitted
    against the tenant named by ``payload[tenant_field]`` before its row
    enters the engine, and a shed request gets HTTP 429 + ``Retry-After``
    instead of unbounded buffering."""
    if schema is None:
        schema = sch.schema_from_types(query=str)
    if webserver is None:
        webserver = PathwayWebserver(host or "0.0.0.0", port or 8080)
    subject = RestServerSubject(
        webserver,
        route,
        methods,
        schema,
        delete_completed_queries,
        request_validator,
        admission=admission,
        tenant_field=tenant_field,
    )
    table = input_table(subject, schema, name=f"rest:{route}")

    def response_writer(responses: Table) -> None:
        result_col = "result" if "result" in responses._column_names else responses._column_names[-1]

        def on_change(key: K.Pointer, row: dict, time: int, is_addition: bool) -> None:
            if not is_addition:
                return
            subject.resolve(key, fmt_value(row[result_col]))

        subscribe(responses, on_change=on_change, name="rest_response")

    return table, response_writer
