"""``pw.AsyncTransformer`` — fully decoupled async row transformation
(reference ``stdlib/utils/async_transformer.py:61-400``).

Mechanism mirrors the reference's loopback: subscribe to the input
table, run ``invoke`` on an event loop with capacity/retry/cache
wrappers, and re-ingest results through a python connector.  Results
arrive at LATER epochs than their inputs (fully asynchronous); failed
rows carry ``_async_status == "-FAILURE-"`` and are dropped from
``.successful``.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import threading
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.udfs import (
    AsyncRetryStrategy,
    CacheStrategy,
    coerce_async,
    with_cache_strategy,
    with_capacity,
    with_retry_strategy,
)

__all__ = ["AsyncTransformer"]

_SUCCESS = "-SUCCESS-"
_FAILURE = "-FAILURE-"


class _LoopbackSubject:
    """The python-connector re-entry point (reference ``_AsyncConnector``).

    ``pending_count`` is the scheduler's completion protocol: the run may
    only end when it reports 0 (queued + in-flight work); the in-flight
    counter is incremented BEFORE dequeueing so the count never transiently
    dips while an item moves between the queue and a task."""

    def __init__(self, transformer: "AsyncTransformer"):
        self.transformer = transformer

    def pending_count(self) -> int:
        t = self.transformer
        return t._queue.qsize() + t._inflight

    def run(self, events: Any) -> None:
        t = self.transformer
        loop = asyncio.new_event_loop()
        t._loop = loop

        async def main() -> None:
            done = False
            while True:
                if (done or events.stopped) and t._inflight == 0 and t._queue.empty():
                    return
                t._inflight += 1
                try:
                    item = t._queue.get_nowait()
                except _queue.Empty:
                    t._inflight -= 1
                    await asyncio.sleep(0.02)
                    continue
                if item is None:
                    t._inflight -= 1
                    done = True
                    continue
                kind, key, row = item
                # per-key ordering (reference _AsyncConnector's consistency
                # buffers): each add gets a sequence number; only the LATEST
                # version of a key may emit, so a remove or re-add arriving
                # while an older invoke is in flight supersedes it
                t._seq += 1
                t._latest[key] = t._seq
                if kind == "remove":
                    cached = t._results.pop(key, None)
                    if cached is not None:
                        events.remove(key, cached)
                        events.commit()
                    t._inflight -= 1
                    continue

                async def work(key=key, row=row, myseq=t._seq) -> None:
                    try:
                        result = await t._invoke(**row)
                        if not isinstance(result, dict):
                            raise TypeError("invoke() must return a dict")
                        values = tuple(
                            result.get(c) for c in t._out_value_cols
                        ) + (_SUCCESS,)
                    except Exception:  # noqa: BLE001
                        values = tuple(None for _ in t._out_value_cols) + (_FAILURE,)
                    if t._latest.get(key) == myseq:
                        old = t._results.get(key)
                        if old is not None:
                            events.remove(key, old)
                        t._results[key] = values
                        events.add(key, values)
                        events.commit()
                    t._inflight -= 1  # AFTER the result is in the queue

                loop.create_task(work())

        loop.run_until_complete(main())


class AsyncTransformer:
    """Subclass and define ``async def invoke(self, **row) -> dict``
    returning values for ``output_schema`` (reference ``:282``)."""

    output_schema: sch.SchemaMetaclass | None = None

    def __init__(
        self,
        input_table: Table,
        *,
        instance: Any = None,
        autocommit_duration_ms: int | None = 100,
    ):
        assert self.output_schema is not None, "set output_schema"
        self._input = input_table
        self._queue: _queue.Queue = _queue.Queue()
        self._results: dict[Any, tuple] = {}
        self._inflight = 0
        self._seq = 0
        self._latest: dict[Any, int] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._out_value_cols = list(self.output_schema.column_names())
        self._invoke = coerce_async(self.invoke)
        self._capacity: int | None = None
        self._retry: AsyncRetryStrategy | None = None
        self._cache: CacheStrategy | None = None

        cols = input_table.column_names()
        pw.io.subscribe(
            input_table,
            on_change=lambda key, row, time, is_addition: self._queue.put(
                ("add" if is_addition else "remove", key, dict(row))
            ),
            on_end=lambda: self._queue.put(None),
            name="async_transformer_in",
        )

        full_schema = sch.schema_from_columns(
            {
                **self.output_schema.columns(),
                "_async_status": sch.ColumnDefinition(name="_async_status"),
            },
            name="AsyncTransformerOutput",
        )
        from pathway_tpu_torch.io._connector import input_table as make_input

        self._result_table = make_input(
            _LoopbackSubject(self),
            full_schema,
            name="async_transformer_out",
            auxiliary=True,
        )

    async def invoke(self, **kwargs: Any) -> dict:  # pragma: no cover
        raise NotImplementedError

    # -- composable options (reference with_options) --------------------
    def with_options(
        self,
        capacity: int | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        cache_strategy: CacheStrategy | None = None,
        timeout: float | None = None,
    ) -> "AsyncTransformer":
        fun = coerce_async(self.invoke)
        if retry_strategy is not None:
            fun = with_retry_strategy(fun, retry_strategy)
        if cache_strategy is not None:
            fun = with_cache_strategy(fun, cache_strategy)
        if capacity is not None:
            fun = with_capacity(fun, capacity)
        self._invoke = fun
        return self

    # -- result tables ---------------------------------------------------
    @property
    def output_table(self) -> Table:
        return self._result_table

    @property
    def successful(self) -> Table:
        ok = self._result_table.filter(pw.this["_async_status"] == _SUCCESS)
        return ok.select(
            **{c: ok[c] for c in self._out_value_cols}
        )

    @property
    def failed(self) -> Table:
        return self._result_table.filter(pw.this["_async_status"] == _FAILURE)
