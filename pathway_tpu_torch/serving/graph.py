"""The full live-RAG serving graph: ingest → embed → index → answer.

:class:`RagServingApp` composes the repo's pieces into one servable
system (ROADMAP item 2 / the paper's headline capability):

- **live ingest** runs as engine dataflow: a queue-driven document feed
  (``upsert``/``delete``) flows through a splitter (``pw.apply``) and a
  ``subscribe`` sink that embeds chunks on the SLO scheduler's embed
  lane and upserts them into a churn-safe :class:`SegmentedIndex`
  (delta segments + background merges);
- **queries** are admitted per tenant (:class:`AdmissionController`),
  then travel embed → lookahead retrieve → generate through the
  :class:`StageCoScheduler` — retrieval overlaps generation instead of
  barriering behind it;
- optional **REST ingress** (:meth:`serve_rest`) exposes ``/v1/answer``
  with the admission controller wired into the connector, so overload
  answers 429 + ``Retry-After`` before a row ever enters the engine.

Everything here is dependency-light by design: the default embedder is
a deterministic feature-hashing bag-of-tokens (no model download), the
default generator is extractive — the point is the *serving fabric*
(admission, SLO scheduling, co-scheduling, live index), not model
quality.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any

import numpy as np

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.cluster import WakeupHub
from pathway_tpu_torch.engine.scheduler import Scheduler
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io.python import ConnectorSubject
from pathway_tpu_torch.stdlib.indexing.hnsw import HnswIndex
from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex

from .admission import AdmissionController, TenantPolicy
from .coscheduler import StageCoScheduler
from .scheduler import SloScheduler

__all__ = ["HashingEmbedder", "RagServingApp", "simple_splitter"]


class HashingEmbedder:
    """Deterministic feature-hashed bag-of-tokens embedding (crc32 mod
    dim, L2-normalized).  Same text → same vector, on any machine, with
    zero model weight — exactly what serving tests and benches need."""

    def __init__(self, dim: int = 64):
        self.dim = max(8, int(dim))

    def __call__(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dim, np.float32)
        for token in str(text).lower().split():
            h = zlib.crc32(token.encode("utf-8"))
            vec[h % self.dim] += 1.0 if (h >> 16) & 1 else 0.5
        norm = float(np.linalg.norm(vec))
        if norm > 0:
            vec /= norm
        return vec


def simple_splitter(doc_id: str, text: str, chunk_words: int = 48) -> list[tuple[str, str]]:
    """Word-window splitter: ``[(chunk_id, chunk_text), ...]`` with
    stable ids ``{doc_id}#{i}`` so re-upserts replace their chunks."""
    words = str(text).split()
    if not words:
        return []
    chunks = []
    for i in range(0, len(words), chunk_words):
        chunks.append((f"{doc_id}#{i // chunk_words}", " ".join(words[i : i + chunk_words])))
    return chunks


class _DocFeed(ConnectorSubject):
    """Queue-driven live document source: ``push`` from any thread, the
    reader drains on WakeupHub generation-waits (no polling sleeps)."""

    def __init__(self, hub: WakeupHub):
        super().__init__("serving_docs")
        self._hub = hub
        self._q: list[tuple[str, dict]] = []
        self._qlock = threading.Lock()

    def push(self, op: str, row: dict) -> None:
        with self._qlock:
            self._q.append((op, row))
        self._hub.notify()

    def run(self) -> None:
        while not self.stopped:
            seen = self._hub.seq()
            with self._qlock:
                batch, self._q = self._q, []
            if not batch:
                self._hub.wait(seen, 0.05)
                continue
            for op, row in batch:
                if op == "delete":
                    self._remove(row)
                else:
                    self.next(**row)
            self.commit()


class RagServingApp:
    """One multi-tenant live-RAG serving instance.

    ``policies`` maps tenant name → :class:`TenantPolicy`; unknown
    tenants get ``default_policy``.  ``start()`` builds the dataflow
    into the current global graph and runs the engine scheduler on a
    daemon thread; ``close()`` tears everything down."""

    def __init__(
        self,
        policies: dict[str, TenantPolicy] | None = None,
        *,
        default_policy: TenantPolicy | None = None,
        embed_dim: int = 64,
        k: int = 4,
        chunk_words: int = 48,
        delta_cap: int = 256,
        auto_merge: bool = True,
        index: Any = None,
        embedder: Any = None,
        answerer: Any = None,
        lanes: dict[str, float] | None = None,
        target_ms: dict[str, float] | None = None,
        max_batch: int = 32,
        lookahead: bool = True,
        probe: Any = None,
        autocommit_ms: int = 10,
        shards: int | None = None,
        standby: bool = True,
    ):
        from pathway_tpu_torch import serving as _serving

        self.hub = WakeupHub()
        self.probe = probe if probe is not None else _serving.serving_probe()
        self.admission = AdmissionController(
            policies, default_policy=default_policy, hub=self.hub
        )
        self.embedder = embedder if embedder is not None else HashingEmbedder(embed_dim)
        self.shards = int(shards) if shards else 0
        self.standby = bool(standby)
        if index is not None:
            self.index = index
        elif self.shards >= 2:
            # partial-failure survival: split the corpus across shard
            # owners so one owner's death degrades answers (partial:true
            # over the survivors + snapshot-backed standby) instead of
            # taking the query surface down — serving/failover.py
            from .failover import PartitionedIndex

            dim, cap, merge = self.embedder.dim, delta_cap, auto_merge
            self.index = PartitionedIndex(
                lambda: SegmentedIndex(
                    HnswIndex(dim, metric="cos"),
                    delta_cap=cap,
                    auto_merge=merge,
                ),
                n_shards=self.shards,
                standby=self.standby,
            )
        else:
            self.index = SegmentedIndex(
                HnswIndex(self.embedder.dim, metric="cos"),
                delta_cap=delta_cap,
                auto_merge=auto_merge,
            )
        self.scheduler = SloScheduler(
            lanes=lanes,
            target_ms=target_ms,
            max_batch=max_batch,
            hub=self.hub,
            probe=self.probe,
        )
        self._chunk_texts: dict[str, str] = {}
        self._chunk_lock = threading.Lock()
        self.coscheduler = StageCoScheduler(
            embedder=self.embedder,
            index=self.index,
            doc_text=self._text_of,
            answerer=answerer,
            scheduler=self.scheduler,
            probe=self.probe,
            k=k,
            lookahead=lookahead,
        )
        self.chunk_words = chunk_words
        self.autocommit_ms = autocommit_ms
        self._docs: dict[str, dict] = {}
        self._feed = _DocFeed(self.hub)
        self.sched: Scheduler | None = None
        self._run_thread: threading.Thread | None = None
        self._rest_port: int | None = None
        self.ingested_chunks = 0
        self.removed_chunks = 0

    # ------------------------------------------------------------- dataflow

    def _text_of(self, chunk_id: Any) -> str:
        with self._chunk_lock:
            return self._chunk_texts.get(chunk_id, "")

    def build(self) -> None:
        """Wire the ingest dataflow into the current global graph."""

        class DocSchema(pw.Schema):
            doc_id: str = pw.column_definition(primary_key=True)
            text: str
            tenant: str = pw.column_definition(default_value="default")

        docs = pw.io.python.read(self._feed, schema=DocSchema, name="serving_docs")
        chunk_words = self.chunk_words
        chunked = docs.select(
            chunks=pw.apply(
                lambda d, t: simple_splitter(d, t, chunk_words),
                pw.this.doc_id,
                pw.this.text,
            ),
            tenant=pw.this.tenant,
        )
        sink = subscribe(chunked, on_change=self._on_chunks, name="serving_ingest")
        # analyzer-facing stage annotations: without these the serving
        # pipeline is three opaque nodes and pw.analyze() cannot tell the
        # ingest path from a user graph (the old PW-S001 near-miss), nor
        # see that the sink is a keyed upsert into the live index
        docs._node.meta["serving"] = {
            "stage": "ingest",
            "admission": type(self.admission).__name__,
            "scheduler": type(self.scheduler).__name__,
        }
        chunked._node.meta["serving"] = {
            "stage": "chunk",
            "coscheduler": type(self.coscheduler).__name__,
        }
        sink.meta["serving"] = {"stage": "index-upsert"}
        # chunk ids are stable (doc_id + position) and the feed is a
        # single-reader python connector, so the upsert is order-safe —
        # the annotation lets PW-X001 verify that instead of assuming it
        sink.meta["index_upsert"] = True
        # availability annotation for PW-R002: a sharded index with
        # snapshot-backed standbys keeps answering (degraded) through a
        # shard owner's death; a single-owner index does not, and the
        # analyzer should say so
        sink.meta["failover"] = {
            "standby": self.shards >= 2 and self.standby,
            "shards": self.shards or 1,
        }

    def _on_chunks(self, key: Any, row: dict, time: int, is_addition: bool) -> None:
        chunks = list(row.get("chunks") or ())
        if not chunks:
            return
        tenant = str(row.get("tenant") or "default")
        cls = self.admission.policy(tenant).tenant_class
        if is_addition:
            with self._chunk_lock:
                for cid, text in chunks:
                    self._chunk_texts[cid] = text
            # embed + upsert ride the embed lane under the writer's
            # class: ingest competes with query embedding for device
            # time instead of bypassing the partition
            self.scheduler.submit(
                "embed", cls, self._ingest_batch, item=chunks, coalesce=None
            )
        else:
            # a re-upsert arrives as retraction(old) + addition(new) in
            # unspecified order; the addition path above stores the new
            # chunk text synchronously, so a retracted chunk whose
            # stored text no longer matches has already been superseded
            # — removing it would delete the replacement (the lane add
            # upserts by stable chunk id, so no removal is needed)
            with self._chunk_lock:
                ids = [
                    cid
                    for cid, text in chunks
                    if self._chunk_texts.get(cid) == text
                ]
                for cid in ids:
                    self._chunk_texts.pop(cid, None)
            if ids:
                self.index.remove(ids)
                self.removed_chunks += len(ids)

    def _ingest_batch(self, chunks: list[tuple[str, str]]) -> int:
        pairs = [(cid, self.embedder(text)) for cid, text in chunks]
        self.index.add(pairs)
        self.ingested_chunks += len(pairs)
        return len(pairs)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "RagServingApp":
        self.build()
        self.sched = Scheduler(G.engine_graph, autocommit_ms=self.autocommit_ms)
        self._run_thread = threading.Thread(
            target=self.sched.run, daemon=True, name="serving_engine"
        )
        self._run_thread.start()
        return self

    def close(self) -> None:
        if self.sched is not None:
            self.sched.stop()
        if self._run_thread is not None:
            self._run_thread.join(5.0)
        self.coscheduler.close()
        self.scheduler.close()
        close = getattr(self.index, "close", None)
        if close is not None:
            close()

    # -------------------------------------------------------------- writes

    def upsert(self, doc_id: str, text: str, tenant: str = "default") -> None:
        row = {"doc_id": str(doc_id), "text": str(text), "tenant": str(tenant)}
        self._docs[row["doc_id"]] = row
        self._feed.push("upsert", row)

    def delete(self, doc_id: str) -> None:
        row = self._docs.pop(str(doc_id), None)
        if row is not None:
            self._feed.push("delete", row)

    def wait_indexed(self, n_chunks: int, timeout: float = 10.0) -> bool:
        """Generation-wait until at least ``n_chunks`` live in the index."""
        import time as _t

        deadline = _t.monotonic() + timeout
        while True:
            seen = self.hub.seq()
            if len(self.index) >= n_chunks:
                return True
            remaining = deadline - _t.monotonic()
            if remaining <= 0:
                return len(self.index) >= n_chunks
            self.hub.wait(seen, min(remaining, 0.05))

    # ------------------------------------------------------------- queries

    def submit_query(self, query: str, tenant: str = "default", k: int | None = None):
        """Admit + co-schedule one query; returns a Future.  Raises
        ``RetryLater`` when the tenant is over its rate or queue bound.

        Tracing starts HERE: the request's trace context is born before
        admission and rides the request object through every stage — the
        response dict carries its ``trace_id`` back out."""
        trace = _tracing.new_trace()
        t0_ns = _tracing.now_ns()
        ticket = self.admission.admit(tenant, route="/v1/answer")
        _tracing.record_span(
            "admit", t0_ns, _tracing.now_ns(), ctx=trace,
            args={"tenant": tenant},
        )
        try:
            fut = self.coscheduler.submit(
                query, tenant_class=ticket.tenant_class, k=k, trace=trace
            )
        except BaseException:
            ticket.release()
            raise
        fut.add_done_callback(lambda _f: ticket.release())
        return fut

    def answer(
        self, query: str, tenant: str = "default", k: int | None = None, timeout: float = 30.0
    ) -> dict:
        return self.submit_query(query, tenant, k).result(timeout=timeout)

    # ---------------------------------------------------------------- REST

    def serve_rest(self, host: str = "127.0.0.1", port: int = 8080) -> None:
        """Register ``/v1/answer`` on a webserver with admission wired
        into the ingress (must be called before :meth:`start`)."""
        import asyncio

        from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer

        class AnswerSchema(pw.Schema):
            query: str
            tenant: str = pw.column_definition(default_value="default")
            k: int = pw.column_definition(default_value=0)

        queries, writer = pw.io.http.rest_connector(
            host=host,
            port=port,
            route="/v1/answer",
            schema=AnswerSchema,
            delete_completed_queries=False,
            admission=self.admission,
            tenant_field="tenant",
        )
        app = self

        class AnswerTransformer(AsyncTransformer):
            output_schema = pw.schema_from_types(result=dict)

            async def invoke(self, query: str, tenant: str, k: int) -> dict:
                cls = app.admission.policy(str(tenant)).tenant_class
                fut = app.coscheduler.submit(
                    str(query), tenant_class=cls, k=int(k) or None
                )
                result = await asyncio.wait_for(
                    asyncio.wrap_future(fut), timeout=30
                )
                return {"result": result}

        writer(AnswerTransformer(input_table=queries).successful)
        self._rest_port = port

    # -------------------------------------------------------------- status

    def stats(self) -> dict[str, Any]:
        return {
            "admission": self.admission.stats(),
            "scheduler": self.scheduler.stats(),
            "coscheduler": self.coscheduler.stats(),
            "index": self.index.stats() if hasattr(self.index, "stats") else {},
            "ingested_chunks": self.ingested_chunks,
            "removed_chunks": self.removed_chunks,
        }
