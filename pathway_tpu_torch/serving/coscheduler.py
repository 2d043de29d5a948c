"""Stage co-scheduler: overlap retrieval with generation (lookahead).

A lockstep RAG pipeline runs embed → retrieve → generate as barriers:
the index sits idle while the generator works and vice versa.  TeleRAG
(PAPERS.md) shows the win from *lookahead retrieval* — fire the index
probe speculatively as soon as the query embedding exists, while the
generation stage of the previous request is still busy; HedraRAG makes
the general case: co-schedule heterogeneous RAG stages instead of
serializing them.  :class:`StageCoScheduler` implements that shape:

- **embed** runs on the SLO scheduler's ``embed`` lane (coalescable, so
  concurrent queries share one batched embedding call);
- **retrieve** runs on the ``search`` lane and only *dispatches* the
  probe (:meth:`SegmentedIndex.dispatch` — an async device launch), then
  parks the request in the generation queue.  The probe is in flight on
  the device while the request waits behind the previous generation —
  that wait is the overlap the lookahead buys;
- **generate** runs on a dedicated worker thread (modeling the
  generation stream): it *collects* the already-running probe, reranks,
  and answers.

Every queue handoff is WakeupHub-notified with finite waits (LK006);
per-request latencies land in the serving
:class:`~pathway_tpu_torch.internals.monitoring.LabeledLatencyProbe` under the
request's tenant class.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable

from pathway_tpu_torch.internals import tracing as _tracing

from .scheduler import SloScheduler

__all__ = ["StageCoScheduler", "extractive_answerer"]


def extractive_answerer(query: str, docs: list[dict]) -> str:
    """Dependency-free default generator: extractive answer from the top
    retrieved chunk (keeps the serving pipeline runnable without an LLM)."""
    if not docs:
        return f"no context found for: {query}"
    top = docs[0]
    return f"[{top.get('id')}] {str(top.get('text', ''))[:240]}"


class _Req:
    __slots__ = (
        "query",
        "k",
        "tenant_class",
        "future",
        "t0_ns",
        "t_embed_ns",
        "t_dispatch_ns",
        "t_dispatch_done_ns",
        "t_collect_ns",
        "t_collect_done_ns",
        "t_genq_ns",
        "payload",
        "coverage",
        "trace",
    )

    def __init__(
        self,
        query: str,
        k: int,
        tenant_class: str,
        future: Future,
        t0_ns: int,
        trace: Any = None,
    ):
        self.query = query
        self.k = k
        self.tenant_class = tenant_class
        self.future = future
        self.t0_ns = t0_ns
        self.t_embed_ns = 0
        self.t_dispatch_ns = 0
        self.t_dispatch_done_ns = 0
        self.t_collect_ns = 0
        self.t_collect_done_ns = 0
        self.t_genq_ns = 0
        self.payload: Any = None
        # (partial, shards_answered, shards_total) — the partial-result
        # contract, read off the index probe handle after collect
        self.coverage: tuple[bool, int, int] = (False, 1, 1)
        #: the request's TraceContext, born at admission and carried
        #: through every stage hop (threads change; the context doesn't)
        self.trace = trace


class StageCoScheduler:
    """embed → (speculative retrieve) → generate, stages overlapped."""

    def __init__(
        self,
        *,
        embedder: Callable[[str], Any],
        index: Any,
        doc_text: Callable[[Any], str] | None = None,
        answerer: Callable[[str, list[dict]], str] | None = None,
        scheduler: SloScheduler | None = None,
        probe: Any = None,
        k: int = 4,
        lookahead: bool = True,
        gen_queue_cap: int = 1024,
        idle_wait_s: float = 0.05,
    ):
        self.embedder = embedder
        self.index = index
        self.doc_text = doc_text or (lambda key: str(key))
        self.answerer = answerer or extractive_answerer
        self.probe = probe
        self.default_k = max(1, int(k))
        self.lookahead = bool(lookahead)
        self.gen_queue_cap = max(1, int(gen_queue_cap))
        self._idle_wait_s = idle_wait_s
        self.scheduler = scheduler if scheduler is not None else SloScheduler(probe=probe)
        self.hub = self.scheduler.hub
        self._gen_q: deque[_Req] = deque()  # lk009: capped at gen_queue_cap
        self._gen_lock = threading.Lock()
        self._stop = threading.Event()
        # lookahead accounting: how often the probe was already in
        # flight when generation picked the request up, and for how long
        self.lookahead_probes = 0
        self.overlap_ns_total = 0
        self.completed = 0
        self.failed = 0
        #: responses served with partial shard coverage (degraded, not
        #: failed — the partial-result contract)
        self.degraded_responses = 0
        self._gen_thread = threading.Thread(
            target=self._gen_loop, daemon=True, name="serving_generate"
        )
        self._gen_thread.start()
        from pathway_tpu_torch import serving as _serving

        _serving._register_coscheduler(self)

    # -------------------------------------------------------------- submit

    def submit(
        self,
        query: str,
        tenant_class: str = "interactive",
        k: int | None = None,
        trace: Any = None,
    ) -> Future:
        """Returns a Future resolving to ``{"answer", "docs", ...}``.
        ``trace`` continues the caller's trace (the admission layer's);
        without one a fresh trace is opened so every response carries a
        ``trace_id``."""
        fut: Future = Future()
        if trace is None:
            trace = _tracing.new_trace()
        req = _Req(
            str(query),
            k if k is not None else self.default_k,
            tenant_class,
            fut,
            time.monotonic_ns(),
            trace,
        )
        efut = self.scheduler.submit(
            "embed", tenant_class, self._embed_batch, item=req.query,
            coalesce="query_embed", trace=trace,
        )
        efut.add_done_callback(lambda f: self._after_embed(f, req))
        return fut

    def _embed_batch(self, queries: list[str]) -> list[Any]:
        return [self.embedder(q) for q in queries]

    def _after_embed(self, efut: Future, req: _Req) -> None:
        exc = efut.exception(timeout=0)
        if exc is not None:
            self._fail(req, exc)
            return
        req.t_embed_ns = time.monotonic_ns()
        if self.probe is not None:
            self.probe.record(
                "serve_embed", req.tenant_class, req.t_embed_ns - req.t0_ns
            )
        vec = efut.result(timeout=0)
        rfut = self.scheduler.submit(
            "search", req.tenant_class, self._retrieve, item=(req, vec),
            trace=req.trace,
        )
        rfut.add_done_callback(lambda f: self._after_retrieve(f, req))

    def _retrieve(self, req_vec: tuple[_Req, Any]) -> Any:
        """Search-lane stage: fire the probe, do NOT wait for results."""
        req, vec = req_vec
        dispatch = getattr(self.index, "dispatch", None)
        if self.lookahead and dispatch is not None:
            req.t_dispatch_ns = time.monotonic_ns()
            handle = dispatch(vec, req.k)
            req.t_dispatch_done_ns = time.monotonic_ns()
            return ("handle", handle)
        req.t_dispatch_ns = time.monotonic_ns()
        hits = self.index.search(vec, req.k)
        req.t_dispatch_done_ns = time.monotonic_ns()
        return ("hits", hits)

    def _after_retrieve(self, rfut: Future, req: _Req) -> None:
        exc = rfut.exception(timeout=0)
        if exc is not None:
            self._fail(req, exc)
            return
        req.payload = rfut.result(timeout=0)
        req.t_genq_ns = time.monotonic_ns()
        overflow = False
        with self._gen_lock:
            if len(self._gen_q) >= self.gen_queue_cap:
                overflow = True
            else:
                self._gen_q.append(req)
        if overflow:
            # bounded handoff even past admission (belt and suspenders):
            # fail loudly instead of buffering without limit
            self._fail(req, RuntimeError("generation queue full"))
            return
        self.hub.notify()

    # ------------------------------------------------------------ generate

    def _gen_loop(self) -> None:
        while not self._stop.is_set():
            seen = self.hub.seq()
            with self._gen_lock:
                req = self._gen_q.popleft() if self._gen_q else None
            if req is None:
                self.hub.wait(seen, self._idle_wait_s)
                continue
            self._generate(req)

    def _resolve_hits(self, req: _Req) -> list[tuple[Any, float]]:
        kind, value = req.payload
        if kind == "hits":
            return value[0] if value else []
        t_collect = req.t_collect_ns = time.monotonic_ns()
        # ambient for the index's own spans (collect_segments /
        # collect_shard parent onto the request trace, not trace 0)
        prev_ctx = _tracing.set_ambient(req.trace)
        try:
            hits = self.index.collect(value)
        finally:
            _tracing.set_ambient(prev_ctx)
        req.t_collect_done_ns = time.monotonic_ns()
        # the probe handle carries shard coverage after collect (identity
        # 1/1 for a single index; real health for a PartitionedIndex)
        req.coverage = (
            bool(getattr(value, "partial", False)),
            int(getattr(value, "shards_answered", 1)),
            int(getattr(value, "shards_total", 1)),
        )
        if req.t_dispatch_ns:
            self.lookahead_probes += 1
            self.overlap_ns_total += t_collect - req.t_dispatch_ns
        return hits[0] if hits else []

    def _generate(self, req: _Req) -> None:
        try:
            t_hits_start = req.t_embed_ns or req.t0_ns
            t_pick = time.monotonic_ns()
            hits = self._resolve_hits(req)
            t_hits = time.monotonic_ns()
            docs = [
                {"id": key, "score": float(score), "text": self.doc_text(key)}
                for key, score in hits
            ]
            t_gen = time.monotonic_ns()
            answer = self.answerer(req.query, docs)
            t_done = time.monotonic_ns()
            if self.probe is not None:
                cls = req.tenant_class
                self.probe.record("serve_retrieve", cls, t_hits - t_hits_start)
                self.probe.record("serve_generate", cls, t_done - t_hits)
                self.probe.record("serve_e2e", cls, t_done - req.t0_ns)
            self.completed += 1
            partial, answered, total = req.coverage
            if partial:
                self.degraded_responses += 1
            if _tracing.enabled():
                # materialize the whole request's spans in ONE call from
                # the timestamps stamped along the way — per-stage record
                # calls are measurable at this request rate
                spans = []
                if req.t_embed_ns:
                    spans.append(("serve_embed", req.t0_ns, req.t_embed_ns, None))
                if req.t_dispatch_done_ns:
                    stage = "dispatch" if req.payload[0] == "handle" else "search"
                    spans.append(
                        (stage, req.t_dispatch_ns, req.t_dispatch_done_ns, None)
                    )
                if req.t_collect_done_ns:
                    spans.append(
                        ("collect", req.t_collect_ns, req.t_collect_done_ns, None)
                    )
                if req.t_genq_ns:
                    # time parked in the generation queue behind the
                    # previous request — queue-wait, not service time
                    spans.append(("gen_queue_wait", req.t_genq_ns, t_pick, None))
                spans.append(("generate", t_gen, t_done, None))
                # the whole request as one root-level span, then
                # tail-keep: a request over the tail threshold survives
                # head sampling
                spans.append(
                    ("serve_e2e", req.t0_ns, t_done,
                     {"class": req.tenant_class})
                )
                _tracing.record_spans(req.trace, spans)
                _tracing.finish_request(req.trace, t_done)
            if not req.future.done():
                req.future.set_result(
                    {
                        "answer": answer,
                        "docs": docs,
                        "tenant_class": req.tenant_class,
                        "latency_ms": (t_done - req.t0_ns) / 1e6,
                        # partial-result contract: a response over a
                        # degraded corpus says so instead of erroring
                        "partial": partial,
                        "shards_answered": answered,
                        "shards_total": total,
                        # the causal timeline's key: look this id up in a
                        # flight-recorder dump / /debug/trace export
                        "trace_id": (
                            req.trace.trace_id if req.trace is not None else 0
                        ),
                    }
                )
        except BaseException as e:  # noqa: BLE001 — fault goes to the caller
            self._fail(req, e)

    def _fail(self, req: _Req, exc: BaseException) -> None:
        self.failed += 1
        if not req.future.done():
            req.future.set_exception(exc)

    # --------------------------------------------------------------- admin

    def stats(self) -> dict[str, Any]:
        with self._gen_lock:
            queued = len(self._gen_q)
        n = max(1, self.lookahead_probes)
        return {
            "completed": self.completed,
            "failed": self.failed,
            "degraded_responses": self.degraded_responses,
            "gen_queued": queued,
            "lookahead_probes": self.lookahead_probes,
            "overlap_ms_total": self.overlap_ns_total / 1e6,
            "overlap_ms_mean": self.overlap_ns_total / n / 1e6,
        }

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.hub.notify()
        self._gen_thread.join(timeout)
        with self._gen_lock:
            leftovers = list(self._gen_q)
            self._gen_q.clear()
        for req in leftovers:
            self._fail(req, RuntimeError("coscheduler closed"))
