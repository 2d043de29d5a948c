"""Epoch scheduler: the engine main loop, single- and multi-worker.

Equivalent of the reference worker main loop (``run_with_new_dataflow_graph``
+ ``step_or_park`` + pollers/flushers, ``src/engine/dataflow.rs:5506-5717``):
drains connector event queues, cuts consistent epochs (micro-batches), and
propagates update batches through the node graph in topological order.

Consistency contract: outputs observe only closed epochs — within an epoch
every operator sees the complete batch, so downstream tables are always a
consistent snapshot (same guarantee the reference gets from timely frontiers).

Multi-worker mode (reference ``PATHWAY_THREADS`` × ``PATHWAY_PROCESSES``,
``src/engine/dataflow/config.rs:86-120``): every worker runs the identical
node list over its own :class:`RunContext`; at stateful operators the epoch
batch is exchanged by a stable key hash (``Node.exchange_routes``) so each
worker owns a disjoint state shard.  Epoch cuts are agreed by an allgather
of worker statuses + an identical pure decision function — the epoch-
synchronous analogue of timely progress tracking.
"""

from __future__ import annotations

import os as _os
import queue
import threading
import time as _time
from collections import defaultdict, deque
from typing import Any, Callable

from pathway_tpu_torch.engine.cluster import Cluster, epoch_trace_context
from pathway_tpu_torch.engine.columnar import ColumnarBatch, extend_batch
from pathway_tpu_torch.engine.graph import EngineGraph, InputNode, Node, RunContext
from pathway_tpu_torch.engine.stream import TIME_STEP, Batch, Update
from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import native as _native
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.internals.keys import Pointer

def _build_adds(rows: Any) -> list:
    """Bulk ``Update(key, values, +1)`` construction (static-row injection
    is a million-row listcomp of NamedTuple calls in big debug tables)."""
    native = _native.load()
    if native is not None:
        try:
            return native.build_adds(rows, Update)
        except Exception:
            pass
    return [Update(k, v, 1) for k, v in rows]


#: dev knob: per-round cluster trace on stderr (timing the epoch loop)
_EPOCH_TRACE = _os.environ.get("PATHWAY_EPOCH_TRACE") == "1"

#: entries sampled per container level when measuring operator state
_STATE_SAMPLE = 24


def approx_state_bytes(obj: Any, depth: int = 5) -> int:
    """Sampled deep size of an operator's state: containers extrapolate
    from their first ``_STATE_SAMPLE`` entries (state dicts are
    homogeneous — groups, kept rows, join sides), numpy buffers report
    ``nbytes``.  Bounds the per-sample cost regardless of state size;
    feeds ``pathway_tpu_state_bytes{operator}`` next to the static
    estimate for cross-validation."""
    import sys

    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        try:
            return int(nb) + 16
        except (TypeError, ValueError):
            pass
    try:
        base = sys.getsizeof(obj)
    except TypeError:
        return 64
    if depth <= 0:
        return base
    if isinstance(obj, dict):
        n = len(obj)
        if not n:
            return base
        tot = k = 0
        for key, val in obj.items():
            tot += approx_state_bytes(key, depth - 1)
            tot += approx_state_bytes(val, depth - 1)
            k += 1
            if k >= _STATE_SAMPLE:
                break
        return base + int(tot / k * n)
    if isinstance(obj, (list, tuple, set, frozenset)):
        n = len(obj)
        if not n:
            return base
        tot = k = 0
        for val in obj:
            tot += approx_state_bytes(val, depth - 1)
            k += 1
            if k >= _STATE_SAMPLE:
                break
        return base + int(tot / k * n)
    return base


#: default bound on bytes buffered between the connector readers and the
#: epoch drain (PATHWAY_INGEST_BUFFER_BYTES); <= 0 disables accounting
DEFAULT_INGEST_BUFFER_BYTES = 256 << 20

#: per-connector overflow policies (input_table(on_overflow=...))
INGEST_OVERFLOW_MODES = ("pause", "shed_oldest", "fail")


class IngestOverflow(RuntimeError):
    """Raised into the reader thread when its source overflows the ingest
    buffer under ``on_overflow="fail"`` (the supervisor applies the
    connector's recovery policy to it like any other reader failure)."""


def _approx_event_bytes(kind: str, key: Any, values: Any) -> int:
    """Cheap buffered-size estimate of one queue item.  Batch items hold
    the built Update list in ``key``; sampled sizing extrapolates, so a
    million-row chunk costs a bounded probe, not a deep walk."""
    if kind == "batch":
        return approx_state_bytes(key, depth=3) + 64
    if kind == "frame":
        native = _native.load()
        return (native.frame_nbytes(key) if native is not None else 0) + 64
    return approx_state_bytes(values, depth=2) + 96


class IngestCredit:
    """Bytes-accounted admission for the connector -> scheduler queue.

    One instance per scheduler, shared by every source: readers *charge*
    each data item before enqueueing it and the drain loops *consume* it
    when it leaves the queue, so the un-drained backlog is bounded by
    ``capacity_bytes`` end to end.  Overflow behaviour is per source:

    - ``"pause"`` (default): the reader thread parks in finite wait
      slices until the drain frees room — native backpressure, no loss.
      A paused source is flagged in its connector stats so the
      supervisor's watchdog does not mistake backpressure for a hang.
    - ``"shed_oldest"``: the source's oldest *buffered* items are
      uncharged immediately (a shed floor advances past them) and the
      drain discards them when it reaches them — counted shed, never
      silent loss.
    - ``"fail"``: raises :class:`IngestOverflow` into the reader.

    All waits are finite condition slices re-checking the stop event, so
    shutdown always interrupts a paused reader."""

    _WAIT_SLICE_S = 0.05

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self._cv = threading.Condition()
        #: per-source FIFO of (seq, bytes, rows) still in the queue
        self._entries: dict[int, deque] = {}
        self._next_seq: dict[int, int] = {}
        #: items with seq < floor were shed; the drain skips them
        self._floor: dict[int, int] = {}
        self._bytes: dict[int, int] = {}
        self._rows: dict[int, int] = {}
        self._total = 0
        self.stalls_total = 0
        self.stall_ms_total = 0.0
        self.shed_rows: dict[int, int] = {}
        self.shed_bytes: dict[int, int] = {}
        self._paused: set[int] = set()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def level(self) -> float:
        """Buffer occupancy in [0, 1] — the engine's ingest-pressure
        signal (pushed to serving brownout when the gap is material)."""
        if self.capacity <= 0:
            return 0.0
        return min(1.0, self._total / self.capacity)

    def charge(
        self,
        node_id: int,
        nbytes: int,
        nrows: int,
        on_overflow: str,
        stop_event: threading.Event | None,
        stats: dict | None = None,
    ) -> int:
        """Admit one data item; returns its sequence number.  May block
        (pause), advance the shed floor (shed_oldest), or raise
        (:class:`IngestOverflow`, fail)."""
        t0 = _time.monotonic()
        stalled = False
        with self._cv:
            while (
                self._total > 0
                and self._total + nbytes > self.capacity
                and not (stop_event is not None and stop_event.is_set())
            ):
                if on_overflow == "fail":
                    raise IngestOverflow(
                        f"source {node_id} overflowed the ingest buffer "
                        f"({self._total + nbytes} > {self.capacity} bytes; "
                        f"PATHWAY_INGEST_BUFFER_BYTES)"
                    )
                if on_overflow == "shed_oldest":
                    if not self._shed_locked(node_id, nbytes):
                        break  # nothing of ours left to shed: admit over
                    continue
                # pause: finite slices; the drain's consume notifies
                if not stalled:
                    stalled = True
                    self.stalls_total += 1
                    self._paused.add(node_id)
                    if stats is not None:
                        stats["paused"] = True
                        stats["pauses"] = stats.get("pauses", 0) + 1
                self._cv.wait(self._WAIT_SLICE_S)
            if stalled:
                self._paused.discard(node_id)
                if stats is not None:
                    stats["paused"] = False
                self.stall_ms_total += (_time.monotonic() - t0) * 1e3
            seq = self._next_seq.get(node_id, 0)
            self._next_seq[node_id] = seq + 1
            self._entries.setdefault(node_id, deque()).append(
                (seq, nbytes, nrows)
            )
            self._bytes[node_id] = self._bytes.get(node_id, 0) + nbytes
            self._rows[node_id] = self._rows.get(node_id, 0) + nrows
            self._total += nbytes
            return seq

    def _shed_locked(self, node_id: int, need: int) -> bool:
        """Uncharge this source's oldest buffered items until ``need``
        bytes fit (or nothing of ours is left); the floor marks them for
        the drain to discard.  Returns True if anything was shed."""
        entries = self._entries.get(node_id)
        if not entries:
            return False
        shed_any = False
        while entries and self._total + need > self.capacity:
            seq, nbytes, nrows = entries.popleft()
            self._floor[node_id] = seq + 1
            self._bytes[node_id] -= nbytes
            self._rows[node_id] -= nrows
            self._total -= nbytes
            self.shed_rows[node_id] = self.shed_rows.get(node_id, 0) + nrows
            self.shed_bytes[node_id] = (
                self.shed_bytes.get(node_id, 0) + nbytes
            )
            shed_any = True
        return shed_any

    def consume(self, node_id: int, seq: int) -> bool:
        """Called by the drain when an item leaves the queue; False means
        the item was shed (the drain discards it without processing)."""
        with self._cv:
            if seq < self._floor.get(node_id, 0):
                return False  # shed: bytes already uncharged
            entries = self._entries.get(node_id)
            if entries and entries[0][0] == seq:
                _s, nbytes, nrows = entries.popleft()
                self._bytes[node_id] -= nbytes
                self._rows[node_id] -= nrows
                self._total -= nbytes
                self._cv.notify_all()  # room freed: wake paused readers
            return True

    def snapshot(self) -> dict[int, dict]:
        """Per-source occupancy + shed counters (node-id keyed; the
        scheduler maps ids to input names for /metrics)."""
        with self._cv:
            out: dict[int, dict] = {}
            for nid in set(self._bytes) | set(self.shed_rows):
                out[nid] = {
                    "rows": self._rows.get(nid, 0),
                    "bytes": self._bytes.get(nid, 0),
                    "shed_rows": self.shed_rows.get(nid, 0),
                    "shed_bytes": self.shed_bytes.get(nid, 0),
                    "paused": nid in self._paused,
                }
            return out

    def totals(self) -> dict[str, Any]:
        with self._cv:
            return {
                "capacity_bytes": self.capacity,
                "buffered_bytes": self._total,
                "buffered_rows": sum(self._rows.values()),
                "stalls_total": self.stalls_total,
                "stall_ms_total": round(self.stall_ms_total, 3),
                "shed_rows_total": sum(self.shed_rows.values()),
                "paused_sources": len(self._paused),
                "level": self.level(),
            }


def _buffer_frame(buffers: dict, nid: int, cap: Any) -> None:
    """Append a native frame to a per-source drain buffer, promoting the
    plain row list to a :class:`ColumnarBatch` on first frame arrival."""
    buf = buffers[nid]
    if not isinstance(buf, ColumnarBatch):
        buf = ColumnarBatch.from_rows(buf)
        buffers[nid] = buf
    buf.append_frame(cap)


class ConnectorEvents:
    """Callback bundle handed to a connector subject's reader thread.

    Every event carries a monotonic enqueue timestamp (5th tuple element)
    so the scheduler's drain can measure queue residency (the "ingest"
    latency stage), and every enqueue fires the optional ``wake`` hook —
    in cluster mode that is the :class:`~pathway_tpu_torch.engine.cluster.
    WakeupHub`, so a parked worker loop reacts to arrival instead of
    discovering it on the next poll tick."""

    #: with persistence, the number of already-replayed events this reader
    #: should skip (cooperative resume; see pathway_tpu_torch.persistence)
    resume_offset: int = 0

    def __init__(
        self,
        q: "queue.Queue",
        node_id: int,
        stop_event: threading.Event | None = None,
        stats: dict | None = None,
        now_ns: Callable[[], int] | None = None,
        wake: Callable[[], None] | None = None,
        credit: "IngestCredit | None" = None,
        on_overflow: str | None = None,
    ):
        self._q = q
        self._node_id = node_id
        self._stop_event = stop_event
        self._now_ns = now_ns if now_ns is not None else _time.monotonic_ns
        self._wake = wake
        self._credit = credit if credit is not None and credit.enabled else None
        self._on_overflow = on_overflow or "pause"
        #: per-connector counters (reference src/connectors/monitoring.rs);
        #: approximate under concurrent readers — monitoring only
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("rows", 0)
        self.stats.setdefault("retractions", 0)
        self.stats.setdefault("commits", 0)
        self.stats.setdefault("closed", False)

    @property
    def stopped(self) -> bool:
        """True once the scheduler is shutting down; readers should return."""
        return self._stop_event is not None and self._stop_event.is_set()

    def _put(self, kind: str, key: Any, values: Any) -> None:
        seq = None
        if self._credit is not None and kind in ("add", "remove", "batch", "frame"):
            if kind == "batch":
                nrows = len(key)
            elif kind == "frame":
                nrows = _native.load().frame_len(key)
            else:
                nrows = 1
            seq = self._credit.charge(
                self._node_id,
                _approx_event_bytes(kind, key, values),
                nrows,
                self._on_overflow,
                self._stop_event,
                self.stats,
            )
        self._q.put(
            (self._node_id, kind, key, values, self._now_ns(), seq)
        )
        if self._wake is not None:
            self._wake()

    def add(self, key: Pointer, values: tuple) -> None:
        self.stats["rows"] += 1
        self._put("add", key, values)

    def remove(self, key: Pointer, values: tuple) -> None:
        self.stats["retractions"] += 1
        self._put("remove", key, values)

    def add_many(self, rows: list) -> None:
        """Chunked ingest: ``rows`` is a list of (key, values) additions
        delivered as ONE queue item — fast readers (file scan, bulk
        backfill) pay the queue lock per chunk, not per row.  Update
        construction happens here, on the READER thread, overlapping the
        scheduler's epoch work."""
        if rows:
            self.stats["rows"] += len(rows)
            self._put("batch", _build_adds(rows), None)

    def add_frame(self, cap: Any) -> None:
        """Columnar ingest: one native frame (contiguous typed columns +
        interned string pool, lazy row keys) delivered as ONE queue item.
        The frame stays columnar through the drain, routing, and the
        frame-aware operators — no per-row Update objects are built
        unless a downstream operator falls back to the row path."""
        native = _native.load()
        n = native.frame_len(cap)
        if n:
            self.stats["rows"] += n
            self._put("frame", cap, None)

    def commit(self) -> None:
        self.stats["commits"] += 1
        self._put("commit", None, None)

    def close(self) -> None:
        self.stats["closed"] = True
        self._put("close", None, None)


class Scheduler:
    def __init__(
        self,
        graph: EngineGraph,
        *,
        autocommit_ms: int = 50,
        n_workers: int = 1,
        worker_id: int = 0,
    ):
        self.graph = graph
        self.autocommit_ms = autocommit_ms
        self.consumers: dict[int, list[tuple[Node, int]]] = defaultdict(list)
        for node in graph.nodes:
            for port, inp in enumerate(node.inputs):
                self.consumers[inp.id].append((node, port))
        self.ctx = RunContext(n_workers=n_workers, worker_id=worker_id)
        from pathway_tpu_torch.engine.graph import ErrorLogNode

        self._has_error_sink = any(
            isinstance(n, ErrorLogNode) for n in graph.nodes
        )
        self.ctx.error_sink_enabled = self._has_error_sink
        self._stop = threading.Event()
        #: per-stage latency probe (ingest/cut/process/exchange/sink/e2e);
        #: native atomic histograms, surfaced via monitoring + /metrics
        from pathway_tpu_torch.internals.monitoring import LatencyProbe

        self.latency = LatencyProbe()
        #: adaptive micro-batch row budget: cut as soon as this many rows
        #: are buffered, even inside the settle window
        try:
            self._epoch_max_rows = int(
                _os.environ.get("PATHWAY_EPOCH_MAX_ROWS", "32768")
            )
        except ValueError:
            self._epoch_max_rows = 32768
        #: live connector queues (stop() drops a wake sentinel in each)
        self._live_queues: list["queue.Queue"] = []
        #: live cluster while run_cluster is active (exchange probe + hub)
        self._active_cluster: Cluster | None = None
        #: persistence hooks (set by pathway_tpu_torch.persistence.attach_persistence)
        self.persistence: Any = None
        #: epoch-boundary GC sweep hook (set by internals.run._ManagedGc);
        #: called between epochs when transient row data is already dead
        self.gc_tick: Callable[[], None] | None = None
        #: per-worker wall time of the last operator snapshot (rate limit)
        self._last_snapshot_at: dict[int, float] = {}
        #: per-connector counters keyed by input name (monitoring)
        self.connector_stats: dict[str, dict] = {}
        #: guards connector_stats registration + prober snapshotting
        self._prober_lock = threading.Lock()
        #: serializes prober callbacks (they may not be thread-safe).
        #: Separate from _prober_lock so a callback may itself call
        #: snapshot_connector_stats()/snapshot_operator_probes() without
        #: deadlocking; lock order is always cb_lock -> prober_lock.
        self._prober_cb_lock = threading.Lock()
        #: optimizer audit trail (analysis/plan.ExecutionPlan) and its
        #: per-pass rewrite counters — set by internals.run before the
        #: run starts, read by /status + /metrics; None/{} when optimize=0
        self.execution_plan: Any = None
        self.plan_counters: dict[str, int] = {}
        #: restart generation of this process when running under the
        #: cluster supervisor (internals.resilience.ClusterSupervisor sets
        #: PATHWAY_WORKER_RESTARTS; internals.run copies it here) — feeds
        #: the pathway_tpu_worker_restarts_total gauge
        self.worker_restarts = 0
        #: bounded, bytes-accounted connector ingest buffer (backpressure):
        #: readers charge it before enqueueing, the drain loops consume;
        #: PATHWAY_INGEST_BUFFER_BYTES <= 0 disables the accounting
        try:
            cap = int(
                _os.environ.get(
                    "PATHWAY_INGEST_BUFFER_BYTES",
                    str(DEFAULT_INGEST_BUFFER_BYTES),
                )
            )
        except ValueError:
            cap = DEFAULT_INGEST_BUFFER_BYTES
        self.ingest_credit = IngestCredit(cap)
        #: last pressure level pushed to serving (rate-limits the push)
        self._last_pressure_pushed = 0.0

    # ------------------------------------------------------------------
    def snapshot_connector_stats(self) -> dict[str, dict]:
        """Race-free copy of the per-connector counters — the ONLY safe
        way to read them from another thread (dashboard, /metrics,
        probers): registration mutates the registry under the same
        lock."""
        with self._prober_lock:
            return {name: dict(s) for name, s in self.connector_stats.items()}

    def snapshot_operator_probes(self, ctx: Any = None) -> dict[int, dict]:
        """Race-free copy of the per-operator probes (same contract as
        :meth:`snapshot_connector_stats`)."""
        ctx = ctx or self.ctx
        with self._prober_lock:
            return {
                nid: dict(p)
                for nid, p in ctx.stats.get("operators", {}).items()
            }

    def ingest_pressure(self) -> dict[str, Any]:
        """Ingest-buffer pressure snapshot with sources keyed by input
        NAME (monitoring surfaces; node ids are internal).  Shape:
        ``{"totals": {...}, "sources": {name: {rows, bytes, shed_rows,
        shed_bytes, paused}}}``."""
        by_id = self.ingest_credit.snapshot()
        names: dict[int, str] = {}
        for node in self.graph.nodes:
            if isinstance(node, InputNode):
                names[node.id] = getattr(node, "name", str(node.id))
        return {
            "totals": self.ingest_credit.totals(),
            "sources": {
                names.get(nid, str(nid)): snap for nid, snap in by_id.items()
            },
        }

    def pressure_level(self) -> float:
        """Engine pressure in [0, 1]: the max of ingest-buffer occupancy
        and exchange credit backlog — the signal brownout acts on."""
        level = self.ingest_credit.level()
        cluster = self._active_cluster
        if cluster is not None:
            level = max(level, cluster.pressure_level())
        return level

    def _push_serving_pressure(self) -> None:
        """Propagate engine pressure to serving admission (brownout).
        Cheap no-op unless serving is imported; pushes only on material
        change (>= 0.05) or full release so the epoch loop stays hot."""
        import sys

        serving = sys.modules.get("pathway_tpu_torch.serving")
        if serving is None:
            return
        level = self.pressure_level()
        last = self._last_pressure_pushed
        if abs(level - last) < 0.05 and not (level == 0.0 and last > 0.0):
            return
        self._last_pressure_pushed = level
        try:
            serving.push_pressure("engine", level)
        except Exception:
            pass  # monitoring-path best effort; never kill the epoch loop

    def _settle_s(self, last_epoch_s: float) -> float:
        """Adaptive micro-batch settle window (seconds): after the last
        arrival, wait this long for the queue to drain before cutting.
        Scaled to the last epoch's cost (a cheap graph cuts almost
        immediately; an expensive one batches more), floored at 0.5 ms and
        capped at a quarter of the autocommit interval — the interval
        itself remains only the upper bound on hold time."""
        return min(max(last_epoch_s * 0.25, 0.0005), self.autocommit_ms / 4000.0)

    def _replay_speedup(self) -> float:
        """Replay speed factor for REALTIME_REPLAY inter-commit gaps:
        ``PATHWAY_REPLAY_SPEEDUP`` env wins, else the persistence config's
        ``replay_speedup``; values <= 0 mean "as fast as possible"."""
        env = _os.environ.get("PATHWAY_REPLAY_SPEEDUP")
        if env:
            try:
                return float(env)
            except ValueError:
                pass
        cfg = getattr(self.persistence, "config", None)
        try:
            return float(getattr(cfg, "replay_speedup", 1.0))
        except (TypeError, ValueError):
            return 1.0

    def wake(self) -> None:
        """Nudge the streaming loops out of their event waits: notifies
        the cluster hub (parked multi-worker idle branches) and drops a
        ``None`` sentinel into each live connector queue (single-worker
        ``q.get``).  Called by ``stop()`` and the GC pacer."""
        cluster = self._active_cluster
        if cluster is not None:
            cluster.wakeup.notify()
        for q in list(self._live_queues):
            q.put(None)

    def _snapshot_interval(self) -> float:
        """Checkpoint cadence in ms — ONE policy for single-worker and
        cluster paths (they must snapshot at the same cadence).
        Precedence: ``PATHWAY_CHECKPOINT_INTERVAL`` env (seconds), then
        ``Config(checkpoint_interval=)`` (seconds), then the legacy
        ``snapshot_interval_ms``; always floored by the autocommit
        interval (checkpoints ride epoch cuts, which happen no more often
        than that)."""
        cfg = self.persistence.config
        interval_ms = float(getattr(cfg, "snapshot_interval_ms", 0) or 0)
        ci = getattr(cfg, "checkpoint_interval", None)
        env = _os.environ.get("PATHWAY_CHECKPOINT_INTERVAL")
        if env:
            try:
                ci = float(env)
            except ValueError:
                pass
        if ci is not None:
            interval_ms = float(ci) * 1000.0
        return max(interval_ms, self.autocommit_ms)

    def _maybe_snapshot(
        self,
        worker: int,
        epoch: int,
        consumed: dict[int, int],
        wrappers: dict[int, Any],
        ctx: RunContext | None = None,
    ) -> None:
        """Operator snapshot, rate-limited by the checkpoint interval.
        Periodic checkpoints are asynchronous: state pickles here at the
        epoch boundary, disk writes happen off the hot path."""
        interval = self._snapshot_interval()
        now = _time.monotonic()
        if (now - self._last_snapshot_at.get(worker, 0.0)) * 1000.0 < interval:
            return
        self._last_snapshot_at[worker] = now
        self._final_snapshot(
            worker, epoch, consumed, wrappers, ctx=ctx, asynchronous=True
        )

    def _final_snapshot(
        self,
        worker: int,
        epoch: int,
        consumed: dict[int, int],
        wrappers: dict[int, Any],
        ctx: RunContext | None = None,
        asynchronous: bool = False,
    ) -> None:
        """Operator snapshot: force-commit the input logs (so the
        snapshot's consumed counts lie within each log's committed
        prefix), then persist the worker's node states.

        ``asynchronous=True`` (periodic checkpoints): the state pickles on
        THIS thread at the epoch boundary, but the log commits and the
        blob write run on the persistence writer thread — the hot path
        never blocks on disk.  Commit-before-blob ordering is preserved on
        the writer, so a visible snapshot is always consistent with the
        log.  The synchronous path (final snapshot after the finalizing
        flush epoch) drains the async queue FIRST, so the final blob —
        whose state must never re-flush buffered windows on resume — can
        never be overwritten by a stale queued checkpoint."""
        if self.persistence is None or not self.persistence.operator_mode:
            return
        ctx = ctx or self.ctx
        states = self._enriched_states(ctx)
        if asynchronous:
            save_async = getattr(
                self.persistence, "save_operator_snapshot_async", None
            )
            if save_async is not None:
                commit_fns = tuple(
                    fc
                    for wr in wrappers.values()
                    if (fc := getattr(wr, "force_log_commit", None)) is not None
                )
                save_async(worker, epoch, consumed, states, commit_fns)
                return
        flush = getattr(self.persistence, "flush_checkpoints", None)
        if flush is not None:
            flush()
        for w in wrappers.values():
            fc = getattr(w, "force_log_commit", None)
            if fc is not None:
                fc()
        self.persistence.save_operator_snapshot(
            worker, epoch, consumed, states
        )

    def _enriched_states(self, ctx: RunContext) -> dict[int, Any]:
        """Operator states to checkpoint: ``ctx.states`` overlaid with
        every node's :meth:`~pathway_tpu_torch.engine.graph.Node.snapshot_state`
        contribution (external-index serialization rides the same blob,
        keyed to the same connector offsets).  A failing hook degrades to
        the plain state for that node — rebuild-on-replay beats a dead
        checkpoint."""
        states = ctx.states
        extras: dict[int, Any] = {}
        for node in self.graph.nodes:
            try:
                extra = node.snapshot_state(ctx)
            except Exception as e:  # noqa: BLE001
                ctx.log_error(node, f"{node.name}#{node.id} snapshot_state: {e!r}")
                continue
            if extra is not None:
                extras[node.id] = extra
        if not extras:
            return states
        return {**states, **extras}

    def _restore_nodes(self, ctx: RunContext) -> None:
        """Post-restore hook pass: after operator state is restored from a
        snapshot, every node gets ``on_restore(ctx)`` — sinks use it to
        reposition their output files to the checkpointed watermark so
        replayed epochs cannot double-emit.  A failing hook is contained
        like any operator error (degraded output beats a dead run)."""
        for node in self.graph.nodes:
            try:
                node.on_restore(ctx)
            except Exception as e:
                ctx.log_error(node, f"{node.name}#{node.id} on_restore: {e!r}")

    def active_closure(self, root_ids: set[int]) -> set[int]:
        """Node ids reachable from ``root_ids`` or from always-tick nodes —
        the only operators that can see data this epoch.  Every worker
        computes this from the SAME gathered input ids, so collectives for
        globally-idle nodes are skipped in lockstep."""
        roots = set(root_ids)
        for node in self.graph.nodes:
            if node.always_tick:
                roots.add(node.id)
        active = set(roots)
        frontier = list(roots)
        while frontier:
            nid = frontier.pop()
            for consumer, _port in self.consumers.get(nid, ()):
                if consumer.id not in active:
                    active.add(consumer.id)
                    frontier.append(consumer.id)
        return active

    @staticmethod
    def _route_outboxes(route: Any, batch: list, W: int) -> list[list]:
        """Split a batch into per-worker outboxes.  Fast paths: const-zero
        routes copy without any per-row work; routes with a positional
        cell spec split in one native C pass (``route_split``); everything
        else runs the per-row Python closure."""
        if getattr(route, "const_zero", False):
            outboxes: list[list] = [[] for _ in range(W)]
            outboxes[0] = batch
            return outboxes
        positional = getattr(route, "positional", None)
        if isinstance(batch, ColumnarBatch):
            native = _native.load()
            if positional is not None and native is not None:
                try:
                    cbs = [ColumnarBatch() for _ in range(W)]
                    spec = tuple(positional)
                    for seg_kind, seg in batch.segments:
                        if seg_kind == "f":
                            # one native pass: byte-identical destinations
                            # to route_split, children share the pool
                            for dst, sub in enumerate(
                                native.frame_route_split(seg, spec, W)
                            ):
                                cbs[dst].append_frame(sub)
                        else:
                            for dst, sub in enumerate(
                                native.route_split(seg, spec, W)
                            ):
                                if sub:
                                    cbs[dst].extend(sub)
                    return cbs
                except Exception:
                    pass  # fall through to the materialized row path
            batch = batch.to_list()
        if positional is not None:
            native = _native.load()
            if native is not None:
                try:
                    return native.route_split(batch, tuple(positional), W)
                except Exception:
                    pass  # any failure: the per-row path decides row by row
        outboxes = [[] for _ in range(W)]
        for u in batch:
            try:
                dest = route(u) % W
            except Exception:
                dest = 0
            outboxes[dest].append(u)
        return outboxes

    def run_epoch(
        self,
        time: int,
        inject: dict[int, Batch],
        *,
        ctx: RunContext | None = None,
        cluster: Cluster | None = None,
        tid: int = 0,
        active: set[int] | None = None,
    ) -> None:
        ctx = ctx or self.ctx
        ctx.time = time
        from pathway_tpu_torch.engine.graph import set_current_ctx

        set_current_ctx(ctx)  # per-cell errors route to this run's log
        W = cluster.n_workers if cluster is not None else 1
        pending: dict[int, dict[int, list[Update]]] = defaultdict(lambda: defaultdict(list))
        for nid, batch in inject.items():
            pending[nid][0] = (
                batch if isinstance(batch, ColumnarBatch) else list(batch)
            )
        for node in self.graph.nodes:
            if active is not None and node.id not in active:
                continue  # globally idle this epoch: no data can reach it
            ins = pending.pop(node.id, None)
            routes = node.exchange_routes() if W > 1 else None
            if routes is not None:
                # collective: every worker participates even with no local
                # data — rows may arrive from peers
                ins = ins or {}
                n_ports = max(1, len(node.inputs))
                for port in range(n_ports):
                    route = routes[port] if port < len(routes) else None
                    if route is None:
                        continue
                    batch = ins.get(port, ())
                    if not isinstance(batch, (list, ColumnarBatch)):
                        batch = list(batch)
                    outboxes = self._route_outboxes(route, batch, W)
                    ins[port] = cluster.exchange(  # type: ignore[union-attr]
                        ("x", node.id, port, time), tid, outboxes
                    )
            has_input = ins is not None and any(ins.values())
            if not has_input and not node.always_tick and not getattr(ctx, "finalizing", False):
                continue
            n_ports = max(1, len(node.inputs))
            inbatches = [ins.get(i, []) if ins else [] for i in range(n_ports)]
            # columnar/row seam: a frame batch reaching a row-only operator
            # materializes HERE (one place), and every routed row is
            # attributed to its execution path — the
            # pathway_tpu_columnar_rows_total{path} counter that makes a
            # silently degraded pipeline (everything on the fallback path)
            # visible in /metrics and /status
            rows_in = 0
            col_in = 0
            for i, b in enumerate(inbatches):
                if isinstance(b, ColumnarBatch):
                    if node.supports_columnar:
                        col_in += b.frame_rows()
                        rows_in += len(b)
                    else:
                        b = b.to_list()
                        inbatches[i] = b
                        rows_in += len(b)
                else:
                    rows_in += len(b)
            if rows_in:
                cr = ctx.stats.setdefault(
                    "columnar_rows", {"columnar": 0, "row": 0}
                )
                cr["columnar"] += col_in
                cr["row"] += rows_in - col_in
            t0 = _time.perf_counter()
            try:
                out = node.process(ctx, time, inbatches)
            except api.FatalEngineError:
                # unrecoverable by contract (runtime typecheck violations,
                # corrupted state): fail the run, don't contain
                raise
            except Exception as e:
                # per-node containment: a failing operator must not abort
                # the run (reference routes errors to the error log,
                # src/engine/error.rs) — and in cluster mode an uncaught
                # raise would strand peers at the next collective.  The
                # epoch's output for this node is lost, so downstream state
                # may be degraded: log loudly, not just to the error table.
                import logging

                entry = ctx.log_error(node, f"{node.name}#{node.id}: {e!r}")
                msg = str(entry)
                logging.getLogger("pathway_tpu_torch").error(
                    "operator failed (epoch %d dropped for this node): %s",
                    time,
                    msg,
                )
                out = []
            # per-operator probe (reference attach_prober/probe_table,
            # src/engine/graph.rs:988-995): latency + row counts feed the
            # dashboard and the /metrics endpoint
            dt_ms = (_time.perf_counter() - t0) * 1000.0
            probe = ctx.stats.setdefault("operators", {}).get(node.id)
            if probe is None:
                # registration under the lock: monitoring threads copy this
                # dict concurrently (see snapshot_operator_probes)
                with self._prober_lock:
                    probe = ctx.stats["operators"].setdefault(
                        node.id,
                        {
                            "name": f"{node.name}#{node.id}",
                            "kind": type(node).__name__,
                            "rows_in": 0,
                            "rows_out": 0,
                            "total_ms": 0.0,
                            "max_ms": 0.0,
                            "epochs": 0,
                            "state_bytes": 0,
                        },
                    )
            probe["rows_in"] += rows_in
            probe["rows_out"] += len(out)
            probe["total_ms"] += dt_ms
            probe["max_ms"] = max(probe["max_ms"], dt_ms)
            probe["epochs"] += 1
            # measured state bytes, sampled with power-of-two epoch
            # backoff (cost amortizes to O(1) per epoch over a run); the
            # finalizing flush in _finish takes the authoritative sample
            e = probe["epochs"]
            if e & (e - 1) == 0:
                st = ctx.states.get(node.id)
                if st is not None:
                    probe["state_bytes"] = approx_state_bytes(st)
            if out:
                for consumer, port in self.consumers.get(node.id, ()):  # fan-out
                    # extend_batch keeps frame segments columnar through
                    # the fan-out (promoting the pending list if needed)
                    pending[consumer.id][port] = extend_batch(
                        pending[consumer.id][port], out
                    )
        for node in self.graph.nodes:
            node.on_time_end(ctx, time)
        if self.graph.probers:
            # per-WORKER stats, like the reference's ProberStats (each
            # worker probes its own partition; a fleet-wide view is the
            # consumer's aggregation over the "worker" field).  Copied per
            # epoch: the live probe dicts mutate in place, so handing out
            # references would make every stored snapshot show the final
            # cumulative totals.  Connector counters are PROCESS-global,
            # so only thread 0's snapshot carries them (summing across
            # worker snapshots must not multiply them).  The snapshot is
            # built under _prober_lock (registry-iteration safety) but the
            # callbacks run under _prober_cb_lock only, so a prober may
            # itself call snapshot_connector_stats()/snapshot_operator_probes()
            # — the documented "only safe way" to read live stats — without
            # deadlocking on the non-reentrant prober lock.
            with self._prober_cb_lock:
                with self._prober_lock:
                    snapshot = {
                        "time": time,
                        "worker": cluster.worker_index(tid) if cluster else 0,
                        "operators": {
                            nid: dict(p)
                            for nid, p in ctx.stats.get("operators", {}).items()
                        },
                        "connectors": (
                            {
                                name: dict(s)
                                for name, s in self.connector_stats.items()
                            }
                            if tid == 0
                            else {}
                        ),
                    }
                    probers = list(self.graph.probers)
                for cb in probers:
                    try:
                        cb(snapshot)
                    except Exception:  # probers must never break the run
                        import logging

                        logging.getLogger("pathway_tpu_torch").warning(
                            "prober callback failed", exc_info=True
                        )

    def _finish(
        self,
        *,
        ctx: RunContext | None = None,
        cluster: Cluster | None = None,
        tid: int = 0,
        post_epoch: Any = None,
    ) -> None:
        # final flush epoch: frontier advances to +inf; buffering operators release
        ctx = ctx or self.ctx
        ctx.finalizing = True  # type: ignore[attr-defined]
        self.run_epoch(ctx.time + TIME_STEP, {}, ctx=ctx, cluster=cluster, tid=tid)
        # authoritative end-of-run state-bytes sample (the in-epoch
        # sampler backs off exponentially, so its last reading can be
        # half a run old)
        ops = ctx.stats.get("operators", {})
        for nid, st in list(ctx.states.items()):
            probe = ops.get(nid)
            if probe is not None:
                probe["state_bytes"] = approx_state_bytes(st)
        if post_epoch is not None:
            # operator snapshot AFTER the finalizing flush, so restored
            # state never re-flushes buffered windows
            post_epoch()
        for node in self.graph.nodes:
            node.on_end(ctx)

    # ------------------------------------------------------------------
    def run(self) -> RunContext:
        static_inject: dict[int, Batch] = {}
        live_inputs: list[InputNode] = []
        for node in self.graph.nodes:
            if isinstance(node, InputNode):
                if node.static_rows:
                    static_inject[node.id] = _build_adds(node.static_rows)
                if node.subject is not None:
                    live_inputs.append(node)

        if not live_inputs:
            self.run_epoch(0, static_inject)
            self.ctx.time = 0
            self._finish()
            return self.ctx

        # --- streaming mode -------------------------------------------
        t = 0
        # operator snapshot (OPERATOR_PERSISTING): restore compacted node
        # states, skip recomputation; only the committed tail past the
        # snapshot's consumed counts is replayed (bounded replay —
        # reference src/persistence/operator_snapshot.rs)
        snap: dict | None = None
        if self.persistence is not None and self.persistence.operator_mode:
            snap = self.persistence.load_operator_snapshot(0)
        if snap is not None:
            self.ctx.states = snap["states"]
            t = snap["epoch"] + TIME_STEP
            self._restore_nodes(self.ctx)
        elif static_inject:
            # static rows re-inject only when no snapshot holds them already
            self.run_epoch(t, static_inject)
            t += TIME_STEP

        # persistence: replay committed input snapshots as leading epochs
        replayed_counts: dict[int, int] = {}
        consumed: dict[int, int] = dict(snap["consumed"]) if snap else {}
        self.ctx.consumed = consumed  # type: ignore[attr-defined]
        if self.persistence is not None:
            self.persistence.check_topology(1)
            # collect every node's committed epochs FIRST, so replay can
            # interleave sources on the recorded global timeline instead of
            # draining one source's whole span before the next
            pending: list[tuple[float, int, int, list[Update]]] = []
            seq = 0
            for node in live_inputs:
                events = self.persistence.replay_events(node)
                data = [e for e in events if e[0] != "commit"]
                replayed_counts[node.id] = len(data)
                if snap is not None:
                    skip = consumed.get(node.id, 0)
                    tail = data[skip:]
                    if tail:
                        batch = [
                            Update(key, values, 1 if kind == "add" else -1)
                            for kind, key, values in tail
                        ]
                        self.run_epoch(t, {node.id: batch})
                        t += TIME_STEP
                    consumed[node.id] = max(skip, len(data))
                    continue
                consumed[node.id] = len(data)
                epoch: list[Update] = []
                node_wall = float("-inf")  # carry-forward for old records
                for kind, key, values in events:
                    if kind == "add":
                        epoch.append(Update(key, values, 1))
                    elif kind == "remove":
                        epoch.append(Update(key, values, -1))
                    elif kind == "commit":
                        if isinstance(values, float):
                            node_wall = values
                        if epoch:
                            pending.append((node_wall, seq, node.id, epoch))
                            seq += 1
                            epoch = []
            # Legacy commit records (written before wall timestamps were
            # recorded) carry wall == -inf.  Backfill each with the next
            # timestamped wall of the SAME source: those epochs happened
            # before that commit, and the seq tiebreak keeps per-source
            # order, so they interleave just ahead of it instead of all
            # legacy epochs of one source draining before any timestamped
            # epoch of another.  An all-legacy log degenerates to pure
            # arrival (seq) order, which is the pre-timestamp behaviour.
            next_wall: dict[int, float] = {}
            for i in range(len(pending) - 1, -1, -1):
                wall, sq, nid, batch = pending[i]
                if wall == float("-inf") and nid in next_wall:
                    pending[i] = (next_wall[nid], sq, nid, batch)
                elif wall != float("-inf"):
                    next_wall[nid] = wall
            # merge across sources by recorded commit wall clock (stable on
            # ties / legacy records without timestamps)
            pending.sort(key=lambda p: (p[0], p[1]))
            prev_wall: float | None = None
            for wall, _seq, node_id, batch in pending:
                if (
                    self.persistence.realtime_replay
                    and wall != float("-inf")
                ):
                    # REALTIME_REPLAY honours recorded inter-commit gaps
                    # (reference RealtimeReplay); SPEEDRUN and resume run
                    # flat out.  Gaps divide by the replay speed factor
                    # (persistence ``replay_speedup`` / env
                    # PATHWAY_REPLAY_SPEEDUP) and cap at 5 s so a
                    # long-idle recording stays usable; the wait is on
                    # the stop event, so shutdown interrupts it instead
                    # of sleeping through.
                    if prev_wall is not None and wall > prev_wall:
                        speedup = self._replay_speedup()
                        if speedup > 0:
                            self._stop.wait(
                                min((wall - prev_wall) / speedup, 5.0)
                            )
                    prev_wall = wall
                if self._stop.is_set():
                    break
                self.run_epoch(t, {node_id: batch})
                t += TIME_STEP
            if self.persistence.replay_only:
                self.ctx.time = t
                self._finish()
                return self.ctx

        q: "queue.Queue" = queue.Queue()  # lk009: bytes-bounded by IngestCredit.charge
        threads: list[threading.Thread] = []
        wrappers: dict[int, Any] = {}
        for node in live_inputs:
            threads.append(
                self._spawn_supervised(
                    node,
                    node.subject,
                    q,
                    wrappers,
                    replayed_counts.get(node.id, 0),
                    self.ctx,
                )
            )

        # auxiliary inputs (loopbacks) never keep the run alive by
        # themselves: the run ends when all primaries closed AND every
        # auxiliary reports no pending work
        primaries = [n for n in live_inputs if not getattr(n, "auxiliary", False)]
        auxiliaries = [n for n in live_inputs if getattr(n, "auxiliary", False)]
        open_subjects = {n.id for n in primaries}
        buffers: dict[int, list[Update]] = defaultdict(list)
        lat = self.latency
        now_ns = lat.now_ns
        credit = self.ingest_credit
        self._live_queues.append(q)
        autocommit_s = self.autocommit_ms / 1000.0
        commit_requested = False
        rows_buffered = 0
        #: remainder of a batch item split at the epoch row budget; it
        #: re-enters the drain ahead of the queue, preserving source order
        carry: deque = deque()  # lk009: holds at most one split batch item
        #: monotonic instants of the oldest / newest buffered arrival
        first_arrival: float | None = None
        last_arrival = 0.0
        #: earliest enqueue timestamp among buffered events (e2e origin)
        origin_ns: int | None = None
        last_epoch_s = 0.0
        while True:
            # Event-driven wait: ``q.get`` wakes the instant a connector
            # enqueues (or stop() drops its sentinel).  Idle, the
            # autocommit interval is only a defensive heartbeat; with data
            # buffered the wait is the adaptive micro-batch window — cut
            # as soon as the queue drains and settles, at the row budget,
            # or at the autocommit deadline, whichever comes first.
            now = _time.monotonic()
            if first_arrival is not None:
                settle = self._settle_s(last_epoch_s)
                deadline = min(
                    last_arrival + settle, first_arrival + autocommit_s
                )
                timeout = deadline - now
            else:
                timeout = autocommit_s
            item = None
            if carry:
                item = carry.popleft()  # remainder of a budget-split batch
            else:
                try:
                    if timeout > 0.0:
                        item = q.get(timeout=timeout)
                    else:
                        item = q.get_nowait()
                except queue.Empty:
                    pass
            # Greedy drain: pull everything already queued into the buffers
            # in one pass, so epoch size tracks the actual backlog instead
            # of one queue item per loop iteration (an epoch that takes
            # longer than autocommit_ms would otherwise degenerate to one
            # reader chunk per epoch).  A commit item ends the drain — rows
            # enqueued after a commit belong to the next transaction.  The
            # item cap bounds buffer growth and guarantees the cut/stop
            # checks below run even against a producer that enqueues as
            # fast as we drain.
            drained = 0
            data_drained = False
            drain_ns = now_ns()
            while item is not None:
                nid, kind, key, values, enq_ns, seq = item
                if seq is not None and not credit.consume(nid, seq):
                    kind = "shed"  # uncharged by shed_oldest: discard
                if kind == "add":
                    buffers[nid].append(Update(key, values, 1))
                    rows_buffered += 1
                elif kind == "batch":
                    room = self._epoch_max_rows - rows_buffered
                    if 0 < room < len(key):
                        # budget-split: the remainder re-enters the drain
                        # first next pass, preserving per-source order
                        # (already consumed from the credit: seq=None)
                        buffers[nid].extend(key[:room])
                        rows_buffered += room
                        carry.appendleft(
                            (nid, "batch", key[room:], values, enq_ns, None)
                        )
                    else:
                        buffers[nid].extend(key)
                        rows_buffered += len(key)
                elif kind == "frame":
                    native = _native.load()
                    n = native.frame_len(key)
                    room = self._epoch_max_rows - rows_buffered
                    if 0 < room < n:
                        # budget-split: frame_slice shares the string pool
                        # and keeps keys lazy — two column copies, no rows
                        _buffer_frame(
                            buffers, nid, native.frame_slice(key, 0, room)
                        )
                        rows_buffered += room
                        carry.appendleft(
                            (
                                nid,
                                "frame",
                                native.frame_slice(key, room, n),
                                values,
                                enq_ns,
                                None,
                            )
                        )
                    else:
                        _buffer_frame(buffers, nid, key)
                        rows_buffered += n
                elif kind == "remove":
                    buffers[nid].append(Update(key, values, -1))
                    rows_buffered += 1
                elif kind == "commit":
                    commit_requested = True
                    break
                elif kind == "close":
                    open_subjects.discard(nid)
                if kind in ("add", "batch", "remove", "frame"):
                    data_drained = True
                    if enq_ns is not None:
                        lat.record("ingest", drain_ns - enq_ns)
                        if origin_ns is None or enq_ns < origin_ns:
                            origin_ns = enq_ns
                drained += 1
                if drained >= 8192 or rows_buffered >= self._epoch_max_rows:
                    # bounded pass: cut/stop checks must run — the row
                    # budget caps the epoch even when the producer lands
                    # a whole static file in one drain
                    break
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    item = None
            now = _time.monotonic()
            if data_drained:
                last_arrival = now
                if first_arrival is None:
                    first_arrival = now
            have_data = rows_buffered > 0
            if commit_requested and not have_data:
                # an empty commit is a no-op, not a standing order —
                # latched, it would chop the NEXT batch at its first row
                # instead of at that batch's own commit boundary
                commit_requested = False
            settle = self._settle_s(last_epoch_s)
            should_cut = have_data and (
                commit_requested
                or rows_buffered >= self._epoch_max_rows
                or (q.empty() and now - last_arrival >= settle)
                or (
                    first_arrival is not None
                    and now - first_arrival >= autocommit_s
                )
            )
            if should_cut:
                inject = {nid: b for nid, b in buffers.items() if b}
                buffers = defaultdict(list)
                commit_requested = False
                for nid, b in inject.items():
                    consumed[nid] = consumed.get(nid, 0) + len(b)
                cut_ns = now_ns()
                if origin_ns is not None:
                    lat.record("cut", cut_ns - origin_ns)
                # sink/e2e stage anchors for the output nodes of this epoch
                self.ctx.latency = lat
                self.ctx.epoch_origin_ns = origin_ns
                self.ctx.epoch_cut_ns = cut_ns
                ep0 = _time.monotonic()
                _ectx = (
                    epoch_trace_context(int(t / TIME_STEP))
                    if _tracing.enabled()
                    else None
                )
                with _tracing.use(_ectx), _tracing.span(
                    "epoch_process", {"epoch": int(t)}
                ):
                    self.run_epoch(t, inject)
                last_epoch_s = _time.monotonic() - ep0
                self.ctx.epoch_origin_ns = None
                self.ctx.epoch_cut_ns = None
                lat.record("process", int(last_epoch_s * 1e9))
                t += TIME_STEP
                rows_buffered = 0
                first_arrival = None
                origin_ns = None
                if self.gc_tick is not None:
                    self.gc_tick()
                self._push_serving_pressure()
                if (
                    self.persistence is not None
                    and self.persistence.operator_mode
                ):
                    self._maybe_snapshot(0, t - TIME_STEP, consumed, wrappers)
            if not open_subjects and not any(buffers.values()) and not carry:
                # order matters: loopback workers enqueue their result BEFORE
                # decrementing pending, so pending==0 guarantees every result
                # is already visible to the q.empty() check after it
                pending = sum(
                    getattr(n.subject, "pending_count", lambda: 0)()
                    for n in auxiliaries
                )
                if pending == 0 and q.empty():
                    break
            if self._stop.is_set():
                break
        self.ctx.time = t
        self._finish(
            post_epoch=lambda: self._final_snapshot(
                0, self.ctx.time, consumed, wrappers
            )
        )
        return self.ctx

    # ------------------------------------------------------------------
    # multi-worker execution

    def run_cluster(self, cluster: Cluster) -> RunContext:
        """SPMD run over ``cluster.threads`` local workers (this process) in
        a ``cluster.processes``-process mesh.  Returns the worker-0 context
        on process 0 (holds captures/outputs), else this process's first
        worker context."""
        T = cluster.threads
        ctxs = [
            RunContext(
                n_workers=cluster.n_workers, worker_id=cluster.worker_index(tid)
            )
            for tid in range(T)
        ]
        for c in ctxs:
            c.error_sink_enabled = self._has_error_sink
        errors: list[BaseException] = []
        self._active_cluster = cluster  # live exchange probe (monitoring)

        def work(tid: int) -> None:
            try:
                self._worker_loop(cluster, tid, ctxs[tid])
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                errors.append(e)
                cluster.close()  # unblock peers; their collectives now fail

        workers = [
            threading.Thread(target=work, args=(tid,), daemon=True)
            for tid in range(1, T)
        ]
        for w in workers:
            w.start()
        try:
            work(0)
            # bounded joins: a sibling stuck in a collective or a socket
            # call is freed by cluster.close() below — never hang forever
            deadline = _time.monotonic() + 10.0
            for w in workers:
                w.join(max(0.0, deadline - _time.monotonic()))
            if any(w.is_alive() for w in workers):
                cluster.close()  # abort barriers, break sockets
                for w in workers:
                    w.join(2.0)
        except KeyboardInterrupt:
            # ^C: clean teardown instead of a hang — stop the run, break
            # every collective and socket wait, give workers a short
            # grace, then re-raise to the caller
            self._stop.set()
            cluster.close()
            for w in workers:
                w.join(2.0)
            self._active_cluster = None
            raise
        self._active_cluster = None
        if errors:
            raise errors[0]
        # the returned (worker-0) context carries every worker's operator
        # errors: a partitioned operator logs on whichever worker owns the
        # row, and callers read ctx.error_log topology-independently.  The
        # end-of-run allgather covers OTHER PROCESSES too; the thread merge
        # is the fallback when the exchange didn't complete.
        gathered = getattr(ctxs[0], "all_errors", None)
        if gathered is not None:
            ctxs[0].error_log = list(gathered)
        else:
            for c in ctxs[1:]:
                ctxs[0].error_log.extend(c.error_log)
        # exchange-overhead probe: pack/send/unpack/wait totals for this
        # process's collectives, surfaced through monitoring and bench
        ctxs[0].stats["exchange"] = cluster.exchange_stats()
        return ctxs[0]

    def _worker_loop(self, cluster: Cluster, tid: int, ctx: RunContext) -> None:
        W = cluster.n_workers
        w = cluster.worker_index(tid)

        static_inject: dict[int, Batch] = {}
        my_inputs: list[tuple[InputNode, Any]] = []  # (node, subject to run)
        live_node_ids: set[int] = set()
        for node in self.graph.nodes:
            if not isinstance(node, InputNode):
                continue
            if node.static_rows and w == 0:
                static_inject[node.id] = _build_adds(node.static_rows)
            if node.subject is None:
                continue
            live_node_ids.add(node.id)
            part = getattr(node.subject, "partition", None)
            if part is not None:
                sub = part(w, W)
                if sub is not None:
                    my_inputs.append((node, sub))
            elif w == 0:
                my_inputs.append((node, node.subject))

        have_static = any(
            isinstance(n, InputNode) and n.static_rows for n in self.graph.nodes
        )
        t = 0
        if not live_node_ids:
            if have_static:
                self.run_epoch(t, static_inject, ctx=ctx, cluster=cluster, tid=tid)
            ctx.time = 0
            self._finish(ctx=ctx, cluster=cluster, tid=tid)
            return

        # persistence replay (per-worker streams): all workers replay in
        # lockstep — the epoch count is agreed first so collectives align.
        # Static rows inject inside (skipped when a snapshot holds them).
        t, replayed_counts = self._cluster_replay(
            cluster, tid, ctx, my_inputs, t,
            static_inject=static_inject if have_static else None,
        )
        if self.persistence is not None and self.persistence.replay_only:
            # record/replay mode: the snapshot IS the input; starting live
            # readers here would double-count every row
            ctx.time = t
            self._finish(ctx=ctx, cluster=cluster, tid=tid)
            return

        hub = cluster.wakeup
        lat = self.latency
        now_ns = lat.now_ns
        credit = self.ingest_credit
        if tid == 0:
            cluster.latency = lat  # exchange recv waits feed the probe
        q: "queue.Queue" = queue.Queue()  # lk009: bytes-bounded by IngestCredit.charge
        wrappers: dict[int, Any] = {}
        for node, subject in my_inputs:
            self._spawn_supervised(
                node,
                subject,
                q,
                wrappers,
                replayed_counts.get(node.id, 0),
                ctx,
                worker=w,
                wake=hub.notify,
            )

        my_primaries = {
            n.id for n, _s in my_inputs if not getattr(n, "auxiliary", False)
        }
        my_aux = [n for n, _s in my_inputs if getattr(n, "auxiliary", False)]
        open_subjects = set(my_primaries)
        buffers: dict[int, list[Update]] = defaultdict(list)
        round_no = 0
        commit_requested = False
        autocommit_s = self.autocommit_ms / 1000.0
        rows_buffered = 0
        #: remainder of a batch item split at the epoch row budget
        carry: deque = deque()  # lk009: holds at most one split batch item
        first_arrival: float | None = None
        last_arrival = 0.0
        origin_ns: int | None = None
        last_epoch_s = 0.0
        while True:
            # generation snapshot BEFORE the drain: anything enqueued or
            # delivered after this point re-triggers the idle wait below
            # immediately (no lost-wakeup window)
            wake_seen = hub.seq()
            # drain whatever is buffered right now (non-blocking, bounded).
            # A commit item ENDS the drain: rows enqueued after a commit
            # belong to the next transaction — merging across it would
            # consolidate an add with its later retraction into nothing
            # (timed update streams rely on the boundary).
            drained = 0
            data_drained = False
            drain_ns = now_ns()
            while drained < 8192:
                if carry:
                    item = carry.popleft()  # budget-split batch remainder
                else:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                if item is None:
                    continue  # wake sentinel from stop()
                nid, kind, key, values, enq_ns, seq = item
                drained += 1
                if seq is not None and not credit.consume(nid, seq):
                    kind = "shed"  # uncharged by shed_oldest: discard
                if kind == "add":
                    buffers[nid].append(Update(key, values, 1))
                    rows_buffered += 1
                elif kind == "batch":
                    room = self._epoch_max_rows - rows_buffered
                    if 0 < room < len(key):
                        buffers[nid].extend(key[:room])
                        rows_buffered += room
                        carry.appendleft(
                            (nid, "batch", key[room:], values, enq_ns, None)
                        )
                    else:
                        buffers[nid].extend(key)
                        rows_buffered += len(key)
                elif kind == "frame":
                    native = _native.load()
                    n = native.frame_len(key)
                    room = self._epoch_max_rows - rows_buffered
                    if 0 < room < n:
                        _buffer_frame(
                            buffers, nid, native.frame_slice(key, 0, room)
                        )
                        rows_buffered += room
                        carry.appendleft(
                            (
                                nid,
                                "frame",
                                native.frame_slice(key, room, n),
                                values,
                                enq_ns,
                                None,
                            )
                        )
                    else:
                        _buffer_frame(buffers, nid, key)
                        rows_buffered += n
                elif kind == "remove":
                    buffers[nid].append(Update(key, values, -1))
                    rows_buffered += 1
                elif kind == "commit":
                    commit_requested = True
                    break
                elif kind == "close":
                    open_subjects.discard(nid)
                if kind in ("add", "batch", "remove", "frame"):
                    data_drained = True
                    if enq_ns is not None:
                        lat.record("ingest", drain_ns - enq_ns)
                        if origin_ns is None or enq_ns < origin_ns:
                            origin_ns = enq_ns
                if rows_buffered >= self._epoch_max_rows:
                    # row budget reached: stop draining so the epoch cuts
                    # even when a static file lands in one burst
                    break

            aux_pending = sum(
                getattr(n.subject, "pending_count", lambda: 0)() for n in my_aux
            )
            # has_data includes a post-drain queue peek: a loopback enqueues
            # its result BEFORE decrementing pending, so (queue empty AND
            # pending 0) means nothing more can arrive — and since every
            # worker contributes that into the allgather, all workers reach
            # the identical CUT/FINISH/WAIT decision and stay in lockstep
            # the decision below must be a pure function of the gathered
            # statuses so every worker reaches the same CUT/FINISH/WAIT
            # verdict — local clocks only enter via the gathered elapsed
            now = _time.monotonic()
            if data_drained:
                last_arrival = now
                if first_arrival is None:
                    first_arrival = now
            # hold time of the oldest buffered arrival: the autocommit
            # interval bounds how long data may be HELD, not a fixed cut
            # cadence — an idle stretch no longer counts toward it
            elapsed_ms = (
                (now - first_arrival) * 1000.0 if first_arrival is not None else 0.0
            )
            settle_s = self._settle_s(last_epoch_s)
            # adaptive micro-batch vote: this worker's queue drained and
            # settled (or hit the row budget) — gathered below, so ANY
            # worker's vote cuts the epoch cluster-wide
            wants_cut = rows_buffered > 0 and (
                rows_buffered >= self._epoch_max_rows
                or (q.empty() and (now - last_arrival) >= settle_s)
            )
            snap_elapsed_ms = (now - self._last_snapshot_at.get(w, 0.0)) * 1000.0
            status = (
                any(buffers.values()) or bool(carry) or not q.empty(),
                len(open_subjects),
                aux_pending,
                commit_requested,
                self._stop.is_set(),
                elapsed_ms,
                tuple(sorted(nid for nid, b in buffers.items() if b)),
                snap_elapsed_ms,
                wants_cut,
            )
            _tr0 = _time.monotonic()
            # round_statuses, NOT allgather: the per-round consensus rides
            # the pipelined sender streams (piggybacked with data frames),
            # keeping the steady state at ONE synchronization rendezvous
            # per round; allgather stays for O(1) run-boundary agreements
            statuses = cluster.round_statuses(round_no, tid, status)
            if _EPOCH_TRACE:
                import sys as _sys

                _sys.stderr.write(
                    f"[trace w{w}] round {round_no} status gather "
                    f"{(_time.monotonic() - _tr0)*1e3:.1f}ms "
                    f"buf={sum(len(b) for b in buffers.values())} "
                    f"t={_time.monotonic():.3f}\n"
                )
            round_no += 1
            any_data = any(s[0] for s in statuses)
            all_closed = all(s[1] == 0 for s in statuses)
            no_aux = all(s[2] == 0 for s in statuses)
            any_commit = any(s[3] for s in statuses)
            stop = any(s[4] for s in statuses)
            autocommit_due = max(s[5] for s in statuses) >= self.autocommit_ms
            buffered_ids = {nid for s in statuses for nid in s[6]}
            any_wants_cut = any(s[8] for s in statuses)
            # snapshot decision is a pure function of the GATHERED statuses
            # (max elapsed-since-snapshot), so every worker snapshots at the
            # same cut epoch — a per-worker clock decision here would let
            # worker A snapshot at epoch N while B holds N-1, corrupting
            # recovery (rows exchanged in the gap epoch lost or doubled)
            snapshot_due = max(s[7] for s in statuses)
            source_done = all_closed and no_aux
            if buffered_ids and (
                any_commit or any_wants_cut or autocommit_due or source_done or stop
            ):
                inject = {nid: b for nid, b in buffers.items() if b}
                buffers = defaultdict(list)
                commit_requested = False
                consumed = getattr(ctx, "consumed", {})
                for nid, b in inject.items():
                    consumed[nid] = consumed.get(nid, 0) + len(b)
                cut_ns = now_ns()
                if origin_ns is not None:
                    lat.record("cut", cut_ns - origin_ns)
                # sink/e2e anchors for output nodes (ctx is per worker —
                # sinks route to worker 0, which records against its own
                # locally-buffered origin)
                ctx.latency = lat
                ctx.epoch_origin_ns = origin_ns
                ctx.epoch_cut_ns = cut_ns
                ep0 = _time.monotonic()
                # trace: the whole epoch runs under the round's
                # deterministic cross-rank context — exchange / status /
                # checkpoint spans inside stitch into one timeline across
                # every rank (round_no was already advanced past the
                # gather round that cut this epoch)
                _ectx = (
                    epoch_trace_context(round_no - 1)
                    if _tracing.enabled()
                    else None
                )
                # only exchange at operators data can actually reach — the
                # closure is identical on every worker (same gathered ids)
                with _tracing.use(_ectx), _tracing.span(
                    "epoch_process", {"round": round_no - 1, "tid": tid}
                ):
                    self.run_epoch(
                        t, inject, ctx=ctx, cluster=cluster, tid=tid,
                        active=self.active_closure(buffered_ids),
                    )
                last_epoch_s = _time.monotonic() - ep0
                ctx.epoch_origin_ns = None
                ctx.epoch_cut_ns = None
                lat.record("process", int(last_epoch_s * 1e9))
                t += TIME_STEP
                rows_buffered = 0
                first_arrival = None
                origin_ns = None
                if tid == 0 and self.gc_tick is not None:
                    self.gc_tick()  # gc is process-wide: one thread sweeps
                if tid == 0:
                    self._push_serving_pressure()
                if (
                    self.persistence is not None
                    and self.persistence.operator_mode
                ):
                    if snapshot_due >= self._snapshot_interval():
                        # every worker reaches the same verdict (gathered
                        # max), so all checkpoint this same cut epoch — a
                        # globally-consistent coordinated checkpoint.
                        # Async: state pickles here, disk I/O rides the
                        # persistence writer thread off the epoch loop.
                        self._last_snapshot_at[w] = _time.monotonic()
                        with _tracing.span(
                            "checkpoint_write",
                            {"worker": w, "epoch": int(t - TIME_STEP)},
                            ctx=_ectx,
                        ):
                            self._final_snapshot(
                                w, t - TIME_STEP, consumed, wrappers, ctx=ctx,
                                asynchronous=True,
                            )
            elif stop or (source_done and not any_data):
                break
            else:
                # event-driven park (replaces the fixed poll sleep): wait
                # on the cluster hub, woken by a local connector enqueue,
                # a peer frame arrival, any worker entering the next
                # round's collective, the GC pacer, or stop().  With data
                # buffered the wait is bounded by the remaining settle /
                # autocommit-hold window; idle it is bounded by the
                # autocommit interval as a defensive heartbeat only.
                if q.empty() and not carry:
                    now = _time.monotonic()
                    if first_arrival is not None:
                        deadline = min(
                            last_arrival + settle_s,
                            first_arrival + autocommit_s,
                        )
                        wait_s = deadline - now
                    else:
                        wait_s = autocommit_s
                    if wait_s > 0.0:
                        hub.wait(wake_seen, wait_s)
        ctx.time = t
        self._finish(
            ctx=ctx, cluster=cluster, tid=tid,
            post_epoch=lambda: self._final_snapshot(
                w, ctx.time, getattr(ctx, "consumed", {}), wrappers, ctx=ctx
            ),
        )
        # final error-log exchange: errors are logged on whichever worker
        # (possibly another PROCESS) owned the row; gather so the caller's
        # returned context reports them topology-independently.  Best
        # effort — a torn-down cluster must not mask the run result.
        try:
            gathered = cluster.allgather(("errlog", "final"), tid, list(ctx.error_log))
            ctx.all_errors = [e for worker_errs in gathered for e in worker_errs]  # type: ignore[attr-defined]
        except Exception:
            pass

    def _cluster_replay(
        self,
        cluster: Cluster,
        tid: int,
        ctx: RunContext,
        my_inputs: list[tuple[InputNode, Any]],
        t: int,
        static_inject: dict[int, Batch] | None = None,
    ) -> tuple[int, dict[int, int]]:
        """Replay persisted input snapshots in lockstep across workers.
        Returns (next epoch time, data-event count replayed per input).

        With an operator snapshot (OPERATOR_PERSISTING), each worker
        restores its own state shard and replays only its committed tail;
        the starting epoch and replay epoch count are agreed by allgather
        so collectives stay aligned."""
        replayed_counts: dict[int, int] = {}
        epochs_per_input: dict[int, list[Batch]] = {}
        snap: dict | None = None
        if self.persistence is not None:
            w = cluster.worker_index(tid)
            # every worker checks (reads are cheap; the meta write is
            # guarded by "stored is None") so a topology mismatch raises
            # the clear error on ALL processes BEFORE any stream truncation
            self.persistence.check_topology(cluster.n_workers)
            if self.persistence.operator_mode:
                snap = self.persistence.load_operator_snapshot(w)
                # all-or-none AND epoch-consistent: a missing blob (crash
                # between per-worker saves) or epoch skew between workers'
                # snapshots forces full replay everywhere — resuming from
                # mixed cut epochs would lose or double-apply rows
                # exchanged in the gap epochs
                metas = cluster.allgather(
                    ("snap_presence",),
                    tid,
                    (snap is not None, snap["epoch"] if snap is not None else -1),
                )
                if not all(m[0] for m in metas) or len({m[1] for m in metas}) > 1:
                    snap = None
            consumed: dict[int, int] = dict(snap["consumed"]) if snap else {}
            ctx.consumed = consumed  # type: ignore[attr-defined]
            if snap is not None:
                ctx.states = snap["states"]
                self._restore_nodes(ctx)
            for node, _subject in my_inputs:
                events = self.persistence.replay_events(node, worker=w)
                data = [e for e in events if e[0] != "commit"]
                replayed_counts[node.id] = len(data)
                if snap is not None:
                    skip = consumed.get(node.id, 0)
                    tail = data[skip:]
                    consumed[node.id] = max(skip, len(data))
                    if tail:
                        epochs_per_input[node.id] = [
                            [
                                Update(key, values, 1 if kind == "add" else -1)
                                for kind, key, values in tail
                            ]
                        ]
                    continue
                consumed[node.id] = len(data)
                epochs: list[Batch] = []
                cur: list[Update] = []
                for kind, key, values in events:
                    if kind == "add":
                        cur.append(Update(key, values, 1))
                    elif kind == "remove":
                        cur.append(Update(key, values, -1))
                    elif kind == "commit" and cur:
                        epochs.append(cur)
                        cur = []
                if epochs:
                    epochs_per_input[node.id] = epochs
        # agree on the starting epoch (snapshot epochs may differ per
        # worker) and on the replay epoch count — exchange slots are keyed
        # by time, so every worker must walk the same sequence
        my_len = max((len(e) for e in epochs_per_input.values()), default=0)
        my_t0 = (snap["epoch"] + TIME_STEP) if snap is not None else t
        agreed = cluster.allgather(
            ("replay_len",), tid, (my_len, my_t0, snap is not None)
        )
        n_epochs = max(a[0] for a in agreed)
        t = max(max(a[1] for a in agreed), t)
        any_snap = any(a[2] for a in agreed)
        if static_inject is not None and not any_snap:
            # static rows: one collective epoch, injected on worker 0 only
            # (snapshots already contain them, hence the any_snap guard)
            self.run_epoch(t, static_inject, ctx=ctx, cluster=cluster, tid=tid)
            t += TIME_STEP
        for i in range(n_epochs):
            inject = {
                nid: epochs[i]
                for nid, epochs in epochs_per_input.items()
                if i < len(epochs)
            }
            self.run_epoch(t, inject, ctx=ctx, cluster=cluster, tid=tid)
            t += TIME_STEP
        return t, replayed_counts

    def _spawn_supervised(
        self,
        node: InputNode,
        subject: Any,
        q: "queue.Queue",
        wrappers: dict[int, Any],
        replayed: int,
        ctx: Any,
        worker: int = 0,
        wake: Callable[[], None] | None = None,
    ) -> threading.Thread:
        """Start the connector supervisor for one live input.  The reader
        no longer dies permanently on the first exception: the supervisor
        restarts it per ``node.recovery_policy`` (default: the historical
        one-failure-drops-the-source behaviour), building a fresh events
        chain per attempt that resumes past the data events the engine
        already consumed."""
        from pathway_tpu_torch.internals.resilience import ConnectorSupervisor

        with self._prober_lock:
            # counter-key setdefaults inside ConnectorEvents must happen
            # under the lock: a concurrent snapshot's dict(s) copy would
            # otherwise hit a resizing dict
            cstats = self.connector_stats.setdefault(f"{node.name}#{node.id}", {})

        def make_events(resume: int) -> Any:
            with self._prober_lock:
                events: Any = ConnectorEvents(
                    q,
                    node.id,
                    self._stop,
                    stats=cstats,
                    now_ns=self.latency.now_ns,
                    wake=wake,
                    credit=self.ingest_credit,
                    on_overflow=getattr(node, "on_overflow", None),
                )
            if self.persistence is not None:
                events = self.persistence.wrap_events(
                    node, events, resume, worker=worker
                )
                # rebind, so snapshot force-commits hit the LIVE attempt's
                # recording wrapper (key reassignment, never a dict resize)
                wrappers[node.id] = events
            return events

        sup = ConnectorSupervisor(
            node,
            subject,
            make_events,
            getattr(node, "recovery_policy", None),
            ctx=ctx,
            stats=cstats,
            stop_event=self._stop,
            initial_resume=replayed,
            skip_handled_by_events=(
                # the persistence recording wrapper skips the resume
                # prefix itself — but only for nodes it actually wraps
                self.persistence is not None
                and not self.persistence.replay_only
                and not getattr(node, "auxiliary", False)
                and self.persistence.persisted(node)
            ),
            stop_runner=self.stop,
        )
        return sup.start()

    def stop(self) -> None:
        self._stop.set()
        # wake any loop parked in an event wait so shutdown is immediate
        # (q.get / hub.wait would otherwise run out their heartbeat first)
        self.wake()
