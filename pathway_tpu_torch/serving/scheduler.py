"""SLO-class scheduler: weighted-fair queues over device-time lanes.

VectorLiteRAG's observation (PAPERS.md): under mixed RAG load the fight
is for *device time* between index-search traffic and embed/generation
traffic — and tail latency is held by partitioning it, not by FIFO.
:class:`SloScheduler` models that partition explicitly:

- **lanes** — one per device-resource kind (``"search"`` for index
  probes, ``"embed"`` for embedding/generation batches), each with a
  configured share of device time.  The dispatcher picks the eligible
  lane with the smallest ``busy_time / share`` (deficit arbitration), so
  a burst of batch embeds cannot starve index probes.
- **weighted-fair queues per (lane, tenant class)** — classic virtual
  finish times: a task's ``vfinish = max(lane vtime, class's last
  vfinish) + cost / weight``; the queue with the smallest head vfinish
  dispatches next.  With interactive weight 4 and batch weight 1, a
  saturated batch tenant gets 1/5 of a contended lane, no matter how
  deep its backlog.
- **latency-aware batch sizing** — coalescable tasks (same ``coalesce``
  key) merge into one call sized ``target_ms / ewma_item_ms`` (clamped
  to ``max_batch``): batches grow only while the per-item service time
  keeps the batch under the lane's latency target.

All handoffs ride the shared :class:`WakeupHub` (generation waits with
finite timeouts — lint LK003/LK006); results come back as
``concurrent.futures.Future``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable

from pathway_tpu_torch.engine.cluster import WakeupHub
from pathway_tpu_torch.internals import tracing as _tracing

from .admission import DEFAULT_CLASS_WEIGHTS

__all__ = ["SloScheduler"]

_EWMA_ALPHA = 0.2


class _Task:
    __slots__ = (
        "fn",
        "item",
        "future",
        "lane",
        "tenant_class",
        "coalesce",
        "cost",
        "vfinish",
        "enq_ns",
        "trace",
    )

    def __init__(
        self,
        fn: Callable,
        item: Any,
        future: Future,
        lane: str,
        tenant_class: str,
        coalesce: Any,
        cost: float,
        vfinish: float,
        enq_ns: int,
        trace: Any = None,
    ):
        self.fn = fn
        self.item = item
        self.future = future
        self.lane = lane
        self.tenant_class = tenant_class
        self.coalesce = coalesce
        self.cost = cost
        self.vfinish = vfinish
        self.enq_ns = enq_ns
        self.trace = trace


class SloScheduler:
    """Weighted-fair, lane-partitioned dispatcher for serving stages."""

    def __init__(
        self,
        *,
        lanes: dict[str, float] | None = None,
        class_weights: dict[str, float] | None = None,
        target_ms: dict[str, float] | None = None,
        max_batch: int = 32,
        hub: WakeupHub | None = None,
        probe: Any = None,
        idle_wait_s: float = 0.05,
        name: str = "slo_scheduler",
    ):
        self._lanes = dict(lanes or {"search": 1.0, "embed": 1.0})
        self._class_weights = dict(class_weights or DEFAULT_CLASS_WEIGHTS)
        self._target_ns = {
            lane: int(
                (target_ms or {}).get(lane, 10.0) * 1e6
            )
            for lane in self._lanes
        }
        self.max_batch = max(1, int(max_batch))
        self.hub = hub if hub is not None else WakeupHub()
        self.probe = probe
        self._idle_wait_s = idle_wait_s
        self._lock = threading.Lock()
        self._queues: dict[tuple[str, str], deque[_Task]] = {}
        self._vtime: dict[str, float] = {lane: 0.0 for lane in self._lanes}
        self._last_vf: dict[tuple[str, str], float] = {}
        self._busy_ns: dict[str, int] = {lane: 0 for lane in self._lanes}
        self._ewma_item_ns: dict[str, float] = {}
        self._dispatched: dict[tuple[str, str], int] = {}
        self._last_batch: dict[str, int] = {}
        # per-lane span args, built once: the queue-wait record is per
        # request, so a fresh dict per record is measurable overhead
        self._lane_args: dict[str, dict] = {}
        self._submitted = 0
        self._completed = 0
        #: brownout pressure in [0, 1]: under pressure, lighter classes
        #: accrue virtual time faster (see submit), deferring batch work
        #: behind interactive work harder than steady-state WFQ does
        self._pressure = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name
        )
        self._thread.start()
        from pathway_tpu_torch import serving as _serving

        _serving._register_scheduler(self)

    def ensure_lane(
        self, lane: str, share: float = 1.0, target_ms: float = 10.0
    ) -> None:
        """Add a device-time lane at runtime if it doesn't exist yet.

        Used by the shard-failover path to carve out a low-share
        ``recover`` lane: restore work then competes for device time
        under the same deficit arbitration as live queries instead of
        stealing it (or bypassing the partition entirely)."""
        with self._lock:
            if lane in self._lanes:
                return
            self._lanes[lane] = float(share)
            self._target_ns[lane] = int(target_ms * 1e6)
            self._vtime[lane] = 0.0
            self._busy_ns[lane] = 0

    # -------------------------------------------------------------- submit

    def submit(
        self,
        lane: str,
        tenant_class: str,
        fn: Callable,
        item: Any = None,
        *,
        coalesce: Any = None,
        cost: float = 1.0,
        trace: Any = None,
    ) -> Future:
        """Enqueue one unit of lane work; returns its Future.

        ``coalesce`` non-None marks the task mergeable: the dispatcher
        may batch same-key neighbors into one ``fn(list_of_items)`` call
        returning one result per item, in order.  ``coalesce=None`` runs
        ``fn(item)`` alone.  ``trace`` (a
        :class:`~pathway_tpu_torch.internals.tracing.TraceContext`) rides the
        task across the queue: the dispatcher records the lane queue-wait
        as a span under it and executes single-task work with it ambient."""
        if lane not in self._lanes:
            raise KeyError(f"unknown lane {lane!r} (have {sorted(self._lanes)})")
        fut: Future = Future()
        now_ns = time.monotonic_ns()
        weight = self._class_weights.get(tenant_class, 1.0)
        pressure = self._pressure
        if pressure > 0.0:
            # brownout: stretch the weight spread — the heaviest class
            # keeps its share, lighter ones fall behind proportionally
            # harder, so interactive queue-wait holds while batch defers
            w_max = max(self._class_weights.values(), default=1.0)
            weight = weight / (
                1.0 + pressure * (w_max / max(weight, 1e-9) - 1.0)
            )
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("scheduler closed")
            qkey = (lane, tenant_class)
            start = max(self._vtime[lane], self._last_vf.get(qkey, 0.0))
            vfinish = start + float(cost) / max(weight, 1e-9)
            self._last_vf[qkey] = vfinish
            task = _Task(
                fn, item, fut, lane, tenant_class, coalesce, cost, vfinish,
                now_ns, trace,
            )
            self._queues.setdefault(qkey, deque()).append(task)
            self._submitted += 1
        self.hub.notify()
        return fut

    # ------------------------------------------------------------ dispatch

    def _batch_target_locked(self, lane: str) -> int:
        ewma = self._ewma_item_ns.get(lane, 0.0)
        if ewma <= 0.0:
            return self.max_batch  # no signal yet: let the batch form
        return max(1, min(self.max_batch, int(self._target_ns[lane] / ewma)))

    def _select(self) -> tuple[str, str, list[_Task]] | None:
        with self._lock:
            lanes_with_work = [
                lane
                for lane in self._lanes
                if any(
                    q and key[0] == lane for key, q in self._queues.items()
                )
            ]
            if not lanes_with_work:
                return None
            # deficit arbitration: least-served lane (busy/share) first
            lane = min(
                lanes_with_work,
                key=lambda ln: self._busy_ns[ln] / self._lanes[ln],
            )
            # WFQ pick: smallest head virtual-finish among this lane's
            # class queues
            heads = [
                (q[0].vfinish, key[1])
                for key, q in self._queues.items()
                if q and key[0] == lane
            ]
            _, cls = min(heads)
            q = self._queues[(lane, cls)]
            head = q.popleft()
            self._vtime[lane] = max(self._vtime[lane], head.vfinish)
            tasks = [head]
            if head.coalesce is not None:
                n = self._batch_target_locked(lane)
                while len(tasks) < n and q and q[0].coalesce == head.coalesce:
                    t = q.popleft()
                    self._vtime[lane] = max(self._vtime[lane], t.vfinish)
                    tasks.append(t)
            qkey = (lane, cls)
            self._dispatched[qkey] = self._dispatched.get(qkey, 0) + len(tasks)
            self._last_batch[lane] = len(tasks)
            return lane, cls, tasks

    def _execute(self, lane: str, cls: str, tasks: list[_Task]) -> None:
        t0 = time.monotonic_ns()
        if self.probe is not None:
            for t in tasks:
                self.probe.record("serve_sched", cls, t0 - t.enq_ns)
        # lane queue-wait, per request: the time between submit and this
        # dispatch is a span on each task's own trace — tail attribution
        # can then tell queue-wait from service time
        if _tracing.enabled():
            wait_args = self._lane_args.get(lane)
            if wait_args is None:
                wait_args = self._lane_args[lane] = {"lane": lane}
            for t in tasks:
                if t.trace is not None:
                    _tracing.record_span(
                        "serve_sched_wait", t.enq_ns, t0, ctx=t.trace,
                        args=wait_args,
                    )
        # single-task (or single-trace batch) execution adopts the trace
        # as ambient so spans inside fn — index dispatch/collect — nest;
        # a mixed-trace coalesced batch has no single owner, so none
        exec_ctx = tasks[0].trace
        for t in tasks[1:]:
            if t.trace is not exec_ctx:
                exec_ctx = None
                break
        prev_ctx = _tracing.set_ambient(exec_ctx)
        try:
            if tasks[0].coalesce is not None:
                results = tasks[0].fn([t.item for t in tasks])
                for t, r in zip(tasks, results):
                    if not t.future.done():
                        t.future.set_result(r)
            else:
                r = tasks[0].fn(tasks[0].item)
                if not tasks[0].future.done():
                    tasks[0].future.set_result(r)
        except BaseException as e:  # noqa: BLE001 — fault goes to callers
            for t in tasks:
                if not t.future.done():
                    t.future.set_exception(e)
        finally:
            _tracing.set_ambient(prev_ctx)
        dt = time.monotonic_ns() - t0
        per_item = dt / len(tasks)
        with self._lock:
            self._busy_ns[lane] += dt
            prev = self._ewma_item_ns.get(lane)
            self._ewma_item_ns[lane] = (
                per_item
                if prev is None
                else (1 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * per_item
            )
            self._completed += len(tasks)

    def _loop(self) -> None:
        while not self._stop.is_set():
            seen = self.hub.seq()
            picked = self._select()
            if picked is None:
                self.hub.wait(seen, self._idle_wait_s)
                continue
            self._execute(*picked)

    # --------------------------------------------------------------- admin

    def drain(self, timeout: float = 10.0) -> bool:
        """Generation-wait until every submitted task completed (True) or
        the deadline passes (False)."""
        deadline = time.monotonic() + timeout
        while True:
            seen = self.hub.seq()
            with self._lock:
                done = self._completed >= self._submitted
            if done:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self.hub.wait(seen, min(remaining, 0.05))

    def stats(self) -> dict[str, Any]:
        with self._lock:
            lanes = {
                lane: {
                    "share": self._lanes[lane],
                    "busy_ms": self._busy_ns[lane] / 1e6,
                    "ewma_item_us": self._ewma_item_ns.get(lane, 0.0) / 1e3,
                    "last_batch": self._last_batch.get(lane, 0),
                    "queued": sum(
                        len(q)
                        for key, q in self._queues.items()
                        if key[0] == lane
                    ),
                }
                for lane in self._lanes
            }
            classes: dict[str, dict[str, int]] = {}
            for (lane, cls), n in self._dispatched.items():
                c = classes.setdefault(cls, {"dispatched": 0, "queued": 0})
                c["dispatched"] += n
            for (lane, cls), q in self._queues.items():
                c = classes.setdefault(cls, {"dispatched": 0, "queued": 0})
                c["queued"] += len(q)
            return {
                "lanes": lanes,
                "classes": classes,
                "submitted": self._submitted,
                "completed": self._completed,
                "pressure": self._pressure,
            }

    def set_pressure(self, level: float) -> None:
        """Brownout input (see :meth:`submit`); clamped to [0, 1]."""
        self._pressure = min(1.0, max(0.0, float(level)))
        self.hub.notify()

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.hub.notify()
        self._thread.join(timeout)
        # fail any tasks still queued so callers never block on a dead
        # dispatcher
        with self._lock:
            leftovers = [t for q in self._queues.values() for t in q]
            for q in self._queues.values():
                q.clear()
        for t in leftovers:
            if not t.future.done():
                t.future.set_exception(RuntimeError("scheduler closed"))
