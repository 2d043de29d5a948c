"""Deterministic, seedable fault-injection harness for chaos testing.

The port's counterpart of ``pathway_tpu/testing/chaos.py``.  Drives the
crash-recovery drills in ``tests/test_torch_chaos.py`` and
``chip_smoke.py``'s persistence phase, and is usable against real
pipelines: every fault is injected by monkey-patching a *specific* call
site under a context manager, so a test
reads as "this exact operation fails on its Nth invocation" — no sleeps,
no racing kill signals, fully reproducible under a fixed ``seed``.

Fault classes (mirrors the failure modes the supervisor and persistence
layers must survive):

- :meth:`chaos.raise_on_nth_call` — transient exception on the Nth call.
- :meth:`chaos.inject_latency` — fixed or seeded-random delay per call
  (exercises watchdogs and autocommit timers).
- :meth:`chaos.torn_write` — an ``_FsBackend.append`` that writes a
  *partial* record then dies (crash mid-append; replay must treat the
  torn tail as absent).
- :meth:`chaos.crash_between_snapshot_and_commit` — the operator
  snapshot is persisted, then the process "dies" before the run
  continues (resume must not double-apply).

Cluster fault primitives:

- :meth:`chaos.kill_worker` — a chosen worker rank dies at the start of
  its Nth epoch (``ChaosError`` or a hard ``os._exit`` — the latter is
  what a real SIGKILL looks like to the rest of the mesh).
- :meth:`chaos.kill_worker_mid_merge` — the process hosting a chosen
  rank dies in the instant between a finished background index merge
  and its atomic commit (``SegmentedIndex._pre_commit``), the widest
  crash window online index maintenance has.
- :meth:`chaos.delay_exchange_frames` / :meth:`chaos.drop_exchange_frames`
  — latency or loss injected at the peer link's single egress point
  (``_PeerSender._transmit``); dropping mutes heartbeats too, so a muted
  peer becomes *detectably* dead.

Gray-failure primitives (the failures that are NOT clean crashes —
asymmetric, partial, or slow — the modes membership layers classically
misdiagnose):

- :meth:`chaos.asymmetric_partition` — delay or drop frames in exactly
  ONE direction (``src -> dst``); the reverse path stays perfect, so
  ``src`` looks dead to ``dst`` while ``dst`` looks fine to ``src``.
- :meth:`chaos.pause_resume` — SIGSTOP a live OS process and SIGCONT it
  after a pause: the process is silent (no heartbeats, no frames, no
  exit code) then wakes and resumes sending as if nothing happened —
  exactly a long GC pause / VM migration.  Survivors must mark it
  suspect/dead and then handle the stale frames that resume on wake.
- :meth:`chaos.slow_peer` — every outbound transmission from one rank is
  slowed (seeded jitter): a degraded-but-alive peer that drags epochs
  without ever missing a liveness deadline.
Overload primitives (sustained pressure rather than failure):

- :meth:`chaos.firehose_source` — a seedable synthetic source pushing
  rows at a target rate (or flat-out); when the ingest credit buffer
  fills, its ``next()`` calls park inside the connector queue's
  ``charge`` — the backpressure path under test.
- :meth:`chaos.stall_sink` — every sink delivery
  (``OutputNode.process``) with data sleeps: a wedged downstream
  writer.  Sinks are synchronous with the epoch cut, so the stall
  holds the drain loop and pressure propagates back to the sources.
- :meth:`chaos.slow_consumer` — one worker rank's epochs take
  ``factor``× their real time: a degraded-but-alive *consumer* whose
  exchange mailboxes back up, exercising sender-side credit
  (``PATHWAY_EXCHANGE_CREDIT_BYTES``) instead of liveness isolation.

- :class:`ClusterDrill` — seedable end-to-end drill: run a wordcount
  cluster fault-free, re-run it with a worker killed at a random epoch
  under :class:`~pathway_tpu_torch.internals.resilience.ClusterSupervisor`,
  and assert the recovered output is byte-identical.
- :class:`IndexDrill` — the live-index variant: a vector index under
  upsert churn, killed mid-merge, must recover with exactly-once
  upserts (index size equals the distinct doc count — nothing dropped,
  nothing double-applied) and recall over the final corpus.

Usage::

    from pathway_tpu_torch.testing import chaos

    with chaos(seed=7) as c:
        c.raise_on_nth_call(SomeReader, "poll", n=3)
        run_pipeline()
    assert c.call_count(SomeReader, "poll") >= 3
"""

from __future__ import annotations

import functools
import os
import random
import threading
import time as _time
from typing import Any, Callable, Iterable

__all__ = ["ChaosError", "ClusterDrill", "IndexDrill", "chaos", "flaky_once"]


class ChaosError(RuntimeError):
    """The marker exception raised by injected faults."""


class chaos:
    """Seedable fault-injection context manager (restores every patch on
    exit, even when the body raises)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        #: (owner, attr, original) in application order
        self._patches: list[tuple[Any, str, Any]] = []
        #: one counter PER PATCH (faults may stack on the same attr; a
        #: shared per-attr counter would double-count each call)
        self._counters: dict[tuple[int, str, int], int] = {}
        self._lock = threading.Lock()
        self._entered = False

    # -- lifecycle ------------------------------------------------------
    def __enter__(self) -> "chaos":
        self._entered = True
        return self

    def __exit__(self, *exc: Any) -> None:
        self.restore()

    def restore(self) -> None:
        """Undo every patch (reverse order)."""
        while self._patches:
            owner, attr, orig = self._patches.pop()
            setattr(owner, attr, orig)

    # -- bookkeeping ----------------------------------------------------
    def _counter_key(self, owner: Any, attr: str) -> tuple[int, str, int]:
        """Reserve a fresh counter slot for one patch."""
        return (id(owner), attr, len(self._patches))

    def _bump(self, key: tuple[int, str, int]) -> int:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + 1
            return self._counters[key]

    def call_count(self, owner: Any, attr: str) -> int:
        """How many times the patched ``owner.attr`` was invoked (with
        stacked faults each call passes through every layer once, so the
        max across this attr's patch counters is the invocation count)."""
        with self._lock:
            return max(
                (
                    v
                    for (oid, a, _i), v in self._counters.items()
                    if oid == id(owner) and a == attr
                ),
                default=0,
            )

    def _patch(self, owner: Any, attr: str, replacement: Callable) -> None:
        orig = getattr(owner, attr)
        self._patches.append((owner, attr, orig))
        setattr(owner, attr, replacement)

    # -- faults ---------------------------------------------------------
    def raise_on_nth_call(
        self,
        owner: Any,
        attr: str,
        n: int,
        exc_factory: Callable[[], BaseException] | None = None,
        every: bool = False,
    ) -> None:
        """The Nth invocation (1-based) of ``owner.attr`` raises; with
        ``every=True`` every invocation from the Nth on raises (a
        permanent fault instead of a transient one)."""
        orig = getattr(owner, attr)
        key = self._counter_key(owner, attr)
        make_exc = exc_factory or (
            lambda: ChaosError(f"injected fault: {attr} call #{n}")
        )

        @functools.wraps(orig)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            count = self._bump(key)
            if count == n or (every and count >= n):
                raise make_exc()
            return orig(*args, **kwargs)

        self._patch(owner, attr, wrapper)

    def inject_latency(
        self,
        owner: Any,
        attr: str,
        delay_s: float = 0.05,
        jitter_s: float = 0.0,
        limit: int | None = None,
    ) -> None:
        """Sleep before each call of ``owner.attr`` (``delay_s`` plus a
        seeded uniform draw from ``[0, jitter_s]``); ``limit`` bounds how
        many calls are delayed."""
        orig = getattr(owner, attr)
        key = self._counter_key(owner, attr)

        @functools.wraps(orig)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            count = self._bump(key)
            if limit is None or count <= limit:
                _time.sleep(delay_s + self.rng.uniform(0.0, jitter_s))
            return orig(*args, **kwargs)

        self._patch(owner, attr, wrapper)

    def torn_write(
        self,
        backend_impl: Any,
        on_nth: int = 1,
        keep_fraction: float = 0.5,
    ) -> None:
        """The Nth ``append`` on a filesystem persistence backend writes
        the length header plus only ``keep_fraction`` of the payload,
        then raises :class:`ChaosError` — exactly what a crash mid-append
        leaves on disk.  ``read_all``/``replay_events`` must treat the
        torn tail as absent."""
        orig = backend_impl.append
        key = self._counter_key(backend_impl, "append")

        def wrapper(stream: str, record: bytes, durable: bool = True) -> None:
            count = self._bump(key)
            if count != on_nth:
                return orig(stream, record, durable)
            # write a torn record exactly as _FsBackend lays them out:
            # full length header, truncated payload, no trailing bytes
            keep = max(0, min(len(record) - 1, int(len(record) * keep_fraction)))
            with backend_impl._lock:
                backend_impl._offsets.pop(stream, None)
                f = backend_impl._handle(stream)
                f.write(len(record).to_bytes(8, "little"))
                f.write(record[:keep])
                f.flush()
                backend_impl._drop_handle(stream)
            raise ChaosError(
                f"injected torn write on stream {stream!r} (append #{count})"
            )

        self._patch(backend_impl, "append", wrapper)

    def crash_between_snapshot_and_commit(self, hooks: Any, on_nth: int = 1) -> None:
        """An operator snapshot persists, then the process "dies" before
        the run carries on — the crash window between a checkpoint landing
        on disk and the epoch loop continuing.  Resume from that snapshot
        must replay only the committed tail (no loss, no double-apply).

        Counts the synchronous (``save_operator_snapshot``) and
        asynchronous (``save_operator_snapshot_async``, used by periodic
        checkpoints) paths on ONE shared counter; on the async path the
        queued blob is flushed to disk before the injected death so the
        crash window is identical in both cases."""
        shared = {"count": 0}
        shared_lock = threading.Lock()

        def _next() -> int:
            with shared_lock:
                shared["count"] += 1
                return shared["count"]

        orig_sync = hooks.save_operator_snapshot
        key_sync = self._counter_key(hooks, "save_operator_snapshot")

        def wrapper_sync(*args: Any, **kwargs: Any) -> Any:
            self._bump(key_sync)
            count = _next()
            result = orig_sync(*args, **kwargs)
            if count == on_nth:
                raise ChaosError(
                    f"injected crash after operator snapshot #{count}"
                )
            return result

        self._patch(hooks, "save_operator_snapshot", wrapper_sync)

        orig_async = getattr(hooks, "save_operator_snapshot_async", None)
        if orig_async is None:
            return
        key_async = self._counter_key(hooks, "save_operator_snapshot_async")

        def wrapper_async(*args: Any, **kwargs: Any) -> Any:
            self._bump(key_async)
            count = _next()
            result = orig_async(*args, **kwargs)
            if count == on_nth:
                flush = getattr(hooks, "flush_checkpoints", None)
                if flush is not None:
                    flush()  # the snapshot must be ON DISK when we "die"
                raise ChaosError(
                    f"injected crash after operator snapshot #{count}"
                )
            return result

        self._patch(hooks, "save_operator_snapshot_async", wrapper_async)

    # -- cluster faults -------------------------------------------------
    def kill_worker(
        self,
        rank: int,
        at_epoch: int,
        hard: bool = False,
        generation: int = 0,
        exit_code: int = 70,
    ) -> None:
        """Worker ``rank`` dies at the start of its ``at_epoch``-th epoch
        (1-based; earlier epochs complete and may have checkpointed).

        ``hard=True`` calls ``os._exit(exit_code)`` — no unwinding, no
        atexit, exactly what SIGKILL looks like to the peer mesh and the
        supervisor; otherwise a :class:`ChaosError` unwinds the worker
        (covers the fatal-operator-error path).  ``generation`` arms the
        fault only in that supervisor respawn generation (matched against
        ``PATHWAY_WORKER_RESTARTS``), so a restarted cluster does not
        re-kill itself forever."""
        from pathway_tpu_torch.engine.scheduler import Scheduler

        if int(os.environ.get("PATHWAY_WORKER_RESTARTS", "0")) != generation:
            return  # a later generation: the fault already fired and is spent
        orig = Scheduler.run_epoch
        key = self._counter_key(Scheduler, "run_epoch")
        epochs_by_rank: dict[int, int] = {}
        rank_lock = threading.Lock()

        @functools.wraps(orig)
        def wrapper(sched: Any, time: int, inject: Any, **kwargs: Any) -> Any:
            self._bump(key)
            ctx = kwargs.get("ctx") or sched.ctx
            my_rank = getattr(ctx, "worker_id", 0)
            with rank_lock:
                epochs_by_rank[my_rank] = epochs_by_rank.get(my_rank, 0) + 1
                count = epochs_by_rank[my_rank]
            if my_rank == rank and count == at_epoch:
                if hard:
                    # the whole point of the flight recorder: the dying
                    # process's spans survive an os._exit (which skips
                    # atexit) because we flush the rings right here
                    from pathway_tpu_torch.internals import tracing as _tracing

                    _tracing.flush("chaos_kill")
                    os._exit(exit_code)
                raise ChaosError(
                    f"injected worker death: rank {rank} at epoch #{count}"
                )
            return orig(sched, time, inject, **kwargs)

        self._patch(Scheduler, "run_epoch", wrapper)

    def kill_worker_mid_merge(
        self,
        rank: int,
        on_nth_merge: int = 1,
        generation: int = 0,
        exit_code: int = 71,
    ) -> None:
        """The process hosting worker ``rank`` dies (hard ``os._exit``)
        in the instant between a finished background index merge and its
        atomic commit — :meth:`SegmentedIndex._pre_commit`, the widest
        crash window online index maintenance has: the merge work is
        done but none of it is published, and the last checkpoint holds
        the pre-merge segmentation.  Recovery must restore that
        checkpoint, replay the connector tail (idempotent upserts), and
        simply re-merge — nothing lost, nothing double-applied.

        ``on_nth_merge`` counts merge commits within the armed process
        (1-based); ``generation`` arms the fault only in that supervisor
        respawn generation (vs ``PATHWAY_WORKER_RESTARTS``) so the
        restarted cluster does not re-kill itself forever.  The rank is
        matched against ``PATHWAY_PROCESS_ID`` at arm time: the merge
        runs on a maintenance thread with no worker context, so the
        fault is scoped per process, not per in-process thread."""
        from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex

        if int(os.environ.get("PATHWAY_WORKER_RESTARTS", "0")) != generation:
            return  # a later generation: the fault already fired and is spent
        if int(os.environ.get("PATHWAY_PROCESS_ID", "0")) != rank:
            return
        orig = SegmentedIndex._pre_commit
        key = self._counter_key(SegmentedIndex, "_pre_commit")

        @functools.wraps(orig)
        def wrapper(seg: Any) -> Any:
            count = self._bump(key)
            if count == on_nth_merge:
                from pathway_tpu_torch.internals import tracing as _tracing

                _tracing.flush("chaos_kill")  # os._exit skips atexit
                os._exit(exit_code)
            return orig(seg)

        self._patch(SegmentedIndex, "_pre_commit", wrapper)

    def delay_exchange_frames(
        self,
        delay_s: float = 0.05,
        jitter_s: float = 0.0,
        limit: int | None = None,
        process_id: int | None = None,
    ) -> None:
        """Sleep before every outbound cluster transmission (data frames
        AND heartbeats) — a slow or congested link.  ``process_id``
        restricts the fault to links owned by one process; ``limit``
        bounds how many transmissions are delayed."""
        from pathway_tpu_torch.engine.cluster import _PeerSender

        orig = _PeerSender._transmit
        key = self._counter_key(_PeerSender, "_transmit")

        @functools.wraps(orig)
        def wrapper(sender: Any, body: Any, n_frames: int) -> Any:
            count = self._bump(key)
            mine = (
                process_id is None
                or getattr(sender.links, "process_id", None) == process_id
            )
            if mine and (limit is None or count <= limit):
                _time.sleep(delay_s + self.rng.uniform(0.0, jitter_s))
            return orig(sender, body, n_frames)

        self._patch(_PeerSender, "_transmit", wrapper)

    def drop_exchange_frames(
        self,
        after: int = 0,
        process_id: int | None = None,
        peer: int | None = None,
    ) -> None:
        """Silently drop every outbound transmission past the first
        ``after`` — a one-way partition.  Dropping happens at the link's
        single egress point, so heartbeats are muted along with data: the
        muted process turns *detectably* dead (liveness timeout) rather
        than silently lossy.  ``process_id``/``peer`` scope the fault to
        one process's links or one destination."""
        from pathway_tpu_torch.engine.cluster import _PeerSender

        orig = _PeerSender._transmit
        key = self._counter_key(_PeerSender, "_transmit")

        @functools.wraps(orig)
        def wrapper(sender: Any, body: Any, n_frames: int) -> Any:
            count = self._bump(key)
            mine = (
                process_id is None
                or getattr(sender.links, "process_id", None) == process_id
            ) and (peer is None or sender.peer == peer)
            if mine and count > after:
                return None  # swallowed by the injected partition
            return orig(sender, body, n_frames)

        self._patch(_PeerSender, "_transmit", wrapper)

    # -- gray failures ---------------------------------------------------
    def asymmetric_partition(
        self,
        src: int,
        dst: int,
        mode: str = "drop",
        delay_s: float = 0.2,
        jitter_s: float = 0.0,
        after: int = 0,
    ) -> None:
        """Break exactly ONE direction of one link: frames from process
        ``src`` to process ``dst`` are dropped (``mode="drop"``) or
        delayed (``mode="delay"``, plus a seeded uniform draw from
        ``[0, jitter_s]``) past the first ``after`` transmissions, while
        ``dst -> src`` stays perfect.

        This is the canonical gray failure: ``dst`` stops hearing
        heartbeats and declares ``src`` suspect/dead, while ``src`` still
        receives from ``dst`` and believes the mesh is whole.  Under the
        isolate fail policy the two sides may hold *different* membership
        views — which is exactly what the drill should assert about."""
        if mode not in ("drop", "delay"):
            raise ValueError(f"mode must be 'drop' or 'delay', got {mode!r}")
        from pathway_tpu_torch.engine.cluster import _PeerSender

        orig = _PeerSender._transmit
        key = self._counter_key(_PeerSender, "_transmit")

        @functools.wraps(orig)
        def wrapper(sender: Any, body: Any, n_frames: int) -> Any:
            count = self._bump(key)
            mine = (
                getattr(sender.links, "process_id", None) == src
                and sender.peer == dst
            )
            if mine and count > after:
                if mode == "drop":
                    return None  # one-way black hole
                _time.sleep(delay_s + self.rng.uniform(0.0, jitter_s))
            return orig(sender, body, n_frames)

        self._patch(_PeerSender, "_transmit", wrapper)

    def pause_resume(
        self, pid: int, pause_s: float = 1.0
    ) -> threading.Timer:
        """SIGSTOP OS process ``pid`` now; SIGCONT it ``pause_s`` seconds
        later (from a daemon timer).  During the pause the process emits
        nothing — no heartbeats, no frames, no exit status — then wakes
        and resumes mid-instruction, the shape of a long GC pause, a VM
        live-migration, or an operator's stray ``kill -STOP``.

        Unlike the monkey-patching faults this targets a *separate* OS
        process (monkey patches don't cross process boundaries), so it is
        the primitive for supervisor/membership drills over real worker
        processes.  Returns the SIGCONT timer; :meth:`restore` (and so
        the context-manager exit) also fires any pending SIGCONT so a
        failing test never leaks a stopped process."""
        import signal

        os.kill(pid, signal.SIGSTOP)
        fired = threading.Event()

        def _resume() -> None:
            if fired.is_set():
                return
            fired.set()
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass  # it died while paused; nothing to resume

        timer = threading.Timer(pause_s, _resume)
        timer.daemon = True
        timer.start()
        # ride the patch-restore machinery: "restoring" this fault means
        # making sure the SIGCONT has been delivered
        self._patches.append((_ResumeOnRestore(timer, _resume), "noop", None))
        return timer

    def slow_peer(
        self,
        process_id: int,
        delay_s: float = 0.05,
        jitter_s: float = 0.02,
    ) -> None:
        """Every outbound transmission from ``process_id`` (to every
        peer) is slowed by ``delay_s`` plus a seeded uniform draw from
        ``[0, jitter_s]`` — a degraded-but-alive rank: it keeps making
        its liveness deadlines while dragging every epoch and probe it
        participates in.  The fault the hedged-collect path
        (``PartitionedIndex`` with ``hedge_timeout_s``) exists for."""
        self.delay_exchange_frames(
            delay_s=delay_s, jitter_s=jitter_s, process_id=process_id
        )

    # -- overload primitives ---------------------------------------------
    def stall_sink(
        self,
        seconds: float,
        limit: int | None = None,
        name: str | None = None,
    ) -> None:
        """Every sink delivery that carries data sleeps ``seconds`` — a
        wedged downstream writer (full disk, throttled API, dead
        consumer).  Patches :meth:`OutputNode.process`, the synchronous
        sink dispatch: the stall holds the epoch cut, the drain loop
        stops taking from the connector queues, the ingest credit buffer
        fills, and the readers park — end-to-end pressure propagation
        with zero data loss under ``on_overflow="pause"``.

        ``limit`` bounds how many deliveries stall (then the sink
        recovers); ``name`` scopes the fault to sinks whose node name
        contains it (default: every sink)."""
        from pathway_tpu_torch.engine.graph import OutputNode

        orig = OutputNode.process
        key = self._counter_key(OutputNode, "process")

        @functools.wraps(orig)
        def wrapper(node: Any, ctx: Any, time: int, inbatches: Any) -> Any:
            count = self._bump(key)
            mine = name is None or name in getattr(node, "name", "")
            if mine and inbatches and inbatches[0]:
                if limit is None or count <= limit:
                    _time.sleep(seconds)
            return orig(node, ctx, time, inbatches)

        self._patch(OutputNode, "process", wrapper)

    def firehose_source(
        self,
        rows_per_sec: float | None,
        total_rows: int,
        vocab: int = 32,
        payload_bytes: int = 64,
        commit_every: int = 64,
        row_factory: Callable[[random.Random, int], dict] | None = None,
    ) -> Any:
        """A seedable synthetic source pushing ``total_rows`` rows at
        ``rows_per_sec`` (``None`` or ``<= 0``: flat-out, the true
        firehose).  Returns a :class:`~pathway_tpu_torch.io.python.ConnectorSubject`
        for ``pw.io.python.read``; default rows are
        ``{"word": "w<k>", "payload": "<payload_bytes of x>"}`` with the
        word drawn from a per-source seeded RNG, or supply
        ``row_factory(rng, i)`` for a custom shape.

        When the source outruns the pipeline and the ingest credit
        buffer (``PATHWAY_INGEST_BUFFER_BYTES``) fills, ``next()`` parks
        inside the connector queue's byte accounting — the reader slows
        to the drain rate instead of growing RSS.  Cuts an epoch every
        ``commit_every`` rows and polls ``stopped`` so shutdown is
        prompt even mid-burst."""
        from pathway_tpu_torch.io.python import ConnectorSubject

        rng = random.Random(self.rng.randrange(2**31))
        interval = (
            1.0 / rows_per_sec if rows_per_sec and rows_per_sec > 0 else 0.0
        )

        class _Firehose(ConnectorSubject):
            def run(subject) -> None:
                start = _time.monotonic()
                for i in range(total_rows):
                    if subject.stopped:
                        return
                    if row_factory is not None:
                        subject.next(**row_factory(rng, i))
                    else:
                        subject.next(
                            word=f"w{rng.randrange(vocab)}",
                            payload="x" * payload_bytes,
                        )
                    if (i + 1) % commit_every == 0:
                        subject.commit()
                    if interval:
                        # pace against the wall clock, not per-row sleeps:
                        # a backpressure pause already "paid" the wait
                        lag = start + (i + 1) * interval - _time.monotonic()
                        if lag > 0:
                            _time.sleep(lag)
                subject.commit()

        return _Firehose(datasource_name="firehose")

    def slow_consumer(self, rank: int, factor: float = 3.0) -> None:
        """Worker ``rank``'s epochs take ``factor``× their real time
        (each :meth:`Scheduler.run_epoch` is followed by a sleep of
        ``elapsed * (factor - 1)``) — a degraded-but-alive *consumer*:
        it keeps heartbeating and acking rounds, but drains its exchange
        mailboxes slowly, so producers sending to it back up against the
        sender-side credit cap (``PATHWAY_EXCHANGE_CREDIT_BYTES``) and
        throttle instead of buffering without bound.  The slow-vs-dead
        distinction under test: this rank must be *backpressured*, never
        isolated."""
        if factor < 1.0:
            raise ValueError(f"factor must be >= 1.0, got {factor}")
        from pathway_tpu_torch.engine.scheduler import Scheduler

        orig = Scheduler.run_epoch
        key = self._counter_key(Scheduler, "run_epoch")

        @functools.wraps(orig)
        def wrapper(sched: Any, time: int, inject: Any, **kwargs: Any) -> Any:
            self._bump(key)
            ctx = kwargs.get("ctx") or sched.ctx
            if getattr(ctx, "worker_id", 0) != rank:
                return orig(sched, time, inject, **kwargs)
            t0 = _time.monotonic()
            try:
                return orig(sched, time, inject, **kwargs)
            finally:
                _time.sleep((_time.monotonic() - t0) * (factor - 1.0))

        self._patch(Scheduler, "run_epoch", wrapper)


class _ResumeOnRestore:
    """Adapter so a pending SIGCONT rides chaos's patch-restore list: the
    restore loop calls ``setattr(owner, "noop", None)`` which lands in
    ``__setattr__`` below and fires the resume."""

    def __init__(self, timer: threading.Timer, resume: Callable[[], None]):
        object.__setattr__(self, "_timer", timer)
        object.__setattr__(self, "_resume", resume)

    def __setattr__(self, name: str, value: Any) -> None:
        object.__getattribute__(self, "_timer").cancel()
        object.__getattribute__(self, "_resume")()


_DRILL_PROGRAM = """
import os, sys
sys.path.insert(0, {repo!r})
import pathway_tpu_torch as pw
from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

_kill_rank = int(os.environ.get("CHAOS_KILL_RANK", "-1"))
if _kill_rank >= 0:
    from pathway_tpu_torch.testing.chaos import chaos as _chaos

    _c = _chaos(seed=int(os.environ.get("CHAOS_SEED", "0")))
    _c.__enter__()  # never restored: this process dies or exits
    _c.kill_worker(_kill_rank, int(os.environ["CHAOS_KILL_EPOCH"]), hard=True)


class S(pw.Schema):
    word: str


t = pw.io.jsonlines.read({input!r}, schema=S, mode="static")
counts = t.groupby(t.word).reduce(t.word, n=pw.reducers.count())
pw.io.jsonlines.write(counts, {output!r})
pconf = Config.simple_config(
    Backend.filesystem({persist!r}),
    persistence_mode=PersistenceMode("operator_persisting"),
)
pw.run(
    autocommit_duration_ms=20,
    persistence_config=pconf,
    monitoring_level="none",
)
"""


class ClusterDrill:
    """Seedable end-to-end cluster fault drill.

    Runs one wordcount pipeline twice over the same generated corpus: a
    fault-free baseline, then a drill where a seeded-random worker is
    hard-killed (``os._exit``) at a seeded-random epoch while the cluster
    runs under :class:`~pathway_tpu_torch.internals.resilience.ClusterSupervisor`
    with coordinated checkpointing enabled.  The drill passes when the
    recovered sink output is *byte-identical* to the fault-free run after
    canonicalization — the diff log is consolidated to final counts and
    serialized deterministically, because the raw log's row batching is
    timing-dependent even between two fault-free runs (what the
    consistency guarantee covers is the *content*, not the arbitrary
    interleaving).

    Small epochs (``PATHWAY_EPOCH_MAX_ROWS``) and a short checkpoint
    interval make static input produce many epochs and several
    checkpoints before the kill, so recovery genuinely exercises
    rollback + replay + sink-watermark truncation rather than a trivial
    from-scratch rerun.
    """

    def __init__(
        self,
        workdir: Any,
        *,
        seed: int = 0,
        processes: int = 2,
        threads: int = 1,
        rows: int = 400,
        vocab: int = 7,
        kill_rank: int | None = None,
        kill_epoch: int | None = None,
        checkpoint_interval_s: float = 0.05,
        epoch_max_rows: int | None = None,
        heartbeat_s: float = 0.2,
        liveness_timeout_s: float = 2.0,
        max_restarts: int = 3,
        timeout_s: float = 180.0,
        trace: bool = False,
    ) -> None:
        self.workdir = str(workdir)
        #: when set, the drill run spools flight-recorder dumps per rank
        #: (PATHWAY_TRACE_DIR) and merges them into one Chrome-trace file
        #: — the killed rank's spans survive via the pre-os._exit flush
        self.trace = bool(trace)
        self.seed = seed
        self.rng = random.Random(seed)
        self.processes = processes
        self.threads = threads
        self.rows = rows
        self.vocab = vocab
        n_ranks = processes * threads
        self.kill_rank = (
            kill_rank if kill_rank is not None else self.rng.randrange(n_ranks)
        )
        self.kill_epoch = (
            kill_epoch if kill_epoch is not None else self.rng.randrange(3, 7)
        )
        self.checkpoint_interval_s = checkpoint_interval_s
        # default epoch cap scales with the worker count: the corpus is
        # partitioned across ranks, and every rank must cut enough data
        # epochs (~10) that any kill_epoch drawn above can actually fire
        self.epoch_max_rows = (
            epoch_max_rows
            if epoch_max_rows is not None
            else max(1, rows // (n_ranks * 10))
        )
        self.heartbeat_s = heartbeat_s
        self.liveness_timeout_s = liveness_timeout_s
        self.max_restarts = max_restarts
        self.timeout_s = timeout_s

    # -- pieces ---------------------------------------------------------
    def _write_corpus(self) -> str:
        path = os.path.join(self.workdir, "corpus.jsonl")
        import json

        with open(path, "w") as f:
            for _ in range(self.rows):
                w = f"w{self.rng.randrange(self.vocab)}"
                f.write(json.dumps({"word": w}) + "\n")
        return path

    def _write_program(self, tag: str, input_path: str) -> tuple[str, str]:
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        out = os.path.join(self.workdir, f"{tag}_out.jsonl")
        persist = os.path.join(self.workdir, f"{tag}_snap")
        prog = os.path.join(self.workdir, f"{tag}_prog.py")
        with open(prog, "w") as f:
            f.write(
                _DRILL_PROGRAM.format(
                    repo=repo, input=input_path, output=out, persist=persist
                )
            )
        return prog, out

    def _run_supervised(self, prog: str, extra_env: dict[str, str]) -> Any:
        import sys

        from pathway_tpu_torch.internals.resilience import (
            ClusterSupervisor,
            ConnectorRecoveryPolicy,
        )

        env = {
            "PATHWAY_CHECKPOINT_INTERVAL": str(self.checkpoint_interval_s),
            "PATHWAY_EPOCH_MAX_ROWS": str(self.epoch_max_rows),
            "PATHWAY_CLUSTER_HEARTBEAT_S": str(self.heartbeat_s),
            "PATHWAY_CLUSTER_LIVENESS_TIMEOUT_S": str(self.liveness_timeout_s),
            **extra_env,
        }
        sup = ClusterSupervisor(
            [sys.executable, prog],
            self.processes,
            threads=self.threads,
            env=env,
            policy=ConnectorRecoveryPolicy(
                max_restarts=self.max_restarts,
                initial_delay_ms=10,
                jitter_ms=0,
                seed=self.seed,
            ),
            log_dir=self.workdir,
        )
        return sup.run(timeout=self.timeout_s)

    def _trace_env(self) -> dict[str, str]:
        """Env for a traced drill run: every rank (and every respawned
        generation) spools flight-recorder dumps into one directory."""
        if not self.trace:
            return {}
        return {"PATHWAY_TRACE_DIR": os.path.join(self.workdir, "trace")}

    def _merge_trace(self) -> tuple[Any, list[int]]:
        """Merge the per-rank spool into one Chrome-trace file; returns
        ``(path_or_None, sorted ranks that contributed spans)``."""
        if not self.trace:
            return None, []
        from pathway_tpu_torch.internals import tracing as _tracing

        trace_file = _tracing.merge_trace_dir(
            os.path.join(self.workdir, "trace")
        )
        if trace_file is None:
            return None, []
        import json

        with open(trace_file) as f:
            events = json.load(f).get("traceEvents", [])
        return trace_file, sorted({int(e.get("pid", 0)) for e in events})

    @staticmethod
    def canonical_output(path: str) -> bytes:
        """Consolidate a jsonlines diff log to its final state and
        serialize deterministically (sorted keys) for byte comparison."""
        import json

        state: dict = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    key = row["word"]
                    if row["diff"] > 0:
                        state[key] = row["n"]
                    elif state.get(key) == row["n"]:
                        del state[key]
        return json.dumps(state, sort_keys=True).encode()

    # -- the drill ------------------------------------------------------
    def run(self) -> dict[str, Any]:
        corpus = self._write_corpus()

        prog, baseline_out = self._write_program("baseline", corpus)
        t0 = _time.monotonic()
        base_report = self._run_supervised(prog, {})
        baseline_seconds = _time.monotonic() - t0
        if base_report.returncode != 0:
            raise ChaosError(
                f"baseline cluster run failed: {base_report.failures}"
            )

        prog, drill_out = self._write_program("drill", corpus)
        drill_env = {
            "CHAOS_KILL_RANK": str(self.kill_rank),
            "CHAOS_KILL_EPOCH": str(self.kill_epoch),
            "CHAOS_SEED": str(self.seed),
        }
        drill_env.update(self._trace_env())
        t0 = _time.monotonic()
        drill_report = self._run_supervised(prog, drill_env)
        faulted_seconds = _time.monotonic() - t0
        trace_file, trace_ranks = self._merge_trace()

        baseline = self.canonical_output(baseline_out)
        recovered = self.canonical_output(drill_out)
        return {
            "ok": drill_report.returncode == 0 and baseline == recovered,
            "trace_file": trace_file,
            "trace_ranks": trace_ranks,
            "identical": baseline == recovered,
            "returncode": drill_report.returncode,
            "kill_rank": self.kill_rank,
            "kill_epoch": self.kill_epoch,
            "restarts": drill_report.restarts,
            "recovery_seconds": list(drill_report.recovery_seconds),
            "baseline_seconds": baseline_seconds,
            "faulted_seconds": faulted_seconds,
            "baseline_output": baseline.decode(),
            "recovered_output": recovered.decode(),
            "failures": list(drill_report.failures),
        }


_INDEX_DRILL_PROGRAM = """
import json, os, sys
sys.path.insert(0, {repo!r})
import pathway_tpu_torch as pw
from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

_kill_rank = int(os.environ.get("CHAOS_KILL_RANK", "-1"))
if _kill_rank >= 0:
    from pathway_tpu_torch.testing.chaos import chaos as _chaos

    _c = _chaos(seed=int(os.environ.get("CHAOS_SEED", "0")))
    _c.__enter__()  # never restored: this process dies or exits
    _c.kill_worker_mid_merge(
        _kill_rank, on_nth_merge=int(os.environ["CHAOS_KILL_MERGE"])
    )


class Doc(pw.Schema):
    # "id" is the engine's reserved row-key column — the doc key is "doc"
    doc: str = pw.column_definition(primary_key=True)
    vec: str


class Q(pw.Schema):
    qid: str = pw.column_definition(primary_key=True)
    qvec: str


class DocSubject(pw.io.python.ConnectorSubject):
    # one ordered reader (worker 0): an upsert stream is ordered per key,
    # and the partitioned static-file byte-range split would let a
    # re-upsert race its own base version across ranks
    deterministic_replay = True  # same file, same order, every generation

    def run(self):
        n = 0
        with open({docs!r}) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                self.next(doc=row["doc"], vec=row["vec"])
                n += 1
                if n % {commit_every} == 0:
                    self.commit()


docs = pw.io.python.read(DocSubject(), schema=Doc)
docs = docs.select(
    doc=pw.this.doc,
    vec=pw.apply(lambda s: tuple(json.loads(s)), pw.this.vec),
)
queries = pw.io.jsonlines.read({queries!r}, schema=Q, mode="static")
queries = queries.select(
    qid=pw.this.qid,
    qvec=pw.apply(lambda s: tuple(json.loads(s)), pw.this.qvec),
)

from pathway_tpu_torch.stdlib.indexing import DataIndex
from pathway_tpu_torch.stdlib.indexing.data_index import UsearchKnn

inner = UsearchKnn(
    docs.vec, dimensions={dim}, reserved_space=4096, delta_cap={delta_cap}
)
di = DataIndex(docs, inner)
reply = di.query(queries.qvec, number_of_matches={k})
out = reply.select(
    qid=pw.this.qid,
    ids=pw.apply(
        lambda ds: [d["doc"] for d in ds if d], pw.this._pw_index_reply
    ),
)
pw.io.jsonlines.write(out, {output!r})
pconf = Config.simple_config(
    Backend.filesystem({persist!r}),
    persistence_mode=PersistenceMode("operator_persisting"),
)
pw.run(
    autocommit_duration_ms=20,
    persistence_config=pconf,
    monitoring_level="none",
)
if int(os.environ.get("PATHWAY_PROCESS_ID", "0")) == 0:
    with open({dump!r}, "w") as f:
        json.dump(reply._node.adapter.stats(), f)
"""


class IndexDrill(ClusterDrill):
    """Live-index churn drill: exactly-once recovery from a crash
    mid-merge.

    Runs a doc-upsert + KNN-query pipeline twice over one seeded corpus
    (base docs followed by re-upserts of random ids under new vectors,
    flowing through the delta segment of a
    :class:`~pathway_tpu_torch.stdlib.indexing.segments.SegmentedIndex`):
    a fault-free baseline, then a drill where the process hosting
    worker 0 — the index owner — is hard-killed between a finished
    background merge and its atomic commit
    (:meth:`chaos.kill_worker_mid_merge`).  The supervisor restarts the
    generation, the worker restores the checkpointed index (pre-merge
    view) and replays only the connector tail; primary-keyed rows make
    the replayed upserts idempotent.

    Passes when the recovered index holds each doc **exactly once**
    (index size equals the distinct id count — nothing dropped by the
    lost merge, nothing double-applied by the replay) and the final
    query answers reach ``recall_target`` against brute force over the
    final (post-churn) corpus.  ``delta_cap`` stays above the per-epoch
    batch size so churn actually flows through the delta segment and
    background merges fire; ``kill_merge=2`` leaves merge #1 and some
    checkpoints behind so recovery genuinely restores state.
    """

    def __init__(
        self,
        workdir: Any,
        *,
        seed: int = 0,
        processes: int = 2,
        n_docs: int = 64,
        n_upserts: int = 96,
        dim: int = 16,
        n_queries: int = 16,
        k: int = 5,
        delta_cap: int = 24,
        kill_merge: int = 2,
        recall_target: float = 0.95,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("checkpoint_interval_s", 0.05)
        kwargs.setdefault("epoch_max_rows", 8)
        # the index lives on worker 0 (route_all_to_zero): kill that rank
        super().__init__(
            workdir,
            seed=seed,
            processes=processes,
            kill_rank=0,
            kill_epoch=1,
            **kwargs,
        )
        self.n_docs = n_docs
        self.n_upserts = n_upserts
        self.dim = dim
        self.n_queries = n_queries
        self.k = k
        self.delta_cap = delta_cap
        self.kill_merge = kill_merge
        self.recall_target = recall_target
        self._final: dict[str, list[float]] = {}
        self._queries: dict[str, list[float]] = {}

    # -- pieces ---------------------------------------------------------
    def _write_inputs(self) -> tuple[str, str]:
        import json

        import numpy as np

        rng = np.random.default_rng(self.seed)

        def vec() -> list[float]:
            v = rng.standard_normal(self.dim)
            return (v / np.linalg.norm(v)).tolist()

        lines = []
        for i in range(self.n_docs):
            v = vec()
            self._final[f"d{i}"] = v
            lines.append({"doc": f"d{i}", "vec": json.dumps(v)})
        for _ in range(self.n_upserts):
            doc_id = f"d{int(rng.integers(self.n_docs))}"
            v = vec()
            self._final[doc_id] = v
            lines.append({"doc": doc_id, "vec": json.dumps(v)})
        docs_path = os.path.join(self.workdir, "docs.jsonl")
        with open(docs_path, "w") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")
        queries_path = os.path.join(self.workdir, "queries.jsonl")
        with open(queries_path, "w") as f:
            for j in range(self.n_queries):
                v = vec()
                self._queries[f"q{j}"] = v
                f.write(json.dumps({"qid": f"q{j}", "qvec": json.dumps(v)}) + "\n")
        return docs_path, queries_path

    def _write_index_program(
        self, tag: str, docs_path: str, queries_path: str
    ) -> tuple[str, str, str]:
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        out = os.path.join(self.workdir, f"{tag}_out.jsonl")
        dump = os.path.join(self.workdir, f"{tag}_index.json")
        persist = os.path.join(self.workdir, f"{tag}_snap")
        prog = os.path.join(self.workdir, f"{tag}_prog.py")
        with open(prog, "w") as f:
            f.write(
                _INDEX_DRILL_PROGRAM.format(
                    repo=repo,
                    docs=docs_path,
                    queries=queries_path,
                    output=out,
                    persist=persist,
                    dump=dump,
                    dim=self.dim,
                    delta_cap=self.delta_cap,
                    k=self.k,
                    commit_every=self.epoch_max_rows,
                )
            )
        return prog, out, dump

    def _final_answers(self, path: str) -> dict[str, list]:
        """Consolidate the query sink's diff log to its final state."""
        import json

        state: dict[str, list] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    if row["diff"] > 0:
                        state[row["qid"]] = row["ids"]
                    elif state.get(row["qid"]) == row["ids"]:
                        del state[row["qid"]]
        return state

    def _recall(self, output_path: str) -> float:
        """Top-k recall of the sink's final answers vs brute force over
        the final (post-churn) corpus."""
        import numpy as np

        answers = self._final_answers(output_path)
        ids = sorted(self._final)
        mat = np.asarray([self._final[i] for i in ids], np.float64)
        k = min(self.k, len(ids))
        hits, total = 0, 0
        for qid, qv in self._queries.items():
            scores = mat @ np.asarray(qv, np.float64)
            gt = {ids[i] for i in np.argsort(-scores)[:k]}
            hits += len(gt & set(answers.get(qid, ())))
            total += k
        return hits / max(total, 1)

    # -- the drill ------------------------------------------------------
    def run(self) -> dict[str, Any]:
        docs_path, queries_path = self._write_inputs()

        prog, base_out, base_dump = self._write_index_program(
            "baseline", docs_path, queries_path
        )
        base_report = self._run_supervised(prog, {})
        if base_report.returncode != 0:
            raise ChaosError(
                f"baseline index run failed: {base_report.failures}"
            )

        prog, drill_out, drill_dump = self._write_index_program(
            "drill", docs_path, queries_path
        )
        t0 = _time.monotonic()
        drill_report = self._run_supervised(
            prog,
            {
                "CHAOS_KILL_RANK": str(self.kill_rank),
                "CHAOS_KILL_MERGE": str(self.kill_merge),
                "CHAOS_SEED": str(self.seed),
                **self._trace_env(),
            },
        )
        faulted_seconds = _time.monotonic() - t0
        trace_file, trace_ranks = self._merge_trace()

        import json

        def read_dump(path: str) -> dict:
            if not os.path.exists(path):
                return {}
            with open(path) as f:
                return json.load(f)

        expected = len(self._final)
        base_stats = read_dump(base_dump)
        drill_stats = read_dump(drill_dump)
        baseline_recall = self._recall(base_out)
        recall = self._recall(drill_out)
        exactly_once = drill_stats.get("size") == expected
        return {
            "ok": (
                drill_report.returncode == 0
                and exactly_once
                and recall >= self.recall_target
            ),
            "exactly_once": exactly_once,
            "expected_size": expected,
            "recovered_size": drill_stats.get("size"),
            "baseline_size": base_stats.get("size"),
            "recall": recall,
            "baseline_recall": baseline_recall,
            "merges_total": drill_stats.get("merges_total", 0),
            "baseline_merges_total": base_stats.get("merges_total", 0),
            "restarts": drill_report.restarts,
            "recovery_seconds": list(drill_report.recovery_seconds),
            "faulted_seconds": faulted_seconds,
            "returncode": drill_report.returncode,
            "failures": list(drill_report.failures),
            "trace_file": trace_file,
            "trace_ranks": trace_ranks,
        }


def flaky_once(
    items: Iterable[Any],
    fail_before_index: int,
    exc_factory: Callable[[], BaseException] | None = None,
) -> Callable[[], Iterable[Any]]:
    """Generator factory for a transiently-faulty source: the FIRST pass
    raises just before yielding item ``fail_before_index``; every later
    pass yields all items.  Pairs with a deterministic-replay reader +
    :class:`~pathway_tpu_torch.internals.resilience.ConnectorRecoveryPolicy`
    to drill restart-with-resume (each row delivered exactly once)."""
    items = list(items)
    state = {"tripped": False}
    make_exc = exc_factory or (
        lambda: ChaosError(f"injected source fault before row {fail_before_index}")
    )

    def gen() -> Iterable[Any]:
        for i, item in enumerate(items):
            if not state["tripped"] and i == fail_before_index:
                state["tripped"] = True
                raise make_exc()
            yield item

    return gen
