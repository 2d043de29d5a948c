"""Connector resilience: supervised restart, backoff, circuit breaking.

The reference engine recovers from reader failures via persisted snapshots
(``src/connectors/mod.rs`` ``Connector::run`` + rewind): a connector that
dies is restarted and resumes from the last committed frontier.  This
module provides that layer for the epoch-synchronous engine:

- :class:`ConnectorRecoveryPolicy` — restart budget, exponential backoff
  (shared with the UDF retry layer: the delay schedule IS an
  :class:`~pathway_tpu_torch.internals.udfs.ExponentialBackoffRetryStrategy`),
  circuit breaker, watchdog timeout and an ``on_failure`` mode.
- :class:`CircuitBreaker` — closed / open / half-open, so a source that
  fails in a tight loop stops consuming restart budget until a cool-down
  elapses.
- :class:`ConnectorSupervisor` — runs ``RowSource.run(events)`` on a
  reader thread, restarting per policy and resuming from the persistence
  snapshot offset (already-delivered rows are skipped, never re-emitted).

The scheduler spawns one supervisor per live input; a node opts in by
carrying a ``recovery_policy`` attribute (``input_table(...,
recovery_policy=...)``).  Nodes without a policy keep the historical
behaviour: one failure, logged, stream closed (``DEFAULT_POLICY``).
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable

from pathway_tpu_torch.internals.udfs import ExponentialBackoffRetryStrategy

__all__ = [
    "BackgroundMaintenance",
    "BreakerState",
    "CircuitBreaker",
    "ClusterRunReport",
    "ClusterSupervisor",
    "ConnectorRecoveryPolicy",
    "ConnectorSupervisor",
    "DEFAULT_POLICY",
    "WatchdogTimeout",
]

_logger = logging.getLogger("pathway_tpu_torch.resilience")

_ON_FAILURE_MODES = ("stop", "drop", "degrade")


class WatchdogTimeout(Exception):
    """A source made no progress within ``watchdog_timeout_s``."""


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed → open → half-open).

    ``failure_threshold`` consecutive failures open the circuit; while
    open, :meth:`allow` refuses further attempts until ``reset_after_s``
    has elapsed, then exactly one probe attempt is allowed (half-open).
    A success closes the circuit; a failure re-opens it and restarts the
    cool-down.  ``clock`` is injectable so tests need not sleep."""

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_after_s: float = 30.0,
        clock: Callable[[], float] = _time.monotonic,
    ):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = BreakerState.CLOSED
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            if (
                self._state == BreakerState.OPEN
                and self._clock() - self._opened_at >= self.reset_after_s
            ):
                return BreakerState.HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """Whether the next attempt may proceed.  In the half-open window
        this consumes the single probe slot (the breaker re-arms as OPEN
        with a fresh cool-down until the probe reports back)."""
        with self._lock:
            if self._state == BreakerState.CLOSED:
                return True
            if self._state == BreakerState.HALF_OPEN:
                return False  # a probe is already in flight
            if self._clock() - self._opened_at >= self.reset_after_s:
                self._state = BreakerState.HALF_OPEN
                self._opened_at = self._clock()  # fresh cool-down if it fails
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = BreakerState.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (
                self._state == BreakerState.HALF_OPEN
                or self._failures >= self.failure_threshold
            ):
                self._state = BreakerState.OPEN
                self._opened_at = self._clock()


@dataclass
class ConnectorRecoveryPolicy:
    """Restart policy for one connector (reference connector supervision).

    ``on_failure`` decides what happens once the restart budget is spent
    or the circuit breaker refuses further attempts:

    - ``"stop"``: the failure is recorded and the whole run is stopped.
    - ``"drop"``: the source's stream is closed; the run continues on the
      data delivered so far (the historical behaviour).
    - ``"degrade"``: like ``drop``, but the failure is routed into the
      global error-log table and the source's outputs are marked stale
      (``ctx.stale_sources`` + the connector's monitoring entry), so the
      run finishes and the degradation is observable instead of silent.
    """

    max_restarts: int = 3
    initial_delay_ms: int = 50
    backoff_factor: float = 2.0
    max_delay_ms: int | None = 10_000
    jitter_ms: int = 50
    full_jitter: bool = False
    seed: int | None = None
    #: no event (row/commit/close) for this long counts as a failure;
    #: the stalled attempt is fenced off and restarted.  None disables.
    watchdog_timeout_s: float | None = None
    on_failure: str = "stop"
    #: consecutive failures before the breaker opens; None disables the
    #: breaker (budget alone governs restarts)
    breaker_failure_threshold: int | None = None
    breaker_reset_after_s: float = 30.0

    def __post_init__(self) -> None:
        if self.on_failure not in _ON_FAILURE_MODES:
            raise ValueError(
                f"on_failure must be one of {_ON_FAILURE_MODES}, "
                f"got {self.on_failure!r}"
            )

    def backoff_strategy(self) -> ExponentialBackoffRetryStrategy:
        """The delay schedule, as the SAME policy object the UDF retry
        layer uses — one backoff implementation across the system."""
        return ExponentialBackoffRetryStrategy(
            max_retries=self.max_restarts,
            initial_delay=self.initial_delay_ms,
            backoff_factor=self.backoff_factor,
            jitter_ms=self.jitter_ms,
            max_delay_ms=self.max_delay_ms,
            full_jitter=self.full_jitter,
            seed=self.seed,
        )

    def make_breaker(
        self, clock: Callable[[], float] = _time.monotonic
    ) -> CircuitBreaker | None:
        if self.breaker_failure_threshold is None:
            return None
        return CircuitBreaker(
            failure_threshold=self.breaker_failure_threshold,
            reset_after_s=self.breaker_reset_after_s,
            clock=clock,
        )


#: nodes without an explicit policy: one failure, logged, stream closed —
#: exactly the pre-supervisor behaviour, so existing pipelines see no
#: change until they opt in
DEFAULT_POLICY = ConnectorRecoveryPolicy(max_restarts=0, on_failure="drop")


class _AttemptEvents:
    """Per-attempt shim around the live events chain.

    Tracks last-activity time (watchdog) and can be *fenced*: a stalled
    attempt's thread cannot be killed, so instead its event sink is cut —
    after :meth:`fence` nothing it emits reaches the engine, and
    cooperative readers observe ``stopped`` and exit.  ``close`` from the
    subject is recorded but NOT forwarded: the supervisor owns the single
    end-of-stream close."""

    def __init__(self, inner: Any):
        self._inner = inner
        self._fenced = False
        self.closed_by_subject = False
        self.last_activity = _time.monotonic()

    @property
    def stopped(self) -> bool:
        return self._fenced or self._inner.stopped

    @property
    def resume_offset(self) -> int:
        return getattr(self._inner, "resume_offset", 0)

    def fence(self) -> None:
        self._fenced = True

    def add(self, key: Any, values: tuple) -> None:
        if not self._fenced:
            self.last_activity = _time.monotonic()
            self._inner.add(key, values)

    def add_many(self, rows: list) -> None:
        if not self._fenced:
            self.last_activity = _time.monotonic()
            self._inner.add_many(rows)

    def add_frame(self, cap: Any) -> None:
        if not self._fenced:
            self.last_activity = _time.monotonic()
            self._inner.add_frame(cap)

    def remove(self, key: Any, values: tuple) -> None:
        if not self._fenced:
            self.last_activity = _time.monotonic()
            self._inner.remove(key, values)

    def commit(self) -> None:
        if not self._fenced:
            self.last_activity = _time.monotonic()
            self._inner.commit()

    def close(self) -> None:
        if not self._fenced:
            self.closed_by_subject = True


class _SkipEvents:
    """Drop the first ``skip`` data events (and any commits inside that
    prefix) before forwarding — the non-persistence analogue of
    ``_RecordingEvents.resume_offset``: a restarted deterministic reader
    re-emits its history and the prefix the engine already consumed must
    not be delivered twice."""

    def __init__(self, inner: Any, skip: int):
        self._inner = inner
        self.resume_offset = skip

    @property
    def stopped(self) -> bool:
        return self._inner.stopped

    def add(self, key: Any, values: tuple) -> None:
        if self.resume_offset > 0:
            self.resume_offset -= 1
            return
        self._inner.add(key, values)

    def add_many(self, rows: list) -> None:
        skip = min(self.resume_offset, len(rows))
        if skip:
            self.resume_offset -= skip
            rows = rows[skip:]
        if rows:
            self._inner.add_many(rows)

    def add_frame(self, cap: Any) -> None:
        from pathway_tpu_torch.internals import native as _native

        native = _native.load()
        n = native.frame_len(cap)
        skip = min(self.resume_offset, n)
        if skip:
            self.resume_offset -= skip
            if skip == n:
                return
            cap = native.frame_slice(cap, skip, n)
        self._inner.add_frame(cap)

    def remove(self, key: Any, values: tuple) -> None:
        if self.resume_offset > 0:
            self.resume_offset -= 1
            return
        self._inner.remove(key, values)

    def commit(self) -> None:
        if self.resume_offset > 0:
            return
        self._inner.commit()

    def close(self) -> None:
        self._inner.close()


class ConnectorSupervisor:
    """Supervises one connector's reader thread.

    Each attempt runs ``subject.run`` on a fresh daemon thread against a
    fresh events chain built by ``make_events(resume)``, where ``resume``
    is the number of data events the engine has already consumed from
    this source (persistence-replayed prefix + rows delivered by earlier
    attempts).  With persistence attached, ``make_events`` wraps the sink
    in the recording layer whose ``resume_offset`` skips that prefix
    without re-recording it; without persistence the supervisor inserts
    :class:`_SkipEvents` for deterministic readers (or calls the reader's
    ``on_persistence_resume`` hook).
    """

    def __init__(
        self,
        node: Any,
        subject: Any,
        make_events: Callable[[int], Any],
        policy: ConnectorRecoveryPolicy | None,
        *,
        ctx: Any = None,
        stats: dict | None = None,
        stop_event: threading.Event | None = None,
        initial_resume: int = 0,
        skip_handled_by_events: bool = False,
        stop_runner: Callable[[], None] | None = None,
    ):
        self.node = node
        self.subject = subject
        self.make_events = make_events
        self.policy = policy if policy is not None else DEFAULT_POLICY
        self.ctx = ctx
        self.stats = stats if stats is not None else {}
        self._stop_event = stop_event or threading.Event()
        self._initial_resume = initial_resume
        #: True when make_events already returns a chain that skips the
        #: resume prefix itself (the persistence recording wrapper)
        self._skip_handled = skip_handled_by_events
        self._stop_runner = stop_runner
        self._backoff = self.policy.backoff_strategy()
        self._breaker = self.policy.make_breaker()
        self.restarts = 0
        self.stats.setdefault("restarts", 0)
        self.stats.setdefault("failures", 0)

    # ------------------------------------------------------------------
    def start(self) -> threading.Thread:
        t = threading.Thread(
            target=self._supervise,
            daemon=True,
            name=f"pw_supervisor_{self.node.name}#{self.node.id}",
        )
        t.start()
        return t

    # ------------------------------------------------------------------
    def _delivered(self) -> int:
        """Data events this run has consumed from this source: the
        replayed prefix plus everything the base events sink counted
        (the stats dict is shared across attempts)."""
        return (
            self._initial_resume
            + self.stats.get("rows", 0)
            + self.stats.get("retractions", 0)
        )

    def _build_attempt(self, resume: int) -> _AttemptEvents:
        events = self.make_events(resume)
        if resume > 0 and not self._skip_handled:
            if getattr(self.subject, "deterministic_replay", False):
                events = _SkipEvents(events, resume)
            else:
                hook = getattr(self.subject, "on_persistence_resume", None)
                if hook is not None:
                    hook(resume)
                else:
                    _logger.warning(
                        "restarting input %r after %d delivered events but "
                        "its reader is not deterministically replayable and "
                        "defines no on_persistence_resume(n) hook; "
                        "re-delivered rows will be double-counted",
                        self.node.name,
                        resume,
                    )
        return _AttemptEvents(events)

    def _run_attempt(self, att: _AttemptEvents) -> BaseException | None:
        """Run one attempt; returns the failure (exception or watchdog
        verdict) or None on clean completion."""
        box: dict[str, BaseException] = {}

        def body() -> None:
            try:
                self.subject.run(att)
            except BaseException as e:  # noqa: BLE001 — reported to policy
                box["exc"] = e

        t = threading.Thread(
            target=body,
            daemon=True,
            name=f"pw_reader_{self.node.name}#{self.node.id}",
        )
        t.start()
        timeout = self.policy.watchdog_timeout_s
        tick = 0.05 if timeout is None else min(0.05, timeout / 4.0)
        while t.is_alive():
            t.join(tick)
            if self._stop_event.is_set():
                # shutdown: the reader sees stopped=True and exits; give
                # it a moment, then abandon it (daemon)
                t.join(0.5)
                return None
            if (
                timeout is not None
                and t.is_alive()
                and _time.monotonic() - att.last_activity > timeout
                # a reader parked by ingest backpressure (IngestCredit
                # pause) is waiting, not hung — fencing it would turn
                # overload into a spurious restart storm
                and not self.stats.get("paused")
            ):
                att.fence()  # the zombie may never die; cut its sink
                return WatchdogTimeout(
                    f"source {self.node.name!r} made no progress for "
                    f"{timeout}s"
                )
        return box.get("exc")

    def _supervise(self) -> None:
        from pathway_tpu_torch.internals.telemetry import get_telemetry

        telemetry = get_telemetry()
        att: _AttemptEvents | None = None
        attempt = 0
        while True:
            att = self._build_attempt(
                self._delivered() if attempt else self._initial_resume
            )
            self.stats["state"] = "live"
            failure = self._run_attempt(att)
            if failure is None:
                if self._breaker is not None:
                    self._breaker.record_success()
                break
            self.stats["failures"] += 1
            self.stats["last_error"] = repr(failure)
            telemetry.counter("connector.failures")
            if self._breaker is not None:
                self._breaker.record_failure()
                if self._breaker.state == BreakerState.OPEN:
                    telemetry.counter("connector.breaker_open")
            _logger.error(
                "connector %s failed (attempt %d): %r",
                self.node.name,
                attempt + 1,
                failure,
            )
            if self._stop_event.is_set():
                break
            can_restart = self.restarts < self.policy.max_restarts and (
                self._breaker is None or self._breaker.allow()
            )
            if not can_restart:
                self._give_up(failure)
                break
            delay = self._backoff.next_delay(self.restarts)
            self.restarts += 1
            self.stats["restarts"] += 1
            telemetry.counter("connector.restarts")
            _logger.warning(
                "restarting connector %s in %.3fs (restart %d/%d, resuming "
                "past %d delivered events)",
                self.node.name,
                delay,
                self.restarts,
                self.policy.max_restarts,
                self._delivered(),
            )
            if self._stop_event.wait(delay):
                break
            attempt += 1
        # exactly one end-of-stream close, owned by the supervisor — the
        # scheduler's run loop exits once every primary source closed
        self.make_close(att)

    def make_close(self, att: _AttemptEvents | None) -> None:
        if att is not None and not att._fenced:
            att._inner.close()
        else:
            # the live chain was fenced (watchdog): close via a fresh sink
            self.make_events(self._delivered()).close()

    def _give_up(self, failure: BaseException) -> None:
        from pathway_tpu_torch.internals.telemetry import get_telemetry

        mode = self.policy.on_failure
        msg = (
            f"connector {self.node.name}#{self.node.id} gave up after "
            f"{self.restarts} restart(s): {failure!r}"
        )
        self.stats["state"] = "failed" if mode == "stop" else mode
        if mode == "degrade":
            # keep the run alive; the failure lands in the global
            # error-log table and the outputs are flagged stale
            self.stats["stale"] = True
            get_telemetry().counter("connector.dlq_events")
            if self.ctx is not None:
                self.ctx.log_error(self.node, msg)
                self.ctx.stale_sources.add(self.node.id)
            return
        if mode == "stop":
            if self.ctx is not None:
                self.ctx.log_error(self.node, msg)
            _logger.error("%s; stopping the run (on_failure='stop')", msg)
            if self._stop_runner is not None:
                self._stop_runner()
            return
        # "drop": historical behaviour — loud log, stream closes, the run
        # continues on whatever was delivered
        _logger.error("%s; dropping the source (on_failure='drop')", msg)


# --------------------------------------------------------------------------
# cluster-level supervision
# --------------------------------------------------------------------------


def _probe_port_range(n: int, start: int = 11000) -> int:
    """Find a contiguous range of ``n`` free TCP ports on 127.0.0.1.

    A fresh range per cluster generation keeps a respawned mesh away from
    TIME_WAIT sockets and half-dead listeners left by the generation it
    replaces.
    """
    import socket as _socket

    base = start + (os.getpid() % 500) * 16
    step = max(n, 1)
    for offset in range(0, 4000, step):
        cand = base + offset
        socks: list[Any] = []
        try:
            for i in range(n):
                s = _socket.socket()
                s.bind(("127.0.0.1", cand + i))
                socks.append(s)
            return cand
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no free range of {n} ports found near {base}")


@dataclass
class ClusterRunReport:
    """Outcome of a supervised cluster run.

    ``recovery_seconds`` has one entry per restart: wall time from the moment
    a worker failure was observed to the moment every replacement process was
    spawned — the whole cluster's downtime window under
    ``restart_scope="generation"``, the single rank's under ``"rank"``
    (survivors never stop).  ``rank_restarts`` maps pid -> per-rank restart
    count (empty under generation scope).
    """

    returncode: int
    restarts: int
    recovery_seconds: list[float] = field(default_factory=list)
    total_seconds: float = 0.0
    failures: list[str] = field(default_factory=list)
    rank_restarts: dict[int, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.returncode == 0


class ClusterSupervisor:
    """Restart a multi-process cluster run after worker death.

    The supervisor owns the whole mesh: it spawns one OS process per
    ``PATHWAY_PROCESS_ID`` with the standard env contract and watches
    their exit codes.  What a nonzero exit triggers is the
    ``restart_scope``:

    - ``"generation"`` (default, the legacy semantics): tear down the
      survivors and respawn *all* of them.  This is the only correct
      granularity when the workers run the fail-together mesh policy — a
      surviving worker cannot rejoin a half-dead mesh: peers fail their
      sockets as soon as one side dies, and epoch consensus needs every
      rank present.
    - ``"rank"`` (per-rank failover, ISSUE 13): respawn ONLY the dead
      rank, on the same port range, with ``PATHWAY_CLUSTER_INCARNATION``
      bumped so the replacement's dial handshake is admitted as a rejoin
      by the survivors' isolate-policy mesh
      (``engine/cluster._ProcessLinks``).  Survivors never stop; the
      replacement restores its state from its snapshot + offset tail and
      rejoins.  The supervisor exports
      ``PATHWAY_CLUSTER_FAIL_POLICY=isolate`` to the workers under this
      scope (overridable via ``env``) because per-rank restart is only
      sound on an isolating mesh.

    Rollback to the last globally-consistent checkpoint is not the
    supervisor's job — the workers' own ``("snap_presence",)`` allgather
    refuses any checkpoint epoch that is missing on some rank or skewed
    across ranks, so a respawned cluster converges on the newest epoch
    that every worker persisted (or replays from scratch when there is
    none), and file sinks truncate back to their checkpointed watermark
    before appending.

    Restart budget and backoff pacing reuse ``ConnectorRecoveryPolicy``
    so cluster supervision tunes exactly like connector supervision.
    The budget counts the current *failure streak*, not lifetime
    restarts: after ``healthy_reset_polls`` consecutive healthy poll
    ticks the streak (and with it the backoff schedule) resets, so an
    unrelated failure hours later starts from the initial delay instead
    of inheriting a maxed-out schedule and an exhausted budget.
    """

    def __init__(
        self,
        argv: list[str],
        n_processes: int,
        *,
        threads: int = 1,
        env: dict[str, str] | None = None,
        policy: ConnectorRecoveryPolicy | None = None,
        log_dir: str | None = None,
        cwd: str | None = None,
        first_port_factory: Callable[[int], int] | None = None,
        grace_s: float = 5.0,
        poll_interval_s: float = 0.02,
        restart_scope: str = "generation",
        healthy_reset_polls: int | None = 250,
    ) -> None:
        if n_processes < 1:
            raise ValueError("n_processes must be >= 1")
        if restart_scope not in ("generation", "rank"):
            raise ValueError(
                f"restart_scope must be 'generation' or 'rank', "
                f"got {restart_scope!r}"
            )
        self.argv = list(argv)
        self.n_processes = n_processes
        self.threads = threads
        self.extra_env = dict(env or {})
        self.policy = policy or ConnectorRecoveryPolicy(
            max_restarts=3, initial_delay_ms=50, max_delay_ms=2_000, jitter_ms=0
        )
        self.log_dir = log_dir
        self.cwd = cwd
        self._first_port_factory = first_port_factory or _probe_port_range
        self.grace_s = grace_s
        self.poll_interval_s = poll_interval_s
        self.restart_scope = restart_scope
        #: consecutive healthy poll ticks after which the failure streak
        #: (budget + backoff position) resets; None disables the reset
        self.healthy_reset_polls = healthy_reset_polls
        self._stop_event = threading.Event()

    def stop(self) -> None:
        """Ask a running :meth:`run` to tear everything down and return."""
        self._stop_event.set()

    # -- process plumbing ---------------------------------------------------

    def _spawn_rank(
        self,
        generation: int,
        first_port: int,
        pid_: int,
        incarnation: int = 0,
    ) -> tuple[subprocess.Popen[bytes], Any]:
        env = dict(os.environ)
        if self.restart_scope == "rank":
            # per-rank restart is only sound on an isolating mesh: the
            # survivors must quiesce one peer, not fail together
            env["PATHWAY_CLUSTER_FAIL_POLICY"] = "isolate"
        env.update(self.extra_env)
        env.update(
            {
                "PATHWAY_THREADS": str(self.threads),
                "PATHWAY_PROCESSES": str(self.n_processes),
                "PATHWAY_PROCESS_ID": str(pid_),
                "PATHWAY_FIRST_PORT": str(first_port),
                # surfaces as pathway_tpu_worker_restarts_total
                "PATHWAY_WORKER_RESTARTS": str(
                    incarnation if self.restart_scope == "rank" else generation
                ),
                # the rejoin handshake: survivors admit a replacement
                # whose dial advertises a newer incarnation
                "PATHWAY_CLUSTER_INCARNATION": str(incarnation),
            }
        )
        log_f: Any = subprocess.DEVNULL
        if self.log_dir is not None:
            suffix = f"_i{incarnation}" if incarnation else ""
            log_f = open(
                os.path.join(
                    self.log_dir, f"gen{generation}_p{pid_}{suffix}.log"
                ),
                "wb",
            )
        proc = subprocess.Popen(
            self.argv,
            env=env,
            cwd=self.cwd,
            stdout=log_f,
            stderr=subprocess.STDOUT,
        )
        return proc, log_f

    def _spawn_generation(
        self, generation: int, first_port: int
    ) -> list[tuple[subprocess.Popen[bytes], Any]]:
        return [
            self._spawn_rank(generation, first_port, pid_)
            for pid_ in range(self.n_processes)
        ]

    def _terminate(self, procs: list[tuple[subprocess.Popen[bytes], Any]]) -> None:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = _time.monotonic() + self.grace_s
        for proc, _ in procs:
            if proc.poll() is None:
                try:
                    proc.wait(max(0.0, deadline - _time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(5.0)
        for _, log_f in procs:
            if log_f is not subprocess.DEVNULL:
                log_f.close()

    @staticmethod
    def _close_logs(procs: list[tuple[subprocess.Popen[bytes], Any]]) -> None:
        for _, log_f in procs:
            if log_f is not subprocess.DEVNULL:
                log_f.close()

    # -- main loop ----------------------------------------------------------

    def run(self, timeout: float | None = None) -> ClusterRunReport:
        """Run the cluster to completion, restarting on worker death."""
        from pathway_tpu_torch.internals.telemetry import get_telemetry

        telemetry = get_telemetry()
        backoff = self.policy.backoff_strategy()
        t0 = _time.monotonic()
        generation = 0
        #: consecutive-failure streak: drives the backoff position AND
        #: the restart budget; resets after a stable-healthy window so an
        #: unrelated failure later doesn't inherit a maxed-out schedule
        failure_streak = 0
        healthy_polls = 0
        recovery_seconds: list[float] = []
        failures: list[str] = []
        rank_restarts: dict[int, int] = {}
        failed_at: float | None = None

        def merge_trace() -> None:
            # flight recorder: the workers spool per-rank Chrome-trace
            # dumps (chaos-kill flush, liveness flush, atexit); whenever a
            # generation ends — restart or completion — fold them into one
            # stitched merged_trace.json so a post-mortem never has to
            spool = self.extra_env.get("PATHWAY_TRACE_DIR") or os.environ.get(
                "PATHWAY_TRACE_DIR"
            )
            if spool:
                from pathway_tpu_torch.internals import tracing as _tracing

                _tracing.merge_trace_dir(spool)

        def report(rc: int) -> ClusterRunReport:
            merge_trace()
            return ClusterRunReport(
                returncode=rc,
                restarts=generation + sum(rank_restarts.values()),
                recovery_seconds=recovery_seconds,
                total_seconds=_time.monotonic() - t0,
                failures=failures,
                rank_restarts=dict(rank_restarts),
            )

        def tick_healthy() -> None:
            nonlocal failure_streak, healthy_polls
            healthy_polls += 1
            if (
                failure_streak
                and self.healthy_reset_polls is not None
                and healthy_polls >= self.healthy_reset_polls
            ):
                _logger.info(
                    "cluster stable for %d polls: failure streak %d reset",
                    healthy_polls,
                    failure_streak,
                )
                failure_streak = 0

        while True:
            first_port = self._first_port_factory(self.n_processes)
            procs = self._spawn_generation(generation, first_port)
            if failed_at is not None:
                recovery_seconds.append(_time.monotonic() - failed_at)
                failed_at = None
            failed_rc: int | None = None
            while True:
                if self._stop_event.is_set():
                    self._terminate(procs)
                    failures.append(f"generation {generation}: stopped by supervisor")
                    return report(-1)
                if timeout is not None and _time.monotonic() - t0 > timeout:
                    self._terminate(procs)
                    failures.append(f"generation {generation}: supervisor timeout")
                    return report(124)
                codes = [proc.poll() for proc, _ in procs]
                bad = [
                    (i, c) for i, c in enumerate(codes) if c is not None and c != 0
                ]
                if bad:
                    failed_rc = bad[0][1]
                    failures.append(
                        f"generation {generation}: worker process "
                        f"{bad[0][0]} exited {failed_rc}"
                    )
                    if self.restart_scope != "rank":
                        break
                    # per-rank failover: respawn ONLY the dead ranks, on
                    # the same port range — survivors keep running and
                    # admit the replacements as rejoins
                    rank_failed_at = _time.monotonic()
                    telemetry.counter("cluster.worker_failures")
                    _logger.warning(
                        "%s; respawning only that rank (survivors keep "
                        "running)",
                        failures[-1],
                    )
                    if failure_streak >= self.policy.max_restarts:
                        _logger.error(
                            "cluster gave up after a streak of %d rank "
                            "restart(s); last failure: %s",
                            failure_streak,
                            failures[-1],
                        )
                        self._terminate(procs)
                        return report(failed_rc)
                    delay = backoff.next_delay(failure_streak)
                    if self._stop_event.wait(delay):
                        failures.append(
                            f"generation {generation}: stopped during backoff"
                        )
                        self._terminate(procs)
                        return report(-1)
                    failure_streak += 1
                    healthy_polls = 0
                    for i, _c in bad:
                        _dead, old_log = procs[i]
                        if old_log is not subprocess.DEVNULL:
                            old_log.close()
                        rank_restarts[i] = rank_restarts.get(i, 0) + 1
                        procs[i] = self._spawn_rank(
                            generation, first_port, i, rank_restarts[i]
                        )
                        telemetry.counter("cluster.restarts")
                    recovery_seconds.append(
                        _time.monotonic() - rank_failed_at
                    )
                    continue
                if all(c == 0 for c in codes):
                    self._close_logs(procs)
                    return report(0)
                tick_healthy()
                self._stop_event.wait(self.poll_interval_s)

            # one worker died: the run is lost — tear down the survivors,
            # pace by the policy's backoff, and respawn the whole mesh
            failed_at = _time.monotonic()
            telemetry.counter("cluster.worker_failures")
            _logger.warning("%s; tearing down survivors", failures[-1])
            self._terminate(procs)
            if failure_streak >= self.policy.max_restarts:
                _logger.error(
                    "cluster gave up after a streak of %d restart(s); "
                    "last failure: %s",
                    failure_streak,
                    failures[-1],
                )
                return report(failed_rc if failed_rc is not None else 1)
            delay = backoff.next_delay(failure_streak)
            if self._stop_event.wait(delay):
                failures.append(f"generation {generation}: stopped during backoff")
                return report(-1)
            telemetry.counter("cluster.restarts")
            merge_trace()  # fold the dead generation's dumps in now
            failure_streak += 1
            healthy_polls = 0
            generation += 1
            _logger.warning(
                "respawning cluster (generation %d; failure streak %d of "
                "at most %d)",
                generation,
                failure_streak,
                self.policy.max_restarts,
            )


class BackgroundMaintenance:
    """Single-flight guarded worker for background index maintenance.

    The segmented index (``stdlib/indexing/segments.py``) hands its merge
    jobs here so compaction runs off the query path.  One job is in
    flight at a time (merges are not reentrant); a failing job is retried
    on the same schedule connectors use
    (:class:`~pathway_tpu_torch.internals.udfs.ExponentialBackoffRetryStrategy`)
    and gives up after ``max_retries``, counting the failure in telemetry
    so /metrics shows maintenance that silently stopped making progress.
    """

    def __init__(
        self,
        name: str = "index-maintenance",
        *,
        max_retries: int = 2,
        initial_delay_ms: int = 50,
        max_delay_ms: int = 2000,
    ):
        self.name = name
        self._backoff = ExponentialBackoffRetryStrategy(
            max_retries=max_retries,
            initial_delay=initial_delay_ms,
            jitter_ms=0,
            max_delay_ms=max_delay_ms,
        )
        self._max_retries = max_retries
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._closed = False

    @property
    def busy(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def submit(self, job: Callable[[], None]) -> bool:
        """Run ``job`` on the maintenance thread; ``False`` if one is
        already in flight (the caller re-submits on its next trigger)."""
        with self._lock:
            if self._closed or self.busy:
                return False
            self._thread = threading.Thread(
                target=self._run, args=(job,), daemon=True, name=self.name
            )
            self._thread.start()
            return True

    def _run(self, job: Callable[[], None]) -> None:
        from pathway_tpu_torch.internals.telemetry import get_telemetry

        for attempt in range(self._max_retries + 1):
            try:
                job()
                return
            except Exception:  # noqa: BLE001
                get_telemetry().counter("index.merge_failures")
                _logger.exception("%s job failed (attempt %d)", self.name, attempt)
                if attempt >= self._max_retries or self._closed:
                    return
                _time.sleep(self._backoff.next_delay(attempt))

    def drain(self, timeout: float | None = 10.0) -> None:
        """Wait for the in-flight job (checkpoint/shutdown barrier)."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def close(self, timeout: float | None = 5.0) -> None:
        self._closed = True
        self.drain(timeout)
