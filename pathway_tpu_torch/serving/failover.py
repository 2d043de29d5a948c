"""Shard health, degraded serving, and snapshot-backed shard failover.

A single :class:`~pathway_tpu_torch.stdlib.indexing.segments.SegmentedIndex`
is one fail domain: when its owner dies, every query dies with it.  This
module partitions the corpus across N shard owners and makes the loss of
one owner a *degradation* instead of an outage (HedraRAG's
stage-isolation argument, EdgeRAG's recompute-on-miss-as-degraded-path):

- :class:`ShardHealthTracker` — per-shard ``alive``/``suspect``/``dead``
  states, mirroring the cluster membership states in
  :mod:`pathway_tpu_torch.engine.cluster`.  Failures promote (a configurable
  streak marks dead), successes demote, so one slow collect doesn't
  blacklist a shard forever.
- :class:`ShardOwner` — one shard's index plus its recovery machinery:
  a monotonic per-shard oplog and a periodic segment snapshot
  (``{"seq", "state"}``).  :meth:`ShardOwner.restore` rebuilds the shard
  from the snapshot and replays the oplog tail ``seq > snapshot_seq``
  **exactly once** (ops are uniquely sequenced; the snapshot records the
  high-water mark), then bumps the owner's ``incarnation`` — the
  generation handshake that lets in-flight probes detect they raced a
  restore.
- :class:`PartitionedIndex` — routes upserts by
  ``stable_shard(key) % n_shards`` and fans every query out to all
  shards.  Probes to dead shards are skipped or served from the
  snapshot-backed **standby** (stale up to one snapshot window, and
  therefore *not* authoritative); probes to suspect shards are hedged:
  collected on a side thread with a timeout, falling back to the standby
  if the owner doesn't answer in time.  The merged response carries the
  partial-result contract — ``partial: true`` with
  ``shards_answered``/``shards_total`` — instead of erroring, so the
  serving pipeline keeps answering at full speed on the healthy fraction
  of the corpus.
- :class:`ShardFailoverSupervisor` — background monitor that notices a
  dead shard and restores it (optionally paced through an SLO-scheduler
  ``recover`` lane so restore work cannot starve live queries),
  recording detection→restored wall time in the failover histogram.

The partial-result contract (documented in README "Degraded operation &
failover"): ``shards_answered`` counts **authoritative** owners only —
a standby-served shard keeps ``partial: true`` until its owner is
restored, because the standby may be stale by up to one snapshot window.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Sequence

import numpy as np

from pathway_tpu_torch.engine.cluster import (
    PEER_ALIVE,
    PEER_DEAD,
    PEER_SUSPECT,
    stable_shard,
)
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.internals.monitoring import _PyHist

__all__ = [
    "ShardHealthTracker",
    "ShardOwner",
    "PartitionedIndex",
    "ShardFailoverSupervisor",
]


class ShardHealthTracker:
    """Per-shard health states with streak-based promotion.

    ``record_failure`` moves ``alive -> suspect`` immediately and
    ``suspect -> dead`` after ``dead_after`` consecutive failures; any
    ``record_success`` resets the streak and demotes ``suspect`` back to
    ``alive``.  ``dead`` is sticky: only :meth:`revive` (called by the
    failover path after a successful restore) clears it, so a dead shard
    cannot flap back into the query path half-recovered."""

    def __init__(self, n_shards: int, *, dead_after: int = 2):
        self.n_shards = int(n_shards)
        self.dead_after = max(1, int(dead_after))
        self._lock = threading.Lock()
        self._state = {i: PEER_ALIVE for i in range(self.n_shards)}
        self._streak = {i: 0 for i in range(self.n_shards)}
        self._reason: dict[int, str | None] = {}

    def state(self, shard_id: int) -> str:
        with self._lock:
            return self._state[shard_id]

    def states(self) -> dict[int, str]:
        with self._lock:
            return dict(self._state)

    def record_failure(self, shard_id: int, reason: str | None = None) -> str:
        with self._lock:
            if self._state[shard_id] == PEER_DEAD:
                return PEER_DEAD
            self._streak[shard_id] += 1
            if self._streak[shard_id] >= self.dead_after:
                self._state[shard_id] = PEER_DEAD
                self._reason[shard_id] = reason
            else:
                self._state[shard_id] = PEER_SUSPECT
            return self._state[shard_id]

    def record_success(self, shard_id: int) -> None:
        with self._lock:
            self._streak[shard_id] = 0
            if self._state[shard_id] == PEER_SUSPECT:
                self._state[shard_id] = PEER_ALIVE

    def mark_dead(self, shard_id: int, reason: str | None = None) -> None:
        with self._lock:
            self._state[shard_id] = PEER_DEAD
            self._streak[shard_id] = self.dead_after
            self._reason[shard_id] = reason

    def mark_suspect(self, shard_id: int) -> None:
        with self._lock:
            if self._state[shard_id] == PEER_ALIVE:
                self._state[shard_id] = PEER_SUSPECT

    def revive(self, shard_id: int) -> None:
        with self._lock:
            self._state[shard_id] = PEER_ALIVE
            self._streak[shard_id] = 0
            self._reason.pop(shard_id, None)

    def dead_shards(self) -> list[int]:
        with self._lock:
            return sorted(
                i for i, s in self._state.items() if s == PEER_DEAD
            )

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._state.values() if s != PEER_DEAD)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "states": dict(self._state),
                "reasons": {
                    i: r for i, r in self._reason.items() if r is not None
                },
            }


class ShardOwner:
    """One shard's index plus its snapshot/oplog recovery machinery.

    Every mutation is sequenced into the oplog *before* it is applied,
    and a snapshot (``{"seq", "state"}``) is cut every
    ``snapshot_every`` ops — the pair is exactly the segment index's
    snapshot-plus-offset-tail recovery contract, applied per shard.
    :meth:`kill` simulates the owner dying (the live index is dropped —
    there is nothing to limp along on); :meth:`restore` builds a fresh
    index from the factory, loads the snapshot, and replays the tail
    ``seq > snapshot_seq`` exactly once, then bumps ``incarnation``."""

    def __init__(
        self,
        shard_id: int,
        index_factory: Callable[[], Any],
        *,
        snapshot_every: int = 256,
    ):
        self.shard_id = int(shard_id)
        self.index_factory = index_factory
        self.index: Any = index_factory()
        self.snapshot_every = max(1, int(snapshot_every))
        self.incarnation = 0
        self.alive = True
        self.tail_replayed = 0
        self.restores_total = 0
        self._lock = threading.RLock()
        self._seq = 0
        self._snapshot: dict[str, Any] | None = None
        self._snapshot_seq = 0
        # [(seq, op, key, vec-or-None)] — ops since the last snapshot
        self._oplog: list[tuple[int, str, Any, Any]] = []
        self._standby: Any = None  # lazy snapshot-backed read replica

    # ---------------------------------------------------------- mutation

    def add(self, items: Sequence[tuple[Any, Any]]) -> None:
        if not items:
            return
        with self._lock:
            prepared = []
            for key, vec in items:
                vec = np.asarray(vec, np.float32)
                self._seq += 1
                self._oplog.append((self._seq, "add", key, vec))
                prepared.append((key, vec))
            if self.alive:
                self.index.add(prepared)
            self._maybe_snapshot_locked()

    def remove(self, keys: Sequence[Any]) -> None:
        if not keys:
            return
        with self._lock:
            for key in keys:
                self._seq += 1
                self._oplog.append((self._seq, "remove", key, None))
            if self.alive:
                self.index.remove(list(keys))
            self._maybe_snapshot_locked()

    def _maybe_snapshot_locked(self) -> None:
        if not self.alive:
            return
        if self._seq - self._snapshot_seq >= self.snapshot_every:
            self.snapshot_now()

    def snapshot_now(self) -> None:
        """Cut a snapshot at the current high-water mark and trim the
        oplog below it — the tail that remains is exactly what a restore
        must replay."""
        with self._lock:
            if not self.alive:
                return
            self._snapshot = {
                "seq": self._seq,
                "state": self.index.state_dict(),
            }
            self._snapshot_seq = self._seq
            self._oplog = [
                op for op in self._oplog if op[0] > self._snapshot_seq
            ]
            self._standby = None  # stale: rebuilt lazily from new snapshot

    # ----------------------------------------------------------- failure

    def kill(self) -> None:
        """Simulate the shard owner dying: the live index is gone.  The
        snapshot and oplog survive (they model durable state — the
        segment snapshot plus the connector offset tail)."""
        with self._lock:
            self.alive = False
            self.index = None

    def restore(self) -> float:
        """Rebuild from the snapshot + exactly-once oplog tail replay.

        Returns wall seconds spent restoring.  Idempotent: restoring an
        already-alive owner is a no-op returning 0.  Each oplog entry is
        applied at most once because entries are uniquely sequenced and
        the replay window is strictly ``seq > snapshot_seq``."""
        with self._lock:
            if self.alive:
                return 0.0
            t0 = time.monotonic()
            index = self.index_factory()
            if self._snapshot is not None:
                index.load_state_dict(self._snapshot["state"])
            tail = [op for op in self._oplog if op[0] > self._snapshot_seq]
            adds: list[tuple[Any, Any]] = []
            for _seq, op, key, vec in tail:
                if op == "add":
                    adds.append((key, vec))
                else:
                    if adds:
                        index.add(adds)
                        adds = []
                    index.remove([key])
            if adds:
                index.add(adds)
            self.tail_replayed += len(tail)
            self.index = index
            self.alive = True
            self.restores_total += 1
            # the generation handshake: in-flight probes dispatched
            # against the dead incarnation detect the mismatch at
            # collect time and re-search the restored index
            self.incarnation += 1
            return time.monotonic() - t0

    # ------------------------------------------------------------ search

    def dispatch(self, queries: np.ndarray, k: int) -> Any:
        with self._lock:
            if not self.alive:
                raise RuntimeError(f"shard {self.shard_id} owner dead")
            return self.index.dispatch(queries, k)

    def collect(self, handle: Any) -> list[list[tuple[Any, float]]]:
        with self._lock:
            if not self.alive:
                raise RuntimeError(f"shard {self.shard_id} owner dead")
            index = self.index
        return index.collect(handle)

    def search(self, queries: np.ndarray, k: int) -> list:
        with self._lock:
            if not self.alive:
                raise RuntimeError(f"shard {self.shard_id} owner dead")
            index = self.index
        return index.search(queries, k)

    def standby_search(self, queries: np.ndarray, k: int) -> list | None:
        """Serve from the snapshot-backed standby (stale by up to one
        snapshot window — the caller must keep the response marked
        partial).  Returns None when no snapshot exists yet."""
        with self._lock:
            if self._snapshot is None:
                return None
            if self._standby is None:
                standby = self.index_factory()
                standby.load_state_dict(self._snapshot["state"])
                self._standby = standby
            standby = self._standby
        return standby.search(queries, k)

    def __len__(self) -> int:
        with self._lock:
            return len(self.index) if self.alive else 0

    def keys(self) -> list:
        with self._lock:
            if not self.alive:
                return []
            keys = self.index.keys
            return list(keys() if callable(keys) else keys)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "shard_id": self.shard_id,
                "alive": self.alive,
                "size": len(self.index) if self.alive else 0,
                "incarnation": self.incarnation,
                "seq": self._seq,
                "snapshot_seq": self._snapshot_seq,
                "oplog_tail": len(
                    [op for op in self._oplog if op[0] > self._snapshot_seq]
                ),
                "tail_replayed": self.tail_replayed,
                "restores_total": self.restores_total,
            }


class _PartProbe:
    """In-flight partitioned search: one entry per shard, plus the
    coverage fields stamped by :meth:`PartitionedIndex.collect` —
    :class:`~pathway_tpu_torch.serving.coscheduler.StageCoScheduler` reads them
    off the handle to build the partial-result contract."""

    __slots__ = (
        "queries",
        "k",
        "entries",
        "partial",
        "shards_answered",
        "shards_total",
        "shards_standby",
    )

    def __init__(self, queries: np.ndarray, k: int, entries: list):
        self.queries = queries
        self.k = k
        self.entries = entries
        self.partial = False
        self.shards_answered = 0
        self.shards_total = len(entries)
        self.shards_standby = 0


class PartitionedIndex:
    """N shard owners behind one ``(key, vector)`` index facade.

    Routing is ``stable_shard(key) % n_shards`` (process-stable, so the
    same key always lands on the same shard across restarts).  Queries
    fan out to every shard; per-shard failures degrade the response
    instead of failing it — see the module docstring for the contract.
    """

    def __init__(
        self,
        index_factory: Callable[[], Any],
        n_shards: int = 2,
        *,
        snapshot_every: int = 256,
        hedge_timeout_s: float = 0.25,
        standby: bool = True,
        dead_after: int = 2,
        health: ShardHealthTracker | None = None,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = int(n_shards)
        self.hedge_timeout_s = float(hedge_timeout_s)
        self.standby = bool(standby)
        self.owners = [
            ShardOwner(i, index_factory, snapshot_every=snapshot_every)
            for i in range(self.n_shards)
        ]
        self.health = (
            health
            if health is not None
            else ShardHealthTracker(self.n_shards, dead_after=dead_after)
        )
        self._lock = threading.Lock()
        self.degraded_responses = 0
        self.failovers_total = 0
        self.probes_recovered = 0
        self.standby_serves = 0
        #: detection→restored wall time per failover (ns buckets)
        self.failover_hist = _PyHist()
        from pathway_tpu_torch import serving as _serving

        _serving._register_shard_set(self)

    # ----------------------------------------------------------- routing

    def _route(self, key: Any) -> int:
        return stable_shard(key) % self.n_shards

    def add(self, items: Sequence[tuple[Any, Any]]) -> None:
        by_shard: dict[int, list] = {}
        for key, vec in items:
            by_shard.setdefault(self._route(key), []).append((key, vec))
        for sid, part in by_shard.items():
            self.owners[sid].add(part)

    def remove(self, keys: Sequence[Any]) -> None:
        by_shard: dict[int, list] = {}
        for key in keys:
            by_shard.setdefault(self._route(key), []).append(key)
        for sid, part in by_shard.items():
            self.owners[sid].remove(part)

    def __len__(self) -> int:
        return sum(len(o) for o in self.owners)

    def keys(self) -> list:
        out: list = []
        for o in self.owners:
            out.extend(o.keys())
        return out

    @property
    def has_standby(self) -> bool:
        return self.standby

    # ------------------------------------------------------------ search

    def dispatch(self, queries: np.ndarray, k: int) -> _PartProbe:
        """Fan the probe out to every shard whose owner might answer.

        Dead shards get a ``standby``/``skip`` entry up front (no wasted
        dispatch); a dispatch failure on a live shard records against its
        health and degrades to the standby path for this probe."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        entries: list[tuple] = []
        for sid, owner in enumerate(self.owners):
            if self.health.state(sid) == PEER_DEAD:
                entries.append(("standby" if self.standby else "skip", sid))
                continue
            try:
                with _tracing.span("dispatch_shard", {"shard": sid}):
                    handle = owner.dispatch(queries, k)
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                self.health.record_failure(sid, repr(e))
                entries.append(("standby" if self.standby else "skip", sid))
                continue
            entries.append(("handle", sid, owner.incarnation, handle))
        return _PartProbe(queries, k, entries)

    def _collect_one(
        self, sid: int, incarnation: int, handle: Any, probe: _PartProbe
    ) -> list | None:
        """Collect one shard's probe; None means this shard contributed
        nothing authoritative (caller decides on standby)."""
        owner = self.owners[sid]
        if owner.incarnation != incarnation:
            # the owner was restored while the probe was in flight: the
            # handle belongs to the dead incarnation — re-search the
            # restored index (authoritative) instead of trusting it
            try:
                hits = owner.search(probe.queries, probe.k)
            except Exception as e:  # noqa: BLE001
                self.health.record_failure(sid, repr(e))
                return None
            with self._lock:
                self.probes_recovered += 1
            self.health.record_success(sid)
            return hits
        if self.health.state(sid) == PEER_SUSPECT:
            # hedged collect: a suspect owner gets one bounded chance
            result: dict[str, Any] = {}

            def _run() -> None:
                try:
                    result["hits"] = owner.collect(handle)
                except Exception as e:  # noqa: BLE001
                    result["exc"] = e

            t = threading.Thread(
                target=_run, daemon=True, name=f"pw-hedge-collect-{sid}"
            )
            t.start()
            t.join(self.hedge_timeout_s)
            if t.is_alive() or "exc" in result:
                reason = repr(result.get("exc", "hedge timeout"))
                self.health.record_failure(sid, reason)
                return None
            self.health.record_success(sid)
            return result["hits"]
        try:
            t0 = time.monotonic()
            hits = owner.collect(handle)
            if time.monotonic() - t0 > self.hedge_timeout_s:
                # answered, but slow: flag for hedging next time
                self.health.mark_suspect(sid)
            else:
                self.health.record_success(sid)
            return hits
        except Exception as e:  # noqa: BLE001
            self.health.record_failure(sid, repr(e))
            return None

    def collect(self, probe: _PartProbe) -> list[list[tuple[Any, float]]]:
        """Resolve the fan-out: merge per-shard top-k into global top-k
        and stamp the coverage fields on the handle.  A shard that fails
        at collect degrades to its standby (when enabled) — the response
        is marked partial, never an exception."""
        n_q = probe.queries.shape[0]
        per_query: list[list[tuple[Any, float]]] = [[] for _ in range(n_q)]
        answered = 0
        standby_served = 0
        for entry in probe.entries:
            if entry[0] == "handle":
                _tag, sid, incarnation, handle = entry
                with _tracing.span("collect_shard", {"shard": sid}):
                    hits = self._collect_one(sid, incarnation, handle, probe)
                if hits is not None:
                    answered += 1
                    for qi in range(n_q):
                        per_query[qi].extend(hits[qi])
                    continue
                # fall through to standby for this shard
            sid = entry[1]
            if self.standby:
                hits = self.owners[sid].standby_search(
                    probe.queries, probe.k
                )
                if hits is not None:
                    standby_served += 1
                    for qi in range(n_q):
                        per_query[qi].extend(hits[qi])
        out = []
        for qi in range(n_q):
            merged = per_query[qi]
            merged.sort(key=lambda kv: (-kv[1], str(kv[0])))
            out.append(merged[: probe.k])
        probe.shards_answered = answered
        probe.shards_standby = standby_served
        probe.partial = answered < probe.shards_total
        if probe.partial:
            with self._lock:
                self.degraded_responses += 1
                self.standby_serves += standby_served
        return out

    def search(self, queries: np.ndarray, k: int) -> list:
        return self.collect(self.dispatch(queries, k))

    # ----------------------------------------------------------- failover

    def fail_shard(self, shard_id: int, reason: str = "killed") -> None:
        """Kill one shard owner (chaos/test API): the live index drops,
        health goes dead, queries degrade immediately."""
        self.owners[shard_id].kill()
        self.health.mark_dead(shard_id, reason)

    def recover_shard(self, shard_id: int, detected_at: float | None = None) -> float:
        """Restore a dead shard from snapshot + exactly-once tail replay
        and put it back in the query path.  Returns failover seconds
        (detection→restored when ``detected_at`` is given, else restore
        time alone) and records it in the failover histogram."""
        t_detect = detected_at if detected_at is not None else time.monotonic()
        self.owners[shard_id].restore()
        self.health.revive(shard_id)
        elapsed = time.monotonic() - t_detect
        with self._lock:
            self.failovers_total += 1
        self.failover_hist.record(int(elapsed * 1e9))
        return elapsed

    # ------------------------------------------------------- persistence

    def state_dict(self) -> dict:
        return {
            "kind": "partitioned",
            "shards": [o.index.state_dict() for o in self.owners],
        }

    def load_state_dict(self, state: dict) -> None:
        shards = state["shards"]
        if len(shards) != self.n_shards:
            raise ValueError(
                f"shard count mismatch: state has {len(shards)}, "
                f"index has {self.n_shards}"
            )
        for owner, sub in zip(self.owners, shards):
            owner.index.load_state_dict(sub)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            degraded = self.degraded_responses
            failovers = self.failovers_total
            recovered = self.probes_recovered
            standby_serves = self.standby_serves
        return {
            "shards_total": self.n_shards,
            "shards_healthy": self.health.healthy_count(),
            "health": self.health.states(),
            "degraded_responses": degraded,
            "failovers_total": failovers,
            "probes_recovered": recovered,
            "standby_serves": standby_serves,
            "failover_seconds": self.failover_hist.snapshot(),
            "shards": [o.stats() for o in self.owners],
        }

    def close(self) -> None:
        for o in self.owners:
            index = o.index
            close = getattr(index, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass


class ShardFailoverSupervisor:
    """Background monitor: notices dead shards and restores them.

    The restore can be paced through an SLO-scheduler lane (default
    ``recover``) so recovery work shares device time under the same
    fairness discipline as live queries instead of stealing it; without
    a scheduler it runs inline on the monitor thread.  Detection→restored
    wall time lands in the partitioned index's failover histogram."""

    def __init__(
        self,
        part: PartitionedIndex,
        *,
        poll_interval_s: float = 0.05,
        scheduler: Any = None,
        lane: str = "recover",
    ):
        self.part = part
        self.poll_interval_s = float(poll_interval_s)
        self.scheduler = scheduler
        self.lane = lane
        if scheduler is not None:
            ensure = getattr(scheduler, "ensure_lane", None)
            if ensure is not None:
                ensure(lane, share=0.25)
        self._stopped = threading.Event()
        self._inflight: set[int] = set()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pw-shard-failover"
        )
        self._thread.start()

    def _restore(self, args: tuple[int, float]) -> float:
        sid, detected_at = args
        try:
            return self.part.recover_shard(sid, detected_at=detected_at)
        finally:
            with self._lock:
                self._inflight.discard(sid)

    def _loop(self) -> None:
        while not self._stopped.is_set():
            for sid in self.part.health.dead_shards():
                with self._lock:
                    if sid in self._inflight:
                        continue
                    self._inflight.add(sid)
                detected_at = time.monotonic()
                if self.scheduler is not None:
                    self.scheduler.submit(
                        self.lane, "batch", self._restore, (sid, detected_at)
                    )
                else:
                    try:
                        self._restore((sid, detected_at))
                    except Exception:  # noqa: BLE001 — retried next poll
                        pass
            self._stopped.wait(self.poll_interval_s)

    def close(self, timeout: float = 5.0) -> None:
        self._stopped.set()
        self._thread.join(timeout)
