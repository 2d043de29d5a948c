"""Segmented online index maintenance: delta segment + background merge
(counterpart of ``pathway_tpu/stdlib/indexing/segments.py``).

EdgeRAG-style online indexing (PAPERS.md) for the live-churn workload:
continuous upserts *and* deletions with bounded recall loss, while the
heavy index stays mostly sealed.  :class:`SegmentedIndex` fronts any
``(key, vector)`` index (host HNSW, device sharded slab, device IVF)
with

- a mutable **delta segment** — a host dict of the most recent upserts,
  searched exactly and merged with main-segment results, so a fresh
  upsert is visible to the very next query without touching the sealed
  main index;
- a **tombstone set shared across segments** — deletions mask the main
  (and, mid-merge, the frozen) segment instead of mutating it; removing
  an absent key is a no-op;
- a **background merge** that freezes the delta + tombstones and
  compacts them into the main segment off the query path, either by
  rebuilding a fresh main (graph indexes: ``merge_strategy =
  "rebuild"``) or by applying remove+upsert in place (device slabs:
  ``"inplace"``).

Consistency: segment bookkeeping (delta, tombstones, freeze, commit)
happens under ``self._lock``; a query snapshots the delta view and mask
under it, then runs the main-segment search and the delta scan OFF the
lock — so queries don't serialize on the segment and updates or
checkpoints never queue behind a graph walk or device dispatch.
In-place main mutation (bulk load, inplace merge, restore) excludes
searchers via a second ``_main_mutex``; rebuild merges swap ``main``
atomically, which the snapshot tolerates.  A query — and a checkpoint's
:meth:`state_dict` — therefore observes either the pre-merge or the
post-merge segmentation, never a torn mix; a key deleted mid-merge is
filtered from the frozen delta everywhere (search, checkpoint, merge
fold-in, rollback), so a delete is never undone by merge machinery.  A
merge interrupted by a crash loses only the merge work: the
checkpointed state is the pre-merge view, and a failed in-process merge
rolls the frozen delta/tombstones back into the live segment.

On the card: the merge runs on the maintenance thread and its
``main.remove``/``main.add`` launch K2 there.  Each kernel wrapper makes
its tensors' card current for the launch (``kernels/_launch.py``), and
a thread's current stream on a card is the default stream unless it
sets another, so a merge's scatters and a query's K3 search run in
stream order on one stream; ``_main_mutex`` orders their enqueueing.

Tuning knobs (constructor args, env defaults):

- ``delta_cap`` / ``PATHWAY_INDEX_DELTA_CAP`` (1024) — delta size that
  triggers a merge; also the bulk-load threshold below which a batch
  goes through the delta instead of straight into main.
- ``tombstone_fraction`` / ``PATHWAY_INDEX_TOMBSTONE_FRACTION`` (0.25)
  — tombstones/main ratio that triggers a merge.
- ``auto_merge`` / ``PATHWAY_INDEX_AUTO_MERGE`` (1) — 0 pins merges to
  explicit :meth:`merge` calls (tests, deterministic drills).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from pathway_tpu_torch.internals import tracing as _tracing

__all__ = ["SegmentedIndex"]


class _SegProbe:
    """In-flight search snapshot from :meth:`SegmentedIndex.dispatch`:
    the delta view + tombstone mask taken at dispatch time, plus either
    the main segment's async device handle (``probe``) or its eagerly
    computed hits (``main_hits``).  ``main is None`` marks a probe over
    an empty index.

    The probe also carries the serving layer's partial-result contract
    (``partial``/``shards_answered``/``shards_total``): a single
    SegmentedIndex is one shard that always answers authoritatively, so
    the identity coverage ``1/1`` — the multi-shard variant lives in
    :class:`pathway_tpu_torch.serving.failover.PartitionedIndex`, whose
    probe carries the same fields with real per-shard health behind them."""

    __slots__ = (
        "queries",
        "k",
        "delta",
        "mask",
        "main",
        "probe",
        "main_hits",
        "partial",
        "shards_answered",
        "shards_total",
    )

    def __init__(self, queries, k, delta, mask, main, probe, main_hits):
        self.queries = queries
        self.k = k
        self.delta = delta
        self.mask = mask
        self.main = main
        self.probe = probe
        self.main_hits = main_hits
        self.partial = False
        self.shards_answered = 1
        self.shards_total = 1


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class SegmentedIndex:
    """Delta segment + tombstones + background merge over ``main``.

    ``main`` is any index with the repo's ``(key, vector)`` contract:
    ``add(items)``, ``remove(keys)``, ``search(queries, k)``,
    ``__len__``; ``state_dict``/``load_state_dict`` make the whole
    segmented index checkpointable, and ``export()`` (keys, matrix)
    enables rebuild-style merges.
    """

    def __init__(
        self,
        main: Any,
        *,
        delta_cap: int | None = None,
        tombstone_fraction: float | None = None,
        auto_merge: bool | None = None,
        maintenance: Any | None = None,
    ):
        self.main = main
        self.metric = getattr(main, "metric", "cos")
        self.delta_cap = max(
            1,
            delta_cap
            if delta_cap is not None
            else _env_int("PATHWAY_INDEX_DELTA_CAP", 1024),
        )
        self.tombstone_fraction = (
            tombstone_fraction
            if tombstone_fraction is not None
            else _env_float("PATHWAY_INDEX_TOMBSTONE_FRACTION", 0.25)
        )
        self.auto_merge = (
            auto_merge
            if auto_merge is not None
            else _env_int("PATHWAY_INDEX_AUTO_MERGE", 1) != 0
        )
        self._lock = threading.RLock()
        # excludes in-place main mutation (bulk load, inplace merge,
        # restore) from searchers, which run main.search off `_lock`;
        # always acquired INSIDE `_lock`, never the other way around
        self._main_mutex = threading.Lock()
        # live segment membership (authoritative: main ∪ delta − tombs)
        self._keys: set[Any] = set(self._main_keys())
        self._delta: dict[Any, np.ndarray] = {}
        self._tombs: set[Any] = set()
        # frozen mid-merge snapshot (empty unless a merge is in flight)
        self._frozen: dict[Any, np.ndarray] = {}
        self._frozen_tombs: set[Any] = set()
        self._merging = False
        self.merges_total = 0
        self.merge_failures = 0
        #: speculative-probe accounting (serving lookahead retrieval):
        #: probes fired via :meth:`dispatch`, and probes whose device
        #: handle went stale (index restored mid-flight) and were
        #: recovered by re-running the search
        self.probes_dispatched = 0
        self.probes_recovered = 0
        self._maintenance = maintenance

    # ---------------------------------------------------------------- helpers

    def _main_keys(self) -> Iterable[Any]:
        keys = getattr(self.main, "keys", None)
        if callable(keys):  # method (hnsw, ivf)
            return keys()
        if keys is not None:  # property returning a list (sharded slab)
            return keys
        return ()

    def _prep(self, vecs: np.ndarray) -> np.ndarray:
        vecs = np.ascontiguousarray(np.atleast_2d(vecs), np.float32)
        if self.metric == "cos":
            norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
            vecs = vecs / np.maximum(norms, 1e-12)
        return vecs

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._keys

    def keys(self) -> list:
        with self._lock:
            return list(self._keys)

    # ---------------------------------------------------------------- updates

    def add(self, items: Sequence[tuple[Any, Any]]) -> None:
        """Upsert ``(key, vector)`` pairs into the delta segment.

        A batch at least ``delta_cap`` large with nothing buffered is a
        bulk load and goes straight into the sealed main segment — the
        initial corpus shouldn't crawl through the delta."""
        if not items:
            return
        with self._lock:
            if (
                len(items) >= self.delta_cap
                and not self._delta
                and not self._tombs
                and not self._merging
            ):
                with self._main_mutex:
                    self.main.add(list(items))
                self._keys = set(self._main_keys())
                return
            for key, vec in items:
                self._tombs.discard(key)
                self._delta[key] = self._prep(np.asarray(vec, np.float32))[0]
                self._keys.add(key)
            self._maybe_merge_locked()

    def remove(self, keys: Sequence[Any]) -> None:
        """Delete keys; an absent key is a no-op.  Keys living in the
        main (or frozen) segment are tombstoned, not physically removed —
        the merge reclaims them."""
        with self._lock:
            for key in keys:
                if key in self._delta:
                    del self._delta[key]
                    # the key may ALSO live in main/frozen under an older
                    # value — tombstone unless the delta held the only copy
                    if key in self._keys and (
                        key in self._frozen or self._has_in_main(key)
                    ):
                        self._tombs.add(key)
                elif key in self._keys:
                    self._tombs.add(key)
                self._keys.discard(key)
            self._maybe_merge_locked()

    def _has_in_main(self, key: Any) -> bool:
        has = getattr(self.main, "__contains__", None)
        if has is not None:
            try:
                return key in self.main
            except TypeError:
                pass
        return True  # conservative: a stray tombstone is a later no-op

    # ----------------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[Any, float]]]:
        """Top-k per query, ``[(key, score), ...]``, higher = closer.

        Precedence per key: live delta > frozen delta > main; tombstones
        mask the older segments.  Scores are computed in the same metric
        space for every segment, so the cross-segment merge is a plain
        sort.  Implemented as an immediate dispatch + collect pair, so
        the synchronous path and the serving lookahead path share one
        snapshot/merge discipline."""
        return self.collect(self.dispatch(queries, k))

    def dispatch(self, queries: np.ndarray, k: int) -> "_SegProbe":
        """Fire a search probe and return a handle for :meth:`collect`.

        The segment view (delta + tombstone mask) is snapshotted under
        ``_lock``; the main-segment probe then launches OFF the lock, so
        upserts, deletes and checkpoints never queue behind a graph walk
        or device dispatch, and queries don't serialize on the segment.
        This is safe because ``self.main`` only changes by atomic
        pointer swap at a rebuild commit (the snapshot tolerates that),
        in-place main mutation (bulk load, inplace merge, restore)
        excludes probes via ``_main_mutex``, and every key such a
        mutation touches is covered by the snapshotted delta/mask —
        either the pre- or post-merge main yields the same merged
        result.

        When the main segment supports async device probes
        (``main.dispatch``, e.g. the sharded slab), only the launch
        happens here — the device computes while the caller does other
        work and :meth:`collect` pays the host sync (TeleRAG-style
        lookahead retrieval).  Host-only main segments run their search
        eagerly on the dispatching thread instead, which preserves the
        same overlap for a serving loop whose dispatch and collect run
        on different stages."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        with self._lock:
            if not self._keys:
                return _SegProbe(queries, 0, {}, set(), None, None, None)
            k = min(k, len(self._keys))
            delta = self._delta_view_locked()
            # main results to drop: deleted keys + keys shadowed by delta
            mask = set(delta)
            mask.update(self._tombs)
            mask.update(self._frozen_tombs)
            main = self.main
            n_main = len(main)
        probe = None
        main_hits: list[list[tuple[Any, float]]] | None = None
        if n_main:
            fetch = min(k + len(mask), n_main)
            main_dispatch = getattr(main, "dispatch", None)
            if main_dispatch is not None:
                t0_ns = _tracing.now_ns()
                with self._main_mutex:
                    probe = main_dispatch(queries, fetch)
                _tracing.record_span("dispatch_segments", t0_ns, _tracing.now_ns())
                with self._lock:
                    self.probes_dispatched += 1
            elif getattr(main, "concurrent_search", False):
                main_hits = main.search(queries, fetch)
            else:
                with self._main_mutex:
                    main_hits = main.search(queries, fetch)
        return _SegProbe(queries, k, delta, mask, main, probe, main_hits)

    def collect(self, handle: "_SegProbe") -> list[list[tuple[Any, float]]]:
        """Resolve a :meth:`dispatch` handle to merged top-k results.

        A device probe whose handle went stale (the index was restored
        via ``load_state_dict`` while it was in flight) is recovered by
        re-running the full search against the restored index — the
        caller sees current results, never an exception or wrong keys."""
        queries, k = handle.queries, handle.k
        if handle.main is None:
            return [[] for _ in range(queries.shape[0])]
        main_hits = handle.main_hits
        if main_hits is None and handle.probe is not None:
            try:
                t0_ns = _tracing.now_ns()
                main_hits = handle.main.collect(handle.probe)
                _tracing.record_span("collect_segments", t0_ns, _tracing.now_ns())
            except RuntimeError:
                with self._lock:
                    self.probes_recovered += 1
                return self.search(queries, k)
        if main_hits is None:
            main_hits = [[] for _ in range(queries.shape[0])]
        delta_hits = self._search_delta(queries, handle.delta, k)
        mask = handle.mask
        out: list[list[tuple[Any, float]]] = []
        for qi in range(queries.shape[0]):
            merged = [
                (key, s) for key, s in main_hits[qi] if key not in mask
            ]
            merged.extend(delta_hits[qi])
            merged.sort(key=lambda kv: (-kv[1], str(kv[0])))
            out.append(merged[:k])
        return out

    def _delta_view_locked(self) -> dict[Any, np.ndarray]:
        """Combined delta: frozen entries shadowed by live ones.  A key
        deleted AFTER the freeze sits in ``_tombs`` and its frozen copy
        must not resurface through this view (the live ``_delta`` is
        always disjoint from ``_tombs``, so the filter only ever drops
        stale frozen entries)."""
        if not self._frozen:
            return dict(self._delta)
        view = {
            key: vec
            for key, vec in self._frozen.items()
            if key not in self._tombs
        }
        view.update(self._delta)
        return view

    def _search_delta(
        self, queries: np.ndarray, delta: dict[Any, np.ndarray], k: int
    ) -> list[list[tuple[Any, float]]]:
        if not delta:
            return [[] for _ in range(queries.shape[0])]
        keys = list(delta.keys())
        mat = np.stack([delta[key] for key in keys])
        q = self._prep(queries)
        if self.metric == "l2sq":
            scores = -(((q[:, None, :] - mat[None, :, :]) ** 2).sum(-1))
        else:
            scores = q @ mat.T
        out = []
        top_n = min(k, len(keys))
        for row in scores:
            top = np.argsort(-row)[:top_n]
            out.append([(keys[i], float(row[i])) for i in top])
        return out

    # ------------------------------------------------------------------ merge

    def _maybe_merge_locked(self) -> None:
        if not self.auto_merge or self._merging:
            return
        due = len(self._delta) >= self.delta_cap or (
            len(self._tombs) >= 16
            and len(self._tombs)
            >= self.tombstone_fraction * max(len(self.main), 1)
        )
        if due:
            self._schedule_merge()

    def _schedule_merge(self) -> None:
        m = self._maintenance
        if m is None:
            from pathway_tpu_torch.internals.resilience import BackgroundMaintenance

            m = self._maintenance = BackgroundMaintenance()
        m.submit(self._run_merge)

    def merge(self, wait: bool = True) -> None:
        """Trigger a merge now.  ``wait=False`` hands it to the
        maintenance thread and returns immediately."""
        if wait:
            self._run_merge()
            m = self._maintenance
            if m is not None:  # a concurrent background merge may hold it
                m.drain()
        else:
            self._schedule_merge()

    def _run_merge(self) -> None:
        with self._lock:
            if self._merging or (not self._delta and not self._tombs):
                return
            self._merging = True
            self._frozen, self._delta = self._delta, {}
            self._frozen_tombs, self._tombs = self._tombs, set()
        try:
            strategy = getattr(self.main, "merge_strategy", "inplace")
            if strategy == "rebuild":
                self._merge_rebuild()
            else:
                self._merge_inplace()
        except BaseException:
            with self._lock:  # full rollback: frozen back into live
                self.merge_failures += 1
                frozen, self._frozen = self._frozen, {}
                ftombs, self._frozen_tombs = self._frozen_tombs, set()
                # keys deleted after the freeze stay deleted: their
                # frozen copies must not ride the rollback back to life
                frozen = {
                    key: vec
                    for key, vec in frozen.items()
                    if key not in self._tombs
                }
                frozen.update(self._delta)  # post-freeze upserts win
                self._delta = frozen
                self._tombs |= {t for t in ftombs if t not in self._delta}
                self._merging = False
            raise

    def _pre_commit(self) -> None:
        """Chaos hook: the instant between a finished merge and its
        atomic commit (``testing/chaos.py kill_worker_mid_merge``)."""

    def _commit_locked(self) -> None:
        self._frozen = {}
        self._frozen_tombs = set()
        self._merging = False
        self.merges_total += 1
        try:
            from pathway_tpu_torch.internals.telemetry import get_telemetry

            get_telemetry().counter("index.merges")
        except Exception:  # noqa: BLE001
            pass

    def _frozen_survivors_locked(self) -> dict[Any, np.ndarray]:
        """Frozen-delta entries that still belong in main: a key deleted
        after the freeze (now in ``_tombs``) must not be folded back in,
        or the delete would be undone once its tombstone is discarded."""
        return {
            key: vec
            for key, vec in self._frozen.items()
            if key not in self._tombs and key not in self._frozen_tombs
        }

    def _merge_rebuild(self) -> None:
        """Build a fresh main from survivors + frozen delta off-lock,
        then pointer-swap.  Doubles as compaction for graph indexes."""
        old = self.main
        with self._lock:
            # `_frozen`/`_frozen_tombs` are only touched by this merge,
            # but `_tombs` absorbs concurrent deletes — snapshot the
            # survivor set under the lock.  A delete landing after this
            # snapshot leaves its key in the new main AND in `_tombs`:
            # still masked from every query, reclaimed next merge.
            frozen = self._frozen_survivors_locked()
            drop = set(self._frozen_tombs) | set(self._frozen)
        keys, mat = old.export()
        new = old.fresh()
        survivors = [i for i, key in enumerate(keys) if key not in drop]
        items: list[tuple[Any, Any]] = [(keys[i], mat[i]) for i in survivors]
        items.extend(frozen.items())
        for i in range(0, len(items), 4096):
            new.add(items[i : i + 4096])
        with self._lock:
            self._pre_commit()
            self.main = new
            self._commit_locked()

    def _merge_inplace(self) -> None:
        """Apply frozen tombstones + delta to the device slab.  The lock
        is held across remove+add: both are cheap host-side dispatches,
        and holding it keeps a concurrent checkpoint from seeing the
        removed-but-not-yet-upserted gap (searchers are excluded by
        ``_main_mutex`` and their snapshotted delta/mask covers every
        key touched here)."""
        with self._lock:
            dead = [t for t in self._frozen_tombs if self._has_in_main(t)]
            frozen = self._frozen_survivors_locked()
            with self._main_mutex:
                if dead:
                    self.main.remove(dead)
                if frozen:
                    self.main.add(list(frozen.items()))
            self._pre_commit()
            self._commit_locked()

    # ------------------------------------------------------------ persistence

    def state_dict(self) -> dict:
        """Snapshot-consistent state: taken under the segment lock, so a
        checkpoint racing a merge serializes the pre-merge view (frozen
        folded back into the delta) — a crash mid-merge restores cleanly
        and the merge simply re-runs after replay."""
        with self._lock:
            # the tombstone-filtered view: a key deleted after the
            # freeze must serialize as deleted, not in delta_keys AND
            # tombstones at once (loading such a state, then merging,
            # would re-insert the frozen vector while discarding the
            # tombstone — permanently resurrecting the deleted doc)
            delta = self._delta_view_locked()
            tombs = set(self._tombs) | {
                t for t in self._frozen_tombs if t not in delta
            }
            keys = list(delta.keys())
            return {
                "kind": "segmented",
                "main": self.main.state_dict(),
                "delta_keys": keys,
                "delta_vectors": np.stack([delta[key] for key in keys])
                if keys
                else np.zeros((0, 0), np.float32),
                "tombstones": list(tombs),
                "merges_total": self.merges_total,
            }

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            with self._main_mutex:
                self.main.load_state_dict(state["main"])
            vecs = np.asarray(state["delta_vectors"], np.float32)
            tombs = set(state["tombstones"])
            # a checkpoint from before the delta-view fix could carry a
            # key in both delta_keys and tombstones; the delete wins
            self._delta = {
                key: vecs[i]
                for i, key in enumerate(state["delta_keys"])
                if key not in tombs
            }
            self._tombs = tombs
            self._frozen = {}
            self._frozen_tombs = set()
            self._merging = False
            self.merges_total = int(state.get("merges_total", 0))
            self._keys = (set(self._main_keys()) | set(self._delta)) - self._tombs

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._keys),
                "main_size": len(self.main),
                "delta_size": len(self._delta) + len(self._frozen),
                "tombstones": len(self._tombs) + len(self._frozen_tombs),
                "merges_total": self.merges_total,
                "merge_failures": self.merge_failures,
                "merging": self._merging,
                "probes_dispatched": self.probes_dispatched,
                "probes_recovered": self.probes_recovered,
            }

    def close(self) -> None:
        m = self._maintenance
        if m is not None:
            m.close()
