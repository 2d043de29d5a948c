"""Host HNSW graph ANN index (counterpart of
``pathway_tpu/stdlib/indexing/hnsw.py``; the reference's usearch role,
``src/external_integration/usearch_integration.rs:1-163``).

The graph walk is pointer-chasing — hostile to a GPU's wide lanes as to
XLA — so like the reference this index lives on the host: the C++
implementation in the port's ``native/pathway_native.cpp`` (``hnsw_*``,
loaded as ``pathway_torch_native``), fronted here by a key-mapped
wrapper with the same ``(key, vector)`` contract as
:class:`~pathway_tpu_torch.parallel.ShardedKnnIndex`.  Without the native
module it degrades to exact brute force (numpy), which is slower but
identical in results.

Scores follow the repo convention (higher = closer): ``cos``/``dot``
return the inner product; ``l2sq`` the negated squared distance.

Removal tombstones graph slots rather than unlinking them, so
long-running churn walks over dead entries; once the dead fraction
passes ``tombstone_fraction`` the index compacts itself by rebuilding
the graph from the host-side vector store.  The same store backs
``state_dict``/``load_state_dict`` (checkpoint restore) and
``export``/``fresh`` (segment merges, see
:class:`~pathway_tpu_torch.stdlib.indexing.segments.SegmentedIndex`).
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import numpy as np

from pathway_tpu_torch.internals import native as _native

__all__ = ["HnswIndex"]

_COMPACT_MIN_SLOTS = 64
_CHUNK = 4096


class HnswIndex:
    """(key, vector) ANN index with live add/remove."""

    # segment merges rebuild a fresh graph rather than editing in place
    merge_strategy = "rebuild"
    # concurrent search/search and search/add are safe: the native graph
    # serializes on its own mutex (GIL released), compact/load swap the
    # (handle, key map) pair atomically against the snapshot below, and
    # the slot decode tolerates concurrent remove()s — so SegmentedIndex
    # lets queries hit this main without serializing on _main_mutex
    concurrent_search = True

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "cos",
        M: int = 16,
        ef_construction: int = 128,
        ef_search: int = 64,
        tombstone_fraction: float = 0.33,
    ):
        if metric not in ("cos", "dot", "l2sq"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dim
        self.metric = metric
        self.M = M
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.tombstone_fraction = tombstone_fraction
        self._slot_of: dict[Any, int] = {}
        self._key_of: dict[int, Any] = {}
        # host copy of every live vector (already ``_prep``-ed): feeds
        # the exact fallback, compaction rebuilds, and state_dict
        self._store: dict[Any, np.ndarray] = {}
        self._hw = 0  # native slot high-water mark (live + tombstoned)
        self.compactions = 0
        self._lock = threading.RLock()
        native = _native.load()
        if native is not None and hasattr(native, "hnsw_new"):
            self._native = native
            self._h = native.hnsw_new(
                dim, M, ef_construction, 1 if metric == "l2sq" else 0
            )
        else:  # exact fallback: same results, no graph
            self._native = None

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Any) -> bool:
        return key in self._store

    def keys(self) -> list:
        return list(self._store)

    def _prep(self, vecs: np.ndarray) -> np.ndarray:
        vecs = np.ascontiguousarray(vecs, np.float32)
        if self.metric == "cos":
            norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
            vecs = vecs / np.maximum(norms, 1e-12)
        return vecs

    def add(self, items: Sequence[tuple[Any, Any]]) -> None:
        if not items:
            return
        # upsert semantics: last occurrence of a key wins — dedup WITHIN
        # the batch too, or the earlier duplicate's slot would stay alive
        # (and keep surfacing in results) with no key mapping back to it
        last: dict[Any, Any] = {}
        for k, v in items:
            last[k] = v
        items = list(last.items())
        keys = [k for k, _ in items]
        mat = self._prep(np.stack([np.asarray(v, np.float32) for _, v in items]))
        with self._lock:
            # re-adding a key replaces its vector
            stale = [k for k in keys if k in self._slot_of]
            if stale:
                self.remove(stale)
            self._insert_prepped(keys, mat)

    def _insert_prepped(self, keys: list, mat: np.ndarray) -> None:
        for key, row in zip(keys, mat):
            self._store[key] = row
        if self._native is None:
            return
        slots = self._native.hnsw_add(self._h, mat)
        for key, slot in zip(keys, slots):
            self._slot_of[key] = slot
            self._key_of[slot] = key
            if slot >= self._hw:
                self._hw = slot + 1

    def remove(self, keys: Sequence[Any]) -> None:
        """Remove keys; absent keys are a no-op (churn replay sends
        deletes for rows that never made the checkpoint)."""
        with self._lock:
            if self._native is None:
                for k in keys:
                    self._store.pop(k, None)
                return
            slots = []
            for k in keys:
                s = self._slot_of.pop(k, None)
                if s is not None:
                    self._key_of.pop(s, None)
                    self._store.pop(k, None)
                    slots.append(s)
            if slots:
                self._native.hnsw_remove(self._h, slots)
            dead = self._hw - len(self._slot_of)
            if (
                self._hw >= _COMPACT_MIN_SLOTS
                and dead > self.tombstone_fraction * self._hw
            ):
                self.compact()

    def compact(self) -> None:
        """Rebuild the native graph from live vectors, reclaiming
        tombstoned slots (satellite: unbounded tombstone growth)."""
        if self._native is None:
            return
        with self._lock:
            keys = list(self._store.keys())
            h = self._native.hnsw_new(
                self.dim, self.M, self.ef_construction,
                1 if self.metric == "l2sq" else 0,
            )
            slot_of: dict[Any, int] = {}
            key_of: dict[int, Any] = {}
            hw = 0
            for i in range(0, len(keys), _CHUNK):
                chunk = keys[i : i + _CHUNK]
                mat = np.stack([self._store[k] for k in chunk])
                slots = self._native.hnsw_add(h, np.ascontiguousarray(mat))
                for key, slot in zip(chunk, slots):
                    slot_of[key] = slot
                    key_of[slot] = key
                    if slot >= hw:
                        hw = slot + 1
            # atomic swap: a concurrent search snapshots the old pair
            self._h, self._slot_of, self._key_of, self._hw = (
                h, slot_of, key_of, hw,
            )
            self.compactions += 1

    def search(
        self, queries: np.ndarray, k: int
    ) -> list[list[tuple[Any, float]]]:
        """Top-k per query as [(key, score), ...], score higher = closer."""
        queries = self._prep(np.atleast_2d(np.asarray(queries, np.float32)))
        n = len(self)
        if n == 0:
            return [[] for _ in range(queries.shape[0])]
        k = min(k, n)
        if self._native is None:
            return self._search_exact(queries, k)
        with self._lock:  # consistent (handle, key map) pair vs compact()
            h, key_of = self._h, self._key_of
        ef = max(self.ef_search, k)
        raw = self._native.hnsw_search(h, queries, k, ef)
        # adaptive retry: heavy tombstone churn can starve survivors
        while any(len(ids) < k for ids, _ in raw) and ef < 4 * n:
            ef *= 4
            raw = self._native.hnsw_search(h, queries, k, ef)
        out: list[list[tuple[Any, float]]] = []
        for ids, dists in raw:
            # native distance is -dot (ip) or l2sq; both negate into the
            # higher-is-closer score convention.  remove() pops entries
            # from the shared key map in place, so decode with .get: a
            # slot deleted mid-search drops out instead of raising.
            row: list[tuple[Any, float]] = []
            for s, d in zip(ids, dists):
                key = key_of.get(s)
                if key is not None:
                    row.append((key, -d))
            out.append(row)
        return out

    def _search_exact(self, q: np.ndarray, k: int) -> list[list[tuple[Any, float]]]:
        with self._lock:  # consistent snapshot vs concurrent add/remove
            keys = list(self._store.keys())
            if not keys:
                return [[] for _ in range(q.shape[0])]
            mat = np.stack([self._store[key] for key in keys])
        if self.metric == "l2sq":
            scores = -(
                ((q[:, None, :] - mat[None, :, :]) ** 2).sum(-1)
            )
        else:
            scores = q @ mat.T
        out = []
        for row in scores:
            top = np.argsort(-row)[:k]
            out.append([(keys[i], float(row[i])) for i in top])
        return out

    # ------------------------------------------------- segments / persistence

    def fresh(self) -> "HnswIndex":
        """Empty index with the same hyperparameters (merge rebuilds)."""
        return HnswIndex(
            self.dim,
            metric=self.metric,
            M=self.M,
            ef_construction=self.ef_construction,
            ef_search=self.ef_search,
            tombstone_fraction=self.tombstone_fraction,
        )

    def export(self) -> tuple[list, np.ndarray]:
        """(keys, matrix) of live vectors, already normalized."""
        with self._lock:
            keys = list(self._store.keys())
            mat = (
                np.stack([self._store[k] for k in keys])
                if keys
                else np.zeros((0, self.dim), np.float32)
            )
        return keys, mat

    def stats(self) -> dict:
        slots = self._hw if self._native is not None else len(self._store)
        return {
            "size": len(self._store),
            "slots": slots,
            "tombstones": max(0, slots - len(self._store)),
            "compactions": self.compactions,
        }

    def state_dict(self) -> dict:
        """Host arrays only (picklable through the checkpoint writer);
        the graph itself is rebuilt on load — insertion is the cost of
        restore, but no native memory layout leaks into snapshots."""
        keys, mat = self.export()
        return {
            "kind": "hnsw",
            "dim": self.dim,
            "metric": self.metric,
            "M": self.M,
            "ef_construction": self.ef_construction,
            "ef_search": self.ef_search,
            "keys": keys,
            "vectors": mat,
        }

    def load_state_dict(self, state: dict) -> None:
        if state.get("dim", self.dim) != self.dim or state.get(
            "metric", self.metric
        ) != self.metric:
            raise ValueError("state_dict does not match index configuration")
        keys = list(state["keys"])
        mat = np.ascontiguousarray(np.asarray(state["vectors"], np.float32))
        with self._lock:
            self._store = {}
            self._slot_of = {}
            self._key_of = {}
            self._hw = 0
            if self._native is not None:
                self._h = self._native.hnsw_new(
                    self.dim, self.M, self.ef_construction,
                    1 if self.metric == "l2sq" else 0,
                )
            for i in range(0, len(keys), _CHUNK):
                self._insert_prepped(
                    keys[i : i + _CHUNK],
                    np.ascontiguousarray(mat[i : i + _CHUNK]),
                )
