"""Device-resident brute-force KNN index (counterpart of
``pathway_tpu/parallel/sharded_knn.py``), single device.

The corpus lives on the card as a fixed-capacity slab ``[capacity, dim]``
(f32 or bf16) plus a ``valid`` flag per slot:

- slots are assigned on the host (free list + cursor); upserts scatter
  the rows into their slots in place through kernel K2
  (``kernels/slab_scatter.py``), with the update batch padded to a
  power-of-two bucket and pad rows sent to slot ``capacity``, which the
  kernel drops;
- capacity grows 2x when full, copying the slab on the device;
- a query batch is scored against the whole slab, masked and reduced to
  its top k by kernel K3 (``kernels/knn_topk.py``) without the
  ``[nq, capacity]`` score matrix ever reaching device memory.

The JAX index keeps two versions of every update: a donating one, and a
non-donating ``_safe`` twin used while a search is in flight, because a
donated buffer may be reused while an asynchronous search still reads
it.  Here every search and every update is enqueued on PyTorch's current
stream in program order, so a search dispatched before an update reads
the slab as it was at dispatch, and the update can always run in place:
one path.  What stream order cannot protect is the host's slot -> key
map, so a slot freed while a handle is in flight stays quarantined until
the handles are collected, as in the JAX index.

The sharded (mesh) search waits for the multi-GPU slice (ROADMAP A9).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import finish_readback, resolve_device, start_readback, upload
from pathway_tpu_torch.internals import device_counters as _devctr
from pathway_tpu_torch.kernels.knn_topk import knn_topk
from pathway_tpu_torch.kernels.slab_scatter import INGEST_EPS, slab_clear, slab_scatter
from pathway_tpu_torch.ops.bucketing import bucket_size, pad_rows
from pathway_tpu_torch.ops.distances import normalize
from pathway_tpu_torch.ops.topk import NEG_INF

__all__ = ["ShardedKnnIndex"]

_MIN_ROWS = 128  # capacity is a multiple of this


class ShardedKnnIndex:
    """Incremental vector index with add/remove/search.

    metric: "cos" (cosine over L2-normalized vectors), "dot", or "l2sq".
    Keys are arbitrary hashable host objects; the device only sees slots.
    """

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "cos",
        capacity: int = 1024,
        mesh: Any = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cos", "dot", "l2sq"):
            raise ValueError(f"unknown metric {metric!r}")
        if mesh is not None:
            raise NotImplementedError(
                "the sharded slab comes with the multi-GPU slice (ROADMAP A9)"
            )
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.capacity = self._round_capacity(capacity)
        self._vectors = torch.zeros((self.capacity, dim), dtype=dtype, device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)

        self._slot_of: dict[Any, int] = {}
        self._key_of: dict[int, Any] = {}
        self._free: list[int] = []
        self._cursor = 0  # next never-used slot
        # freed slots are quarantined while dispatch handles are in flight,
        # so collect() never resolves a reused slot to the wrong key
        self._inflight = 0
        self._quarantine: list[int] = []
        # buffer generation, bumped on every realloc (_grow and
        # load_state_dict); a handle from before the last load_state_dict
        # is rejected, because the slot -> key map was replaced wholesale
        self._version = 0
        self._reset_version = 0

    # ------------------------------------------------------------------
    @staticmethod
    def _round_capacity(cap: int) -> int:
        return max(_MIN_ROWS, ((cap + _MIN_ROWS - 1) // _MIN_ROWS) * _MIN_ROWS)

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, key: Any) -> bool:
        return key in self._slot_of

    @property
    def keys(self) -> list:
        return list(self._slot_of)

    # ------------------------------------------------------------------
    # updates

    def _assign_slots(self, keys: Sequence[Any], pad_to: int) -> np.ndarray:
        """Slot per key (allocating new slots as needed, growing the slab
        when full); rows beyond ``len(keys)`` pad with ``capacity`` so the
        scatter drops them.  The one copy of the free-list/cursor
        bookkeeping, shared by the host and device ingest paths."""
        slot_of = self._slot_of
        n_new = sum(1 for key in keys if key not in slot_of)
        while len(slot_of) + n_new > self.capacity:
            self._grow()
        slots = np.full(pad_to, self.capacity, np.int32)
        key_of = self._key_of
        free = self._free
        for i, key in enumerate(keys):
            slot = slot_of.get(key)
            if slot is None:
                slot = free.pop() if free else self._cursor
                if slot == self._cursor:
                    self._cursor += 1
                slot_of[key] = slot
                key_of[slot] = key
            slots[i] = slot
        return slots

    def _upload_slots(self, slots: np.ndarray) -> torch.Tensor:
        _devctr.record_h2d(slots.nbytes)
        return upload(slots, self.device)

    def add(self, items: Sequence[tuple[Any, np.ndarray]]) -> None:
        """Upsert (key, vector) pairs."""
        if not items:
            return
        keys = [key for key, _v in items]
        vecs = np.stack([np.asarray(v, np.float32).reshape(-1) for _k, v in items])
        self.add_batch(keys, vecs)

    def add_batch(self, keys: Sequence[Any], vectors: np.ndarray) -> None:
        """Columnar upsert: ``keys`` aligned with rows of ``vectors`` [n, dim].
        For ``cos`` the rows are normalized on the host (eps 1e-30), as the
        JAX index does; the cast to the slab type happens in the scatter."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"vectors shape {vectors.shape} != (n, {self.dim})")
        n = len(keys)
        if n != vectors.shape[0]:
            raise ValueError(f"{n} keys vs {vectors.shape[0]} vectors")
        if n == 0:
            return
        b = bucket_size(n)
        slots = self._assign_slots(keys, pad_to=b)
        if self.metric == "cos":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            np.maximum(norms, INGEST_EPS, out=norms)
            vectors = vectors / norms
        vals = pad_rows(vectors, b)
        _devctr.record_h2d(vals.nbytes)
        slab_scatter(
            self._vectors, self._valid, self._upload_slots(slots),
            upload(vals, self.device), normalize=False,
        )

    def add_batch_device(
        self, keys: Sequence[Any], vectors: torch.Tensor, n_valid: int | None = None
    ) -> None:
        """Upsert from a device tensor [b, dim] (an encoder's output)
        without reading the embeddings back to the host: slot assignment
        is the only host work; normalization (``cos``, eps 1e-30), cast and
        scatter run in one kernel.  Rows at index >= len(keys) (encoder
        padding) go to an out-of-range slot and are dropped."""
        n = len(keys) if n_valid is None else n_valid
        b = int(vectors.shape[0])
        if int(vectors.shape[1]) != self.dim:
            raise ValueError(f"vectors dim {vectors.shape[1]} != {self.dim}")
        if n > b:
            raise ValueError(f"{n} keys but only {b} vector rows")
        if vectors.device != self.device:
            raise ValueError(f"vectors on {vectors.device}, index on {self.device}")
        slots = self._assign_slots(keys, pad_to=b)
        slab_scatter(
            self._vectors, self._valid, self._upload_slots(slots),
            vectors.contiguous(), normalize=self.metric == "cos",
        )

    def remove(self, keys: Sequence[Any]) -> None:
        slots = []
        for key in keys:
            slot = self._slot_of.pop(key, None)
            if slot is not None:
                self._key_of.pop(slot, None)
                if self._inflight > 0:
                    self._quarantine.append(slot)
                else:
                    self._free.append(slot)
                slots.append(slot)
        if not slots:
            return
        arr = pad_rows(np.asarray(slots, np.int32), bucket_size(len(slots)), fill=self.capacity)
        slab_clear(self._valid, self._upload_slots(arr))

    def _grow(self) -> None:
        """2x capacity realloc, copied on the device (rare and amortized).
        Searches already enqueued read the old buffers, which the caching
        allocator keeps until the stream has passed them."""
        new_cap = self._round_capacity(self.capacity * 2)
        vec = torch.zeros((new_cap, self.dim), dtype=self.dtype, device=self.device)
        valid = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
        vec[: self.capacity] = self._vectors
        valid[: self.capacity] = self._valid
        self.capacity = new_cap
        self._version += 1
        self._vectors, self._valid = vec, valid

    # ------------------------------------------------------------------
    # search

    def dispatch(self, queries: np.ndarray, k: int):
        """Enqueue a search and start its readback; returns an opaque
        handle for :meth:`collect`.  Several handles may be in flight."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        nq = queries.shape[0]
        if nq == 0 or not self._slot_of:
            return (None, nq, k, self._version)
        k_eff = min(k, self.capacity)
        qb = pad_rows(queries, bucket_size(nq, min_bucket=1))
        _devctr.record_h2d(qb.nbytes)
        q = upload(qb, self.device)
        if self.metric == "cos":
            q = normalize(q)
        vals, idx = knn_topk(
            q, self._vectors, self._valid, k_eff, "l2sq" if self.metric == "l2sq" else "dot"
        )
        self._inflight += 1
        return (start_readback(vals, idx), nq, k, self._version)

    def collect(self, handle) -> list[list[tuple[Any, float]]]:
        """Resolve a :meth:`dispatch` handle to [[(key, score), ...], ...].

        Valid across a ``_grow`` (slot numbering is grow-stable and freed
        slots stay quarantined while any handle is outstanding); not valid
        across ``load_state_dict``, which replaces the slot -> key map, so
        a pre-restore handle raises."""
        out, nq, k, version = handle
        if out is None:
            return [[] for _ in range(nq)]
        if version < self._reset_version:
            raise RuntimeError(
                "stale dispatch handle: the index was restored via "
                "load_state_dict after this dispatch; slot numbering is "
                "only stable across capacity grows, not restores"
            )
        self._inflight = max(0, self._inflight - 1)
        if self._inflight == 0 and self._quarantine:
            self._free.extend(self._quarantine)
            self._quarantine.clear()
        vals, idx = finish_readback(out)
        _devctr.record_d2h(vals.nbytes + idx.nbytes)
        rows: list[list[tuple[Any, float]]] = []
        for qi in range(nq):
            row = []
            for slot, score in zip(idx[qi], vals[qi]):
                if score <= NEG_INF / 2:
                    continue
                key = self._key_of.get(int(slot))
                if key is not None:
                    row.append((key, float(score)))
            rows.append(row[:k])
        return rows

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[Any, float]]]:
        """Top-k per query: [[(key, score), ...], ...].  Scores: higher =
        closer for cos/dot; for l2sq the negated squared distance."""
        return self.collect(self.dispatch(queries, k))

    # ------------------------------------------------------------------
    # persistence support (same format as the JAX index; a bf16 slab is
    # written out as f32).  The arrays are copies, as the JAX index's are,
    # on the CPU too.

    def state_dict(self) -> dict:
        return {
            "dim": self.dim,
            "metric": self.metric,
            "capacity": self.capacity,
            "vectors": self._vectors.to("cpu", copy=True).float().numpy(),
            "valid": self._valid.to("cpu", copy=True).numpy(),
            "slot_of": dict(self._slot_of),
            "cursor": self._cursor,
            "free": list(self._free) + list(self._quarantine),
        }

    def load_state_dict(self, state: dict) -> None:
        self.capacity = self._round_capacity(state["capacity"])
        vectors = np.array(state["vectors"], np.float32)
        valid = np.array(state["valid"], np.float32)
        vec = torch.zeros((self.capacity, self.dim), dtype=self.dtype, device=self.device)
        val = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
        vec[: vectors.shape[0]] = torch.from_numpy(vectors).to(self.device, self.dtype)
        val[: valid.shape[0]] = torch.from_numpy(valid).to(self.device)
        self._vectors, self._valid = vec, val
        self._slot_of = dict(state["slot_of"])
        self._key_of = {s: k for k, s in self._slot_of.items()}
        self._cursor = state["cursor"]
        self._free = list(state["free"])
        # outstanding handles reference the pre-restore slot space:
        # invalidate them and reset the in-flight bookkeeping
        self._version += 1
        self._reset_version = self._version
        self._inflight = 0
        self._quarantine = []
