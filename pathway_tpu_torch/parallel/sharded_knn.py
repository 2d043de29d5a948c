"""Device-resident brute-force KNN index (counterpart of
``pathway_tpu/parallel/sharded_knn.py``), on one card or sharded over a
mesh.

The corpus lives on the card as a fixed-capacity slab ``[capacity, dim]``
(f32 or bf16) plus a ``valid`` flag per slot:

- slots are assigned on the host (free list + cursor); upserts scatter
  the rows into their slots in place through kernel K2
  (``kernels/slab_scatter.py``), or, for an encoder's last hidden state
  on a one-shard index on its device, through the ingest tail, which
  pools and scatters in one launch (``add_pooled_device``); the pad rows of an
  encoder's output are sent to an out-of-range slot, which the kernel
  drops;
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

With ``mesh=`` (a :class:`~pathway_tpu_torch.parallel.mesh.Mesh`) the slab
is split row-wise over the devices along ``data_axis``, as the JAX
index shards it (``P(data_axis, None)``): shard s holds global slots
``[s * shard_rows, (s + 1) * shard_rows)`` and their flags on its
device, and the capacity is a multiple of ``shards * 128``.  Slots stay
global on the host; every update runs K2 on each shard it touches, with
local slots.  A search is the JAX mesh program (B12,
``sharded_knn.py:345-376``) driven from this one process: each shard
normalizes the queries and runs K3 over its rows with its first slot as
the offset, at ``kk = min(k, shard_rows)``; the ``[nq, kk]`` lists are
copied to the mesh's first device (the ``all_gather``: a copy between
cards where the devices differ), concatenated in shard order and
reduced to k by K3's merge passes, or K13 above ``MAX_K``.  A grow
changes ``shard_rows``, so rows move between shards: they are copied
device to device, where the JAX index round-trips the slab through the
host.  ``state_dict`` holds the global arrays, as the JAX one does, so
states cross between sharded and unsharded indexes of both packages.
A ``"model"`` axis replicates the slab over the model shards, as the JAX
index's ``P(data_axis, None)`` does; any other axis besides ``data_axis``
larger than 1 raises.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import finish_readback, resolve_device, start_readback, upload
from pathway_tpu_torch.internals import device_counters as _devctr
from pathway_tpu_torch.kernels.knn_topk import knn_topk, merge_partials
from pathway_tpu_torch.kernels._pitch import pitched_zeros
from pathway_tpu_torch.kernels.pool_normalize import pool_normalize, pool_normalize_into
from pathway_tpu_torch.kernels.slab_scatter import INGEST_EPS, slab_clear, slab_scatter
from pathway_tpu_torch.ops.bucketing import bucket_size, pad_rows
from pathway_tpu_torch.ops.distances import normalize
from pathway_tpu_torch.ops.topk import NEG_INF
from pathway_tpu_torch.parallel.mesh import Mesh, data_devices

__all__ = ["ShardedKnnIndex"]

_MIN_SHARD_ROWS = 128  # capacity is a multiple of shards * this


class ShardedKnnIndex:
    """Incremental vector index with add/remove/search.

    metric: "cos" (cosine over L2-normalized vectors), "dot", or "l2sq".
    Keys are arbitrary hashable host objects; the device only sees slots.
    With ``mesh`` the slab is sharded over the mesh's ``data_axis`` and
    ``device`` is not read: the mesh names the devices.
    """

    # segment merges mutate the slab in place (remove+upsert scatters)
    merge_strategy = "inplace"

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "cos",
        capacity: int = 1024,
        mesh: Mesh | None = None,
        data_axis: str = "data",
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cos", "dot", "l2sq"):
            raise ValueError(f"unknown metric {metric!r}")
        if mesh is None:
            self._devices = [resolve_device(device)]
        else:
            if data_axis not in mesh.shape:
                raise ValueError(f"mesh {mesh.shape} has no {data_axis!r} axis to shard over")
            self._devices = data_devices(mesh, data_axis, "ShardedKnnIndex")
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = self._devices[0]
        self.shards = len(self._devices)
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.capacity = self._round_capacity(capacity)
        self._vecs, self._flags = self._zeros(self.capacity)

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
    def _round_capacity(self, cap: int) -> int:
        unit = self.shards * _MIN_SHARD_ROWS
        return max(unit, ((cap + unit - 1) // unit) * unit)

    @property
    def shard_rows(self) -> int:
        return self.capacity // self.shards

    def _zeros(self, capacity: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Zeroed per-shard slabs and flags for ``capacity`` slots; a slab's
        rows lie 16 bytes apart whatever ``dim`` (``kernels/_pitch.py``)."""
        rows = capacity // self.shards
        vecs = [pitched_zeros((rows, self.dim), self.dtype, d) for d in self._devices]
        flags = [torch.zeros((rows,), dtype=torch.float32, device=d) for d in self._devices]
        return vecs, flags

    @property
    def _vectors(self) -> torch.Tensor:
        """The whole slab ``[capacity, dim]`` (sharded: a copy on the first
        device, for inspection)."""
        if self.shards == 1:
            return self._vecs[0]
        return torch.cat([v.to(self.device) for v in self._vecs])

    @property
    def _valid(self) -> torch.Tensor:
        """The whole ``[capacity]`` flag vector (sharded: a copy)."""
        if self.shards == 1:
            return self._flags[0]
        return torch.cat([f.to(self.device) for f in self._flags])

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

    def _upload(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        _devctr.record_h2d(arr.nbytes)
        return upload(arr, device)

    def _local(self, slots: np.ndarray, shard: int) -> np.ndarray:
        """``slots`` (global) as shard ``shard``'s local slots; every slot
        of another shard (and a pad) becomes ``shard_rows``, which K2
        drops."""
        rows = self.shard_rows
        lo = shard * rows
        inside = (slots >= lo) & (slots < lo + rows)
        return np.where(inside, slots - lo, rows).astype(np.int32)

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
        JAX index does; the cast to the slab type happens in the scatter.
        Each shard is sent only its own rows."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"vectors shape {vectors.shape} != (n, {self.dim})")
        n = len(keys)
        if n != vectors.shape[0]:
            raise ValueError(f"{n} keys vs {vectors.shape[0]} vectors")
        if n == 0:
            return
        slots = self._assign_slots(keys, pad_to=n)
        if self.metric == "cos":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            np.maximum(norms, INGEST_EPS, out=norms)
            vectors = vectors / norms
        shard_of = slots // self.shard_rows
        for s, dev in enumerate(self._devices):
            rows = np.nonzero(shard_of == s)[0]
            if len(rows):
                slab_scatter(
                    self._vecs[s], self._flags[s], self._upload(self._local(slots[rows], s), dev),
                    self._upload(vectors[rows], dev), normalize=False,
                )

    def add_batch_device(
        self, keys: Sequence[Any], vectors: torch.Tensor, n_valid: int | None = None
    ) -> None:
        """Upsert from a device tensor [b, dim] (an encoder's output)
        without reading the embeddings back to the host: slot assignment
        is the only host work; normalization (``cos``, eps 1e-30), cast and
        scatter run in one kernel.  Rows at index >= len(keys) (encoder
        padding) go to an out-of-range slot and are dropped.  A shard on
        the tensor's own device takes every row with its foreign slots out
        of range; a shard elsewhere is sent only its own rows."""
        n = len(keys) if n_valid is None else n_valid
        b = int(vectors.shape[0])
        if int(vectors.shape[1]) != self.dim:
            raise ValueError(f"vectors dim {vectors.shape[1]} != {self.dim}")
        if n > b:
            raise ValueError(f"{n} keys but only {b} vector rows")
        slots = self._assign_slots(keys, pad_to=b)
        vectors = vectors.contiguous()
        shard_of = slots // self.shard_rows
        for s, dev in enumerate(self._devices):
            if dev == vectors.device:
                local, rows = self._local(slots, s), vectors
            else:
                sel = np.nonzero(shard_of == s)[0]
                if not len(sel):
                    continue
                local = self._local(slots[sel], s)
                rows = vectors.index_select(0, self._upload(sel, vectors.device)).to(dev)  # pw-j002: card to card
            slab_scatter(
                self._vecs[s], self._flags[s], self._upload(local, dev), rows,
                normalize=self.metric == "cos",
            )

    def add_pooled_device(
        self, keys: Sequence[Any], hidden: torch.Tensor, mask: torch.Tensor, pool: str,
        normalize: bool, n_valid: int | None = None,
    ) -> None:
        """Upsert the pooled rows of an encoder's last hidden state
        ``hidden`` [b, L, dim] (``mask`` [b, L] uint8): pool (``"cls"`` or
        ``"mean"``), normalise when ``normalize`` (eps 1e-12), for ``cos``
        normalise again (eps 1e-30), cast and scatter; the same rows as
        ``add_batch_device`` of the encoder's pooled output.  One shard on
        ``hidden``'s device takes the ingest tail
        (``kernels.pool_normalize_into``: one launch, no f32 rows between
        the pooling and the scatter); otherwise K7 pools and
        ``add_batch_device`` scatters.  Slot assignment is the host's work,
        as there; rows at index >= len(keys) go to an out-of-range slot and
        are not read."""
        n = len(keys) if n_valid is None else n_valid
        b = int(hidden.shape[0])
        if int(hidden.shape[-1]) != self.dim:
            raise ValueError(f"hidden dim {hidden.shape[-1]} != {self.dim}")
        if n > b:
            raise ValueError(f"{n} keys but only {b} hidden rows")
        if self.shards != 1 or hidden.device != self.device:
            self.add_batch_device(keys, pool_normalize(hidden, mask, pool, normalize), n_valid=n)
            return
        slots = self._assign_slots(keys, pad_to=b)
        pool_normalize_into(
            self._vecs[0], self._flags[0], self._upload(slots, self.device), hidden, mask, pool, normalize,
            self.metric == "cos",
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
        arr = np.asarray(slots, np.int32)
        shard_of = arr // self.shard_rows
        for s, dev in enumerate(self._devices):
            sel = np.nonzero(shard_of == s)[0]
            if len(sel):
                slab_clear(self._flags[s], self._upload(self._local(arr[sel], s), dev))

    def _grow(self) -> None:
        """2x capacity realloc, copied device to device (rare and
        amortized).  Sharded, ``shard_rows`` doubles, so each old shard's
        rows land in the new shards that cover their global slots.
        Searches already enqueued read the old buffers, which the caching
        allocator keeps until the stream has passed them."""
        new_cap = self._round_capacity(self.capacity * 2)
        old, new = self.shard_rows, new_cap // self.shards
        vecs, flags = self._zeros(new_cap)
        for s in range(self.shards):
            lo = s * old
            for t in range(lo // new, min(self.shards, -(-(lo + old) // new))):
                a, b = max(lo, t * new), min(lo + old, (t + 1) * new)
                vecs[t][a - t * new : b - t * new].copy_(self._vecs[s][a - lo : b - lo])
                flags[t][a - t * new : b - t * new].copy_(self._flags[s][a - lo : b - lo])
        self.capacity = new_cap
        self._version += 1
        self._vecs, self._flags = vecs, flags

    # ------------------------------------------------------------------
    # search

    def _search(self, q: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(values, global slots)`` for the uploaded queries ``q``
        (on the first device, not yet normalized)."""
        metric = "l2sq" if self.metric == "l2sq" else "dot"
        rows = self.shard_rows
        kk = min(k, rows)
        on_device: dict[torch.device, torch.Tensor] = {}
        vals, ids = [], []
        for s, dev in enumerate(self._devices):
            qs = on_device.get(dev)
            if qs is None:
                qs = q.to(dev)  # pw-j002: card to card, once per shard's card
                qs = on_device[dev] = normalize(qs) if self.metric == "cos" else qs
            v, i = knn_topk(qs, self._vecs[s], self._flags[s], kk, metric, offset=s * rows)
            vals.append(v.to(self.device))
            ids.append(i.to(self.device))
        if self.shards == 1:
            return vals[0], ids[0]
        return merge_partials(torch.cat(vals, 1), torch.cat(ids, 1), k, presorted=False)

    def dispatch(self, queries: np.ndarray, k: int):
        """Enqueue a search and start its readback; returns an opaque
        handle for :meth:`collect`.  Several handles may be in flight."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        nq = queries.shape[0]
        if nq == 0 or not self._slot_of:
            return (None, nq, k, self._version)
        k_eff = min(k, self.capacity)
        qb = pad_rows(queries, bucket_size(nq, min_bucket=1))
        vals, idx = self._search(self._upload(qb, self.device), k_eff)
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
    # persistence support (same format as the JAX index: the global
    # arrays, sharded or not; a bf16 slab is written out as f32).  The
    # arrays are copies, as the JAX index's are, on the CPU too.

    def state_dict(self) -> dict:
        return {
            "dim": self.dim,
            "metric": self.metric,
            "capacity": self.capacity,
            "vectors": np.concatenate([v.to("cpu", copy=True).float().numpy() for v in self._vecs]),
            "valid": np.concatenate([f.to("cpu", copy=True).numpy() for f in self._flags]),
            "slot_of": dict(self._slot_of),
            "cursor": self._cursor,
            "free": list(self._free) + list(self._quarantine),
        }

    def load_state_dict(self, state: dict) -> None:
        self.capacity = self._round_capacity(state["capacity"])
        vectors = np.array(state["vectors"], np.float32)
        valid = np.array(state["valid"], np.float32)
        vecs, flags = self._zeros(self.capacity)
        rows = self.shard_rows
        for s in range(self.shards):
            lo = s * rows
            hi = min(lo + rows, vectors.shape[0])
            if hi > lo:
                vecs[s][: hi - lo] = torch.from_numpy(vectors[lo:hi]).to(vecs[s].device, self.dtype)
            hi = min(lo + rows, valid.shape[0])
            if hi > lo:
                flags[s][: hi - lo] = torch.from_numpy(valid[lo:hi]).to(flags[s].device)
        self._vecs, self._flags = vecs, flags
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
