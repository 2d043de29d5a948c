"""IVF-flat approximate KNN index on one card (counterpart of
``pathway_tpu/parallel/ivf_knn.py``).

An inverted-file index, the JAX package's approximate index behind
``UsearchKnn(nlist=, nprobe=)``:

- ``nlist`` k-means centroids live on the card; a few Lloyd iterations
  on a host sample train them, with each step's assignment on the card
  (kernel K11, ``kernels/ivf_assign.py``, the ``0.5 ||c||^2`` score) and
  the centroid update in numpy, as the JAX index draws and averages;
- rows are stored grouped by cell in a ``[nlist, cell_cap, d]`` slab with
  a ``[nlist, cell_cap]`` valid flag per slot; per-cell free lists and
  cursors are host-side.  A row's cell is its best centroid by inner
  product (K11); rows and flags are written by the slab scatter/clear
  (K2, ``kernels/slab_scatter.py``) on the flat views ``[nlist *
  cell_cap, d]`` and ``[nlist * cell_cap]``, each ``(cell, slot)`` pair
  mapped to ``cell * cell_cap + slot`` on the host and every pair out of
  range to -1, which K2 drops as ``mode="drop"`` does;
- a query batch is probed against the centroids in f32 (K3,
  ``kernels/knn_topk.py``, with k = ``nprobe``), then K12
  (``kernels/ivf_scan.py``) scores the valid rows of the probed cells and
  K3's merge passes reduce them to k, without the JAX program's
  ``[query_block, nprobe, cell_cap, d]`` gather; an ``nprobe`` or a k
  above K3's ``MAX_K`` (128) is selected by K13 instead
  (``kernels/topk_select.py``);
- a cell overflow doubles ``cell_cap`` for every cell, copied on the
  card.

The JAX index pads each update batch to a power-of-two bucket so that a
few compiled programs serve every size; PyTorch runs eagerly, so the
port sends the rows as they are.  ``query_block`` only sizes the plain
scan's gather on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import finish_readback, resolve_device, start_readback, upload
from pathway_tpu_torch.internals import device_counters as _devctr
from pathway_tpu_torch.kernels._pitch import flat_rows, pitched, pitched_zeros
from pathway_tpu_torch.kernels.ivf_assign import ivf_assign
from pathway_tpu_torch.kernels.ivf_scan import ivf_scan
from pathway_tpu_torch.kernels.knn_topk import knn_topk
from pathway_tpu_torch.kernels.slab_scatter import INGEST_EPS, slab_clear, slab_scatter
from pathway_tpu_torch.ops.bucketing import bucket_size
from pathway_tpu_torch.ops.topk import NEG_INF

__all__ = ["IvfKnnIndex"]

#: cell types a state may name (the JAX package's bf16 state holds an
#: ``ml_dtypes`` array, whose numpy dtype is named "bfloat16")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _kmeans(
    data: np.ndarray, nlist: int, assign: Callable[[np.ndarray], np.ndarray],
    iters: int = 8, seed: int = 0,
) -> np.ndarray:
    """A few Lloyd iterations over ``data`` [n, d] f32; ``assign(cents)``
    gives each row's nearest centroid (K11 with the ``0.5 ||c||^2`` term).
    The random draws, their order and the update are the JAX package's,
    in numpy, so both give the same centroids from the same data."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    cents = data[rng.choice(n, size=min(nlist, n), replace=False)].copy()
    if cents.shape[0] < nlist:  # degenerate: fewer points than cells
        cents = np.concatenate(
            [cents, rng.normal(size=(nlist - cents.shape[0], data.shape[1]))]
        ).astype(np.float32)
    for _ in range(iters):
        a = assign(cents)
        for ci in range(nlist):
            members = data[a == ci]
            if len(members):
                cents[ci] = members.mean(axis=0)
            else:  # dead cell: re-seed on a random point
                cents[ci] = data[rng.integers(n)]
    return cents.astype(np.float32)


class IvfKnnIndex:
    """Incremental IVF-flat index with add/remove/search.

    metric: "cos" (vectors L2-normalized at add time) or "dot".
    Keys are arbitrary hashable host objects; the card sees (cell, slot).
    """

    # segment merges mutate the cell slabs in place (remove+upsert)
    merge_strategy = "inplace"

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "cos",
        capacity: int = 1024,
        nlist: int | None = None,
        nprobe: int | None = None,
        train_size: int = 50_000,
        query_block: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cos", "dot"):
            raise ValueError(f"unsupported IVF metric {metric!r}")
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.seed = seed
        self.train_size = train_size
        self.query_block = query_block
        self.nlist = nlist or max(16, 1 << int(np.log2(max(capacity, 2) ** 0.5)))
        self.nprobe = nprobe or max(1, self.nlist // 8)
        self.cell_cap = max(64, bucket_size(4 * max(1, capacity // self.nlist)))

        self._centroids: torch.Tensor | None = None  # [nlist, d] f32
        # rows 16 bytes apart whatever dim (kernels/_pitch.py); so are the centroids'
        self._cells = pitched_zeros((self.nlist, self.cell_cap, dim), dtype, self.device)
        self._valid = torch.zeros((self.nlist, self.cell_cap), dtype=torch.float32, device=self.device)
        # host bookkeeping
        self._slot_of: dict[Any, tuple[int, int]] = {}  # key -> (cell, slot)
        self._key_of: dict[tuple[int, int], Any] = {}
        self._free: list[list[int]] = [[] for _ in range(self.nlist)]
        self._cursor = np.zeros(self.nlist, np.int64)  # next fresh slot per cell
        self._pending: list[tuple[Any, np.ndarray]] = []  # rows awaiting training

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._slot_of) + len(self._pending)

    def __contains__(self, key: Any) -> bool:
        return key in self._slot_of or any(k == key for k, _v in self._pending)

    def keys(self) -> list:
        seen = list(self._slot_of)
        seen.extend(k for k, _v in self._pending if k not in self._slot_of)
        return seen

    @property
    def trained(self) -> bool:
        return self._centroids is not None

    def _normalize(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.ascontiguousarray(vectors, np.float32)
        if self.metric == "cos":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            np.maximum(norms, INGEST_EPS, out=norms)
            vectors = vectors / norms
        return vectors

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        _devctr.record_h2d(arr.nbytes)
        return upload(arr, self.device)

    def train(self, sample: np.ndarray | None = None) -> None:
        """Fit centroids; flushes any rows buffered before training.

        Re-training a populated index re-inserts every stored vector (read
        back from the cells), so cell placement always matches the
        centroids used for probing."""
        if sample is None:
            if not self._pending:
                raise ValueError("nothing to train on")
            sample = np.stack([v for _k, v in self._pending])
        sample = self._normalize(sample)
        if sample.shape[0] > self.train_size:
            rng = np.random.default_rng(self.seed)
            sample = sample[rng.choice(sample.shape[0], size=self.train_size, replace=False)]
        stored: list[tuple[Any, np.ndarray]] = []
        if self._slot_of:
            cs, ss = (torch.tensor(a, device=self.device) for a in zip(*self._slot_of.values()))
            rows = self._cells[cs, ss].cpu().float().numpy()
            stored = list(zip(self._slot_of, rows))
            self._cells = pitched_zeros(tuple(self._cells.shape), self._cells.dtype, self.device)
            self._valid = torch.zeros_like(self._valid)
            self._slot_of.clear()
            self._key_of.clear()
            self._free = [[] for _ in range(self.nlist)]
            self._cursor[:] = 0
        x = self._upload(sample)

        def assign(cents: np.ndarray) -> np.ndarray:
            return ivf_assign(x, self._upload(cents), half_norm=True).cpu().numpy()

        self._centroids = pitched(self._upload(_kmeans(sample, self.nlist, assign, seed=self.seed)))
        pending, self._pending = self._pending, []
        for keys_vecs in (stored, pending):
            if keys_vecs:
                self.add_batch([k for k, _ in keys_vecs], np.stack([v for _, v in keys_vecs]))

    # ------------------------------------------------------------------
    def _flat_slots(self, cells: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """``cell * cell_cap + slot`` per pair as int32, -1 for a pair out of
        range (the JAX pads ``(nlist, cell_cap)`` among them), which K2
        drops."""
        cells = np.asarray(cells, np.int64)
        slots = np.asarray(slots, np.int64)
        keep = (cells >= 0) & (cells < self.nlist) & (slots >= 0) & (slots < self.cell_cap)
        return np.where(keep, cells * self.cell_cap + slots, -1).astype(np.int32)

    def add(self, items: Sequence[tuple[Any, np.ndarray]]) -> None:
        if not items:
            return
        keys = [k for k, _v in items]
        vecs = np.stack([np.asarray(v, np.float32).reshape(-1) for _k, v in items])
        self.add_batch(keys, vecs)

    def add_batch(self, keys: Sequence[Any], vectors: np.ndarray) -> None:
        vectors = self._normalize(vectors)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"vectors shape {vectors.shape} != (n, {self.dim})")
        keys = list(keys)
        if len(keys) != vectors.shape[0]:
            raise ValueError(f"{len(keys)} keys vs {vectors.shape[0]} vectors")
        # duplicate keys within one batch: keep the LAST occurrence only
        # (upsert semantics), or two live slots would map to one key
        last = {key: i for i, key in enumerate(keys)}
        if len(last) != len(keys):
            sel = sorted(last.values())
            keys = [keys[i] for i in sel]
            vectors = vectors[sel]
        if self._centroids is None:
            # buffer until trained; auto-train once the buffer is useful
            self._pending.extend(zip(keys, vectors))
            if len(self._pending) >= max(self.nlist * 8, 1024):
                self.train()
            return
        if not keys:
            return
        # upserts: drop existing placements first (the cell may change)
        existing = [k for k in keys if k in self._slot_of]
        if existing:
            self.remove(existing)
        rows = self._upload(vectors)
        cells = ivf_assign(rows, self._centroids, half_norm=False).cpu().numpy()
        if self._cells.dtype != self.dtype:  # cells loaded from a state of another type
            rows = rows.to(self.dtype)  # the JAX index rounds the rows to its own type first
        # overflow check (host counts; a grow doubles cell_cap for all cells)
        counts = np.bincount(cells, minlength=self.nlist)
        for ci in np.nonzero(counts)[0]:
            while self._cursor[ci] - len(self._free[ci]) + counts[ci] > self.cell_cap:
                self._grow()
        slots = np.empty(len(keys), np.int64)
        for i, (key, ci) in enumerate(zip(keys, cells)):
            ci = int(ci)
            free = self._free[ci]
            slot = free.pop() if free else int(self._cursor[ci])
            if slot == self._cursor[ci]:
                self._cursor[ci] += 1
            slots[i] = slot
            self._slot_of[key] = (ci, slot)
            self._key_of[(ci, slot)] = key
        flat = self._upload(self._flat_slots(cells, slots))
        slab_scatter(flat_rows(self._cells), self._valid.view(-1), flat, rows, normalize=False)

    def remove(self, keys: Sequence[Any]) -> None:
        cs, ss = [], []
        for key in keys:
            place = self._slot_of.pop(key, None)
            if place is None:
                # may still be sitting in the pre-training buffer
                self._pending = [(k, v) for k, v in self._pending if k != key]
                continue
            ci, slot = place
            self._key_of.pop(place, None)
            self._free[ci].append(slot)
            cs.append(ci)
            ss.append(slot)
        if cs:
            slab_clear(self._valid.view(-1), self._upload(self._flat_slots(cs, ss)))

    def _grow(self) -> None:
        """Double cell_cap, copying the cells on the card (rare and
        amortized); the new cells are of the index's type, as the JAX
        index's are."""
        new_cap = self.cell_cap * 2
        cells = pitched_zeros((self.nlist, new_cap, self.dim), self.dtype, self.device)
        valid = torch.zeros((self.nlist, new_cap), dtype=torch.float32, device=self.device)
        cells[:, : self.cell_cap] = self._cells
        valid[:, : self.cell_cap] = self._valid
        self.cell_cap = new_cap
        self._cells, self._valid = cells, valid

    # ------------------------------------------------------------------
    def search(
        self, queries: np.ndarray, k: int, *, nprobe: int | None = None
    ) -> list[list[tuple[Any, float]]]:
        """Top-k per query: [[(key, score), ...], ...] (higher = closer)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        nq = queries.shape[0]
        if nq == 0:
            return []
        if self._centroids is None:
            if self._pending:
                self.train()
            else:
                return [[] for _ in range(nq)]
        if self.metric == "cos":
            queries = self._normalize(queries)
        nprobe = min(nprobe or self.nprobe, self.nlist)
        k_eff = min(k, nprobe * self.cell_cap)
        if k_eff < 1:
            return [[] for _ in range(nq)]
        q = self._upload(queries)
        ones = torch.ones((self.nlist,), dtype=torch.float32, device=self.device)
        probe = knn_topk(q, self._centroids, ones, nprobe, "dot")[1]
        vals, ids = finish_readback(start_readback(
            *ivf_scan(q, probe, self._cells, self._valid, k_eff, self.query_block)
        ))
        _devctr.record_d2h(vals.nbytes + ids.nbytes)
        rows: list[list[tuple[Any, float]]] = []
        for qi in range(nq):
            row = []
            for flat, score in zip(ids[qi], vals[qi]):
                if score <= NEG_INF / 2:
                    continue
                key = self._key_of.get(divmod(int(flat), self.cell_cap))
                if key is not None:
                    row.append((key, float(score)))
            rows.append(row[:k])
        return rows

    # ------------------------------------------------------------------
    # persistence: the JAX index's fields, the cells written as f32 (a
    # numpy-only reader cannot open a bf16 array) and their type by name.
    # The arrays are copies, as the JAX index's are, on the CPU too.

    def state_dict(self) -> dict:
        def host(t: torch.Tensor) -> np.ndarray:
            return t.to("cpu", copy=True).float().numpy()

        return {
            "dim": self.dim,
            "metric": self.metric,
            "nlist": self.nlist,
            "cell_cap": self.cell_cap,
            "centroids": None if self._centroids is None else host(self._centroids),
            "cells": host(self._cells),
            "valid": host(self._valid),
            "dtype": str(self._cells.dtype).removeprefix("torch."),
            "slot_of": dict(self._slot_of),
            "cursor": self._cursor.copy(),
            "free": [list(f) for f in self._free],
            "pending": [(k, np.asarray(v)) for k, v in self._pending],
        }

    def load_state_dict(self, state: dict) -> None:
        """Load a state of this index or of the JAX one.  As in the JAX
        index, the cells keep the state's type (its ``dtype`` entry, else
        its array's) and ``dtype`` stays the index's own."""
        cells = np.asarray(state["cells"])
        name = state.get("dtype", cells.dtype.name)
        if name not in _DTYPES:
            raise ValueError(f"IVF cells of type {name!r}: the port keeps {sorted(_DTYPES)}")
        self.nlist = state["nlist"]
        self.cell_cap = state["cell_cap"]
        cents = state["centroids"]
        self._centroids = None if cents is None else pitched(torch.from_numpy(
            np.array(cents, np.float32)).to(self.device))
        self._cells = pitched(torch.from_numpy(cells.astype(np.float32)).to(self.device, _DTYPES[name]))
        self._valid = torch.from_numpy(np.array(state["valid"], np.float32)).to(self.device)
        self._slot_of = dict(state["slot_of"])
        self._key_of = {p: k for k, p in self._slot_of.items()}
        self._cursor = np.asarray(state["cursor"]).copy()
        self._free = [list(f) for f in state["free"]]
        self._pending = [(k, np.asarray(v)) for k, v in state["pending"]]
