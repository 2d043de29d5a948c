"""Host adapters bridging engine index operators to concrete indexes
(counterpart of ``pathway_tpu/stdlib/indexing/adapters.py``).

Equivalent of the reference's ``ExternalIndex`` implementations
(``src/external_integration/*.rs``): the KNN adapter fronts the
card-resident :class:`~pathway_tpu_torch.parallel.ShardedKnnIndex` (its
upserts scatter through K2, its searches run K3), the IVF adapter the
card-resident :class:`~pathway_tpu_torch.parallel.IvfKnnIndex` (K11,
K12); BM25 is a host inverted index (the tantivy equivalent).  The
device adapters take ``device=`` (default ``"cuda"``, which raises on a
machine with no card) and pass it to their index.  Metadata filtering
(JMESPath-subset, see :mod:`.filters`) is applied host-side with
over-fetch, mirroring the reference's filter-then-trim flow
(``src/external_integration/mod.rs:92-181``).

Vectors reach the device index as host rows: ``add`` stacks ``np.float32``
rows from the payloads (an embedder UDF's host arrays) and the index
uploads them, as the JAX adapter does.
"""

from __future__ import annotations

import heapq
import math
from collections import defaultdict
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = [
    "KnnAdapter",
    "IvfAdapter",
    "HnswAdapter",
    "BM25Adapter",
    "HybridAdapter",
]

_OVERFETCH = 4


def _segmented(main, delta_cap, tombstone_fraction, auto_merge):
    from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex

    return SegmentedIndex(
        main,
        delta_cap=delta_cap,
        tombstone_fraction=tombstone_fraction,
        auto_merge=auto_merge,
    )


class KnnAdapter:
    """(key, vector) index over :class:`ShardedKnnIndex` + host metadata.

    The concrete index is fronted by a
    :class:`~pathway_tpu_torch.stdlib.indexing.segments.SegmentedIndex`: live
    upserts/deletes land in a delta segment + tombstone set and a
    background merge compacts them into the sealed main segment
    (``delta_cap``/``tombstone_fraction``/``auto_merge`` knobs, env
    defaults ``PATHWAY_INDEX_*``).  ``device`` places the slab (not read
    with ``mesh``)."""

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "cos",
        capacity: int = 1024,
        mesh: Any = None,
        dtype: Any = None,
        delta_cap: int | None = None,
        tombstone_fraction: float | None = None,
        auto_merge: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        from pathway_tpu_torch.parallel import ShardedKnnIndex

        self.index = _segmented(
            ShardedKnnIndex(
                dim,
                metric=metric,
                capacity=capacity,
                mesh=mesh,
                dtype=dtype or torch.float32,
                device=device,
            ),
            delta_cap,
            tombstone_fraction,
            auto_merge,
        )
        self.meta: dict[Any, dict | None] = {}

    def add(self, items: Sequence[tuple[Any, Any]]) -> None:
        prepared = []
        for key, payload in items:
            if isinstance(payload, tuple) and len(payload) == 2 and isinstance(payload[1], dict):
                vec, meta = payload
            else:
                vec, meta = payload, None
            self.meta[key] = meta
            prepared.append((key, np.asarray(vec, np.float32)))
        self.index.add(prepared)

    def remove(self, keys: Sequence[Any]) -> None:
        for k in keys:
            self.meta.pop(k, None)
        self.index.remove(keys)

    def set_meta(self, key: Any, meta: dict | None) -> None:
        self.meta[key] = meta

    def search(
        self,
        payloads: Sequence[Any],
        k: Sequence[int],
        filters: Sequence[Callable[[dict], bool] | None],
    ) -> list[list[tuple[Any, float]]]:
        if not payloads:
            return []
        kmax = max(list(k) + [0])
        if kmax == 0:
            return [[] for _ in payloads]
        fetch = kmax * (_OVERFETCH if any(f is not None for f in filters) else 1)
        fetch = min(max(fetch, kmax), max(len(self.index), 1))
        q = np.stack([np.asarray(p, np.float32).reshape(-1) for p in payloads])
        raw = self.index.search(q, fetch)
        out = []
        for qi, reply in enumerate(raw):
            f = filters[qi]
            if f is not None:
                reply = [(key, s) for key, s in reply if f(self.meta.get(key) or {})]
            out.append(reply[: k[qi]])
        return out

    # ------------------------------------------------- persistence / stats

    def state_dict(self) -> dict:
        return {"index": self.index.state_dict(), "meta": dict(self.meta)}

    def load_state_dict(self, state: dict) -> None:
        self.index.load_state_dict(state["index"])
        self.meta = dict(state["meta"])

    def stats(self) -> dict:
        s = getattr(self.index, "stats", None)
        return s() if s is not None else {"size": len(self.index)}


class HnswAdapter(KnnAdapter):
    """(key, vector) index over the host HNSW graph
    (:class:`~pathway_tpu_torch.stdlib.indexing.hnsw.HnswIndex`), the
    reference's usearch role (``usearch_integration.rs``).  Same contract
    and metadata-filter flow as :class:`KnnAdapter`.  The graph lives on
    the host in both packages, so ``device`` (with the other device-index
    arguments) is accepted and not read."""

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "cos",
        M: int = 16,
        ef_construction: int = 128,
        ef_search: int = 64,
        delta_cap: int | None = None,
        tombstone_fraction: float | None = None,
        auto_merge: bool | None = None,
        **_ignored: Any,
    ):
        from pathway_tpu_torch.stdlib.indexing.hnsw import HnswIndex

        self.index = _segmented(
            HnswIndex(
                dim,
                metric=metric,
                M=M,
                ef_construction=ef_construction,
                ef_search=ef_search,
            ),
            delta_cap,
            tombstone_fraction,
            auto_merge,
        )
        self.meta: dict[Any, dict | None] = {}


class BM25Adapter:
    """Incremental BM25 full-text index (tantivy-equivalent,
    ``src/external_integration/tantivy_integration.rs``)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75, tokenizer: Callable[[str], list[str]] | None = None):
        self.k1 = k1
        self.b = b
        self._tokenize = tokenizer or (lambda s: [t for t in _simple_tokens(s)])
        self.postings: dict[str, dict[Any, int]] = defaultdict(dict)
        self.doc_len: dict[Any, int] = {}
        self.doc_terms: dict[Any, list[str]] = {}
        self.meta: dict[Any, dict | None] = {}
        self.total_len = 0

    def add(self, items: Sequence[tuple[Any, Any]]) -> None:
        for key, payload in items:
            if isinstance(payload, tuple) and len(payload) == 2 and isinstance(payload[1], dict):
                text, meta = payload
            else:
                text, meta = payload, None
            if key in self.doc_len:
                self._remove_one(key)
            toks = self._tokenize(str(text))
            self.doc_terms[key] = toks
            self.doc_len[key] = len(toks)
            self.total_len += len(toks)
            self.meta[key] = meta
            for t in toks:
                self.postings[t][key] = self.postings[t].get(key, 0) + 1

    def _remove_one(self, key: Any) -> None:
        toks = self.doc_terms.pop(key, [])
        self.total_len -= self.doc_len.pop(key, 0)
        self.meta.pop(key, None)
        for t in set(toks):
            d = self.postings.get(t)
            if d is not None:
                d.pop(key, None)
                if not d:
                    del self.postings[t]

    def remove(self, keys: Sequence[Any]) -> None:
        for k in keys:
            self._remove_one(k)

    def set_meta(self, key: Any, meta: dict | None) -> None:
        self.meta[key] = meta

    def __len__(self) -> int:
        return len(self.doc_len)

    def state_dict(self) -> dict:
        return {
            "postings": {t: dict(d) for t, d in self.postings.items()},
            "doc_len": dict(self.doc_len),
            "doc_terms": dict(self.doc_terms),
            "meta": dict(self.meta),
            "total_len": self.total_len,
        }

    def load_state_dict(self, state: dict) -> None:
        self.postings = defaultdict(dict, {t: dict(d) for t, d in state["postings"].items()})
        self.doc_len = dict(state["doc_len"])
        self.doc_terms = dict(state["doc_terms"])
        self.meta = dict(state["meta"])
        self.total_len = state["total_len"]

    def stats(self) -> dict:
        return {"size": len(self.doc_len), "terms": len(self.postings)}

    def search(
        self,
        payloads: Sequence[Any],
        k: Sequence[int],
        filters: Sequence[Callable[[dict], bool] | None],
    ) -> list[list[tuple[Any, float]]]:
        n = len(self.doc_len)
        avgdl = (self.total_len / n) if n else 1.0
        out = []
        for qi, payload in enumerate(payloads):
            scores: dict[Any, float] = defaultdict(float)
            for term in self._tokenize(str(payload)):
                plist = self.postings.get(term)
                if not plist:
                    continue
                idf = math.log(1.0 + (n - len(plist) + 0.5) / (len(plist) + 0.5))
                for key, tf in plist.items():
                    dl = self.doc_len[key]
                    denom = tf + self.k1 * (1 - self.b + self.b * dl / avgdl)
                    scores[key] += idf * tf * (self.k1 + 1) / denom
            f = filters[qi]
            items: Any = scores.items()
            if f is not None:
                # filter BEFORE top-k selection so a restrictive filter
                # still yields k matching docs when they exist
                items = [
                    (key, s) for key, s in items if f(self.meta.get(key) or {})
                ]
            # heap selection instead of a full sort of every matching doc:
            # O(N log k); same ordering as sorted(..)[:k] incl. tie-break
            ranked = heapq.nsmallest(
                k[qi], items, key=lambda kv: (-kv[1], str(kv[0]))
            )
            out.append([(key, float(s)) for key, s in ranked])
        return out


class HybridAdapter:
    """Reciprocal-rank fusion over child adapters (reference
    ``HybridIndex``, ``stdlib/indexing/hybrid_index.py:14-147``).
    Payloads are tuples with one element per child."""

    def __init__(self, children: Sequence[Any], rrf_k: float = 60.0):
        self.children = list(children)
        self.rrf_k = rrf_k

    def add(self, items: Sequence[tuple[Any, Any]]) -> None:
        for ci, child in enumerate(self.children):
            child.add([(key, payload[ci]) for key, payload in items])

    def remove(self, keys: Sequence[Any]) -> None:
        for child in self.children:
            child.remove(keys)

    def set_meta(self, key: Any, meta: dict | None) -> None:
        for child in self.children:
            if hasattr(child, "set_meta"):
                child.set_meta(key, meta)

    def state_dict(self) -> dict:
        return {
            "children": [
                child.state_dict() if hasattr(child, "state_dict") else None
                for child in self.children
            ]
        }

    def load_state_dict(self, state: dict) -> None:
        for child, sub in zip(self.children, state["children"]):
            if sub is not None and hasattr(child, "load_state_dict"):
                child.load_state_dict(sub)

    def stats(self) -> dict:
        return {
            f"child{ci}": child.stats()
            for ci, child in enumerate(self.children)
            if hasattr(child, "stats")
        }

    def search(self, payloads, k, filters):
        per_child = []
        for ci, child in enumerate(self.children):
            child_payloads = [p[ci] for p in payloads]
            fetch = [kk * 2 for kk in k]
            per_child.append(child.search(child_payloads, fetch, filters))
        out = []
        for qi in range(len(payloads)):
            fused: dict[Any, float] = defaultdict(float)
            for replies in per_child:
                for rank, (key, _s) in enumerate(replies[qi]):
                    fused[key] += 1.0 / (self.rrf_k + rank + 1)
            ranked = sorted(fused.items(), key=lambda kv: (-kv[1], str(kv[0])))
            out.append([(key, float(s)) for key, s in ranked[: k[qi]]])
        return out


def _simple_tokens(s: str):
    import re

    return re.findall(r"[a-z0-9]+", s.lower())


class IvfAdapter(KnnAdapter):
    """(key, vector) index over the approximate :class:`IvfKnnIndex`
    (reference USearch HNSW role; see
    ``pathway_tpu_torch/parallel/ivf_knn.py``) on ``device``."""

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "cos",
        capacity: int = 1024,
        dtype: Any = None,
        nlist: int | None = None,
        nprobe: int | None = None,
        delta_cap: int | None = None,
        tombstone_fraction: float | None = None,
        auto_merge: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        from pathway_tpu_torch.parallel import IvfKnnIndex

        self.index = _segmented(
            IvfKnnIndex(
                dim,
                metric=metric,
                capacity=capacity,
                dtype=dtype or torch.bfloat16,
                nlist=nlist,
                nprobe=nprobe,
                device=device,
            ),
            delta_cap,
            tombstone_fraction,
            auto_merge,
        )
        self.meta: dict[Any, dict | None] = {}
