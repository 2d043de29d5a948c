"""kNN classifiers (reference ``stdlib/ml/classifiers/`` — LSH-bucketed
kNN with majority vote, ``_knn_lsh.py:64-306``).

Two candidate-search engines:

- the exact card-resident index (default: the fused score + top-k, K3,
  outruns host LSH at the target scales), and
- a REAL LSH banding structure (:class:`LshBandingIndex` +
  :func:`generate_euclidean_lsh_bucketer` /
  :func:`generate_cosine_lsh_bucketer`), faithful to the reference's
  scheme: L bands of M hashes; a query's candidates are the union of its
  matching band buckets, re-ranked by the exact distance.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = [
    "knn_lsh_classifier_train",
    "knn_lsh_train",
    "knn_lsh_classify",
    "generate_euclidean_lsh_bucketer",
    "generate_cosine_lsh_bucketer",
    "LshBandingIndex",
]


def generate_euclidean_lsh_bucketer(
    d: int, M: int, L: int, A: float, seed: int = 0
) -> Callable[[np.ndarray], list]:
    """p-stable Euclidean LSH (reference
    ``_lsh.generate_euclidean_lsh_bucketer``): each of the L bands hashes
    a vector to a tuple of M quantized projections
    ``floor((x . v + b) / A)``."""
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(L * M, d))  # [L*M, d]
    offs = rng.uniform(0, A, size=(L * M,))

    def bucketer(x: Any) -> list:
        x = np.asarray(x, np.float64).reshape(-1)
        h = np.floor((proj @ x + offs) / A).astype(np.int64)
        return [tuple(h[i * M : (i + 1) * M]) for i in range(L)]

    return bucketer


def generate_cosine_lsh_bucketer(
    d: int, M: int, L: int, seed: int = 0
) -> Callable[[np.ndarray], list]:
    """Signed-random-hyperplane LSH (reference
    ``generate_cosine_lsh_bucketer``): each band is M sign bits."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(L * M, d))

    def bucketer(x: Any) -> list:
        x = np.asarray(x, np.float64).reshape(-1)
        bits = (planes @ x >= 0).astype(np.int64)
        out = []
        for i in range(L):
            band = bits[i * M : (i + 1) * M]
            out.append(int("".join(map(str, band)), 2))
        return out

    return bucketer


class LshBandingIndex:
    """Banded LSH candidate index with exact re-ranking (the reference's
    ``knn_lsh_generic_classifier_train`` data structure, host-side)."""

    def __init__(
        self,
        d: int,
        *,
        L: int = 20,
        M: int = 10,
        A: float = 10.0,
        metric: str = "euclidean",
        seed: int = 0,
    ):
        if metric == "euclidean":
            self.bucketer = generate_euclidean_lsh_bucketer(d, M, L, A, seed)
            self._dist = lambda q, x: float(np.sum((q - x) ** 2))
        elif metric == "cosine":
            self.bucketer = generate_cosine_lsh_bucketer(d, M, L, seed)

            def _cos(q, x):
                nq = np.linalg.norm(q) or 1.0
                nx = np.linalg.norm(x) or 1.0
                return 1.0 - float(q @ x) / (nq * nx)

            self._dist = _cos
        else:
            raise ValueError(f"unsupported LSH metric {metric!r}")
        self.L = L
        #: band index: buckets[band_i][band_hash] -> set of keys
        self.buckets: list[dict[Any, set]] = [defaultdict(set) for _ in range(L)]
        self.vectors: dict[Any, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.vectors)

    def add(self, key: Any, vector: Any) -> None:
        if key in self.vectors:
            self.remove(key)
        v = np.asarray(vector, np.float64).reshape(-1)
        self.vectors[key] = v
        for band_i, h in enumerate(self.bucketer(v)):
            self.buckets[band_i][h].add(key)

    def remove(self, key: Any) -> None:
        v = self.vectors.pop(key, None)
        if v is None:
            return
        for band_i, h in enumerate(self.bucketer(v)):
            self.buckets[band_i][h].discard(key)

    def candidates(self, query: Any) -> set:
        """Union of the query's matching band buckets."""
        q = np.asarray(query, np.float64).reshape(-1)
        out: set = set()
        for band_i, h in enumerate(self.bucketer(q)):
            out |= self.buckets[band_i].get(h, set())
        return out

    def query(self, query: Any, k: int) -> list[tuple[Any, float]]:
        """Top-k (key, distance) among LSH candidates — approximate: a
        point sharing no band bucket with the query is never considered."""
        q = np.asarray(query, np.float64).reshape(-1)
        scored = [
            (key, self._dist(q, self.vectors[key])) for key in self.candidates(q)
        ]
        scored.sort(key=lambda kv: (kv[1], str(kv[0])))
        return scored[:k]


def knn_lsh_train(
    data: Table,
    L: int = 20,
    d: int | None = None,
    M: int = 10,
    A: float = 10.0,
    type: str = "euclidean",  # noqa: A002 — reference parameter name
    embedding_column: str = "data",
    label_column: str = "label",
    device: str | torch.device = "cuda",
) -> KNNIndex:
    """Build the classifier index (reference ``knn_lsh_classifier_train``)
    on ``device`` (the JAX package's has no such argument)."""
    assert d is not None, "pass d (embedding dimensions)"
    return KNNIndex(
        data[embedding_column], data, n_dimensions=d, n_or=L, n_and=M,
        bucket_length=A, distance_type=type, device=device,
    )


knn_lsh_classifier_train = knn_lsh_train


def knn_lsh_classify(
    index: KNNIndex, data_queries: Any, queries: Table | None = None, k: int = 3
) -> Table:
    """Classify queries by majority vote over the k nearest neighbours
    (reference ``knn_lsh_classify``)."""
    replies = index.get_nearest_items(data_queries, k=k, collapse_rows=True)

    def vote(labels) -> Any:
        from collections import Counter

        labels = [l for l in (labels or ()) if l is not None]
        if not labels:
            return None
        return Counter(labels).most_common(1)[0][0]

    return replies.select(predicted_label=pw.apply(vote, replies.label))
