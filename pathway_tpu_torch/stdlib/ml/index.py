"""Legacy ``KNNIndex`` API (reference ``stdlib/ml/index.py:9-300``;
counterpart of ``pathway_tpu/stdlib/ml/index.py``) over the card-resident
brute-force index: K2 scatters the rows into the slab, K3 searches it
(the reference used a pure-Python LSH implementation,
``ml/classifiers/_knn_lsh.py``).  ``device=`` (default ``"cuda"``) goes
to ``BruteForceKnnFactory``; the JAX package has no such argument."""

from __future__ import annotations

from typing import Any

import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import BruteForceKnnFactory, DataIndex

__all__ = ["KNNIndex"]


class KNNIndex:
    """reference ``KNNIndex(data_embedding, data, n_dimensions, ...)``"""

    def __init__(
        self,
        data_embedding: Any,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: Any = None,
        device: str | torch.device = "cuda",
    ):
        metric = "l2sq" if distance_type == "euclidean" else "cos"
        factory = BruteForceKnnFactory(
            dimensions=n_dimensions,
            reserved_space=max(1024, n_or * 64),
            metric=metric,
            device=device,
        )
        self._index: DataIndex = factory.build_data_index(
            data_embedding, data, metadata_column=metadata
        )
        self._data = data

    def get_nearest_items(
        self,
        query_embedding: Any,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: Any = None,
    ) -> Table:
        """Fully consistent queries (reference ``get_nearest_items``)."""
        return self._pack(
            self._index.query(
                query_embedding, number_of_matches=k, metadata_filter=metadata_filter
            ),
            collapse_rows,
            with_distances,
        )

    def get_nearest_items_asof_now(
        self,
        query_embedding: Any,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: Any = None,
    ) -> Table:
        return self._pack(
            self._index.query_as_of_now(
                query_embedding, number_of_matches=k, metadata_filter=metadata_filter
            ),
            collapse_rows,
            with_distances,
        )

    def _pack(self, replies: Table, collapse_rows: bool, with_distances: bool) -> Table:
        data_cols = self._data._column_names

        def collapse(datas, scores):
            cols = {
                c: tuple((d or {}).get(c) for d in (datas or ()))
                for c in data_cols
            }
            if with_distances:
                cols["dist"] = tuple(-float(s) for s in (scores or ()))
            return cols

        packed = replies.select(
            *[
                replies[c]
                for c in replies._column_names
                if not c.startswith("_pw_index_reply")
            ],
            _pw_packed=pw.apply(
                collapse, replies["_pw_index_reply"], replies["_pw_index_reply_score"]
            ),
        )
        out_cols = data_cols + (["dist"] if with_distances else [])
        result = packed.select(
            *[packed[c] for c in packed._column_names if c != "_pw_packed"],
            **{
                c: pw.apply(lambda p, c=c: p[c], packed["_pw_packed"])
                for c in out_cols
            },
        )
        return result
