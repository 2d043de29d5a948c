"""Convenience constructors for text-document vector indexes
(counterpart of ``pathway_tpu/stdlib/indexing/vector_document_index.py``;
reference ``stdlib/indexing/vector_document_index.py``).  The KNN
constructors take ``device=`` (default ``"cuda"``) for their factory."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import (
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    DataIndex,
    TantivyBM25Factory,
    UsearchKnnFactory,
)

__all__ = [
    "VectorDocumentIndex",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_usearch_knn_document_index",
    "default_full_text_document_index",
]


def VectorDocumentIndex(  # noqa: N802 — reference-compatible name
    data_column: ColumnReference,
    data_table: Table,
    embedder: Any,
    *,
    dimensions: int | None = None,
    metadata_column: ColumnReference | None = None,
    metric: str = BruteForceKnnMetricKind.COS,
    reserved_space: int = 1024,
    mesh: Any = None,
    device: Any = "cuda",
) -> DataIndex:
    factory = BruteForceKnnFactory(
        dimensions=dimensions,
        reserved_space=reserved_space,
        metric=metric,
        embedder=embedder,
        mesh=mesh,
        device=device,
    )
    return factory.build_data_index(data_column, data_table, metadata_column)


default_vector_document_index = VectorDocumentIndex
default_brute_force_knn_document_index = VectorDocumentIndex


def default_usearch_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    embedder: Any,
    *,
    dimensions: int | None = None,
    metadata_column: ColumnReference | None = None,
    metric: str = BruteForceKnnMetricKind.COS,
    reserved_space: int = 1024,
    device: Any = "cuda",
) -> DataIndex:
    factory = UsearchKnnFactory(
        dimensions=dimensions,
        reserved_space=reserved_space,
        metric=metric,
        embedder=embedder,
        device=device,
    )
    return factory.build_data_index(data_column, data_table, metadata_column)


def default_full_text_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    metadata_column: ColumnReference | None = None,
) -> DataIndex:
    return TantivyBM25Factory().build_data_index(
        data_column, data_table, metadata_column
    )
