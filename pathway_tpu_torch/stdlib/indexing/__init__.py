"""``pw.indexing`` — live retrieval indexes over streaming tables
(counterpart of ``pathway_tpu/stdlib/indexing``, ROADMAP item 14).

Capability parity with reference ``python/pathway/stdlib/indexing/``:
``DataIndex`` (``data_index.py:206-473``), brute-force / usearch / LSH
KNN (``nearest_neighbors.py:65-547``), ``TantivyBM25`` (``bm25.py``),
``HybridIndex`` RRF fusion (``hybrid_index.py``), sorting index
(``sorting.py``).  The KNN path runs on the card: a slab in device
memory searched by the fused score + top-k kernel (see
:mod:`pathway_tpu_torch.parallel.sharded_knn`), or the IVF cells (see
:mod:`pathway_tpu_torch.parallel.ivf_knn`), each fronted by the
delta segment of :class:`SegmentedIndex`.
"""

from pathway_tpu_torch.stdlib.indexing.adapters import BM25Adapter, HybridAdapter, KnnAdapter
from pathway_tpu_torch.stdlib.indexing.data_index import (
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    DataIndex,
    HybridIndex,
    HybridIndexFactory,
    InnerIndex,
    InnerIndexFactory,
    LshKnn,
    LshKnnFactory,
    TantivyBM25,
    TantivyBM25Factory,
    UsearchKnn,
    UsearchKnnFactory,
)
from pathway_tpu_torch.stdlib.indexing.filters import compile_filter
from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex
from pathway_tpu_torch.stdlib.indexing.sorting import retrieve_prev_next_values
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    VectorDocumentIndex,
    default_brute_force_knn_document_index,
    default_full_text_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)

__all__ = [
    "DataIndex",
    "InnerIndex",
    "InnerIndexFactory",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "UsearchKnn",
    "UsearchKnnFactory",
    "LshKnn",
    "LshKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "HybridIndex",
    "HybridIndexFactory",
    "KnnAdapter",
    "BM25Adapter",
    "HybridAdapter",
    "SegmentedIndex",
    "compile_filter",
    "retrieve_prev_next_values",
    "VectorDocumentIndex",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_usearch_knn_document_index",
    "default_full_text_document_index",
]
