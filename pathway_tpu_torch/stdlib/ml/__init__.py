"""``pw.ml`` (reference ``python/pathway/stdlib/ml/``): legacy KNNIndex,
classifiers (incl. real LSH banding), HMM, smart-table fuzzy join."""

from pathway_tpu_torch.stdlib.ml import classifiers, hmm, smart_table_ops
from pathway_tpu_torch.stdlib.ml.classifiers import (
    LshBandingIndex,
    generate_cosine_lsh_bucketer,
    generate_euclidean_lsh_bucketer,
)
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = [
    "KNNIndex",
    "LshBandingIndex",
    "classifiers",
    "generate_cosine_lsh_bucketer",
    "generate_euclidean_lsh_bucketer",
    "hmm",
    "smart_table_ops",
]
