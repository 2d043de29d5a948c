"""Plain PyTorch numeric primitives of the port (counterpart of
``pathway_tpu/ops``): distances, masked top-k, mask-aware pooling and
shape bucketing."""

from pathway_tpu_torch.ops.bucketing import bucket_size, pad_dim, pad_rows
from pathway_tpu_torch.ops.distances import (
    cosine_scores,
    dot_scores,
    l2sq_distances,
    normalize,
)
from pathway_tpu_torch.ops.pooling import cls_pool, masked_mean_pool
from pathway_tpu_torch.ops.topk import masked_top_k

__all__ = [
    "bucket_size",
    "pad_dim",
    "pad_rows",
    "cosine_scores",
    "dot_scores",
    "l2sq_distances",
    "normalize",
    "masked_mean_pool",
    "cls_pool",
    "masked_top_k",
]
