"""``pw.utils`` (reference ``python/pathway/stdlib/utils/``):
AsyncTransformer, column helpers, pandas_transformer, bucketing/filtering."""

from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.col import flatten_column, multiapply_all, unpack_col
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

__all__ = [
    "AsyncTransformer",
    "unpack_col",
    "flatten_column",
    "multiapply_all",
    "pandas_transformer",
]
