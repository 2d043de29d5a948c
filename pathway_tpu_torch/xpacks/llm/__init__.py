"""The port's part of the live RAG stack (counterpart of
``pathway_tpu/xpacks/llm``): so far the local encoder embedder (a UDF) and
the rerankers."""

from pathway_tpu_torch.xpacks.llm import embedders, rerankers
from pathway_tpu_torch.xpacks.llm.rerankers import (
    CrossEncoderReranker,
    EncoderReranker,
    rerank_topk_filter,
)

__all__ = [
    "embedders",
    "rerankers",
    "CrossEncoderReranker",
    "EncoderReranker",
    "rerank_topk_filter",
]
