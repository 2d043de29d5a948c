"""The port's part of the live RAG stack (counterpart of
``pathway_tpu/xpacks/llm``): the embedders (the local encoder on the card
and the API embedders) and the rerankers, all UDFs.  The servers,
``DocumentStore``, question answering and the other modules of the JAX
package's ``xpacks.llm`` come with ROADMAP item 15."""

from pathway_tpu_torch.xpacks.llm import embedders, rerankers
from pathway_tpu_torch.xpacks.llm.embedders import (
    GeminiEmbedder,
    LiteLLMEmbedder,
    OpenAIEmbedder,
    SentenceTransformerEmbedder,
    TorchEncoderEmbedder,
)
from pathway_tpu_torch.xpacks.llm.rerankers import (
    CrossEncoderReranker,
    EncoderReranker,
    LLMReranker,
    rerank_topk_filter,
)

__all__ = [
    "embedders",
    "rerankers",
    "TorchEncoderEmbedder",
    "SentenceTransformerEmbedder",
    "OpenAIEmbedder",
    "LiteLLMEmbedder",
    "GeminiEmbedder",
    "CrossEncoderReranker",
    "EncoderReranker",
    "LLMReranker",
    "rerank_topk_filter",
]
