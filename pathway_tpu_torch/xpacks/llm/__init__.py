"""``pw.xpacks.llm`` — the port's live RAG stack (reference
``python/pathway/xpacks/llm/``; counterpart of ``pathway_tpu/xpacks/llm``):
embedders (the local encoder on the card and the API embedders), llms,
parsers, splitters, rerankers, DocumentStore, VectorStore, question
answering, servers, prompts.  The parsers beyond ``ParseUtf8`` and
``rag_eval`` come with ROADMAP item 16."""

from pathway_tpu_torch.xpacks.llm._typing import Doc, DocTransformer, DocTransformerCallable
from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    rerankers,
    splitters,
)
from pathway_tpu_torch.xpacks.llm import document_store, question_answering, servers, vector_store
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
    FlashRankReranker,
    LLMReranker,
    rerank_topk_filter,
)

__all__ = [
    "Doc",
    "DocTransformer",
    "DocTransformerCallable",
    "embedders",
    "llms",
    "parsers",
    "prompts",
    "rerankers",
    "splitters",
    "document_store",
    "question_answering",
    "servers",
    "vector_store",
    "TorchEncoderEmbedder",
    "SentenceTransformerEmbedder",
    "OpenAIEmbedder",
    "LiteLLMEmbedder",
    "GeminiEmbedder",
    "CrossEncoderReranker",
    "EncoderReranker",
    "FlashRankReranker",
    "LLMReranker",
    "rerank_topk_filter",
]
