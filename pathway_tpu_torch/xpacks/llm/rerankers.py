"""Rerankers (counterpart of ``pathway_tpu/xpacks/llm/rerankers.py``).

:class:`CrossEncoderReranker` scores (doc, query) pairs with the
cross-encoder on the card through
:class:`~pathway_tpu_torch.parallel.TorchEncoder` ``(cross=True)``, one
batched call per engine epoch; :class:`EncoderReranker` scores with the
bi-encoder's dot product; :func:`rerank_topk_filter` keeps the k best.
They are plain classes and a plain function for now: the JAX package's
derive from the ``UDF`` base class and ``@udf``, which the port now has
(``pathway_tpu_torch.internals.udfs``); making them UDFs is the rest of
ROADMAP item 13.  ``LLMReranker`` and ``FlashRankReranker`` need an LLM
client and the servers and come with items 13 and 15.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.models.encoder import BGE_RERANKER_BASE, EncoderConfig
from pathway_tpu_torch.parallel.executor import TorchEncoder
from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder

__all__ = ["rerank_topk_filter", "CrossEncoderReranker", "EncoderReranker"]


def _text(doc: Any) -> str:
    return doc["text"] if isinstance(doc, dict) else str(doc)


def rerank_topk_filter(
    docs: list, scores: list[float], k: int = 5
) -> tuple[list, list[float]]:
    """Keep the k best (docs, scores) pairs, best first (the JAX
    package's numpy ``argsort`` of the negated scores, so ties fall the
    same way)."""
    order = np.argsort(-np.asarray(scores, dtype=np.float64))[: int(k)]
    return [docs[i] for i in order], [float(scores[i]) for i in order]


class CrossEncoderReranker:
    """(doc, query) -> relevance score via the cross-encoder on the card.

    Without ``config`` the architecture is
    :data:`~pathway_tpu_torch.models.BGE_RERANKER_BASE`, as for the
    default ``model_name``; the weights are a seeded random init unless
    ``params`` (a flax parameter tree of the JAX package's
    ``CrossEncoderModel``) is passed.  A local HF checkpoint directory as
    ``model_name`` loads its weights, config and vocabulary.
    """

    def __init__(
        self,
        model_name: str = "BAAI/bge-reranker-base",
        *,
        mesh: Any = None,
        params: Any = None,
        config: EncoderConfig | None = None,
        max_batch_size: int | None = 256,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        checkpoint_dir = model_name if os.path.isdir(model_name) else None
        if config is None and checkpoint_dir is None:
            config = BGE_RERANKER_BASE
        self.encoder = TorchEncoder(
            config, cross=True, mesh=mesh, model_name=model_name, params=params,
            max_batch=max_batch_size or 256, checkpoint_dir=checkpoint_dir,
            seed=seed, device=device,
        )

    def __batch__(self, docs: list, queries: list) -> list[float]:
        scores = self.encoder.score_pairs([str(q) for q in queries], [_text(d) for d in docs])
        return [float(s) for s in scores]

    def __wrapped__(self, doc: Any, query: str) -> float:
        return self.__batch__([doc], [query])[0]


class EncoderReranker:
    """Bi-encoder similarity reranker: the dot product of the doc's and
    the query's embeddings."""

    def __init__(
        self,
        embedder: Any = None,
        model_name: str = "all-MiniLM-L6-v2",
        *,
        device: str | torch.device = "cuda",
    ):
        self.embedder = embedder if embedder is not None else TorchEncoderEmbedder(
            model_name, device=device
        )

    def __batch__(self, docs: list, queries: list) -> list[float]:
        demb = np.stack([np.asarray(v) for v in self.embedder._embed_batch([_text(d) for d in docs])])
        qemb = np.stack([np.asarray(v) for v in self.embedder._embed_batch([str(q) for q in queries])])
        return [float(x) for x in np.sum(demb * qemb, axis=1)]

    def __wrapped__(self, doc: Any, query: str) -> float:
        return self.__batch__([doc], [query])[0]
