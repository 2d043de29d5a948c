"""Rerankers (counterpart of ``pathway_tpu/xpacks/llm/rerankers.py``).

:class:`CrossEncoderReranker` scores (doc, query) pairs with the
cross-encoder on the card through
:class:`~pathway_tpu_torch.parallel.TorchEncoder` ``(cross=True)``;
:class:`EncoderReranker` scores with the bi-encoder's dot product.  Both
are :class:`~pathway_tpu_torch.UDF`\\ s with a ``__batch__``, as the JAX
package's are: applied to columns, the engine hands them each epoch's
pairs in one call, cut into chunks of at most ``max_batch_size``.
:func:`rerank_topk_filter` (a ``@udf``) keeps the k best, and
:class:`LLMReranker` asks a chat UDF for a 1-5 rating, and
:class:`FlashRankReranker` needs the optional ``flashrank`` package.
"""

from __future__ import annotations

import asyncio
import inspect
import os
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.internals.udfs import UDF, udf
from pathway_tpu_torch.models.encoder import BGE_RERANKER_BASE, EncoderConfig
from pathway_tpu_torch.parallel.executor import TorchEncoder
from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder

__all__ = [
    "rerank_topk_filter",
    "CrossEncoderReranker",
    "EncoderReranker",
    "LLMReranker",
    "FlashRankReranker",
]


def _text(doc: Any) -> str:
    return doc["text"] if isinstance(doc, dict) else str(doc)


@udf
def rerank_topk_filter(
    docs: list[dict], scores: list[float], k: int = 5
) -> tuple[list[dict], list[float]]:
    """Keep the k best (docs, scores) pairs, best first (the JAX
    package's numpy ``argsort`` of the negated scores, so ties fall the
    same way).  A UDF: call the function itself as
    ``rerank_topk_filter.__wrapped_fun__``."""
    order = np.argsort(-np.asarray(scores, dtype=np.float64))[: int(k)]
    return [docs[i] for i in order], [float(scores[i]) for i in order]


class CrossEncoderReranker(UDF):
    """(doc, query) -> relevance score via the cross-encoder on the card.

    Without ``config`` the architecture is
    :data:`~pathway_tpu_torch.models.BGE_RERANKER_BASE`, as for the
    default ``model_name``; the weights are a seeded random init unless
    ``params`` (a flax parameter tree of the JAX package's
    ``CrossEncoderModel``) is passed.  A local HF checkpoint directory as
    ``model_name`` loads its weights, config and vocabulary.
    ``max_batch_size`` bounds both the pairs the engine hands one
    ``__batch__`` call and the encoder's chunk; other keyword arguments go
    to :class:`~pathway_tpu_torch.UDF`.
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
        **kwargs: Any,
    ):
        super().__init__(max_batch_size=max_batch_size, **kwargs)
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


class EncoderReranker(UDF):
    """Bi-encoder similarity reranker: the dot product of the doc's and
    the query's embeddings (by default a :class:`TorchEncoderEmbedder` of
    ``model_name`` on ``device``)."""

    def __init__(
        self,
        embedder: Any = None,
        model_name: str = "all-MiniLM-L6-v2",
        *,
        device: str | torch.device = "cuda",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.embedder = embedder if embedder is not None else TorchEncoderEmbedder(
            model_name, device=device
        )

    def __batch__(self, docs: list, queries: list) -> list[float]:
        demb = np.stack([np.asarray(v) for v in self.embedder._embed_batch([_text(d) for d in docs])])
        qemb = np.stack([np.asarray(v) for v in self.embedder._embed_batch([str(q) for q in queries])])
        return [float(x) for x in np.sum(demb * qemb, axis=1)]

    def __wrapped__(self, doc: Any, query: str) -> float:
        return self.__batch__([doc], [query])[0]


class LLMReranker(UDF):
    """Chat-based 1-5 relevance scoring (reference ``rerankers.py:58``):
    ``llm`` is a chat UDF (or a callable) taking a list of messages; an
    answer that does not start with a number scores 1."""

    PROMPT = (
        "Given a query and a document, rate how relevant the document is "
        "to the query on an integer scale of 1 to 5. Answer with ONLY the "
        "number.\nQuery: {query}\nDocument: {doc}"
    )

    def __init__(self, llm: Any, **kwargs: Any):
        super().__init__(**kwargs)
        self.llm = llm

    def __wrapped__(self, doc: Any, query: str) -> float:
        msg = [{"role": "user", "content": self.PROMPT.format(query=query, doc=_text(doc))}]
        fun = self.llm.__wrapped__ if hasattr(self.llm, "__wrapped__") else self.llm
        out = fun(msg)
        if inspect.isawaitable(out):
            out = asyncio.run(out)
        try:
            return float(str(out).strip().split()[0])
        except (ValueError, IndexError):
            return 1.0


class FlashRankReranker(UDF):
    """reference ``rerankers.py:319`` — gated on the flashrank package."""

    def __init__(self, model: str = "ms-marco-TinyBERT-L-2-v2", **kwargs: Any):
        super().__init__(**kwargs)
        try:
            import flashrank  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "FlashRankReranker needs the 'flashrank' package; use "
                "CrossEncoderReranker (on the card) instead"
            ) from e
