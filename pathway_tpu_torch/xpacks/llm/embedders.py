"""Embedders: text -> vector UDFs (counterpart of
``pathway_tpu/xpacks/llm/embedders.py``).

:class:`TorchEncoderEmbedder`, and its reference-named alias
:class:`SentenceTransformerEmbedder`, runs a BERT-family encoder on the
card through :class:`~pathway_tpu_torch.parallel.TorchEncoder`.  Like the
JAX package's embedders it is a :class:`~pathway_tpu_torch.UDF` with a
``__batch__``: applied to a column, the engine hands it each epoch's
rows in one call, cut into chunks of at most ``max_batch_size``.

The API embedders (:class:`OpenAIEmbedder`, :class:`LiteLLMEmbedder`,
:class:`GeminiEmbedder`) keep the reference's async-UDF shape (capacity,
retry and cache composition) and need their client packages, imported
only when an embedder is made or called; without the package the
constructor raises ``ImportError``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.models import encoder as _enc
from pathway_tpu_torch.parallel.executor import TorchEncoder

__all__ = [
    "BaseEmbedder",
    "TorchEncoderEmbedder",
    "SentenceTransformerEmbedder",
    "OpenAIEmbedder",
    "LiteLLMEmbedder",
    "GeminiEmbedder",
]

_PRESETS = {
    "all-minilm-l6-v2": "MINILM_L6",
    "sentence-transformers/all-minilm-l6-v2": "MINILM_L6",
    "baai/bge-small-en-v1.5": "BGE_SMALL",
    "bge-small": "BGE_SMALL",
    "baai/bge-base-en-v1.5": "BGE_BASE",
    "bge-base": "BGE_BASE",
    "baai/bge-large-en-v1.5": "BGE_LARGE",
    "bge-large": "BGE_LARGE",
    "intfloat/e5-base-v2": "E5_BASE",
    "e5-base": "E5_BASE",
}


def _resolve_config(model: str) -> _enc.EncoderConfig:
    return getattr(_enc, _PRESETS.get(model.lower(), "MINILM_L6"))


class BaseEmbedder(UDF):
    def get_embedding_dimension(self, **kwargs: Any) -> int:
        """Probe: embed a short string, report its width (reference
        ``BaseEmbedder.get_embedding_dimension``)."""
        return int(np.asarray(self._embed_batch(["."])[0]).reshape(-1).shape[0])

    def _embed_batch(self, texts: list[str]) -> list:
        raise NotImplementedError


class TorchEncoderEmbedder(BaseEmbedder):
    """Sentence encoder on the card; one batched call per epoch chunk.

    ``model`` is a local HF checkpoint directory (weights, config and
    vocabulary; ``config.json`` decides pooling unless ``config`` is
    passed), or it picks an architecture preset (MiniLM/BGE/E5 family)
    whose weights are a seeded random init unless ``params`` (a flax
    parameter tree of the JAX package's encoder) is passed.  ``mesh`` runs
    the encoder data parallel (:class:`~pathway_tpu_torch.parallel.TorchEncoder`).
    ``max_batch_size`` bounds both the rows the engine hands one
    ``__batch__`` call and the encoder's chunk; ``call_kwargs`` is accepted
    and unused, as in the JAX package; other keyword arguments go to
    :class:`~pathway_tpu_torch.UDF`.
    """

    def __init__(
        self,
        model: str = "all-MiniLM-L6-v2",
        *,
        mesh: Any = None,
        max_batch_size: int | None = 1024,
        call_kwargs: dict | None = None,
        params: Any = None,
        config: _enc.EncoderConfig | None = None,
        sequence_axis: str | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        **kwargs: Any,
    ):
        super().__init__(max_batch_size=max_batch_size, **kwargs)
        checkpoint_dir = model if os.path.isdir(model) else None
        if config is None and checkpoint_dir is None:
            config = _resolve_config(model)
        self.model = model
        self.encoder = TorchEncoder(
            config, mesh=mesh, model_name=model, params=params,
            max_batch=max_batch_size or 1024, checkpoint_dir=checkpoint_dir,
            sequence_axis=sequence_axis, seed=seed, device=device,
        )

    def _embed_batch(self, texts: list[str]) -> list:
        emb = self.encoder.encode([t if t else "." for t in texts])
        return [row for row in emb]

    def __batch__(self, texts: list[str]) -> list:
        return self._embed_batch([str(t) for t in texts])

    def __wrapped__(self, text: str) -> Any:
        return self._embed_batch([str(text)])[0]


#: reference-compatible name: in the reference this wraps torch
#: SentenceTransformers; here it is the port's encoder on the card
SentenceTransformerEmbedder = TorchEncoderEmbedder


class _ApiEmbedder(BaseEmbedder):
    """Shared shape of the network API embedders."""

    _client_pkg = ""

    def __init__(
        self,
        *,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = None,
        **call_kwargs: Any,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.model = model
        self.call_kwargs = call_kwargs
        try:
            __import__(self._client_pkg)
        except ImportError as e:
            raise ImportError(
                f"{type(self).__name__} needs the {self._client_pkg!r} package "
                "(and network access); use TorchEncoderEmbedder to embed "
                "locally on the card"
            ) from e

    def _embed_batch(self, texts: list[str]) -> list:
        import asyncio

        async def run_all() -> list:
            return await asyncio.gather(*[self.__wrapped__(t) for t in texts])

        return asyncio.run(run_all())


class OpenAIEmbedder(_ApiEmbedder):
    """reference ``embedders.py:85``"""

    _client_pkg = "openai"

    async def __wrapped__(self, input: str, **kwargs: Any) -> Any:
        import openai

        client = openai.AsyncOpenAI()
        kw = {**self.call_kwargs, **kwargs}
        if self.model is not None:
            kw.setdefault("model", self.model)
        ret = await client.embeddings.create(input=[input or "."], **kw)
        return np.asarray(ret.data[0].embedding)


class LiteLLMEmbedder(_ApiEmbedder):
    """reference ``embedders.py:180``"""

    _client_pkg = "litellm"

    async def __wrapped__(self, input: str, **kwargs: Any) -> Any:
        import litellm

        kw = {**self.call_kwargs, **kwargs}
        if self.model is not None:
            kw.setdefault("model", self.model)
        ret = await litellm.aembedding(input=[input or "."], **kw)
        return np.asarray(ret.data[0]["embedding"])


class GeminiEmbedder(_ApiEmbedder):
    """reference ``embedders.py:330``"""

    _client_pkg = "google.generativeai"

    async def __wrapped__(self, input: str, **kwargs: Any) -> Any:
        import google.generativeai as genai

        kw = {**self.call_kwargs, **kwargs}
        if self.model is not None:
            kw.setdefault("model", self.model)
        ret = genai.embed_content(content=input or ".", **kw)
        return np.asarray(ret["embedding"])
