"""Chat model wrappers (reference ``xpacks/llm/llms.py``).

``BaseChat`` (reference ``llms.py:27``) is the UDF contract:
``__wrapped__(messages) -> str`` where messages is a list of
``{"role": ..., "content": ...}`` dicts.  Network chats
(OpenAI/LiteLLM/Cohere, reference ``:84/:313/:544``) are gated on their
client packages; :class:`HFPipelineChat` (``:441``) on a locally cached
model.  ``prompt_chat_single_qa`` matches the reference helper.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.udfs import UDF

__all__ = [
    "BaseChat",
    "OpenAIChat",
    "LiteLLMChat",
    "HFPipelineChat",
    "CohereChat",
    "prompt_chat_single_qa",
]


def prompt_chat_single_qa(question: str) -> list[dict]:
    """Wrap a plain question into the single-turn message format
    (reference ``llms.py prompt_chat_single_qa``)."""
    return [{"role": "user", "content": str(question)}]


class BaseChat(UDF):
    """Base chat UDF (reference ``llms.py:27``)."""

    def __init__(
        self,
        *,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = None,
        **call_kwargs: Any,
    ):
        executor = (
            udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
            if (capacity is not None or retry_strategy is not None)
            else None
        )
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.model = model
        self.call_kwargs = call_kwargs

    def _accepts_call_arg(self, arg: str) -> bool:
        return True


class _GatedChat(BaseChat):
    _client_pkg = ""

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        try:
            __import__(self._client_pkg)
        except ImportError as e:
            raise ImportError(
                f"{type(self).__name__} needs the {self._client_pkg!r} package "
                "(and network access)"
            ) from e


class OpenAIChat(_GatedChat):
    """reference ``llms.py:84``"""

    _client_pkg = "openai"

    async def __wrapped__(self, messages: list[dict], **kwargs: Any) -> str | None:
        import openai

        client = openai.AsyncOpenAI()
        kw = {**self.call_kwargs, **kwargs}
        if self.model is not None:
            kw.setdefault("model", self.model)
        ret = await client.chat.completions.create(messages=messages, **kw)
        return ret.choices[0].message.content


class LiteLLMChat(_GatedChat):
    """reference ``llms.py:313``"""

    _client_pkg = "litellm"

    async def __wrapped__(self, messages: list[dict], **kwargs: Any) -> str | None:
        import litellm

        kw = {**self.call_kwargs, **kwargs}
        if self.model is not None:
            kw.setdefault("model", self.model)
        ret = await litellm.acompletion(messages=messages, **kw)
        return ret.choices[0]["message"]["content"]


class CohereChat(_GatedChat):
    """reference ``llms.py:544``"""

    _client_pkg = "cohere"

    async def __wrapped__(self, messages: list[dict], **kwargs: Any) -> str | None:
        import cohere

        client = cohere.AsyncClient()
        kw = {**self.call_kwargs, **kwargs}
        if self.model is not None:
            kw.setdefault("model", self.model)
        query = messages[-1]["content"]
        ret = await client.chat(message=query, **kw)
        return ret.text


class HFPipelineChat(BaseChat):
    """Local HuggingFace text-generation pipeline (reference ``llms.py:441``).
    Runs on the card unless the caller passes ``device="cpu"``, as every
    entry point of the port does.  Requires a locally cached model — no
    downloads attempted."""

    def __init__(self, model: str | None = None, device: str = "cuda", **kwargs: Any):
        super().__init__(model=model, **kwargs)
        from transformers import pipeline

        self.pipeline = pipeline(
            "text-generation",
            model=model,
            device=device,
            model_kwargs={"local_files_only": True},
        )

    def __wrapped__(self, messages: list[dict] | str, **kwargs: Any) -> str | None:
        if isinstance(messages, str):
            prompt = messages
        else:
            prompt = "\n".join(m.get("content", "") for m in messages)
        out = self.pipeline(prompt, **{**self.call_kwargs, **kwargs})
        text = out[0]["generated_text"]
        return text[len(prompt) :] if text.startswith(prompt) else text
