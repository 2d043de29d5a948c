"""Shared typing for the LLM xpack (reference
``python/pathway/xpacks/llm/_typing.py``)."""

from __future__ import annotations

from typing import Any, Callable, TypedDict


class Doc(TypedDict, total=False):
    """A document chunk flowing through the RAG pipeline."""

    text: str
    metadata: dict
    score: float


#: a UDF / callable mapping list[Doc] -> list[Doc] (parsers, splitters,
#: post-processors, rerank filters)
DocTransformerCallable = Callable[[list[Doc]], list[Doc]]

DocTransformer = Any  # UDF or DocTransformerCallable
