"""Text splitters (reference ``xpacks/llm/splitters.py:13-121``).

``TokenCountSplitter`` uses the framework tokenizer for counting (the
reference uses tiktoken, unavailable offline); chunk contract matches the
reference: ``list[tuple[text, metadata]]``.
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals.udfs import UDF

__all__ = ["null_splitter", "TokenCountSplitter"]


def null_splitter(txt: str) -> list[tuple[str, dict]]:
    """No-op splitter: one chunk (reference ``null_splitter``)."""
    return [(txt, {})]


_SENTENCE_END = re.compile(r"(?<=[.!?])\s+")


class TokenCountSplitter(UDF):
    """Split text into chunks of [min_tokens, max_tokens], preferring
    sentence boundaries (reference ``TokenCountSplitter``)."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        from pathway_tpu_torch.models.tokenizer import HashTokenizer

        self._tok = HashTokenizer()

    def _count(self, text: str) -> int:
        return self._tok.count_tokens(text)

    def __wrapped__(self, txt: str, **kwargs: Any) -> list[tuple[str, dict]]:
        text = str(txt)
        if not text.strip():
            return []
        pieces = _SENTENCE_END.split(text)
        chunks: list[str] = []
        cur = ""
        cur_tokens = 0
        for piece in pieces:
            pt = self._count(piece)
            if pt > self.max_tokens:
                # sentence longer than a chunk: hard-split by words
                if cur:
                    chunks.append(cur)
                    cur, cur_tokens = "", 0
                words = piece.split()
                step = max(self.max_tokens, 1)
                for s in range(0, len(words), step):
                    chunks.append(" ".join(words[s : s + step]))
                continue
            # max_tokens is a hard ceiling: close the chunk whenever adding
            # the next sentence would overflow it
            if cur and cur_tokens + pt > self.max_tokens:
                chunks.append(cur)
                cur, cur_tokens = piece, pt
            else:
                cur = f"{cur} {piece}".strip() if cur else piece
                cur_tokens += pt
        if cur:
            # a trailing fragment below min_tokens merges back only when the
            # combined chunk still respects max_tokens
            if (
                chunks
                and cur_tokens < self.min_tokens
                and self._count(chunks[-1]) + cur_tokens <= self.max_tokens
            ):
                chunks[-1] = f"{chunks[-1]} {cur}"
            else:
                chunks.append(cur)
        return [(c, {}) for c in chunks]
